"""Fleet-scale soak harness: O(1000) simulated replicas on a virtual
clock, driving the port's serve control plane.

The port of `skypilot_tpu/fleetsim/` (`clock.py`, `traffic.py`,
`chaos.py`, `slo.py`, `replicas.py`, `runner.py` with its whole
scenario catalog, `__main__.py`). `runner.FleetSim` constructs the
port's `serve.controller.ServeController`, `serve.load_balancer
.LoadBalancer` (its `dispatch` seam: routing, breaker and failover
without HTTP) and autoscalers, and injects (a) a `clock.VirtualClock`
through the controller's `now_fn` / `sleep_fn` seams and (b) a
`replicas.SimFleet` of mock replica processes in place of the replica
manager. Simulated minutes run in seconds of wall time, and
`slo.SLOEvaluator` asserts SLOs from the port's skytpu_* metrics
registry. Nothing here runs a kernel or touches a tensor: the
simulated replicas are latency distributions, so the fleet simulator
runs on the CPU, where its tests hold it against the reference's
reports seed for seed.

Entry point:

    python -m skypilot_tpu_torch.fleetsim --scenario smoke
"""
from skypilot_tpu_torch.fleetsim.clock import VirtualClock
from skypilot_tpu_torch.fleetsim.runner import SCENARIOS, FleetSim, Scenario

__all__ = ['FleetSim', 'SCENARIOS', 'Scenario', 'VirtualClock']
