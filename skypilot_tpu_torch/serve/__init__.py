"""The port's serving plane, each module beside its counterpart in
`skypilot_tpu/serve/`. The data plane: the load balancer on the standard
library (`load_balancer.py`), its routing policies
(`load_balancing_policies.py`), the `service:` spec (`service_spec.py`)
and the autoscalers (`autoscalers.py`). The control plane: the service
state database (`serve_state.py`), the spot placer (`spot_placer.py`),
the replica manager and its launch seam (`replica_managers.py`), the
controller that runs them and the LB in one process (`controller.py`)
and the public API, `up` / `update` / `down` / `status` / `tail_logs`
(`core.py`).
"""
