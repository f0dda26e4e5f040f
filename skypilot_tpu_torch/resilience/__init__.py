"""The port's resilience subsystem: fault injection, the retry policy and
circuit breakers.

The port's copies of `skypilot_tpu/resilience/faults.py` (the named
fault points tests and `SKYTPU_FAULTS` drills arm),
`skypilot_tpu/resilience/retries.py` (the backoff policy `fit`'s
checkpoint saves and the load balancer's migrations retry under) and
`skypilot_tpu/resilience/circuit.py` (the load balancer's per-replica
breakers).
"""
from skypilot_tpu_torch.resilience import circuit
from skypilot_tpu_torch.resilience import faults
from skypilot_tpu_torch.resilience import retries

__all__ = ['circuit', 'faults', 'retries']
