"""The port's resilience subsystem: fault injection and the retry policy.

The port's copies of `skypilot_tpu/resilience/faults.py` (the named
fault points tests and `SKYTPU_FAULTS` drills arm) and
`skypilot_tpu/resilience/retries.py` (the backoff policy `fit`'s
checkpoint saves retry under). The reference's circuit breakers serve
planes the port does not have (the load balancer, provisioning) and
are not copied.
"""
from skypilot_tpu_torch.resilience import faults
from skypilot_tpu_torch.resilience import retries

__all__ = ['faults', 'retries']
