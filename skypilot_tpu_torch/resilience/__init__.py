"""The port's resilience subsystem: deterministic fault injection.

The port's copy of `skypilot_tpu/resilience/faults.py` (the named
fault points tests and `SKYTPU_FAULTS` drills arm). The reference's
retry policy and circuit breakers serve planes the port does not have
(the load balancer, provisioning) and are not copied.
"""
from skypilot_tpu_torch.resilience import faults

__all__ = ['faults']
