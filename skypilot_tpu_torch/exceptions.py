"""The port's copy of the exception classes of `skypilot_tpu/exceptions.py`
that its modules raise, with the reference's names and bases, so a
caller catches the same class from either package.
"""
from typing import List, Optional


class SkyTpuError(Exception):
    """Base class for all framework errors."""


class InvalidTaskError(SkyTpuError, ValueError):
    """A Task / task YAML is malformed (a `service:` section among it)."""


class ResourcesUnavailableError(SkyTpuError):
    """No (cloud, region, zone) could satisfy the request.

    Carries the failover history so callers can display the per-zone
    reasons, as the reference's failover loop does.
    """

    def __init__(self, message: str,
                 failover_history: Optional[List[Exception]] = None):
        super().__init__(message)
        self.failover_history: List[Exception] = failover_history or []


class ClusterDoesNotExist(SkyTpuError, ValueError):
    """Named cluster not found in the state DB."""


class ClusterSetUpError(SkyTpuError):
    """Runtime setup (deps install, skylet start) failed on the cluster."""


class ServeError(SkyTpuError):
    """SkyServe-analog subsystem error."""
