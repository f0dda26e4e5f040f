"""The port's copy of the exception classes of `skypilot_tpu/exceptions.py`
that its modules raise, with the reference's names and bases, so a
caller catches the same class from either package.
"""


class SkyTpuError(Exception):
    """Base class for all framework errors."""


class InvalidTaskError(SkyTpuError, ValueError):
    """A Task / task YAML is malformed (here: a `service:` section)."""
