"""The replicated scheduler's control channel (port-only).

JAX drives every chip of a host from one process, so the reference's
engine has one host side. The port runs one process per device, and
every rank runs the engine's host side (admission, pages, the prefix
cache, copy-on-write, sampling parameters) itself, identically. Rank 0
alone hears the outside world (HTTP, batch input), so it publishes what
changes the host state: once per `step()` it broadcasts the host events
since the last one (submit with prompt, sampling parameters and request
id; abort; abort of all) over the mesh's CPU `gloo` group, with a hash
of its host plan after them; the other ranks apply the events, check
the hash against their own and step with it. An idle rank 0 publishes an
empty message every HEARTBEAT_SECONDS, so a follower waits at most
TIMEOUT_SECONDS for a message and exits when rank 0 is gone.

Used by `inference.engine.InferenceEngine` (`_publish`, `follow`,
`heartbeat`, `stop_followers`).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

# An idle leader publishes at least this often.
HEARTBEAT_SECONDS = 2.0
# A follower raises when no message came for this long (the control
# group's collective timeout).
TIMEOUT_SECONDS = 20.0


class Channel:
    """One rank's end of the control channel over `mesh.control_group`:
    rank 0 publishes, every other rank receives."""

    def __init__(self, mesh: Any) -> None:
        import torch.distributed as dist
        self._group = mesh.control_group
        self.leader = mesh.rank == 0
        self.closed = False
        self._last = time.monotonic()
        # Ranks enter the channel together: a follower's first receive
        # must not count a slower leader's start-up against its timeout.
        dist.barrier()

    def publish(self, events: List[Any], plan: int, step: bool = False,
                stop: bool = False) -> None:
        import torch.distributed as dist
        if not self.leader:
            raise RuntimeError('only rank 0 publishes host events')
        if self.closed:
            raise RuntimeError('the control channel is closed (followers '
                               'were stopped)')
        dist.broadcast_object_list(
            [{'events': events, 'plan': plan, 'step': step, 'stop': stop}],
            src=0, group=self._group)
        self._last = time.monotonic()
        self.closed = stop

    def receive(self) -> Dict[str, Any]:
        """The next message of rank 0. Raises when rank 0 is gone, or
        sent nothing for TIMEOUT_SECONDS."""
        import torch.distributed as dist
        box: List[Any] = [None]
        dist.broadcast_object_list(box, src=0, group=self._group)
        return box[0]

    def due(self) -> bool:
        """Has the leader been silent for a heartbeat's length?"""
        return time.monotonic() - self._last >= HEARTBEAT_SECONDS
