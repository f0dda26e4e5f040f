"""Request-scoped tracing: one contextvar request ID per request.

The port's copy of `skypilot_tpu/observability/tracing.py`
(`get_request_id`, `new_request_id`, `bind`/`unbind`,
`request_scope`). A handler binds an ID once; everything that reads
the context within that thread sees it.

    from skypilot_tpu_torch.observability import tracing
    with tracing.request_scope() as rid:          # or request_scope(rid)
        ...

Contextvars do not follow work into another thread: code that hops
threads (the server's engine loop) captures the ID at the hop and
`bind()`s it on the other side.
"""
import contextlib
import contextvars
import uuid
from typing import Iterator, Optional

_request_id: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar('skytpu_request_id', default=None)


def get_request_id() -> Optional[str]:
    """The current request's ID, or None outside any request scope."""
    return _request_id.get()


def new_request_id(prefix: str = 'req') -> str:
    return f'{prefix}-{uuid.uuid4().hex[:12]}'


def bind(request_id: str) -> contextvars.Token:
    """Set the ID in the current context; returns the reset token.
    Prefer request_scope() — bind() is for thread hops where a with
    block can't span the handoff."""
    return _request_id.set(request_id)


def unbind(token: contextvars.Token) -> None:
    _request_id.reset(token)


@contextlib.contextmanager
def request_scope(request_id: Optional[str] = None) -> Iterator[str]:
    """Bind `request_id` (or a fresh one) for the duration of the
    block; yields the bound ID."""
    rid = request_id or new_request_id()
    token = _request_id.set(rid)
    try:
        yield rid
    finally:
        _request_id.reset(token)
