"""Circuit breakers keyed by target (closed -> open -> half-open).

The port's copy of `skypilot_tpu/resilience/circuit.py`: `State` (:29),
`CircuitBreaker` (:48) with `allow` (:76), `record_success` (:118),
`record_failure` (:128), `forget` (:156), `_set_state` (:168) and the
`on_open` hook, with stdlib `logging` for the reference's `sky_logging`.

A breaker protects callers from hammering a target that keeps failing
(a flapping replica, a wedged probe endpoint): after
`failure_threshold` consecutive failures the circuit OPENS and calls
are rejected without touching the target; after `recovery_timeout`
the circuit goes HALF-OPEN and admits a bounded number of trial calls
— one success re-closes it, one failure re-opens it (and restarts the
timer).

State is exported through the observability registry
(`skytpu_circuit_state`, `skytpu_circuit_open_total`) so an open
circuit shows up in any /metrics scrape, not just in logs.

Thread-safe: the load balancer's handler threads record outcomes
concurrently.
"""
import enum
import logging
import threading
import time
from typing import Callable, Dict, Optional

from skypilot_tpu_torch.observability import instruments as obs

logger = logging.getLogger(__name__)


class State(enum.IntEnum):
    """Gauge encoding (documented in the metric help string)."""
    CLOSED = 0
    OPEN = 1
    HALF_OPEN = 2


class _Target:
    __slots__ = ('state', 'failures', 'opened_at', 'half_open_inflight',
                 'half_open_since')

    def __init__(self):
        self.state = State.CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self.half_open_inflight = 0
        self.half_open_since = 0.0


class CircuitBreaker:
    """One named breaker group; per-target independent circuits."""

    def __init__(self, name: str,
                 failure_threshold: int = 3,
                 recovery_timeout: float = 30.0,
                 half_open_max_calls: int = 1,
                 now_fn: Callable[[], float] = time.monotonic,
                 on_open: Optional[Callable[[str], None]] = None):
        if failure_threshold < 1:
            raise ValueError('failure_threshold must be >= 1')
        if recovery_timeout < 0:
            raise ValueError('recovery_timeout must be >= 0')
        self.name = name
        self.failure_threshold = failure_threshold
        self.recovery_timeout = recovery_timeout
        self.half_open_max_calls = half_open_max_calls
        # Fired (outside the breaker lock) each time a target's
        # circuit transitions to OPEN — the LB hooks its trace
        # flight-recorder dump here, so the evidence of WHAT was
        # failing ships the moment the breaker gives up on a target.
        self._on_open = on_open
        self._now = now_fn
        self._lock = threading.Lock()
        self._targets: Dict[str, _Target] = {}

    # -- queries -------------------------------------------------------------

    def allow(self, target: str) -> bool:
        """May the caller contact `target` now? Drives the open ->
        half-open transition as a side effect of asking."""
        with self._lock:
            t = self._targets.get(target)
            if t is None or t.state == State.CLOSED:
                return True
            now = self._now()
            if t.state == State.OPEN:
                if now - t.opened_at < self.recovery_timeout:
                    return False
                self._set_state(t, target, State.HALF_OPEN)
                t.half_open_inflight = 0
                t.half_open_since = now
            # HALF_OPEN: admit a bounded number of trial calls. Trial
            # slots EXPIRE after another recovery window — a trial
            # whose caller never reported an outcome (client vanished
            # mid-proxy) must not wedge the target rejected forever.
            if t.half_open_inflight >= self.half_open_max_calls:
                if now - t.half_open_since < self.recovery_timeout:
                    return False
                t.half_open_inflight = 0
                t.half_open_since = now
            t.half_open_inflight += 1
            return True

    def state(self, target: str) -> State:
        with self._lock:
            t = self._targets.get(target)
            return t.state if t is not None else State.CLOSED

    def snapshot(self) -> Dict[str, State]:
        """Target -> state for every tracked target, WITHOUT driving
        the open -> half-open transition (allow() mutates; a stats
        endpoint polled by dashboards must not burn half-open trial
        slots)."""
        with self._lock:
            return {target: t.state
                    for target, t in self._targets.items()}

    # -- outcome feedback ----------------------------------------------------

    def record_success(self, target: str) -> None:
        with self._lock:
            t = self._targets.get(target)
            if t is None:
                return
            if t.state != State.CLOSED:
                self._set_state(t, target, State.CLOSED)
            t.failures = 0
            t.half_open_inflight = 0

    def record_failure(self, target: str) -> None:
        opened = False
        with self._lock:
            t = self._targets.setdefault(target, _Target())
            t.failures += 1
            if t.state == State.HALF_OPEN or (
                    t.state == State.CLOSED and
                    t.failures >= self.failure_threshold):
                self._set_state(t, target, State.OPEN)
                t.opened_at = self._now()
                t.half_open_inflight = 0
                opened = True
                obs.CIRCUIT_OPEN.labels(breaker=self.name,
                                        target=target).inc()
                logger.warning(
                    'circuit %s/%s OPEN after %d consecutive '
                    'failure(s); retry in %.0fs', self.name, target,
                    t.failures, self.recovery_timeout)
        if opened and self._on_open is not None:
            # Outside the lock: the callback may query this breaker
            # (or do slow I/O like a trace dump) without deadlocking
            # the record path.
            try:
                self._on_open(target)
            except Exception:  # diagnostics must never break serving
                logger.warning('on_open callback failed for %s/%s',
                               self.name, target, exc_info=True)

    def forget(self, target: str) -> None:
        """Drop a target (replica scaled down): its gauge reads closed
        so a dead endpoint never looks permanently broken."""
        with self._lock:
            t = self._targets.pop(target, None)
            if t is not None:
                obs.CIRCUIT_STATE.labels(
                    breaker=self.name, target=target).set(
                        float(State.CLOSED))

    # -- internals -----------------------------------------------------------

    def _set_state(self, t: _Target, target: str, state: State) -> None:
        t.state = state
        obs.CIRCUIT_STATE.labels(breaker=self.name,
                                 target=target).set(float(state))
