"""The virtual clock every simulated component shares.

The port of `skypilot_tpu/fleetsim/clock.py` (`VirtualClock`: `now`,
`sleep`, `advance`). One instance is injected everywhere a real
deployment reads time — controller hysteresis, LB QPS window, breaker
recovery timeouts, replica startup deadlines — so simulated minutes
advance in microseconds of wall time and every schedule is exactly
reproducible (the contract resilience/retries.py keeps with its
injectable now_fn/sleep_fn).
"""
import threading


class VirtualClock:
    """Monotonic simulated time. `now` is the now_fn seam, `sleep`
    the sleep_fn seam (sleeping ADVANCES the clock instead of
    blocking), `advance` moves it on by a tick."""

    def __init__(self, start: float = 0.0) -> None:
        self._t = float(start)
        # The controller tick thread and test assertions may race on
        # reads; advancing is cheap enough to serialize always.
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._t

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)

    def advance(self, seconds: float) -> float:
        if seconds < 0:
            raise ValueError(f'cannot rewind the clock ({seconds})')
        with self._lock:
            self._t += seconds
            return self._t
