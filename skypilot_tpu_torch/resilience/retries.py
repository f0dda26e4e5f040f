"""One retry policy: backoff, jitter and a deadline budget.

The port's copy of `skypilot_tpu/resilience/retries.py`: `RetryPolicy`
(:46-82), `call` (:85-124), `_one_attempt` (:127-141) and `retrying`
(:144-151), with the standard library's `logging` for the reference's
`sky_logging`. `train/loop.py` saves its checkpoints through it.

Semantics, as the reference's:
- exponential backoff with full jitter:
  delay = uniform(0, min(max_delay, base_delay * 2**attempt));
- `deadline` is an elapsed-time budget across all attempts;
- `attempt_timeout` bounds one attempt by running it on a worker
  thread; a timed-out attempt counts as a failure (the thread is
  abandoned).

`sleep_fn`, `now_fn` and `rng` are injectable, so a fake clock advanced
by the fake sleep makes every schedule exact in tests.
"""
import dataclasses
import functools
import logging
import random
import time
from typing import Callable, Optional, Tuple, Type

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How to retry: attempt count, backoff shape, time budgets.

    max_attempts=None means attempts are unbounded and only `deadline`
    stops the loop.
    """
    max_attempts: Optional[int] = 3
    base_delay: float = 1.0
    max_delay: float = 60.0
    deadline: Optional[float] = None
    attempt_timeout: Optional[float] = None
    exponential: bool = True
    jitter: bool = True

    def __post_init__(self):
        if self.max_attempts is not None and self.max_attempts < 1:
            raise ValueError('max_attempts must be >= 1 (or None)')
        if self.base_delay < 0 or self.max_delay < self.base_delay:
            raise ValueError('need 0 <= base_delay <= max_delay')
        if self.max_attempts is None and self.deadline is None:
            raise ValueError(
                'unbounded attempts require a deadline budget')

    def delay(self, attempt: int, rng: Callable[[], float]) -> float:
        """Backoff before attempt `attempt + 1` (0-based)."""
        if self.exponential:
            cap = min(self.max_delay,
                      self.base_delay * (2.0 ** attempt))
        else:
            cap = min(self.max_delay, self.base_delay)
        if self.jitter:
            return rng() * cap
        return cap


def call(fn: Callable,
         policy: RetryPolicy,
         retry_on: Tuple[Type[BaseException], ...] = (Exception,),
         on_retry: Optional[Callable[[BaseException, int], None]] = None,
         describe: str = '',
         sleep_fn: Callable[[float], None] = time.sleep,
         now_fn: Callable[[], float] = time.monotonic,
         rng: Callable[[], float] = random.random):
    """Run `fn()` under `policy`; re-raise the last error on exhaustion.

    `on_retry(exc, attempt)` fires between attempts, where a caller
    tears down partial state before the next attempt.
    """
    start = now_fn()
    what = describe or getattr(fn, '__name__', 'operation')
    attempt = 0
    while True:
        try:
            return _one_attempt(fn, policy)
        except retry_on as e:
            attempt += 1
            out_of_attempts = (policy.max_attempts is not None and
                               attempt >= policy.max_attempts)
            delay = policy.delay(attempt - 1, rng)
            over_budget = (policy.deadline is not None and
                           now_fn() - start + delay > policy.deadline)
            if out_of_attempts or over_budget:
                reason = ('budget exhausted' if over_budget
                          else 'attempts exhausted')
                logger.warning('%s failed (%s after %d attempt(s)): %s',
                               what, reason, attempt, e)
                raise
            logger.debug('%s attempt %d failed (%s); retrying in '
                         '%.1fs', what, attempt, e, delay)
            if on_retry is not None:
                on_retry(e, attempt)
            if delay > 0:
                sleep_fn(delay)


def _one_attempt(fn: Callable, policy: RetryPolicy):
    if policy.attempt_timeout is None:
        return fn()
    import concurrent.futures
    # One worker per attempt: a fresh attempt must not queue behind an
    # abandoned (still-running) timed-out one.
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        fut = pool.submit(fn)
        try:
            return fut.result(timeout=policy.attempt_timeout)
        except concurrent.futures.TimeoutError:
            raise TimeoutError(
                f'attempt exceeded {policy.attempt_timeout:.1f}s')
    finally:
        pool.shutdown(wait=False)


def retrying(policy: RetryPolicy,
             retry_on: Tuple[Type[BaseException], ...] = (Exception,),
             **call_kwargs):
    """Decorator form of `call` for functions that own their policy."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return call(functools.partial(fn, *args, **kwargs),
                        policy=policy, retry_on=retry_on,
                        describe=fn.__name__, **call_kwargs)
        return wrapper
    return deco
