"""Deterministic fault injection: named points the stack checks inline.

The port's copy of `skypilot_tpu/resilience/faults.py`: `declare`,
`registered_points`, `arm`/`disarm`/`reset`/`hits`, the
`SKYTPU_FAULTS` parser, `inject`, `armed_points` and `FaultInjected`,
with stdlib `logging` for the reference's `sky_logging`. Hot paths
call `faults.inject('<point>')`; unarmed, that is a dict lookup.
Armed (by a test, or by SKYTPU_FAULTS on a live process), it raises
and/or adds latency for a bounded number of hits, and each firing
counts in `skytpu_faults_injected_total{point}`.

The catalog holds the points the port reaches, with the reference's
names, so one `SKYTPU_FAULTS` drill arms either package:
`engine.snapshot` and `engine.handoff_lease` (the engine's migration
seams), `checkpoint.save` (`train/checkpoints.save_train_state`,
before a byte is written), and the load balancer's `lb.upstream`,
`lb.upstream_midstream`, `lb.migrate` and `lb.handoff`
(`serve/load_balancer.py`), the serve control plane's
`provision.launch`, `probe.http` and `controller.step`, and the fleet
simulator's `fleet.zone_loss`, `fleet.preemption_wave` and
`replica.preempt`.

    faults.arm('engine.snapshot', times=1)
    ...
    faults.reset()   # in teardown

    SKYTPU_FAULTS='engine.snapshot:2,engine.handoff_lease:forever'

Env grammar: comma-separated `point[:times[:latency_seconds]]` where
times is an int or `forever`. Env-armed faults raise FaultInjected.
"""
import logging
import re
import threading
import time
from typing import Callable, Dict, List, Optional

from skypilot_tpu_torch import envs
from skypilot_tpu_torch.observability import instruments as obs

logger = logging.getLogger(__name__)

POINT_RE = re.compile(r'^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$')


class FaultInjected(Exception):
    """Default exception an armed fault raises (env-armed faults
    always raise this; tests usually arm the exception type the call
    site actually handles, e.g. OSError for the LB upstream hop)."""


# -- the fault-point catalog ----------------------------------------------
# Declared centrally (like observability/instruments.py), so importing
# one module lists every point.

_POINTS: Dict[str, str] = {}


def declare(name: str, description: str) -> str:
    if not POINT_RE.fullmatch(name):
        raise ValueError(
            f'fault point {name!r} must match {POINT_RE.pattern} '
            '(plane.operation, lowercase)')
    if name in _POINTS:
        raise ValueError(f'duplicate fault point {name!r}')
    if not description or len(description.strip()) < 10:
        raise ValueError(f'fault point {name!r} needs a description')
    _POINTS[name] = description
    return name


CHECKPOINT_SAVE = declare(
    'checkpoint.save',
    'Writing one training checkpoint (the save + its completeness '
    'sentinel).')
ENGINE_SNAPSHOT = declare(
    'engine.snapshot',
    'Serializing one in-flight request\'s KV pages + host state into '
    'a migration blob (fires before any device reads, so an armed '
    'fault models a snapshot that never materializes).')
ENGINE_HANDOFF_LEASE = declare(
    'engine.handoff_lease',
    'The engine granting a handoff lease — pausing a request at the '
    'prefill->decode boundary with its slot held live; an armed '
    'fault refuses the lease, so the request decodes co-located and '
    'no handoff frame is exported.')

LB_UPSTREAM = declare(
    'lb.upstream',
    'The load balancer contacting one upstream replica for a proxied '
    'request (fires before any response bytes are written).')
LB_UPSTREAM_MIDSTREAM = declare(
    'lb.upstream_midstream',
    'The load balancer reading the NEXT body chunk from an upstream '
    'that already sent response bytes (fires mid-stream, after the '
    'client saw headers — failover is no longer possible).')
LB_MIGRATE = declare(
    'lb.migrate',
    'The load balancer migrating one interrupted stream: snapshot '
    'fetch + restore re-route (fires once per interrupted request, '
    'before the first restore attempt).')
LB_HANDOFF = declare(
    'lb.handoff',
    'The load balancer walking the planned prefill->decode handoff '
    'ladder for one request (fires once per handoff frame, before '
    'the first decode-pool restore attempt); an armed fault forces '
    'the co-located /internal/resume fallback.')

# The serve control plane (serve/controller.py, replica_managers.py)
# and the fleet simulator's chaos (fleetsim/replicas.py).
PROVISION_LAUNCH = declare(
    'provision.launch',
    'Launching a cluster/replica through the provision plane (cloud '
    'API create + execution.launch call sites).')
PROBE_HTTP = declare(
    'probe.http',
    'One readiness-probe HTTP round against a replica endpoint.')
CONTROLLER_STEP = declare(
    'controller.step',
    'One serve-controller reconcile tick (probe -> autoscale -> LB '
    'sync); arming with latency simulates a stalled controller, with '
    'an exception a crashed tick.')
FLEET_ZONE_LOSS = declare(
    'fleet.zone_loss',
    'One replica killed by a simulated zone outage (fleetsim chaos '
    'schedules arm this while a zone is marked lost; each firing is '
    'one replica down).')
FLEET_PREEMPTION_WAVE = declare(
    'fleet.preemption_wave',
    'One spot replica killed by a simulated preemption wave; the '
    'armed `times` bound IS the wave size, so '
    'SKYTPU_FAULTS=fleet.preemption_wave:300 preempts 300 replicas.')
REPLICA_PREEMPT = declare(
    'replica.preempt',
    'One replica receiving a preemption notice mid-decode (fleetsim '
    'chaos arms this to kill replicas that hold in-flight requests, '
    'exercising the drain -> snapshot -> migrate ladder).')


def registered_points() -> Dict[str, str]:
    return dict(_POINTS)


# -- arming ----------------------------------------------------------------

# Default-exception sentinel: distinct from None (None = latency-only
# fault). A fresh FaultInjected is constructed per firing — a shared
# instance raised concurrently would race on __traceback__.
_DEFAULT_EXC = object()


class _Arm:
    __slots__ = ('times', 'exc', 'latency', 'hits', 'from_env')

    def __init__(self, times: Optional[int], exc,
                 latency: float, from_env: bool = False):
        self.times = times          # None = forever
        self.exc = exc              # None = latency-only fault
        self.latency = latency
        self.hits = 0
        # Env-armed faults carry no exception type of their own: the
        # call site supplies one via inject(env_exc=...) so the
        # failure looks like the real thing to its handlers.
        self.from_env = from_env


_lock = threading.Lock()
_armed: Dict[str, _Arm] = {}
_env_cache_raw: Optional[str] = None


def arm(point: str, times: Optional[int] = 1,
        exc=_DEFAULT_EXC,
        latency: float = 0.0) -> None:
    """Arm `point` to fail the next `times` injections (None=forever)
    with `exc` (None = add latency only), after `latency` seconds."""
    if point not in _POINTS:
        raise ValueError(f'unknown fault point {point!r}; declared: '
                         f'{sorted(_POINTS)}')
    if times is not None and times < 1:
        raise ValueError('times must be >= 1 or None (forever)')
    with _lock:
        _armed[point] = _Arm(times, exc, latency)


def disarm(point: str) -> None:
    with _lock:
        _armed.pop(point, None)


def reset() -> None:
    """Disarm everything (test teardown)."""
    global _env_cache_raw
    with _lock:
        _armed.clear()
        _env_cache_raw = None


def hits(point: str) -> int:
    """How many times `point` actually fired (test assertions)."""
    with _lock:
        a = _armed.get(point)
        return a.hits if a is not None else 0


def _load_env_locked() -> None:
    """Re-parse SKYTPU_FAULTS whenever its raw value changes: read at
    inject time, never cached at import (the import-time-env trap that
    bit SKYTPU_JOBS_RETRY_GAP)."""
    global _env_cache_raw
    raw = envs.SKYTPU_FAULTS.get()
    if raw == _env_cache_raw:
        return
    _env_cache_raw = raw
    # The env var is authoritative for env-armed points: a changed or
    # unset value must DISARM what it no longer lists (a chaos drill
    # must end when the operator unsets the variable).
    for point in [p for p, a in _armed.items() if a.from_env]:
        del _armed[point]
    for spec in filter(None, (s.strip() for s in raw.split(','))):
        parts = spec.split(':')
        point = parts[0]
        if point not in _POINTS:
            logger.warning('SKYTPU_FAULTS: unknown point %r ignored',
                           point)
            continue
        try:
            times: Optional[int] = 1
            if len(parts) > 1:
                times = (None if parts[1] == 'forever'
                         else int(parts[1]))
            latency = float(parts[2]) if len(parts) > 2 else 0.0
        except ValueError:
            # A typo'd env var must never take down the hot path it
            # was meant to test.
            logger.warning('SKYTPU_FAULTS: malformed spec %r ignored',
                           spec)
            continue
        existing = _armed.get(point)
        if existing is not None and not existing.from_env:
            # arm() (a test's explicit choice) outranks the env.
            continue
        _armed[point] = _Arm(times, _DEFAULT_EXC, latency,
                             from_env=True)


def inject(point: str,
           sleep_fn: Callable[[float], None] = time.sleep,
           env_exc: Optional[type] = None) -> None:
    """The hot-path hook: no-op unless `point` is armed.

    `env_exc` is the exception type an ENV-armed fault raises at this
    call site — the type the surrounding handlers treat as a real
    failure (e.g. OSError on the LB upstream hop), so chaos armed via
    SKYTPU_FAULTS exercises the recovery path instead of crashing it.
    Code-armed faults always raise exactly what the test supplied.
    """
    with _lock:
        _load_env_locked()
        a = _armed.get(point)
        if a is None:
            return
        if a.times is not None and a.hits >= a.times:
            return
        a.hits += 1
        latency, exc = a.latency, a.exc
        if exc is _DEFAULT_EXC:
            exc_type = (env_exc if (a.from_env and env_exc is not None)
                        else FaultInjected)
            exc = exc_type(f'injected fault at {point}')
    obs.FAULTS_INJECTED.labels(point=point).inc()
    logger.warning('fault injected at %s (latency=%.2fs, exc=%r)',
                   point, latency, exc)
    if latency > 0:
        sleep_fn(latency)
    if exc is not None:
        raise exc


def armed_points() -> List[str]:
    with _lock:
        _load_env_locked()
        return sorted(_armed)
