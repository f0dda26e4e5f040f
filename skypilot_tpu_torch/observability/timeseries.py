"""In-process time-series ring over the skytpu_* metrics registry.

The port's copy of `skypilot_tpu/observability/timeseries.py`:
`TimeSeriesStore` (with its injectable `now=` on every mutating and
query call), `quantile_from_buckets`, the `Sampler` thread with
`start_sampler`/`stop_sampler`, and `query_response`. The reference's
aiohttp handler becomes `handler(params, store=None)`, which returns
the JSON document for the port's stdlib server.

- `TimeSeriesStore.sample_now()` appends one structured
  `Registry.collect()` snapshot to a bounded ring per series.
- Memory is hard-bounded: `SKYTPU_TS_CAPACITY` samples per series,
  `SKYTPU_TS_MAX_SERIES` series in all; past the series cap new
  series only displace stale ones, and fresh churn is dropped and
  counted.
- Windowed queries: counter rate/increase with counter-reset clamping,
  gauge min/mean/max/last, and histogram quantiles from bucket deltas
  (bucket upper bound, as `quantile_from_buckets` resolves it).
- `/internal/timeseries` serves both raw dumps (the `top` feed) and
  one-shot windowed queries.
"""
import collections
import math
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from skypilot_tpu_torch import envs
from skypilot_tpu_torch.observability import metrics as metrics_lib

# Series kinds stored (untyped custom metrics sample as gauges: the
# store has no way to know their delta semantics).
_SCALAR_KINDS = {'counter', 'gauge'}

LabelPairs = Tuple[Tuple[str, str], ...]


def quantile_from_buckets(buckets: Iterable[Tuple[float, float]],
                          count: float, q: float) -> float:
    """Resolve a quantile from (bucket upper bound, cumulative count)
    pairs — EXACTLY the convention fleetsim's SLOEvaluator uses:
    first bucket whose cumulative count reaches q*count wins, the
    reported value is its upper bound (conservative: the true value
    is <= the reported one). math.inf when nothing resolves."""
    value = math.inf
    for bound, cum in sorted(buckets):
        if cum >= q * count:
            value = bound
            break
    return value


class _Series:
    __slots__ = ('kind', 'labels', 'samples', 'last_pass')

    def __init__(self, kind: str, labels: LabelPairs,
                 capacity: int) -> None:
        self.kind = kind
        self.labels = labels
        # Ring buffer: deque(maxlen=) drops the oldest sample on
        # overflow — wraparound is silent and allocation-free.
        self.samples: collections.deque = collections.deque(
            maxlen=capacity)
        self.last_pass = 0


class TimeSeriesStore:
    """Bounded per-process store of sampled skytpu_* series.

    Scalar samples are `(ts, value)`. Histogram samples are
    `(ts, cumulative_counts_incl_inf, sum, count)` — full cumulative
    bucket vectors, so any window's quantile resolves from the delta
    of two retained samples without having seen the samples between.
    """

    def __init__(self, capacity: Optional[int] = None,
                 max_series: Optional[int] = None,
                 registry: Optional[metrics_lib.Registry] = None
                 ) -> None:
        self._capacity_override = capacity
        self._max_series_override = max_series
        self._registry = registry
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, LabelPairs], _Series] = {}
        self._buckets: Dict[str, Tuple[float, ...]] = {}
        self._pass = 0
        self.dropped_series = 0
        self.evicted_series = 0

    # -- configuration seams --------------------------------------------------

    def _capacity(self) -> int:
        if self._capacity_override is not None:
            return max(2, int(self._capacity_override))
        return max(2, envs.SKYTPU_TS_CAPACITY.get())

    def _max_series(self) -> int:
        if self._max_series_override is not None:
            return max(1, int(self._max_series_override))
        return max(1, envs.SKYTPU_TS_MAX_SERIES.get())

    # -- ingest ---------------------------------------------------------------

    def _admit_locked(self, key: Tuple[str, LabelPairs], kind: str,
               stale: List[Tuple[str, LabelPairs]]
               ) -> Optional[_Series]:
        """Admit a new series under the cap; evict one stale series
        (not updated this pass) to make room, else drop the newcomer.
        Established live series are never displaced by churn."""
        if len(self._series) >= self._max_series():
            if not stale:
                self.dropped_series += 1
                return None
            del self._series[stale.pop()]
            self.evicted_series += 1
        s = _Series(kind, key[1], self._capacity())
        self._series[key] = s
        return s

    def _append_locked(self, key: Tuple[str, LabelPairs], kind: str,
                sample: tuple,
                stale: List[Tuple[str, LabelPairs]]) -> None:
        s = self._series.get(key)
        if s is None:
            s = self._admit_locked(key, kind, stale)
            if s is None:
                return
        s.samples.append(sample)
        s.last_pass = self._pass

    def _stale_keys_locked(self) -> List[Tuple[str, LabelPairs]]:
        """Eviction candidates, stalest last (so list.pop() takes the
        stalest first). Computed once per ingest pass, not per
        admission — churny passes stay O(n log n), not O(n^2)."""
        if len(self._series) < self._max_series():
            return []
        current = self._pass
        stale = [(s.last_pass, key)
                 for key, s in self._series.items()
                 if s.last_pass < current]
        stale.sort(reverse=True)
        return [key for _, key in stale]

    def sample_now(self, now: Optional[float] = None,
                   names: Optional[Iterable[str]] = None) -> int:
        """Append one registry snapshot; returns series touched.
        `names` restricts the pass to those metric families (the
        autoscaler signal source samples just its two histograms per
        controller tick instead of the whole fleet's registry)."""
        ts = time.time() if now is None else float(now)
        registry = self._registry or metrics_lib.REGISTRY
        wanted = set(names) if names is not None else None
        families = [f for f in registry.collect()
                    if wanted is None or f.name in wanted]
        touched = 0
        with self._lock:
            self._pass += 1
            stale = self._stale_keys_locked()
            for fam in families:
                if fam.buckets is not None:
                    self._buckets[fam.name] = fam.buckets
                    for point in fam.histograms:
                        labels = tuple(zip(fam.labelnames,
                                           point.labelvalues))
                        self._append_locked(
                            (fam.name, labels), 'histogram',
                            (ts,
                             point.cumulative + (float(point.count),),
                             point.sum, point.count),
                            stale)
                        touched += 1
                    continue
                kind = fam.kind if fam.kind in _SCALAR_KINDS \
                    else 'gauge'
                for _series, labelpairs, value in fam.scalars:
                    self._append_locked((fam.name, labelpairs), kind,
                                 (ts, value), stale)
                    touched += 1
        return touched

    def add_sample(self, name: str, labels: Dict[str, str],
                   value: float, now: Optional[float] = None,
                   kind: str = 'gauge') -> None:
        """Append one synthetic scalar sample (series that exist only
        in the store, e.g. the LB's per-replica skytpu_replica_up)."""
        ts = time.time() if now is None else float(now)
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._pass += 1
            self._append_locked(key, kind, (ts, float(value)),
                         self._stale_keys_locked())

    def ingest_dump(self, doc: Dict[str, Any],
                    extra_labels: Optional[Dict[str, str]] = None
                    ) -> int:
        """Merge another process's dump() into this store, optionally
        stamping every series with extra labels — the LB federation
        path (`extra_labels={'replica': url}` keeps one replica's
        series distinguishable from another's and from the LB's own).
        Remote timestamps are kept as-is."""
        extra = tuple(sorted((extra_labels or {}).items()))
        ingested = 0
        with self._lock:
            self._pass += 1
            stale = self._stale_keys_locked()
            for row in doc.get('series', ()):
                name = row.get('name')
                kind = row.get('kind', 'gauge')
                if not name:
                    continue
                labels = tuple(sorted(
                    dict(row.get('labels') or {}).items())) + extra
                if kind == 'histogram':
                    buckets = tuple(float(b)
                                    for b in row.get('buckets') or ())
                    if buckets:
                        self._buckets.setdefault(name, buckets)
                    for s in row.get('samples', ()):
                        ts, cum, total, count = s
                        self._append_locked((name, labels), kind,
                                     (float(ts),
                                      tuple(float(c) for c in cum),
                                      float(total), float(count)),
                                     stale)
                        ingested += 1
                else:
                    for ts, value in row.get('samples', ()):
                        self._append_locked((name, labels), kind,
                                     (float(ts), float(value)), stale)
                        ingested += 1
        return ingested

    # -- introspection --------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                'series': len(self._series),
                'samples': sum(len(s.samples)
                               for s in self._series.values()),
                'capacity': self._capacity(),
                'max_series': self._max_series(),
                'dropped_series': self.dropped_series,
                'evicted_series': self.evicted_series,
            }

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self._buckets.clear()
            self._pass = 0
            self.dropped_series = 0
            self.evicted_series = 0

    def _matching(self, name: str,
                  labels: Optional[Dict[str, str]]) -> List[_Series]:
        """Series of `name` whose labels CONTAIN `labels` (subset
        match — {'replica': url} selects one replica's series while
        None aggregates the fleet)."""
        want = tuple((labels or {}).items())
        out = []
        with self._lock:
            for (sname, _), s in self._series.items():
                if sname != name:
                    continue
                have = dict(s.labels)
                if all(have.get(k) == v for k, v in want):
                    out.append(s)
        return out

    def dump(self, since: Optional[float] = None,
             names: Optional[Iterable[str]] = None,
             labels: Optional[Dict[str, str]] = None
             ) -> Dict[str, Any]:
        """JSON-portable snapshot of retained samples (optionally only
        samples newer than `since`) — the federation / `top` wire
        format ingest_dump() round-trips."""
        wanted = set(names) if names is not None else None
        want = tuple((labels or {}).items())
        rows = []
        with self._lock:
            for (name, _), s in sorted(self._series.items()):
                if wanted is not None and name not in wanted:
                    continue
                have = dict(s.labels)
                if not all(have.get(k) == v for k, v in want):
                    continue
                samples = [smp for smp in s.samples
                           if since is None or smp[0] > since]
                if not samples:
                    continue
                row: Dict[str, Any] = {
                    'name': name,
                    'kind': s.kind,
                    'labels': dict(s.labels),
                }
                if s.kind == 'histogram':
                    row['buckets'] = list(self._buckets.get(name, ()))
                    row['samples'] = [
                        [ts, list(cum), total, count]
                        for ts, cum, total, count in samples]
                else:
                    row['samples'] = [[ts, v] for ts, v in samples]
                rows.append(row)
        return {'now': time.time(), 'series': rows}

    # -- windowed queries -----------------------------------------------------

    def _window(self, s: _Series, window: float,
                now: Optional[float]) -> List[tuple]:
        samples = list(s.samples)
        if not samples:
            return []
        end = samples[-1][0] if now is None else float(now)
        lo = end - window
        return [smp for smp in samples if lo <= smp[0] <= end]

    def counter_increase(self, name: str,
                         labels: Optional[Dict[str, str]] = None,
                         window: float = 60.0,
                         now: Optional[float] = None
                         ) -> Optional[float]:
        """Total increase over the window, summed across matching
        series, CLAMPED at counter resets: a sample below its
        predecessor means the process restarted, so the increase
        since the reset is the new absolute value — never a negative
        contribution. None when no series holds >= 2 samples."""
        total = None
        for s in self._matching(name, labels):
            win = self._window(s, window, now)
            if len(win) < 2:
                continue
            inc = 0.0
            prev = win[0][1]
            for _, value in win[1:]:
                inc += value - prev if value >= prev else value
                prev = value
            total = inc if total is None else total + inc
        return total

    def counter_rate(self, name: str,
                     labels: Optional[Dict[str, str]] = None,
                     window: float = 60.0,
                     now: Optional[float] = None) -> Optional[float]:
        """Per-second rate over the window (reset-clamped increase /
        observed span). None when no series spans the window."""
        total = 0.0
        span = 0.0
        seen = False
        for s in self._matching(name, labels):
            win = self._window(s, window, now)
            if len(win) < 2:
                continue
            inc = 0.0
            prev = win[0][1]
            for _, value in win[1:]:
                inc += value - prev if value >= prev else value
                prev = value
            total += inc
            span = max(span, win[-1][0] - win[0][0])
            seen = True
        if not seen or span <= 0:
            return None
        return total / span

    def gauge_stats(self, name: str,
                    labels: Optional[Dict[str, str]] = None,
                    window: float = 60.0,
                    now: Optional[float] = None
                    ) -> Optional[Dict[str, float]]:
        """min/mean/max/last over the window across matching series
        (last = the newest sample among them). None when empty."""
        values: List[float] = []
        last_ts = -math.inf
        last = None
        for s in self._matching(name, labels):
            win = self._window(s, window, now)
            for ts, value in win:
                values.append(value)
                if ts >= last_ts:
                    last_ts, last = ts, value
        if not values:
            return None
        return {'min': min(values),
                'mean': sum(values) / len(values),
                'max': max(values),
                'last': last,
                'count': float(len(values))}

    def hist_delta(self, name: str,
                   labels: Optional[Dict[str, str]] = None,
                   window: Optional[float] = 60.0,
                   now: Optional[float] = None,
                   since: Optional[float] = None
                   ) -> Optional[Tuple[List[Tuple[float, float]],
                                       float]]:
        """Aggregate histogram delta over the window: ([(bucket bound
        incl +Inf, cumulative delta)], sample count). Per series, the
        delta is newest-sample minus the oldest window sample (or the
        newest sample <= `since` when given; zero baseline when the
        series has no earlier sample — 'everything so far'). A
        restart (count going DOWN) clamps to the newest absolutes:
        everything since the restart counts, nothing goes negative."""
        bounds = self._buckets.get(name)
        if bounds is None:
            return None
        n_buckets = len(bounds) + 1
        agg = [0.0] * n_buckets
        count = 0.0
        seen = False
        for s in self._matching(name, labels):
            if s.kind != 'histogram':
                continue
            samples = list(s.samples)
            if not samples:
                continue
            if since is not None:
                win = samples
                base = None
                for smp in samples:
                    if smp[0] <= since:
                        base = smp
                last = samples[-1]
                if base is last:
                    continue
            elif window is None:
                base, last = None, samples[-1]
            else:
                win = self._window(s, window, now)
                if not win:
                    continue
                last = win[-1]
                base = win[0] if len(win) > 1 else None
                if base is not None and len(win) == len(samples) \
                        and len(samples) < (s.samples.maxlen or 0):
                    # The window holds the series' entire unwrapped
                    # history: the first sample already carries
                    # everything observed before sampling began, so
                    # the baseline is zero, not that first sample —
                    # else a freshly started process reports empty
                    # windows for activity it just served.
                    base = None
            _, last_cum, _, last_n = last
            if base is None or base[3] > last_n:
                # No baseline, or the counter went backwards
                # (restart): the newest absolutes ARE the delta.
                deltas = list(last_cum)
                dcount = float(last_n)
            else:
                deltas = [max(0.0, a - b)
                          for a, b in zip(last_cum, base[1])]
                dcount = float(last_n - base[3])
            for i in range(min(n_buckets, len(deltas))):
                agg[i] += deltas[i]
            count += dcount
            seen = True
        if not seen:
            return None
        pairs = [(b, agg[i]) for i, b in enumerate(bounds)]
        pairs.append((math.inf, agg[-1]))
        return pairs, count

    def hist_mean(self, name: str,
                  labels: Optional[Dict[str, str]] = None,
                  window: float = 60.0,
                  now: Optional[float] = None,
                  min_count: int = 1) -> Optional[float]:
        """Windowed mean from sum/count deltas (restart-clamped like
        hist_delta). The anomaly detector feeds on this: unlike a
        bucket quantile it moves continuously, so EWMA deviations are
        meaningful."""
        total = 0.0
        count = 0.0
        seen = False
        for s in self._matching(name, labels):
            if s.kind != 'histogram':
                continue
            win = self._window(s, window, now)
            if not win:
                continue
            last = win[-1]
            base = win[0] if len(win) > 1 else None
            if base is not None and len(win) == len(s.samples) \
                    and len(s.samples) < (s.samples.maxlen or 0):
                base = None     # whole unwrapped history: zero base
            if base is None or base[3] > last[3]:
                dsum, dcount = last[2], float(last[3])
            else:
                dsum = max(0.0, last[2] - base[2])
                dcount = float(last[3] - base[3])
            total += dsum
            count += dcount
            seen = True
        if not seen or count < min_count or count <= 0:
            return None
        return total / count

    def hist_quantile(self, name: str, q: float = 0.95,
                      labels: Optional[Dict[str, str]] = None,
                      window: float = 60.0,
                      now: Optional[float] = None,
                      min_count: int = 1) -> Optional[float]:
        """Windowed quantile from bucket deltas, resolved exactly as
        fleetsim's SLO evaluator resolves it (bucket upper bound;
        math.inf when it lands past the top finite bucket). None when
        the window saw fewer than min_count samples."""
        delta = self.hist_delta(name, labels, window, now)
        if delta is None:
            return None
        pairs, count = delta
        if count < min_count:
            return None
        return quantile_from_buckets(pairs, count, q)


# The process-wide store, fed by the background Sampler (and by
# whoever else calls sample_now — the autoscaler signal source
# samples its own metrics through this same instance).
STORE = TimeSeriesStore()


class Sampler:
    """Daemon thread sampling the registry into STORE every
    SKYTPU_TS_SAMPLE_SECONDS (re-read each lap, so the knob can be
    changed without restarting in tests)."""

    def __init__(self, store: Optional[TimeSeriesStore] = None,
                 interval: Optional[float] = None) -> None:
        self._store = store or STORE
        self._interval_override = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _interval(self) -> float:
        if self._interval_override is not None:
            return self._interval_override
        return envs.SKYTPU_TS_SAMPLE_SECONDS.get()

    def _run(self) -> None:
        while not self._stop.is_set():
            interval = self._interval()
            if interval <= 0:
                return
            if self._stop.wait(interval):
                return
            try:
                self._store.sample_now()
            except Exception:  # noqa: BLE001 — telemetry must never
                # take down the plane it observes.
                pass

    def start(self) -> bool:
        if self._interval() <= 0:
            return False
        if self._thread is not None and self._thread.is_alive():
            return True
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name='skytpu-ts-sampler', daemon=True)
        self._thread.start()
        return True

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


_SAMPLER: Optional[Sampler] = None
_SAMPLER_LOCK = threading.Lock()


def start_sampler() -> bool:
    """Start (idempotently) the process-wide background sampler;
    False when SKYTPU_TS_SAMPLE_SECONDS disables it."""
    global _SAMPLER
    with _SAMPLER_LOCK:
        if _SAMPLER is None:
            _SAMPLER = Sampler()
        return _SAMPLER.start()


def sampler_running() -> bool:
    """Whether the process-wide sampler's thread is alive (a caller that
    starts it only when it is not can stop it again without stopping
    another owner's)."""
    with _SAMPLER_LOCK:
        return _SAMPLER is not None and _SAMPLER._thread is not None \
            and _SAMPLER._thread.is_alive()  # noqa: SLF001


def stop_sampler() -> None:
    with _SAMPLER_LOCK:
        if _SAMPLER is not None:
            _SAMPLER.stop()


# -- HTTP plane -----------------------------------------------------------


def _json_safe(value):
    if value is None:
        return None
    if value != value:  # NaN
        return None
    if value in (math.inf, -math.inf):
        return 'inf' if value > 0 else '-inf'
    return value


def query_response(store: TimeSeriesStore,
                   params: Dict[str, str]) -> Dict[str, Any]:
    """One windowed query over `store`, shaped for JSON. `params` is
    the /internal/timeseries query string: query=rate|increase|gauge|
    quantile, metric=..., window=seconds, q=0.95, plus label filters
    as labels=k=v,k2=v2 (replica=... is shorthand for the federation
    label)."""
    kind = params.get('query', 'rate')
    metric = params.get('metric', '')
    window = float(params.get('window',
                              envs.SKYTPU_WATCHDOG_WINDOW_SECONDS
                              .get()))
    labels: Dict[str, str] = {}
    for pair in (params.get('labels') or '').split(','):
        if '=' in pair:
            k, v = pair.split('=', 1)
            labels[k.strip()] = v.strip()
    if params.get('replica'):
        labels['replica'] = params['replica']
    out: Dict[str, Any] = {'query': kind, 'metric': metric,
                           'window_s': window,
                           'labels': labels or None}
    if kind == 'rate':
        out['value'] = _json_safe(
            store.counter_rate(metric, labels or None, window))
    elif kind == 'increase':
        out['value'] = _json_safe(
            store.counter_increase(metric, labels or None, window))
    elif kind == 'gauge':
        stats = store.gauge_stats(metric, labels or None, window)
        out['value'] = None if stats is None else \
            {k: _json_safe(v) for k, v in stats.items()}
    elif kind == 'quantile':
        q = float(params.get('q', 0.95))
        out['q'] = q
        out['value'] = _json_safe(store.hist_quantile(
            metric, q, labels or None, window,
            min_count=int(params.get('min_count', 1))))
    else:
        out['error'] = f'unknown query {kind!r}'
    return out


def handler(params: Dict[str, str],
            store: Optional[TimeSeriesStore] = None) -> Dict[str, Any]:
    """The /internal/timeseries document for query-string `params`
    (the reference's aiohttp_handler): no `query` -> a raw dump (the
    `top` feed, `since=` bounds it); with `query=` -> one windowed
    answer."""
    store = store or STORE
    if 'query' in params:
        return query_response(store, params)
    since = params.get('since')
    names = params.get('names')
    doc = store.dump(
        since=float(since) if since else None,
        names=names.split(',') if names else None,
        labels={'replica': params['replica']}
        if params.get('replica') else None)
    doc['stats'] = store.stats()
    return doc
