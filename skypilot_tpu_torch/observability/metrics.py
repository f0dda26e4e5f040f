"""Dependency-free metrics: Counter/Gauge/Histogram + Prometheus text.

The port's copy of `skypilot_tpu/observability/metrics.py`: `Metric`,
`Counter`, `Gauge`, `Histogram` (with exemplars and `observe_count`),
`Registry`, `REGISTRY`, `render_family`, `generate_text`,
`exemplars_snapshot` and the `MAX_LABEL_SETS` overflow, byte for byte
in what they render, so a scraper or a golden test reads either
package's /metrics the same. The reference's aiohttp handler becomes
`handler()`, which returns `(body, content_type)` for the port's
stdlib HTTP server.

Naming contract (as the reference's): every metric is
`skytpu_<snake>`, counters end in `_total`, and every metric carries a
help string. Counters only go up; histograms expose cumulative
`_bucket{le=}` series plus `_sum`/`_count`.

    from skypilot_tpu_torch.observability import metrics
    C = metrics.Counter('skytpu_widgets_total', 'Widgets made.',
                        labelnames=('kind',))
    C.labels(kind='round').inc()
    text = metrics.generate_text()        # scrape payload
"""
import bisect
import math
import re
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

CONTENT_TYPE = 'text/plain; version=0.0.4; charset=utf-8'

_NAME_RE = re.compile(r'^skytpu_[a-z0-9_]+$')
_LABEL_RE = re.compile(r'^[a-z_][a-z0-9_]*$')

# Cardinality guard: a label value drawn from an unbounded set (raw
# URLs, request ids) would grow the scrape payload without bound and
# eventually OOM the process it was meant to observe. Past the cap,
# new label sets collapse into one 'overflow' series — the metric
# stays truthful in aggregate and the process stays alive.
MAX_LABEL_SETS = 1000
_OVERFLOW = '_overflow'

# Latency-shaped default: sub-ms engine steps through multi-second
# prefills/provision calls.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _format_value(v: float) -> str:
    if v == math.inf:
        return '+Inf'
    if v == -math.inf:
        return '-Inf'
    if v != v:  # NaN
        return 'NaN'
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label_value(v: str) -> str:
    return v.replace('\\', r'\\').replace('\n', r'\n').replace('"', r'\"')


def _escape_help(v: str) -> str:
    return v.replace('\\', r'\\').replace('\n', r'\n')


def _render_labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ''
    inner = ','.join(f'{n}="{_escape_label_value(v)}"'
                     for n, v in zip(names, values))
    return '{' + inner + '}'


class HistPoint(NamedTuple):
    """One histogram series in a FamilySnapshot: cumulative counts per
    FINITE bucket (the +Inf cumulative equals `count`), plus the
    per-bucket exemplar slots (len(buckets)+1, last is +Inf)."""
    labelvalues: Tuple[str, ...]
    cumulative: Tuple[float, ...]
    sum: float
    count: int
    exemplars: Tuple[Optional[Tuple[str, float]], ...]


class FamilySnapshot(NamedTuple):
    """Structured snapshot of one metric family — the single source
    both the text exposition and the time-series sampler consume, so
    the two can never disagree. Scalar families (counter/gauge) carry
    `scalars` in samples() triplet form; histogram families carry
    `histograms` and a non-None `buckets`."""
    name: str
    kind: str
    help: str
    labelnames: Tuple[str, ...]
    buckets: Optional[Tuple[float, ...]]
    scalars: Tuple[Tuple[str, Tuple[Tuple[str, str], ...], float], ...]
    histograms: Tuple[HistPoint, ...]


def render_family(fam: FamilySnapshot) -> str:
    """Prometheus text (0.0.4 + exemplar suffixes) for one family —
    byte-identical to what the pre-collect() per-metric renderers
    emitted, because scrapers and golden tests pin that format."""
    lines = [f'# HELP {fam.name} {_escape_help(fam.help)}',
             f'# TYPE {fam.name} {fam.kind}']
    if fam.buckets is None:
        for series, labelpairs, value in fam.scalars:
            names = tuple(n for n, _ in labelpairs)
            values = tuple(v for _, v in labelpairs)
            lines.append(f'{series}{_render_labels(names, values)} '
                         f'{_format_value(value)}')
        return '\n'.join(lines)
    base_names = fam.labelnames + ('le',)
    bounds = [_format_value(b) for b in fam.buckets] + ['+Inf']
    for point in fam.histograms:
        cumulative = list(point.cumulative) + [point.count]
        for bound, cum, ex in zip(bounds, cumulative,
                                  point.exemplars):
            line = (f'{fam.name}_bucket'
                    f'{_render_labels(base_names, point.labelvalues + (bound,))}'
                    f' {_format_value(cum)}')
            if ex is not None:
                line += (f' # {{trace_id='
                         f'"{_escape_label_value(ex[0])}"}} '
                         f'{_format_value(ex[1])}')
            lines.append(line)
        base = _render_labels(fam.labelnames, point.labelvalues)
        lines.append(f'{fam.name}_sum{base} '
                     f'{_format_value(point.sum)}')
        lines.append(f'{fam.name}_count{base} '
                     f'{_format_value(float(point.count))}')
    return '\n'.join(lines)


class Metric:
    """Base: name/help/label validation + the labels() child map."""

    type_name = 'untyped'

    def __init__(self, name: str, help: str,  # noqa: A002 — prom idiom
                 labelnames: Sequence[str] = (),
                 registry: Optional['Registry'] = None):
        if not _NAME_RE.fullmatch(name):
            raise ValueError(
                f'metric name {name!r} must match {_NAME_RE.pattern} '
                '(the skytpu_ namespace keeps dashboards greppable)')
        if not help or not help.strip():
            raise ValueError(f'metric {name!r} needs a help string')
        for label in labelnames:
            if not _LABEL_RE.fullmatch(label):
                raise ValueError(
                    f'label {label!r} of {name!r} must match '
                    f'{_LABEL_RE.pattern}')
        if len(set(labelnames)) != len(labelnames):
            raise ValueError(f'duplicate labels on {name!r}')
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if registry is None:
            registry = REGISTRY
        if registry is not None:
            registry.register(self)

    def _child_key(self, kwargs: Dict[str, str]) -> Tuple[str, ...]:
        if set(kwargs) != set(self.labelnames):
            raise ValueError(
                f'{self.name} takes labels {self.labelnames}, got '
                f'{tuple(sorted(kwargs))}')
        return tuple(str(kwargs[n]) for n in self.labelnames)

    def labels(self, **kwargs: str):
        key = self._child_key(kwargs)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= MAX_LABEL_SETS:
                    key = (_OVERFLOW,) * len(self.labelnames)
                    child = self._children.get(key)
                    if child is not None:
                        return child
                child = self._make_child()
                self._children[key] = child
            return child

    def _default_child(self):
        """The labelless series (metrics declared without labels)."""
        if self.labelnames:
            raise ValueError(
                f'{self.name} has labels {self.labelnames}; call '
                '.labels(...) first')
        return self.labels()

    def _make_child(self):
        raise NotImplementedError

    def samples(self) -> List[Tuple[str, Tuple[Tuple[str, str], ...],
                                    float]]:
        """[(series_name, ((label, value), ...), value)] snapshot."""
        raise NotImplementedError

    def collect(self) -> FamilySnapshot:
        """One structured snapshot of this family (scalar form)."""
        return FamilySnapshot(
            name=self.name, kind=self.type_name, help=self.help,
            labelnames=self.labelnames, buckets=None,
            scalars=tuple(self.samples()), histograms=())

    def collect_text(self) -> str:
        return render_family(self.collect())


class _CounterChild:
    __slots__ = ('_value', '_lock')

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(
                f'counters only go up (inc({amount})); use a Gauge')
        with self._lock:
            self._value += amount

    def value(self) -> float:
        with self._lock:
            return self._value


class _ScalarMetric(Metric):
    """Shared value()/samples() for the single-number metrics
    (Counter/Gauge — their children both expose .value())."""

    def value(self, **labels: str) -> float:
        """Current value (0 for a never-touched series) — tests and
        /health handlers read this; scrapers use generate_text()."""
        if not labels and not self.labelnames:
            with self._lock:
                child = self._children.get(())
            return child.value() if child is not None else 0.0
        key = self._child_key(labels)
        with self._lock:
            child = self._children.get(key)
        return child.value() if child is not None else 0.0

    def samples(self):
        with self._lock:
            items = sorted(self._children.items())
        return [(self.name, tuple(zip(self.labelnames, key)),
                 child.value()) for key, child in items]


class Counter(_ScalarMetric):
    type_name = 'counter'

    def _make_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)


class _GaugeChild:
    __slots__ = ('_value', '_lock')

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_ScalarMetric):
    type_name = 'gauge'

    def _make_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)


class _HistogramChild:
    __slots__ = ('_buckets', '_counts', '_sum', '_count', '_lock',
                 '_exemplars')

    def __init__(self, buckets: Sequence[float]):
        self._buckets = buckets
        self._counts = [0] * (len(buckets) + 1)  # +1 = +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()
        # Last (trace_id, value) landing in each bucket — OpenMetrics
        # exemplars, the bridge from "p99 regressed" to "pull THIS
        # trace". Last-wins per bucket keeps it O(buckets) forever.
        self._exemplars: List[Optional[Tuple[str, float]]] = \
            [None] * (len(buckets) + 1)

    def observe(self, value: float,
                trace_id: Optional[str] = None) -> None:
        idx = bisect.bisect_left(self._buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if trace_id:
                self._exemplars[idx] = (trace_id, float(value))

    def observe_count(self, value: float, n: int,
                      trace_id: Optional[str] = None) -> None:
        """Record `value` as n identical samples under ONE lock
        acquire — the hot-path bulk form (e.g. per-round speculative
        acceptance counts drained batch-at-a-time per dispatch)."""
        if n <= 0:
            return
        idx = bisect.bisect_left(self._buckets, value)
        with self._lock:
            self._counts[idx] += n
            self._sum += value * n
            self._count += n
            if trace_id:
                self._exemplars[idx] = (trace_id, float(value))

    def snapshot(self) -> Tuple[List[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._count

    def exemplars(self) -> List[Optional[Tuple[str, float]]]:
        with self._lock:
            return list(self._exemplars)


class Histogram(Metric):
    type_name = 'histogram'

    def __init__(self, name: str, help: str,  # noqa: A002
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 registry: Optional['Registry'] = None):
        buckets = tuple(float(b) for b in buckets)
        if not buckets:
            raise ValueError(f'{name!r} needs at least one bucket')
        if any(b >= nxt for b, nxt in zip(buckets, buckets[1:])) or \
                any(b == math.inf for b in buckets):
            raise ValueError(
                f'{name!r} buckets must be strictly increasing and '
                f'finite (+Inf is implicit), got {buckets}')
        self.buckets = buckets
        super().__init__(name, help, labelnames, registry)

    def _make_child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets)

    def observe(self, value: float,
                trace_id: Optional[str] = None) -> None:
        self._default_child().observe(value, trace_id=trace_id)

    def observe_count(self, value: float, n: int,
                      trace_id: Optional[str] = None) -> None:
        """n identical samples, one lock acquire (see
        _HistogramChild.observe_count)."""
        self._default_child().observe_count(value, n, trace_id=trace_id)

    def child_snapshot(self, **labels: str):
        """(cumulative bucket counts, sum, count) for one series —
        (zeros, 0, 0) when never observed."""
        key = (self._child_key(labels) if (labels or self.labelnames)
               else ())
        with self._lock:
            child = self._children.get(key)
        if child is None:
            return [0] * (len(self.buckets) + 1), 0.0, 0
        counts, total, n = child.snapshot()
        cumulative, running = [], 0
        for c in counts:
            running += c
            cumulative.append(running)
        return cumulative, total, n

    def samples(self):
        with self._lock:
            items = sorted(self._children.items())
        out = []
        for key, child in items:
            counts, total, n = child.snapshot()
            base = tuple(zip(self.labelnames, key))
            running = 0
            for bound, c in zip(self.buckets, counts):
                running += c
                out.append((f'{self.name}_bucket',
                            base + (('le', _format_value(bound)),),
                            running))
            out.append((f'{self.name}_bucket', base + (('le', '+Inf'),),
                        n))
            out.append((f'{self.name}_sum', base, total))
            out.append((f'{self.name}_count', base, float(n)))
        return out

    def exemplars(self) -> List[Dict[str, object]]:
        """[{labels, le, trace_id, value}] for every bucket holding an
        exemplar — the /internal/stats JSON form."""
        with self._lock:
            items = sorted(self._children.items())
        out: List[Dict[str, object]] = []
        bounds = [_format_value(b) for b in self.buckets] + ['+Inf']
        for key, child in items:
            for le, ex in zip(bounds, child.exemplars()):
                if ex is None:
                    continue
                out.append({
                    'labels': dict(zip(self.labelnames, key)),
                    'le': le,
                    'trace_id': ex[0],
                    'value': ex[1],
                })
        return out

    def collect(self) -> FamilySnapshot:
        """Structured snapshot: cumulative finite-bucket counts, sum,
        count, and exemplar slots per series. The text exposition
        (with OpenMetrics-style exemplar suffixes on bucket lines:
        `... 5 # {trace_id="..."} 0.042`) renders from exactly this,
        as does the time-series sampler — one consistent pass."""
        with self._lock:
            items = sorted(self._children.items())
        points = []
        for key, child in items:
            counts, total, n = child.snapshot()
            cumulative, running = [], 0
            for c in counts[:-1]:
                running += c
                cumulative.append(float(running))
            points.append(HistPoint(
                labelvalues=key, cumulative=tuple(cumulative),
                sum=total, count=n,
                exemplars=tuple(child.exemplars())))
        return FamilySnapshot(
            name=self.name, kind=self.type_name, help=self.help,
            labelnames=self.labelnames, buckets=self.buckets,
            scalars=(), histograms=tuple(points))


class Registry:
    """Thread-safe metric registry → one text-format scrape payload."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def register(self, metric: Metric) -> None:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None and existing is not metric:
                raise ValueError(
                    f'duplicate metric name {metric.name!r}')
            self._metrics[metric.name] = metric

    def unregister(self, metric: Metric) -> None:
        """Remove one metric (lint/test fixtures that must not leave a
        deliberately bad metric behind); unknown metrics are a no-op."""
        with self._lock:
            if self._metrics.get(metric.name) is metric:
                del self._metrics[metric.name]

    def metrics(self) -> List[Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[FamilySnapshot]:
        """Structured snapshot of every registered family, one
        consistent pass in name order — the sampler-facing sibling of
        generate_text() (which renders exactly this), so text
        exposition and time-series sampling can never disagree."""
        return [m.collect() for m in self.metrics()]

    def generate_text(self) -> str:
        # Per-metric collect_text(), not render_family(collect()):
        # the default is identical, but subclasses (lint fixtures)
        # may override the text form alone.
        return '\n'.join(m.collect_text()
                         for m in self.metrics()) + '\n'


# The process-wide default registry: every plane (API server, inference
# server, load balancer, train loop, skylet) registers here, so a
# single /metrics handler exposes whatever this process touches.
REGISTRY = Registry()


def generate_text() -> str:
    return REGISTRY.generate_text()


def exemplars_snapshot(registry: Optional[Registry] = None
                       ) -> Dict[str, List[Dict[str, object]]]:
    """histogram name -> exemplar rows, for /internal/stats (only
    histograms that hold at least one exemplar appear)."""
    reg = registry if registry is not None else REGISTRY
    out: Dict[str, List[Dict[str, object]]] = {}
    for metric in reg.metrics():
        if isinstance(metric, Histogram):
            rows = metric.exemplars()
            if rows:
                out[metric.name] = rows
    return out


def handler() -> Tuple[bytes, str]:
    """The /metrics payload and its content type, for a stdlib handler
    (the reference's aiohttp_handler): one place to evolve the
    exposition contract."""
    return generate_text().encode(), CONTENT_TYPE
