"""SLO assertions evaluated from the live skytpu_* metrics registry.

The port of `skypilot_tpu/fleetsim/slo.py`: the assertion kinds
`HistQuantileBelow`, `RatioBelow`, `CounterRatioAbove`, `GaugeWithin`,
`CounterDeltaWithin`, the `SLOEvaluator` (`mark`, `evaluate`) and
`write_report`. Scale and robustness claims are *scrapes*, not log
archaeology, so the soak harness asserts its SLOs against the exact series /metrics would
expose: histogram quantiles from bucket deltas, error rates from
counter deltas between named window marks, recovery times from
gauges. No log parsing anywhere.

Reports land as SLO_<scenario>.json with the same honesty schema the
bench channel uses: `{rc, scenario, asserts: [...]}` where rc != 0
means at least one assertion failed (or the run itself died) — a
caller can gate on rc without parsing assertion bodies.
"""
import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

from skypilot_tpu_torch.observability import metrics as metrics_lib
from skypilot_tpu_torch.observability import spans as spans_lib

_DEFAULT_WINDOW = ('warmup_end', 'end')


@dataclasses.dataclass(frozen=True)
class HistQuantileBelow:
    """q-quantile of a histogram's window delta stays under
    `threshold`. The quantile is resolved to the bucket upper bound
    (conservative: the true value is <= the reported one)."""
    name: str
    threshold: float
    metric: str = 'skytpu_fleetsim_ttft_seconds'
    q: float = 0.95
    window: Tuple[str, str] = _DEFAULT_WINDOW
    min_count: int = 1   # zero-sample windows FAIL — silence hides bugs


@dataclasses.dataclass(frozen=True)
class RatioBelow:
    """sum(counter{label in num_values}) / sum(counter) over the
    window stays under `threshold` (e.g. hard-error rate during a
    rolling update)."""
    name: str
    threshold: float
    metric: str = 'skytpu_fleetsim_requests_total'
    label: str = 'outcome'
    num_values: Tuple[str, ...] = ('error',)
    window: Tuple[str, str] = _DEFAULT_WINDOW
    min_total: int = 1


@dataclasses.dataclass(frozen=True)
class CounterRatioAbove:
    """delta(num_metric) / sum(delta(den_metrics)) over the window
    stays >= `threshold` — a ratio across SEPARATE unlabeled counters
    (e.g. the prefix-cache hit ratio, hits / (hits + misses), from
    skytpu_prefix_cache_{hits,misses}_total deltas)."""
    name: str
    threshold: float
    num_metric: str
    den_metrics: Tuple[str, ...]
    window: Tuple[str, str] = _DEFAULT_WINDOW
    min_total: int = 1


@dataclasses.dataclass(frozen=True)
class GaugeWithin:
    """Current gauge value sits in [lo, threshold] — recovery-time
    gauges report -1 while recovery never happened, so lo=0 makes
    'never recovered' a failure, not a pass."""
    name: str
    threshold: float
    metric: str = 'skytpu_fleetsim_recovery_seconds'
    labels: Tuple[Tuple[str, str], ...] = ()
    lo: float = 0.0


@dataclasses.dataclass(frozen=True)
class CounterDeltaWithin:
    """delta(counter) over the window, summed across series matching
    `labels` (subset match), sits in [min_delta, max_delta] — e.g.
    'the watchdog fired at least once during the outage' (min 1) or
    'it never fired before it' (max 0)."""
    name: str
    metric: str
    min_delta: float = 0.0
    max_delta: float = math.inf
    labels: Tuple[Tuple[str, str], ...] = ()
    window: Tuple[str, str] = _DEFAULT_WINDOW

    @property
    def threshold(self) -> float:
        # _result() reports one scalar bound; the binding one here is
        # the finite max when set, else the min.
        return self.max_delta if math.isfinite(self.max_delta) \
            else self.min_delta


SLOAssert = (HistQuantileBelow, RatioBelow, CounterRatioAbove,
             GaugeWithin, CounterDeltaWithin)


class SLOEvaluator:
    """Snapshots the registry at named marks; evaluates window deltas.

    Snapshot-and-delta (rather than absolute reads) matters because
    the registry is process-global: a tier-1 test session runs many
    scenarios back-to-back and each one's SLOs must only see its own
    traffic.
    """

    def __init__(self, asserts: Sequence) -> None:
        self.asserts = list(asserts)
        self._marks: Dict[str, Dict] = {}

    def _needed_metrics(self) -> List[str]:
        needed = set()
        for a in self.asserts:
            if isinstance(a, GaugeWithin):
                continue
            if isinstance(a, CounterRatioAbove):
                needed.add(a.num_metric)
                needed.update(a.den_metrics)
            else:
                needed.add(a.metric)
        return sorted(needed)

    def mark(self, name: str) -> None:
        snap = {}
        for mname in self._needed_metrics():
            metric = metrics_lib.REGISTRY.get(mname)
            if metric is not None:
                snap[mname] = {(series, labels): value
                               for series, labels, value
                               in metric.samples()}
        self._marks[name] = snap

    def _delta(self, metric: str, window: Tuple[str, str]
               ) -> Optional[Dict]:
        start, end = window
        if start not in self._marks or end not in self._marks:
            return None
        s0 = self._marks[start].get(metric, {})
        s1 = self._marks[end].get(metric, {})
        return {key: value - s0.get(key, 0.0)
                for key, value in s1.items()}

    # -- per-kind evaluation --------------------------------------------------

    def _eval_quantile(self, a: HistQuantileBelow) -> Dict:
        delta = self._delta(a.metric, a.window)
        if delta is None:
            return _result(a, math.nan, False,
                           f'window {a.window} never marked')
        buckets: List[Tuple[float, float]] = []
        count = 0.0
        for (series, labels), value in delta.items():
            if series == f'{a.metric}_bucket':
                le = dict(labels)['le']
                bound = math.inf if le == '+Inf' else float(le)
                buckets.append((bound, value))
            elif series == f'{a.metric}_count':
                count += value
        if count < a.min_count:
            return _result(a, math.nan, False,
                           f'only {int(count)} samples in window '
                           f'(min {a.min_count})')
        value = math.inf
        for bound, cum in sorted(buckets):
            if cum >= a.q * count:
                value = bound
                break
        return _result(a, value, value <= a.threshold,
                       f'p{int(a.q * 100)} over {int(count)} samples')

    def _eval_ratio(self, a: RatioBelow) -> Dict:
        delta = self._delta(a.metric, a.window)
        if delta is None:
            return _result(a, math.nan, False,
                           f'window {a.window} never marked')
        num = total = 0.0
        for (series, labels), value in delta.items():
            if series != a.metric:
                continue
            total += value
            if dict(labels).get(a.label) in a.num_values:
                num += value
        if total < a.min_total:
            return _result(a, math.nan, False,
                           f'only {int(total)} events in window '
                           f'(min {a.min_total})')
        ratio = num / total
        return _result(a, ratio, ratio <= a.threshold,
                       f'{int(num)}/{int(total)} '
                       f'{"|".join(a.num_values)}')

    def _eval_counter_ratio(self, a: CounterRatioAbove) -> Dict:
        num_delta = 0.0
        total = 0.0
        for metric in dict.fromkeys((a.num_metric,) + a.den_metrics):
            delta = self._delta(metric, a.window)
            if delta is None:
                return _result(a, math.nan, False,
                               f'window {a.window} never marked')
            value = sum(v for (series, _labels), v in delta.items()
                        if series == metric)
            if metric == a.num_metric:
                num_delta = value
            if metric in a.den_metrics:
                total += value
        if total < a.min_total:
            return _result(a, math.nan, False,
                           f'only {int(total)} events in window '
                           f'(min {a.min_total})')
        ratio = num_delta / total
        return _result(a, ratio, ratio >= a.threshold,
                       f'{int(num_delta)}/{int(total)} '
                       f'{a.num_metric} (>= bound)')

    def _eval_gauge(self, a: GaugeWithin) -> Dict:
        metric = metrics_lib.REGISTRY.get(a.metric)
        if metric is None:
            return _result(a, math.nan, False,
                           f'{a.metric} not registered')
        # Existence check first: a never-touched series reads 0.0
        # through value(), and 0.0 sits inside [lo, threshold] — a
        # chaos event that never fired must not report "recovered in
        # 0s".
        want = dict(a.labels)
        value = None
        for series, labels, sample in metric.samples():
            if series == a.metric and dict(labels) == want:
                value = sample
                break
        if value is None:
            return _result(a, math.nan, False,
                           'series never written — did its chaos '
                           'event fire?')
        return _result(a, value, a.lo <= value <= a.threshold,
                       f'bounds [{a.lo}, {a.threshold}]')

    def _eval_counter_delta(self, a: CounterDeltaWithin) -> Dict:
        delta = self._delta(a.metric, a.window)
        if delta is None:
            return _result(a, math.nan, False,
                           f'window {a.window} never marked')
        want = dict(a.labels)
        total = 0.0
        for (series, labels), value in delta.items():
            if series != a.metric:
                continue
            have = dict(labels)
            if all(have.get(k) == v for k, v in want.items()):
                total += value
        ok = a.min_delta <= total <= a.max_delta
        return _result(a, total, ok,
                       f'delta in [{a.min_delta:g}, {a.max_delta:g}]'
                       f' over {a.window}')

    def evaluate(self) -> List[Dict]:
        out = []
        for a in self.asserts:
            if isinstance(a, HistQuantileBelow):
                out.append(self._eval_quantile(a))
            elif isinstance(a, RatioBelow):
                out.append(self._eval_ratio(a))
            elif isinstance(a, CounterRatioAbove):
                out.append(self._eval_counter_ratio(a))
            elif isinstance(a, GaugeWithin):
                out.append(self._eval_gauge(a))
            elif isinstance(a, CounterDeltaWithin):
                out.append(self._eval_counter_delta(a))
            else:
                raise TypeError(f'unknown SLO assert {a!r}')
        return out


def _result(a, value: float, ok: bool, detail: str) -> Dict:
    if value != value:  # NaN is not JSON-portable
        value = None
    elif value in (math.inf, -math.inf):
        value = 'inf'
    metric = getattr(a, 'metric', None) or getattr(a, 'num_metric', '')
    return {'name': a.name, 'metric': metric, 'ok': bool(ok),
            'value': value, 'threshold': a.threshold, 'detail': detail}


def write_report(out_dir: str, scenario: str, results: List[Dict],
                 extra: Optional[Dict] = None,
                 rc_override: Optional[int] = None) -> Tuple[str, int]:
    """Write SLO_<scenario>.json in the shared `{rc, scenario,
    asserts}` evidence schema; returns (path, rc). rc_override forces
    a non-zero rc for runs that died before evaluating (a crashed soak
    must not look like a passing one)."""
    rc = rc_override if rc_override is not None else \
        (0 if results and all(r['ok'] for r in results) else 1)
    path = os.path.join(out_dir, f'SLO_{scenario}.json')
    payload = {'rc': rc, 'scenario': scenario, 'asserts': results,
               'extra': extra or {}}
    if rc != 0:
        # A failing report carries the span flight recorder: the last
        # completed request trees (LB legs + per-attempt outcomes)
        # from THIS process, so a breach is triaged from the report
        # alone — which requests, through which replicas, how slow —
        # instead of from a re-run with tracing turned up.
        payload['flight_recorder'] = spans_lib.COLLECTOR.recent_trees()
    tmp = path + '.tmp'
    with open(tmp, 'w', encoding='utf-8') as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write('\n')
    os.replace(tmp, path)
    return path, rc
