"""Continuous SLO watchdog over the live time-series store.

The port's copy of `skypilot_tpu/observability/watchdog.py`: the five
rule kinds (`HistQuantileBelow`, `CounterRatioAbove`, `GaugeWithin`,
`ReplicaUp`, `AnomalyEWMA`), the rule grammar (`parse_rules`),
`default_rules`, `Watchdog` with its breach/clear hysteresis,
`start_watchdog`/`stop_watchdog`/`get_watchdog` and `snapshot()`. The
reference's aiohttp handler becomes `handler(watchdog=None)`, which
returns the /internal/alerts document for the port's stdlib server.

Rules are evaluated every `SKYTPU_WATCHDOG_TICK_SECONDS` against
trailing windows of the ring store (timeseries.py):

- a rule fires after `SKYTPU_WATCHDOG_BREACH_TICKS` consecutive
  breached ticks and clears after `SKYTPU_WATCHDOG_CLEAR_TICKS` clean
  ones;
- every transition increments `skytpu_watchdog_alerts_total{rule,state}`
  and lands in a bounded event log served by `/internal/alerts`;
- a fire dumps the span flight recorder and the offending metric
  window to `SKYTPU_TRACE_DUMP_DIR` when that is set.

Time is injectable (`now_fn`), and `pre_tick` runs before the rules
each tick.
"""
import collections
import json
import math
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

from skypilot_tpu_torch import envs
from skypilot_tpu_torch.observability import spans as spans_lib
from skypilot_tpu_torch.observability import timeseries as ts_lib

# Evaluation outcome of one rule on one tick: None = not enough data
# (holds current state, advances neither streak).
_Eval = Optional[Dict[str, Any]]


def _eval(breached: bool, value: Optional[float], detail: str
          ) -> Dict[str, Any]:
    return {'breached': bool(breached), 'value': value,
            'detail': detail}


class HistQuantileBelow:
    """Live form of slo.HistQuantileBelow: the q-quantile of the
    metric's trailing-window bucket delta stays <= threshold."""

    def __init__(self, name: str, metric: str, threshold: float,
                 q: float = 0.95,
                 labels: Optional[Dict[str, str]] = None,
                 window: Optional[float] = None,
                 min_count: int = 1) -> None:
        self.name = name
        self.metric = metric
        self.threshold = threshold
        self.q = q
        self.labels = labels
        self.window = window
        self.min_count = min_count

    def evaluate(self, store: ts_lib.TimeSeriesStore, now: float,
                 default_window: float) -> _Eval:
        window = self.window or default_window
        value = store.hist_quantile(self.metric, self.q, self.labels,
                                    window, now,
                                    min_count=self.min_count)
        if value is None:
            return None
        return _eval(value > self.threshold, value,
                     f'p{int(self.q * 100)}({self.metric}) over '
                     f'{window:g}s vs <= {self.threshold:g}')


class CounterRatioAbove:
    """Live form of slo.CounterRatioAbove: increase(num) /
    sum(increase(dens)) over the trailing window stays >= threshold
    (e.g. the prefix-cache hit ratio staying healthy)."""

    def __init__(self, name: str, num_metric: str,
                 den_metrics: Sequence[str], threshold: float,
                 labels: Optional[Dict[str, str]] = None,
                 window: Optional[float] = None,
                 min_total: float = 1.0) -> None:
        self.name = name
        self.num_metric = num_metric
        self.den_metrics = tuple(den_metrics)
        self.threshold = threshold
        self.labels = labels
        self.window = window
        self.min_total = min_total

    def evaluate(self, store: ts_lib.TimeSeriesStore, now: float,
                 default_window: float) -> _Eval:
        window = self.window or default_window
        num = store.counter_increase(self.num_metric, self.labels,
                                     window, now)
        if num is None:
            return None
        total = 0.0
        for metric in self.den_metrics:
            inc = store.counter_increase(metric, self.labels,
                                         window, now)
            if inc is not None:
                total += inc
        if total < self.min_total:
            return None
        ratio = num / total
        return _eval(ratio < self.threshold, ratio,
                     f'{self.num_metric}/{"+".join(self.den_metrics)}'
                     f' over {window:g}s vs >= {self.threshold:g}')


class GaugeWithin:
    """Live form of slo.GaugeWithin: the newest windowed value of the
    gauge sits in [lo, hi]. `on_missing` decides what a series that
    has no samples yet means: 'skip' (default — hold state),
    'breach', or 'ok'."""

    def __init__(self, name: str, metric: str, lo: float = 0.0,
                 hi: float = math.inf,
                 labels: Optional[Dict[str, str]] = None,
                 window: Optional[float] = None,
                 on_missing: str = 'skip') -> None:
        self.name = name
        self.metric = metric
        self.lo = lo
        self.hi = hi
        self.labels = labels
        self.window = window
        self.on_missing = on_missing

    def evaluate(self, store: ts_lib.TimeSeriesStore, now: float,
                 default_window: float) -> _Eval:
        window = self.window or default_window
        stats = store.gauge_stats(self.metric, self.labels, window,
                                  now)
        bounds = f'{self.metric} in [{self.lo:g}, {self.hi:g}]'
        if stats is None:
            if self.on_missing == 'skip':
                return None
            return _eval(self.on_missing == 'breach', None,
                         bounds + ' (no samples)')
        value = stats['last']
        return _eval(not self.lo <= value <= self.hi, value, bounds)


class ReplicaUp:
    """All replicas in the CURRENT set (per `replicas_fn`) have a
    fresh skytpu_replica_up == 1 sample. The LB federation path
    writes that synthetic gauge per scrape (1 on success, 0 on
    failure), so this rule both fires on a dead replica and — because
    membership is re-read every tick — clears once the controller
    prunes it from the set."""

    def __init__(self, name: str,
                 replicas_fn: Callable[[], Sequence[str]],
                 metric: str = 'skytpu_replica_up',
                 window: Optional[float] = None) -> None:
        self.name = name
        self.replicas_fn = replicas_fn
        self.metric = metric
        self.window = window

    def evaluate(self, store: ts_lib.TimeSeriesStore, now: float,
                 default_window: float) -> _Eval:
        window = self.window or default_window
        replicas = list(self.replicas_fn())
        if not replicas:
            return None
        down = []
        seen_any = False
        for url in replicas:
            stats = store.gauge_stats(self.metric, {'replica': url},
                                      window, now)
            if stats is None:
                continue
            seen_any = True
            if stats['last'] < 1.0:
                down.append(url)
        if not seen_any:
            return None
        return _eval(bool(down), float(len(down)),
                     'down: ' + ', '.join(down) if down else
                     f'all {len(replicas)} replicas up')


class AnomalyEWMA:
    """EWMA + robust-z anomaly detector over a latency series: each
    tick's windowed mean (histogram sum/count delta; falls back to
    the gauge mean for non-histogram series) is scored as
    z = |x - ewma| / (1.4826 * ewma_abs_dev + eps); z > `z_max`
    breaches. Catches regressions nobody wrote a threshold for —
    the baseline is the series' own recent history."""

    def __init__(self, name: str, metric: str,
                 labels: Optional[Dict[str, str]] = None,
                 z_max: Optional[float] = None,
                 alpha: float = 0.3, warmup_ticks: int = 5,
                 window: Optional[float] = None) -> None:
        self.name = name
        self.metric = metric
        self.labels = labels
        self.z_max = z_max
        self.alpha = alpha
        self.warmup_ticks = warmup_ticks
        self.window = window
        self._ewma: Optional[float] = None
        self._ewma_dev = 0.0
        self._ticks = 0

    def evaluate(self, store: ts_lib.TimeSeriesStore, now: float,
                 default_window: float) -> _Eval:
        window = self.window or default_window
        x = store.hist_mean(self.metric, self.labels, window, now)
        if x is None:
            stats = store.gauge_stats(self.metric, self.labels,
                                      window, now)
            x = None if stats is None else stats['mean']
        if x is None:
            return None
        z_max = self.z_max if self.z_max is not None \
            else envs.SKYTPU_WATCHDOG_ANOMALY_Z.get()
        if self._ewma is None:
            self._ewma = x
        dev = abs(x - self._ewma)
        # Score against the PRE-update baseline, then fold the new
        # observation in — an anomaly must not dilute the baseline it
        # is judged against before the judgement.
        z = dev / (1.4826 * self._ewma_dev + 1e-9)
        self._ewma = (1 - self.alpha) * self._ewma + self.alpha * x
        self._ewma_dev = ((1 - self.alpha) * self._ewma_dev
                          + self.alpha * dev)
        self._ticks += 1
        if self._ticks <= self.warmup_ticks:
            return _eval(False, 0.0,
                         f'warmup {self._ticks}/{self.warmup_ticks}')
        return _eval(z > z_max, z,
                     f'robust-z of mean({self.metric}) vs '
                     f'<= {z_max:g}')


# -- rule grammar ---------------------------------------------------------


def parse_rules(spec: str) -> List[Any]:
    """Parse the SKYTPU_WATCHDOG_RULES grammar: ';'-separated rules,
    each one of
      p95(metric) < threshold @ window_s      (any pNN)
      ratio(num/den1+den2) >= threshold @ window_s
      within(metric, lo, hi)
      anomaly(metric)
    Raises ValueError on anything it cannot parse — a silently
    ignored rule is an SLO that never existed."""
    rules: List[Any] = []
    for raw in spec.split(';'):
        text = raw.strip()
        if not text:
            continue
        window = None
        if '@' in text:
            text, wtxt = text.rsplit('@', 1)
            window = float(wtxt.strip())
            text = text.strip()
        if text.startswith('p') and '(' in text \
                and text[1:text.index('(')].isdigit():
            q = int(text[1:text.index('(')]) / 100.0
            inner, rest = _split_call(text)
            op, thr = _split_cmp(rest)
            if op not in ('<', '<='):
                raise ValueError(f'quantile rule needs < : {raw!r}')
            rules.append(HistQuantileBelow(
                name=text.replace(' ', ''), metric=inner,
                threshold=thr, q=q, window=window))
        elif text.startswith('ratio('):
            inner, rest = _split_call(text)
            op, thr = _split_cmp(rest)
            if op not in ('>', '>='):
                raise ValueError(f'ratio rule needs >= : {raw!r}')
            if '/' not in inner:
                raise ValueError(f'ratio needs num/den: {raw!r}')
            num, dens = inner.split('/', 1)
            rules.append(CounterRatioAbove(
                name=text.replace(' ', ''), num_metric=num.strip(),
                den_metrics=[d.strip() for d in dens.split('+')],
                threshold=thr, window=window))
        elif text.startswith('within('):
            inner, rest = _split_call(text)
            if rest.strip():
                raise ValueError(f'within takes no comparator: '
                                 f'{raw!r}')
            parts = [p.strip() for p in inner.split(',')]
            if len(parts) != 3:
                raise ValueError(f'within(metric,lo,hi): {raw!r}')
            rules.append(GaugeWithin(
                name=text.replace(' ', ''), metric=parts[0],
                lo=float(parts[1]), hi=float(parts[2]),
                window=window))
        elif text.startswith('anomaly('):
            inner, rest = _split_call(text)
            if rest.strip():
                raise ValueError(f'anomaly takes no comparator: '
                                 f'{raw!r}')
            rules.append(AnomalyEWMA(
                name=text.replace(' ', ''), metric=inner.strip(),
                window=window))
        else:
            raise ValueError(f'unparseable watchdog rule: {raw!r}')
    return rules


def _split_call(text: str):
    open_i = text.index('(')
    close_i = text.index(')', open_i)
    return text[open_i + 1:close_i].strip(), text[close_i + 1:]


def _split_cmp(rest: str):
    rest = rest.strip()
    for op in ('<=', '>=', '<', '>'):
        if rest.startswith(op):
            return op, float(rest[len(op):].strip())
    raise ValueError(f'missing comparator in {rest!r}')


def default_rules() -> List[Any]:
    """Rules from SKYTPU_WATCHDOG_RULES, plus (when the Z knob is on)
    anomaly detectors over the serving latency histograms."""
    spec = envs.SKYTPU_WATCHDOG_RULES.get()
    rules = parse_rules(spec) if spec else []
    if envs.SKYTPU_WATCHDOG_ANOMALY_Z.get() > 0:
        rules.append(AnomalyEWMA('anomaly(decode_step)',
                                 'skytpu_decode_step_seconds'))
        rules.append(AnomalyEWMA('anomaly(ttft)',
                                 'skytpu_prefill_seconds'))
    return rules


# -- the engine -----------------------------------------------------------


class _RuleState:
    __slots__ = ('rule', 'firing', 'breach_streak', 'clear_streak',
                 'last_value', 'last_detail', 'fired', 'cleared')

    def __init__(self, rule) -> None:
        self.rule = rule
        self.firing = False
        self.breach_streak = 0
        self.clear_streak = 0
        self.last_value: Optional[float] = None
        self.last_detail = ''
        self.fired = 0
        self.cleared = 0


class Watchdog:
    """Evaluates live rules every tick with breach/clear hysteresis;
    emits alert events, counts transitions, dumps evidence on fire."""

    def __init__(self, rules: Optional[Sequence[Any]] = None,
                 store: Optional[ts_lib.TimeSeriesStore] = None,
                 now_fn: Optional[Callable[[], float]] = None,
                 breach_ticks: Optional[int] = None,
                 clear_ticks: Optional[int] = None,
                 window: Optional[float] = None,
                 pre_tick: Optional[
                     Callable[['Watchdog'], None]] = None,
                 dump_evidence: bool = True) -> None:
        import time as _time
        self.store = store or ts_lib.STORE
        self.now_fn = now_fn or _time.time
        self._breach_ticks_override = breach_ticks
        self._clear_ticks_override = clear_ticks
        self._window_override = window
        self.pre_tick = pre_tick
        self.dump_evidence = dump_evidence
        self._lock = threading.Lock()
        self._states = [_RuleState(r) for r in (rules if rules
                        is not None else default_rules())]
        self.events: collections.deque = collections.deque(
            maxlen=256)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # Hysteresis knobs are re-read per tick so tests (and operators
    # via restart-free config pushes) can tighten them live.
    def _breach_ticks(self) -> int:
        if self._breach_ticks_override is not None:
            return max(1, self._breach_ticks_override)
        return max(1, envs.SKYTPU_WATCHDOG_BREACH_TICKS.get())

    def _clear_ticks(self) -> int:
        if self._clear_ticks_override is not None:
            return max(1, self._clear_ticks_override)
        return max(1, envs.SKYTPU_WATCHDOG_CLEAR_TICKS.get())

    def _window(self) -> float:
        if self._window_override is not None:
            return self._window_override
        return envs.SKYTPU_WATCHDOG_WINDOW_SECONDS.get()

    def add_rule(self, rule) -> None:
        with self._lock:
            self._states.append(_RuleState(rule))

    def tick(self) -> List[Dict[str, Any]]:
        """One evaluation pass; returns the transitions it caused."""
        if self.pre_tick is not None:
            try:
                self.pre_tick(self)
            except Exception:  # noqa: BLE001 — federation scrape
                # failure must not stop local rules from running.
                pass
        now = self.now_fn()
        window = self._window()
        transitions = []
        with self._lock:
            states = list(self._states)
        for st in states:
            try:
                res = st.rule.evaluate(self.store, now, window)
            except Exception as exc:  # noqa: BLE001
                st.last_detail = f'evaluate error: {exc!r}'
                continue
            if res is None:
                continue
            st.last_value = res['value']
            st.last_detail = res['detail']
            if res['breached']:
                st.breach_streak += 1
                st.clear_streak = 0
                if not st.firing and \
                        st.breach_streak >= self._breach_ticks():
                    st.firing = True
                    st.fired += 1
                    transitions.append(
                        self._transition(st, 'fire', now))
            else:
                st.clear_streak += 1
                st.breach_streak = 0
                if st.firing and \
                        st.clear_streak >= self._clear_ticks():
                    st.firing = False
                    st.cleared += 1
                    transitions.append(
                        self._transition(st, 'clear', now))
        return transitions

    def _transition(self, st: _RuleState, state: str, now: float
                    ) -> Dict[str, Any]:
        event = {'rule': st.rule.name, 'state': state, 'ts': now,
                 'value': _json_val(st.last_value),
                 'detail': st.last_detail}
        self.events.append(event)
        # Imported late: instruments imports metrics at module load
        # and the counter must exist exactly once per process.
        from skypilot_tpu_torch.observability import instruments as obs
        obs.WATCHDOG_ALERTS.labels(rule=st.rule.name,
                                   state=state).inc()
        if state == 'fire' and self.dump_evidence:
            event['dumps'] = self._dump(st, now)
        return event

    def _dump(self, st: _RuleState, now: float) -> List[str]:
        out_dir = envs.SKYTPU_TRACE_DUMP_DIR.get()
        if not out_dir:
            return []
        paths = []
        safe = ''.join(c if c.isalnum() else '_'
                       for c in st.rule.name)
        trace = spans_lib.dump_flight_recorder(
            out_dir, f'watchdog_{safe}')
        if trace:
            paths.append(trace)
        try:
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(
                out_dir, f'WATCHDOG_{safe}_{os.getpid()}.json')
            window = self._window()
            payload = {'rule': st.rule.name, 'ts': now,
                       'value': _json_val(st.last_value),
                       'detail': st.last_detail,
                       'window_s': window,
                       'window': self.store.dump(since=now - window)}
            tmp = path + '.tmp'
            with open(tmp, 'w', encoding='utf-8') as f:
                json.dump(payload, f, indent=2, sort_keys=True)
                f.write('\n')
            os.replace(tmp, path)
            paths.append(path)
        except OSError:
            pass
        return paths

    def snapshot(self) -> Dict[str, Any]:
        """The /internal/alerts payload: per-rule state + the bounded
        transition log, newest last."""
        with self._lock:
            states = list(self._states)
        return {
            'now': self.now_fn(),
            'rules': [{
                'name': st.rule.name,
                'firing': st.firing,
                'breach_streak': st.breach_streak,
                'clear_streak': st.clear_streak,
                'fired': st.fired,
                'cleared': st.cleared,
                'last_value': _json_val(st.last_value),
                'detail': st.last_detail,
            } for st in states],
            'events': list(self.events),
        }

    # -- background thread ------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            interval = envs.SKYTPU_WATCHDOG_TICK_SECONDS.get()
            if interval <= 0:
                return
            if self._stop.wait(interval):
                return
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the watchdog must
                # never take down the plane it watches.
                pass

    def start(self) -> bool:
        if envs.SKYTPU_WATCHDOG_TICK_SECONDS.get() <= 0:
            return False
        if self._thread is not None and self._thread.is_alive():
            return True
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name='skytpu-watchdog', daemon=True)
        self._thread.start()
        return True

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


def _json_val(value):
    if value is None:
        return None
    if value != value:
        return None
    if value in (math.inf, -math.inf):
        return 'inf' if value > 0 else '-inf'
    return value


_WATCHDOG: Optional[Watchdog] = None
_WATCHDOG_LOCK = threading.Lock()


def start_watchdog(rules: Optional[Sequence[Any]] = None,
                   **kwargs) -> Optional[Watchdog]:
    """Start (idempotently) the process-wide watchdog thread; None
    when SKYTPU_WATCHDOG_TICK_SECONDS disables it. Subsequent calls
    return the running instance and ignore the arguments."""
    global _WATCHDOG
    with _WATCHDOG_LOCK:
        if _WATCHDOG is None:
            _WATCHDOG = Watchdog(rules=rules, **kwargs)
        return _WATCHDOG if _WATCHDOG.start() else None


def stop_watchdog() -> None:
    global _WATCHDOG
    with _WATCHDOG_LOCK:
        if _WATCHDOG is not None:
            _WATCHDOG.stop()
            _WATCHDOG = None


def get_watchdog() -> Optional[Watchdog]:
    return _WATCHDOG


def handler(watchdog: Optional[Watchdog] = None) -> Dict[str, Any]:
    """The /internal/alerts document (the reference's aiohttp_handler):
    the running watchdog's snapshot, or an empty one when none runs."""
    wd = watchdog or get_watchdog()
    return wd.snapshot() if wd is not None else \
        {'now': None, 'rules': [], 'events': [],
         'detail': 'watchdog not running'}
