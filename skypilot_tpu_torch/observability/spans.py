"""Distributed request spans: trees of timed phases per trace ID.

The port's copy of `skypilot_tpu/observability/spans.py`:
`SpanContext`, `parse_traceparent`/`format_traceparent`, the sampling
coin, `SpanCollector` (`start_trace`, `record_span`, `finish_trace`,
`is_kept`, `mark_error`, `spans_for`, `recent_trees` and the
flight-recorder ring), `span()`, `tree_view`, `to_chrome_trace`,
`exemplar_trace_id` and `dump_flight_recorder`. Same span names, ids
(32-hex trace, 16-hex span, W3C `traceparent`) and JSON, so one
`/internal/trace` reader serves both packages.

Two recording styles, one collector:

  with spans.span('inference.request', attrs={...}) as ctx:  # live scope
      ...                                    # children nest via the
                                             # contextvar
  COLLECTOR.record_span('engine.prefill',    # explicit times: engine
      trace_id=..., parent_id=..., start=t0, # phases are stamped on the
      end=t1, attrs={'bucket': 128})         # host around a dispatch and
                                             # the host read that syncs it

On CUDA every launch is asynchronous, so an engine phase ends at the
host read that synchronises (`.tolist()`), never at a
`torch.cuda.synchronize()` added for the span's sake.

Collector semantics (knobs read at call time through envs):

  * Head sampling: a keep/drop decision is stamped when a trace first
    appears (`SKYTPU_TRACE_SAMPLE`), but spans buffer regardless while
    the trace is in flight; at completion the tree is kept if it was
    head-sampled OR any span errored OR it ran longer than
    `SKYTPU_TRACE_SLOW_SECONDS`.
  * `SKYTPU_TRACE_MAX_SPANS` caps buffered spans process-wide; over
    the cap the oldest completed trees go first, then new spans drop
    (counted, never raised).
  * The ring of the last `SKYTPU_TRACE_RECORDER_CAPACITY` completed
    trees is the flight recorder the watchdog dumps when a rule fires.

Thread-safe: the engine-loop thread records while HTTP handler threads
open and close scopes.
"""
import contextlib
import contextvars
import dataclasses
import json
import os
import random
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Optional

from skypilot_tpu_torch import envs

TRACEPARENT_HEADER = 'traceparent'
TRACE_ID_RESPONSE_HEADER = 'X-Trace-ID'


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """Position in a trace: which tree, and which node to parent on."""
    trace_id: str
    span_id: str


_span_context: contextvars.ContextVar[Optional[SpanContext]] = \
    contextvars.ContextVar('skytpu_span_context', default=None)


def new_trace_id() -> str:
    # random.getrandbits over uuid4: span creation sits on the decode
    # hot path and uuid4's os.urandom read is ~6x the cost; these ids
    # need uniqueness, not unpredictability. All-zero is invalid
    # W3C — reroll the (2**-128) lottery ticket.
    tid = random.getrandbits(128)
    while tid == 0:
        tid = random.getrandbits(128)
    return f'{tid:032x}'


def new_span_id() -> str:
    sid = random.getrandbits(64)
    while sid == 0:
        sid = random.getrandbits(64)
    return f'{sid:016x}'


def current_context() -> Optional[SpanContext]:
    """The innermost open span's context (None outside any span)."""
    return _span_context.get()


def current_trace_id() -> Optional[str]:
    ctx = _span_context.get()
    return ctx.trace_id if ctx is not None else None


def bind_context(ctx: Optional[SpanContext]) -> contextvars.Token:
    """Set the span context in the current execution context; for
    thread hops where a `with span(...)` block can't span the handoff
    (pair with tracing.bind() for the rid)."""
    return _span_context.set(ctx)


def unbind_context(token: contextvars.Token) -> None:
    _span_context.reset(token)


def format_traceparent(ctx: SpanContext) -> str:
    return f'00-{ctx.trace_id}-{ctx.span_id}-01'


def _is_hex(s: str) -> bool:
    try:
        int(s, 16)
        return True
    except ValueError:
        return False


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """W3C-shaped `00-<trace32>-<span16>-<flags>`; returns None on any
    malformation (a bad header must never kill a proxied request)."""
    if not value:
        return None
    parts = value.strip().split('-')
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or not _is_hex(version):
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id) or \
            trace_id == '0' * 32:
        return None
    if len(span_id) != 16 or not _is_hex(span_id) or \
            span_id == '0' * 16:
        return None
    if len(flags) != 2 or not _is_hex(flags):
        return None
    return SpanContext(trace_id=trace_id, span_id=span_id)


class _TraceBuf:
    """In-flight trace: spans buffer as RAW TUPLES (name, span_id,
    parent_id, start, end, attrs, status) and only materialize into
    dicts when the tree is kept — at the default 1% sampling, ~99% of
    buffered spans are discarded at finalize, and the decode hot path
    must not pay dict/uuid construction for records that will never
    be read."""
    __slots__ = ('spans', 'sampled', 'error', 'open_spans',
                 'started_wall')

    def __init__(self, sampled: bool):
        self.spans: List[tuple] = []
        self.sampled = sampled
        self.error = False
        self.open_spans = 0
        self.started_wall = time.time()


def _materialize(rec: tuple, trace_id: str) -> Dict[str, Any]:
    name, span_id, parent_id, start, end, attrs, status = rec
    return {
        'name': name,
        'trace_id': trace_id,
        'span_id': span_id or new_span_id(),
        'parent_id': parent_id,
        'start': start,
        'end': end,
        'attrs': attrs,
        'status': status,
    }


class SpanCollector:
    """Bounded in-process span store + completed-tree flight ring."""

    def __init__(self,
                 sample_rate: Optional[float] = None,
                 max_spans: Optional[int] = None,
                 recorder_capacity: Optional[int] = None,
                 slow_seconds: Optional[float] = None,
                 rng: Optional[random.Random] = None):
        # None = read the env knob at call time (tests pin explicitly).
        self._sample_rate = sample_rate
        self._max_spans = max_spans
        self._recorder_capacity = recorder_capacity
        self._slow_seconds = slow_seconds
        self._rng = rng or random
        self._lock = threading.Lock()
        self._active: Dict[str, _TraceBuf] = {}
        # trace_id -> completed tree payload, oldest first.
        self._completed: 'OrderedDict[str, Dict[str, Any]]' = \
            OrderedDict()
        self._total_spans = 0
        self.dropped_spans = 0

    # -- knobs (call-time env reads; constructor args pin for tests) --

    def sample_rate(self) -> float:
        if self._sample_rate is not None:
            return self._sample_rate
        return envs.SKYTPU_TRACE_SAMPLE.get()

    def max_spans(self) -> int:
        if self._max_spans is not None:
            return self._max_spans
        return envs.SKYTPU_TRACE_MAX_SPANS.get()

    def recorder_capacity(self) -> int:
        if self._recorder_capacity is not None:
            return self._recorder_capacity
        return envs.SKYTPU_TRACE_RECORDER_CAPACITY.get()

    def slow_seconds(self) -> float:
        if self._slow_seconds is not None:
            return self._slow_seconds
        return envs.SKYTPU_TRACE_SLOW_SECONDS.get()

    # -- lifecycle -----------------------------------------------------

    def start_trace(self, trace_id: str) -> None:
        """Idempotent join: first call stamps the head-sampling
        decision; later calls are no-ops."""
        with self._lock:
            self._start_trace_locked(trace_id)

    def _start_trace_locked(self, trace_id: str) -> _TraceBuf:
        buf = self._active.get(trace_id)
        if buf is None:
            sampled = self._rng.random() < self.sample_rate()
            buf = _TraceBuf(sampled=sampled)
            self._active[trace_id] = buf
        return buf

    def note_open(self, trace_id: str) -> None:
        with self._lock:
            self._start_trace_locked(trace_id).open_spans += 1

    def note_close(self, trace_id: str) -> None:
        with self._lock:
            buf = self._active.get(trace_id)
            if buf is None:
                return
            buf.open_spans = max(0, buf.open_spans - 1)
            if buf.open_spans == 0:
                self._finalize_locked(trace_id)

    def mark_error(self, trace_id: str) -> None:
        """Errored traces are kept regardless of the sampling coin."""
        with self._lock:
            buf = self._active.get(trace_id)
            if buf is not None:
                buf.error = True

    def record_span(self, name: str, *, trace_id: str,
                    span_id: Optional[str] = None,
                    parent_id: Optional[str] = None,
                    start: float, end: float,
                    attrs: Optional[Dict[str, Any]] = None,
                    status: str = 'ok') -> None:
        """Append a finished span (explicit wall-clock times)."""
        record = (name, span_id,
                  parent_id, start, end,
                  dict(attrs) if attrs else {}, status)
        with self._lock:
            cap = self.max_spans()
            if self._total_spans >= cap:
                # Oldest completed trees make room first; active
                # traces are someone's in-flight request.
                while self._completed and self._total_spans >= cap:
                    _, evicted = self._completed.popitem(last=False)
                    self._total_spans -= len(evicted['spans'])
                if self._total_spans >= cap:
                    self.dropped_spans += 1
                    return
            if trace_id in self._active:
                buf = self._active[trace_id]
                buf.spans.append(record)
                if status == 'error':
                    buf.error = True
            elif trace_id in self._completed:
                # Late arrival (e.g. an engine thread finishing after
                # the HTTP scope closed): append into the kept tree.
                self._completed[trace_id]['spans'].append(
                    _materialize(record, trace_id))
            else:
                buf = self._start_trace_locked(trace_id)
                buf.spans.append(record)
                if status == 'error':
                    buf.error = True
            self._total_spans += 1

    def finish_trace(self, trace_id: str) -> None:
        """Finalize if no live scopes remain (a still-open span's exit
        will finalize instead)."""
        with self._lock:
            buf = self._active.get(trace_id)
            if buf is not None and buf.open_spans == 0:
                self._finalize_locked(trace_id)

    def _finalize_locked(self, trace_id: str) -> None:
        buf = self._active.pop(trace_id, None)
        if buf is None:
            return
        if not buf.spans:
            return
        start = min(s[3] if type(s) is tuple else s['start']
                    for s in buf.spans)
        end = max(s[4] if type(s) is tuple else s['end']
                  for s in buf.spans)
        duration = max(0.0, end - start)
        keep = buf.sampled or buf.error or \
            duration >= self.slow_seconds()
        if not keep:
            self._total_spans -= len(buf.spans)
            return
        self._completed[trace_id] = {
            'trace_id': trace_id,
            'error': buf.error,
            'duration': duration,
            'spans': [_materialize(s, trace_id) if type(s) is tuple
                      else s for s in buf.spans],
        }
        self._completed.move_to_end(trace_id)
        while len(self._completed) > self.recorder_capacity():
            _, evicted = self._completed.popitem(last=False)
            self._total_spans -= len(evicted['spans'])

    # -- queries -------------------------------------------------------

    def span_count(self) -> int:
        with self._lock:
            return self._total_spans

    def is_kept(self, trace_id: str) -> bool:
        """Will (or did) this trace survive sampling? Used to gate
        exemplar attachment — an exemplar pointing at a dropped trace
        is a dead link. Slow-keeps are invisible until completion, so
        this can under-report, never over-report."""
        with self._lock:
            buf = self._active.get(trace_id)
            if buf is not None:
                return buf.sampled or buf.error
            return trace_id in self._completed

    def spans_for(self, trace_id: str) -> List[Dict[str, Any]]:
        """All spans known for `trace_id` (active or completed)."""
        with self._lock:
            if trace_id in self._active:
                buf = self._active[trace_id]
                # Materialize IN PLACE so lazily-assigned span ids
                # stay stable across repeated reads of a live trace.
                buf.spans = [s if type(s) is dict
                             else _materialize(s, trace_id)
                             for s in buf.spans]
                return list(buf.spans)
            tree = self._completed.get(trace_id)
            return list(tree['spans']) if tree else []

    def recent_trees(self, limit: Optional[int] = None
                     ) -> List[Dict[str, Any]]:
        """Completed trees, newest LAST (the flight recorder)."""
        with self._lock:
            trees = [
                {**t, 'spans': list(t['spans'])}
                for t in self._completed.values()
            ]
        if limit is not None:
            trees = trees[-limit:]
        return trees

    def clear(self) -> None:
        with self._lock:
            self._active.clear()
            self._completed.clear()
            self._total_spans = 0
            self.dropped_spans = 0


def to_chrome_trace(span_records: List[Dict[str, Any]]
                    ) -> Dict[str, Any]:
    """Chrome-trace/Perfetto JSON (`X` complete events, µs)."""
    events = []
    for s in span_records:
        args = dict(s.get('attrs') or {})
        args['span_id'] = s['span_id']
        if s.get('parent_id'):
            args['parent_id'] = s['parent_id']
        if s.get('status') and s['status'] != 'ok':
            args['status'] = s['status']
        events.append({
            'name': s['name'],
            'cat': 'skytpu',
            'ph': 'X',
            'ts': s['start'] * 1e6,
            'dur': max(0.0, s['end'] - s['start']) * 1e6,
            'pid': 1,
            'tid': 1,
            'args': args,
        })
    return {'traceEvents': events}


def tree_view(span_records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Nest spans by parent_id; spans whose parent lives in another
    process (a propagated traceparent) surface as roots here."""
    by_id = {}
    for s in span_records:
        node = dict(s)
        node['children'] = []
        by_id[s['span_id']] = node
    roots = []
    for node in by_id.values():
        parent = by_id.get(node.get('parent_id') or '')
        if parent is not None and parent is not node:
            parent['children'].append(node)
        else:
            roots.append(node)
    for node in by_id.values():
        node['children'].sort(key=lambda n: n['start'])
    roots.sort(key=lambda n: n['start'])
    return roots


# Process-global collector: every plane (LB, server, engine, fleetsim)
# records here; /internal/trace and the flight recorder read it.
COLLECTOR = SpanCollector()


@contextlib.contextmanager
def span(name: str,
         parent: Optional[SpanContext] = None,
         attrs: Optional[Dict[str, Any]] = None,
         collector: Optional[SpanCollector] = None
         ) -> Iterator[SpanContext]:
    """Open a live span scope: children started inside the block (via
    this contextmanager, in the same task context) parent on it. Pass
    `parent=` to graft onto a propagated remote context instead of the
    contextvar."""
    coll = collector or COLLECTOR
    parent_ctx = parent if parent is not None else _span_context.get()
    if parent_ctx is not None:
        trace_id = parent_ctx.trace_id
        parent_id = parent_ctx.span_id
    else:
        trace_id = new_trace_id()
        parent_id = None
    ctx = SpanContext(trace_id=trace_id, span_id=new_span_id())
    coll.note_open(trace_id)
    token = _span_context.set(ctx)
    # The caller's dict is read at EXIT (record_span copies), so
    # attributes discovered mid-scope (status code, token counts)
    # land by mutating the dict passed in.
    span_attrs = attrs if attrs is not None else {}
    status = 'ok'
    start = time.time()
    try:
        yield ctx
    except BaseException:
        status = 'error'
        raise
    finally:
        _span_context.reset(token)
        coll.record_span(name, trace_id=trace_id, span_id=ctx.span_id,
                         parent_id=parent_id, start=start,
                         end=time.time(), attrs=span_attrs,
                         status=status)
        coll.note_close(trace_id)


def exemplar_trace_id(trace_id: Optional[str]) -> Optional[str]:
    """`trace_id` if its tree will be queryable later, else None —
    the value to pass to Histogram.observe(..., trace_id=)."""
    if trace_id and COLLECTOR.is_kept(trace_id):
        return trace_id
    return None


def dump_flight_recorder(out_dir: str, reason: str,
                         collector: Optional[SpanCollector] = None
                         ) -> Optional[str]:
    """Write the completed-tree ring to `<out_dir>/TRACE_<reason>_
    <pid>.json`; returns the path (None when the ring is empty or the
    write fails — dumping evidence must never take down the plane)."""
    coll = collector or COLLECTOR
    trees = coll.recent_trees()
    if not trees:
        return None
    payload = {
        'reason': reason,
        'pid': os.getpid(),
        'trees': trees,
    }
    path = os.path.join(out_dir, f'TRACE_{reason}_{os.getpid()}.json')
    try:
        os.makedirs(out_dir, exist_ok=True)
        tmp = f'{path}.tmp'
        with open(tmp, 'w', encoding='utf-8') as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path
    except OSError:
        return None
