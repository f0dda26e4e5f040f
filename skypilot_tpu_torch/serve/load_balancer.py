"""Load balancer: a reverse proxy on the standard library in front of
ready replicas.

The port of `skypilot_tpu/serve/load_balancer.py`, which is aiohttp from
end to end; the card has no aiohttp, so this one is a
`ThreadingHTTPServer` (one thread per client connection) whose upstream
legs are `http.client` connections. Piece by piece it keeps the
reference's behaviour:

- `request_context` (:34, the 4 MB peek cap :31, no parse of a streamed
  body), `_sse_frame_doc` (:85), `classify_pool_role` (:99),
  `handoff_eligible` (:121) and `RequestRateTracker` (:140, 60 s window).
- `LoadBalancer` (:159): `SKYTPU_LB_POLICY` outranks the spec unless
  `honor_env_policy=False`; the breaker `lb` (3 failures, 15 s recovery)
  on `now_fn`; `set_replicas` (:211), `_pool_candidates` (:233),
  `_failover_order` (:250), `_restore_candidates` (:273) and the
  synchronous `dispatch` (:294) / `_dispatch_traced` (:320) seam.
- The proxy, `_handle_proxy` (:420) / `_proxy_traced` (:454): candidates
  in failover order, only before the first byte reaches the client; one
  `lb.upstream` span a leg, whose id rides the outgoing `traceparent`
  (an inbound `traceparent` and `X-SkyTPU-Handoff` are stripped; only
  the LB sets the handoff header); the breaker fed; fault points
  `lb.upstream` and `lb.upstream_midstream`; 503 + `Retry-After` when
  no replica is ready.
- `_relay_managed` (:638): token frames forwarded verbatim and counted
  (the count is the `sent` of `/internal/restore`); a `migrate` frame,
  or an upstream that dies mid-read, goes to `_fetch_snapshot` (:781)
  and `_migrate_stream` (:805, `lb.migrate`); a non-terminal `handoff`
  frame to `_handoff_stream` (:901, `lb.handoff`: the decode pool
  first, then the general fleet; bytes buffered past the frame dropped
  uncounted), with `_abandon_source` (:1019) and the co-located
  `_resume_local` (:1038).
- `/internal/stats` (:360), `/internal/trace` (:1066), `/metrics`,
  `/internal/timeseries` (the replicas' series federated under a
  `replica` label by `_scrape_replicas`, :1112) and `/internal/alerts`
  (`_fleet_rules`, :1140).
- `start` (:1173) runs the sampler and, when the tick knob is above 0,
  a watchdog whose `pre_tick` scrapes the replicas; it binds 0.0.0.0
  and returns the port. `stop` (:1208) ends in-flight legs and joins
  every thread it started: the server's, each connection's, each
  fire-and-forget abandon's (`_spawn_bg`, :206), the watchdog's and the
  sampler's when this LB started it.

Where the reference awaited, a thread blocks: the read-gap timeout
(`SKYTPU_LB_STREAM_READ_TIMEOUT`) is the upstream socket's timeout, the
whole-request limit (3600 s, :495) a deadline, and a client that leaves
mid-stream is a `BrokenPipeError` or `ConnectionResetError` on the
write. Responses to proxied requests are HTTP/1.1 chunked, each SSE
frame written and flushed as it arrives, so a stream cut after its
first byte ends without the closing chunk, as the reference's does.
"""
import base64
import collections
import contextlib
import http.client
import itertools
import json
import socket
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from skypilot_tpu_torch import envs
from skypilot_tpu_torch.observability import instruments as obs
from skypilot_tpu_torch.observability import metrics as metrics_lib
from skypilot_tpu_torch.observability import spans
from skypilot_tpu_torch.observability import timeseries as timeseries_lib
from skypilot_tpu_torch.observability import watchdog as watchdog_lib
from skypilot_tpu_torch.resilience import circuit
from skypilot_tpu_torch.resilience import faults
from skypilot_tpu_torch.resilience import retries
from skypilot_tpu_torch.serve import load_balancing_policies as lb_policies

_QPS_WINDOW_SECONDS = 60.0
# Bodies above this are never JSON-parsed for routing context: the
# peek must stay O(prompt), not O(attachment).
_CONTEXT_PEEK_MAX_BYTES = 4 * 1024 * 1024
# The reference's ClientTimeout(total=3600): one upstream leg's limit.
_LEG_SECONDS = 3600.0
# Headers that describe one hop's framing, never forwarded: http.client
# and this server frame each hop themselves.
_HOP_HEADERS = ('connection', 'keep-alive', 'transfer-encoding')
_READ_SIZE = 1 << 20


def request_context(body: Optional[bytes],
                    content_type: Optional[str],
                    content_length: Optional[int]
                    ) -> Optional[Dict[str, Any]]:
    """Peek the routing context out of an already-buffered request
    body. Only declared-length JSON bodies are parsed — a streamed
    (chunked, no content-length) upload is proxied as before and
    routes context-free, never buffered twice or parsed
    speculatively. Returns {'prompt_tokens', 'max_new_tokens'} or
    None when the request carries nothing routable."""
    if (not body or content_type != 'application/json'
            or content_length is None
            or content_length > _CONTEXT_PEEK_MAX_BYTES):
        return None
    try:
        doc = json.loads(body)
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(doc, dict):
        return None
    ctx: Dict[str, Any] = {}
    tokens = doc.get('prompt_tokens')
    if not (isinstance(tokens, list) and tokens
            and all(isinstance(t, int) for t in tokens)):
        # OpenAI-style bodies may carry the tokenized prompt under
        # `prompt` (a list of ids): that IS a real token count.
        prompt = doc.get('prompt')
        if isinstance(prompt, list) and prompt and \
                all(isinstance(t, int) for t in prompt):
            tokens = prompt
        else:
            tokens = None
    if tokens is not None:
        ctx['prompt_tokens'] = tokens
    elif isinstance(doc.get('prompt'), str) and doc['prompt']:
        ctx['prompt'] = doc['prompt']
    else:
        return None
    max_new = doc.get('max_new_tokens')
    if isinstance(max_new, int):
        ctx['max_new_tokens'] = max_new
    if doc.get('stream') is True:
        # Only streamed requests can carry the non-terminal handoff
        # frame; key added only when set so poolless callers see the
        # same context dicts as before.
        ctx['stream'] = True
    return ctx


def _sse_frame_doc(frame: bytes) -> Optional[Dict[str, Any]]:
    """The JSON dict of one SSE frame's `data:` line, or None for
    frames the managed relay should pass through uninterpreted
    (comments, keep-alives, non-JSON payloads)."""
    for line in frame.split(b'\n'):
        if line.startswith(b'data: '):
            try:
                doc = json.loads(line[6:])
            except (ValueError, UnicodeDecodeError):
                return None
            return doc if isinstance(doc, dict) else None
    return None


def classify_pool_role(context: Optional[Dict[str, Any]]
                       ) -> Optional[str]:
    """Request shape -> pool role: long-prompt AND short-gen requests
    prefer the prefill-heavy pool; everything else with routable
    content is decode-bound. None (no context) routes unrestricted."""
    if not context:
        return None
    tokens = context.get('prompt_tokens')
    if tokens:
        prompt_len = len(tokens)
    else:
        # The threshold is token-denominated; a raw string is ~4
        # chars/token.
        prompt_len = len(context.get('prompt') or '') // 4
    max_new = context.get('max_new_tokens', 64)
    if prompt_len >= envs.SKYTPU_LB_POOL_PROMPT_THRESHOLD.get() and \
            max_new <= envs.SKYTPU_LB_POOL_MAX_NEW_THRESHOLD.get():
        return 'prefill'
    return 'decode'


def handoff_eligible(context: Optional[Dict[str, Any]]) -> bool:
    """Whether a request may take the two-leg (prefill -> planned
    handoff -> decode) route: only a prompt that arrived TOKENIZED
    (the ~4 chars/token string estimate never gates a handoff) and
    only a streamed request (the only kind that can carry the
    non-terminal handoff frame), of prefill shape. The engine side of
    the guard is structural: the pause exists only after the first
    generated token."""
    if not context or not context.get('stream'):
        return False
    if not context.get('prompt_tokens'):
        return False
    return classify_pool_role(context) == 'prefill'


class RequestRateTracker:
    def __init__(self, now_fn: Callable[[], float] = time.time) -> None:
        self._times = collections.deque()
        self._lock = threading.Lock()
        self._now = now_fn

    def record(self) -> None:
        with self._lock:
            self._times.append(self._now())

    def qps(self) -> float:
        cutoff = self._now() - _QPS_WINDOW_SECONDS
        with self._lock:
            while self._times and self._times[0] < cutoff:
                self._times.popleft()
            return len(self._times) / _QPS_WINDOW_SECONDS


class _Frames:
    """The bytes of an SSE stream, cut into frames at blank lines.
    Appending and cutting stay linear however large a frame grows: a
    handoff or migrate frame carries a whole KV snapshot (hundreds of
    MB at a full model's width), read a chunk at a time."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._scan = 0

    def feed(self, data: bytes) -> None:
        self._buf += data

    def next(self) -> Optional[bytes]:
        """The next whole frame (without its blank line), or None."""
        end = self._buf.find(b'\n\n', self._scan)
        if end < 0:
            self._scan = max(0, len(self._buf) - 1)
            return None
        frame = bytes(self._buf[:end])
        del self._buf[:end + 2]
        self._scan = 0
        return frame

    def clear(self) -> None:
        self._buf.clear()
        self._scan = 0


class _Upstream:
    """One upstream exchange: an `http.client` request sent and its
    response's headers read. Registered with the LB while open, so
    `stop()` can cut a read that blocks. Reads take the read-gap
    timeout, bounded by the leg's deadline."""

    def __init__(self, lb: 'LoadBalancer', target: str, method: str,
                 path: str, body: Optional[bytes],
                 headers: Dict[str, str]) -> None:
        url = urllib.parse.urlsplit(target)
        self.deadline = time.monotonic() + _LEG_SECONDS
        self._lb = lb
        self.sock: Optional[socket.socket] = None
        self.resp: Optional[http.client.HTTPResponse] = None
        self._conn = http.client.HTTPConnection(
            url.hostname, url.port or 80, timeout=_LEG_SECONDS)
        lb._track(self)
        try:
            self._conn.connect()
            # Kept apart from the connection: http.client drops its
            # reference once a close-delimited response owns it.
            self.sock = self._conn.sock
            self._conn.request(method, url.path.rstrip('/') + path,
                               body=body, headers=headers)
            self.resp = self._conn.getresponse()
        except BaseException:
            self.close()
            raise
        self.status = self.resp.status
        self.headers = self.resp.headers

    def read(self, gap: float) -> bytes:
        """The bytes available now (at least one, or b'' at EOF),
        waiting at most `gap` seconds (0: no gap limit) and never past
        the leg's deadline."""
        if self.resp.isclosed():
            return b''  # the body was read whole (its socket is gone)
        left = self.deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError('upstream leg past its 3600 s limit')
        self.sock.settimeout(min(gap, left) if gap > 0 else left)
        return self.resp.read1(_READ_SIZE)

    def shutdown(self) -> None:
        """Unblock a read in another thread (`stop()`)."""
        if self.sock is not None:
            with contextlib.suppress(OSError):
                self.sock.shutdown(socket.SHUT_RDWR)

    def close(self) -> None:
        self._lb._untrack(self)
        with contextlib.suppress(Exception):
            if self.resp is not None:
                self.resp.close()
        with contextlib.suppress(Exception):
            self._conn.close()
        if self.sock is not None:
            with contextlib.suppress(OSError):
                self.sock.close()


def _write_chunk(handler: BaseHTTPRequestHandler, data: bytes) -> None:
    handler.wfile.write(b'%x\r\n%s\r\n' % (len(data), data))
    handler.wfile.flush()


def _write_eof(handler: BaseHTTPRequestHandler) -> None:
    handler.wfile.write(b'0\r\n\r\n')
    handler.wfile.flush()


def _send_body(handler: BaseHTTPRequestHandler, status: int, body: bytes,
               content_type: str,
               headers: Optional[Dict[str, str]] = None) -> int:
    handler.send_response(status)
    handler.send_header('Content-Type', content_type)
    handler.send_header('Content-Length', str(len(body)))
    handler.send_header('Connection', 'close')
    for name, value in (headers or {}).items():
        handler.send_header(name, value)
    handler.end_headers()
    if handler.command != 'HEAD':
        handler.wfile.write(body)
    return status


def _send_json(handler: BaseHTTPRequestHandler, doc: Any,
               status: int = 200) -> int:
    return _send_body(handler, status, json.dumps(doc).encode(),
                      'application/json; charset=utf-8')


def _send_text(handler: BaseHTTPRequestHandler, status: int, text: str,
               headers: Optional[Dict[str, str]] = None) -> int:
    return _send_body(handler, status, text.encode(),
                      'text/plain; charset=utf-8', headers)


def _read_request_body(handler: BaseHTTPRequestHandler
                       ) -> Tuple[bytes, Optional[int]]:
    """(body, declared Content-Length or None). A chunked upload is
    read whole (a failed-over request must replay identical bytes) but
    declares no length, so it never feeds the routing peek."""
    if 'chunked' in (handler.headers.get('Transfer-Encoding') or
                     '').lower():
        parts = []
        while True:
            size = int(handler.rfile.readline().split(b';')[0].strip(),
                       16)
            if size == 0:
                while handler.rfile.readline() not in (b'\r\n', b'\n',
                                                       b''):
                    pass
                return b''.join(parts), None
            parts.append(handler.rfile.read(size))
            handler.rfile.readline()
    length = handler.headers.get('Content-Length')
    if length is None:
        return b'', None
    n = int(length)
    return handler.rfile.read(n), n


class LoadBalancer:
    def __init__(self, policy_name: str = 'least_load',
                 port: int = 0,
                 now_fn: Callable[[], float] = time.time,
                 honor_env_policy: bool = True) -> None:
        # SKYTPU_LB_POLICY outranks the spec: live routing A/Bs must
        # not require a spec edit. Callers that ARE the A/B pass
        # honor_env_policy=False — a stray exported override silently
        # running both passes on one policy would turn the comparison
        # into a phantom regression.
        self.policy_name = policy_name
        if honor_env_policy:
            self.policy_name = envs.SKYTPU_LB_POLICY.get() or \
                policy_name
        self.policy = lb_policies.make_policy(
            self.policy_name,
            now_fn=(time.monotonic if now_fn is time.time else now_fn))
        self.port = port
        # url -> pool ROLE ('prefill'/'decode'/'general'); empty means
        # no pool routing (single undifferentiated fleet).
        self._pool_roles: Dict[str, str] = {}
        self.tracker = RequestRateTracker(now_fn)
        # Replica endpoints that keep failing at the transport layer
        # get routed around instead of 502ing live traffic. now_fn is
        # the clock seam; the production default keeps the breaker on
        # monotonic time (immune to wall-clock jumps).
        self.breaker = circuit.CircuitBreaker(
            'lb', failure_threshold=3, recovery_timeout=15.0,
            now_fn=(time.monotonic if now_fn is time.time else now_fn),
            on_open=self._dump_on_breaker_open)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # Fleet telemetry federation: the LB's watchdog scrapes every
        # replica's /internal/timeseries on its tick (pre_tick seam)
        # into the shared store, each series stamped with a `replica`
        # label.
        self._watchdog: Optional[watchdog_lib.Watchdog] = None
        self._owns_sampler = False
        self._scrape_since: Dict[str, float] = {}
        # What stop() must end and join: open upstream legs, client
        # connections, and fire-and-forget abandons.
        self._lock = threading.Lock()
        self._upstreams: set = set()
        self._clients: set = set()
        self._bg_threads: set = set()
        self._stopping = False

    # -- bookkeeping of what stop() ends -------------------------------------

    def _track(self, upstream: _Upstream) -> None:
        with self._lock:
            self._upstreams.add(upstream)

    def _untrack(self, upstream: _Upstream) -> None:
        with self._lock:
            self._upstreams.discard(upstream)

    def _spawn_bg(self, fn: Callable, *args) -> None:
        """A fire-and-forget call on a daemon thread that stop() joins
        (the reference's tasks that the event loop held weakly)."""
        def run():
            try:
                fn(*args)
            finally:
                with self._lock:
                    self._bg_threads.discard(thread)

        thread = threading.Thread(target=run, daemon=True,
                                  name='skytpu-lb-bg')
        with self._lock:
            self._bg_threads.add(thread)
        thread.start()

    def set_replicas(self, urls: List[str],
                     pools: Optional[Dict[str, str]] = None) -> None:
        """`pools` maps url -> pool role; None keeps the previous
        mapping (or no pools at all) so poolless callers are
        untouched."""
        old = set(self.policy.replicas) - set(urls)
        self.policy.set_replicas(urls)
        if pools is not None:
            self._pool_roles = dict(pools)
        for gone in old:
            self.breaker.forget(gone)
            self._pool_roles.pop(gone, None)

    def _dump_on_breaker_open(self, target: str) -> None:
        """A circuit opening means this LB just gave up on a replica —
        dump the span flight recorder so the trees leading up to the
        failures survive for offline triage. No-op unless
        SKYTPU_TRACE_DUMP_DIR is set."""
        out_dir = envs.SKYTPU_TRACE_DUMP_DIR.get()
        if out_dir:
            spans.dump_flight_recorder(out_dir, 'breaker_open')

    def _pool_candidates(self, context) -> Optional[List[str]]:
        """Replica-pool slice for this request's shape, or None for
        no restriction (no pools configured, no routable context, or
        the preferred pool currently has no ready replica — shape
        preference must never 503 a servable request)."""
        if not self._pool_roles:
            return None
        role = classify_pool_role(context)
        if role is None:
            return None
        urls = [r for r in self.policy.replicas
                if self._pool_roles.get(r) == role]
        if not urls:
            return None
        obs.LB_POOL_REQUESTS.labels(pool=role).inc()
        return urls

    def _failover_order(self, context=None):
        """Upstream try-order: the policy's pick first, then the rest
        of its pool, then every other replica — a failed upstream
        must not 502 the client while healthy replicas exist. None
        when the rotation is empty; otherwise a LAZY iterator (the
        common case consumes one element). Shared by the HTTP proxy
        AND dispatch()."""
        pool = self._pool_candidates(context)
        first = self.policy.select(context=context, candidates=pool)
        if first is None:
            return None
        if pool is None:
            return itertools.chain(
                (first,),
                (r for r in self.policy.replicas if r != first))
        pool_set = set(pool)
        return itertools.chain(
            (first,), (r for r in pool if r != first),
            (r for r in self.policy.replicas
             if r != first and r not in pool_set))

    def _restore_candidates(self, context=None,
                            role: str = 'decode') -> List[str]:
        """Candidate order for RESTORE legs (planned handoff and crash
        migration): the work remaining after any snapshot is
        decode-only, so the decode pool's replicas come FIRST, then the
        rest of the fleet. The request's original shape classification
        deliberately does not drive this order: it classified the
        *whole* request (long prompt => prefill pool), which is wrong
        for the remainder. Poolless deployments degrade to plain fleet
        order."""
        del context  # shape classification deliberately unused here
        pool = [r for r in self.policy.replicas
                if self._pool_roles.get(r) == role]
        pool_set = set(pool)
        return pool + [r for r in self.policy.replicas
                       if r not in pool_set]

    # -- the non-HTTP seam ---------------------------------------------------

    def dispatch(self, send: Callable[[str], bool],
                 context: Optional[Dict[str, Any]] = None) -> str:
        """Route ONE request through the real policy + breaker +
        failover discipline without the HTTP layer. `send(url)`
        performs the request against one upstream and returns success;
        failures feed the breaker and fail over exactly like the
        proxy's pre-bytes phase. Returns 'ok', 'no_replica' (empty
        rotation), 'all_open' (candidates exist, every circuit open)
        or 'error' (every attempted upstream failed). Each dispatch
        records the proxy's lb.proxy/lb.upstream span shape."""
        self.tracker.record()
        root_attrs: Dict[str, Any] = {'transport': 'dispatch'}
        with spans.span('lb.proxy', attrs=root_attrs) as root:
            result = self._dispatch_traced(send, context, root)
            root_attrs['result'] = result
            if result != 'ok':
                spans.COLLECTOR.mark_error(root.trace_id)
            return result

    def _dispatch_traced(self, send: Callable[[str], bool],
                         context: Optional[Dict[str, Any]],
                         root: spans.SpanContext) -> str:
        candidates = self._failover_order(context)
        if candidates is None:
            obs.LB_NO_REPLICA.inc()
            return 'no_replica'
        attempted = 0
        for target in candidates:
            if not self.breaker.allow(target):
                continue
            attempted += 1
            if attempted > 1:
                obs.LB_UPSTREAM_RETRIES.inc()
            obs.LB_REPLICA_REQUESTS.labels(replica=target).inc()
            self.policy.on_request_start(target, context=context)
            leg_attrs: Dict[str, Any] = {'replica': target,
                                         'attempt': attempted}
            try:
                with spans.span('lb.upstream', attrs=leg_attrs):
                    ok = send(target)
                    leg_attrs['ok'] = bool(ok)
            finally:
                self.policy.on_request_end(target)
            if ok:
                self.breaker.record_success(target)
                return 'ok'
            obs.LB_PROXY_ERRORS.inc()
            self.breaker.record_failure(target)
            # Failed legs make the trace keep-worthy even when a later
            # leg succeeds: the breaker-open dump should contain the
            # requests that fed the breaker.
            spans.COLLECTOR.mark_error(root.trace_id)
        if attempted == 0:
            obs.LB_NO_REPLICA.inc()
            return 'all_open'
        return 'error'

    # -- the LB's own routes -------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """The /internal/stats document (reference :360)."""
        # snapshot() is non-mutating: polling stats must not burn
        # half-open trial slots.
        states = self.breaker.snapshot()
        replicas = list(self.policy.replicas)
        breakers = {
            url: states.get(url, circuit.State.CLOSED).name.lower()
            for url in replicas}
        return {
            'qps': self.tracker.qps(),
            'replicas': replicas,
            'breakers': breakers,
            'candidates': sum(1 for s in breakers.values()
                              if s != 'open'),
            # Per-bucket exemplars from the LB's own histograms.
            'exemplars': metrics_lib.exemplars_snapshot(),
            # WHY traffic shifted: the policy's affinity-table shape
            # plus the hit/miss/bounded-load counters.
            'routing': {
                'policy': self.policy_name,
                'pools': dict(self._pool_roles),
                'affinity': {
                    **self.policy.stats(),
                    'hits': int(obs.LB_AFFINITY_HITS.value()),
                    'misses': int(obs.LB_AFFINITY_MISSES.value()),
                    'fallbacks':
                        int(obs.LB_AFFINITY_FALLBACKS.value()),
                },
            },
            # Engine pressure from the process-local registry (real
            # series in co-located deployments).
            'engine': {
                'queue_depth': obs.QUEUE_DEPTH.value(),
                'kv_cache_utilization':
                    obs.KV_CACHE_UTILIZATION.value(),
                'kv_pages': {
                    'total': int(obs.KV_PAGES_TOTAL.value()),
                    'free': int(obs.KV_PAGES_FREE.value()),
                    'cached': int(obs.PREFIX_CACHE_PAGES.value()),
                    'private': int(obs.KV_PAGES_PRIVATE.value()),
                },
                'prefix_cache_hits':
                    int(obs.PREFIX_CACHE_HITS.value()),
                'prefix_cache_misses':
                    int(obs.PREFIX_CACHE_MISSES.value()),
            },
        }

    def trace(self, trace_id: Optional[str]
              ) -> Tuple[Dict[str, Any], int]:
        """The /internal/trace document (reference :1066): the LB's own
        spans for a trace id plus, best-effort, whatever each replica's
        /internal/trace knows about it — one query returns the LB leg
        AND the replica's server/engine phases under one tree."""
        if not trace_id:
            trees = spans.COLLECTOR.recent_trees()
            return {'traces': [
                {'trace_id': t['trace_id'], 'error': t['error'],
                 'duration': t['duration'],
                 'spans': len(t['spans'])} for t in trees]}, 200
        records = list(spans.COLLECTOR.spans_for(trace_id))
        query = urllib.parse.urlencode({'trace_id': trace_id})
        for target in list(self.policy.replicas):
            url = target.rstrip('/') + '/internal/trace?' + query
            try:
                with urllib.request.urlopen(url, timeout=2) as r:
                    doc = json.loads(r.read())
            except (OSError, ValueError, http.client.HTTPException):
                # A replica that is down (or never saw the trace)
                # contributes nothing; the LB's own legs still render.
                continue
            records.extend(doc.get('spans') or [])
        if not records:
            return {'error': f'unknown trace_id {trace_id!r} (dropped by '
                             'sampling, evicted, or never seen here)'}, 404
        return {
            'trace_id': trace_id,
            'spans': records,
            'tree': spans.tree_view(records),
            'traceEvents':
                spans.to_chrome_trace(records)['traceEvents'],
        }, 200

    def _handle_own(self, handler: BaseHTTPRequestHandler, path: str,
                    query: Dict[str, str]) -> bool:
        """Answer the LB's own GET routes; False for anything else (it
        is proxied)."""
        if path == '/internal/stats':
            _send_json(handler, self.stats())
        elif path == '/internal/trace':
            doc, status = self.trace(query.get('trace_id'))
            _send_json(handler, doc, status)
        elif path == '/metrics':
            # The LB's own metrics, not a replica's (a replica's
            # /metrics is scraped directly).
            body, content_type = metrics_lib.handler()
            _send_body(handler, 200, body, content_type)
        elif path == '/internal/timeseries':
            # Fleet-merged: the LB's own series plus every replica's
            # (replica-labeled).
            _send_json(handler, timeseries_lib.handler(query))
        elif path == '/internal/alerts':
            _send_json(handler, watchdog_lib.handler(self._watchdog))
        else:
            return False
        return True

    # -- the proxy -----------------------------------------------------------

    def _handle_proxy(self, handler: BaseHTTPRequestHandler) -> None:
        self.tracker.record()
        # The body is buffered once (a failed-over request must replay
        # identical bytes); the routing peek reuses THAT buffer, and
        # refuses undeclared-length or oversized bodies.
        body, length = _read_request_body(handler)
        content_type = (handler.headers.get_content_type()
                        if 'Content-Type' in handler.headers
                        else 'application/octet-stream')
        context = request_context(body, content_type, length)
        # Join the caller's trace when it sent a traceparent; root a
        # new one otherwise.
        inbound = spans.parse_traceparent(
            handler.headers.get(spans.TRACEPARENT_HEADER))
        root_attrs: Dict[str, Any] = {
            'method': handler.command,
            'path': urllib.parse.urlsplit(handler.path).path}
        with spans.span('lb.proxy', parent=inbound,
                        attrs=root_attrs) as root:
            status = self._proxy_traced(handler, body, context, root)
            root_attrs['status'] = status
            if status >= 500:
                spans.COLLECTOR.mark_error(root.trace_id)

    def _proxy_traced(self, handler: BaseHTTPRequestHandler, body: bytes,
                      context: Optional[Dict[str, Any]],
                      root: spans.SpanContext) -> int:
        """One routing pass under `root`'s trace: upstreams tried in
        failover order, each attempt wrapped in an lb.upstream span
        whose OWN id rides the outgoing traceparent. Returns the status
        the client got."""
        trace_hdr = {spans.TRACE_ID_RESPONSE_HEADER: root.trace_id}
        candidates = self._failover_order(context)
        if candidates is None:
            obs.LB_NO_REPLICA.inc()
            return _send_text(handler, 503,
                              'No ready replicas. Retry shortly.\n',
                              {'Retry-After': '1', **trace_hdr})
        last_error: Optional[BaseException] = None
        attempted = 0
        for target in candidates:
            if self._stopping:
                break
            if not self.breaker.allow(target):
                continue
            attempted += 1
            if attempted > 1:
                obs.LB_UPSTREAM_RETRIES.inc()
            obs.LB_REPLICA_REQUESTS.labels(replica=target).inc()
            self.policy.on_request_start(target, context=context)
            upstream: Optional[_Upstream] = None
            leg_attrs: Dict[str, Any] = {'replica': target,
                                         'attempt': attempted}
            try:
                with spans.span('lb.upstream', attrs=leg_attrs) as leg:
                    # Phase 1 — contact the upstream. Failures here are
                    # the REPLICA's: feed the breaker, fail over.
                    try:
                        faults.inject('lb.upstream', env_exc=OSError)
                        # The replica parents on THIS leg, not on the
                        # client's span; X-SkyTPU-Handoff is LB-owned.
                        hdrs = {k: v for k, v in handler.headers.items()
                                if k.lower() not in (
                                    'host', 'content-length',
                                    'x-skytpu-handoff',
                                    spans.TRACEPARENT_HEADER,
                                    *_HOP_HEADERS)}
                        hdrs[spans.TRACEPARENT_HEADER] = \
                            spans.format_traceparent(leg)
                        if (self._pool_roles
                                and handoff_eligible(context)
                                and envs.SKYTPU_MIGRATION_ENABLE.get()):
                            # Two-leg route: the prefill replica pauses
                            # at the first token under a lease and
                            # exports a non-terminal handoff frame.
                            hdrs['X-SkyTPU-Handoff'] = '1'
                        upstream = _Upstream(
                            self, target, handler.command, handler.path,
                            body if body or handler.command not in (
                                'GET', 'HEAD') else None, hdrs)
                    except (OSError, http.client.HTTPException) as e:
                        obs.LB_PROXY_ERRORS.inc()
                        self.breaker.record_failure(target)
                        last_error = e
                        leg_attrs['error'] = type(e).__name__
                        # A failed leg makes the trace keep-worthy even
                        # if a later leg succeeds.
                        spans.COLLECTOR.mark_error(leg.trace_id)
                        # Nothing written: fail over to the next one.
                        continue
                    # The replica answered: success for breaker
                    # purposes. Errors past this point interleave
                    # upstream reads with CLIENT-socket writes; blaming
                    # the replica would let one dead client open
                    # circuits on healthy replicas.
                    self.breaker.record_success(target)
                    leg_attrs['status'] = upstream.status
                    return self._relay(handler, upstream, target, context,
                                       leg_attrs, leg)
            finally:
                self.policy.on_request_end(target)
                if upstream is not None:
                    upstream.close()
        if last_error is None:
            # Candidates existed but every circuit was open.
            obs.LB_NO_REPLICA.inc()
            return _send_text(
                handler, 503,
                'All replicas are circuit-open. Retry shortly.\n',
                {'Retry-After': '1', **trace_hdr})
        return _send_text(handler, 502,
                          f'All {attempted} upstream(s) failed; last '
                          f'error: {last_error}\n', trace_hdr)

    def _relay(self, handler: BaseHTTPRequestHandler, upstream: _Upstream,
               target: str, context: Optional[Dict[str, Any]],
               leg_attrs: Dict[str, Any], leg: spans.SpanContext) -> int:
        """Send the upstream's status and headers, then stream its body
        chunk by chunk (SSE and chunked token streams flow as
        generated); a migratable token stream goes to the frame-aware
        relay. Returns the status."""
        status = upstream.status
        bodyless = handler.command == 'HEAD' or status in (204, 304) \
            or status < 200
        try:
            handler.send_response_only(status, upstream.resp.reason)
            for name, value in upstream.headers.items():
                if name.lower() not in ('content-length',
                                        'x-trace-id', *_HOP_HEADERS):
                    handler.send_header(name, value)
            handler.send_header(spans.TRACE_ID_RESPONSE_HEADER,
                                leg.trace_id)
            if not bodyless:
                handler.send_header('Transfer-Encoding', 'chunked')
            handler.send_header('Connection', 'close')
            handler.end_headers()
        except OSError:
            # Client socket failed before headers went out.
            return status
        if bodyless:
            return status
        # Only the gap between chunks of an ALREADY-STARTED stream is
        # bounded (a per-request read timeout would also cap
        # time-to-first-byte): a wedged upstream mid-stream terminates
        # the client's response instead of hanging it.
        read_gap = envs.SKYTPU_LB_STREAM_READ_TIMEOUT.get()
        mig_key = upstream.headers.get('X-SkyTPU-Migration-Key')
        if (mig_key and context is not None and status == 200
                and (upstream.headers.get('Content-Type') or ''
                     ).startswith('text/event-stream')
                and envs.SKYTPU_MIGRATION_ENABLE.get()):
            # Migratable token stream: relay frame-aware so an
            # interruption (drain's terminal migrate event, or the
            # upstream dying mid-stream) resumes on another replica.
            return self._relay_managed(handler, upstream, target, mig_key,
                                       context, read_gap, leg_attrs, leg,
                                       status)
        while True:
            # Upstream reads and client writes fail for DIFFERENT
            # parties: separate try blocks, so a dead replica is never
            # blamed on the client or vice versa.
            try:
                faults.inject('lb.upstream_midstream', env_exc=OSError)
                chunk = upstream.read(read_gap)
            except (OSError, http.client.HTTPException):
                # The upstream died AFTER bytes went out: a retry would
                # corrupt the stream and a closing chunk would forge a
                # COMPLETE response out of a truncated one. The honest
                # signal left is closing the client connection
                # mid-body.
                obs.LB_PROXY_ERRORS.inc()
                obs.LB_MIDSTREAM_FAILURES.inc()
                leg_attrs['midstream_error'] = True
                spans.COLLECTOR.mark_error(leg.trace_id)
                return status
            if not chunk:
                break
            try:
                _write_chunk(handler, chunk)
            except OSError:
                return status  # the CLIENT went away; the replica is fine
        with contextlib.suppress(OSError):
            _write_eof(handler)
        return status

    def _relay_managed(self, handler: BaseHTTPRequestHandler,
                       upstream: _Upstream, target: str, mig_key: str,
                       context: Dict[str, Any], read_gap: float,
                       leg_attrs: Dict[str, Any], leg: spans.SpanContext,
                       status: int) -> int:
        """Frame-aware SSE relay for migratable generate streams.

        Token frames are forwarded verbatim and COUNTED once the client
        has them — that count is the ground truth of what the client
        has seen, and rides `?sent=` into /internal/restore so the
        resumed stream starts at exactly the next unseen token. Two
        interruption shapes trigger migration: the upstream draining
        (its terminal `migrate` frame carries the blob), and the
        upstream dying mid-read (the blob is fetched from
        /internal/snapshot by migration key). Honest termination is
        the last rung: only when migration fails inside its deadline.

        A NON-terminal `handoff` frame is the planned two-leg route:
        the ladder (_handoff_stream) either restores onto a decode-pool
        replica (switch upstreams, drop any bytes buffered past the
        frame — they were never counted into `sent`, so the restored
        stream re-sends them) or resumes the SAME upstream co-located
        (keep reading, buffer intact). Only if the prefill replica died
        too does it fall through to crash migration with the handoff
        blob in hand."""
        state = {'sent': 0, 'last_token': time.monotonic()}
        own: List[_Upstream] = []  # upstreams of restored legs
        cur_up, cur_target, cur_key = upstream, target, mig_key
        buf = _Frames()
        try:
            while True:
                migrate_payload = None
                handoff_payload = None
                interrupted = False
                while not interrupted and migrate_payload is None \
                        and handoff_payload is None:
                    # Drain frames already buffered BEFORE reading more:
                    # a co-located fallback re-enters here with leftover
                    # bytes that must not be dropped.
                    while (frame := buf.next()) is not None:
                        doc = _sse_frame_doc(frame)
                        if doc is not None and 'migrate' in doc:
                            migrate_payload = doc['migrate']
                            break
                        if doc is not None and 'handoff' in doc:
                            handoff_payload = doc['handoff']
                            break
                        if doc is None or 'token' in doc:
                            try:
                                _write_chunk(handler, frame + b'\n\n')
                            except OSError:
                                return status  # client went away
                            if doc is not None:
                                state['sent'] += 1
                                state['last_token'] = time.monotonic()
                            continue
                        # done / error: terminal, forward verbatim.
                        with contextlib.suppress(OSError):
                            _write_chunk(handler, frame + b'\n\n')
                            _write_eof(handler)
                        return status
                    if migrate_payload is not None or \
                            handoff_payload is not None:
                        break
                    try:
                        faults.inject('lb.upstream_midstream',
                                      env_exc=OSError)
                        chunk = cur_up.read(read_gap)
                    except (OSError, http.client.HTTPException):
                        interrupted = True
                        break
                    if not chunk:
                        # EOF without a terminal frame: the upstream
                        # vanished mid-stream.
                        interrupted = True
                        break
                    buf.feed(chunk)
                if self._stopping:
                    return status  # stop() cut the leg: no migration
                if handoff_payload is not None:
                    res = self._handoff_stream(context, state, cur_target,
                                               cur_key, handoff_payload)
                    if isinstance(res, tuple):
                        # The decode leg owns the request now: close the
                        # prefill leg and tell the replica to drop its
                        # copy (left open, the lease would expire into a
                        # zombie co-located decode of the SAME tokens).
                        cur_up.close()
                        self._spawn_bg(self._abandon_source, cur_target,
                                       cur_key)
                        cur_up, cur_target, cur_key = res
                        own.append(cur_up)
                        # Bytes past the handoff frame were never counted
                        # into `sent`; the restored stream re-sends them.
                        buf.clear()
                        continue
                    if res == 'fallback':
                        # Co-located resume: the prefill replica's
                        # stream (and our buffer) just continues.
                        continue
                    # The prefill replica is unreachable too: crash
                    # migration is the backstop, with the blob in hand.
                    migrate_payload = handoff_payload
                new = self._migrate_stream(context, state, cur_target,
                                           cur_key, migrate_payload)
                if new is None:
                    # Failure ladder's last rung: honest termination
                    # (the connection closes without the last chunk).
                    obs.LB_PROXY_ERRORS.inc()
                    obs.LB_MIDSTREAM_FAILURES.inc()
                    leg_attrs['midstream_error'] = True
                    spans.COLLECTOR.mark_error(leg.trace_id)
                    return status
                cur_up, cur_target, cur_key = new
                own.append(cur_up)
                buf.clear()
                # Loop: the restored stream is itself migratable.
        finally:
            for up in own:
                up.close()

    def _restore_leg(self, cand: str, sent: int, blob: bytes
                     ) -> Union[_Upstream, int]:
        """POST a blob to `cand`'s /internal/restore; the open stream on
        200, else the status (the leg closed). OSError when `cand` is
        unreachable."""
        up = _Upstream(self, cand, 'POST',
                       f'/internal/restore?sent={sent}&stream=1', blob,
                       {'Content-Type': 'application/octet-stream'})
        if up.status == 200:
            return up
        up.close()
        return up.status

    def _fetch_snapshot(self, target: str, key: str,
                        deadline: float) -> Optional[bytes]:
        """GET the request's KV snapshot off the interrupted replica
        by migration key; None when it can't be had (replica truly
        dead, request already finished, key unknown)."""
        if not key:
            return None
        budget = deadline - time.monotonic()
        if budget <= 0:
            return None
        url = (target.rstrip('/') + '/internal/snapshot?' +
               urllib.parse.urlencode({'key': key}))
        try:
            with urllib.request.urlopen(
                    url, timeout=max(0.1, min(5.0, budget))) as r:
                return r.read()
        except (OSError, http.client.HTTPException):
            return None

    def _migrate_stream(self, context, state, dead_target, dead_key,
                        migrate_payload
                        ) -> Optional[Tuple[_Upstream, str, str]]:
        """Resume one interrupted stream on another replica: blob from
        the drain event (or fetched by key), restored decode-pool-first
        (_restore_candidates) under the migration deadline budget.
        Returns (upstream, target, new_key) or None — the caller
        honest-terminates on None."""
        policy = retries.RetryPolicy(
            deadline=envs.SKYTPU_MIGRATION_DEADLINE_SECONDS.get(),
            base_delay=0.1, max_delay=1.0)
        deadline = time.monotonic() + (policy.deadline or 0.0)
        obs.MIGRATION_ATTEMPTS.inc()
        t0 = time.monotonic()
        attrs: Dict[str, Any] = {'from': dead_target,
                                 'sent': state['sent']}
        with spans.span('lb.migrate', attrs=attrs):
            try:
                faults.inject('lb.migrate', env_exc=OSError)
                blob: Optional[bytes] = None
                if migrate_payload is not None:
                    try:
                        blob = base64.b64decode(
                            migrate_payload.get('snapshot') or '')
                    except (ValueError, TypeError):
                        blob = None
                if not blob:
                    blob = self._fetch_snapshot(dead_target, dead_key,
                                                deadline)
                if not blob:
                    raise OSError('no snapshot available for the '
                                  'interrupted stream')
                if len(blob) > envs.SKYTPU_MIGRATION_MAX_BYTES.get():
                    raise OSError(
                        f'snapshot is {len(blob)} bytes, over '
                        'SKYTPU_MIGRATION_MAX_BYTES')
                attrs['blob_bytes'] = len(blob)
                delay = policy.base_delay
                while True:
                    for cand in self._restore_candidates(context):
                        if cand == dead_target or \
                                not self.breaker.allow(cand):
                            continue
                        if time.monotonic() >= deadline:
                            break
                        try:
                            up = self._restore_leg(cand, state['sent'],
                                                   blob)
                        except (OSError, http.client.HTTPException):
                            self.breaker.record_failure(cand)
                            continue
                        if up == 400:
                            # The blob itself is bad — no other replica
                            # will accept it either.
                            raise OSError(
                                'restore rejected the snapshot blob')
                        if isinstance(up, int):
                            continue  # capacity/draining (409/503)
                        self.breaker.record_success(cand)
                        attrs['to'] = cand
                        obs.MIGRATION_SUCCESSES.inc()
                        obs.MIGRATION_SECONDS.observe(
                            time.monotonic() - t0)
                        obs.MIGRATION_INTERRUPTION_SECONDS.observe(
                            time.monotonic() - state['last_token'])
                        return (up, cand,
                                up.headers.get('X-SkyTPU-Migration-Key')
                                or '')
                    if time.monotonic() + delay >= deadline:
                        raise OSError('no replica could restore the '
                                      'stream inside the migration '
                                      'deadline')
                    # READY sets change under us (a drained replica's
                    # successor registering): wait and re-list.
                    time.sleep(delay)
                    delay = min(delay * 2, policy.max_delay)
            except OSError as e:
                attrs['error'] = str(e)
                obs.MIGRATION_FAILURES.inc()
                return None

    def _handoff_stream(self, context, state, src_target, src_key,
                        payload
                        ) -> Union[Tuple[_Upstream, str, str], str, None]:
        """Walk the planned prefill->decode handoff ladder for one
        paused stream. Rungs, in order:

        1. Restore onto a decode-pool candidate (_restore_candidates,
           breaker-allowed, source excluded) under the
           SKYTPU_HANDOFF_DEADLINE_SECONDS retry budget; the blob is
           capped by SKYTPU_HANDOFF_MAX_BYTES.
        2. On exhaustion, POST /internal/resume on the prefill replica:
           its slot is still live under the lease, so the co-located
           fallback is a state transition — the client stream just
           continues. Counted as a handoff fallback, never an error.

        Returns (upstream, target, new_key) after a decode-leg restore,
        'fallback' after a co-located resume, or None when the prefill
        replica is unreachable too — the caller then falls through to
        the crash-migration backstop with the blob in hand."""
        obs.HANDOFF_ATTEMPTS.inc()
        policy = retries.RetryPolicy(
            deadline=envs.SKYTPU_HANDOFF_DEADLINE_SECONDS.get(),
            base_delay=0.05, max_delay=0.5)
        t0 = time.monotonic()
        deadline = t0 + (policy.deadline or 0.0)
        attrs: Dict[str, Any] = {'from': src_target,
                                 'sent': state['sent']}
        with spans.span('lb.handoff', attrs=attrs):
            try:
                faults.inject('lb.handoff', env_exc=OSError)
                try:
                    blob = base64.b64decode(payload.get('snapshot') or '')
                except (ValueError, TypeError):
                    blob = b''
                if not blob:
                    raise OSError('handoff frame carried no snapshot')
                if len(blob) > envs.SKYTPU_HANDOFF_MAX_BYTES.get():
                    raise OSError(
                        f'handoff blob is {len(blob)} bytes, over '
                        'SKYTPU_HANDOFF_MAX_BYTES')
                attrs['blob_bytes'] = len(blob)
                delay = policy.base_delay
                while True:
                    candidates = [
                        c for c in self._restore_candidates(context)
                        if c != src_target]
                    if not candidates:
                        # Nothing to wait for: a one-replica fleet
                        # resumes co-located immediately.
                        raise OSError('no other replica to take the '
                                      'decode leg')
                    for cand in candidates:
                        if not self.breaker.allow(cand):
                            continue
                        if time.monotonic() >= deadline:
                            break
                        try:
                            up = self._restore_leg(cand, state['sent'],
                                                   blob)
                        except (OSError, http.client.HTTPException):
                            self.breaker.record_failure(cand)
                            continue
                        if up == 400:
                            # Bad blob: no replica will take it; the
                            # co-located original is still decodable.
                            raise OSError(
                                'restore rejected the handoff blob')
                        if isinstance(up, int):
                            continue  # capacity/draining (409/503)
                        self.breaker.record_success(cand)
                        attrs['to'] = cand
                        obs.HANDOFF_SUCCESSES.inc()
                        obs.HANDOFF_TRANSFER_SECONDS.observe(
                            time.monotonic() - t0)
                        state['last_token'] = time.monotonic()
                        return (up, cand,
                                up.headers.get('X-SkyTPU-Migration-Key')
                                or '')
                    if time.monotonic() + delay >= deadline:
                        raise OSError(
                            'no decode-pool replica took the handoff '
                            'inside SKYTPU_HANDOFF_DEADLINE_SECONDS')
                    time.sleep(delay)
                    delay = min(delay * 2, policy.max_delay)
            except OSError as e:
                attrs['error'] = str(e)
            status = self._resume_local(src_target, src_key)
            if status is not None:
                attrs['fallback'] = 'resume'
                if status == 'resumed':
                    # 'active' means the lease already expired and the
                    # ENGINE counted the fallback — counting here too
                    # would double it.
                    obs.HANDOFF_FALLBACKS.inc()
                state['last_token'] = time.monotonic()
                return 'fallback'
            # The prefill replica is gone too; crash migration (the
            # caller) is the remaining rung.
            attrs['fallback'] = 'migrate'
            return None

    def _post_resume(self, target: str, params: Dict[str, str],
                     timeout: float) -> bytes:
        url = (target.rstrip('/') + '/internal/resume?' +
               urllib.parse.urlencode(params))
        req = urllib.request.Request(url, data=b'', method='POST')
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.read()

    def _abandon_source(self, target: str, key: str) -> None:
        """Best-effort: tell the prefill replica its copy of a
        handed-off request is no longer needed (the decode-leg restore
        was confirmed) so the lease-paused slot frees now. Failure is
        harmless — the replica's own lease expiry reclaims the slot
        eventually."""
        if not key:
            return
        with contextlib.suppress(Exception):
            self._post_resume(target, {'key': key, 'abandon': '1'}, 5.0)

    def _resume_local(self, target: str, key: str) -> Optional[str]:
        """POST /internal/resume?key= on the prefill replica: flips the
        lease-paused slot back to decoding, and the already-open stream
        continues by itself. Returns the replica's status ('resumed',
        or 'active' when the lease had already expired and the slot
        resumed itself), or None when the replica can't be reached or
        no longer knows the key."""
        if not key:
            return None
        try:
            body = self._post_resume(target, {'key': key}, 5.0)
        except (OSError, http.client.HTTPException):
            return None
        try:
            doc = json.loads(body)
        except ValueError:
            return 'resumed'
        return str(doc.get('status') or 'resumed')

    # -- fleet telemetry federation -------------------------------------------

    def _scrape_replicas(self, wd: watchdog_lib.Watchdog) -> None:
        """Watchdog pre_tick: pull every replica's retained series
        (incrementally, via `since=`) into the shared store under a
        `replica=<url>` label, and write the synthetic
        skytpu_replica_up gauge per scrape outcome."""
        store = wd.store
        for target in list(self.policy.replicas):
            url = (target.rstrip('/') + '/internal/timeseries')
            since = self._scrape_since.get(target)
            if since is not None:
                url += f'?since={since}'
            up = 0.0
            try:
                with urllib.request.urlopen(url, timeout=2) as r:
                    doc = json.loads(r.read().decode('utf-8'))
                store.ingest_dump(doc, extra_labels={'replica': target})
                self._scrape_since[target] = float(
                    doc.get('now') or 0.0) or self._scrape_since.get(
                        target, 0.0)
                up = 1.0
            except (OSError, ValueError, http.client.HTTPException):
                pass
            store.add_sample('skytpu_replica_up', {'replica': target},
                             up, now=wd.now_fn())

    def _fleet_rules(self) -> List[Any]:
        """The LB's live rules: SKYTPU_WATCHDOG_RULES / anomaly
        defaults plus replica liveness over the CURRENT replica set,
        re-read each tick."""
        rules = watchdog_lib.default_rules()
        rules.append(watchdog_lib.ReplicaUp(
            'replica_up',
            replicas_fn=lambda: list(self.policy.replicas)))
        return rules

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> int:
        """Serve on 0.0.0.0 from a background thread; returns the bound
        port. The telemetry plane rides the LB's lifecycle: the
        registry sampler, plus a watchdog whose every tick first
        scrapes the replicas' series (each a no-op when its interval
        knob is 0)."""
        self._stopping = False
        self._owns_sampler = (not timeseries_lib.sampler_running()
                              and timeseries_lib.start_sampler())
        if envs.SKYTPU_WATCHDOG_TICK_SECONDS.get() > 0:
            self._watchdog = watchdog_lib.Watchdog(
                rules=self._fleet_rules(),
                pre_tick=self._scrape_replicas)
            self._watchdog.start()
        server = ThreadingHTTPServer(('0.0.0.0', self.port),
                                     _make_handler(self))
        # Non-daemon connection threads: server_close() joins them.
        server.daemon_threads = False
        self._server = server
        self.port = server.server_address[1]
        # A short poll: stop() waits one for the serving loop to end.
        self._thread = threading.Thread(target=server.serve_forever,
                                        kwargs={'poll_interval': 0.05},
                                        daemon=True, name='skytpu-lb')
        self._thread.start()
        return self.port

    def stop(self) -> None:
        """Stop serving: in-flight legs end (a cut stream is not
        migrated), and every thread this LB started is joined."""
        self._stopping = True
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        if self._server is not None:
            self._server.shutdown()
            with self._lock:
                open_legs = list(self._upstreams)
                clients = list(self._clients)
            for up in open_legs:
                up.shutdown()
            for conn in clients:
                with contextlib.suppress(OSError):
                    conn.shutdown(socket.SHUT_RDWR)
            self._server.server_close()  # joins the connection threads
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        with self._lock:
            background = list(self._bg_threads)
        for thread in background:
            thread.join(timeout=10)
        if self._owns_sampler:
            timeseries_lib.stop_sampler()
            self._owns_sampler = False


def _make_handler(lb: LoadBalancer):
    """The connection handler class bound to `lb`: the LB's own GET
    routes, every other method and path proxied."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = 'HTTP/1.1'
        server_version = 'skypilot-tpu-torch-lb'

        def log_message(self, format, *args):  # noqa: A002
            pass  # keep the serving log to errors

        def setup(self):
            super().setup()
            with lb._lock:
                lb._clients.add(self.connection)

        def finish(self):
            try:
                super().finish()
            finally:
                with lb._lock:
                    lb._clients.discard(self.connection)

        def _serve(self):
            # One request a connection: every response says close.
            self.close_connection = True
            url = urllib.parse.urlsplit(self.path)
            try:
                if self.command == 'GET' and lb._handle_own(
                        self, url.path,
                        dict(urllib.parse.parse_qsl(url.query))):
                    return
                lb._handle_proxy(self)
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client went away; nobody is left to answer

        do_GET = do_POST = do_PUT = do_DELETE = do_PATCH = _serve
        do_HEAD = do_OPTIONS = _serve

    return Handler
