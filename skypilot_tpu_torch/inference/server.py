"""Inference HTTP server for the port, on the standard library only.

Ports the serving core of `skypilot_tpu/inference/server.py`: the
`EngineLoop` (:58) with its `_tick` (:339), restore and migration
helpers (:121-231), and the `/health` and `/generate` handlers (:455,
:499) with the reference's bodies:
  GET  /health    -> 200 {"status": "ok", "engine": {...}} once loaded
  POST /generate  -> {"prompt_tokens": [...], "max_new_tokens": N,
                      "temperature": t, "top_k": k, "top_p": p,
                      "eos_token_id": e, "logprobs": bool}
                     => {"tokens": [...]} (+ "logprobs")
                     with "stream": true => SSE: `data: {"token": t}`
                     per token, then `data: {"done": true, "tokens": [...]}`.

Request migration, as the reference's (same status codes and bodies,
so its load balancer drives a port replica unchanged):
  POST /internal/drain?deadline=s   stop admission, wait, snapshot the
                                    stragglers (:645)
  GET  /internal/snapshot?key=k     one request's blob (:682)
  GET|POST /internal/resume?key=k[&abandon=1]   handoff fallback (:708)
  POST /internal/restore?sent=n&stream=1        splice a blob (:748)
Streams carry `X-SkyTPU-Migration-Key`, a non-terminal `handoff` frame
for requests sent with `X-SkyTPU-Handoff: 1`, and a terminal `migrate`
frame when a drain snapshots them. SIGTERM drains, then exits; the
server also exits when its launcher dies (`_watch_parent`, :853),
unless `--no-exit-with-parent`.

The telemetry plane, as the reference's (:833-841), through the port's
`observability` package:
  GET /metrics              Prometheus text of the process registry
  GET /internal/trace       the flight recorder's index, or with
                            ?trace_id= one trace's spans, tree and
                            Chrome-trace events (:622-643)
  GET /internal/timeseries  the time-series ring (raw dump, or one
                            windowed answer with ?query=)
  GET /internal/alerts      the watchdog's rules and events
  GET /internal/kernels     this process's kernel launches so far, one
                            count for each wrapper of
                            `ops/flash_attention.py` (the port's own
                            route: the reference has no such count)
Every route runs inside `instruments.http_middleware('inference')`
(request counter and latency histogram, X-Request-ID, an
`inference.request` span grafted onto an inbound `traceparent`,
`X-Trace-ID` out). /health's `engine` block is read from the
instruments' gauges and counters, key for key as the reference's
(:455-495). `main()` starts the sampler and watchdog threads; an
embedded server (`create_server`) starts none.

One engine-loop thread owns the engine (and the card); HTTP handler
threads (`ThreadingHTTPServer`) enqueue requests and wait on their
watcher's queue, so concurrent requests join the running decode batch.
A request's id and span context are captured in the handler thread at
submit and rebound in the engine thread around `engine.submit`
(:111-133, :249-279), so the engine's phase spans join the request's
trace.

The OpenAI-compatible routes (`/v1/models`, `/v1/completions`,
`/v1/chat/completions`; `openai_api.py`, reference :848-849) are
mounted beside these; `--tokenizer` gives them text prompts, chat and
stop strings, `--served-model-name` the id /v1/models reports. Load
shedding (`shed_limit`, reference :423-440): past `--max-queue-depth`
(or SKYTPU_MAX_QUEUE_DEPTH) queued requests, /generate and the /v1
routes answer 503 with Retry-After and count in REQUESTS_SHED.

Sharded serving (`--mesh` over any of the reference's axes, e.g.
`tensor=N`, `expert=N`, `fsdp=N`, `context=N` or `tensor=8,fsdp=2`,
reference :897-898) runs one process per rank, each started with the
same flags and the gang variables SKYTPU_COORDINATOR_ADDR (host:port of
rank 0's rendezvous), SKYTPU_NUM_PROCESSES and SKYTPU_PROCESS_ID.
`tensor` cuts heads, `expert` an MoE's experts, `fsdp` every weight
(each layer gathered for its math), `context` the KV cache's sequence
(a dense cache there: `--kv-page-size` > 0 with `context` raises, as
in the reference, and the prefix cache is off); `data` and `pipe`
replicate. `--draft-model` shards its draft as the target. Rank 0
serves every route, `/internal/drain|snapshot|
restore|resume` and the handoff frame included; the other ranks bind no
port and follow its engine (`InferenceEngine.follow`), which publishes
each snapshot, restore and resume as a control event: the followers
join the gather of a request's KV heads (and spans) to rank 0, or the
scatter of a blob's, at the same point of their step sequence, so a blob
from a
sharded replica restores on an unsharded one and back. Followers exit
0 when rank 0 stops them (SIGTERM on rank 0) and non-zero when rank 0
is gone. The engine loop keeps an idle rank 0's followers posted
(`heartbeat`), and a failed step ends every rank of a replica: its
followers may be mid-collective.

  python -m skypilot_tpu_torch.inference.server --model llama3-8b \
      --port 8080 [--device cuda] [--draft-model llama3-1b --spec-k 4]
      [--checkpoint HF_OR_TRAIN_DIR] [--draft-checkpoint DIR]
      [--max-queue-depth N] [--tokenizer DIR] [--served-model-name ID]
      [--mesh AXIS=N[,AXIS=M...]]
"""
from __future__ import annotations

import argparse
import base64
import concurrent.futures
import json
import os
import queue
import signal
import sys
import threading
import time
import traceback
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from skypilot_tpu_torch import envs
from skypilot_tpu_torch.inference import openai_api
from skypilot_tpu_torch.observability import instruments as obs
from skypilot_tpu_torch.observability import metrics as metrics_lib
from skypilot_tpu_torch.observability import spans
from skypilot_tpu_torch.observability import timeseries as timeseries_lib
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.observability import watchdog as watchdog_lib


class EngineLoop:
    """Single thread owning the engine: requests arrive through a
    queue; per-token progress and results go to per-request watchers.
    Drain, snapshot, resume and abandon run on the engine thread
    between ticks (`run_on_engine`)."""

    class Watcher:
        def __init__(self, stream: bool, sink=None) -> None:
            self.stream = stream
            self.q: 'queue.Queue' = queue.Queue()
            # Where push() delivers (default: the watcher's own queue);
            # the OpenAI routes merge a request's choices into one.
            self._sink = sink or self.q.put
            self.sent = 0
            self.aborted = False
            # Migration identity: the opaque key a load balancer quotes
            # at /internal/snapshot and /internal/resume, and the
            # engine's request id once admitted.
            self.key: Optional[str] = None
            self.rid: Optional[int] = None
            # The request asked to pause at the prefill->decode boundary
            # for a planned handoff.
            self.handoff = False
            self.logprobs: Optional[List[float]] = None

        def push(self, item) -> None:
            self._sink(item)

    def __init__(self, engine) -> None:
        self.engine = engine
        self._submit_q: 'queue.Queue' = queue.Queue()
        self._abort_q: 'queue.Queue' = queue.Queue()
        self._cmd_q: 'queue.Queue' = queue.Queue()
        self._watchers: Dict[int, EngineLoop.Watcher] = {}
        self._by_key: Dict[str, EngineLoop.Watcher] = {}
        self._stop = threading.Event()
        # /health reads the gauges: this engine's from the start.
        engine._update_gauges()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='engine-loop')
        self._thread.start()

    def submit(self, prompt: List[int], sampling, stream: bool = False,
               key: Optional[str] = None, handoff: bool = False,
               sink=None) -> 'EngineLoop.Watcher':
        """Returns the watcher whose queue yields ('token', t)* then
        ('done', tokens), ('migrate', {...}) or ('error', message);
        with `handoff` (stream requests only) also one non-terminal
        ('handoff', {...}). With `sink`, the events go to `sink(event)`
        instead of the watcher's queue."""
        watcher = self.Watcher(stream, sink)
        watcher.key = key
        watcher.handoff = bool(handoff and stream)
        # Contextvars do not cross the queue into the engine thread:
        # capture the request id and span context here.
        self._submit_q.put(('gen', prompt, sampling, watcher,
                            tracing.get_request_id(),
                            spans.current_context()))
        return watcher

    def restore(self, blob: bytes, sent: int = 0, stream: bool = True,
                key: Optional[str] = None) -> 'EngineLoop.Watcher':
        """Splice a migration blob into this engine (on the engine
        thread); the watcher streams only the tokens past `sent`, the
        count the client already received."""
        watcher = self.Watcher(stream)
        watcher.key = key
        watcher.sent = max(0, int(sent))
        self._submit_q.put(('restore', blob, None, watcher,
                            tracing.get_request_id(),
                            spans.current_context()))
        return watcher

    def run_on_engine(self, fn) -> 'concurrent.futures.Future':
        """Run `fn` on the engine thread between ticks."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._cmd_q.put((fn, fut))
        return fut

    def has_pending(self) -> bool:
        """Any request still queued, admitted or streaming."""
        return bool(self._watchers) or not self._submit_q.empty()

    def drain(self, deadline_s: float, flush_s: float,
              timeout: Optional[float] = None
              ) -> List[Tuple['EngineLoop.Watcher', bytes]]:
        """Give in-flight requests up to `deadline_s` to finish, then
        snapshot-and-abort the stragglers on the engine thread
        (`snapshot_inflight`) and allow `flush_s` for their handlers to
        flush the migrate frames. Returns the snapshots."""
        deadline = time.monotonic() + max(0.0, deadline_s)
        while self.has_pending() and time.monotonic() < deadline:
            time.sleep(0.05)
        try:
            return self.run_on_engine(self.snapshot_inflight).result(
                timeout=timeout)
        finally:
            time.sleep(flush_s)

    def abort(self, watcher: 'EngineLoop.Watcher') -> None:
        """Free a request's slot (client gone); applied by the engine
        thread before its next step."""
        watcher.aborted = True
        self._abort_q.put(watcher)

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError('engine loop did not stop within '
                               f'{timeout}s')

    # -- engine-thread-only helpers (call via run_on_engine) -----------------

    def snapshot_inflight(self) -> List[Tuple['EngineLoop.Watcher',
                                              bytes]]:
        """Snapshot-and-abort every remaining request (drain). Each
        watcher gets a terminal ('migrate', {snapshot, sent}); one whose
        client is gone is freed instead."""
        out: List[Tuple[EngineLoop.Watcher, bytes]] = []
        for rid, watcher in list(self._watchers.items()):
            self._watchers.pop(rid, None)
            if watcher.key:
                self._by_key.pop(watcher.key, None)
            if watcher.aborted:
                self.engine.abort(rid)
                continue
            try:
                blob = self.engine.snapshot_request(rid)
            except Exception as e:  # noqa: BLE001 — reported to the client
                watcher.push(('error', f'drain snapshot failed: {e}'))
                self.engine.abort(rid)
                continue
            self.engine.abort(rid)
            watcher.push(('migrate', {
                'snapshot': base64.b64encode(blob).decode('ascii'),
                'sent': watcher.sent}))
            out.append((watcher, blob))
        return out

    def snapshot_by_key(self, key: str) -> Tuple[bytes, int]:
        """Snapshot-and-abort one request by its migration key. Returns
        (blob, tokens already pushed to its stream); KeyError when it
        finished or was never here."""
        watcher = self._by_key.pop(key, None)
        if watcher is None or watcher.rid is None:
            raise KeyError(f'unknown migration key {key!r}')
        blob = self.engine.snapshot_request(watcher.rid)
        self.engine.abort(watcher.rid)
        self._watchers.pop(watcher.rid, None)
        watcher.push(('error', 'request migrated away'))
        return blob, watcher.sent

    def resume_by_key(self, key: str) -> str:
        """Resume a handoff-paused request locally: 'resumed' when the
        lease was still held, 'active' when it already decodes here.
        KeyError when it finished, aborted or was never admitted."""
        watcher = self._by_key.get(key)
        if watcher is None or watcher.rid is None:
            raise KeyError(f'unknown migration key {key!r}')
        return 'resumed' if self.engine.resume_handoff(watcher.rid) \
            else 'active'

    def abandon_by_key(self, key: str) -> None:
        """Drop the co-located copy of a handed-off request (its
        decode-leg restore succeeded elsewhere). KeyError when it
        finished, aborted or was never admitted."""
        watcher = self._by_key.pop(key, None)
        if watcher is None or watcher.rid is None:
            raise KeyError(f'unknown migration key {key!r}')
        self._watchers.pop(watcher.rid, None)
        self.engine.abort(watcher.rid)
        watcher.push(('error', 'request handed off to the decode pool'))

    # -- the loop ------------------------------------------------------------

    def _process_submission(self, item) -> None:
        kind, payload, sampling, watcher, req_id, span_ctx = item
        if watcher.aborted:
            return
        # Rebind the handler's request context for engine.submit, which
        # captures the span parent of the request's phases.
        rid_token = tracing.bind(req_id) if req_id else None
        ctx_token = (spans.bind_context(span_ctx)
                     if span_ctx is not None else None)
        try:
            if kind == 'restore':
                rid = self.engine.restore_request(payload)
            else:
                rid = self.engine.submit(payload, sampling,
                                         handoff=watcher.handoff)
        except Exception as e:  # noqa: BLE001 — the handler must hear
            # Restore keeps the exception type: SnapshotError (bad blob,
            # 400) and RuntimeError (no room here, 409) drive different
            # load-balancer decisions.
            msg = (f'{type(e).__name__}: {e}' if kind == 'restore'
                   else str(e))
            watcher.push(('error', msg))
            return
        finally:
            if ctx_token is not None:
                spans.unbind_context(ctx_token)
            if rid_token is not None:
                tracing.unbind(rid_token)
        watcher.rid = rid
        self._watchers[rid] = watcher
        if watcher.key:
            self._by_key[watcher.key] = watcher

    def _drain_submissions(self) -> None:
        while True:
            try:
                item = self._submit_q.get_nowait()
            except queue.Empty:
                return
            self._process_submission(item)

    def _drain_commands(self) -> None:
        while True:
            try:
                fn, fut = self._cmd_q.get_nowait()
            except queue.Empty:
                return
            try:
                result = fn()
            except Exception as e:  # noqa: BLE001 — the future carries it
                fut.set_exception(e)
            else:
                fut.set_result(result)

    def _drain_aborts(self) -> None:
        while True:
            try:
                target = self._abort_q.get_nowait()
            except queue.Empty:
                return
            for rid, watcher in list(self._watchers.items()):
                if watcher is target:
                    self._watchers.pop(rid)
                    if watcher.key:
                        self._by_key.pop(watcher.key, None)
                    self.engine.abort(rid)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 — the loop must live
                # Fail the in-flight requests (handlers answer 500) and
                # keep serving: a dead loop would hang every request.
                for watcher in self._watchers.values():
                    watcher.push(('error', f'{type(e).__name__}: {e}'))
                self._watchers.clear()
                self._by_key.clear()
                mesh = self.engine.mesh
                if mesh is not None and mesh.world_size > 1:
                    # Its followers may be mid-collective, or their host
                    # plans apart from this one: the replica ends.
                    traceback.print_exc()
                    os._exit(1)  # noqa: SLF001 — the HTTP threads never join
                self.engine.abort_all()

    def _tick(self) -> None:
        self._drain_commands()
        self._drain_submissions()
        self._drain_aborts()
        if not self.engine.has_work:
            self.engine.heartbeat()
            try:
                item = self._submit_q.get(timeout=0.2)
            except queue.Empty:
                return
            self._process_submission(item)
            return
        if not self.engine.has_runnable_work:
            # Every live slot is parked under a handoff lease: park
            # briefly instead of spinning (step() still expires leases).
            try:
                item = self._submit_q.get(timeout=0.005)
            except queue.Empty:
                pass
            else:
                self._process_submission(item)
        self.engine.step()
        self._drain_aborts()
        progress = self.engine.active_progress()
        finished = self.engine.finished()
        finished_lps = self.engine.finished_logprobs()
        for rid, tokens in {**progress, **finished}.items():
            watcher = self._watchers.get(rid)
            if watcher is not None and watcher.stream:
                for t in tokens[watcher.sent:]:
                    watcher.push(('token', t))
                watcher.sent = len(tokens)
        for rid, tokens in finished.items():
            watcher = self._watchers.pop(rid, None)
            if watcher is not None:
                if watcher.key:
                    self._by_key.pop(watcher.key, None)
                watcher.logprobs = finished_lps.get(rid)
                watcher.push(('done', tokens))
        # Handoff export AFTER the token fan-out: the frame's sent count
        # includes the first token, so the decode leg starts at the next.
        for rid in self.engine.handoff_pending():
            watcher = self._watchers.get(rid)
            self.engine.mark_handoff_exported(rid)
            if watcher is None or watcher.aborted or not watcher.stream:
                self.engine.resume_handoff(rid)
                continue
            try:
                with spans.span('engine.handoff_snapshot',
                                attrs={'request_id': rid}):
                    blob = self.engine.snapshot_request(rid)
            except Exception:  # noqa: BLE001 — degrade, don't fail
                # Unsnapshottable (size cap, injected fault): decode
                # co-located.
                self.engine.resume_handoff(rid)
                continue
            watcher.push(('handoff', {
                'snapshot': base64.b64encode(blob).decode('ascii'),
                'sent': watcher.sent}))


def shed_limit(holder: Dict[str, Any]) -> Optional[int]:
    """Load shedding (reference :423-440): the queue-depth limit if the
    engine is at or over it right now, else None. Past the limit a
    request would only age in the queue past any client timeout; a fast
    503 + Retry-After lets the load balancer or the client try another
    replica. The limit: holder['max_queue_depth'] (--max-queue-depth),
    else SKYTPU_MAX_QUEUE_DEPTH; 0 or unset disables. Each shed request
    counts in REQUESTS_SHED."""
    limit = holder.get('max_queue_depth')
    if limit is None:
        # A malformed env value reads as the declared default (0: off).
        limit = envs.SKYTPU_MAX_QUEUE_DEPTH.get()
    if limit and obs.QUEUE_DEPTH.value() >= limit:
        obs.REQUESTS_SHED.inc()
        return int(limit)
    return None


def _parse_sampling(body: Dict[str, Any]):
    from skypilot_tpu_torch.inference.engine import SamplingParams
    eos = body.get('eos_token_id')
    return SamplingParams(
        temperature=float(body.get('temperature', 0.0)),
        top_k=int(body.get('top_k', 0)),
        top_p=float(body.get('top_p', 1.0)),
        max_new_tokens=int(body.get('max_new_tokens', 64)),
        eos_token_id=None if eos is None else int(eos))


def _sse(payload: Dict[str, Any]) -> bytes:
    return f'data: {json.dumps(payload)}\n\n'.encode()


def _health_engine() -> Dict[str, Any]:
    """/health's `engine` block, read from the instruments (reference
    :455-495): liveness detail without a device sync."""
    return {
        'queue_depth': int(obs.QUEUE_DEPTH.value()),
        'in_flight': int(obs.BATCH_SLOTS_ACTIVE.value()),
        'batch_occupancy': obs.BATCH_OCCUPANCY.value(),
        'kv_cache_utilization': obs.KV_CACHE_UTILIZATION.value(),
        'kv_pages': {
            'total': int(obs.KV_PAGES_TOTAL.value()),
            'free': int(obs.KV_PAGES_FREE.value()),
            'cached': int(obs.PREFIX_CACHE_PAGES.value()),
            'private': int(obs.KV_PAGES_PRIVATE.value()),
        },
        'prefix_cache': {
            'hits': int(obs.PREFIX_CACHE_HITS.value()),
            'misses': int(obs.PREFIX_CACHE_MISSES.value()),
            'reused_tokens': int(obs.PREFIX_CACHE_REUSED_TOKENS.value()),
            'evictions': int(obs.PREFIX_CACHE_EVICTIONS.value()),
        },
        # Zeros without a draft; acceptance over a window is the
        # accepted/proposed counter-delta ratio.
        'spec': {
            'rounds': int(obs.SPEC_ROUNDS.value()),
            'proposed_tokens': int(obs.SPEC_PROPOSED_TOKENS.value()),
            'accepted_tokens': int(obs.SPEC_ACCEPTED_TOKENS.value()),
        },
    }


def _kernel_launches() -> Dict[str, int]:
    """/internal/kernels: each kernel wrapper's launches in this
    process (its `launches`; the plain version's calls never count)."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    return {name: getattr(fa, name).launches for name in (
        'flash_attention', 'flash_attention_quant', 'flash_attention_dq',
        'flash_attention_dkv')}


def _trace_doc(query: Dict[str, str]) -> Tuple[Dict[str, Any], int]:
    """/internal/trace: the flight recorder's index, or one trace's
    spans, tree and Chrome-trace events (reference :622-643)."""
    trace_id = query.get('trace_id')
    if not trace_id:
        return {'traces': [
            {'trace_id': t['trace_id'], 'error': t['error'],
             'duration': t['duration'], 'spans': len(t['spans'])}
            for t in spans.COLLECTOR.recent_trees()]}, 200
    records = spans.COLLECTOR.spans_for(trace_id)
    if not records:
        return {'error': f'unknown trace_id {trace_id!r} (dropped by '
                         'sampling, evicted, or never seen here)'}, 404
    return {'trace_id': trace_id, 'spans': records,
            'tree': spans.tree_view(records),
            'traceEvents': spans.to_chrome_trace(records)['traceEvents']}, 200


def make_handler(holder: Dict[str, Any]):
    """The request handler class, bound to `holder` ({'loop':
    EngineLoop or None while loading; 'draining': True once a drain
    started})."""

    @obs.http_middleware('inference')
    class Handler(BaseHTTPRequestHandler):
        server_version = 'skypilot-tpu-torch'

        def log_message(self, format, *args):  # noqa: A002
            pass  # keep the serving log to errors

        def _json(self, doc: Dict[str, Any], status: int = 200,
                  headers: Optional[Dict[str, str]] = None) -> None:
            body = json.dumps(doc).encode()
            self.send_response(status)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def _route(self) -> Tuple[str, Dict[str, str]]:
            url = urllib.parse.urlsplit(self.path)
            return url.path, dict(urllib.parse.parse_qsl(url.query))

        def _body(self) -> bytes:
            return self.rfile.read(int(self.headers.get('Content-Length',
                                                        0)))

        def do_GET(self):  # noqa: N802
            path, query = self._route()
            loop: Optional[EngineLoop] = holder.get('loop')
            if path in ('/health', '/'):
                if loop is None:
                    self._json({'status': 'loading'}, 503)
                    return
                self._json({'status': 'ok', 'engine': _health_engine()})
            elif path == '/metrics':
                body, content_type = metrics_lib.handler()
                self.send_response(200)
                self.send_header('Content-Type', content_type)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == '/internal/trace':
                self._json(*_trace_doc(query))
            elif path == '/internal/timeseries':
                self._json(timeseries_lib.handler(query))
            elif path == '/internal/alerts':
                self._json(watchdog_lib.handler())
            elif path == '/internal/kernels':
                self._json(_kernel_launches())
            elif path == '/internal/snapshot':
                self._snapshot(loop, query)
            elif path == '/internal/resume':
                self._resume(loop, query)
            elif ('GET', path) in openai_api.ROUTES:
                openai_api.ROUTES['GET', path](self, holder)
            else:
                self._json({'error': 'not found'}, 404)

        def do_POST(self):  # noqa: N802
            path, query = self._route()
            loop: Optional[EngineLoop] = holder.get('loop')
            if path == '/generate':
                self._generate(loop)
            elif path == '/internal/drain':
                self._drain(loop, query)
            elif path == '/internal/resume':
                self._resume(loop, query)
            elif path == '/internal/restore':
                self._restore(loop, query)
            elif ('POST', path) in openai_api.ROUTES:
                openai_api.ROUTES['POST', path](self, holder)
            else:
                self._json({'error': 'not found'}, 404)

        def _generate(self, loop: Optional[EngineLoop]) -> None:
            if loop is None:
                self._json({'error': 'model loading'}, 503)
                return
            if holder.get('draining'):
                # No new admissions once a drain started.
                self._json({'error': 'replica draining'}, 503,
                           {'Retry-After': '1'})
                return
            limit = shed_limit(holder)
            if limit is not None:
                self._json({'error': f'overloaded: queue depth >= {limit}'},
                           503, {'Retry-After': '1'})
                return
            try:
                body = json.loads(self._body() or b'{}')
                prompt = [int(t) for t in body['prompt_tokens']]
                sampling = _parse_sampling(body)
            except (json.JSONDecodeError, KeyError, TypeError, ValueError,
                    AttributeError):
                self._json({'error': 'need {"prompt_tokens": [ints]} with '
                                     'numeric sampling fields'}, 400)
                return
            if not prompt:
                self._json({'error': 'prompt_tokens must be non-empty'},
                           400)
                return
            stream = bool(body.get('stream', False))
            # A load balancer flags the prefill leg it will hand off to
            # the decode pool; stream requests only.
            handoff = (stream
                       and self.headers.get('X-SkyTPU-Handoff') == '1'
                       and envs.SKYTPU_MIGRATION_ENABLE.get())
            key = uuid.uuid4().hex
            watcher = loop.submit(prompt, sampling, stream=stream, key=key,
                                  handoff=handoff)
            try:
                if stream:
                    self._stream(watcher, key)
                else:
                    self._wait(watcher, bool(body.get('logprobs', False)))
            except (BrokenPipeError, ConnectionResetError):
                loop.abort(watcher)
                raise  # the middleware counts it as 499

        def _wait(self, watcher, want_logprobs: bool,
                  first: Optional[Tuple[str, Any]] = None) -> None:
            while True:
                kind, payload = first or watcher.q.get()
                first = None
                if kind == 'done':
                    doc = {'tokens': payload}
                    if want_logprobs:
                        doc['logprobs'] = watcher.logprobs
                    self._json(doc)
                    return
                if kind == 'migrate':
                    # A drain caught this request: the caller finishes
                    # it elsewhere from the blob.
                    self._json({'error': 'replica draining',
                                'migrate': payload}, 409,
                               {'X-SkyTPU-Migrate': '1'})
                    return
                if kind == 'error':
                    self._json({'error': payload}, 500)
                    return

        def _stream(self, watcher, key: str,
                    first: Optional[Tuple[str, Any]] = None) -> None:
            self.send_response(200)
            self.send_header('Content-Type', 'text/event-stream')
            self.send_header('Cache-Control', 'no-cache')
            self.send_header('X-SkyTPU-Migration-Key', key)
            self.end_headers()
            self.wfile.flush()
            kind, payload = first or watcher.q.get()
            while True:
                if kind == 'token':
                    frame = {'token': payload}
                elif kind in ('handoff', 'migrate', 'error'):
                    # handoff is the one non-terminal frame: the slot
                    # stays live under its lease and the stream goes on.
                    frame = {kind: payload}
                else:
                    frame = {'done': True, 'tokens': payload}
                self.wfile.write(_sse(frame))
                self.wfile.flush()
                if kind not in ('token', 'handoff'):
                    return
                kind, payload = watcher.q.get()

        def _drain(self, loop: Optional[EngineLoop],
                   query: Dict[str, str]) -> None:
            """Stop admission, give in-flight requests `?deadline=`
            (default SKYTPU_DRAIN_DEADLINE_SECONDS) to finish, then
            snapshot-and-abort the stragglers: streams get a terminal
            migrate frame, the others' blobs come back here."""
            if loop is None:
                self._json({'status': 'empty'})
                return
            holder['draining'] = True
            try:
                deadline_s = float(query.get(
                    'deadline', envs.SKYTPU_DRAIN_DEADLINE_SECONDS.get()))
            except ValueError:
                deadline_s = envs.SKYTPU_DRAIN_DEADLINE_SECONDS.get()
            snapshots = loop.drain(deadline_s, flush_s=0.1)
            self._json({
                'status': 'drained',
                'finished_naturally': not snapshots,
                'snapshots': [
                    {'snapshot': base64.b64encode(blob).decode('ascii'),
                     'sent': watcher.sent}
                    for watcher, blob in snapshots if not watcher.stream],
                'migrated_streams': sum(
                    1 for watcher, _ in snapshots if watcher.stream),
            })

        def _snapshot(self, loop: Optional[EngineLoop],
                      query: Dict[str, str]) -> None:
            key = query.get('key')
            if loop is None or not key:
                self._json({'error': 'need ?key= and a live engine'}, 400)
                return
            try:
                blob, sent = loop.run_on_engine(
                    lambda: loop.snapshot_by_key(key)).result()
            except KeyError:
                self._json({'error': f'unknown migration key {key!r} '
                                     '(request finished, aborted, or '
                                     'never admitted here)'}, 404)
                return
            except Exception as e:  # noqa: BLE001 — snapshot refusal
                self._json({'error': str(e)}, 500)
                return
            self.send_response(200)
            self.send_header('Content-Type', 'application/octet-stream')
            self.send_header('Content-Length', str(len(blob)))
            self.send_header('X-SkyTPU-Sent', str(sent))
            self.end_headers()
            self.wfile.write(blob)

        def _resume(self, loop: Optional[EngineLoop],
                    query: Dict[str, str]) -> None:
            """Resume a handoff-paused request here (idempotent with
            lease expiry), or with ?abandon=1 drop it (its decode leg
            was restored elsewhere)."""
            key = query.get('key')
            if loop is None or not key:
                self._json({'error': 'need ?key= and a live engine'}, 400)
                return
            if query.get('abandon'):
                try:
                    loop.run_on_engine(
                        lambda: loop.abandon_by_key(key)).result()
                except KeyError:
                    self._json({'error': f'unknown migration key {key!r}'},
                               404)
                    return
                self._json({'status': 'abandoned'})
                return
            try:
                status = loop.run_on_engine(
                    lambda: loop.resume_by_key(key)).result()
            except KeyError:
                self._json({'error': f'unknown migration key {key!r} '
                                     '(request finished, aborted, or '
                                     'never admitted here)'}, 404)
                return
            self._json({'status': status})

        def _restore(self, loop: Optional[EngineLoop],
                     query: Dict[str, str]) -> None:
            """Splice a blob and resume it: ?sent=N tokens already
            reached the client, so the stream starts at token N+1. 400
            for a bad blob, 409 for no room here, 503 while loading or
            draining."""
            if loop is None:
                self._json({'error': 'model loading'}, 503)
                return
            if holder.get('draining'):
                self._json({'error': 'replica draining'}, 503,
                           {'Retry-After': '1'})
                return
            blob = self._body()
            try:
                sent = max(0, int(query.get('sent', '0')))
            except ValueError:
                self._json({'error': 'bad ?sent='}, 400)
                return
            stream = query.get('stream', '1') not in ('0', 'false')
            key = uuid.uuid4().hex
            watcher = loop.restore(blob, sent=sent, stream=stream, key=key)
            # The first event says whether the engine took the blob,
            # while the status is still open.
            kind, payload = watcher.q.get()
            if kind == 'error':
                bad_blob = str(payload).startswith('SnapshotError')
                self._json({'error': payload}, 400 if bad_blob else 409)
                return
            try:
                if stream:
                    self._stream(watcher, key, (kind, payload))
                else:
                    self._wait(watcher, False, (kind, payload))
            except (BrokenPipeError, ConnectionResetError):
                loop.abort(watcher)
                raise  # the middleware counts it as 499

    return Handler


def create_server(holder: Dict[str, Any], host: str = '0.0.0.0',
                  port: int = 8080) -> ThreadingHTTPServer:
    """An HTTP server bound to (host, port); run it with
    serve_forever() and stop it with shutdown() + server_close(). It
    starts no sampler or watchdog thread (main() does), so embedded
    servers stay thread-free."""
    server = ThreadingHTTPServer((host, port), make_handler(holder))
    server.daemon_threads = True
    return server


def prefix_cache_arg(flag: str) -> Optional[bool]:
    """--prefix-cache auto|on|off -> build_engine's prefix_cache
    (None = follow SKYTPU_PREFIX_CACHE, as the reference)."""
    return None if flag == 'auto' else flag == 'on'


def engine_kwargs(args) -> Dict[str, Any]:
    """build_engine's arguments for the parsed flags (every rank of a
    mesh builds the same engine)."""
    return dict(
        device=args.device, seed=args.seed, checkpoint=args.checkpoint,
        mesh_arg=args.mesh, draft_checkpoint=args.draft_checkpoint,
        batch_size=args.batch_size, max_seq_len=args.max_seq_len,
        prefill_chunk=args.prefill_chunk, kv_quant=args.kv_quant,
        prefill_interleave=args.prefill_interleave,
        draft_model=args.draft_model, spec_k=args.spec_k,
        spec_fuse_rounds=args.spec_fuse_rounds,
        decode_fuse_steps=args.decode_fuse_steps,
        kv_page_size=args.kv_page_size, kv_pages=args.kv_pages,
        prefix_cache=prefix_cache_arg(args.prefix_cache),
        prefix_cache_max_pages=args.prefix_cache_max_pages)


def _watch_parent() -> None:
    """Exit when the launching process dies (the server is reparented):
    a replica dies with its launcher and never lingers holding the card.
    A server started by PID 1 (a container entrypoint) cannot see a
    reparent, so the watchdog stands down there."""
    interval = envs.SKYTPU_WATCHDOG_INTERVAL.get(default=5.0)
    original = os.getppid()
    if original == 1:
        return

    def _loop():
        while True:
            if os.getppid() != original:
                os._exit(0)  # noqa: SLF001 — the engine thread never joins
            time.sleep(interval)

    threading.Thread(target=_loop, daemon=True,
                     name='parent-watchdog').start()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='tiny',
                        help='Config name resolvable by models.resolve')
    parser.add_argument('--port', type=int, default=8080)
    parser.add_argument('--device', default='cuda',
                        help="Torch device ('cuda' by default; 'cpu' runs "
                             'the plain PyTorch paths).')
    parser.add_argument('--seed', type=int, default=0,
                        help='Seed of the random weights.')
    parser.add_argument('--checkpoint', default=None,
                        help='Checkpoint dir with model params: an HF '
                             'safetensors dir (config.json + '
                             '*.safetensors, streamed import) or a port '
                             'train checkpoint of --model, layout '
                             'auto-detected; an HF dir\'s geometry wins '
                             'over --model. Without it the weights are '
                             'random from --seed.')
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--max-seq-len', type=int, default=None)
    parser.add_argument('--max-queue-depth', type=int, default=None,
                        help='Shed load (503 + Retry-After) once this many '
                             'requests are queued ahead of the decode batch '
                             '(default: SKYTPU_MAX_QUEUE_DEPTH; 0 disables).')
    parser.add_argument('--tokenizer', default=None,
                        help='HF tokenizer dir/name (needs transformers). '
                             'Enables text prompts, chat templates and stop '
                             'strings on the /v1 OpenAI endpoints; without '
                             'it the server takes token ids.')
    parser.add_argument('--served-model-name', default=None,
                        help='Model id reported by /v1/models (default: '
                             '--model).')
    parser.add_argument('--prefill-chunk', type=int, default=1024)
    parser.add_argument('--prefill-interleave', type=int, default=None)
    parser.add_argument('--draft-model', default=None,
                        help='Speculative decoding: a small same-vocab draft '
                             'model (random weights from --seed + 1) '
                             'proposes spec-k tokens per target verify pass '
                             '(greedy requests; lossless). Incompatible '
                             'with --prefill-interleave (the draft cache '
                             'needs one-shot prefill).')
    parser.add_argument('--draft-checkpoint', default=None,
                        help='HF safetensors checkpoint of the draft model.')
    parser.add_argument('--spec-k', type=int, default=None,
                        help='Draft tokens per speculative round (default: '
                             'SKYTPU_SPEC_K).')
    parser.add_argument('--spec-fuse-rounds', type=int, default=None,
                        help='Speculative draft/verify rounds per host '
                             'dispatch (default: SKYTPU_SPEC_FUSE_ROUNDS, '
                             '8; 1 = one dispatch per round).')
    parser.add_argument('--kv-quant', default='auto',
                        choices=['auto', 'none', 'int8'])
    parser.add_argument('--decode-fuse-steps', type=int, default=None)
    parser.add_argument('--kv-page-size', type=int, default=None)
    parser.add_argument('--kv-pages', type=int, default=None)
    parser.add_argument('--prefix-cache', default='auto',
                        choices=['auto', 'on', 'off'],
                        help='Cross-request prefix KV reuse (radix cache, '
                             'copy-on-write pages). auto (default) '
                             'resolves via SKYTPU_PREFIX_CACHE (on); paged, '
                             'chunked engines only.')
    parser.add_argument('--prefix-cache-max-pages', type=int, default=None,
                        help='Cap on KV pages the prefix cache keeps '
                             '(default: SKYTPU_PREFIX_CACHE_MAX_PAGES, '
                             '0 = bounded by the pool only).')
    parser.add_argument('--mesh', default=None,
                        help='Shard serving over a device mesh, e.g. '
                             'tensor=2, expert=2 (an MoE), fsdp=2, '
                             'context=2 (a dense KV cache cut on its '
                             'sequence) or tensor=8,fsdp=2: one process per '
                             'rank, each started with the same flags and '
                             'SKYTPU_COORDINATOR_ADDR, SKYTPU_NUM_PROCESSES '
                             'and SKYTPU_PROCESS_ID; rank 0 serves.')
    parser.add_argument('--no-exit-with-parent', action='store_true',
                        help='Keep serving after the launcher exits '
                             '(deliberate daemonization only).')
    args = parser.parse_args()
    if not args.no_exit_with_parent:
        _watch_parent()
    if args.mesh and envs.SKYTPU_PROCESS_ID.get(strict=True) > 0:
        # A follower rank: no port, no telemetry threads; it steps with
        # rank 0 until rank 0 stops it.
        from skypilot_tpu_torch import inference
        from skypilot_tpu_torch.parallel import mesh as mesh_lib
        try:
            inference.build_engine(args.model,
                                   **engine_kwargs(args)).follow()
        finally:
            mesh_lib.shutdown()
        return
    # The live telemetry plane: the registry sampler and the SLO
    # watchdog (each a no-op when its interval knob is 0).
    timeseries_lib.start_sampler()
    watchdog_lib.start_watchdog()

    holder: Dict[str, Any] = {
        'loop': None, 'tokenizer': None,
        'model_name': args.served_model_name or args.model,
        'max_queue_depth': args.max_queue_depth}
    server = create_server(holder, port=args.port)
    load_errors: List[BaseException] = []

    def _load():
        # /health answers 503 'loading' meanwhile; a failed load stops
        # the server instead of leaving it loading forever.
        from skypilot_tpu_torch import inference
        try:
            if args.tokenizer:
                holder['tokenizer'] = openai_api.load_tokenizer(
                    args.tokenizer)
            engine = inference.build_engine(args.model,
                                            **engine_kwargs(args))
        except Exception as e:  # noqa: BLE001 — reported by main()
            load_errors.append(e)
            server.shutdown()
            return
        holder['loop'] = EngineLoop(engine)

    threading.Thread(target=_load, daemon=True).start()

    def _drain_and_exit() -> None:
        # SIGTERM is a preemption notice: stop admission, let in-flight
        # requests finish within the drain deadline, snapshot the
        # stragglers (their streams end in a migrate frame), then exit.
        holder['draining'] = True
        loop: Optional[EngineLoop] = holder.get('loop')
        if loop is not None:
            try:
                loop.drain(envs.SKYTPU_DRAIN_DEADLINE_SECONDS.get(),
                           flush_s=1.0, timeout=30)
                # Under a mesh the followers exit 0 with this rank.
                loop.run_on_engine(loop.engine.stop_followers).result(
                    timeout=30)
            except Exception as e:  # noqa: BLE001 — exit regardless
                print(f'drain on SIGTERM failed: {e}', file=sys.stderr,
                      flush=True)
        os._exit(0)  # noqa: SLF001 — the engine thread never joins

    # Never block in a signal handler: the drain sleeps.
    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
        target=_drain_and_exit, daemon=True).start())
    try:
        server.serve_forever()
    finally:
        server.server_close()
    if load_errors:
        raise SystemExit(f'engine failed to load: '
                         f'{type(load_errors[0]).__name__}: '
                         f'{load_errors[0]}')


if __name__ == '__main__':
    main()
