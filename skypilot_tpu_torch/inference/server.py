"""Inference HTTP server for the port, on the standard library only.

Ports the serving core of `skypilot_tpu/inference/server.py`: the
`EngineLoop` (:58) with its `_tick` (:339), and the `/health` and
`/generate` handlers (:455, :499) with the reference's bodies:
  GET  /health    -> 200 {"status": "ok", "engine": {...}} once loaded
  POST /generate  -> {"prompt_tokens": [...], "max_new_tokens": N,
                      "temperature": t, "top_k": k, "top_p": p,
                      "eos_token_id": e, "logprobs": bool}
                     => {"tokens": [...]} (+ "logprobs")
                     with "stream": true => SSE: `data: {"token": t}`
                     per token, then `data: {"done": true, "tokens": [...]}`.

One engine-loop thread owns the engine (and the card); HTTP handler
threads (`ThreadingHTTPServer`) enqueue requests and wait on their
watcher's queue, so concurrent requests join the running decode batch.
The OpenAI routes, load shedding, drain/migration endpoints and the
telemetry plane wait for later slices.

  python -m skypilot_tpu_torch.inference.server --model llama3-8b \
      --port 8080 [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional


class EngineLoop:
    """Single thread owning the engine: requests arrive through a
    queue; per-token progress and results go to per-request watchers."""

    class Watcher:
        def __init__(self, stream: bool) -> None:
            self.stream = stream
            self.q: 'queue.Queue' = queue.Queue()
            self.sent = 0
            self.aborted = False
            self.logprobs: Optional[List[float]] = None

        def push(self, item) -> None:
            self.q.put(item)

    def __init__(self, engine) -> None:
        self.engine = engine
        self._submit_q: 'queue.Queue' = queue.Queue()
        self._abort_q: 'queue.Queue' = queue.Queue()
        self._watchers: Dict[int, EngineLoop.Watcher] = {}
        self._stop = threading.Event()
        self.gauges: Dict[str, Any] = {}
        self._refresh_gauges()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='engine-loop')
        self._thread.start()

    def submit(self, prompt: List[int], sampling,
               stream: bool = False) -> 'EngineLoop.Watcher':
        """Returns the watcher whose queue yields ('token', t)* then
        ('done', tokens) or ('error', message)."""
        watcher = self.Watcher(stream)
        self._submit_q.put((prompt, sampling, watcher))
        return watcher

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

    def _refresh_gauges(self) -> None:
        e = self.engine
        in_flight = sum(1 for s in e.state.slots if s is not None)
        self.gauges = {
            'queue_depth': e.queue_depth(),
            'in_flight': in_flight,
            'batch_occupancy': in_flight / max(1, len(e.state.slots)),
            'kv_pages': {'total': e.pages_total(), 'free': e.pages_free()},
        }

    def _process_submission(self, item) -> None:
        prompt, sampling, watcher = item
        if watcher.aborted:
            return
        try:
            rid = self.engine.submit(prompt, sampling)
        except ValueError as e:
            watcher.push(('error', str(e)))
            return
        self._watchers[rid] = watcher

    def _drain_submissions(self) -> None:
        while True:
            try:
                item = self._submit_q.get_nowait()
            except queue.Empty:
                return
            self._process_submission(item)

    def _drain_aborts(self) -> None:
        while True:
            try:
                target = self._abort_q.get_nowait()
            except queue.Empty:
                return
            for rid, watcher in list(self._watchers.items()):
                if watcher is target:
                    self._watchers.pop(rid)
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
                self.engine.abort_all()
            self._refresh_gauges()

    def _tick(self) -> None:
        self._drain_submissions()
        self._drain_aborts()
        if not self.engine.has_work:
            try:
                item = self._submit_q.get(timeout=0.2)
            except queue.Empty:
                return
            self._process_submission(item)
            return
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
                watcher.logprobs = finished_lps.get(rid)
                watcher.push(('done', tokens))


def _parse_sampling(body: Dict[str, Any]):
    from skypilot_tpu_torch.inference.engine import SamplingParams
    eos = body.get('eos_token_id')
    return SamplingParams(
        temperature=float(body.get('temperature', 0.0)),
        top_k=int(body.get('top_k', 0)),
        top_p=float(body.get('top_p', 1.0)),
        max_new_tokens=int(body.get('max_new_tokens', 64)),
        eos_token_id=None if eos is None else int(eos))


def make_handler(holder: Dict[str, Any]):
    """The request handler class, bound to `holder` ({'loop':
    EngineLoop or None while loading})."""

    class Handler(BaseHTTPRequestHandler):
        server_version = 'skypilot-tpu-torch'

        def log_message(self, format, *args):  # noqa: A002
            pass  # keep the serving log to errors

        def _json(self, doc: Dict[str, Any], status: int = 200) -> None:
            body = json.dumps(doc).encode()
            self.send_response(status)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path != '/health':
                self._json({'error': 'not found'}, 404)
                return
            loop: Optional[EngineLoop] = holder.get('loop')
            if loop is None:
                self._json({'status': 'loading'}, 503)
                return
            self._json({'status': 'ok', 'engine': dict(loop.gauges)})

        def do_POST(self):  # noqa: N802
            if self.path != '/generate':
                self._json({'error': 'not found'}, 404)
                return
            loop: Optional[EngineLoop] = holder.get('loop')
            if loop is None:
                self._json({'error': 'model loading'}, 503)
                return
            try:
                n = int(self.headers.get('Content-Length', 0))
                body = json.loads(self.rfile.read(n) or b'{}')
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
            watcher = loop.submit(prompt, sampling, stream=stream)
            try:
                if stream:
                    self._stream(watcher)
                else:
                    self._wait(watcher, bool(body.get('logprobs', False)))
            except (BrokenPipeError, ConnectionResetError):
                loop.abort(watcher)

        def _wait(self, watcher, want_logprobs: bool) -> None:
            while True:
                kind, payload = watcher.q.get()
                if kind == 'done':
                    doc = {'tokens': payload}
                    if want_logprobs:
                        doc['logprobs'] = watcher.logprobs
                    self._json(doc)
                    return
                if kind == 'error':
                    self._json({'error': payload}, 500)
                    return

        def _stream(self, watcher) -> None:
            self.send_response(200)
            self.send_header('Content-Type', 'text/event-stream')
            self.send_header('Cache-Control', 'no-cache')
            self.end_headers()
            while True:
                kind, payload = watcher.q.get()
                if kind == 'token':
                    frame = {'token': payload}
                elif kind == 'error':
                    frame = {'error': payload}
                else:
                    frame = {'done': True, 'tokens': payload}
                self.wfile.write(f'data: {json.dumps(frame)}\n\n'.encode())
                self.wfile.flush()
                if kind != 'token':
                    return

    return Handler


def create_server(holder: Dict[str, Any], host: str = '0.0.0.0',
                  port: int = 8080) -> ThreadingHTTPServer:
    """An HTTP server bound to (host, port); run it with
    serve_forever() and stop it with shutdown() + server_close()."""
    server = ThreadingHTTPServer((host, port), make_handler(holder))
    server.daemon_threads = True
    return server


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
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--max-seq-len', type=int, default=None)
    parser.add_argument('--prefill-chunk', type=int, default=1024)
    parser.add_argument('--prefill-interleave', type=int, default=None)
    parser.add_argument('--kv-quant', default='auto',
                        choices=['auto', 'none', 'int8'])
    parser.add_argument('--decode-fuse-steps', type=int, default=None)
    parser.add_argument('--kv-page-size', type=int, default=None)
    parser.add_argument('--kv-pages', type=int, default=None)
    args = parser.parse_args()

    holder: Dict[str, Any] = {'loop': None}
    server = create_server(holder, port=args.port)
    load_errors: List[BaseException] = []

    def _load():
        # /health answers 503 'loading' meanwhile; a failed load stops
        # the server instead of leaving it loading forever.
        from skypilot_tpu_torch import inference
        try:
            engine = inference.build_engine(
                args.model, device=args.device, seed=args.seed,
                batch_size=args.batch_size, max_seq_len=args.max_seq_len,
                prefill_chunk=args.prefill_chunk, kv_quant=args.kv_quant,
                prefill_interleave=args.prefill_interleave,
                decode_fuse_steps=args.decode_fuse_steps,
                kv_page_size=args.kv_page_size, kv_pages=args.kv_pages)
        except Exception as e:  # noqa: BLE001 — reported by main()
            load_errors.append(e)
            server.shutdown()
            return
        holder['loop'] = EngineLoop(engine)

    threading.Thread(target=_load, daemon=True).start()
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
