"""OpenAI-compatible API for the port's inference server.

Ports `skypilot_tpu/inference/openai_api.py` onto the port's stdlib
server (`inference/server.py`), with the reference's bodies and status
codes:

  GET  /v1/models           -> the one served model
  POST /v1/completions      -> text or token-id prompts, optional SSE
  POST /v1/chat/completions -> messages through the tokenizer's chat
                               template, optional SSE

Ported: `load_tokenizer` (:49), `_MAX_N`, `_normalize_prompts` (:65),
`_parse_common` (:95), `_finish_reason` (:185), `_logprobs_doc` (:190),
`_decode` (:240), `_stable_len` (:247), `_apply_stops` (:258),
`_collect` (:266) and the routes of `add_openai_routes` (:275):
`models`, `_ready`, `_serve`, `_respond`, `_stream` (:456), `_err400`
and `_chat_prompt` (:592).

Text in and out needs a tokenizer (`--tokenizer`, loaded through
`transformers` inside `load_tokenizer` only). Without one the server
stays tokenizer-free: /v1/completions takes token-id prompts and answers
a `tokens` field with `"text": null`; string prompts, chat and `stop`
strings answer 400. Sampling maps temperature, top_k and top_p onto
`SamplingParams`; sampled-token logprobs (completions `logprobs: 0`,
chat `logprobs: true`; non-streaming); n > 1 fans a prompt into n engine
requests (index = prompt_i*n + j); `echo` prepends the prompt
(non-streaming); `stop` strings truncate the text, and in a stream a hit
aborts the request so its slot frees at once. Top-N logprobs, best_of,
tools and constrained response formats answer 400.

How the reference's aiohttp code maps onto the stdlib server:
- its coroutines are blocking functions of the request's handler
  thread; `_collect` waits on the `EngineLoop` watchers' events, which
  every watcher of a request delivers into one queue (`sink`), tagged
  with its choice index;
- a client that goes away shows as BrokenPipeError or
  ConnectionResetError on a write: every live watcher of the request is
  aborted and the error re-raised (the middleware counts a 499);
- when one choice fails, the whole request answers 500 and the
  sibling choices' watchers are aborted (:384-396);
- each request runs under `tracing.request_scope(rid)`, rid being the
  response's `cmpl-...` or `chatcmpl-...` id;
- the reference's `timeline.Event('openai.generate')` span has no
  counterpart: the port has no `utils/timeline.py`.

Two fixes against the reference (ROADMAP.md, Queue 3): `_ready` refuses
a request while the replica drains (503 `replica draining` with
Retry-After, as /generate does), and a request a drain migrates away
ends with an error instead of waiting forever for a 'done' that never
comes.
"""
from __future__ import annotations

import json
import logging
import queue
import re
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from skypilot_tpu_torch.observability import tracing

logger = logging.getLogger(__name__)


def load_tokenizer(name_or_path: str):
    """An HF tokenizer through `transformers`, imported here only: the
    port does not need it otherwise, and the card has none."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            '--tokenizer needs the `transformers` package, which is not '
            'installed; without a tokenizer the server takes token-id '
            'prompts on /v1/completions') from e
    return AutoTokenizer.from_pretrained(name_or_path)


# n>1 fans one prompt into n engine requests (continuous batching packs
# them); capped so one call cannot monopolize the decode batch.
_MAX_N = 8


class _BadRequest(Exception):
    pass


class _Unavailable(Exception):
    """503 with the reference's body (and Retry-After when set)."""

    def __init__(self, message: str, retry_after: bool = False) -> None:
        super().__init__(message)
        self.retry_after = retry_after


def _normalize_prompts(prompt: Any, tokenizer) -> List[List[int]]:
    """OpenAI `prompt` -> list of token lists. The spec allows a string,
    a list of strings, a token array, or a list of token arrays."""
    if isinstance(prompt, str):
        if tokenizer is None:
            raise _BadRequest(
                'string prompts need a server-side tokenizer; start '
                'the server with --tokenizer, or send token ids')
        return [tokenizer.encode(prompt)]
    if isinstance(prompt, list) and prompt:
        if all(isinstance(p, str) for p in prompt):
            if tokenizer is None:
                raise _BadRequest(
                    'string prompts need a server-side tokenizer; '
                    'start the server with --tokenizer, or send '
                    'token ids')
            return [tokenizer.encode(p) for p in prompt]
        if all(isinstance(p, int) and not isinstance(p, bool)
               for p in prompt):
            return [list(prompt)]
        if all(isinstance(p, list) and p
               and all(isinstance(t, int) and not isinstance(t, bool)
                       for t in p) for p in prompt):
            return [list(p) for p in prompt]
    raise _BadRequest(
        'prompt must be a string, a list of strings, a token array, '
        'or a list of non-empty token arrays')


def _parse_common(body: Dict[str, Any], tokenizer, chat: bool):
    """Shared request validation -> (SamplingParams, stop strings,
    want_logprobs, n, echo)."""
    from skypilot_tpu_torch.inference.engine import SamplingParams
    # Sampled-token logprobs are supported (completions `logprobs: 0`,
    # chat `logprobs: true` with top_logprobs absent/0); top-N
    # alternatives are not, so those 400.
    lp_ok = ((lambda v: v in (None, False, True)) if chat
             else (lambda v: v is None or v == 0))
    for field, ok in (('n', lambda v: v is None
                       or (isinstance(v, int)
                           and not isinstance(v, bool)
                           and 1 <= v <= _MAX_N)),
                      ('best_of', lambda v: v in (None, 1)),
                      ('logprobs', lp_ok),
                      ('top_logprobs', lambda v: v in (None, 0)),
                      ('echo', lambda v: v in (None, False)
                       or (not chat and v is True)),
                      # json_object/json_schema would need constrained
                      # decoding: a 400 beats free text to a client
                      # that asked for JSON.
                      ('response_format',
                       lambda v: v is None or (isinstance(v, dict)
                                               and v.get('type')
                                               in (None, 'text'))),
                      ('tools', lambda v: not v),
                      ('tool_choice', lambda v: v in (None, 'none'))):
        if not ok(body.get(field)):
            raise _BadRequest(
                f'{field}={body.get(field)!r} is not supported; '
                'sampling is temperature/top_k/top_p, and batching is '
                'via prompt lists (continuous batching packs them)')
    stop = body.get('stop')
    if stop is None:
        stops: List[str] = []
    elif isinstance(stop, str):
        stops = [stop]
    elif (isinstance(stop, list)
          and all(isinstance(s, str) and s for s in stop)):
        stops = list(stop)
    else:
        raise _BadRequest('stop must be a string or list of strings')
    if stops and tokenizer is None:
        raise _BadRequest('stop strings need a server-side tokenizer '
                          '(--tokenizer)')
    eos = body.get('eos_token_id')
    if eos is None and tokenizer is not None:
        eos = tokenizer.eos_token_id
    try:
        # Explicit null is valid per the OpenAI spec (= default); only a
        # present non-null value is parsed, and 0 still rejects.
        raw_top_p = body.get('top_p')
        top_p = 1.0 if raw_top_p is None else float(raw_top_p)
        if not 0.0 < top_p <= 1.0:
            raise _BadRequest(f'top_p must be in (0, 1], got {top_p}')
        sampling = SamplingParams(
            temperature=float(body.get('temperature', 1.0)),
            top_k=int(body.get('top_k', 0)),
            top_p=top_p,
            max_new_tokens=int(body.get('max_tokens', 16)),
            eos_token_id=eos)
    except (TypeError, ValueError) as e:
        raise _BadRequest(f'bad sampling field: {e}') from e
    raw_lp = body.get('logprobs')
    want_logprobs = (raw_lp is True) if chat else (raw_lp == 0 and
                                                  raw_lp is not False
                                                  and raw_lp is not None)
    if want_logprobs and body.get('stream'):
        raise _BadRequest('logprobs are supported on non-streaming '
                          'requests only')
    n = body.get('n') or 1
    if body.get('best_of') is not None and body['best_of'] < n:
        raise _BadRequest(f'best_of={body["best_of"]} must be >= '
                          f'n={n}')
    echo = bool(body.get('echo', False))
    if echo and want_logprobs:
        # Prompt-token logprobs (what echo+logprobs means in the spec)
        # would need a scoring pass the engine does not run.
        raise _BadRequest('echo with logprobs is not supported')
    if echo and tokenizer is None and isinstance(body.get('prompt'),
                                                 str):
        raise _BadRequest('echo needs a tokenizer for string prompts')
    if echo and body.get('stream'):
        raise _BadRequest('echo is supported on non-streaming '
                          'requests only')
    return sampling, stops, want_logprobs, n, echo


def _finish_reason(tokens: List[int], sampling) -> str:
    return ('length' if len(tokens) >= sampling.max_new_tokens
            else 'stop')


def _logprobs_doc(tokens: List[int], logprobs: Optional[List[float]],
                  tokenizer, chat: bool,
                  text_len: Optional[int]) -> Dict[str, Any]:
    """Sampled-token logprobs in each endpoint's schema. Token strings
    need a tokenizer; without one, token ids stand in.

    `text_len`: length of the returned completion text (after stop
    truncation and special stripping): entries cover exactly the
    emitted text, so tokens whose text starts at or after that boundary
    are dropped. None = token-id mode, keep everything.

    A chat entry's `bytes` is the token's own UTF-8 bytes
    (`_token_bytes`), so the kept entries' bytes join to the content's
    even where a multi-byte character is split across tokens (the
    reference gives the bytes of the vocabulary glyph, `Ġhello`; ROADMAP
    Queue 3). The token that completes a split character adds no
    character to the decoded text, so it is kept for its bytes, where
    the reference stops there."""
    lps = list(logprobs or [])
    if tokenizer is None:
        return {'tokens': list(tokens), 'token_logprobs': lps,
                'top_logprobs': None, 'text_offset': None}
    # One incremental pass: token j's text spans
    # [prefix_lens[j], prefix_lens[j+1]) of the decoded completion.
    prefix_lens = [len(_decode(tokenizer, tokens[:j]))
                   for j in range(len(tokens) + 1)]
    tok_bytes = _token_bytes(tokenizer, tokens)
    keep = len(tokens)
    if text_len is not None:
        # The longest prefix of tokens whose non-empty spans fit in the
        # returned text (a prefix, so the arrays never misalign).
        keep = 0
        for j in range(len(tokens)):
            grows = prefix_lens[j] < prefix_lens[j + 1] or tok_bytes[j]
            if grows and prefix_lens[j + 1] <= text_len:
                keep = j + 1
            else:
                break
    tok_strs = tokenizer.convert_ids_to_tokens(tokens[:keep])
    lps = lps[:keep]
    if chat:
        return {'content': [
            # top_logprobs/bytes are schema-required on every entry.
            {'token': t, 'logprob': lp, 'top_logprobs': [],
             'bytes': list(b)}
            for t, lp, b in zip(tok_strs, lps, tok_bytes)]}
    return {'tokens': tok_strs, 'token_logprobs': lps,
            'top_logprobs': None,
            'text_offset': prefix_lens[:keep]}


def _byte_decoder() -> Dict[str, int]:
    """GPT-2's byte-level alphabet reversed: glyph char -> byte. Bytes
    that print as themselves keep their code point; the rest map to 256
    upwards in byte order."""
    printable = (list(range(ord('!'), ord('~') + 1))
                 + list(range(ord('\xa1'), ord('\xac') + 1))
                 + list(range(ord('\xae'), ord('\xff') + 1)))
    chars, extra = {}, 0
    for b in range(256):
        if b in printable:
            chars[chr(b)] = b
        else:
            chars[chr(256 + extra)] = b
            extra += 1
    return chars


_BYTE_DECODER = _byte_decoder()
_BYTE_TOKEN = re.compile(r'<0x([0-9A-Fa-f]{2})>')


def _is_byte_level(tokenizer) -> bool:
    """Does `tokenizer` spell tokens in the byte-level alphabet (GPT-2,
    Llama 3, Qwen)? A fast tokenizer says so by its decoder, a slow one
    by its `byte_decoder`."""
    backend = getattr(tokenizer, 'backend_tokenizer', None)
    if backend is not None and backend.decoder is not None:
        return type(backend.decoder).__name__ == 'ByteLevel'
    return hasattr(tokenizer, 'byte_decoder')


def _token_bytes(tokenizer, tokens: List[int]) -> List[bytes]:
    """Each token's own UTF-8 bytes. Byte-level glyphs map back through
    the byte decoder; otherwise a sentencepiece `▁` is a space and a
    `<0xNN>` piece that byte. A special token decodes to nothing (the
    text skips it), so its bytes are empty."""
    special = set(getattr(tokenizer, 'all_special_ids', ()))
    glyphs = tokenizer.convert_ids_to_tokens(tokens)
    byte_level = _is_byte_level(tokenizer)
    out = []
    for tid, glyph in zip(tokens, glyphs):
        glyph = str(glyph)
        if tid in special:
            out.append(b'')
        elif byte_level and all(ch in _BYTE_DECODER for ch in glyph):
            out.append(bytes(_BYTE_DECODER[ch] for ch in glyph))
        else:
            byte = _BYTE_TOKEN.fullmatch(glyph)
            out.append(bytes([int(byte.group(1), 16)]) if byte
                       else glyph.replace('\u2581', ' ').encode('utf-8'))
    return out


def _decode(tokenizer, tokens: List[int]) -> str:
    """skip_special_tokens: the engine finishes with the eos id among
    the generated tokens, and OpenAI text must not carry it."""
    return tokenizer.decode(tokens, skip_special_tokens=True)


def _stable_len(text: str) -> int:
    """Length of the emission-safe prefix: a byte-level BPE decode of a
    token prefix can end in U+FFFD while a multi-byte char is split
    across tokens; that tail is never emitted."""
    n = len(text)
    while n > 0 and text[n - 1] == '\ufffd':
        n -= 1
    return n


def _apply_stops(text: str, stops: List[str]) -> Tuple[str, bool]:
    cut = min((text.find(s) for s in stops if s in text),
              default=-1)
    if cut >= 0:
        return text[:cut], True
    return text, False


# A watcher's 'migrate' event comes when a drain snapshots the request
# away: the OpenAI API has no way to continue it elsewhere, so it ends
# the choice as an error.
_MIGRATED = 'replica draining: the request was migrated away'


def _submit_all(engine_loop, prompts: List[List[int]], sampling,
                stream: bool) -> Tuple[List[Any], 'queue.Queue']:
    """One engine request per prompt; every watcher delivers its events
    into one queue as (choice index, kind, payload)."""
    merged: 'queue.Queue' = queue.Queue()
    watchers = [engine_loop.submit(
        p, sampling, stream=stream,
        sink=lambda item, i=i: merged.put((i,) + tuple(item)))
        for i, p in enumerate(prompts)]
    return watchers, merged


def _collect(merged: 'queue.Queue', n: int) -> List[List[int]]:
    """Every choice's tokens, in choice order; RuntimeError on the first
    choice that fails."""
    outs: List[Optional[List[int]]] = [None] * n
    pending = n
    while pending:
        i, kind, payload = merged.get()
        if kind == 'done':
            outs[i] = payload
            pending -= 1
        elif kind == 'error':
            raise RuntimeError(payload)
        elif kind == 'migrate':
            raise RuntimeError(_MIGRATED)
    return outs


def _ready(holder: Dict[str, Any]):
    """The engine loop, or _Unavailable: loading, draining (the fix
    against the reference's _ready, :290-306) or over the shedding
    limit."""
    loop = holder.get('loop')
    if loop is None:
        raise _Unavailable('model loading')
    if holder.get('draining'):
        # No new admissions once a drain started: this replica is about
        # to vanish, as /generate answers.
        raise _Unavailable('replica draining', retry_after=True)
    # server imports this module at its top: importing server there
    # too would be cyclic.
    from skypilot_tpu_torch.inference import server as server_lib
    limit = server_lib.shed_limit(holder)
    if limit is not None:
        raise _Unavailable(f'overloaded: queue depth >= {limit}',
                           retry_after=True)
    return loop


def _model_name(holder: Dict[str, Any]) -> str:
    return holder.get('model_name') or 'model'


def models(handler, holder: Dict[str, Any]) -> None:
    handler._json({
        'object': 'list',
        'data': [{'id': _model_name(holder), 'object': 'model',
                  'owned_by': 'skypilot-tpu'}]})


def completions(handler, holder: Dict[str, Any]) -> None:
    _serve(handler, holder, chat=False)


def chat_completions(handler, holder: Dict[str, Any]) -> None:
    _serve(handler, holder, chat=True)


def _err400(handler, msg: str) -> None:
    handler._json(
        {'error': {'message': msg, 'type': 'invalid_request_error'}}, 400)


def _chat_prompt(body: Dict[str, Any], tokenizer) -> List[int]:
    if tokenizer is None:
        raise _BadRequest(
            'chat completions need a server-side tokenizer '
            '(--tokenizer) with a chat template')
    messages = body.get('messages')
    if (not isinstance(messages, list) or not messages
            or not all(isinstance(m, dict) and 'role' in m
                       and 'content' in m for m in messages)):
        raise _BadRequest(
            'messages must be a non-empty list of '
            '{"role", "content"} objects')
    try:
        ids = tokenizer.apply_chat_template(
            messages, add_generation_prompt=True, tokenize=True)
    except Exception as e:  # noqa: BLE001 — template errors are 400s
        raise _BadRequest(f'chat template failed: {e}') from e
    if not ids:
        raise _BadRequest('chat template produced an empty prompt')
    return list(ids)


def _serve(handler, holder: Dict[str, Any], chat: bool) -> None:
    try:
        engine_loop = _ready(holder)
    except _Unavailable as e:
        handler._json({'error': str(e)}, 503,
                      {'Retry-After': '1'} if e.retry_after else None)
        return
    tokenizer = holder.get('tokenizer')
    try:
        body = json.loads(handler._body())
    except json.JSONDecodeError:
        _err400(handler, 'body must be JSON')
        return
    try:
        sampling, stops, want_logprobs, n, echo = _parse_common(
            body, tokenizer, chat)
        if chat:
            prompts = [_chat_prompt(body, tokenizer)]
        else:
            prompts = _normalize_prompts(body.get('prompt'), tokenizer)
    except _BadRequest as e:
        _err400(handler, str(e))
        return
    rid = (f'chatcmpl-{uuid.uuid4().hex}' if chat
           else f'cmpl-{uuid.uuid4().hex}')
    # The response id doubles as the request id of the logs and spans.
    with tracing.request_scope(rid):
        _respond(handler, holder, chat, engine_loop, tokenizer, body,
                 sampling, stops, want_logprobs, n, echo, rid, prompts)


def _respond(handler, holder, chat, engine_loop, tokenizer, body,
             sampling, stops, want_logprobs, n, echo, rid,
             prompts) -> None:
    stream = bool(body.get('stream', False))
    created = int(time.time())
    logger.info('%s: %d prompt(s), n=%d, stream=%s',
                'chat.completions' if chat else 'completions',
                len(prompts), n, stream)
    # n>1: one engine request per choice (index = prompt_i*n + j). Each
    # choice pays its own prefill; the prompt is billed once.
    n_prompt = sum(len(p) for p in prompts)
    # Echo returns the client's exact prompt text when it sent strings
    # (decode(encode(s)) is lossy for normalizing tokenizers).
    raw_prompt = body.get('prompt')
    if echo and isinstance(raw_prompt, str):
        echo_texts: List[Optional[str]] = [raw_prompt]
    elif (echo and isinstance(raw_prompt, list) and raw_prompt
          and all(isinstance(p, str) for p in raw_prompt)):
        echo_texts = list(raw_prompt)
    else:
        echo_texts = [None] * len(prompts)
    echo_texts = [t for t in echo_texts for _ in range(n)]
    prompts = [p for p in prompts for _ in range(n)]
    watchers, merged = _submit_all(engine_loop, prompts, sampling, stream)
    if stream:
        _stream(handler, holder, engine_loop, watchers, merged, sampling,
                stops, tokenizer, rid, created, chat)
        return
    try:
        outs = _collect(merged, len(watchers))
    except RuntimeError as e:
        # One choice failed: the 500 covers the whole request, so free
        # the sibling slots too.
        for w in watchers:
            engine_loop.abort(w)
        handler._json({'error': str(e)}, 500)
        return
    choices = []
    for i, tokens in enumerate(outs):
        finish = _finish_reason(tokens, sampling)
        text = None
        if tokenizer is not None:
            text, stopped = _apply_stops(_decode(tokenizer, tokens), stops)
            if stopped:
                finish = 'stop'
            if echo:
                prefix = (echo_texts[i] if echo_texts[i] is not None
                          else _decode(tokenizer, prompts[i]))
                text = prefix + text
        lp_doc = None
        if want_logprobs:
            lp_doc = _logprobs_doc(tokens, watchers[i].logprobs, tokenizer,
                                   chat,
                                   len(text) if text is not None else None)
        if chat:
            choice = {'index': i, 'finish_reason': finish,
                      'message': {'role': 'assistant', 'content': text}}
        else:
            choice = {'index': i, 'text': text, 'finish_reason': finish}
            if tokenizer is None:
                choice['tokens'] = (list(prompts[i]) + tokens if echo
                                    else tokens)
        if want_logprobs:
            choice['logprobs'] = lp_doc
        choices.append(choice)
    n_out = sum(len(t) for t in outs)
    handler._json({
        'id': rid,
        'object': 'chat.completion' if chat else 'text_completion',
        'created': created, 'model': _model_name(holder),
        'choices': choices,
        'usage': {'prompt_tokens': n_prompt,
                  'completion_tokens': n_out,
                  'total_tokens': n_prompt + n_out}})


def _stream(handler, holder, engine_loop, watchers, merged, sampling,
            stops, tokenizer, rid, created, chat) -> None:
    handler.send_response(200)
    handler.send_header('Content-Type', 'text/event-stream')
    handler.send_header('Cache-Control', 'no-cache')
    handler.end_headers()

    def write(payload: bytes) -> None:
        handler.wfile.write(payload)
        handler.wfile.flush()

    def chunk(i: int, delta_text: Optional[str], finish: Optional[str],
              first: bool, tokens: Optional[List[int]] = None) -> bytes:
        if chat:
            delta: Dict[str, Any] = {}
            if first:
                delta['role'] = 'assistant'
            if delta_text:
                delta['content'] = delta_text
            choice: Dict[str, Any] = {'index': i, 'delta': delta,
                                      'finish_reason': finish}
        else:
            choice = {'index': i, 'text': delta_text or '',
                      'finish_reason': finish}
            if tokens is not None:
                choice['tokens'] = tokens
        doc = {'id': rid,
               'object': ('chat.completion.chunk' if chat
                          else 'text_completion'),
               'created': created, 'model': _model_name(holder),
               'choices': [choice]}
        return f'data: {json.dumps(doc)}\n\n'.encode()

    # Hold back a stop-string prefix: a stop split across deltas must
    # never be half-emitted.
    holdback = max((len(s) for s in stops), default=1) - 1
    state = [{'tokens': [], 'emitted': 0, 'first': True, 'live': True,
              'counted': False} for _ in watchers]
    pending = len(watchers)

    def finish_one(st) -> None:
        nonlocal pending
        # Exactly once: a stop-aborted request may still race a 'done'
        # from the same engine tick.
        if not st['counted']:
            st['counted'] = True
            pending -= 1

    try:
        while pending:
            i, kind, payload = merged.get()
            st = state[i]
            if kind in ('error', 'migrate'):
                message = payload if kind == 'error' else _MIGRATED
                write(f'data: {json.dumps({"error": message})}\n\n'
                      .encode())
                st['live'] = False
                finish_one(st)
                continue
            if not st['live']:
                if kind == 'done':
                    finish_one(st)
                continue
            if kind == 'token':
                st['tokens'].append(payload)
                if tokenizer is None:
                    write(chunk(i, None, None, st['first'],
                                tokens=[payload]))
                    st['first'] = False
                    continue
                text = _decode(tokenizer, st['tokens'])
                cut_text, stopped = _apply_stops(text, stops)
                if stopped:
                    write(chunk(i, cut_text[st['emitted']:], 'stop',
                                st['first']))
                    st['live'] = False
                    st['first'] = False
                    # The useful output ended here: free the slot
                    # instead of decoding to max_tokens.
                    engine_loop.abort(watchers[i])
                    finish_one(st)
                    continue
                safe = _stable_len(text) - (holdback if stops else 0)
                if safe > st['emitted']:
                    write(chunk(i, text[st['emitted']:safe], None,
                                st['first']))
                    st['emitted'] = safe
                    st['first'] = False
            elif kind == 'done':
                finish_one(st)
                tokens = payload
                finish = _finish_reason(tokens, sampling)
                if tokenizer is None:
                    write(chunk(i, None, finish, st['first'],
                                tokens=tokens[len(st['tokens']):]))
                    continue
                text = _decode(tokenizer, tokens)
                cut_text, stopped = _apply_stops(text, stops)
                if stopped:
                    finish = 'stop'
                write(chunk(i, cut_text[st['emitted']:], finish,
                            st['first']))
                st['first'] = False
        write(b'data: [DONE]\n\n')
    except (BrokenPipeError, ConnectionResetError):
        # Client gone mid-stream: free every slot still decoding.
        for i, st in enumerate(state):
            if st['live']:
                engine_loop.abort(watchers[i])
        raise


# The routes, as add_openai_routes mounts them (:612-614).
ROUTES = {
    ('GET', '/v1/models'): models,
    ('POST', '/v1/completions'): completions,
    ('POST', '/v1/chat/completions'): chat_completions,
}
