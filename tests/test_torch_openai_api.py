"""Port parity: the OpenAI-compatible /v1 routes and load shedding.

One request script goes through two servers on the same tiny weights
(reference `init_params`, key 7, f32): the JAX app (`server.create_app`
through aiohttp's TestClient, as tests/unit/test_openai_api.py drives
it) and the port's stdlib server (`create_server` in a thread, port 0).
Both hold the reference test's toy tokenizer (a WordLevel vocabulary of
256 words over tiny's vocab) or none. Each response must equal the
other's, status and body, except `id` and `created`; logprobs within
1e-4 (f32 on both sides, only the summation order differs); SSE streams
frame for frame. Greedy requests only: sampled tokens differ between
the packages' generators.

Covered: token-id and text prompts, prompt lists, chat; n with echo,
stop strings; logprobs; streams (completions, chat, token mode, a stop
string held back); every 400 body; 503 while loading; the shed 503 with
Retry-After and its REQUESTS_SHED delta; the served model name. Then
what only the port does: the drain fix (ROADMAP.md, Queue 3: a /v1
request during a drain gets 503 `replica draining`, where the reference
admits it), a migrated-away request ending instead of hanging, and a
client that leaves mid-stream freeing its slot. (The server's
`--served-model-name`, `--tokenizer` and `--max-queue-depth` run as a
process in tests/test_torch_server.py.)
"""
import asyncio
import dataclasses
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu import inference as ref_inference
from skypilot_tpu.inference import server as ref_server
from skypilot_tpu.models import llama as ref_llama
from skypilot_tpu.observability import instruments as ref_obs
from skypilot_tpu_torch import inference
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.inference import server as server_lib
from skypilot_tpu_torch.observability import instruments as port_obs

TOL_LOGPROB = 1e-4
ENGINE_KW = dict(batch_size=2, max_seq_len=64, prefill_chunk=16,
                 kv_page_size=8, kv_quant='none', decode_fuse_steps=2)


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _toy_tokenizer(path):
    """The reference test's toy tokenizer, saved to `path` and loaded."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import AutoTokenizer, PreTrainedTokenizerFast
    words = ['[UNK]', '</s>', 'hello', 'world', 'foo', 'bar', 'stop',
             'go']
    words += [f'w{i}' for i in range(len(words), 256)]
    vocab = {w: i for i, w in enumerate(words)}
    tok = Tokenizer(WordLevel(vocab, unk_token='[UNK]'))
    tok.pre_tokenizer = Whitespace()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok,
                                   unk_token='[UNK]', eos_token='</s>')
    fast.chat_template = (
        "{% for m in messages %}{{ m['content'] }} {% endfor %}")
    fast.save_pretrained(str(path))
    return AutoTokenizer.from_pretrained(str(path))


class _JaxServer:
    """The JAX app on an event loop of its own, one request at a time."""

    def __init__(self, params, config):
        from aiohttp.test_utils import TestClient, TestServer
        engine = ref_inference.InferenceEngine(params, config, **ENGINE_KW)
        self.holder = {'loop': ref_server.EngineLoop(engine),
                       'tokenizer': None, 'model_name': 'tiny'}
        self.aio = asyncio.new_event_loop()

        async def start():
            client = TestClient(TestServer(
                ref_server.create_app(self.holder)))
            await client.start_server()
            return client
        self.client = self.aio.run_until_complete(start())

    def request(self, method, path, body=None):
        async def go():
            r = await self.client.request(method, path, json=body)
            return r.status, dict(r.headers), await r.text()
        return self.aio.run_until_complete(go())

    def close(self):
        self.aio.run_until_complete(self.client.close())
        self.holder['loop'].stop()
        self.aio.close()


class _PortServer:
    def __init__(self, params, config):
        engine = inference.InferenceEngine(params, config, device='cpu',
                                           **ENGINE_KW)
        self.holder = {'loop': server_lib.EngineLoop(engine),
                       'tokenizer': None, 'model_name': 'tiny'}
        self.srv = server_lib.create_server(self.holder, host='127.0.0.1',
                                            port=0)
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = f'http://127.0.0.1:{self.srv.server_address[1]}'

    def request(self, method, path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            self.base + path, data=data, method=method,
            headers={'Content-Type': 'application/json'})
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status, dict(resp.headers), resp.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read().decode()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.holder['loop'].stop()


@pytest.fixture(scope='module')
def servers(tmp_path_factory):
    config = ref_llama.CONFIGS['tiny']
    params = jax.tree.map(np.asarray, ref_llama.init_params(
        config, jax.random.key(7)))
    port_config = weights.config_from_dict(dataclasses.asdict(config))
    tok = _toy_tokenizer(tmp_path_factory.mktemp('toytok'))
    ref = _JaxServer(params, config)
    port = _PortServer(weights.from_jax_params(params, port_config),
                       port_config)
    yield {'ref': ref, 'port': port, 'tok': tok}
    ref.close()
    port.close()


def _set(servers, **fields):
    for name in ('ref', 'port'):
        servers[name].holder.update(fields)


def _strip(doc):
    """A body without the fields that differ by construction (the
    response's id and creation time)."""
    return {k: v for k, v in doc.items() if k not in ('id', 'created')}


def _split_logprobs(doc):
    """(body with every logprob value taken out, the values in order).
    A chat entry's `bytes` is taken out too (marked 'bytes'): the port
    gives the token's own UTF-8 bytes, the reference the glyph's (ROADMAP
    Queue 3), so test_chat_matches checks them on their own."""
    values = []

    def walk(x, key=None):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if isinstance(x, list):
            if key == 'token_logprobs':
                values.extend(x)
                return len(x)
            if key == 'bytes':
                return 'bytes'
            return [walk(v) for v in x]
        if key == 'logprob':
            values.append(x)
            return 'lp'
        return x
    return walk(doc), values


def _sse(text):
    return [block[len('data: '):] for block in text.split('\n\n')
            if block.startswith('data: ')]


def _both(servers, method, path, body=None, stream=False):
    """The two answers, held equal; returns the port's (status, headers,
    parsed body or SSE frames)."""
    out = {}
    for name in ('ref', 'port'):
        status, headers, text = servers[name].request(method, path, body)
        if stream:
            # Choices interleave as the engines' ticks and the threads
            # fall: compare each choice's frames in order.
            frames = _sse(text)
            doc = sorted((_strip(json.loads(f)) for f in frames
                          if f != '[DONE]'),
                         key=lambda d: d['choices'][0]['index']
                         if 'choices' in d else -1)
            doc += [f for f in frames if f == '[DONE]']
        else:
            doc = _strip(json.loads(text))
        out[name] = (status, headers, doc)
    (rs, rh, rdoc), (ps, ph, pdoc) = out['ref'], out['port']
    assert ps == rs, (path, body, rdoc, pdoc)
    rbody, rlps = _split_logprobs(rdoc)
    pbody, plps = _split_logprobs(pdoc)
    assert pbody == rbody, (path, body)
    np.testing.assert_allclose(plps, rlps, rtol=TOL_LOGPROB,
                               atol=TOL_LOGPROB)
    for header in ('Retry-After',):
        assert ph.get(header) == rh.get(header), header
    return ps, ph, pdoc


def _greedy(**body):
    return {'temperature': 0, **body}


# -- completions ----------------------------------------------------------------


def test_models_and_the_served_name(servers):
    status, _, doc = _both(servers, 'GET', '/v1/models')
    assert status == 200 and doc['data'][0]['id'] == 'tiny'
    _set(servers, model_name='served-as')
    try:
        _, _, doc = _both(servers, 'GET', '/v1/models')
        assert doc['data'][0]['id'] == 'served-as'
        _, _, doc = _both(servers, 'POST', '/v1/completions', _greedy(
            prompt=[3, 17, 42], max_tokens=2))
        assert doc['model'] == 'served-as'
    finally:
        _set(servers, model_name='tiny')


@pytest.mark.parametrize('body', [
    _greedy(prompt=[3, 17, 42], max_tokens=4),
    _greedy(prompt=[[3, 17, 42], [5, 6]], max_tokens=3),
    _greedy(prompt=[3, 17, 42], max_tokens=3, n=2, echo=True),
    _greedy(prompt=[3, 17, 42, 9], max_tokens=5, logprobs=0),
    _greedy(prompt=[7, 8], max_tokens=6, eos_token_id=3),
], ids=['tokens', 'token-lists', 'n-echo', 'logprobs', 'eos'])
def test_token_id_completions_match(servers, body):
    status, _, doc = _both(servers, 'POST', '/v1/completions', body)
    assert status == 200 and doc['choices'][0]['text'] is None


@pytest.mark.parametrize('body', [
    _greedy(prompt='hello world foo', max_tokens=4),
    _greedy(prompt=['hello world', 'foo bar go'], max_tokens=3),
    _greedy(prompt='hello world', max_tokens=4, n=2, echo=True),
    _greedy(prompt=[2, 3, 4], max_tokens=3, echo=True),
    _greedy(prompt='hello world', max_tokens=6, logprobs=0),
    _greedy(prompt='hello world', max_tokens=6, top_p=1e-6,
            temperature=1.0),
    _greedy(prompt='hello', max_tokens=2, top_p=None,
            response_format={'type': 'text'}, tool_choice='none'),
], ids=['text', 'text-list', 'n-echo', 'token-echo', 'logprobs',
        'top-p', 'no-op-fields'])
def test_text_completions_match(servers, body):
    _set(servers, tokenizer=servers['tok'])
    try:
        status, _, doc = _both(servers, 'POST', '/v1/completions', body)
    finally:
        _set(servers, tokenizer=None)
    assert status == 200 and isinstance(doc['choices'][0]['text'], str)


def test_stop_strings_match(servers):
    _set(servers, tokenizer=servers['tok'])
    try:
        _, _, base = _both(servers, 'POST', '/v1/completions', _greedy(
            prompt='hello world', max_tokens=6))
        words = base['choices'][0]['text'].split()
        assert len(words) >= 2
        for body in (_greedy(prompt='hello world', max_tokens=6,
                             stop=words[1]),
                     _greedy(prompt='hello world', max_tokens=6,
                             stop=[words[1], 'never'], logprobs=0)):
            _, _, doc = _both(servers, 'POST', '/v1/completions', body)
            assert doc['choices'][0]['finish_reason'] == 'stop'
            assert words[1] not in doc['choices'][0]['text']
    finally:
        _set(servers, tokenizer=None)


def test_chat_matches(servers):
    _set(servers, tokenizer=servers['tok'])
    try:
        for body in (_greedy(messages=[{'role': 'user',
                                        'content': 'hello world'}],
                             max_tokens=4),
                     _greedy(messages=[{'role': 'system', 'content': 'go'},
                                       {'role': 'user', 'content': 'foo'}],
                             max_tokens=3, n=2, logprobs=True)):
            status, _, doc = _both(servers, 'POST', '/v1/chat/completions',
                                   body)
            assert status == 200 and doc['object'] == 'chat.completion'
            for choice in doc['choices']:
                entries = (choice.get('logprobs') or {}).get('content', [])
                # A word-level token's own bytes are its word's.
                for entry in entries:
                    assert bytes(entry['bytes']) == \
                        entry['token'].encode('utf-8')
                if 'logprobs' in body:
                    assert entries
    finally:
        _set(servers, tokenizer=None)


# -- streams --------------------------------------------------------------------


@pytest.mark.parametrize('path,body,tokenizer', [
    ('/v1/completions', _greedy(prompt='hello world', max_tokens=5,
                                stream=True), True),
    ('/v1/completions', _greedy(prompt=[3, 17, 42], max_tokens=4,
                                stream=True), False),
    ('/v1/completions', _greedy(prompt=[3, 17], max_tokens=3, n=2,
                                stream=True), False),
    ('/v1/chat/completions', _greedy(
        messages=[{'role': 'user', 'content': 'hello'}], max_tokens=3,
        stream=True), True),
], ids=['text', 'tokens', 'n2-tokens', 'chat'])
def test_streams_match_frame_for_frame(servers, path, body, tokenizer):
    if tokenizer:
        _set(servers, tokenizer=servers['tok'])
    try:
        status, headers, frames = _both(servers, 'POST', path, body,
                                        stream=True)
    finally:
        _set(servers, tokenizer=None)
    assert status == 200 and frames[-1] == '[DONE]'
    assert headers['Content-Type'].startswith('text/event-stream')


def test_stream_stop_is_held_back_and_matches(servers):
    _set(servers, tokenizer=servers['tok'])
    try:
        _, _, base = _both(servers, 'POST', '/v1/completions', _greedy(
            prompt='hello world', max_tokens=6))
        words = base['choices'][0]['text'].split()
        _, _, frames = _both(servers, 'POST', '/v1/completions', _greedy(
            prompt='hello world', max_tokens=6, stream=True,
            stop=words[1]), stream=True)
    finally:
        _set(servers, tokenizer=None)
    text = ''.join(f['choices'][0]['text'] for f in frames[:-1])
    assert words[1] not in text
    assert frames[-2]['choices'][0]['finish_reason'] == 'stop'


# -- errors ---------------------------------------------------------------------


BAD_COMPLETIONS = (
    {'prompt': 'hello'},                      # no tokenizer: 400
    {'prompt': [1, 2], 'stop': 'x'},
    {'prompt': None}, {'prompt': []}, {'prompt': [[]]},
    {'prompt': [1.5, 2]}, {'prompt': [True, False]}, {'prompt': {'a': 1}},
    {'prompt': [1], 'n': 99}, {'prompt': [1], 'n': 0},
    {'prompt': [1], 'logprobs': 3}, {'prompt': [1], 'top_p': 0.0},
    {'prompt': [1], 'top_p': 1.5}, {'prompt': [1], 'best_of': 4},
    {'prompt': [1], 'response_format': {'type': 'json_object'}},
    {'prompt': [1], 'tools': [{'type': 'function'}]},
    {'prompt': [1], 'tool_choice': 'auto'},
    {'prompt': [1], 'stop': 5},
    {'prompt': [1], 'logprobs': 0, 'stream': True},
    {'prompt': [1], 'echo': True, 'logprobs': 0},
    {'prompt': [1], 'echo': True, 'stream': True},
    {'prompt': [1], 'temperature': 'hot'},
)


@pytest.mark.parametrize('body', BAD_COMPLETIONS)
def test_bad_completions_get_the_same_400(servers, body):
    status, _, doc = _both(servers, 'POST', '/v1/completions', body)
    assert status == 400 and doc['error']['type'] == 'invalid_request_error'


def test_bad_chats_and_text_errors_get_the_same_400(servers):
    for messages in (None, [], 'hi', [{'role': 'user'}]):
        _both(servers, 'POST', '/v1/chat/completions',
              {'messages': messages})
    _set(servers, tokenizer=servers['tok'])
    try:
        for messages in (None, [], [{'role': 'user'}]):
            status, _, _ = _both(servers, 'POST', '/v1/chat/completions',
                                 {'messages': messages})
            assert status == 400
        status, _, _ = _both(servers, 'POST', '/v1/chat/completions',
                             {'messages': [{'role': 'u', 'content': 'x'}],
                              'logprobs': True, 'top_logprobs': 2})
        assert status == 400
    finally:
        _set(servers, tokenizer=None)


def test_body_that_is_not_json_gets_the_same_400(servers):
    for name in ('ref', 'port'):
        srv = servers[name]
        if name == 'port':
            req = urllib.request.Request(srv.base + '/v1/completions',
                                         data=b'not json', method='POST')
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=30)
            got = (err.value.code, json.loads(err.value.read()))
        else:
            async def go():
                r = await srv.client.post('/v1/completions',
                                          data=b'not json')
                return r.status, json.loads(await r.text())
            want = srv.aio.run_until_complete(go())
    assert got == want and got[0] == 400


def test_503_while_loading(servers):
    loops = {name: servers[name].holder['loop'] for name in ('ref', 'port')}
    _set(servers, loop=None)
    try:
        for path, body in (('/v1/completions', {'prompt': [1]}),
                           ('/v1/chat/completions', {'messages': [
                               {'role': 'user', 'content': 'x'}]})):
            status, headers, doc = _both(servers, 'POST', path, body)
            assert (status, doc) == (503, {'error': 'model loading'})
    finally:
        for name, loop in loops.items():
            servers[name].holder['loop'] = loop


def test_shedding_matches_and_counts(servers):
    """With the queue gauge at the limit both servers answer 503 with
    Retry-After, before any engine work, and count each in
    REQUESTS_SHED; below the limit nothing is shed. Both engines are
    idle here, so nothing else writes the gauge."""
    gauges = (ref_obs.QUEUE_DEPTH, port_obs.QUEUE_DEPTH)
    shed = (ref_obs.REQUESTS_SHED, port_obs.REQUESTS_SHED)
    before = [c.value() for c in shed]
    _set(servers, max_queue_depth=2)
    try:
        for g in gauges:
            g.set(2)
        for path, body in (('/v1/completions', {'prompt': [1]}),
                           ('/v1/chat/completions', {'messages': [
                               {'role': 'user', 'content': 'x'}]})):
            status, headers, doc = _both(servers, 'POST', path, body)
            assert status == 503 and headers['Retry-After'] == '1'
            assert doc == {'error': 'overloaded: queue depth >= 2'}
        status, headers, doc = _both(servers, 'POST', '/generate', {
            'prompt_tokens': [1, 2], 'max_new_tokens': 2})
        assert status == 503 and headers['Retry-After'] == '1'
        assert [c.value() - b for c, b in zip(shed, before)] == [3, 3]
        for g in gauges:
            g.set(1)
        status, _, _ = _both(servers, 'POST', '/v1/completions',
                             _greedy(prompt=[1, 2], max_tokens=2))
        assert status == 200
        assert [c.value() - b for c, b in zip(shed, before)] == [3, 3]
    finally:
        for g in gauges:
            g.set(0)
        _set(servers, max_queue_depth=None)


def test_shed_limit_reads_the_knob_when_the_holder_has_none(monkeypatch):
    port_obs.QUEUE_DEPTH.set(4)
    try:
        monkeypatch.setenv('SKYTPU_MAX_QUEUE_DEPTH', '4')
        assert server_lib.shed_limit({}) == 4
        monkeypatch.setenv('SKYTPU_MAX_QUEUE_DEPTH', '5')
        assert server_lib.shed_limit({}) is None
        monkeypatch.setenv('SKYTPU_MAX_QUEUE_DEPTH', 'junk')  # off
        assert server_lib.shed_limit({}) is None
        assert server_lib.shed_limit({'max_queue_depth': 0}) is None
        assert server_lib.shed_limit({'max_queue_depth': 3}) == 3
    finally:
        port_obs.QUEUE_DEPTH.set(0)


# -- what only the port does ----------------------------------------------------


def test_v1_refuses_new_work_while_draining(servers):
    """Queue 3: the reference's /v1 routes admit during a drain (its
    `_ready` has no drain check) while /generate answers 503; the port
    answers 503 `replica draining` with Retry-After on every route."""
    _set(servers, draining=True)
    try:
        body = _greedy(prompt=[3, 4], max_tokens=2)
        status, _, _ = servers['ref'].request('POST', '/v1/completions',
                                              body)
        assert status == 200   # the reference's defect
        for path, req in (('/v1/completions', body),
                          ('/v1/chat/completions', {'messages': [
                              {'role': 'user', 'content': 'x'}]}),
                          ('/generate', {'prompt_tokens': [3, 4]})):
            status, headers, text = servers['port'].request('POST', path,
                                                            req)
            assert status == 503 and headers['Retry-After'] == '1'
            assert json.loads(text) == {'error': 'replica draining'}
    finally:
        _set(servers, draining=False)


def test_a_migrated_v1_request_ends_instead_of_hanging(servers):
    """A drain snapshots in-flight requests away; the /v1 routes cannot
    hand a client a migration blob, so the request ends with an error
    (the reference's `_collect` waits forever for 'done'). The snapshot
    is taken on the engine thread right after the request's first step,
    as a drain past its deadline takes it."""
    port = servers['port']
    loop = port.holder['loop']
    engine = loop.engine
    step = engine.step
    for stream in (False, True):
        snaps = []

        def step_then_drain():
            step()
            if not snaps and engine.active_progress():
                snaps.append(loop.snapshot_inflight())

        engine.step = step_then_drain
        try:
            status, _, text = port.request('POST', '/v1/completions',
                                           _greedy(prompt=[3, 4, 5],
                                                   max_tokens=40,
                                                   stream=stream))
        finally:
            del engine.step
        assert len(snaps) == 1 and len(snaps[0]) == 1
        if stream:
            frames = _sse(text)
            assert status == 200 and frames[-1] == '[DONE]'
            assert 'migrated away' in json.loads(frames[-2])['error']
        else:
            assert status == 500 and 'migrated away' in json.loads(
                text)['error']


def test_client_gone_mid_stream_frees_the_slot(servers):
    port = servers['port']
    loop = port.holder['loop']
    aborted = port_obs.REQUESTS_ABORTED.value()
    host, portno = port.srv.server_address
    body = json.dumps(_greedy(prompt=[3, 4, 5], max_tokens=50,
                              stream=True)).encode()
    with socket.create_connection((host, portno), timeout=30) as sock:
        sock.sendall(b'POST /v1/completions HTTP/1.1\r\nHost: x\r\n'
                     b'Content-Type: application/json\r\n'
                     b'Content-Length: ' + str(len(body)).encode()
                     + b'\r\n\r\n' + body)
        assert sock.recv(64).startswith(b'HTTP/1.0 200')
    deadline = time.time() + 30
    while loop.has_pending() or \
            port_obs.REQUESTS_ABORTED.value() == aborted:
        assert time.time() < deadline, 'the slot was never freed'
        time.sleep(0.02)
    assert port_obs.REQUESTS_ABORTED.value() == aborted + 1


# -- chat logprobs' bytes (ROADMAP Queue 3, closed) ------------------------------


def _byte_level_bpe():
    """A byte-level BPE tokenizer trained here (no download) on text
    whose accented and euro characters stay split across tokens."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers import trainers
    from transformers import PreTrainedTokenizerFast
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=300, special_tokens=['</s>'],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(['hello world there ' * 5] * 20, trainer)
    return PreTrainedTokenizerFast(tokenizer_object=tok, eos_token='</s>')


def test_chat_bytes_are_the_tokens_own_utf8():
    """Joined over the kept entries, the bytes are the content's UTF-8,
    with 'ï' split over two tokens and '€' over three; the entries past
    a split character are kept (the reference stops at its second half);
    the trailing eos is not an entry."""
    from skypilot_tpu_torch.inference import openai_api
    tok = _byte_level_bpe()
    text = 'hello naïve € world'
    ids = tok.encode(text)
    glyphs = tok.convert_ids_to_tokens(ids)
    assert 'Ã' in glyphs and '¯' in glyphs       # 'ï' = c3 af, split
    ids = ids + [tok.eos_token_id]
    content = openai_api._decode(tok, ids)
    assert content == text
    doc = openai_api._logprobs_doc(ids, [-0.5] * len(ids), tok, True,
                                   len(content))
    entries = doc['content']
    assert len(entries) == len(ids) - 1
    assert b''.join(bytes(e['bytes']) for e in entries) == \
        content.encode('utf-8')
    assert [e['token'] for e in entries] == glyphs
    assert bytes(entries[0]['bytes']) == b'hello'
    assert bytes(entries[1]['bytes']) == b' '          # the glyph 'Ġ'
    # The completions endpoint keeps its glyph tokens and offsets.
    doc = openai_api._logprobs_doc(ids, [-0.5] * len(ids), tok, False,
                                   len(content))
    assert doc['tokens'] == glyphs and len(doc['text_offset']) == len(glyphs)


def test_sentencepiece_pieces_give_their_bytes():
    """Outside the byte-level alphabet: '▁' is a space and a '<0xNN>'
    piece that byte; a special token decodes to nothing."""
    from skypilot_tpu_torch.inference import openai_api

    class Pieces:
        all_special_ids = [2]
        pieces = {0: '▁hello', 1: 'ing', 2: '</s>', 3: '<0xE2>',
                  4: '<0x82>', 5: '<0xAC>', 6: '▁naïve'}

        def convert_ids_to_tokens(self, ids):
            return [self.pieces[i] for i in ids]

    got = openai_api._token_bytes(Pieces(), [0, 1, 3, 4, 5, 6, 2])
    assert got == [b' hello', b'ing', b'\xe2', b'\x82', b'\xac',
                   ' naïve'.encode('utf-8'), b'']
