"""The port's standard-library HTTP server on the `tiny` config, on the CPU.

/health before and after the engine loads, /generate plain (with
logprobs) and streaming, bad bodies, and concurrent requests: every
answer carries exactly the tokens the engine emits greedily for the
same prompt.
"""
import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from skypilot_tpu_torch import inference
from skypilot_tpu_torch.inference import server as server_lib

ENGINE_KW = dict(batch_size=2, max_seq_len=64, prefill_chunk=16,
                 kv_page_size=8, device='cpu', seed=1)


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


@pytest.fixture(scope='module')
def served():
    engine = inference.build_engine('tiny', **ENGINE_KW)
    holder = {'loop': None}
    srv = server_lib.create_server(holder, host='127.0.0.1', port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f'http://127.0.0.1:{srv.server_address[1]}'
    try:
        with pytest.raises(urllib.error.HTTPError) as info:
            _get(base + '/health')
        assert info.value.code == 503
        holder['loop'] = server_lib.EngineLoop(engine)
        yield base, engine
    finally:
        srv.shutdown()
        srv.server_close()
        if holder['loop'] is not None:
            holder['loop'].stop()
        thread.join(10)


def _expected(prompt, max_new):
    """Greedy tokens and logprobs from a fresh engine with the same
    seed-drawn weights."""
    engine = inference.build_engine('tiny', **ENGINE_KW)
    rid = engine.submit(prompt, inference.SamplingParams(
        max_new_tokens=max_new))
    tokens = engine.run_to_completion()[rid]
    return tokens, engine.finished_logprobs()[rid]


def test_health_reports_engine(served):
    base, _ = served
    status, doc = _get(base + '/health')
    assert status == 200 and doc['status'] == 'ok'
    assert doc['engine']['kv_pages']['total'] == 16


def test_generate_plain_matches_engine(served):
    base, _ = served
    prompt = [5, 9, 14, 3, 77, 8]
    status, text = _post(base + '/generate', {
        'prompt_tokens': prompt, 'max_new_tokens': 7, 'logprobs': True})
    doc = json.loads(text)
    want_tokens, want_lps = _expected(prompt, 7)
    assert status == 200 and doc['tokens'] == want_tokens
    assert doc['logprobs'] == pytest.approx(want_lps, abs=1e-5)


def test_generate_stream_matches_engine(served):
    base, _ = served
    prompt = list(range(20, 45))
    status, text = _post(base + '/generate', {
        'prompt_tokens': prompt, 'max_new_tokens': 9, 'stream': True})
    frames = [json.loads(line[len('data: '):])
              for line in text.splitlines() if line.startswith('data: ')]
    want, _ = _expected(prompt, 9)
    assert status == 200
    assert [f['token'] for f in frames[:-1]] == want
    assert frames[-1] == {'done': True, 'tokens': want}


def test_concurrent_requests_batch(served):
    base, _ = served
    prompts = [[1, 2, 3], list(range(7, 30)), [42] * 5]
    results = {}

    def call(i):
        results[i] = json.loads(_post(base + '/generate', {
            'prompt_tokens': prompts[i], 'max_new_tokens': 6})[1])['tokens']

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    for i, prompt in enumerate(prompts):
        assert results[i] == _expected(prompt, 6)[0]


@pytest.mark.parametrize('body', [{}, {'prompt_tokens': []},
                                  {'prompt_tokens': ['x']},
                                  {'prompt_tokens': [1], 'top_p': 0}])
def test_bad_requests_get_400(served, body):
    base, _ = served
    with pytest.raises(urllib.error.HTTPError) as info:
        _post(base + '/generate', body)
    assert info.value.code == 400


def test_engine_stays_on_cpu_here(served):
    _, engine = served
    assert engine.device == torch.device('cpu')
