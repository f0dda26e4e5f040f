"""The port's standard-library HTTP server on the `tiny` config, on the CPU.

/health before and after the engine loads, /generate plain (with
logprobs) and streaming, bad bodies, and concurrent requests: every
answer carries exactly the tokens the engine emits greedily for the
same prompt. The server as a process (`python -m`): it exits once its
launcher dies, unless `--no-exit-with-parent`; with
`--draft-model` it serves speculative decode with the draft-free
server's greedy tokens; and it takes the OpenAI routes' flags
(`--served-model-name`, `--tokenizer`, `--max-queue-depth`).
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
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


# -- the server as a process --------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A launcher that starts the server, waits until it answers /health (200,
# or 503 while the engine loads: either way its watchdog has recorded
# this parent), writes its pid and exits.
_LAUNCHER = r"""
import subprocess, sys, time, urllib.error, urllib.request
port, marker, log, extra = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4:]
proc = subprocess.Popen([sys.executable, '-m',
                         'skypilot_tpu_torch.inference.server', '--device',
                         'cpu', '--model', 'tiny', '--port', port] + extra,
                        stdout=open(log, 'w'), stderr=subprocess.STDOUT)
open(marker, 'w').write(str(proc.pid))
deadline = time.time() + 90
while time.time() < deadline and proc.poll() is None:
    try:
        urllib.request.urlopen(f'http://127.0.0.1:{port}/health', timeout=2)
        break
    except urllib.error.HTTPError:
        break
    except OSError:
        time.sleep(0.1)
else:
    sys.exit('the server never answered /health')
"""


def _free_port():
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _alive(pid):
    """True while `pid` runs (a zombie awaiting its reaper counts as
    gone)."""
    try:
        with open(f'/proc/{pid}/stat') as f:
            return f.read().rsplit(')', 1)[1].split()[0] != 'Z'
    except FileNotFoundError:
        return False


def _kill(pid):
    if _alive(pid):
        os.kill(pid, signal.SIGKILL)


def _launch_orphan(tmp_path, *extra):
    """Start the server through _LAUNCHER and let the launcher exit.
    Returns (server pid, port)."""
    port, marker = _free_port(), tmp_path / 'server.pid'
    env = {**os.environ, 'SKYTPU_WATCHDOG_INTERVAL': '0.3',
           'PYTHONPATH': REPO, 'OMP_NUM_THREADS': '1'}
    # The server writes to its own log, so no pipe of ours outlives the
    # launcher.
    try:
        proc = subprocess.run([sys.executable, '-c', _LAUNCHER, str(port),
                               str(marker), str(tmp_path / 'server.log'),
                               *extra], env=env, cwd=REPO, timeout=120,
                              capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        if marker.exists():
            _kill(int(marker.read_text()))
        raise
    pid = int(marker.read_text())
    if proc.returncode != 0:
        _kill(pid)
        raise AssertionError(proc.stderr)
    return pid, port


def test_server_exits_with_its_launcher(tmp_path):
    """The launcher is gone: the server notices the new parent within a
    few watchdog intervals and exits instead of holding the device."""
    pid, _ = _launch_orphan(tmp_path)
    try:
        deadline = time.time() + 10
        while time.time() < deadline and _alive(pid):
            time.sleep(0.1)
        assert not _alive(pid), 'server lingered after its launcher died'
    finally:
        _kill(pid)


@pytest.fixture(scope='module')
def orphan_spec_server(tmp_path_factory):
    """A speculative server (`--draft-model tiny --spec-k 3`, ENGINE_KW's
    geometry and seed) launched with --no-exit-with-parent by a launcher
    that has exited; loaded before the tests use it."""
    pid, port = _launch_orphan(
        tmp_path_factory.mktemp('spec_server'), '--no-exit-with-parent',
        '--draft-model', 'tiny', '--spec-k', '3', '--batch-size', '2',
        '--max-seq-len', '64', '--prefill-chunk', '16', '--kv-page-size',
        '8', '--seed', '1')
    base = f'http://127.0.0.1:{port}'
    try:
        deadline = time.time() + 90
        while True:
            try:
                if _get(base + '/health', timeout=5)[0] == 200:
                    break
            except urllib.error.HTTPError:
                pass
            assert time.time() < deadline and _alive(pid)
            time.sleep(0.1)
        yield pid, base
    finally:
        _kill(pid)


def test_no_exit_with_parent_outlives_its_launcher(orphan_spec_server):
    pid, _ = orphan_spec_server
    time.sleep(1.5)                     # five watchdog intervals
    assert _alive(pid)


def test_draft_model_server_matches_draft_free_server(orphan_spec_server,
                                                      served):
    _, spec_base = orphan_spec_server
    plain_base, _ = served
    prompt = [5, 9, 14, 3, 77, 8, 120, 33]
    body = {'prompt_tokens': prompt, 'max_new_tokens': 12}
    spec = json.loads(_post(spec_base + '/generate', body)[1])['tokens']
    # /health reads the process-global counters, which other engines of
    # this test process may have moved: the draft-free server's request
    # must leave them where they were.
    plain_before = _get(plain_base + '/health')[1]['engine']['spec']
    plain = json.loads(_post(plain_base + '/generate', body)[1])['tokens']
    assert spec == plain == _expected(prompt, 12)[0]
    spec_health = _get(spec_base + '/health')[1]['engine']['spec']
    assert spec_health['rounds'] > 0
    assert spec_health['proposed_tokens'] >= spec_health['accepted_tokens']
    assert set(plain_before) == {'rounds', 'proposed_tokens',
                                 'accepted_tokens'}
    assert _get(plain_base + '/health')[1]['engine']['spec'] == plain_before


def _toy_tokenizer_dir(path):
    """tests/unit/test_openai_api.py's toy tokenizer (WordLevel over
    tiny's 256 ids, '</s>' the eos), saved as an HF tokenizer dir."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import PreTrainedTokenizerFast
    words = ['[UNK]', '</s>', 'hello', 'world', 'foo', 'bar', 'stop', 'go']
    words += [f'w{i}' for i in range(len(words), 256)]
    tok = Tokenizer(WordLevel({w: i for i, w in enumerate(words)},
                              unk_token='[UNK]'))
    tok.pre_tokenizer = Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token='[UNK]',
                            eos_token='</s>').save_pretrained(str(path))
    return str(path)


def test_openai_flags_in_a_process(tmp_path):
    """--served-model-name names the model /v1 reports, --tokenizer
    gives /v1/completions text prompts, and --max-queue-depth is taken
    (the shedding itself: tests/test_torch_openai_api.py)."""
    pid, port = _launch_orphan(
        tmp_path, '--no-exit-with-parent', '--served-model-name',
        'my-model', '--tokenizer', _toy_tokenizer_dir(tmp_path / 'tok'),
        '--max-queue-depth', '4', '--batch-size', '2', '--max-seq-len',
        '64', '--prefill-chunk', '16', '--kv-page-size', '8')
    base = f'http://127.0.0.1:{port}'
    try:
        deadline = time.time() + 90
        while True:
            try:
                if _get(base + '/health', timeout=5)[0] == 200:
                    break
            except urllib.error.HTTPError:
                pass
            assert time.time() < deadline and _alive(pid)
            time.sleep(0.1)
        assert _get(base + '/v1/models')[1]['data'][0]['id'] == 'my-model'
        status, text = _post(base + '/v1/completions', {
            'prompt': 'hello world', 'max_tokens': 3, 'temperature': 0})
        doc = json.loads(text)
        assert status == 200 and doc['model'] == 'my-model'
        assert isinstance(doc['choices'][0]['text'], str)
        assert doc['usage']['prompt_tokens'] == 2
    finally:
        _kill(pid)
