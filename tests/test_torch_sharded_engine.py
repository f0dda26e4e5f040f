"""Port parity: tensor-parallel serving in skypilot_tpu_torch, the port of
`tests/unit/test_sharded_paged.py`'s oracle.

Two ranks (four for the replicated-KV case) are spawned once for the
module and join a gloo mesh on the CPU from the gang variables; rank 0
runs each scenario's script of submits, steps and aborts, the other ranks
`follow()`. Every scenario's greedy tokens must equal, on every rank,
those of the port's unsharded engine on the same script (paged, dense,
int8, a warm prefix hit with copy-on-write, an oversubscribed pool that
queues and drains, an abort between steps, tensor 4 over tiny's two KV
heads), and the JAX engine's under `MeshSpec(data=1, fsdp=4, tensor=2)`
on the conftest's 8 CPU devices on the same script. The JAX engine
refuses tiny's two KV heads at tensor 4 (its pool must divide), so the
replicated case is held to it at tensor 2, and the reference's own deep
split (tiny with four KV heads, one a rank) to it at
`MeshSpec(data=1, fsdp=2, tensor=4)`.
Each first-token sample's logits agree with the unsharded engine's
within 1e-5 relative (f32). Rank 0's shared prefix pages keep their
bytes through the COW. A follower whose host plan is tampered with
raises (the plan hash each step carries), and an idle rank 0's
heartbeats keep its followers alive past the control group's timeout.

The server runs as two processes (`--mesh tensor=2 --device cpu`, its
weights drawn sharded from seed 0): /generate, a stream and /v1 equal
the unsharded engine's tokens on the same seed, and its follower exits
non-zero when rank 0 is killed. (Batch's two processes are in
`test_torch_batch.py`.)
"""
import dataclasses
import json
import multiprocessing
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu import inference as ref_inference
from skypilot_tpu.models import llama as ref_llama
from skypilot_tpu_torch import inference as port_inference
from skypilot_tpu_torch import weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_LOGITS_REL = 1e-5
PREFIX = [i % 89 + 1 for i in range(16)]
PROMPTS = [[5, 11, 2, 9], list(range(3, 25)), [7] * 17 + [3, 1]]
BASE_KW = dict(batch_size=3, max_seq_len=64, prefill_chunk=16,
               kv_page_size=8, kv_quant='none', prefix_cache=False)


def _script(prompts, max_new):
    return ([('submit', p, max_new) for p in prompts] + [('run',)])


# name -> (engine kwargs over BASE_KW, rank 0's script)
SCENARIOS = {
    'paged': ({}, _script(PROMPTS, 8)),
    'dense': (dict(kv_page_size=0), _script(PROMPTS, 8)),
    'int8': (dict(kv_quant='int8'), _script(PROMPTS, 8)),
    'prefix': (dict(batch_size=2, prefix_cache=True),
               _script([PREFIX + [3, 4]], 6) + [('snap',)]
               + _script([PREFIX + [9, 9]], 6) + _script([PREFIX], 4)
               + [('cow',)]),
    'oversubscribed': (dict(batch_size=2, kv_pages=6),
                       _script([list(range(1, 30)), list(range(1, 10))], 8)),
    'abort': ({}, [('submit', PROMPTS[0], 10), ('submit', [8, 1, 6], 40),
                   ('step',), ('abort', 1), ('run',)]),
    # Rank 0 idles past the control group's timeout, then serves.
    'idle': ({}, [('idle', 6.0)] + _script(PROMPTS[:1], 4)),
}
# The third entry names the model (tiny unless given).
TENSOR4 = {'tensor4': ({}, _script(PROMPTS, 8)),
           'tensor4_kv4': ({}, _script(PROMPTS, 8), 'tiny_kv4')}
# Shorter control timings in the ranks, so the idle scenario outlasts the
# timeout in seconds.
TIMEOUT_S, HEARTBEAT_S = 5.0, 0.25


def run_script(engine, script, seen):
    """Rank 0's (or an unsharded engine's) script; returns the request
    ids and what the script measured. `seen` collects every finished
    request's tokens."""
    from skypilot_tpu_torch.inference import engine as eng
    rids, out = [], {'max_queue': 0}
    for op in script:
        if op[0] == 'submit':
            rids.append(engine.submit(
                list(op[1]), eng.SamplingParams(max_new_tokens=op[2])))
        elif op[0] == 'step':
            engine.step()
            seen.update(engine.finished())
        elif op[0] == 'abort':
            engine.abort(rids[op[1]])
        elif op[0] == 'run':
            while engine.has_work:
                engine.step()
                out['max_queue'] = max(out['max_queue'],
                                       engine.queue_depth())
                seen.update(engine.finished())
        elif op[0] == 'idle':
            t_end = time.monotonic() + op[1]
            while time.monotonic() < t_end:
                engine.heartbeat()
                time.sleep(0.05)
        elif op[0] in ('snap', 'cow'):
            pool = engine.state.cache['k']
            if op[0] == 'snap':
                out['cached'] = {p: pool[:, p].clone() for p in range(
                    1, engine.pages_total() + 1) if engine._prefix.owns(p)}
            else:
                out['cow_copies'] = engine.stats['cow_copies']
                out['prefix_hits'] = engine.stats['prefix_hits']
                out['cow_intact'] = all(
                    torch.equal(pool[:, p], data)
                    for p, data in out.pop('cached').items())
    return rids, out


def _instrument(engine):
    """Record every finished request and every first-token sample's
    logits of `engine` (its followers' own books included)."""
    seen, logits = {}, []
    finished, sample = engine.finished, engine._sample_host_params

    def recording_finished():
        out = finished()
        seen.update(out)
        return out

    def recording_sample(lg, params):
        logits.append(lg.detach().float().clone().numpy())
        return sample(lg, params)

    engine.finished = recording_finished
    engine._sample_host_params = recording_sample
    return seen, logits


def _model(spec):
    return spec[2] if len(spec) > 2 else 'tiny'


def rank_main(rank, world, port, models, scenarios, out):
    os.environ.update(SKYTPU_COORDINATOR_ADDR=f'127.0.0.1:{port}',
                      SKYTPU_NUM_PROCESSES=str(world),
                      SKYTPU_PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    from skypilot_tpu_torch.parallel import control
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    control.TIMEOUT_SECONDS, control.HEARTBEAT_SECONDS = TIMEOUT_S, \
        HEARTBEAT_S
    results = {}
    try:
        mesh = mesh_lib.mesh_from_env(
            mesh_lib.MeshSpec.parse(f'tensor={world}'), 'cpu')
        for name, spec in scenarios.items():
            kw, script = spec[:2]
            engine = port_inference.InferenceEngine(
                *models[_model(spec)], mesh=mesh, **{**BASE_KW, **kw})
            seen, logits = _instrument(engine)
            if rank == 0:
                rids, measured = run_script(engine, script, seen)
                engine.stop_followers()
            else:
                engine.follow()
                rids, measured = None, {}
            k = engine.state.cache['k']
            results[name] = {
                'rids': rids, 'seen': seen, 'logits': logits,
                'kv_heads': (k['q'] if isinstance(k, dict) else k).shape[3],
                **measured}
        # A follower whose host plan left rank 0's raises at the next
        # message; rank 0 then loses it inside the step's collectives.
        engine = port_inference.InferenceEngine(*models['tiny'], mesh=mesh,
                                                **BASE_KW)
        try:
            if rank == 0:
                run_script(engine, _script(PROMPTS[:1], 4), {})
            else:
                engine._page_alloc.reverse()
                engine.follow()
            results['tampered'] = 'no error'
        except RuntimeError as e:
            results['tampered'] = str(e)
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        results['error'] = f'{type(e).__name__}: {e}'
    out.put((rank, results))
    out.close()
    out.join_thread()
    os._exit(0)


def _free_port():
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _start(world, models, scenarios):
    """Start `world` ranks on `scenarios`; returns wait(), their results
    by rank (read once, then kept)."""
    ctx = multiprocessing.get_context('spawn')
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=rank_main, args=(
        r, world, port, models, scenarios, out))
        for r in range(world)]
    for p in procs:
        p.start()
    got = []

    def wait():
        if not got:
            try:
                results = dict(out.get(timeout=240) for _ in procs)
            finally:
                for p in procs:
                    p.join(30)
                    if p.is_alive():
                        p.kill()
            got.append([results[r] for r in range(world)])
        return got[0]

    return wait


@pytest.fixture(scope='module')
def tiny():
    ref_config = ref_llama.CONFIGS['tiny']
    params = ref_llama.init_params(ref_config, jax.random.key(7))
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    tparams = weights.from_jax_params(jax.tree.map(np.asarray, params))
    return ref_config, params, config, tparams


@pytest.fixture(scope='module')
def models(tiny):
    """name -> (JAX params, JAX config, port params, port config): tiny,
    and the reference's deep-split variant of it with four KV heads
    (`test_sharded_paged.py::test_tensor4_deep_split`)."""
    ref_config, params, config, tparams = tiny
    config4 = dataclasses.replace(ref_config, num_heads=4, num_kv_heads=4)
    params4 = ref_llama.init_params(config4, jax.random.key(11))
    return {'tiny': (params, ref_config, tparams, config),
            'tiny_kv4': (params4, config4, weights.from_jax_params(
                jax.tree.map(np.asarray, params4)),
                weights.config_from_dict(dataclasses.asdict(config4)))}


def _port_models(models):
    return {name: m[2:] for name, m in models.items()}


@pytest.fixture(scope='module')
def gangs(models):
    """The two- and four-rank gangs, started together."""
    return {2: _start(2, _port_models(models), SCENARIOS),
            4: _start(4, _port_models(models), TENSOR4)}


# The unsharded engines run while the gangs do.
@pytest.fixture(scope='module')
def ranks(gangs, unsharded):
    return gangs[2]()


@pytest.fixture(scope='module')
def ranks4(gangs, unsharded):
    return gangs[4]()


@pytest.fixture(scope='module')
def unsharded(models, gangs):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    for name, spec in {**SCENARIOS, **TENSOR4}.items():
        kw, script = spec[:2]
        engine = port_inference.InferenceEngine(
            *models[_model(spec)][2:], device='cpu', **{**BASE_KW, **kw})
        seen, logits = _instrument(engine)
        rids, measured = run_script(engine, script, seen)
        out[name] = {'tokens': [seen.get(r) for r in rids],
                     'logits': logits, **measured}
    torch.set_num_threads(threads)
    return out


# JAX engines by (model, mesh, engine kwargs): scripts without a prefix
# cache leave an engine as they found it, so the scenarios of one
# geometry share its compiles.
_JAX_ENGINES = {}


def _jax_tokens(models, name, mesh_axes=(1, 4, 2)):
    """The JAX engine's tokens on scenario `name`'s script under
    MeshSpec(data, fsdp, tensor) = `mesh_axes`."""
    from skypilot_tpu.parallel import MeshSpec, make_mesh
    spec = {**SCENARIOS, **TENSOR4}[name]
    kw, script = {**BASE_KW, **spec[0]}, spec[1]
    key = (_model(spec), mesh_axes, tuple(sorted(kw.items())))
    ref = _JAX_ENGINES.get(key)
    if ref is None:
        params, config = models[_model(spec)][:2]
        data, fsdp, tensor = mesh_axes
        ref = ref_inference.InferenceEngine(
            params, config, mesh=make_mesh(MeshSpec(data=data, fsdp=fsdp,
                                                    tensor=tensor)),
            **{k: kw[k] for k in ('batch_size', 'max_seq_len',
                                  'prefill_chunk', 'kv_quant',
                                  'kv_page_size', 'prefix_cache')},
            **({'kv_pages': kw['kv_pages']} if 'kv_pages' in kw else {}))
        if not kw['prefix_cache']:
            _JAX_ENGINES[key] = ref
    rids, seen = [], {}
    for op in script:
        if op[0] == 'submit':
            rids.append(ref.submit(list(op[1]), ref_inference.SamplingParams(
                max_new_tokens=op[2])))
        elif op[0] == 'step':
            ref.step()
            seen.update(ref.finished())
        elif op[0] == 'abort':
            ref.abort(rids[op[1]])
        elif op[0] == 'run':
            seen.update(ref.run_to_completion())
    return [seen.get(r) for r in rids]


def _rank_tokens(results, name):
    """Each rank's tokens of a scenario, by rank 0's request ids."""
    rids = results[0][name]['rids']
    return [[r[name]['seen'].get(rid) for rid in rids] for r in results]


def _check(results, unsharded, name):
    for r in results:
        assert 'error' not in r, r['error']
    per_rank = _rank_tokens(results, name)
    want = unsharded[name]['tokens']
    for tokens in per_rank:
        assert tokens == want, (name, tokens, want)
    got_logits = results[0][name]['logits']
    want_logits = unsharded[name]['logits']
    assert len(got_logits) == len(want_logits) > 0
    for a, b in zip(got_logits, want_logits):
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= TOL_LOGITS_REL, (name, err)
    # Every rank samples from the same gathered logits.
    for r in results[1:]:
        for a, b in zip(r[name]['logits'], got_logits):
            np.testing.assert_array_equal(a, b)
    return per_rank[0]


@pytest.mark.parametrize('name', ['paged', 'dense', 'int8'])
def test_tensor2_equals_unsharded_and_the_jax_engine(models, ranks,
                                                     unsharded, name):
    tokens = _check(ranks, unsharded, name)
    assert ranks[0][name]['kv_heads'] == \
        models['tiny'][3].num_kv_heads // 2
    assert tokens == _jax_tokens(models, name)


def test_warm_prefix_hit_copies_on_write(models, ranks, unsharded):
    tokens = _check(ranks, unsharded, 'prefix')
    assert tokens == _jax_tokens(models, 'prefix')
    got = ranks[0]['prefix']
    assert got['prefix_hits'] == unsharded['prefix']['prefix_hits'] == 2
    assert got['cow_copies'] == unsharded['prefix']['cow_copies'] >= 1
    assert got['cow_intact'] and unsharded['prefix']['cow_intact']


def test_oversubscribed_pool_queues_and_drains(models, ranks, unsharded):
    tokens = _check(ranks, unsharded, 'oversubscribed')
    assert tokens == _jax_tokens(models, 'oversubscribed')
    assert ranks[0]['oversubscribed']['max_queue'] == 1


def test_abort_between_steps(models, ranks, unsharded):
    tokens = _check(ranks, unsharded, 'abort')
    assert tokens[1] is None and len(tokens[0]) == 10
    assert tokens == _jax_tokens(models, 'abort')


def test_idle_leader_keeps_followers_alive(ranks, unsharded):
    """Rank 0 idled 6 s, past the 5 s the followers wait for a message,
    then served."""
    assert SCENARIOS['idle'][1][0][1] > TIMEOUT_S
    _check(ranks, unsharded, 'idle')


def test_tensor4_replicates_tinys_two_kv_heads(models, ranks4, unsharded):
    tokens = _check(ranks4, unsharded, 'tensor4')
    assert [r['tensor4']['kv_heads'] for r in ranks4] == [1, 1, 1, 1]
    # The JAX engine cannot split two KV heads four ways; it serves the
    # same script at tensor 2.
    with pytest.raises(ValueError, match='divisible by 4'):
        _jax_tokens(models, 'tensor4', (1, 2, 4))
    assert tokens == _jax_tokens(models, 'tensor4')


def test_tensor4_deep_split_equals_the_jax_engine(models, ranks4, unsharded):
    """The reference's deep split: four KV heads, one on each rank."""
    tokens = _check(ranks4, unsharded, 'tensor4_kv4')
    assert [r['tensor4_kv4']['kv_heads'] for r in ranks4] == [1, 1, 1, 1]
    assert tokens == _jax_tokens(models, 'tensor4_kv4', (1, 2, 4))


def test_a_follower_off_rank_0s_plan_raises(ranks):
    assert 'host plan' in ranks[1]['tampered'] and \
        'diverged' in ranks[1]['tampered']
    assert ranks[0]['tampered'] != 'no error'


# -- the entry points as processes ------------------------------------------


def _gang_env(port, rank, world=2):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('SKYTPU_')}
    return {**env, 'PYTHONPATH': REPO, 'OMP_NUM_THREADS': '1',
            'SKYTPU_COORDINATOR_ADDR': f'127.0.0.1:{port}',
            'SKYTPU_NUM_PROCESSES': str(world),
            'SKYTPU_PROCESS_ID': str(rank)}


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type':
                                          'application/json'})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read().decode()


def test_server_serves_tensor2_and_its_follower_exits_with_rank_0(tmp_path):
    flags = ['--model', 'tiny', '--device', 'cpu', '--mesh', 'tensor=2',
             '--batch-size', '2', '--max-seq-len', '64',
             '--prefill-chunk', '16', '--kv-page-size', '8']
    http, gang = _free_port(), _free_port()
    logs = [open(tmp_path / f'rank{r}.log', 'w') for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.inference.server',
         '--port', str(http)] + flags, cwd=REPO, env=_gang_env(gang, r),
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    base = f'http://127.0.0.1:{http}'
    try:
        t0 = time.monotonic()
        while True:
            assert procs[0].poll() is None and procs[1].poll() is None, \
                (tmp_path / 'rank0.log').read_text()[-3000:]
            try:
                with urllib.request.urlopen(base + '/health', timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            assert time.monotonic() - t0 < 120
            time.sleep(0.2)
        got = [json.loads(_post(base + '/generate', {
            'prompt_tokens': p, 'max_new_tokens': 6}))['tokens']
            for p in PROMPTS[:2]]
        frames = [line for line in _post(base + '/generate', {
            'prompt_tokens': PROMPTS[2], 'max_new_tokens': 6,
            'stream': True}).splitlines() if line.startswith('data: ')]
        got.append(json.loads(frames[-1][6:])['tokens'])
        v1 = json.loads(_post(base + '/v1/completions', {
            'prompt': PROMPTS[0], 'max_tokens': 6, 'temperature': 0}))
        # The unsharded engine on the same seed, one request at a time.
        engine = port_inference.build_engine(
            'tiny', device='cpu', seed=0, batch_size=2, max_seq_len=64,
            prefill_chunk=16, kv_page_size=8)
        want = []
        for p in PROMPTS:
            rid = engine.submit(p, port_inference.SamplingParams(
                max_new_tokens=6))
            want.append(engine.run_to_completion()[rid])
        assert got == want
        assert v1['choices'][0]['tokens'] == want[0]
        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait(10)
        rc = procs[1].wait(30)
        assert rc != 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
