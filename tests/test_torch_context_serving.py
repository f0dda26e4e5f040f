"""Port parity: serving over the fsdp, data, pipe and context mesh axes in
skypilot_tpu_torch, against the JAX engine under the matching `MeshSpec`
on the conftest's 8 CPU devices and against the port's unsharded engine.

Ranks are spawned once for the module (a gang of two and one of four)
and join gloo meshes on the CPU from the gang variables, one mesh a
scenario; rank 0 runs each scenario's script, the other ranks
`follow()`. f32 tiny configs, greedy, so the tolerance is token equality
and first-token logits within TOL_LOGITS_REL (1e-5) relative of the
port's unsharded engine on the same script:
- tiny with itself as its draft at `fsdp=2`, every rank holding half of
  each `embed`-cut weight between layers (each layer gathered for its
  math), and tiny-moe at `fsdp=2`: equal to the JAX engine;
- tiny at `data=2,pipe=2` (four ranks, everything replicated): equal
  to the unsharded engine;
- tiny at `context=2`, bf16 and int8 KV, chunk 8 over a cache of 40
  positions, so the chunk [16, 24) straddles the spans' boundary at 20
  and the later rank's first two chunks see no key of its span; a
  prompt past the interleave threshold prefills one chunk a step; each
  rank's cache leaf holds 20 positions: equal to the JAX engine; the
  same through the flash path (the kernels' plain versions at the
  span's offset, negative on the later rank) equal to the port's
  unsharded flash engine;
- tiny at `tensor=2,context=2` (four ranks, as the reference's
  tests/unit/test_inference.py:382): equal to the JAX engine;
- a request snapshotted on `context=2` (its dense row gathered over the
  spans) restored into the port's unsharded engine with the row equal,
  and an unsharded engine's blob restored into `context=2`, each span
  taking its positions;
- the reference's ValueError for an explicit page size with `context`;
- `checkpoints import --mesh fsdp=2` as two processes;
- `flash_attention._merge` at +inf lse rows, and the kernels'
  plain versions at a negative `q_offset`.
"""
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import tempfile
import time

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu import inference as ref_inference
from skypilot_tpu.models import llama as ref_llama
from skypilot_tpu.models import moe as ref_moe
from skypilot_tpu_torch import inference as port_inference
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.inference import engine as port_eng
from skypilot_tpu_torch.ops import flash_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_LOGITS_REL = 1e-5
PROMPTS = [[5, 11, 2, 9], list(range(3, 25)), [7] * 17 + [3, 1]]
BASE_KW = dict(batch_size=3, max_seq_len=64, prefill_chunk=16,
               kv_quant='none', prefix_cache=False)
# context=2: 40 positions, spans [0, 20) and [20, 40); the 30-token
# prompt's chunk [16, 24) straddles the boundary, the 35-token one
# prefills a chunk a step (past 4 x 8). Dense, the layout a context
# axis takes, on the unsharded engines too.
CTX_KW = dict(batch_size=3, max_seq_len=40, prefill_chunk=8,
              kv_page_size=0, kv_quant='none', prefix_cache=False)
CTX_PROMPTS = [list(range(5, 35)), [9, 4, 1, 7, 2], list(range(40, 75))]
CTX_NEW = 4
MIG_PROMPT = list(range(9, 36))
MIG_NEW = 6


def _script(prompts, max_new):
    return [('submit', p, max_new) for p in prompts] + [('run',)]


# A request prefilled across both spans and decoded a step, snapshotted
# and aborted; then the unsharded engine's blob of the same request
# restored here, run.
CTX_MIGRATE = [('submit', MIG_PROMPT, MIG_NEW), ('step',), ('step',),
               ('snap', 0), ('abort', 0), ('restore', 'unsharded'),
               ('run',)]

# name -> (model, mesh, engine kwargs, rank 0's script).
SCENARIOS = {
    'fsdp_draft': ('tiny', 'fsdp=2', dict(BASE_KW, batch_size=2,
                                          draft=True, spec_k=3,
                                          spec_fuse_rounds=2),
                   _script(PROMPTS[:2], 8)),
    'moe_fsdp': ('tiny-moe', 'fsdp=2', BASE_KW, _script(PROMPTS, 8)),
    'context': ('tiny', 'context=2', CTX_KW,
                _script(CTX_PROMPTS, CTX_NEW)),
    'context_int8': ('tiny', 'context=2', dict(CTX_KW, kv_quant='int8'),
                     _script(CTX_PROMPTS, CTX_NEW)),
    'context_flash': ('tiny', 'context=2', dict(CTX_KW, use_flash=True),
                      _script(CTX_PROMPTS, CTX_NEW)),
    'context_migrate': ('tiny', 'context=2', dict(CTX_KW, batch_size=2,
                                                  decode_fuse_steps=1),
                        CTX_MIGRATE),
}
SCENARIOS4 = {
    'data_pipe': ('tiny', 'data=2,pipe=2', dict(BASE_KW, kv_page_size=8),
                  _script(PROMPTS, 8)),
    'tensor_context': ('tiny', 'tensor=2,context=2', CTX_KW,
                       _script(CTX_PROMPTS, CTX_NEW)),
}
# Scenario -> the JAX engine's mesh on the 8 CPU devices.
JAX_MESHES = {
    'fsdp_draft': dict(fsdp=2), 'moe_fsdp': dict(fsdp=-1),
    'context': dict(fsdp=4, context=2), 'context_int8': dict(fsdp=4,
                                                             context=2),
    'tensor_context': dict(fsdp=2, context=2, tensor=2),
}


def _free_port():
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _engine(models, spec, mesh=None):
    model, _, kw, _ = spec
    tparams, config = models[model][-2:]
    kw = dict(kw)
    if kw.pop('draft', False):
        kw['draft'] = (tparams, config)
    return port_inference.InferenceEngine(
        tparams, config, mesh=mesh, device=None if mesh else 'cpu', **kw)


def _instrument(engine):
    """Record every finished request and every first-token sample's
    logits of `engine`."""
    seen, logits = {}, []
    finished, sample = engine.finished, engine._sample_host_params

    def recording_finished():
        got = finished()
        seen.update(got)
        return got

    def recording_sample(lg, params):
        logits.append(lg.detach().float().clone().numpy())
        return sample(lg, params)

    engine.finished = recording_finished
    engine._sample_host_params = recording_sample
    return seen, logits


def _row(engine, slot):
    """Slot `slot`'s dense row of every cache leaf on this rank."""
    out = []
    for name in ('k', 'v'):
        leaf = engine.state.cache[name]
        for part in (leaf.values() if isinstance(leaf, dict) else [leaf]):
            out.append(part[:, slot].numpy().copy())
    return out


def run_script(engine, script, seen, blobs):
    """Rank 0's (or an unsharded engine's) script; returns the request
    ids and what it recorded."""
    rids, out = [], {'blobs': []}
    for op in script:
        if op[0] == 'submit':
            rids.append(engine.submit(list(op[1]), port_inference
                                      .SamplingParams(max_new_tokens=op[2])))
        elif op[0] == 'step':
            engine.step()
            seen.update(engine.finished())
        elif op[0] == 'run':
            while engine.has_work:
                engine.step()
                seen.update(engine.finished())
        elif op[0] == 'abort':
            engine.abort(rids[op[1]])
        elif op[0] == 'snap':
            out['blobs'].append(engine.snapshot_request(rids[op[1]]))
        elif op[0] == 'restore':
            path = blobs[op[1]]
            t_end = time.monotonic() + 180
            while not os.path.exists(path + '.done'):
                assert time.monotonic() < t_end, path
                engine.heartbeat()
                time.sleep(0.05)
            with open(path, 'rb') as f:
                rids.append(engine.restore_request(f.read()))
    return rids, out


def _watch_rows(engine, out):
    """Record this rank's dense row of a request when a snapshot gathers
    it and when a restore splices it."""
    snap_kv, restore = engine._snapshot_kv, engine._restore_locked

    def snapshot_kv(i, length):
        out.setdefault('snapped', []).append(_row(engine, i))
        return snap_kv(i, length)

    def restore_locked(header, arrays):
        rid = restore(header, arrays)
        slot = next(i for i, s in enumerate(engine.state.slots)
                    if s is not None and s.request_id == rid)
        out.setdefault('restored', []).append(_row(engine, slot))
        return rid

    engine._snapshot_kv = snapshot_kv
    engine._restore_locked = restore_locked


def rank_main(rank, world, port, models, scenarios, blobs, out):
    os.environ.update(SKYTPU_COORDINATOR_ADDR=f'127.0.0.1:{port}',
                      SKYTPU_NUM_PROCESSES=str(world),
                      SKYTPU_PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    from skypilot_tpu_torch.parallel import control
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    control.TIMEOUT_SECONDS, control.HEARTBEAT_SECONDS = 20.0, 0.25
    results = {}
    try:
        for name, spec in scenarios.items():
            mesh = mesh_lib.mesh_from_env(mesh_lib.MeshSpec.parse(spec[1]),
                                          'cpu')
            engine = _engine(models, spec, mesh)
            seen, logits = _instrument(engine)
            rows = {}
            _watch_rows(engine, rows)
            if rank == 0:
                rids, measured = run_script(engine, spec[3], seen, blobs)
                engine.stop_followers()
            else:
                engine.follow()
                rids, measured = None, {}
            k = engine.state.cache['k']
            results[name] = {
                'rids': rids, 'seen': seen, 'logits': logits,
                'cache_shape': list((k['q'] if isinstance(k, dict)
                                     else k).shape),
                'param_shapes': {key: list(v.shape) for key, v in
                                 engine.params['layers'].items()},
                'embed_shape': list(engine.params['embed'].shape),
                'rows': rows, **measured}
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        import traceback
        results['error'] = f'{type(e).__name__}: {e}\n' + \
            traceback.format_exc()
    out.put((rank, results))
    out.close()
    out.join_thread()
    os._exit(0)


def _start(world, models, scenarios, blobs):
    ctx = multiprocessing.get_context('spawn')
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=rank_main, args=(
        r, world, port, models, scenarios, blobs, out))
        for r in range(world)]
    for p in procs:
        p.start()
    got = []

    def wait():
        if not got:
            try:
                results = dict(out.get(timeout=300) for _ in procs)
            finally:
                for p in procs:
                    p.join(30)
                    if p.is_alive():
                        p.kill()
            got.append([results[r] for r in range(world)])
        return got[0]

    return wait


@pytest.fixture(scope='module')
def models():
    """name -> (JAX params, JAX config, port params, port config)."""
    out = {}
    for name, ref_cfgs, init, key in (
            ('tiny', ref_llama.CONFIGS, ref_llama.init_params, 7),
            ('tiny-moe', ref_moe.CONFIGS, ref_moe.init_params, 3)):
        ref_config = ref_cfgs[name]
        params = init(ref_config, jax.random.key(key))
        config = weights.config_from_dict(dataclasses.asdict(ref_config))
        tparams = weights.from_jax_params(jax.tree.map(np.asarray, params),
                                          config)
        out[name] = (params, ref_config, tparams, config)
    return out


@pytest.fixture(scope='module')
def blobs():
    with tempfile.TemporaryDirectory(prefix='context_serving_') as d:
        yield {'unsharded': os.path.join(d, 'unsharded.blob')}


@pytest.fixture(scope='module')
def gangs(models, blobs):
    port_models = {name: m[2:] for name, m in models.items()}
    return {2: _start(2, port_models, SCENARIOS, blobs),
            4: _start(4, port_models, SCENARIOS4, blobs)}


def _jax_tokens(models, name):
    from skypilot_tpu.parallel import MeshSpec, make_mesh
    model, _, kw, script = {**SCENARIOS, **SCENARIOS4}[name]
    params, ref_config = models[model][:2]
    kw = dict(kw)
    if kw.pop('draft', False):
        kw['draft'] = (params, ref_config)
    spec = MeshSpec(**JAX_MESHES[name])
    devices = jax.devices()
    if -1 not in spec.sizes().values():
        devices = devices[:int(np.prod(list(spec.sizes().values())))]
    engine = ref_inference.InferenceEngine(
        params, ref_config, mesh=make_mesh(spec, devices), **kw)
    rids = [engine.submit(list(op[1]), ref_inference.SamplingParams(
        max_new_tokens=op[2])) for op in script if op[0] == 'submit']
    done = engine.run_to_completion()
    return [done.get(r) for r in rids]


@pytest.fixture(scope='module')
def unsharded(models, gangs, blobs):
    """The port's unsharded engines on every script and the JAX engines
    under their meshes (while the gangs run); the unsharded blob the
    context ranks restore."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        engine = _engine(models, SCENARIOS['context_migrate'])
        rid = engine.submit(list(MIG_PROMPT), port_inference.SamplingParams(
            max_new_tokens=MIG_NEW))
        engine.step()
        engine.step()
        with open(blobs['unsharded'], 'wb') as f:
            f.write(engine.snapshot_request(rid))
        open(blobs['unsharded'] + '.done', 'w').close()
        with concurrent.futures.ThreadPoolExecutor(len(JAX_MESHES)) as pool:
            jobs = {name: pool.submit(_jax_tokens, models, name)
                    for name in JAX_MESHES}
            out = {}
            for name, spec in {**SCENARIOS, **SCENARIOS4}.items():
                if name == 'context_migrate':
                    continue
                engine = _engine(models, spec)
                seen, logits = _instrument(engine)
                rids, _ = run_script(engine, spec[3], seen, blobs)
                out[name] = {'tokens': [seen.get(r) for r in rids],
                             'logits': logits}
            for name, job in jobs.items():
                out[name]['jax'] = job.result()
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.fixture(scope='module')
def ranks(gangs, unsharded):
    return gangs[2]()


@pytest.fixture(scope='module')
def ranks4(gangs, unsharded):
    return gangs[4]()


def _check(results, unsharded, name):
    """Every rank's tokens equal the unsharded engine's, rank 0's
    first-token logits within TOL_LOGITS_REL of its, every rank's logits
    equal rank 0's; returns the tokens."""
    for r in results:
        assert 'error' not in r, r['error']
    want = unsharded[name]['tokens']
    rids = results[0][name]['rids']
    for r in results:
        assert [r[name]['seen'].get(rid) for rid in rids] == want, name
    got_logits = results[0][name]['logits']
    want_logits = unsharded[name]['logits']
    assert len(got_logits) == len(want_logits) > 0
    for a, b in zip(got_logits, want_logits):
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= TOL_LOGITS_REL, (name, err)
    for r in results[1:]:
        for a, b in zip(r[name]['logits'], got_logits):
            np.testing.assert_array_equal(a, b)
    return want


@pytest.mark.parametrize('name', ['fsdp_draft', 'moe_fsdp'])
def test_fsdp_serves_the_jax_engines_tokens_from_half_the_weights(
        models, ranks, unsharded, name):
    tokens = _check(ranks, unsharded, name)
    assert tokens == unsharded[name]['jax']
    model = SCENARIOS[name][0]
    axes = port_eng.llama.logical_axes(models[model][3])['layers']
    full = models[model][2]['layers']
    for r in ranks:
        # Between layers a rank holds half of every embed-cut weight.
        for key, shape in r[name]['param_shapes'].items():
            dim = axes[key].index('embed')
            want = list(full[key].shape)
            want[dim] //= 2
            assert shape == want, (key, shape)
        assert r[name]['embed_shape'][1] * 2 == models[model][3].hidden_size


@pytest.mark.parametrize('name', ['context', 'context_int8',
                                  'context_flash'])
def test_context_serves_the_jax_engines_tokens_from_half_the_cache(
        models, ranks, unsharded, name):
    tokens = _check(ranks, unsharded, name)
    if name in JAX_MESHES:
        assert tokens == unsharded[name]['jax']
    for r in ranks:
        # Each rank's leaf holds its span: 40 positions over 2 ranks.
        assert r[name]['cache_shape'][2] == 20


def test_data_and_pipe_replicate(ranks4, unsharded):
    tokens = _check(ranks4, unsharded, 'data_pipe')
    assert all(t is not None for t in tokens)
    assert [r['data_pipe']['param_shapes'] for r in ranks4[1:]] == \
        [ranks4[0]['data_pipe']['param_shapes']] * 3


def test_tensor_and_context_on_four_ranks(ranks4, unsharded):
    tokens = _check(ranks4, unsharded, 'tensor_context')
    assert tokens == unsharded['tensor_context']['jax']
    for r in ranks4:
        assert r['tensor_context']['cache_shape'][2:4] == [20, 1]


def test_context_snapshot_restores_unsharded_and_back(models, ranks,
                                                      blobs):
    """The snapshot gathers the request's row over the two spans: the
    unsharded engine restores it with the row equal to the spans put
    side by side, and decodes on token for token; the unsharded
    engine's blob restores on the ranks, each span taking its part."""
    for r in ranks:
        assert 'error' not in r, r['error']
    _, _, tparams, config = models['tiny']
    plain = port_inference.InferenceEngine(tparams, config, device='cpu',
                                           **SCENARIOS['context_migrate'][2])
    rid = plain.submit(list(MIG_PROMPT), port_inference.SamplingParams(
        max_new_tokens=MIG_NEW))
    want = plain.run_to_completion()[rid]
    r0 = ranks[0]['context_migrate']
    assert [r0['seen'].get(x) for x in r0['rids']] == [None, want]
    blob = r0['blobs'][0]
    header, arrays = port_eng._snapshot_unpack(blob)
    length = header['length']
    assert arrays['k'].shape[1] == length > 20 and header['layout'] == \
        'dense'
    spans = [r['context_migrate']['rows']['snapped'][0] for r in ranks]
    engine = port_inference.InferenceEngine(
        tparams, config, device='cpu', **SCENARIOS['context_migrate'][2])
    restored = engine.restore_request(blob)
    slot = next(i for i, s in enumerate(engine.state.slots)
                if s is not None and s.request_id == restored)
    for leaf, a, b in zip(_row(engine, slot), *spans):
        whole = np.concatenate([a, b], axis=1)
        np.testing.assert_array_equal(leaf[:, :length], whole[:, :length])
    assert engine.run_to_completion()[restored] == want
    # Back: the unsharded blob's row, cut at the spans' boundary, the
    # rest of each span zero.
    with open(blobs['unsharded'], 'rb') as f:
        u_header, u_arrays = port_eng._snapshot_unpack(f.read())
    n = u_header['length']
    back = [r['context_migrate']['rows']['restored'][0] for r in ranks]
    for name, a, b in zip(('k', 'v'), *back):
        whole = np.concatenate([a, b], axis=1)
        np.testing.assert_array_equal(whole[:, :n], u_arrays[name].numpy())
        assert not whole[:, n:].any()


def test_an_explicit_page_size_with_context_raises_as_the_reference():
    from skypilot_tpu.parallel import MeshSpec, make_mesh
    config = ref_llama.CONFIGS['tiny']
    with pytest.raises(ValueError) as ref:
        ref_inference.init_cache(config, 2, 64, page_size=8, mesh=make_mesh(
            MeshSpec(fsdp=4, context=2)))
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.Mesh(mesh_lib.MeshSpec(fsdp=1, context=2), 0, 2,
                         torch.device('cpu'))
    with pytest.raises(ValueError) as port:
        port_eng.init_cache(llama.CONFIGS['tiny'], 2, 64, page_size=8,
                            device='cpu', mesh=mesh)
    assert str(port.value) == str(ref.value)
    # Without a page size the reference's default there is dense, and
    # the sequence rounds to a multiple of the context degree.
    cache = port_eng.init_cache(llama.CONFIGS['tiny'], 2, 61, pad_to=8,
                                device='cpu', mesh=mesh)
    assert cache['k'].shape[2] == 32


def test_checkpoints_import_runs_as_a_gang(tmp_path):
    import chip_smoke
    from skypilot_tpu_torch.models import gemma
    config = gemma.CONFIGS['tiny-gemma']
    tparams = gemma.init_params(config, torch.Generator().manual_seed(0),
                                torch.device('cpu'))
    chip_smoke.write_hf_checkpoint(tparams, config, str(tmp_path))
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('SKYTPU_')}
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.checkpoints', 'import',
         str(tmp_path), '--device', 'cpu', '--mesh', 'fsdp=2'], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**env, 'PYTHONPATH': REPO, 'OMP_NUM_THREADS': '1',
             'SKYTPU_COORDINATOR_ADDR': f'127.0.0.1:{port}',
             'SKYTPU_NUM_PROCESSES': '2', 'SKYTPU_PROCESS_ID': str(rank)})
        for rank in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    stats = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    for doc in stats:
        assert doc['rc'] == 0 and doc['num_layers'] == config.num_layers
        assert doc['tensors'] > 0


def test_batch_over_fsdp_destroys_its_process_groups(tmp_path):
    """`batch --mesh fsdp=2` as two processes writes what the unsharded
    batch writes, and each rank has destroyed its process groups when
    `batch.main` returns: a gloo group left to the interpreter's teardown
    aborted a finished rank ("terminate called without an active
    exception", ROADMAP Queue 3), now and then."""
    from skypilot_tpu_torch.inference import batch
    reqs = [{'prompt_tokens': p} for p in PROMPTS]
    inp, out = tmp_path / 'in.jsonl', tmp_path / 'out.jsonl'
    inp.write_text(''.join(json.dumps(r) + '\n' for r in reqs))
    flags = ['--model', 'tiny', '--device', 'cpu', '--batch-size', '2',
             '--max-seq-len', '64', '--kv-quant', 'none',
             '--max-new-tokens', '5']
    code = ('import sys; import torch.distributed as dist; '
            'from skypilot_tpu_torch.inference import batch; '
            'batch.main(sys.argv[1:]); '
            'print("groups left:", dist.is_initialized())')
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('SKYTPU_')}
    procs = [subprocess.Popen(
        [sys.executable, '-c', code, '--input', str(inp), '--output',
         str(out), '--mesh', 'fsdp=2', *flags], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**env, 'PYTHONPATH': REPO, 'OMP_NUM_THREADS': '1',
             'SKYTPU_COORDINATOR_ADDR': f'127.0.0.1:{port}',
             'SKYTPU_NUM_PROCESSES': '2', 'SKYTPU_PROCESS_ID': str(rank)})
        for rank in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all('groups left: False' in o for o, _ in outs), outs
    args = batch.build_parser().parse_args(['--input', '-', '--output', '-',
                                            *flags])
    engine = port_inference.build_engine(args.model,
                                         **batch.engine_kwargs(args))
    records = batch.run_batch(engine, reqs, port_inference.SamplingParams(
        max_new_tokens=args.max_new_tokens))
    assert out.read_text() == ''.join(json.dumps(r) + '\n' for r in records)


def _dense_attention(q, k, v, q_pos, k_pos):
    """Causal attention of q [B,T,H,D] at `q_pos` over k/v [B,S,KV,D] at
    `k_pos`, in f64: the function the partials must give."""
    g = q.shape[2] // k.shape[2]
    kk = k.double().repeat_interleave(g, dim=2)
    vv = v.double().repeat_interleave(g, dim=2)
    s = torch.einsum('bthd,bshd->bhts', q.double(), kk) / q.shape[-1] ** 0.5
    mask = q_pos[:, None] >= k_pos[None, :]
    s = torch.where(mask, s, torch.full_like(s, -torch.inf))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    return torch.einsum('bhts,bshd->bthd', p, vv)


def test_kernels_plain_versions_at_a_negative_offset():
    """A span that lies past the chunk's first rows: the kernels' plain
    versions (the wrappers' CPU path) at q_offset - span start give O = 0
    and lse = +inf on every row before the span, and the span's own
    attention after it; an offset past every row masks them all."""
    gen = torch.Generator().manual_seed(0)
    b, t, s, h, kv, d = 2, 24, 16, 4, 2, 16
    q = torch.randn(b, t, h, d, generator=gen)
    k = torch.randn(b, s, kv, d, generator=gen)
    v = torch.randn(b, s, kv, d, generator=gen)
    lo, start = 32, 20                   # the span [32, 48), chunk at 20
    for quant in (False, True):
        if quant:
            kq, vq = port_eng.quantize_kv(k), port_eng.quantize_kv(v)
            o, lse = fa.flash_fwd(q, kq['q'], vq['q'], k_scale=kq['s'],
                                  v_scale=vq['s'], q_offset=start - lo,
                                  block_k=8)
            kd = kq['q'].float() * kq['s'][..., None]
            vd = vq['q'].float() * vq['s'][..., None]
        else:
            o = fa.flash_attention(q, k, v, q_offset=start - lo, block_k=8)
            _, lse = fa.flash_fwd(q, k, v, q_offset=start - lo, block_k=8)
            kd, vd = k, v
        masked = lo - start                  # rows 0..11 see no key
        assert torch.isposinf(lse[:, :, :masked]).all()
        assert torch.isfinite(lse[:, :, masked:]).all()
        assert (o[:, :masked] == 0).all()
        want = _dense_attention(q, kd, vd, start + torch.arange(t),
                                lo + torch.arange(s))
        torch.testing.assert_close(o[:, masked:].double(),
                                   want[:, masked:], rtol=1e-4, atol=1e-4)
    o, lse = fa.flash_fwd(q, k, v, q_offset=-t, block_k=8)
    assert torch.isposinf(lse).all() and (o == 0).all()


def test_merge_of_the_spans_partials_weighs_an_unseen_span_zero():
    """Two spans' partials (the plain K1 at each span's offset) folded by
    `_merge`, in either order, equal attention over the whole cache,
    rows that one span does not see included (its lse is +inf there, and
    the merged lse is finite); a row no span sees keeps O = 0 and lse =
    +inf. A bare logaddexp fold would give the +inf partial the row."""
    gen = torch.Generator().manual_seed(1)
    b, t, s, h, kv, d = 1, 12, 16, 4, 2, 16
    q = torch.randn(b, t, h, d, generator=gen)
    k = torch.randn(b, 2 * s, kv, d, generator=gen)
    v = torch.randn(b, 2 * s, kv, d, generator=gen)
    start = 10                    # rows 0..5 see only the first span
    parts = [fa.flash_fwd(q, k[:, c * s:(c + 1) * s],
                          v[:, c * s:(c + 1) * s],
                          q_offset=start - c * s, block_k=8)
             for c in range(2)]
    assert torch.isposinf(parts[1][1][:, :, :s - start]).all()
    want = _dense_attention(q, k, v, start + torch.arange(t),
                            torch.arange(2 * s))
    for order in (parts, parts[::-1]):
        got, lse = fa._merge(None, None, *order[0])
        got, lse = fa._merge(got, lse, *order[1])
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
        assert torch.isfinite(lse).all()
    assert torch.isposinf(torch.logaddexp(parts[0][1], parts[1][1])[
        :, :, :s - start]).all()
    # A row no span sees: both lse +inf, O = 0.
    inf = torch.full((b, h, t, 1), torch.inf)
    none, none_lse = fa._merge(torch.zeros(b, t, h, d), inf,
                               torch.zeros(b, t, h, d), inf)
    assert (none == 0).all() and torch.isposinf(none_lse).all()
