"""Port parity: the rest of serving on a `tensor` or `expert` mesh in
skypilot_tpu_torch: the MoE family over `expert`, over `tensor` and over
both, speculative decode with a draft, request snapshot / restore /
handoff, and the server's /internal routes on a two-process replica.

Ranks are spawned once for the module (a gang of two and one of four)
and join gloo meshes on the CPU from the gang variables, one mesh a
scenario; rank 0 runs each scenario's script, the other ranks
`follow()`. f32 tiny configs throughout, so the tolerance is token
equality and first-token logits within TOL_LOGITS_REL (1e-5) relative
of the port's unsharded engine on the same script:
- tiny-moe at `expert=2`, `tensor=2` and `expert=2,tensor=2` (four
  ranks), equal to the unsharded engine and to the JAX engine under the
  matching `MeshSpec` on the conftest's 8 CPU devices;
- tiny with itself as its draft at `tensor=2`, equal to the JAX sharded
  spec engine (`test_sharded_paged.py::test_sharded_spec_rounds_match_
  unsharded`'s scenario) and to the plain greedy tokens, every round
  accepted;
- migration on the unquantized and the int8 pool: a sharded engine's
  snapshot restored into the same sharded engine, into the port's and
  the JAX package's unsharded engines, and the port's unsharded and the
  JAX sharded engines' snapshots restored into the sharded one, each
  continuing token for token; the blob holds every KV head, and the
  restored pages equal the snapshotted ones byte for byte on every rank
  (tiny-moe at `expert=2,tensor=2` too, where the restore's heads also
  travel along `expert`);
- a planned handoff under the mesh: paused on every rank, exported and
  restored, resumed, and its lease expired by rank 0's clock (counted
  once, on rank 0);
- the server as two `--mesh tensor=2` processes drained mid-stream, the
  migrate frame's blob restored by an unsharded port server, the stream
  continuing token for token.
"""
import base64
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

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
from skypilot_tpu_torch.inference import server as server_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_LOGITS_REL = 1e-5
PROMPTS = [[5, 11, 2, 9], list(range(3, 25)), [7] * 17 + [3, 1]]
BASE_KW = dict(batch_size=3, max_seq_len=64, prefill_chunk=16,
               kv_page_size=8, kv_quant='none', prefix_cache=False)
SPEC_KW = dict(batch_size=2, spec_k=4, spec_fuse_rounds=2)
MIG_KW = dict(decode_fuse_steps=2)
MIG_PROMPT = list(range(9, 28))
MIG_NEW = 12
LEASE_S = 0.3


def _script(prompts, max_new):
    return [('submit', p, max_new) for p in prompts] + [('run',)]


def _migrate_script(sources):
    """Prefill and a decode step, snapshot (every rank's pages read
    around it), abort, restore the blob here, then each of `sources`'
    blobs of the same request (files the parent writes), run."""
    return ([('submit', MIG_PROMPT, MIG_NEW), ('step',), ('step',),
             ('snap', 0), ('abort', 0), ('restore', 'own')]
            + [('restore', name) for name in sources] + [('run',)])


HANDOFF = [('submit', PROMPTS[1], 10, True), ('step',), ('paused',),
           ('step',), ('snap', 0), ('abort', 0), ('restore', 'own'),
           ('submit', PROMPTS[2], 10, True), ('step',), ('resume', 2),
           ('submit', PROMPTS[0], 10, True), ('step',),
           ('idle', LEASE_S + 0.2), ('run',)]

# name -> (model, mesh, engine kwargs over BASE_KW, rank 0's script).
SCENARIOS = {
    'moe_expert': ('tiny-moe', 'expert=2', {}, _script(PROMPTS, 8)),
    'moe_tensor': ('tiny-moe', 'tensor=2', {}, _script(PROMPTS, 8)),
    'spec': ('tiny', 'tensor=2', dict(SPEC_KW, draft=True),
             _script(PROMPTS[:2], 10)),
    'handoff': ('tiny', 'tensor=2', MIG_KW, HANDOFF),
    'migrate_none': ('tiny', 'tensor=2', MIG_KW,
                     _migrate_script(['unsharded_none', 'jax_none'])),
    'migrate_int8': ('tiny', 'tensor=2', dict(MIG_KW, kv_quant='int8'),
                     _migrate_script(['unsharded_int8', 'jax_int8'])),
}
SCENARIOS4 = {
    'moe_expert_tensor': ('tiny-moe', 'expert=2,tensor=2', {},
                          _script(PROMPTS, 8)),
    'moe_migrate': ('tiny-moe', 'expert=2,tensor=2', MIG_KW,
                    _migrate_script(['unsharded_moe'])),
}
TIMEOUT_S, HEARTBEAT_S = 20.0, 0.25


def _pages(engine, slot, n):
    """Slot `slot`'s first `n` pages of both pools on this rank, as numpy
    arrays (raw or int8 codes and scales; f32 configs only)."""
    pages = torch.tensor(engine._slot_pages[slot][:n])
    out = []
    for name in ('k', 'v'):
        leaf = engine.state.cache[name]
        for part in (leaf.values() if isinstance(leaf, dict) else [leaf]):
            out.append(part[:, pages].numpy().copy())
    return out


def _slot_of(engine, rid):
    return next(i for i, s in enumerate(engine.state.slots)
                if s is not None and s.request_id == rid)


def _watch_pages(engine, out):
    """Record, on any rank, the request's pages when a snapshot gathers
    them and when a restore splices them (`out['snapped']`,
    `out['restored']`)."""
    snap_kv, restore = engine._snapshot_kv, engine._restore_locked

    def snapshot_kv(i, length):
        n = -(-length // engine.kv_page_size)
        out.setdefault('snapped', []).append(_pages(engine, i, n))
        return snap_kv(i, length)

    def restore_locked(header, arrays):
        rid = restore(header, arrays)
        if header.get('layout') != 'none':
            n = -(-int(header['length']) // engine.kv_page_size)
            out.setdefault('restored', []).append(
                _pages(engine, _slot_of(engine, rid), n))
        return rid

    engine._snapshot_kv = snapshot_kv
    engine._restore_locked = restore_locked


def _device_only(engine, out):
    """Hold this rank's migration collectives to what an NCCL group takes
    (tensors on the pool's device, never a host copy) on the CPU: while
    the snapshot's gather (`_snapshot_kv`) or the restore's broadcast
    (`_scatter_kv`) runs, the backend reads as NCCL, `Tensor.cpu` and
    `Tensor.numpy` raise, a tensor made without a device lands on
    'meta' (where no collective runs), and each tensor handed to
    `all_gather` or `broadcast` must lie on the pool's device. Counts
    the collectives so checked (`out['device_only']`)."""
    import torch.distributed as dist
    leaf = engine.state.cache['k']
    device = (leaf['q'] if isinstance(leaf, dict) else leaf).device
    out['device_only'] = 0

    def host_copy(*_args, **_kwargs):
        raise AssertionError('a host copy inside a migration collective')

    def on_device(op):
        def call(*args, **kwargs):
            first = args[0] if isinstance(args[0], list) else [args[0]]
            for t in first + [a for a in args[1:2]
                              if isinstance(a, torch.Tensor)]:
                assert t.device == device, (op.__name__, t.device, device)
            out['device_only'] += 1
            return op(*args, **kwargs)
        return call

    def guarded(fn):
        def wrapper(*args, **kwargs):
            saved = (dist.get_backend, dist.all_gather, dist.broadcast,
                     torch.Tensor.cpu, torch.Tensor.numpy,
                     torch.get_default_device())
            dist.get_backend = lambda group=None: 'nccl'
            dist.all_gather = on_device(saved[1])
            dist.broadcast = on_device(saved[2])
            torch.Tensor.cpu = torch.Tensor.numpy = host_copy
            torch.set_default_device('meta')
            try:
                return fn(*args, **kwargs)
            finally:
                (dist.get_backend, dist.all_gather, dist.broadcast,
                 torch.Tensor.cpu, torch.Tensor.numpy) = saved[:5]
                torch.set_default_device(saved[5])
        return wrapper

    engine._snapshot_kv = guarded(engine._snapshot_kv)
    engine._scatter_kv = guarded(engine._scatter_kv)


def run_script(engine, script, seen, blobs):
    """Rank 0's (or an unsharded engine's) script; returns the request
    ids and what it measured. `seen` collects every finished request's
    tokens; `blobs` names the blob files a restore reads."""
    from skypilot_tpu_torch.inference import engine as eng
    rids, out = [], {'blobs': []}
    for op in script:
        if op[0] == 'submit':
            rids.append(engine.submit(
                list(op[1]), eng.SamplingParams(max_new_tokens=op[2]),
                handoff=len(op) > 3 and op[3]))
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
            if engine.handoff_pending():
                engine.mark_handoff_exported(rids[op[1]])
        elif op[0] == 'restore':
            if op[1] == 'own':
                blob = out['blobs'][-1]
            else:
                path = blobs[op[1]]
                t_end = time.monotonic() + 180
                while not os.path.exists(path + '.done'):
                    assert time.monotonic() < t_end, path
                    engine.heartbeat()
                    time.sleep(0.05)
                with open(path, 'rb') as f:
                    blob = f.read()
            rids.append(engine.restore_request(blob))
        elif op[0] == 'paused':
            out['paused'] = engine.handoff_pending()
        elif op[0] == 'resume':
            out['resumed'] = engine.resume_handoff(rids[op[1]])
        elif op[0] == 'idle':
            t_end = time.monotonic() + op[1]
            while time.monotonic() < t_end:
                engine.heartbeat()
                time.sleep(0.05)
    out['fallbacks'] = engine.stats['handoff_fallbacks']
    return rids, out


def _instrument(engine):
    """Record every finished request and every first-token sample's
    logits of `engine` (its followers' own books included)."""
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


def _engine(models, spec, mesh=None):
    """The port's engine of scenario `spec` (unsharded without `mesh`);
    `models` maps a name to (JAX params, JAX config, port params, port
    config), or to the last two alone."""
    model, _, kw, _ = spec
    tparams, config = models[model][-2:]
    kw = dict(kw)
    if kw.pop('draft', False):
        kw['draft'] = (tparams, config)
    return port_inference.InferenceEngine(
        tparams, config, mesh=mesh, device=None if mesh else 'cpu',
        **{**BASE_KW, **kw})


def rank_main(rank, world, port, models, scenarios, blobs, out):
    os.environ.update(SKYTPU_COORDINATOR_ADDR=f'127.0.0.1:{port}',
                      SKYTPU_NUM_PROCESSES=str(world),
                      SKYTPU_PROCESS_ID=str(rank),
                      SKYTPU_HANDOFF_LEASE_SECONDS=str(LEASE_S))
    torch.set_num_threads(1)
    from skypilot_tpu_torch.parallel import control
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    control.TIMEOUT_SECONDS, control.HEARTBEAT_SECONDS = TIMEOUT_S, \
        HEARTBEAT_S
    results = {}
    try:
        for name, spec in scenarios.items():
            mesh = mesh_lib.mesh_from_env(mesh_lib.MeshSpec.parse(spec[1]),
                                          'cpu')
            engine = _engine(models, spec, mesh)
            seen, logits = _instrument(engine)
            pages, guard = {}, {}
            _device_only(engine, guard)
            _watch_pages(engine, pages)
            if rank == 0:
                rids, measured = run_script(engine, spec[3], seen, blobs)
                engine.stop_followers()
            else:
                engine.follow()
                rids, measured = None, {
                    'fallbacks': engine.stats['handoff_fallbacks']}
            k = engine.state.cache['k']
            results[name] = {
                'rids': rids, 'seen': seen, 'logits': logits,
                'kv_heads': (k['q'] if isinstance(k, dict) else k).shape[3],
                'experts': engine.params['layers']['w_gate'].shape[1]
                if spec[0] == 'tiny-moe' else None,
                'draft_heads': None if engine._draft_params is None else
                engine._draft_params['layers']['wq'].shape[2],
                'pages': pages, **guard, **measured}
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        import traceback
        results['error'] = f'{type(e).__name__}: {e}\n' + \
            traceback.format_exc()
    out.put((rank, results))
    out.close()
    out.join_thread()
    os._exit(0)


def _free_port():
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _start(world, models, scenarios, blobs):
    """Start `world` ranks on `scenarios`; returns wait(), their results
    by rank (read once, then kept)."""
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
def blob_dir():
    with tempfile.TemporaryDirectory(prefix='sharded_serving_') as d:
        yield d


def _blob_paths(blob_dir):
    return {name: os.path.join(blob_dir, name + '.blob') for name in (
        'unsharded_none', 'unsharded_int8', 'jax_none', 'jax_int8',
        'unsharded_moe')}


@pytest.fixture(scope='module')
def gangs(models, blob_dir):
    port_models = {name: m[2:] for name, m in models.items()}
    blobs = _blob_paths(blob_dir)
    return {2: _start(2, port_models, SCENARIOS, blobs),
            4: _start(4, port_models, SCENARIOS4, blobs)}


def _write(path, blob):
    with open(path, 'wb') as f:
        f.write(blob)
    open(path + '.done', 'w').close()


def _mig_steps(engine, step, pkg):
    """The migration script's request up to its snapshot: prefill and
    a decode step, then its blob."""
    rid = engine.submit(list(MIG_PROMPT), pkg.SamplingParams(
        max_new_tokens=MIG_NEW))
    step(engine)
    step(engine)
    return engine.snapshot_request(rid)


@pytest.fixture(scope='module')
def unsharded(models, gangs, blob_dir):
    """The port's unsharded engines on every script (while the gangs
    run), and the blobs the ranks restore: the port's unsharded
    snapshots, then the JAX sharded engine's."""
    from skypilot_tpu.parallel import MeshSpec, make_mesh
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    blobs = _blob_paths(blob_dir)
    for quant in ('none', 'int8'):
        engine = _engine(models, ('tiny', None, dict(MIG_KW, kv_quant=quant),
                                  None))
        _write(blobs[f'unsharded_{quant}'], _mig_steps(
            engine, lambda e: e.step(), port_inference))
    engine = _engine(models, ('tiny-moe', None, MIG_KW, None))
    _write(blobs['unsharded_moe'], _mig_steps(engine, lambda e: e.step(),
                                              port_inference))
    params, ref_config = models['tiny'][:2]

    def jax_blob(quant):
        ref = ref_inference.InferenceEngine(
            params, ref_config, mesh=make_mesh(MeshSpec(data=1, fsdp=4,
                                                        tensor=2)),
            **{**BASE_KW, **MIG_KW, 'kv_quant': quant})
        _write(blobs[f'jax_{quant}'], _mig_steps(
            ref, lambda e: e.step(), ref_inference))

    # The JAX engines in threads (their compiles release the GIL), beside
    # the gangs: the blobs the ranks restore, and each scenario's tokens
    # under its mesh.
    with concurrent.futures.ThreadPoolExecutor(len(JAX_MESHES) + 2) as pool:
        blob_jobs = [pool.submit(jax_blob, q) for q in ('none', 'int8')]
        jobs = {name: pool.submit(_jax_tokens, models, *spec)
                for name, spec in JAX_MESHES.items()}
        for job in blob_jobs:
            job.result()
        jax_tokens = {name: job.result() for name, job in jobs.items()}
    out = {}
    lease = os.environ.get('SKYTPU_HANDOFF_LEASE_SECONDS')
    os.environ['SKYTPU_HANDOFF_LEASE_SECONDS'] = str(LEASE_S)
    try:
        for name, spec in {**SCENARIOS, **SCENARIOS4}.items():
            engine = _engine(models, spec)
            seen, logits = _instrument(engine)
            rids, measured = run_script(engine, spec[3], seen, blobs)
            out[name] = {'tokens': [seen.get(r) for r in rids],
                         'logits': logits, 'jax': jax_tokens.get(name),
                         **measured}
    finally:
        if lease is None:
            os.environ.pop('SKYTPU_HANDOFF_LEASE_SECONDS')
        else:
            os.environ['SKYTPU_HANDOFF_LEASE_SECONDS'] = lease
        torch.set_num_threads(threads)
    return out


@pytest.fixture(scope='module')
def ranks(gangs, unsharded):
    return gangs[2]()


@pytest.fixture(scope='module')
def ranks4(gangs, unsharded):
    return gangs[4]()


def _greedy(models, model, prompt, max_new):
    """The plain greedy tokens of `prompt` on the port's unsharded
    engine."""
    engine = _engine(models, (model, None, {}, None))
    rid = engine.submit(list(prompt), port_inference.SamplingParams(
        max_new_tokens=max_new))
    return engine.run_to_completion()[rid]


def _rank_tokens(results, name):
    rids = results[0][name]['rids']
    return [[r[name]['seen'].get(rid) for rid in rids] for r in results]


def _check(results, unsharded, name):
    """Every rank's tokens equal the unsharded engine's on the script,
    rank 0's first-token logits within TOL_LOGITS_REL of its, and every
    rank's logits equal rank 0's."""
    for r in results:
        assert 'error' not in r, r['error']
    want = unsharded[name]['tokens']
    for tokens in _rank_tokens(results, name):
        assert tokens == want, (name, tokens, want)
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


def _jax_tokens(models, model, mesh_kw, script, kw=None):
    """The JAX engine's tokens of `script`'s submits under
    `MeshSpec(**mesh_kw)` (engine kwargs over BASE_KW)."""
    from skypilot_tpu.parallel import MeshSpec, make_mesh
    params, ref_config = models[model][:2]
    engine_kw = {**BASE_KW, **(kw or {})}
    if engine_kw.pop('draft', False):
        engine_kw['draft'] = (params, ref_config)
    ref = ref_inference.InferenceEngine(
        params, ref_config, mesh=make_mesh(MeshSpec(**mesh_kw)),
        **engine_kw)
    rids = [ref.submit(list(p), ref_inference.SamplingParams(
        max_new_tokens=n)) for _, p, n in script[:-1]]
    done = ref.run_to_completion()
    return [done.get(r) for r in rids]


# Scenario -> the JAX engine under the matching mesh on its script:
# (model, MeshSpec kwargs on the 8 CPU devices, script, engine kwargs).
JAX_MESHES = {
    'moe_expert': ('tiny-moe', dict(data=1, fsdp=4, expert=2),
                   SCENARIOS['moe_expert'][3]),
    'moe_tensor': ('tiny-moe', dict(data=1, fsdp=4, tensor=2),
                   SCENARIOS['moe_tensor'][3]),
    'moe_expert_tensor': ('tiny-moe', dict(data=1, fsdp=2, expert=2,
                                           tensor=2),
                          SCENARIOS4['moe_expert_tensor'][3]),
    'spec': ('tiny', dict(data=1, fsdp=4, tensor=2), SCENARIOS['spec'][3],
             dict(SPEC_KW, draft=True)),
}


@pytest.mark.parametrize('name', ['moe_expert', 'moe_tensor'])
def test_moe_on_two_ranks_equals_unsharded_and_the_jax_engine(
        models, ranks, unsharded, name):
    tokens = _check(ranks, unsharded, name)
    config = models['tiny-moe'][3]
    mesh = SCENARIOS[name][1]
    experts = config.num_experts // (2 if 'expert' in mesh else 1)
    heads = config.num_kv_heads // (2 if 'tensor' in mesh else 1)
    assert [r[name]['experts'] for r in ranks] == [experts] * 2
    assert [r[name]['kv_heads'] for r in ranks] == [heads] * 2
    assert tokens == unsharded[name]['jax']


def test_moe_over_expert_and_tensor_on_four_ranks(models, ranks4,
                                                  unsharded):
    name = 'moe_expert_tensor'
    tokens = _check(ranks4, unsharded, name)
    config = models['tiny-moe'][3]
    assert [r[name]['experts'] for r in ranks4] == \
        [config.num_experts // 2] * 4
    assert [r[name]['kv_heads'] for r in ranks4] == \
        [config.num_kv_heads // 2] * 4
    assert tokens == unsharded[name]['jax']


def test_spec_rounds_under_tensor_equal_the_jax_sharded_spec_engine(
        models, ranks, unsharded):
    tokens = _check(ranks, unsharded, 'spec')
    config = models['tiny'][3]
    # The draft is cut as the target: its query heads split two ways.
    assert [r['spec']['draft_heads'] for r in ranks] == \
        [config.num_heads // 2] * 2
    assert tokens == [_greedy(models, 'tiny', p, 10) for p in PROMPTS[:2]]
    assert tokens == unsharded['spec']['jax']


def _check_migration(results, unsharded, name, restores, models,
                     model='tiny'):
    want = _greedy(models, model, MIG_PROMPT, MIG_NEW)
    for r in results:
        assert 'error' not in r, r['error']
    # The request aborted at its snapshot, then each restore of it.
    for tokens in _rank_tokens(results, name):
        assert tokens == [None] + [want] * restores, (name, tokens)
    assert unsharded[name]['tokens'] == [None] + [want] * restores
    # Every rank spliced the bytes it gathered.
    for r in results:
        pages = r[name]['pages']
        assert len(pages['snapped']) == 1
        assert len(pages['restored']) == restores
        for a, b in zip(pages['snapped'][0], pages['restored'][0]):
            np.testing.assert_array_equal(a, b)
    return results[0][name]['blobs'][0], want


@pytest.mark.parametrize('quant', ['none', 'int8'])
def test_migration_between_sharded_and_unsharded_engines(
        models, ranks, unsharded, blob_dir, quant):
    """A sharded snapshot restores on the sharded engine, the port's and
    the JAX package's unsharded ones; the port's unsharded and the JAX
    sharded engines' snapshots restore on the sharded one."""
    name = f'migrate_{quant}'
    blob, want = _check_migration(ranks, unsharded, name, 3, models)
    header, arrays = port_eng._snapshot_unpack(blob)
    config = models['tiny'][3]
    leaves = ('k.q', 'k.s', 'v.q', 'v.s') if quant == 'int8' else ('k', 'v')
    assert sorted(arrays) == sorted(leaves)
    for leaf in leaves:
        assert arrays[leaf].shape[3] == config.num_kv_heads
    # The unsharded engine's blob of the same request: every head within
    # the tolerance (the sharded forward sums f32 partials).
    with open(_blob_paths(blob_dir)[f'unsharded_{quant}'], 'rb') as f:
        u_header, u_arrays = port_eng._snapshot_unpack(f.read())
    assert u_header['generated'] == header['generated']
    for leaf in leaves:
        a, b = arrays[leaf].float(), u_arrays[leaf].float()
        if leaf.endswith('.q'):
            assert (a - b).abs().max() <= 1
        else:
            assert ((a - b).abs().max() / b.abs().max()) <= TOL_LOGITS_REL
    _, _, tparams, config = models['tiny']
    port = port_inference.InferenceEngine(
        tparams, config, device='cpu',
        **{**BASE_KW, **MIG_KW, 'kv_quant': quant})
    ref = ref_inference.InferenceEngine(
        models['tiny'][0], models['tiny'][1],
        **{**BASE_KW, **MIG_KW, 'kv_quant': quant})
    for engine in (port, ref):
        rid = engine.restore_request(blob)
        assert engine.run_to_completion()[rid] == want


def test_moe_migration_over_expert_and_tensor(models, ranks4, unsharded):
    """tiny-moe at expert=2,tensor=2: every rank gathers its tensor
    group's heads and rank 0 packs them; the restore broadcasts the blob
    (the unsharded engine's too) to the four ranks, each keeping its
    heads."""
    blob, want = _check_migration(ranks4, unsharded, 'moe_migrate', 2,
                                  models, 'tiny-moe')
    _, _, tparams, config = models['tiny-moe']
    engine = port_inference.InferenceEngine(
        tparams, config, device='cpu', **{**BASE_KW, **MIG_KW})
    rid = engine.restore_request(blob)
    assert engine.run_to_completion()[rid] == want


@pytest.mark.parametrize('name, restores, leaves', [
    ('migrate_none', 3, 2), ('migrate_int8', 3, 4), ('handoff', 1, 2),
    ('moe_migrate', 2, 2)])
def test_migration_collectives_take_only_the_pools_device_tensors(
        ranks, ranks4, name, restores, leaves):
    """A snapshot, its restores and a handoff's export under a mesh, as an
    NCCL group sees them (`_device_only`): on every rank, one gather a
    snapshot leaf and one broadcast a restored leaf, each on tensors of
    the pool's device and none on a host copy; the scenario's own test
    holds its tokens and pages."""
    results = ranks4 if name in SCENARIOS4 else ranks
    for r in results:
        assert 'error' not in r, r['error']
    assert [r[name]['device_only'] for r in results] == \
        [(1 + restores) * leaves] * len(results)

def test_handoff_pauses_exports_resumes_and_expires_under_the_mesh(
        models, ranks, unsharded):
    """Handoff flags reach the followers, the pause holds on every rank,
    the exported blob restores, a resume and rank 0's lease expiry both
    decode on: tokens equal the unsharded engine's script and the plain
    greedy tokens; the fallback counts once, on rank 0."""
    want = _check(ranks, unsharded, 'handoff')
    r0 = ranks[0]['handoff']
    assert r0['paused'] == [r0['rids'][0]] and r0['resumed'] is True
    assert want == [None, _greedy(models, 'tiny', PROMPTS[1], 10),
                    _greedy(models, 'tiny', PROMPTS[2], 10),
                    _greedy(models, 'tiny', PROMPTS[0], 10)]
    assert [r['handoff']['fallbacks'] for r in ranks] == [1, 0]
    assert unsharded['handoff']['fallbacks'] == 1
    for r in ranks:
        pages = r['handoff']['pages']
        for a, b in zip(pages['snapped'][0], pages['restored'][0]):
            np.testing.assert_array_equal(a, b)


# -- the server as two processes, drained into an unsharded server ----------

SERVER_FLAGS = ['--model', 'tiny', '--device', 'cpu', '--mesh', 'tensor=2',
                '--batch-size', '2', '--max-seq-len', '128',
                '--prefill-chunk', '16', '--kv-page-size', '8',
                '--decode-fuse-steps', '1']
SERVER_KW = dict(device='cpu', seed=0, batch_size=2, max_seq_len=128,
                 prefill_chunk=16, kv_page_size=8, decode_fuse_steps=1)
SERVER_PROMPT = list(range(7, 19))
SERVER_NEW = 100


def _gang_env(port, rank, world=2):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('SKYTPU_')}
    return {**env, 'PYTHONPATH': REPO, 'OMP_NUM_THREADS': '1',
            'SKYTPU_COORDINATOR_ADDR': f'127.0.0.1:{port}',
            'SKYTPU_NUM_PROCESSES': str(world),
            'SKYTPU_PROCESS_ID': str(rank)}


def _request(url, body=None, data=None):
    if body is not None:
        data = json.dumps(body).encode()
    return urllib.request.Request(url, data=data, headers={
        'Content-Type': 'application/json'})


def _call(url, **kw):
    try:
        with urllib.request.urlopen(_request(url, **kw), timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _frames(resp):
    for line in resp:
        line = line.strip()
        if line.startswith(b'data: '):
            yield json.loads(line[len(b'data: '):])


def test_sharded_server_drains_a_stream_into_an_unsharded_server(tmp_path):
    http, gang = _free_port(), _free_port()
    logs = [open(tmp_path / f'rank{r}.log', 'w') for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.inference.server',
         '--port', str(http)] + SERVER_FLAGS, cwd=REPO,
        env=_gang_env(gang, r), stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(2)]
    base = f'http://127.0.0.1:{http}'
    engine = port_inference.build_engine('tiny', **SERVER_KW)
    rid = engine.submit(list(SERVER_PROMPT), port_inference.SamplingParams(
        max_new_tokens=SERVER_NEW))
    want = engine.run_to_completion()[rid]
    holder = {'loop': server_lib.EngineLoop(engine)}
    srv = server_lib.create_server(holder, host='127.0.0.1', port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
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
        resp = urllib.request.urlopen(_request(base + '/generate', body={
            'prompt_tokens': SERVER_PROMPT, 'max_new_tokens': SERVER_NEW,
            'stream': True}), timeout=60)
        got, drained = [], {}
        for frame in _frames(resp):
            if 'token' not in frame:
                break
            got.append(frame['token'])
            if not drained:
                drained['thread'] = threading.Thread(
                    target=lambda: drained.update(doc=_call(
                        base + '/internal/drain?deadline=0', body={})))
                drained['thread'].start()
        resp.close()
        assert 'migrate' in frame, frame
        drained['thread'].join(60)
        status, body = drained['doc']
        assert status == 200 and json.loads(body) == {
            'status': 'drained', 'finished_naturally': False,
            'snapshots': [], 'migrated_streams': 1}
        migrate = frame['migrate']
        assert migrate['sent'] == len(got) < SERVER_NEW
        blob = base64.b64decode(migrate['snapshot'])
        header, arrays = port_eng._snapshot_unpack(blob)
        assert arrays['k'].shape[3] == engine.config.num_kv_heads
        assert _call(base + '/generate', body={
            'prompt_tokens': [1, 2], 'max_new_tokens': 2})[0] == 503
        resp = urllib.request.urlopen(_request(
            f'http://127.0.0.1:{srv.server_address[1]}/internal/restore'
            f"?sent={migrate['sent']}", data=blob), timeout=60)
        rest = []
        for frame in _frames(resp):
            if 'token' not in frame:
                break
            rest.append(frame['token'])
        resp.close()
        assert frame == {'done': True, 'tokens': want}
        assert got + rest == want
        # The drained replica still stops cleanly: its follower exits 0.
        procs[0].terminate()
        assert procs[0].wait(60) == 0 and procs[1].wait(60) == 0
    finally:
        srv.shutdown()
        srv.server_close()
        holder['loop'].stop()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()


# -- batch on a mesh: an MoE over expert (drawn, and from a train
# checkpoint cut on read), a draft over tensor -----------------------------

BATCH_FLAGS = ['--batch-size', '2', '--max-seq-len', '64', '--kv-page-size',
               '8', '--kv-quant', 'none', '--decode-fuse-steps', '2',
               '--max-new-tokens', '5']


@pytest.mark.parametrize('case', ['moe_expert_checkpoint', 'draft_tensor'])
def test_batch_on_a_mesh_equals_the_unsharded_batch(tmp_path, case):
    from skypilot_tpu_torch.inference import batch
    from skypilot_tpu_torch.train import checkpoints as train_ckpts
    from skypilot_tpu_torch.train import trainer
    rng = np.random.default_rng(11)
    reqs = [{'prompt_tokens': [int(t) for t in rng.integers(1, 256, n)]}
            for n in (5, 19, 3, 27)]
    inp, out = tmp_path / 'in.jsonl', tmp_path / 'out.jsonl'
    inp.write_text(''.join(json.dumps(r) + '\n' for r in reqs))
    flags = {'moe_expert_checkpoint': ['--model', 'tiny-moe', '--checkpoint',
                                       str(tmp_path / 'train')],
             'draft_tensor': ['--model', 'tiny', '--draft-model', 'tiny']
             }[case] + BATCH_FLAGS
    mesh = 'tensor=2' if case == 'draft_tensor' else 'expert=2'
    if case == 'moe_expert_checkpoint':
        state = trainer.make_train_state(
            trainer.TrainerConfig(model='tiny-moe'), 'cpu', seed=5)
        train_ckpts.save_train_state(str(tmp_path / 'train'), state, step=3)
    gang = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.inference.batch',
         '--device', 'cpu', '--input', str(inp), '--output', str(out),
         '--mesh', mesh, *flags], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_gang_env(gang, rank))
        for rank in range(2)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], errs
    args = batch.build_parser().parse_args(
        ['--device', 'cpu', '--input', '-', '--output', '-', *flags])
    engine = port_inference.build_engine(args.model,
                                         **batch.engine_kwargs(args))
    assert (engine._draft_params is not None) == (case == 'draft_tensor')
    records = batch.run_batch(engine, reqs, port_inference.SamplingParams(
        max_new_tokens=args.max_new_tokens))
    assert out.read_text() == ''.join(json.dumps(r) + '\n' for r in records)
