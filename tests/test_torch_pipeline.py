"""GPipe over `pipe`: the port's `parallel/pipeline.py` against the
reference's `skypilot_tpu/parallel/pipeline.py`.

The JAX side runs the reference's `llama_pipeline_forward` under the
reference test's meshes on the 8 CPU devices (`tests/conftest.py`):
`MeshSpec(data=8 // S, pipe=S)`, the gradient case on a 4-device
submesh, and `MeshSpec(data=2, pipe=2, tensor=2)` for the composed case.
The port side runs as gloo ranks on the CPU, one gang per world size for
the module, one torch thread a rank; weights come from the reference's
`init_params` (`weights.from_jax_params`), tokens from numpy seeds, and
each stage holds only its layers (`sharding.stage_shard`). Held, f32:
- logits at pipe=2 and pipe=4 (tiny with 4 layers, tokens (8, 32)), 4
  microbatches at pipe=2, pipe=1, and pipe=2 x tensor=2 (4 ranks, each
  with its heads, MLP and vocab cut): |a - b| <= TOL (1 + |b|), TOL
  1e-5 (only the reductions' order differs);
- the gradients of (logits**2).mean() at 2 layers, tokens (4, 16),
  pipe=2, against `jax.grad` of the reference's: every leaf within TOL,
  each stage's layers on their stage, and the replicated leaves (the
  embedding, the final norm, the head) bit-equal across the stages;
- a tiny gemma preset (tied embeddings, embed scale, a window on layer
  0, final softcap, norm_plus_one) over pipe=2 against the port's own
  unpipelined `llama.forward`, logits and gradients: the knobs the
  reference's pipeline skips (ROADMAP.md, Queue 3), so the parity cases
  stay on llama configs;
- the uneven splits raise ValueError naming 'layers' or 'microbatches'.
"""
import dataclasses
import multiprocessing
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as ref_llama
from skypilot_tpu.parallel import MeshSpec, make_mesh
from skypilot_tpu.parallel import pipeline as ref_pipeline
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import pipeline
from skypilot_tpu_torch.train import trainer

TOL = 1e-5
# (id, port mesh, ranks, microbatches)
FORWARD = [('pipe2', 'pipe=2,fsdp=1', 2, None),
           ('pipe4', 'pipe=4,fsdp=1', 4, None),
           ('pipe2_mb4', 'pipe=2,fsdp=1', 2, 4),
           ('pipe2_tensor2', 'pipe=2,fsdp=1,tensor=2', 4, None)]
REF_SPECS = {'pipe2': MeshSpec(data=4, pipe=2, fsdp=1),
             'pipe4': MeshSpec(data=2, pipe=4, fsdp=1),
             'pipe2_mb4': MeshSpec(data=4, pipe=2, fsdp=1),
             'pipe2_tensor2': MeshSpec(data=2, pipe=2, fsdp=1, tensor=2)}


def _config(layers):
    return dataclasses.replace(ref_llama.CONFIGS['tiny'], num_layers=layers)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _free_port():
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


# -- the ranks --------------------------------------------------------------


def _mesh(spec):
    return mesh_lib.mesh_from_env(mesh_lib.MeshSpec.parse(spec), 'cpu')


def _stage_params(params, config, mesh, grad=False):
    """This rank's params: each leaf cut by the mesh's rules, the layers
    also to this stage's (`sharding.stage_shard`)."""
    from skypilot_tpu_torch.parallel import sharding
    cuts = llama.shard_tree(config, mesh)

    def cut(leaf, shard):
        return shard(leaf).clone().requires_grad_(grad)
    out = {k: cut(v, cuts[k]) for k, v in params.items() if k != 'layers'}
    out['layers'] = {k: cut(v, sharding.stage_shard(mesh, cuts['layers'][k]))
                     for k, v in params['layers'].items()}
    return out


def _forward_case(spec, params, config, tokens, microbatches):
    """The pipelined logits on this rank (whole over vocab)."""
    mesh = _mesh(spec)
    local = _stage_params(params, config, mesh)
    with torch.no_grad():
        logits = pipeline.llama_pipeline_forward(
            local, torch.from_numpy(tokens).long(), config, mesh,
            num_microbatches=microbatches)
    return logits.numpy()


def _grad_case(spec, params, config, tokens, microbatches=None):
    """(logits, loss, grads) of (logits**2).mean() through the pipeline:
    the layers' gradients this stage's rows, the others whole; and
    whether the replicated leaves' gradients are bit-equal across the
    stages."""
    from skypilot_tpu_torch.parallel import collectives
    mesh = _mesh(spec)
    local = _stage_params(params, config, mesh, grad=True)
    logits = pipeline.llama_pipeline_forward(
        local, torch.from_numpy(tokens).long(), config, mesh,
        num_microbatches=microbatches)
    loss = (logits.float() ** 2).mean()
    leaves = trainer.tree_leaves(local)
    grads = torch.autograd.grad(loss, leaves)
    names = [f'layers.{k}' for k in sorted(local['layers'])] + sorted(
        k for k in local if k != 'layers')
    names = sorted(names)
    out = {n: g.numpy() for n, g in zip(names, grads)}
    same = True
    for n, g in out.items():
        if not n.startswith('layers.'):
            every = collectives.all_gather(torch.from_numpy(g)[None],
                                           mesh.group('pipe'), 0)
            same &= bool((every == every[:1]).all())
    return logits.detach().numpy(), float(loss), out, same, \
        mesh.index('pipe')


def _gang(rank, world, port, jobs, out):
    os.environ.update(SKYTPU_COORDINATOR_ADDR=f'127.0.0.1:{port}',
                      SKYTPU_NUM_PROCESSES=str(world),
                      SKYTPU_PROCESS_ID=str(rank))
    os.environ.pop('SKYTPU_TORCH_DIST_BACKEND', None)
    torch.set_num_threads(1)
    results = {}
    try:
        for key, kind, args in jobs:
            if kind == 'forward':
                results[key] = _forward_case(*args)
            elif kind == 'grad':
                results[key] = _grad_case(*args)
        out.put((rank, results))
    except BaseException as e:  # noqa: BLE001 — reported to the test
        import traceback
        out.put((rank, {'error': traceback.format_exc()}))
        raise SystemExit(1) from e


def _run_gang(world, jobs):
    ctx = multiprocessing.get_context('spawn')
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_gang, args=(r, world, port, jobs, out))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, out


def _collect(procs, out):
    try:
        got = dict(out.get(timeout=600) for _ in procs)
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    for rank, res in got.items():
        assert 'error' not in res, f'rank {rank}: {res["error"]}'
    return got


# -- the module's runs ------------------------------------------------------


@pytest.fixture(scope='module')
def runs():
    """The reference's logits and gradients and both gangs' readings."""
    ref4 = _config(4)
    params4 = ref_llama.init_params(ref4, jax.random.key(0))
    tokens4 = _tokens(1, (8, 32), ref4.vocab_size)
    port4 = weights.config_from_dict(dataclasses.asdict(ref4))
    tparams4 = weights.from_jax_params(_np(params4), port4)
    ref2 = _config(2)
    params2 = ref_llama.init_params(ref2, jax.random.key(0))
    tokens2 = _tokens(2, (4, 16), ref2.vocab_size)
    port2 = weights.config_from_dict(dataclasses.asdict(ref2))
    tparams2 = weights.from_jax_params(_np(params2), port2)
    from skypilot_tpu_torch.models import gemma
    gemma_config = gemma.CONFIGS['tiny-gemma']
    gemma_params = llama.init_params(
        gemma_config, torch.Generator().manual_seed(5), torch.device('cpu'))
    gemma_tokens = _tokens(3, (4, 32), gemma_config.vocab_size)

    jobs = {2: [], 4: []}
    for key, spec, world, mb in FORWARD:
        jobs[world].append((key, 'forward', (spec, tparams4, port4,
                                             tokens4, mb)))
    jobs[2].append(('grad', 'grad', ('pipe=2,fsdp=1', tparams2, port2,
                                     tokens2)))
    jobs[2].append(('gemma', 'grad', ('pipe=2,fsdp=1', gemma_params,
                                      gemma_config, gemma_tokens)))
    gangs = {w: _run_gang(w, j) for w, j in jobs.items()}

    ref = {}
    for key, _spec, _world, mb in FORWARD:
        mesh = make_mesh(REF_SPECS[key])
        ref[key] = np.asarray(ref_pipeline.llama_pipeline_forward(
            params4, jnp.asarray(tokens4), ref4, mesh, num_microbatches=mb))
    mesh = make_mesh(MeshSpec(data=2, pipe=2, fsdp=1),
                     devices=jax.devices()[:4])

    def pipe_loss(p):
        return (ref_pipeline.llama_pipeline_forward(
            p, jnp.asarray(tokens2), ref2, mesh).astype(jnp.float32)
            ** 2).mean()

    ref['grad'] = _np(jax.grad(pipe_loss)(params2))
    ref['pipe1'] = np.asarray(ref_pipeline.llama_pipeline_forward(
        params4, jnp.asarray(tokens4), ref4,
        make_mesh(MeshSpec(data=8, pipe=1, fsdp=1))))
    # The gemma pin's oracle: the port's own unpipelined forward.
    g_params = trainer.tree_map(lambda t: t.clone().requires_grad_(True),
                                gemma_params)
    logits = llama.forward(g_params, torch.from_numpy(gemma_tokens).long(),
                           gemma_config)
    grads = torch.autograd.grad((logits ** 2).mean(),
                                trainer.tree_leaves(g_params))
    names = sorted([f'layers.{k}' for k in g_params['layers']]
                   + [k for k in g_params if k != 'layers'])
    ref['gemma'] = (logits.detach().numpy(),
                    {n: g.numpy() for n, g in zip(names, grads)})
    ranks = {w: _collect(*g) for w, g in gangs.items()}
    return {'ref': ref, 'ranks': ranks, 'one_rank': (tparams4, port4,
                                                     tokens4)}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize('key,spec,world,mb', FORWARD,
                         ids=[f[0] for f in FORWARD])
def test_pipeline_matches_reference(runs, key, spec, world, mb):
    for rank, res in runs['ranks'][world].items():
        _close(res[key], runs['ref'][key], f'{key} rank {rank}')


def test_single_stage_is_the_plain_forward(runs):
    params, config, tokens = runs['one_rank']
    mesh = trainer.placement('cpu')
    with torch.no_grad():
        got = pipeline.llama_pipeline_forward(
            params, torch.from_numpy(tokens).long(), config, mesh)
    _close(got.numpy(), runs['ref']['pipe1'], 'pipe=1')


def _grads_close(got, want, stage, stages, what):
    """The port's stage gradients against whole reference leaves (a
    nested dict of numpy)."""
    for name, g in got.items():
        if name.startswith('layers.'):
            full = want['layers'][name.split('.')[1]]
            per = full.shape[0] // stages
            full = full[stage * per:(stage + 1) * per]
        else:
            full = want[name]
        _close(g, full, f'{what} {name}')


def test_pipeline_gradients_match_jax_grad(runs):
    for rank, res in runs['ranks'][2].items():
        _logits, _loss, grads, same, stage = res['grad']
        assert same, f'rank {rank}: replicated leaves\' gradients differ'
        _grads_close(grads, runs['ref']['grad'], stage, 2, f'rank {rank}')


def test_gemma_knobs_pipelined_equal_the_unpipelined_forward(runs):
    """Tied embeddings, embed scale, per-layer windows, norm_plus_one and
    the final softcap: the pipeline over pipe=2 equals the port's
    `llama.forward`, logits and gradients (the tied embedding's taken on
    every stage from the head and, broadcast from stage 0, from the
    stack's input)."""
    want_logits, want_grads = runs['ref']['gemma']
    nested = {'layers': {}}
    for name, g in want_grads.items():
        if name.startswith('layers.'):
            nested['layers'][name.split('.')[1]] = g
        else:
            nested[name] = g
    for rank, res in runs['ranks'][2].items():
        logits, _loss, grads, same, stage = res['gemma']
        _close(logits, want_logits, f'gemma logits rank {rank}')
        assert same, f'rank {rank}: replicated leaves\' gradients differ'
        _grads_close(grads, nested, stage, 2, f'gemma rank {rank}')


def _fake_mesh(spec):
    """A rank's view of a mesh for the argument checks, which raise
    before any collective runs."""
    spec = mesh_lib.MeshSpec.parse(spec)
    world = int(np.prod(spec.shape()))
    return mesh_lib.Mesh(spec, 0, world, torch.device('cpu'))


def test_uneven_layers_rejected(runs):
    params, config, tokens = runs['one_rank']   # 4 layers % 8 stages
    with pytest.raises(ValueError, match='layers'):
        pipeline.llama_pipeline_forward(
            params, torch.from_numpy(tokens).long(), config,
            _fake_mesh('pipe=8,fsdp=1'))


def test_uneven_microbatches_rejected(runs):
    params, config, tokens = runs['one_rank']
    with pytest.raises(ValueError, match='microbatches'):
        pipeline.llama_pipeline_forward(
            params, torch.from_numpy(tokens).long(), config,
            _fake_mesh('pipe=2,fsdp=1'), num_microbatches=3)
