"""Training under a mesh: the port's step against the reference's.

The reference side is skypilot_tpu's `make_train_step` under the tests'
8 CPU devices as tests/unit/test_llama_train.py builds it
(`MeshSpec(data=1, fsdp=2, context=2, tensor=2)`): under GSPMD its step
is the global step whatever its layout. Its `make_train_state` gives the
initial state, carried across by `weights.from_jax_train_state`; batches
come from numpy with a seed, their masks with zeros. The port side runs
as gloo ranks on the CPU, spawned once per world size for the module
(`_gang`): every rank walks the same scenarios, each on a mesh of its
own, and rank 0 reports.

What is held, f32 on both sides (only the reductions reorder):
- each autograd-aware collective (`parallel/collectives.py`) at world
  2: its forward and its gradient against the unsharded function;
- the port's step at fsdp=2, data=2, tensor=2, context=2 (ring, and
  dense attention over K/V gathered along `context`), fsdp=2 x tensor=2
  and data=2 x context=2 (ring; 4 ranks), and tiny-gemma (tied head,
  post-norms, softcaps) at tensor=2: loss and grad_norm per step and
  every param after 2 steps within TOL (1e-5 relative) of the
  reference's;
- a state saved by `fit` under fsdp=2 resumes under tensor=2 and on one
  device, and its third step equals the reference's uninterrupted one;
- an HF `--checkpoint` imported under fsdp=2 is the one-device import,
  cut;
- a remat layer's recompute, run by a backward outside the caller's
  `use_mesh` (autograd's own thread on CUDA), under the layer's mesh.
"""
import dataclasses
import multiprocessing
import os
import shutil
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as ref_llama
from skypilot_tpu.parallel import MeshSpec, make_mesh, use_mesh
from skypilot_tpu.train import trainer as ref_trainer
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.train import trainer

TOL = 1e-5
STEPS = 2
KW = dict(batch_size=4, seq_len=32, warmup_steps=1, learning_rate=1e-2,
          max_steps=STEPS + 1)
REF_SPEC = MeshSpec(data=1, fsdp=2, context=2, tensor=2)
# (id, model, attention override, port mesh, ranks)
PARITY = [('fsdp2', 'tiny', None, 'fsdp=2', 2),
          ('data2', 'tiny', None, 'data=2,fsdp=1', 2),
          ('tensor2', 'tiny', None, 'fsdp=1,tensor=2', 2),
          ('context2_ring', 'tiny', 'ring', 'fsdp=1,context=2', 2),
          ('gemma_tensor2', 'tiny-gemma', None, 'fsdp=1,tensor=2', 2),
          ('context2_dense', 'tiny', None, 'fsdp=1,context=2', 2),
          ('fsdp2_tensor2', 'tiny', None, 'fsdp=2,tensor=2', 4),
          ('data2_context2_ring', 'tiny', 'ring', 'data=2,context=2', 4)]
COLLECTIVES = ('copy_to', 'reduce_from', 'gather_from', 'gather_weight',
               'shift')
REMAT_SPECS = ('fsdp=2', 'fsdp=1,tensor=2')
TRAIN_PARAMS_SPECS = ('fsdp=2', 'fsdp=1,tensor=2')


def _batches(vocab):
    rng = np.random.default_rng(21)
    out = []
    for i in range(STEPS + 1):
        tokens = rng.integers(0, vocab, (4, 32)).astype(np.int32)
        mask = np.ones((4, 32), np.float32)
        mask[0, 20:] = 0.0
        mask[3, :7] = 0.0
        mask[i % 4, 13] = 0.0
        out.append((tokens, mask))
    return out


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _ref_init(model):
    cfg = ref_trainer.TrainerConfig(model=model, **KW)
    mesh = make_mesh(REF_SPEC)
    return _np(ref_trainer.make_train_state(cfg, mesh))


def _ref_run(model, attention, init, steps):
    """The reference's steps from `init` on the 4-D mesh: (loss,
    grad_norm) per step and the params after each step."""
    cfg = ref_trainer.TrainerConfig(model=model, attention_impl=attention,
                                    **KW)
    mesh = make_mesh(REF_SPEC)
    step = ref_trainer.make_train_step(cfg, mesh)
    state = jax.device_put(jax.tree.map(jnp.asarray, init))
    metrics, params = [], []
    vocab = cfg.model_config().vocab_size
    with use_mesh(mesh):
        for tokens, mask in _batches(vocab)[:steps]:
            state, m = step(state, {'tokens': jnp.asarray(tokens),
                                    'mask': jnp.asarray(mask)})
            metrics.append((float(m['loss']), float(m['grad_norm'])))
            params.append(_np(state['params']))
    return metrics, params


def _free_port():
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


# -- the ranks --------------------------------------------------------------


def _mesh(spec):
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    return mesh_lib.mesh_from_env(mesh_lib.MeshSpec.parse(spec), 'cpu')


def _full_params(state, mesh, cfg):
    """The state's params put back whole (numpy) on rank 0."""
    from skypilot_tpu_torch.train import checkpoints
    full = checkpoints._gather_full(state['params'], mesh,
                                    cfg.model_config())
    return None if full is None else {k: v.numpy() for k, v in full.items()}


def _collective_case(name, mesh):
    """(forward error, gradient error) of one op at world 2 against the
    unsharded function, every rank's inputs drawn from one seed."""
    from skypilot_tpu_torch.parallel import collectives
    group, me, n = mesh.group('fsdp'), mesh.rank, mesh.world_size
    gen = torch.Generator().manual_seed(11)
    xs = [torch.randn(3, 4, generator=gen) for _ in range(n)]
    cs = [torch.randn(3, 4 * n, generator=gen) for _ in range(n)]
    x = (xs[0] if name == 'copy_to' else xs[me]).clone().requires_grad_(True)
    if name == 'copy_to':
        # Column-parallel input: every rank's part of the loss reads x.
        y = collectives.copy_to(x, group)
        want_y, c = xs[0], cs[me][:, :4]
        want_g = sum(c_[:, :4] for c_ in cs)
    elif name == 'reduce_from':
        y = collectives.reduce_from(x, group)
        want_y, c = sum(xs), cs[0][:, :4]
        want_g = c
    elif name == 'gather_from':
        y = collectives.gather_from(x, group, 1)
        want_y, c = torch.cat(xs, 1), cs[0]
        want_g = c[:, 4 * me:4 * me + 4]
    elif name == 'gather_weight':
        y = collectives.gather_weight(x, group, 1)
        want_y, c = torch.cat(xs, 1), cs[me]
        want_g = sum(cs)[:, 4 * me:4 * me + 4]
    else:
        y = collectives.shift(x, group, 1)
        want_y, c = xs[(me - 1) % n], cs[me][:, :4]
        want_g = cs[(me + 1) % n][:, :4]
    (y * c).sum().backward()
    return (float((y.detach() - want_y).abs().max()),
            float((x.grad - want_g).abs().max()))


def _parity(model, attention, spec, init, batches):
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    mesh = _mesh(spec)
    cfg = trainer.TrainerConfig(model=model, attention_impl=attention, **KW)
    state = trainer.shard_state(init, cfg, mesh)
    step = trainer.make_train_step(cfg, mesh)
    cut = trainer.batch_shardings(mesh)
    metrics = []
    for tokens, mask in batches[:STEPS]:
        state, m = step(state, {
            'tokens': cut['tokens'](torch.from_numpy(tokens).long()),
            'mask': cut['mask'](torch.from_numpy(mask))})
        metrics.append((float(m['loss']), float(m['grad_norm'])))
    # Leaves replicated over an axis hold the same bits on every rank.
    from skypilot_tpu_torch.parallel import collectives
    world = mesh.group(mesh_lib.AXIS_ORDER)
    cuts = trainer.tree_leaves(llama.shard_tree(cfg.model_config(), mesh))
    same = True
    for leaf, shard in zip(trainer.tree_leaves(state['params']), cuts):
        if not shard.cuts:
            every = collectives.all_gather(leaf.detach()[None], world, 0)
            same &= bool((every == every[:1]).all())
    return metrics, _full_params(state, mesh, cfg), same


def _resume(spec, ckpt, init, batches, kill):
    """fit at `spec` from `init` (the reference's, given as --checkpoint)
    or the latest step in `ckpt`, the batches the global ones; with
    `kill`, killed after saving step 2. Returns (the last step's loss,
    rank 0's full params after it)."""
    from skypilot_tpu_torch.train import loop
    mesh = _mesh(spec)
    cfg = trainer.TrainerConfig(model='tiny', **KW)

    def batch_fn(i):
        if kill and i == STEPS:
            raise KeyboardInterrupt('killed after the save')
        tokens, mask = batches[i]
        return {'tokens': torch.from_numpy(tokens).long(),
                'mask': torch.from_numpy(mask)}

    try:
        res = loop.fit(cfg, mesh, batch_fn=batch_fn, checkpoint_dir=ckpt,
                       checkpoint_every=STEPS, log_every=1,
                       init_checkpoint=init, log_fn=lambda _: None)
    except KeyboardInterrupt:
        return None, None
    return (float(res['metrics']['loss']),
            _full_params(res['state'], mesh, cfg))


def _hf_case(hf_dir):
    """load_params(mesh=) under fsdp=2 against the one-device import cut
    by this rank's shards; max |a - b| over every leaf."""
    from skypilot_tpu_torch.checkpoints import hf_import
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import sharding
    mesh = _mesh('fsdp=2')
    got, config, _ = hf_import.load_params(hf_dir, mesh=mesh)
    whole, _, _ = hf_import.load_params(hf_dir, device='cpu')
    cuts = sharding.tree_shardings(mesh, llama.param_logical_axes(config))
    want = sharding.tree_map(lambda t, c: c(t), whole, cuts)
    return max(float((a - b).abs().max()) for a, b in zip(
        trainer.tree_leaves(got), trainer.tree_leaves(want)))


def _train_params_case(ckpt, spec):
    """restore_params of a port train checkpoint under `spec` (what
    `fit(init_checkpoint=)` reads) against the one-device read cut by
    this rank's shards: max |a - b| over every leaf, and whether every
    leaf owns only its slice's storage (the cut made on the host, not a
    view of the whole leaf)."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train import checkpoints
    mesh = _mesh(spec)
    config = llama.CONFIGS['tiny']
    got = checkpoints.restore_params(ckpt, config, mesh=mesh)
    whole = checkpoints.restore_params(ckpt, device='cpu')
    cuts = sharding.tree_shardings(mesh, llama.param_logical_axes(config))
    want = sharding.tree_map(lambda t, c: c(t), whole, cuts)
    leaves = trainer.tree_leaves(got)
    owned = all(t.untyped_storage().nbytes() == t.numel() * t.element_size()
                for t in leaves)
    return max(float((a - b).abs().max()) for a, b in zip(
        leaves, trainer.tree_leaves(want))), owned


def _remat_outside(spec):
    """A remat layer is recomputed when the backward runs, which on CUDA
    is autograd's own thread, outside the caller's `use_mesh`: grads
    taken outside the mesh context against grads taken inside it (tiny
    with remat on), max |a - b|."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    mesh = _mesh(spec)
    config = dataclasses.replace(llama.CONFIGS['tiny'], remat=True)
    cfg = trainer.TrainerConfig(model='tiny', **KW)
    params = trainer.make_train_state(cfg, mesh, seed=3)['params']
    cut = trainer.batch_shardings(mesh)
    tokens, mask = _batches(config.vocab_size)[0]
    batch = {'tokens': cut['tokens'](torch.from_numpy(tokens).long()),
             'mask': cut['mask'](torch.from_numpy(mask))}
    leaves = trainer.tree_leaves(params)
    grads = []
    for inside in (False, True):
        with mesh_lib.use_mesh(mesh):
            loss = llama.loss_fn(params, batch, config)
            if inside:
                grads.append(torch.autograd.grad(loss, leaves))
        if not inside:
            grads.append(torch.autograd.grad(loss, leaves))
    return max(float((a - b).abs().max()) for a, b in zip(*grads))


def _gang(rank, world, port, jobs, out):
    os.environ.update(SKYTPU_COORDINATOR_ADDR=f'127.0.0.1:{port}',
                      SKYTPU_NUM_PROCESSES=str(world),
                      SKYTPU_PROCESS_ID=str(rank))
    os.environ.pop('SKYTPU_TORCH_DIST_BACKEND', None)
    torch.set_num_threads(1)
    results = {}
    try:
        for key, kind, args in jobs:
            if kind == 'collective':
                results[key] = _collective_case(args, _mesh('fsdp=2'))
            elif kind == 'parity':
                results[key] = _parity(*args)
            elif kind == 'resume':
                results[key] = _resume(*args)
            elif kind == 'hf':
                results[key] = _hf_case(args)
            elif kind == 'train_params':
                results[key] = _train_params_case(*args)
            elif kind == 'remat':
                results[key] = _remat_outside(args)
            elif kind == 'copy' and rank == 0:
                shutil.copytree(*args)
        out.put((rank, results))
        code = 0
    except BaseException:  # noqa: BLE001 — reported to the test
        import traceback
        out.put((rank, {'error': traceback.format_exc()}))
        code = 1
    # Flush the result, then leave without the interpreter's teardown: a
    # rank whose process groups are torn down after rank 0 (the store's
    # host) has gone can hang or abort (ROADMAP Queue 3).
    out.close()
    out.join_thread()
    os._exit(code)


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
def runs(tmp_path_factory):
    """The reference's trajectories and both gangs' readings."""
    from skypilot_tpu import checkpoints as ref_ckpts
    tmp = tmp_path_factory.mktemp('mesh_train')
    inits = {m: _ref_init(m) for m in ('tiny', 'tiny-gemma')}
    full = {m: weights.from_jax_train_state(init)
            for m, init in inits.items()}
    batches = {m: _batches(ref_trainer.TrainerConfig(model=m)
                           .model_config().vocab_size) for m in inits}
    hf_dir = str(tmp / 'hf')
    ref_ckpts.export_params(inits['tiny']['params'],
                            ref_llama.CONFIGS['tiny'], hf_dir)
    ckpt = str(tmp / 'run')
    jobs = {2: [], 4: []}
    for name in COLLECTIVES:
        jobs[2].append((name, 'collective', name))
    for key, model, attention, spec, world in PARITY:
        jobs[world].append((key, 'parity', (model, attention, spec,
                                            full[model], batches[model])))
    jobs[2] += [
        ('saved', 'resume', ('fsdp=2', ckpt, hf_dir, batches['tiny'],
                             True)),
        ('copy', 'copy', (ckpt, ckpt + '_tensor')),
        ('resumed', 'resume', ('fsdp=1,tensor=2', ckpt + '_tensor', None,
                               batches['tiny'], False)),
        ('hf', 'hf', hf_dir)]
    jobs[2] += [('train_params_' + spec, 'train_params', (ckpt, spec))
                for spec in TRAIN_PARAMS_SPECS]
    jobs[2] += [('remat_' + spec, 'remat', spec) for spec in REMAT_SPECS]
    gangs = {w: _run_gang(w, j) for w, j in jobs.items()}
    ref = {('tiny', None): _ref_run('tiny', None, inits['tiny'], STEPS + 1),
           ('tiny', 'ring'): _ref_run('tiny', 'ring', inits['tiny'], STEPS),
           ('tiny-gemma', None): _ref_run('tiny-gemma', None,
                                          inits['tiny-gemma'], STEPS)}
    ranks = {w: _collect(*g) for w, g in gangs.items()}
    # The same checkpoint resumed on one device, in this process.
    from skypilot_tpu_torch.train import loop
    shutil.copytree(ckpt, ckpt + '_one')
    tokens, mask = batches['tiny'][STEPS]
    res = loop.fit(trainer.TrainerConfig(model='tiny', **KW), 'cpu',
                   batch_fn=lambda i: {
                       'tokens': torch.from_numpy(tokens).long(),
                       'mask': torch.from_numpy(mask)},
                   checkpoint_dir=ckpt + '_one', log_every=1,
                   log_fn=lambda _: None)
    one = (float(res['metrics']['loss']), trainer.tree_map(
        lambda t: t.detach().numpy(), res['state']['params']))
    return {'ref': ref, 'ranks': ranks, 'one_device': one}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


def _params_close(got, want, what):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat:
        keys = [p.key for p in path]
        name = (f'layers.{keys[1]}' if keys[0] == 'layers' else keys[0])
        if keys[0] == 'layers':
            mine = np.stack([got[f'{name}.{i}'] for i in range(
                leaf.shape[0])])
        else:
            mine = got[name]
        _close(mine, np.asarray(leaf), f'{what} {keys}')


@pytest.mark.parametrize('name', COLLECTIVES)
def test_collective_matches_the_unsharded_function(runs, name):
    for rank, res in runs['ranks'][2].items():
        fwd, grad = res[name]
        assert fwd <= 1e-6 and grad <= 1e-6, (rank, name, fwd, grad)


@pytest.mark.parametrize('key,model,attention,spec,world', PARITY,
                         ids=[p[0] for p in PARITY])
def test_mesh_step_matches_reference(runs, key, model, attention, spec,
                                     world):
    metrics, params = runs['ref'][(model, attention)]
    for rank, res in runs['ranks'][world].items():
        got, full, same = res[key]
        assert same, f'rank {rank}: replicated leaves differ across ranks'
        for i, ((loss, norm), (want_loss, want_norm)) in enumerate(
                zip(got, metrics[:STEPS])):
            _close(loss, want_loss, f'rank {rank} step {i + 1} loss')
            _close(norm, want_norm, f'rank {rank} step {i + 1} grad_norm')
    _params_close(runs['ranks'][world][0][key][1], params[STEPS - 1],
                  f'{key} params after {STEPS} steps')


def test_checkpoint_resumes_across_meshes(runs):
    """Saved by fit under fsdp=2 (killed after the save at step 2; the
    reference's params given as --checkpoint, an HF dir), resumed under
    tensor=2 and on one device: the third step equals the reference's
    uninterrupted one."""
    metrics, params = runs['ref'][('tiny', None)]
    ranks = runs['ranks'][2]
    assert ranks[0]['saved'] == (None, None)
    for rank in ranks:
        _close(ranks[rank]['resumed'][0], metrics[STEPS][0],
               f'rank {rank} resumed loss')
    _params_close(ranks[0]['resumed'][1], params[STEPS],
                  'params resumed under tensor=2')
    loss, one = runs['one_device']
    _close(loss, metrics[STEPS][0], 'one-device resumed loss')
    flat = {f'layers.{k}.{i}': v[i] for k, v in one['layers'].items()
            for i in range(v.shape[0])}
    flat.update({k: v for k, v in one.items() if k != 'layers'})
    _params_close(flat, params[STEPS], 'params resumed on one device')


def test_hf_checkpoint_under_fsdp_is_the_one_device_import_cut(runs):
    for rank, res in runs['ranks'][2].items():
        assert res['hf'] == 0.0, rank


@pytest.mark.parametrize('spec', TRAIN_PARAMS_SPECS)
def test_train_checkpoint_params_under_a_mesh_are_the_one_device_read_cut(
        runs, spec):
    """A port train checkpoint's params read under a mesh (the fine-tune
    `--checkpoint` path) are the one-device read, cut, each leaf cut on
    the host so a rank holds no more than its slice."""
    for rank, res in runs['ranks'][2].items():
        diff, owned = res['train_params_' + spec]
        assert diff == 0.0 and owned, (rank, diff, owned)


@pytest.mark.parametrize('spec', REMAT_SPECS)
def test_remat_recomputes_under_the_mesh_outside_its_context(runs, spec):
    """The layer carries its mesh into the remat recompute: grads taken
    outside `use_mesh` (as autograd's CUDA thread takes them) equal
    those taken inside."""
    for rank, res in runs['ranks'][2].items():
        assert res['remat_' + spec] == 0.0, (rank, res['remat_' + spec])
