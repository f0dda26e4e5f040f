"""Expert parallelism and MoE training under a mesh: the port's
`models/moe.py` and trainer against the reference's.

The JAX side runs the reference's `moe.forward(mesh=)` and its
`make_train_step` under the reference test's mesh,
`MeshSpec(data=2, fsdp=1, expert=4)` (tests/unit/test_moe.py), on the 8
CPU devices (`tests/conftest.py`): under GSPMD its results are the
global ones whatever the layout. The port side runs as gloo ranks on the
CPU, one gang per world size for the module, one torch thread a rank;
weights and the initial train state come from the reference
(`weights.from_jax_params`, `from_jax_train_state`), tokens from numpy
seeds. Held, f32 (only the reductions' order differs), within TOL
(1e-5, relative and absolute):
- tiny-moe's logits and aux loss at expert=2 and data=2 x expert=2,
  each rank holding 2 of the 4 experts and the router's columns for
  them;
- the same with `capacity_factor` 0.5 at data=2 x expert=2 and at
  data=2 x context=2, where the capacity binds and the routing is
  global: a data rank routing its own rows alone drops other tokens
  (checked), so the global positions across the data ranks, and across
  the context ranks inside each row, decide the result;
- 2 trainer steps (loss, grad norm, the params after) at data=2 x
  expert=2, expert=2, fsdp=2, tensor=2, context=2 and expert=2 x
  context=2 against the reference's, the replicated leaves bit-equal
  across ranks;
- a dense model replicated over pipe=2 and over expert=2 in the trainer
  against the reference's trainer at `MeshSpec(data=1, pipe=2)`;
- a train checkpoint saved under expert=2 restored on one device equals
  the saved state, and `restore_params(mesh=)` under expert=2 is the
  one-device read cut;
- an expert or layer count the degree does not divide raises.
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

from skypilot_tpu.models import moe as ref_moe
from skypilot_tpu.parallel import MeshSpec, make_mesh, use_mesh
from skypilot_tpu.parallel import sharding as ref_sharding
from skypilot_tpu.train import trainer as ref_trainer
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.train import trainer

TOL = 1e-5
STEPS = 2
KW = dict(batch_size=4, seq_len=32, warmup_steps=1, learning_rate=1e-2,
          max_steps=STEPS + 1)
REF_SPEC = MeshSpec(data=2, fsdp=1, expert=4, tensor=1)
DROP_FACTOR = 0.5
# (id, capacity factor, port mesh, ranks)
FORWARD = [('expert2', None, 'expert=2,fsdp=1', 2),
           ('data2_expert2', None, 'data=2,expert=2,fsdp=1', 4),
           ('data2_expert2_drops', DROP_FACTOR, 'data=2,expert=2,fsdp=1', 4),
           ('data2_context2_drops', DROP_FACTOR, 'data=2,context=2,fsdp=1',
            4)]
# (id, model, port mesh, ranks)
TRAIN = [('moe_data2_expert2', 'tiny-moe', 'data=2,expert=2,fsdp=1', 4),
         ('moe_expert2', 'tiny-moe', 'expert=2,fsdp=1', 2),
         ('moe_fsdp2', 'tiny-moe', 'fsdp=2', 2),
         ('moe_tensor2', 'tiny-moe', 'fsdp=1,tensor=2', 2),
         ('moe_context2', 'tiny-moe', 'fsdp=1,context=2', 2),
         ('moe_expert2_context2', 'tiny-moe', 'expert=2,context=2,fsdp=1',
          4),
         ('dense_pipe2', 'tiny', 'pipe=2,fsdp=1', 2),
         ('dense_expert2', 'tiny', 'expert=2,fsdp=1', 2)]
REF_TRAIN_SPECS = {'tiny-moe': (REF_SPEC, None),
                   'tiny': (MeshSpec(data=1, pipe=2, fsdp=1), 2)}
CKPT_SPEC = 'expert=2,fsdp=1'


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(vocab):
    rng = np.random.default_rng(31)
    out = []
    for i in range(STEPS):
        tokens = rng.integers(0, vocab, (4, 32)).astype(np.int32)
        mask = np.ones((4, 32), np.float32)
        mask[1, 25:] = 0.0
        mask[2, :5] = 0.0
        mask[i % 4, 11] = 0.0
        out.append((tokens, mask))
    return out


def _ref_mesh(model):
    spec, n = REF_TRAIN_SPECS[model]
    return make_mesh(spec, devices=jax.devices()[:n] if n else None)


def _ref_train(model):
    """The reference's initial state and its steps: (loss, grad_norm)
    per step and the params after the last."""
    cfg = ref_trainer.TrainerConfig(model=model, **KW)
    mesh = _ref_mesh(model)
    init = _np(ref_trainer.make_train_state(cfg, mesh))
    step = ref_trainer.make_train_step(cfg, mesh)
    state = jax.device_put(jax.tree.map(jnp.asarray, init))
    metrics = []
    with use_mesh(mesh):
        for tokens, mask in _batches(cfg.model_config().vocab_size):
            state, m = step(state, {'tokens': jnp.asarray(tokens),
                                    'mask': jnp.asarray(mask)})
            metrics.append((float(m['loss']), float(m['grad_norm'])))
    return init, metrics, _np(state['params'])


def _ref_forward(config, params, tokens):
    mesh = make_mesh(REF_SPEC)
    param_sh = ref_sharding.tree_shardings(
        mesh, ref_moe.param_logical_axes(config))
    with use_mesh(mesh):
        sharded = jax.jit(lambda p: p, out_shardings=param_sh)(params)
        logits, aux = jax.jit(lambda p, t: ref_moe.forward(
            p, t, config, mesh=mesh))(sharded, jnp.asarray(tokens))
    return np.asarray(logits), float(aux)


def _free_port():
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


# -- the ranks --------------------------------------------------------------


def _mesh(spec):
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    return mesh_lib.mesh_from_env(mesh_lib.MeshSpec.parse(spec), 'cpu')


def _forward_case(spec, config, params, tokens):
    """This rank's logits (its batch rows) and the aux loss."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import sharding
    mesh = _mesh(spec)
    cuts = llama.shard_tree(config, mesh)
    local = sharding.tree_map(lambda t, c: c(t).clone(), params, cuts)
    cut = sharding.batch_shard(mesh)
    with mesh_lib.use_mesh(mesh), torch.no_grad():
        logits, aux = moe.forward(local, cut(torch.from_numpy(tokens).long()),
                                  config)
    return logits.numpy(), float(aux), cut.place(tokens.shape)


def _full_params(state, mesh, cfg):
    from skypilot_tpu_torch.train import checkpoints
    full = checkpoints._gather_full(state['params'], mesh,
                                    cfg.model_config())
    return None if full is None else {k: v.numpy() for k, v in full.items()}


def _train_case(model, spec, init, batches):
    """2 steps from the reference's state: (loss, grad_norm) per step,
    rank 0's whole params after, and whether the replicated leaves are
    bit-equal across ranks."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import collectives
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    mesh = _mesh(spec)
    cfg = trainer.TrainerConfig(model=model, **KW)
    state = trainer.shard_state(init, cfg, mesh)
    step = trainer.make_train_step(cfg, mesh)
    cut = trainer.batch_shardings(mesh)
    metrics = []
    for tokens, mask in batches:
        state, m = step(state, {
            'tokens': cut['tokens'](torch.from_numpy(tokens).long()),
            'mask': cut['mask'](torch.from_numpy(mask))})
        metrics.append((float(m['loss']), float(m['grad_norm'])))
    world = mesh.group(mesh_lib.AXIS_ORDER)
    cuts = trainer.tree_leaves(llama.shard_tree(cfg.model_config(), mesh))
    same = True
    for leaf, shard in zip(trainer.tree_leaves(state['params']), cuts):
        if not shard.cuts:
            every = collectives.all_gather(leaf.detach()[None], world, 0)
            same &= bool((every == every[:1]).all())
    return metrics, _full_params(state, mesh, cfg), same


def _ckpt_case(spec, init, batches, ckpt):
    """One step under `spec` from the reference's state, saved to `ckpt`
    (step 1); rank 0's whole params, mu and nu as saved."""
    from skypilot_tpu_torch.train import checkpoints
    mesh = _mesh(spec)
    cfg = trainer.TrainerConfig(model='tiny-moe', **KW)
    mcfg = cfg.model_config()
    state = trainer.shard_state(init, cfg, mesh)
    step = trainer.make_train_step(cfg, mesh)
    cut = trainer.batch_shardings(mesh)
    tokens, mask = batches[0]
    state, _ = step(state, {
        'tokens': cut['tokens'](torch.from_numpy(tokens).long()),
        'mask': cut['mask'](torch.from_numpy(mask))})
    checkpoints.save_train_state(ckpt, state, mesh=mesh, config=mcfg)
    saved = {}
    for group, tree in (('params', state['params']),
                        ('mu', state['opt_state']['mu']),
                        ('nu', state['opt_state']['nu'])):
        full = checkpoints._gather_full(tree, mesh, mcfg)
        saved[group] = None if full is None else {
            k: v.numpy() for k, v in full.items()}
    return saved


def _restore_params_case(spec, ckpt):
    """`restore_params(mesh=)` under `spec` against the one-device read
    cut by this rank's shards: max |a - b| over every leaf."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train import checkpoints
    mesh = _mesh(spec)
    config = moe.CONFIGS['tiny-moe']
    got = checkpoints.restore_params(ckpt, config, mesh=mesh)
    whole = checkpoints.restore_params(ckpt, device='cpu')
    cuts = sharding.tree_shardings(mesh, moe.param_logical_axes(config))
    want = sharding.tree_map(lambda t, c: c(t), whole, cuts)
    assert got['layers']['w_gate'].shape[1] == \
        config.num_experts // mesh.shape['expert']
    return max(float((a - b).abs().max()) for a, b in zip(
        trainer.tree_leaves(got), trainer.tree_leaves(want)))


def _gang(rank, world, port, jobs, out):
    os.environ.update(SKYTPU_COORDINATOR_ADDR=f'127.0.0.1:{port}',
                      SKYTPU_NUM_PROCESSES=str(world),
                      SKYTPU_PROCESS_ID=str(rank))
    os.environ.pop('SKYTPU_TORCH_DIST_BACKEND', None)
    torch.set_num_threads(1)
    results = {}
    try:
        for key, kind, args in jobs:
            fn = {'forward': _forward_case, 'train': _train_case,
                  'ckpt': _ckpt_case,
                  'restore_params': _restore_params_case}[kind]
            results[key] = fn(*args)
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
    """The reference's forwards and trajectories and the gangs'
    readings."""
    ckpt = str(tmp_path_factory.mktemp('expert') / 'run')
    ref_config = ref_moe.CONFIGS['tiny-moe']
    params = ref_moe.init_params(ref_config, jax.random.key(3))
    tokens = np.random.default_rng(7).integers(
        0, ref_config.vocab_size, (4, 16)).astype(np.int32)
    configs = {}
    for key, factor, _spec, _world in FORWARD:
        ref_c = (ref_config if factor is None else
                 dataclasses.replace(ref_config, capacity_factor=factor))
        configs[key] = (ref_c, weights.config_from_dict(
            dataclasses.asdict(ref_c)))
    tparams = weights.from_jax_params(_np(params), configs['expert2'][1])
    inits, batches = {}, {}
    jobs = {2: [], 4: []}
    for key, _factor, spec, world in FORWARD:
        jobs[world].append((key, 'forward', (spec, configs[key][1], tparams,
                                             tokens)))
    ref_train = {}
    for model in ('tiny-moe', 'tiny'):
        ref_train[model] = _ref_train(model)
        inits[model] = weights.from_jax_train_state(ref_train[model][0])
        batches[model] = _batches(ref_trainer.TrainerConfig(
            model=model).model_config().vocab_size)
    for key, model, spec, world in TRAIN:
        jobs[world].append((key, 'train', (model, spec, inits[model],
                                           batches[model])))
    jobs[2] += [('ckpt', 'ckpt', (CKPT_SPEC, inits['tiny-moe'],
                                  batches['tiny-moe'], ckpt)),
                ('restore_params', 'restore_params', (CKPT_SPEC, ckpt))]
    gangs = {w: _run_gang(w, j) for w, j in jobs.items()}
    ref = {key: _ref_forward(configs[key][0], params, tokens)
           for key, *_ in FORWARD}
    # A data rank routing its own rows alone (the trap the global
    # positions avoid): the port's one-device forward of rows 0-1.
    with torch.no_grad():
        alone, _ = moe.forward(
            tparams, torch.from_numpy(tokens[:2]).long(),
            configs['data2_expert2_drops'][1])
    ranks = {w: _collect(*g) for w, g in gangs.items()}
    return {'ref': ref, 'ref_train': ref_train, 'ranks': ranks,
            'alone': alone.numpy(), 'ckpt': ckpt}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize('key,factor,spec,world', FORWARD,
                         ids=[f[0] for f in FORWARD])
def test_expert_parallel_forward_matches_reference(runs, key, factor, spec,
                                                   world):
    want_logits, want_aux = runs['ref'][key]
    for rank, res in runs['ranks'][world].items():
        logits, aux, rows = res[key]
        _close(logits, want_logits[rows], f'{key} rank {rank} logits')
        _close(aux, want_aux, f'{key} rank {rank} aux')


def test_capacity_drops_route_over_the_global_batch(runs):
    """At capacity factor 0.5 a data rank routing its rows alone gets
    another answer than the global routing the reference takes (and the
    port matches, above): the case holds the global positions."""
    want, _ = runs['ref']['data2_expert2_drops']
    assert np.abs(runs['alone'] - want[:2]).max() > 1e-2


@pytest.mark.parametrize('key,model,spec,world', TRAIN,
                         ids=[t[0] for t in TRAIN])
def test_mesh_step_matches_reference(runs, key, model, spec, world):
    _init, metrics, params = runs['ref_train'][model]
    for rank, res in runs['ranks'][world].items():
        got, _full, same = res[key]
        assert same, f'rank {rank}: replicated leaves differ across ranks'
        for i, ((loss, norm), (want_loss, want_norm)) in enumerate(
                zip(got, metrics)):
            _close(loss, want_loss, f'{key} rank {rank} step {i + 1} loss')
            _close(norm, want_norm, f'{key} rank {rank} step {i + 1} norm')
    full = runs['ranks'][world][0][key][1]
    for name, leaf in params.items():
        if name == 'layers':
            for sub, stacked in leaf.items():
                mine = np.stack([full[f'layers.{sub}.{i}']
                                 for i in range(stacked.shape[0])])
                _close(mine, stacked, f'{key} params layers.{sub}')
        else:
            _close(full[name], leaf, f'{key} params {name}')


def test_expert_checkpoint_restores_on_one_device(runs):
    """Saved under expert=2 (each rank 2 of the 4 experts), restored into
    a one-device state: every params, mu and nu entry is the saved
    one."""
    from skypilot_tpu_torch.train import checkpoints
    saved = runs['ranks'][2][0]['ckpt']
    cfg = trainer.TrainerConfig(model='tiny-moe', **KW)
    state = checkpoints.restore_train_state(
        runs['ckpt'], trainer.make_train_state(cfg, 'cpu'))
    assert state['step'] == 1 and state['opt_state']['count'] == 1
    for group, tree in (('params', state['params']),
                        ('mu', state['opt_state']['mu']),
                        ('nu', state['opt_state']['nu'])):
        for name, t in checkpoints._flat(tree):
            np.testing.assert_array_equal(t.detach().numpy(),
                                          saved[group][name],
                                          err_msg=f'{group} {name}')


def test_restore_params_cuts_the_experts(runs):
    for rank, res in runs['ranks'][2].items():
        assert res['restore_params'] == 0.0, rank


@pytest.mark.parametrize('what', ['expert', 'layers'])
def test_indivisible_cuts_raise(what):
    """4 experts over expert=3, and 3 layers over pipe=2, raise
    ValueError naming the axis, as any cut the degree does not divide
    (`sharding.cut`)."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import sharding
    spec = mesh_lib.MeshSpec.parse('expert=3,fsdp=1' if what == 'expert'
                                   else 'pipe=2,fsdp=1')
    mesh = mesh_lib.Mesh(spec.resolve(int(np.prod(spec.shape()))), 0,
                         int(np.prod(spec.shape())), torch.device('cpu'))
    if what == 'expert':
        shard = sharding.leaf_shard(
            mesh, moe.param_logical_axes(moe.CONFIGS['tiny-moe'])[
                'layers']['router'])
        shape = (2, 64, 4)
    else:
        shard = sharding.stage_shard(mesh)
        shape = (3, 64)
    with pytest.raises(ValueError, match=f'{what} of size'):
        shard.local_shape(shape)
