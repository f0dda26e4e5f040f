"""Port parity: skypilot_tpu_torch.parallel (mesh and sharding rules)
against skypilot_tpu.parallel, and the cuts each rank keeps.

The spec algebra (aliases, `resolve`, `shape`), `spec_for` (the
reference's PartitionSpec as a tuple), `kv_page_axes` and
`llama.param_logical_axes` are compared case for case with the
reference. The gang variables parse strictly. A tree of params carried
over from the JAX package (`weights.from_jax_params`) is cut by
`tree_shardings` for every rank of tensor 2 and 4, and the slices put
back together give the tree (KV heads replicate at tensor 4 over tiny's
two). Two gloo ranks on the CPU join a mesh from the gang variables and
run the forward's collectives (`llama._row_parallel`, the vocab-parallel
`embed` and `project_logits`) against the unsharded functions, within
1e-5 relative in f32. An HF checkpoint imported under a mesh gives each
rank its slice of the whole import.
"""
import dataclasses
import multiprocessing
import os
import socket

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as ref_llama
from skypilot_tpu.parallel import mesh as ref_mesh
from skypilot_tpu.parallel import sharding as ref_sharding
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.inference import engine as port_eng
from skypilot_tpu_torch.models import gemma, llama, moe, qwen
from skypilot_tpu_torch.parallel import mesh as port_mesh
from skypilot_tpu_torch.parallel import sharding as port_sharding

_GANG = ('SKYTPU_COORDINATOR_ADDR', 'SKYTPU_NUM_PROCESSES',
         'SKYTPU_PROCESS_ID')


def _fake_mesh(tensor, rank):
    """A rank's view of a one-axis tensor mesh, no process group (the
    cuts need none)."""
    return port_mesh.Mesh(port_mesh.MeshSpec(fsdp=1, tensor=tensor),
                          rank, tensor, torch.device('cpu'),
                          tensor_rank=rank)


# -- mesh specs -------------------------------------------------------------

SPEC_CASES = [
    ({'tensor': 2}, 8), ({'tp': 2, 'dp': 2}, 8), ({'fsdp': -1}, 4),
    ({'model': 4, 'sp': 2}, 8), ({'pp': 2, 'zero': -1, 'ep': 1}, 8),
    ({'tensor_parallel': 8}, 8), ({'data': 3}, 8), ({'fsdp': -1,
                                                     'tensor': 3}, 8),
    ({'tp': 2, 'model': 4}, 8), ({'nonsense': 2}, 8),
    ({'fsdp': -1, 'data': -1}, 8),
]


def _outcome(fn):
    try:
        return ('ok', fn())
    except ValueError as e:
        return ('ValueError', type(e).__name__)


@pytest.mark.parametrize('d,n', SPEC_CASES)
def test_mesh_spec_matches_reference(d, n):
    def run(lib):
        spec = lib.MeshSpec.from_dict(d)
        resolved = spec.resolve(n)
        return (spec.sizes(), resolved.sizes(), resolved.shape(),
                resolved.axis_names())
    assert _outcome(lambda: run(port_mesh)) == _outcome(
        lambda: run(ref_mesh))


def test_axes_and_aliases_match_reference():
    assert port_mesh.AXIS_ORDER == ref_mesh.AXIS_ORDER
    assert port_mesh._AXIS_ALIASES == ref_mesh._AXIS_ALIASES
    for name in list(ref_mesh._AXIS_ALIASES) + ['TENSOR', 'data']:
        assert port_mesh.canonical_axis(name) == ref_mesh.canonical_axis(
            name)
    with pytest.raises(ValueError, match='Unknown mesh axis'):
        port_mesh.canonical_axis('rows')
    with pytest.raises(ValueError, match='resolve'):
        port_mesh.MeshSpec().shape()
    # The --mesh argument, split as the reference's build_engine splits it.
    assert port_mesh.MeshSpec.parse('tensor=2,fsdp=1') == \
        port_mesh.MeshSpec(fsdp=1, tensor=2)


# -- logical axes -----------------------------------------------------------

LOGICAL_CASES = [
    ('batch', 'seq', 'embed'), ('embed', 'heads', 'head_dim'),
    ('layers', 'embed', 'kv_heads', 'head_dim'), ('vocab', 'embed'),
    ('embed', 'vocab'), ('layers', 'mlp', 'embed'), ('batch', 'embed'),
    (None, 'expert', 'embed', 'mlp'), ('batch', None, 'unknown'),
    ('embed', 'embed'),
]
RULES = [None, {'batch': 'data', 'embed': ('data', 'fsdp'),
                'heads': ('tensor', 'context')}]


@pytest.mark.parametrize('rules', RULES, ids=['default', 'custom'])
@pytest.mark.parametrize('axes', LOGICAL_CASES)
def test_spec_for_matches_reference(axes, rules):
    assert port_sharding.spec_for(axes, rules) == tuple(
        ref_sharding.spec_for(axes, rules))


def test_rules_match_reference():
    assert port_sharding.DEFAULT_RULES == ref_sharding.DEFAULT_RULES


@pytest.mark.parametrize('ndim,stacked', [(4, False), (3, False), (5, True),
                                          (4, True), (2, False), (6, True)])
def test_kv_page_axes_match_reference(ndim, stacked):
    assert _outcome(lambda: port_sharding.kv_page_axes(ndim, stacked)) == \
        _outcome(lambda: ref_sharding.kv_page_axes(ndim, stacked))


@pytest.mark.parametrize('family,name', [(llama, 'tiny'),
                                         (gemma, 'tiny-gemma'),
                                         (qwen, 'tiny-qwen'),
                                         (llama, 'llama32-3b')])
def test_param_logical_axes_match_reference(family, name):
    """The llama core's axes, with gemma's post-norms, qwen's q/k/v
    biases and a tied head."""
    from skypilot_tpu import models as ref_models
    ref_family, ref_config = ref_models.resolve(name)
    config = family.CONFIGS[name]
    assert family.param_logical_axes(config) == \
        ref_family.param_logical_axes(ref_config)


# -- the gang variables -----------------------------------------------------


def test_gang_variables_parse_strictly(monkeypatch):
    for name in _GANG:
        monkeypatch.delenv(name, raising=False)
    # One process (the defaults), or no coordinator: no process group.
    assert port_mesh.initialize_distributed() is False
    monkeypatch.setenv('SKYTPU_NUM_PROCESSES', '2')
    assert port_mesh.initialize_distributed() is False
    monkeypatch.setenv('SKYTPU_COORDINATOR_ADDR', '127.0.0.1:1')
    for name, value in (('SKYTPU_PROCESS_ID', 'one'),
                        ('SKYTPU_PROCESS_ID', ''),
                        ('SKYTPU_NUM_PROCESSES', '2.5'),
                        ('SKYTPU_NUM_PROCESSES', '')):
        monkeypatch.setenv(name, value)
        with pytest.raises(ValueError, match=name):
            port_mesh.initialize_distributed()
        monkeypatch.setenv(name, '2' if 'NUM' in name else '0')
    monkeypatch.setenv('SKYTPU_PROCESS_ID', '2')
    with pytest.raises(ValueError, match='outside'):
        port_mesh.initialize_distributed()
    assert not torch.distributed.is_initialized()
    # A one-process mesh needs no process group.
    mesh = port_mesh.make_mesh(port_mesh.MeshSpec(), 'cpu')
    assert (mesh.world_size, mesh.tensor_group, mesh.control_group) == (
        1, None, None)
    assert mesh.spec.sizes()['fsdp'] == 1
    assert not torch.distributed.is_initialized()


def test_backend_and_device_choice(monkeypatch):
    monkeypatch.delenv('SKYTPU_TORCH_DIST_BACKEND', raising=False)
    assert port_mesh._backend(torch.device('cpu')) == 'gloo'
    assert port_mesh._backend(torch.device('cuda', 0)) == 'nccl'
    monkeypatch.setenv('SKYTPU_TORCH_DIST_BACKEND', 'gloo')
    assert port_mesh._backend(torch.device('cuda', 0)) == 'gloo'
    assert port_mesh.rank_device(3, 'cpu') == torch.device('cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            port_mesh.rank_device(1)


def test_nccl_two_ranks_on_one_device_raise():
    one_card = [('host', 'cuda:0'), ('host', 'cuda:0')]
    with pytest.raises(RuntimeError, match='NCCL cannot run two ranks on '
                       'one device.*SKYTPU_TORCH_DIST_BACKEND=gloo'):
        port_mesh.check_distinct_devices('nccl', one_card)
    port_mesh.check_distinct_devices('gloo', one_card)
    port_mesh.check_distinct_devices(
        'nccl', [('host', 'cuda:0'), ('host', 'cuda:1'),
                 ('other', 'cuda:0')])


def test_ambient_mesh():
    assert port_mesh.tensor_parallel() is None
    two, one = _fake_mesh(2, 1), _fake_mesh(1, 0)
    with port_mesh.use_mesh(two):
        assert port_mesh.tensor_parallel() is two
        with port_mesh.use_mesh(one):
            assert port_mesh.tensor_parallel() is None
        assert port_mesh.tensor_parallel() is two
    assert port_mesh.tensor_parallel() is None
    with pytest.raises(ValueError, match='needs 2 devices, have 1: .*'
                       'SKYTPU_PROCESS_ID'):
        port_mesh.make_mesh(port_mesh.MeshSpec(fsdp=1, tensor=2), 'cpu')


# -- cuts -------------------------------------------------------------------


@pytest.fixture(scope='module')
def tiny():
    ref_config = ref_llama.CONFIGS['tiny']
    params = ref_llama.init_params(ref_config, jax.random.key(7))
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    return config, weights.from_jax_params(jax.tree.map(np.asarray, params))


def _shard_tree(tree, shardings):
    """Each leaf of `tree` cut by its `Shard` (views)."""
    return port_sharding.tree_map(lambda leaf, shard: shard(leaf), tree,
                                  shardings)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize('tensor', [2, 4])
def test_tree_shardings_put_back_together_give_the_tree(tiny, tensor):
    config, tparams = tiny
    logical = llama.param_logical_axes(config)
    cuts = [_shard_tree(tparams, port_sharding.tree_shardings(
        _fake_mesh(tensor, r), logical)) for r in range(tensor)]
    for path, full in _leaves(tparams):
        axes = _at(logical, path)
        spec = port_sharding.spec_for(axes)
        parts = [_at(c, path) for c in cuts]
        if 'tensor' not in spec:
            for part in parts:
                assert part.data_ptr() == full.data_ptr()
            continue
        dim = spec.index('tensor')
        name = axes[dim]
        if full.shape[dim] < tensor:
            # Replicated KV heads: each rank keeps its query heads' one.
            assert name == 'kv_heads'
            group = tensor // full.shape[dim]
            parts = parts[::group]
        torch.testing.assert_close(torch.cat(parts, dim=dim), full,
                                   rtol=0, atol=0)


def test_indivisible_shapes_raise(tiny):
    config, tparams = tiny
    assert port_sharding.cut(2, 4, 3, 'kv_heads') == (1, 2)
    for n, parts, name in ((5, 2, 'heads'), (3, 2, 'kv_heads'),
                           (2, 4, 'heads'), (6, 4, 'kv_heads'),
                           (255, 2, 'vocab'), (7, 2, 'mlp')):
        with pytest.raises(ValueError, match=f'{name} of size {n} does not '
                           f'split over tensor degree {parts}'):
            port_sharding.cut(n, parts, 0, name)
    odd = dataclasses.replace(config, num_heads=6, num_kv_heads=2)
    with pytest.raises(ValueError, match='heads of size 6'):
        port_eng.check_mesh(_fake_mesh(4, 0), odd)
    port_eng.check_mesh(_fake_mesh(4, 0), config)
    deep = dataclasses.replace(config, num_heads=8, num_kv_heads=8)
    with pytest.raises(ValueError, match='kv_heads of size 8'):
        port_eng.check_mesh(_fake_mesh(3, 0), dataclasses.replace(
            deep, num_heads=9, intermediate_size=129, vocab_size=255))


def test_what_a_mesh_does_not_serve_raises(tiny):
    """Every mesh axis serves (tests/test_torch_context_serving.py): the
    only refusals left are the reference's own, an explicit page size
    with a context axis (init_cache's ValueError, reference
    engine.py:376-391), and `sharding.cut`'s, a hidden size the fsdp
    degree does not divide among them."""
    config, tparams = tiny
    mesh = _fake_mesh(2, 0)
    for spec in (port_mesh.MeshSpec(fsdp=2, tensor=1),
                 port_mesh.MeshSpec(fsdp=1, data=2, tensor=2),
                 port_mesh.MeshSpec(fsdp=1, pipe=2),
                 port_mesh.MeshSpec(fsdp=1, context=2),
                 port_mesh.MeshSpec(fsdp=1, context=2, expert=2)):
        wide = dataclasses.replace(mesh, spec=spec)
        port_eng.check_mesh(wide, config)
        port_eng.check_mesh(wide, moe.CONFIGS['tiny-moe'], config)
    wide = dataclasses.replace(mesh, spec=port_mesh.MeshSpec(fsdp=3))
    for cfg in (config, moe.CONFIGS['tiny-moe']):
        with pytest.raises(ValueError, match='embed of size 64 does not '
                           'split over fsdp degree 3'):
            port_eng.check_mesh(wide, cfg)
    context = dataclasses.replace(
        mesh, spec=port_mesh.MeshSpec(fsdp=1, context=2))
    with pytest.raises(ValueError, match='incompatible with a '
                       'context-sharded cache'):
        port_eng.init_cache(config, 2, 64, page_size=8, device='cpu',
                            mesh=context)


def test_hf_import_places_each_ranks_slice(tmp_path):
    """`load_params(mesh=)` (`_alloc_stacked`/`_place_layer`): each rank
    of tensor 2 gets exactly its cut of the unsharded import (tiny-gemma:
    post-norms and a tied head)."""
    import chip_smoke
    from skypilot_tpu_torch.checkpoints import hf_import
    config = gemma.CONFIGS['tiny-gemma']
    tparams = gemma.init_params(config, torch.Generator().manual_seed(0),
                                torch.device('cpu'))
    chip_smoke.write_hf_checkpoint(tparams, config, str(tmp_path))
    full, got_config, _ = hf_import.load_params(str(tmp_path), device='cpu')
    logical = llama.param_logical_axes(got_config)
    for r in range(2):
        mesh = _fake_mesh(2, r)
        want = _shard_tree(
            full, port_sharding.tree_shardings(mesh, logical))
        got, _, _ = hf_import.load_params(str(tmp_path), mesh=mesh)
        for path, leaf in _leaves(want):
            torch.testing.assert_close(_at(got, path), leaf, rtol=0, atol=0)


# -- two gloo ranks ---------------------------------------------------------


def _free_port():
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _collective_rank(rank, port, tparams, config, out):
    os.environ.update(SKYTPU_COORDINATOR_ADDR=f'127.0.0.1:{port}',
                      SKYTPU_NUM_PROCESSES='2', SKYTPU_PROCESS_ID=str(rank))
    os.environ.pop('SKYTPU_TORCH_DIST_BACKEND', None)
    torch.set_num_threads(1)
    mesh = port_mesh.mesh_from_env(port_mesh.MeshSpec.parse('tensor=2'),
                                   'cpu')
    local = _shard_tree(tparams, port_sharding.tree_shardings(
        mesh, llama.param_logical_axes(config)))
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, config.vocab_size, (2, 5), generator=gen)
    h = torch.randn(2, 5, config.hidden_size, generator=gen)
    act = torch.randn(2, 5, config.intermediate_size, generator=gen)
    attn = torch.randn(2, 5, config.num_heads, config.head_dim,
                       generator=gen)
    lp = llama.layer_params_at(tparams, 0)
    llp = llama.layer_params_at(local, 0)
    want = {'embed': llama.embed(tparams, tokens, config),
            'logits': llama.project_logits(h, tparams, config),
            'down': llama._row_parallel(act, lp['w_down'], 'bsm,me->bse',
                                        config),
            'wo': llama._row_parallel(attn, lp['wo'], 'bshd,hde->bse',
                                      config)}
    heads = config.num_heads // 2
    mine = slice(mesh.tensor_rank * heads, (mesh.tensor_rank + 1) * heads)
    cols = slice(mesh.tensor_rank * config.intermediate_size // 2,
                 (mesh.tensor_rank + 1) * config.intermediate_size // 2)
    with port_mesh.use_mesh(mesh):
        got = {'embed': llama.embed(local, tokens, config),
               'logits': llama.project_logits(h, local, config),
               'down': llama._row_parallel(act[..., cols], llp['w_down'],
                                           'bsm,me->bse', config),
               'wo': llama._row_parallel(attn[:, :, mine], llp['wo'],
                                         'bshd,hde->bse', config)}
    out.put((rank, mesh.backend, mesh.tensor_rank,
             {k: (float((got[k] - want[k]).abs().max()
                        / want[k].abs().max()), tuple(got[k].shape)
                  == tuple(want[k].shape)) for k in want}))
    # Flush the result, then leave without the interpreter's teardown: a
    # rank whose process groups are torn down after rank 0 (the store's
    # host) has gone can hang or abort (ROADMAP Queue 3).
    out.close()
    out.join_thread()
    os._exit(0)


def test_two_gloo_ranks_run_the_forwards_collectives(tiny):
    config, tparams = tiny
    ctx = multiprocessing.get_context('spawn')
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_collective_rank,
                         args=(r, port, tparams, config, out))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        results = sorted(out.get(timeout=120) for _ in procs)
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    for rank, (got_rank, backend, tensor_rank, errs) in enumerate(results):
        assert (got_rank, backend, tensor_rank) == (rank, 'gloo', rank)
        for name, (err, same_shape) in errs.items():
            assert same_shape and err <= 1e-5, (rank, name, err)


def test_training_and_the_checkpoints_cli_keep_one_device(tmp_path):
    """The checkpoints CLI and the trainer take a mesh of several devices
    as one process per device (the CLI's `import --mesh` as a gang:
    tests/test_torch_context_serving.py), so one process asking for two
    raises, naming the gang variables. A one-device mesh is accepted by
    both."""
    from skypilot_tpu_torch.checkpoints import __main__ as cli
    from skypilot_tpu_torch.train import loop
    for run in (lambda: cli.main(['import', str(tmp_path), '--device',
                                  'cpu', '--mesh', 'tensor=2']),
                lambda: loop.main(['--device', 'cpu', '--mesh',
                                   'tensor=2'])):
        with pytest.raises(ValueError, match='one process per device.*'
                           'SKYTPU_PROCESS_ID'):
            run()
    # A one-device mesh passes (the empty directory then fails as a
    # checkpoint, rc 1).
    assert cli.main(['import', str(tmp_path), '--device', 'cpu', '--mesh',
                     'tensor=1,fsdp=-1']) == 1
