"""Port parity: skypilot_tpu_torch.models.moe against skypilot_tpu.models.moe.

Weights come from the reference `init_params` (numpy ->
`weights.from_jax_params`), inputs from numpy seeds; tiny-moe runs in f32
on the CPU.

- Presets: field for field (`dataclasses.asdict`), and the three
  param/FLOP counts.
- Routing: given the reference's own router probabilities, `_assign`'s
  dispatch and combine (materialised by `dispatch_combine`) equal the
  reference `_route`'s exactly, at training capacity (a skewed router
  forces drops) and at serving capacity, for tiny-moe (4 experts, top 2)
  and dbrx's routing shape (16, top 4). From the hidden states and the
  router, the dispatch is still exact; the combine weights and the aux
  loss agree within 1e-6 relative, because the router product and `exp`
  of XLA and of ATen differ in the last bit on the CPU (and the aux
  loss's mean over tokens sums in another order).
- `forward`'s logits and aux, `loss_fn` and its gradients (against
  `jax.grad`): 1e-5 relative (of each tensor's largest element), f32.
- `_moe_mlp` (static and grouped) against `_moe_mlp_dense`, the
  reference's one-hot form: 1e-6 relative in f32, with drops.
- bf16: `_moe_mlp` against `_moe_mlp_dense` within TOL_BF16_COMBINE, a
  limit the combine weights left in f32 break (they read 2.7e-3; a sound
  reading is 0.0 here); against the JAX function within two bf16 steps
  (the port's bf16 products round the gate and up projections, which the
  reference keeps in f32), and the forward within 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import moe as ref_moe
from skypilot_tpu_torch import models as port_models
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.train import trainer

TOL_F32 = 1e-5
TOL_ROUTE = 1e-6
TOL_BF16_COMBINE = 1e-3
TOL_BF16_MLP = 1e-2
TOL_BF16_FORWARD = 2e-2


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pair(ref_config, seed=3):
    params = ref_moe.init_params(ref_config, jax.random.key(seed))
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    return params, config, weights.from_jax_params(
        jax.tree.map(np.asarray, params), config)


def test_presets_equal_the_reference_and_resolve():
    assert set(moe.CONFIGS) == set(ref_moe.CONFIGS)
    for name, ref_config in ref_moe.CONFIGS.items():
        config = moe.CONFIGS[name]
        want = dataclasses.asdict(ref_config)
        got = dataclasses.asdict(config)
        assert weights.dtype_from_name(want.pop('dtype')) == got.pop('dtype')
        assert got == want, name
        assert config.num_params() == ref_config.num_params(), name
        assert config.active_params() == ref_config.active_params(), name
        for seq in (512, 4096):
            assert (config.flops_per_token(seq)
                    == ref_config.flops_per_token(seq)), name
        assert port_models.resolve(name) == (moe, config)
        assert weights.config_from_dict(want | {'dtype': 'float32'}) == \
            dataclasses.replace(config, dtype=torch.float32)
    assert moe.CONFIGS['mixtral-8x7b'].attention_impl == 'dense'
    assert moe.CONFIGS['dbrx-moe'].attention_impl == 'flash'
    # 46.7 B params (2.90 GB a layer in bf16), 12.9 B of them active.
    mixtral = moe.CONFIGS['mixtral-8x7b']
    assert round(mixtral.num_params() / 1e9, 1) == 46.7
    assert round(mixtral.active_params() / 1e9, 1) == 12.9


def test_init_params_layout_and_the_f32_router():
    """The port's draw has the reference's leaves, shapes and dtypes (the
    router f32 in a bf16 model); `from_jax_params` and `cast_params` keep
    it f32."""
    ref_config = dataclasses.replace(ref_moe.CONFIGS['tiny-moe'],
                                     dtype=jnp.bfloat16)
    ref_params = ref_moe.init_params(ref_config, jax.random.key(0))
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    params = moe.init_params(config, torch.Generator().manual_seed(0), 'cpu')
    flat_ref = {tuple(k.key for k in path): leaf for path, leaf in
                jax.tree_util.tree_flatten_with_path(ref_params)[0]}
    flat = {}
    for key, value in params.items():
        if isinstance(value, dict):
            flat.update({(key, k): v for k, v in value.items()})
        else:
            flat[(key,)] = value
    assert set(flat) == set(flat_ref) == set(moe.param_shapes(config))
    for path, leaf in flat.items():
        assert tuple(leaf.shape) == flat_ref[path].shape == \
            moe.param_shapes(config)[path], path
        assert leaf.dtype == weights.dtype_from_name(flat_ref[path].dtype)
    assert params['layers']['router'].dtype == torch.float32
    assert params['layers']['w_gate'].dtype == torch.bfloat16
    assert sum(t.numel() for t in trainer.tree_leaves(params)) == \
        config.num_params()
    handed = weights.from_jax_params(jax.tree.map(np.asarray, ref_params),
                                     config)
    assert handed['layers']['router'].dtype == torch.float32
    assert handed['layers']['wq'].dtype == torch.bfloat16
    as_f32 = trainer.tree_map(lambda t: t.float(), handed)
    cast = weights.cast_params(as_f32, config)
    assert cast['layers']['router'].dtype == torch.float32
    assert cast['embed'].dtype == torch.bfloat16


def _routing_inputs(num_experts, seed=0, g=64, e=64):
    """Hidden states and a router skewed towards expert 0 (a constant
    feature times a large weight), so training capacity drops tokens."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((g, e)).astype(np.float32)
    h[:, 0] = 1.0
    router = (rng.standard_normal((e, num_experts)) * 0.3).astype(np.float32)
    router[0, 0] += 3.0
    return h, router


@pytest.mark.parametrize('capacity', ['train', 'serve'])
@pytest.mark.parametrize('experts,top_k', [(4, 2), (16, 4)],
                         ids=['tiny_x4_k2', 'dbrx_x16_k4'])
def test_route_matches_reference(experts, top_k, capacity):
    ref_config = dataclasses.replace(
        ref_moe.CONFIGS['tiny-moe'], num_experts=experts,
        num_experts_per_tok=top_k,
        capacity_factor=1.25 if capacity == 'train' else experts / top_k)
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    h, router = _routing_inputs(experts)
    want_d, want_c, want_aux = ref_moe._route(jnp.asarray(h),
                                              jnp.asarray(router),
                                              ref_config)
    want_d, want_c = np.asarray(want_d), np.asarray(want_c)
    # Given the reference's probabilities, every output is the
    # reference's.
    probs = np.array(jax.nn.softmax(jnp.einsum(
        'ge,ex->gx', jnp.asarray(h), jnp.asarray(router)), axis=-1))
    route = moe._assign(torch.from_numpy(probs), config)
    dispatch, combine = moe.dispatch_combine(route, experts)
    np.testing.assert_array_equal(dispatch.numpy(), want_d)
    np.testing.assert_array_equal(combine.numpy(), want_c)
    np.testing.assert_allclose(float(route.aux_loss), float(want_aux),
                               rtol=TOL_ROUTE)
    dropped = int((~route.keep).sum())
    if capacity == 'train':
        assert dropped > 0                      # the skew overflows expert 0
    else:
        assert dropped == 0 and route.capacity == h.shape[0]
    # From the hidden states and the router.
    route = moe._route(torch.from_numpy(h), torch.from_numpy(router), config)
    dispatch, combine = moe.dispatch_combine(route, experts)
    np.testing.assert_array_equal(dispatch.numpy(), want_d)
    np.testing.assert_allclose(combine.numpy(), want_c, rtol=TOL_ROUTE,
                               atol=TOL_ROUTE)
    np.testing.assert_allclose(float(route.aux_loss), float(want_aux),
                               rtol=TOL_ROUTE)


@pytest.mark.parametrize('capacity', ['train', 'serve'])
def test_moe_mlp_equals_the_one_hot_form(capacity):
    """Both index paths against `_moe_mlp_dense`, with drops at training
    capacity; rows outside `valid` are dropped too."""
    config = dataclasses.replace(
        moe.CONFIGS['tiny-moe'],
        capacity_factor=1.25 if capacity == 'train' else 2.0)
    params = moe.init_params(config, torch.Generator().manual_seed(4), 'cpu')
    lp = llama.layer_params_at(params, 0)
    h, _ = _routing_inputs(4, seed=1)
    lp = {**lp, 'router': lp['router'].clone()}
    lp['router'][0, 0] += 3.0
    h = torch.from_numpy(h).reshape(4, 16, 64)
    want, want_aux = moe._moe_mlp_dense(h, lp, config)
    for mode in ('static', 'grouped', 'auto'):
        got, aux = moe._moe_mlp(h, lp, config, mode=mode)
        assert _rel(got, want) < TOL_ROUTE, mode
        assert float(aux) == float(want_aux)
    valid = torch.ones(4, 16, dtype=torch.bool)
    valid[1, 5:] = False
    for mode in ('static', 'grouped'):
        got, _ = moe._moe_mlp(h, lp, config, mode=mode, valid=valid)
        assert torch.all(got[1, 5:] == 0), mode
        if capacity == 'serve':     # no drops: the valid rows stay as they were
            assert _rel(got[valid], want[valid]) < TOL_ROUTE, mode
    with pytest.raises(ValueError, match='mode'):
        moe._moe_mlp(h, lp, config, mode='ragged')


@pytest.mark.parametrize('mode', ['static', 'grouped'])
def test_forward_matches_reference(mode, monkeypatch):
    monkeypatch.setattr(moe, 'STATIC_ROWS', 10 ** 9 if mode == 'static'
                        else 0)
    ref_config = ref_moe.CONFIGS['tiny-moe']
    params, config, tparams = _pair(ref_config)
    tokens = np.random.default_rng(1).integers(
        0, ref_config.vocab_size, (2, 16)).astype(np.int32)
    want, want_aux = ref_moe.forward(params, jnp.asarray(tokens), ref_config)
    with torch.no_grad():
        got, aux = moe.forward(tparams, torch.from_numpy(tokens).long(),
                               config)
    assert _rel(got.numpy(), want) < TOL_F32
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=TOL_F32)


@pytest.mark.parametrize('impl,remat', [('dense', False), ('flash', True)],
                         ids=['dense', 'flash_remat'])
def test_loss_and_grads_match_jax_grad(impl, remat):
    """loss_fn (cross-entropy + 0.02 aux) and every leaf's gradient; the
    port's flash path runs its plain versions here, remat through
    torch.utils.checkpoint."""
    ref_config = dataclasses.replace(ref_moe.CONFIGS['tiny-moe'],
                                     attention_impl=impl)
    params, config, tparams = _pair(ref_config, seed=5)
    config = dataclasses.replace(config, remat=remat)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, ref_config.vocab_size, (2, 32)).astype(np.int32)
    mask = np.ones((2, 32), np.float32)
    mask[1, 20:] = 0.0
    want_loss, want_grads = jax.value_and_grad(ref_moe.loss_fn)(
        params, {'tokens': jnp.asarray(tokens), 'mask': jnp.asarray(mask)},
        ref_config)
    tparams = trainer.tree_map(lambda t: t.requires_grad_(True), tparams)
    loss = moe.loss_fn(tparams, {'tokens': torch.from_numpy(tokens).long(),
                                 'mask': torch.from_numpy(mask)}, config)
    grads = torch.autograd.grad(loss, trainer.tree_leaves(tparams))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=TOL_F32)
    flat = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    assert len(flat) == len(grads)
    for (path, want), got in zip(flat, grads):
        assert _rel(got.numpy(), want) < TOL_F32, path


def test_bf16_combine_casts_like_the_reference(monkeypatch):
    ref_config = dataclasses.replace(ref_moe.CONFIGS['tiny-moe'],
                                     dtype=jnp.bfloat16)
    params, config, tparams = _pair(ref_config)
    lp_ref = jax.tree.map(lambda a: a[0], params['layers'])
    lp = llama.layer_params_at(tparams, 0)
    rng = np.random.default_rng(0)
    h_ref = jnp.asarray(rng.standard_normal((4, 16, 64)),
                        jnp.float32).astype(jnp.bfloat16)
    h = weights.to_tensor(np.asarray(h_ref))
    dense, _ = moe._moe_mlp_dense(h, lp, config)
    got, _ = moe._moe_mlp(h, lp, config)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), dense.float()) < TOL_BF16_COMBINE
    want, _ = ref_moe._moe_mlp(h_ref, lp_ref, ref_config)
    assert _rel(got.float(), np.asarray(want, np.float32)) < TOL_BF16_MLP

    def combine_f32(outputs, route, cfg):
        w = route.gates * route.keep
        return (outputs.float() * w[..., None]).sum(1).to(cfg.dtype)

    monkeypatch.setattr(moe, '_combine', combine_f32)
    bad, _ = moe._moe_mlp(h, lp, config)
    assert _rel(bad.float(), dense.float()) >= TOL_BF16_COMBINE
    monkeypatch.undo()

    tokens = rng.integers(0, 256, (2, 16)).astype(np.int32)
    want, want_aux = ref_moe.forward(params, jnp.asarray(tokens), ref_config)
    with torch.no_grad():
        logits, aux = moe.forward(tparams, torch.from_numpy(tokens).long(),
                                  config)
    assert _rel(logits.numpy(), want) < TOL_BF16_FORWARD
    np.testing.assert_allclose(float(aux), float(want_aux),
                               rtol=TOL_BF16_FORWARD)
