"""Port parity: skypilot_tpu_torch.models.llama against the JAX model.

Weights come from the reference `init_params` (numpy, then
`weights.from_jax_params`), tokens from numpy; both sides run the
`tiny` config in f32 on the CPU. Logits tolerance 1e-4 (f32 through a
few layers; only summation order differs); rope 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as ref
from skypilot_tpu_torch import models as port_models
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.models import llama as port

TOL = 1e-4


def _pair(ref_config):
    params = ref.init_params(ref_config, jax.random.key(3))
    np_params = jax.tree.map(np.asarray, params)
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    return params, config, weights.from_jax_params(np_params)


KNOBS = {
    'llama': {},
    'windowed': dict(sliding_window=5, sliding_window_pattern=2),
    'gemma_like': dict(activation='gelu', tied_embeddings=True,
                       embed_scale=True, norm_plus_one=True,
                       post_norms=True, attn_logit_softcap=20.0,
                       final_logit_softcap=15.0,
                       query_pre_attn_scalar=8.0),
    'qkv_bias_rope_scaled': dict(attn_qkv_bias=True,
                                 rope_scaling_factor=8.0,
                                 rope_scaling_original_max=64),
}


@pytest.mark.parametrize('knobs', list(KNOBS))
def test_forward_matches_reference(knobs):
    ref_config = dataclasses.replace(ref.CONFIGS['tiny'], **KNOBS[knobs])
    params, config, tparams = _pair(ref_config)
    tokens = np.random.default_rng(0).integers(
        0, ref_config.vocab_size, (2, 24)).astype(np.int32)
    want = np.asarray(ref.forward(params, jnp.asarray(tokens), ref_config))
    got = port.forward(tparams, torch.from_numpy(tokens).long(), config)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize('scaling', [None, 8.0, 32.0])
def test_rope_matches_reference(scaling):
    ref_config = dataclasses.replace(
        ref.CONFIGS['tiny'], rope_theta=500000.0,
        rope_scaling_factor=scaling, rope_scaling_original_max=64)
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        port._rope_freqs(16, config).numpy(),
        np.asarray(ref._rope_freqs(16, ref_config)), rtol=1e-6)
    want = np.asarray(ref._rope(jnp.asarray(x), jnp.asarray(pos),
                                ref_config))
    got = port._rope(torch.from_numpy(x), torch.from_numpy(pos), config)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # Halves, not interleaved pairs: position 0 is the identity and the
    # first half rotates against the second.
    x0 = port._rope(torch.from_numpy(x), torch.zeros(9, dtype=torch.long),
                    config)
    np.testing.assert_allclose(x0.numpy(), x, rtol=0, atol=0)


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    for plus_one in (False, True):
        want = np.asarray(ref._rms_norm(jnp.asarray(x), jnp.asarray(w),
                                        1e-5, plus_one))
        got = port._rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5,
                             plus_one)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_layer_windows_match_reference():
    ref_config = dataclasses.replace(ref.CONFIGS['tiny'], num_layers=6,
                                     sliding_window=7,
                                     sliding_window_pattern=3)
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    assert port.layer_windows(config) == [
        int(w) for w in np.asarray(ref.layer_windows(ref_config))]
    assert port.layer_windows(port.CONFIGS['tiny']) == [None, None]


def test_init_params_layout_matches_reference():
    ref_config = dataclasses.replace(ref.CONFIGS['tiny'], post_norms=True,
                                     attn_qkv_bias=True)
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    want = jax.tree.map(lambda a: a.shape,
                        ref.init_params(ref_config, jax.random.key(0)))
    got = port.init_params(config, torch.Generator().manual_seed(0), 'cpu')
    got_shapes = {k: (tuple(v.shape) if not isinstance(v, dict) else
                      {kk: tuple(vv.shape) for kk, vv in v.items()})
                  for k, v in got.items()}
    assert got_shapes == want
    assert got['embed'].dtype == torch.float32


def test_presets_and_resolve():
    assert set(port.CONFIGS) == set(ref.CONFIGS)
    for name, ref_config in ref.CONFIGS.items():
        want = dataclasses.asdict(ref_config)
        got = dataclasses.asdict(port.CONFIGS[name])
        assert weights.dtype_from_name(want.pop('dtype')) == got.pop('dtype')
        assert got == want, name
    family, config = port_models.resolve('llama3-8b')
    assert family is port and config.num_kv_heads == 8
    # The gemma, mistral and qwen families resolve since they were
    # ported (tests/test_torch_families.py); MoE still raises.
    for name in ('gemma2-2b', 'mistral-7b', 'qwen2-7b'):
        assert port_models.resolve(name)[1].vocab_size > 0
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        port_models.resolve('mixtral-8x7b')
    with pytest.raises(ValueError):
        port_models.resolve('no-such-model')


def test_bf16_weights_convert_bit_exactly():
    x = jnp.asarray(np.random.default_rng(4).standard_normal((5, 7)),
                    jnp.bfloat16)
    t = weights.to_tensor(np.asarray(x))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy(),
        np.asarray(x).view(np.int16))
