"""Port parity: skypilot_tpu_torch.ops.attention against skypilot_tpu.ops.

The same inputs, drawn with numpy, go through the JAX reference
`dense_attention` / `_repeat_kv` and the port's, in f32 on the CPU.
Tolerance 1e-5: both sides compute f32 scores and an f32 softmax; only
the summation order differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import attention as ref
from skypilot_tpu_torch.ops import attention as port

TOL = 1e-5


def _inputs(seed, b, sq, skv, h, kv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize('kw', [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=5),
    dict(causal=False, window=4),
    dict(causal=True, softcap=20.0),
    dict(causal=True, q_offset=8),
    dict(causal=True, q_offset=12, kv_offset=4, window=6, softcap=30.0),
], ids=['causal', 'full', 'window', 'window_noncausal', 'softcap',
        'q_offset', 'offsets_window_softcap'])
@pytest.mark.parametrize('heads', [(4, 4), (4, 2)], ids=['mha', 'gqa'])
def test_dense_attention_matches_reference(kw, heads):
    h, kv = heads
    q, k, v = _inputs(0, 2, 12, 20, h, kv, 16)
    want = np.asarray(ref.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), **kw))
    got = port.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_repeat_kv_matches_reference():
    _, k, _ = _inputs(1, 2, 1, 6, 8, 2, 4)
    want = np.asarray(ref._repeat_kv(jnp.asarray(k), 8))
    got = port._repeat_kv(torch.from_numpy(k), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert port._repeat_kv(torch.from_numpy(k), 2).shape == k.shape
