"""Port parity: skypilot_tpu_torch.ops.attention against skypilot_tpu.ops.

The same inputs, drawn with numpy, go through the JAX reference
`dense_attention` / `_repeat_kv` / `blockwise_attention` / `attention`
and the port's, in f32 on the CPU. Tolerance 1e-5 on outputs (both sides
compute f32 scores and an f32 softmax; only the summation order
differs) and 2e-4 on grads (tests/unit/test_attention.py's).
"""
import jax
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


TOL_GRAD = 2e-4


def _grads_pair(ref_fn, port_fn, q, k, v, seed=5):
    """Outputs and grads (of sum(out * w), w from numpy) of both sides."""
    w = np.random.default_rng(seed).standard_normal(
        q.shape).astype(np.float32)
    want = np.asarray(ref_fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    want_g = jax.grad(lambda *a: jnp.sum(ref_fn(*a) * jnp.asarray(w)),
                      argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = port_fn(*leaves)
    got_g = torch.autograd.grad(out, leaves, torch.from_numpy(w))
    return out.detach().numpy(), want, got_g, want_g


@pytest.mark.parametrize('kw', [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=5),
    dict(causal=False, window=4),
    dict(causal=True, softcap=20.0),
    dict(causal=True, q_offset=8, kv_offset=2, window=6, softcap=30.0),
], ids=['causal', 'full', 'window', 'window_noncausal', 'softcap',
        'offsets_window_softcap'])
@pytest.mark.parametrize('block', [4, 7, 64])
def test_blockwise_attention_matches_reference(kw, block):
    q, k, v = _inputs(2, 2, 12, 20, 4, 2, 16)
    got, want, got_g, want_g = _grads_pair(
        lambda *a: ref.blockwise_attention(*a, block_size=block, **kw),
        lambda *a: port.blockwise_attention(*a, block_size=block, **kw),
        q, k, v)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL_GRAD,
                                   atol=TOL_GRAD)


@pytest.mark.parametrize('impl,kw', [
    ('dense', dict(causal=True, window=6)),
    ('blockwise', dict(causal=True, softcap=25.0)),
    ('flash', dict(causal=True)),
    ('flash', dict(causal=True, window=9, softcap=25.0)),
    ('flash', dict(causal=False)),
    ('flash', dict(causal=False, window=5)),     # routes to blockwise
], ids=['dense', 'blockwise', 'flash', 'flash_window_softcap',
        'flash_non_causal', 'flash_non_causal_window'])
def test_attention_dispatch_matches_reference(impl, kw):
    q, k, v = _inputs(3, 2, 32, 32, 4, 2, 16)
    got, want, got_g, want_g = _grads_pair(
        lambda *a: ref.attention(*a, impl=impl, block_size=16, **kw),
        lambda *a: port.attention(*a, impl=impl, block_size=16, **kw),
        q, k, v)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL_GRAD,
                                   atol=TOL_GRAD)


def test_attention_routing(monkeypatch):
    from skypilot_tpu_torch.ops import flash_attention as fa
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 1, 16, 16, 4, 2, 16))
    calls = []
    real = fa.flash_attention

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(fa, 'flash_attention', spy)
    port.attention(q, k, v, impl='flash', window=4, softcap=10.0)
    assert calls == [dict(window=4, softcap=10.0)]
    # A non-causal window is the one flash case blockwise takes.
    out = port.attention(q, k, v, causal=False, impl='flash', window=4,
                         block_size=8)
    assert len(calls) == 1
    assert torch.equal(out, port.blockwise_attention(
        q, k, v, causal=False, block_size=8, window=4))
    with pytest.raises(NotImplementedError, match='parallel slice'):
        port.attention(q, k, v, impl='ring')
    with pytest.raises(ValueError, match='Unknown attention impl'):
        port.attention(q, k, v, impl='paged')
