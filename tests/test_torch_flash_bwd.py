"""Port parity: the flash backward's plain version and autograd path.

`flash_attention_bwd_plain` (the CPU path of the port's K3 and K4, and
the oracle the CUDA kernels are held to on the card) against the
reference `_flash_bwd_impl(..., interpret=True)`, which runs the Pallas
`_dq_kernel` / `_dkv_kernel` in interpret mode on the CPU, on the O and
lse of the reference forward. Then `torch.autograd` through the port's
`flash_attention` (`_FlashFn`) against `jax.grad` of the reference's.
Inputs are numpy draws in f32 at the reference tests' size (B2, S64, H4,
KV2, D16, blocks 16); tolerance 2e-4 on grads, as
tests/unit/test_attention.py uses (both sides run the same recurrence in
f32, in another summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import flash_attention as ref
from skypilot_tpu_torch.ops import flash_attention as fa

TOL = 2e-4


def _inputs(seed, b=2, sq=64, skv=64, h=4, kv=2, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, do


# (causal, sq, skv, window, softcap, q_offset)
CASES = {
    'causal': (True, 64, 64, None, None, None),
    'non_causal': (False, 64, 64, None, None, None),
    'window_8': (True, 64, 64, 8, None, None),
    'window_24': (True, 64, 64, 24, None, None),
    'softcap_20': (True, 64, 64, None, 20.0, None),
    'window_softcap': (True, 64, 64, 24, 20.0, None),
    'non_causal_softcap': (False, 64, 64, None, 20.0, None),
    'q_offset': (True, 32, 64, None, None, 32),
    'q_offset_window_softcap': (True, 32, 64, 12, 20.0, 32),
}


@pytest.mark.parametrize('case', list(CASES))
def test_plain_backward_matches_reference(case):
    causal, sq, skv, window, softcap, off = CASES[case]
    q, k, v, do = _inputs(11, sq=sq, skv=skv)
    scalars = jnp.array([window or 0, off or 0], jnp.int32)
    flags = dict(causal=causal, windowed=window is not None, block_q=16,
                 block_k=16, softcap=softcap, interpret=True,
                 offset_mode=off is not None)
    o, lse = ref._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), scalars, **flags)
    want = ref._flash_bwd_impl(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), o, lse, jnp.asarray(do),
                               scalars, **flags)
    t = torch.from_numpy
    got = fa.flash_attention_bwd_plain(
        t(q), t(k), t(v), t(np.asarray(o)), t(np.asarray(lse)), t(do),
        causal=causal, block_q=16, block_k=16, window=window,
        softcap=softcap, q_offset=off)
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize('case', ['causal', 'non_causal', 'window_softcap',
                                  'q_offset'])
def test_autograd_grads_match_jax_grad(case):
    causal, sq, skv, window, softcap, off = CASES[case]
    q, k, v, do = _inputs(12, sq=sq, skv=skv)
    kw = dict(causal=causal, block_q=16, block_k=16, softcap=softcap)

    def ref_loss(q_, k_, v_):
        out = ref.flash_attention(
            q_, k_, v_, window=None if window is None else jnp.int32(window),
            q_offset=None if off is None else jnp.int32(off), **kw)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*leaves, window=window, q_offset=off, **kw)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_rows_with_no_visible_key_give_zero_grads():
    """lse = +inf rows (window past the end of the cache) give P = 0:
    their dQ is 0 and they add nothing to dK/dV."""
    q, k, v, do = _inputs(13, sq=16, skv=32)
    t = torch.from_numpy
    kw = dict(causal=True, window=4, q_offset=28, block_k=8)
    o, lse = fa.flash_attention_plain(t(q), t(k), t(v), **kw)
    masked = ~torch.isfinite(lse[0, 0, :, 0])
    assert masked.any() and not masked.all()
    dq, dk, dv = fa.flash_attention_bwd_plain(t(q), t(k), t(v), o, lse,
                                              t(do), **kw)
    assert bool((dq[:, masked] == 0).all())
    # Dropping the masked rows' dO changes nothing.
    do2 = t(do).clone()
    do2[:, masked] = 0
    _, dk2, dv2 = fa.flash_attention_bwd_plain(t(q), t(k), t(v), o, lse,
                                               do2, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_cpu_wrappers_use_the_plain_version_without_launching():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(14, sq=32, skv=32))
    o, lse = fa.flash_fwd(q, k, v, block_k=8)
    delta = fa.bwd_delta(o, do)
    before = (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta, block_k=8)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, block_k=8)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, block_k=8)
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b)
    assert (fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == before
    np.testing.assert_allclose(
        delta.numpy(), np.einsum('bshd,bshd->bhs', do.numpy(), o.numpy()),
        rtol=1e-5, atol=1e-5)
