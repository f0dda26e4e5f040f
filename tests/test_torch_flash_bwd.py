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

At head_dim 256 (gemma2-2b/9b, whose backward K3/K4 have d 256
instances) the same comparisons run at S64, GQA 4/2, with window +
softcap and q_offset + window + softcap, at the same 2e-4: the longer
f32 sums (256 terms a dot product, against 16) measured at most 5.0e-6
from the reference (the max |dK| gap, window_softcap case). One
module-scoped fixture runs the reference's interpret mode once per case
and serves every test of that case. Then a d 256 tiny-gemma `loss_fn`
(local and global layers, both softcaps, tied embeddings) through
`attention_impl='flash'`, every param's grad against `jax.grad` of the
reference loss.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import gemma as ref_gemma
from skypilot_tpu.models import llama as ref_llama
from skypilot_tpu.ops import flash_attention as ref
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.models import gemma
from skypilot_tpu_torch.ops import flash_attention as fa
from skypilot_tpu_torch.train import trainer

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


# -- head_dim 256 ------------------------------------------------------------

# (causal, sq, skv, window, softcap, q_offset) at d 256, GQA 4/2.
D256_CASES = {
    'window_softcap': (True, 64, 64, 24, 20.0, None),
    'q_offset_window_softcap': (True, 32, 64, 12, 20.0, 32),
}


@pytest.fixture(scope='module')
def d256_runs():
    """Per D256_CASES case: the inputs, and the reference's forward,
    interpret-mode backward and jax.grad of sum(flash(q, k, v) * dO),
    each computed once for the module."""
    runs = {}
    for i, (case, (causal, sq, skv, window, softcap, off)) in enumerate(
            D256_CASES.items()):
        q, k, v, do = _inputs(21 + i, sq=sq, skv=skv, d=256)
        scalars = jnp.array([window or 0, off or 0], jnp.int32)
        flags = dict(causal=causal, windowed=window is not None,
                     block_q=16, block_k=16, softcap=softcap, interpret=True,
                     offset_mode=off is not None)
        o, lse = ref._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), scalars, **flags)
        bwd = ref._flash_bwd_impl(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), o, lse, jnp.asarray(do),
                                  scalars, **flags)

        def ref_loss(q_, k_, v_, window=window, off=off, softcap=softcap,
                     causal=causal, do=do):
            out = ref.flash_attention(
                q_, k_, v_, causal=causal, block_q=16, block_k=16,
                softcap=softcap,
                window=None if window is None else jnp.int32(window),
                q_offset=None if off is None else jnp.int32(off))
            return jnp.sum(out * jnp.asarray(do))

        grads = jax.grad(ref_loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        runs[case] = dict(inputs=(q, k, v, do), o=np.array(o),
                          lse=np.array(lse),
                          bwd=[np.array(a) for a in bwd],
                          grads=[np.array(a) for a in grads])
    return runs


@pytest.mark.parametrize('case', list(D256_CASES))
def test_plain_backward_matches_reference_at_head_dim_256(d256_runs, case):
    causal, _, _, window, softcap, off = D256_CASES[case]
    run = d256_runs[case]
    t = torch.from_numpy
    q, k, v, do = (t(a) for a in run['inputs'])
    got = fa.flash_attention_bwd_plain(
        q, k, v, t(run['o']), t(run['lse']), do, causal=causal, block_q=16,
        block_k=16, window=window, softcap=softcap, q_offset=off)
    for name, g, w in zip(('dq', 'dk', 'dv'), got, run['bwd']):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize('case', list(D256_CASES))
def test_autograd_grads_match_jax_grad_at_head_dim_256(d256_runs, case):
    """autograd through the port's flash_attention (K1's plain version
    forward, K3/K4's backward) at d 256, where the CPU takes a gradient
    at any head_dim and CUDA now has the d 256 kernels."""
    causal, _, _, window, softcap, off = D256_CASES[case]
    run = d256_runs[case]
    q, k, v, do = run['inputs']
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, block_q=16, block_k=16,
                             window=window, softcap=softcap, q_offset=off)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w in zip(got, run['grads']):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)


def test_gemma_loss_grads_match_reference_at_head_dim_256(monkeypatch):
    """tiny-gemma at head_dim 256 through attention_impl='flash' (window
    16 on the local layer, a global layer, softcaps 50 / 30, tied
    embeddings): the loss and every param's grad against jax.grad of the
    reference loss in interpret mode, on the same weights and tokens."""
    ref_config = dataclasses.replace(
        ref_gemma.CONFIGS['tiny-gemma'], head_dim=256, num_heads=2,
        num_kv_heads=1, attention_impl='flash', attention_block_size=16)
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    assert (config.head_dim, config.attention_impl) == (256, 'flash')
    assert (config.sliding_window, config.attn_logit_softcap) == (16, 50.0)
    monkeypatch.setitem(gemma.CONFIGS, 'tiny-gemma-d256', config)
    ref_params = ref_llama.init_params(ref_config, jax.random.key(7))
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, ref_config.vocab_size, (2, 32)).astype(np.int32)
    want_loss, want_grads = jax.value_and_grad(ref_gemma.loss_fn)(
        ref_params, {'tokens': jnp.asarray(tokens)}, ref_config)
    params = trainer.tree_map(
        lambda a: a.requires_grad_(True), weights.from_jax_params(
            jax.tree.map(lambda a: np.array(a, np.float32), ref_params)))
    loss = gemma.loss_fn(params, {'tokens': torch.from_numpy(tokens).long()},
                         config)
    grads = torch.autograd.grad(loss, trainer.tree_leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5, atol=1e-5)
    flat = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    assert len(flat) == len(grads)
    for (path, w), g in zip(flat, grads):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=TOL, atol=TOL,
            err_msg=jax.tree_util.keystr(path))
