"""Port parity: the flash forward's plain versions against the Pallas kernel.

`flash_attention_plain` / `flash_attention_quant_plain` (the CPU path of
the port's K1 and K2, and the oracle the CUDA kernels are held to on
the card) against the reference `flash_attention` /
`flash_attention_quant` and `_flash_fwd_impl`'s lse, which run in Pallas
interpret mode on the CPU. Inputs are numpy draws; tolerance 2e-5 (both
run the same online-softmax recurrence in f32, in another summation
order). The CUDA kernels themselves are compared with these plain
versions on the card by chip_smoke.py and tests/test_torch_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import flash_attention as ref
from skypilot_tpu_torch.ops import flash_attention as fa

TOL = 2e-5


def _inputs(seed, b, sq, skv, h, kv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    return q, k, v


def _ref_lse(q, k, v, causal, bq, bk, window, softcap, q_offset,
             k_scale=None, v_scale=None):
    scalars = jnp.array([window or 0, q_offset or 0], jnp.int32)
    _, lse = ref._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scalars, causal,
        window is not None, bq, bk, softcap, interpret=True,
        offset_mode=q_offset is not None,
        k_scale=None if k_scale is None else jnp.asarray(k_scale),
        v_scale=None if v_scale is None else jnp.asarray(v_scale))
    return np.asarray(lse)


def _assert_lse_close(got, want):
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=TOL,
                               atol=TOL)


# (causal, sq, skv, heads, kv_heads, block_q, block_k, window, softcap,
#  q_offset)
CASES = {
    'causal': (True, 32, 32, 4, 4, 16, 16, None, None, None),
    'non_causal': (False, 32, 32, 4, 4, 16, 16, None, None, None),
    'gqa': (True, 32, 32, 4, 2, 16, 8, None, None, None),
    'window': (True, 32, 32, 4, 2, 8, 8, 10, None, None),
    'softcap': (True, 32, 32, 4, 2, 16, 16, None, 30.0, None),
    'cached_prefill': (True, 16, 64, 4, 2, 8, 16, None, None, 40),
    'cached_prefill_window_softcap': (True, 16, 64, 4, 2, 8, 16, 12, 25.0,
                                      40),
}


@pytest.mark.parametrize('case', list(CASES))
def test_flash_plain_matches_reference(case):
    causal, sq, skv, h, kv, bq, bk, window, softcap, off = CASES[case]
    q, k, v = _inputs(3, 2, sq, skv, h, kv, 16)
    want = np.asarray(ref.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=bq, block_k=bk,
        window=None if window is None else jnp.int32(window),
        softcap=softcap, q_offset=None if off is None else jnp.int32(off)))
    got, lse = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, block_q=bq, block_k=bk, window=window,
        softcap=softcap, q_offset=off)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    _assert_lse_close(lse.numpy(), _ref_lse(q, k, v, causal, bq, bk,
                                            window, softcap, off))


def _quant_inputs(seed, b, sq, skv, h, kv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    kq = rng.integers(-127, 128, (b, skv, kv, d)).astype(np.int8)
    vq = rng.integers(-127, 128, (b, skv, kv, d)).astype(np.int8)
    ks = rng.uniform(0.002, 0.02, (b, skv, kv)).astype(np.float32)
    vs = rng.uniform(0.002, 0.02, (b, skv, kv)).astype(np.float32)
    return q, kq, ks, vq, vs


@pytest.mark.parametrize('case', ['causal', 'cached_prefill',
                                  'cached_prefill_window_softcap'])
def test_flash_quant_plain_matches_reference(case):
    causal, sq, skv, h, kv, bq, bk, window, softcap, off = CASES[case]
    q, kq, ks, vq, vs = _quant_inputs(4, 2, sq, skv, h, kv, 16)
    want = np.asarray(ref.flash_attention_quant(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
        jnp.asarray(vs), causal=causal, block_q=bq, block_k=bk,
        window=None if window is None else jnp.int32(window),
        softcap=softcap, q_offset=None if off is None else jnp.int32(off)))
    t = torch.from_numpy
    got, lse = fa.flash_attention_quant_plain(
        t(q), t(kq), t(ks), t(vq), t(vs), causal=causal, block_q=bq,
        block_k=bk, window=window, softcap=softcap, q_offset=off)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    _assert_lse_close(lse.numpy(), _ref_lse(q, kq, vq, causal, bq, bk,
                                            window, softcap, off, ks, vs))


def test_fully_masked_rows_give_zero_output_and_inf_lse():
    # Rows at global positions 40..55 under window 4 see keys 37..55,
    # but the cache holds only 0..31: rows 40+ see nothing at all,
    # rows below see their window.
    q, k, v = _inputs(5, 1, 16, 32, 4, 2, 16)
    off, window = 28, 4
    got, lse = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, block_q=8, block_k=8, window=window, q_offset=off)
    rows = off + np.arange(16)
    masked = rows - window + 1 > 31
    assert masked.any() and not masked.all()
    assert np.all(np.isinf(lse.numpy()[0, :, masked, 0]))
    assert np.all(got.numpy()[0, masked] == 0.0)
    assert np.all(np.isfinite(lse.numpy()[0, :, ~masked, 0]))
    want = np.asarray(ref.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=8, block_k=8, window=jnp.int32(window),
        q_offset=jnp.int32(off)))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_cpu_tensors_take_the_plain_version_without_launching():
    q, k, v = _inputs(6, 1, 16, 16, 4, 2, 16)
    before = (fa.flash_attention.launches, fa.flash_attention_quant.launches)
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), block_q=8, block_k=8)
    plain, _ = fa.flash_attention_plain(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v), block_k=8)
    assert torch.equal(out, plain)
    assert (fa.flash_attention.launches,
            fa.flash_attention_quant.launches) == before


def test_window_requires_causal():
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, 1, 8, 8, 2, 2, 16))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, causal=False, q_offset=2)


@pytest.mark.parametrize('make,ok', [
    (lambda: torch.zeros(2, 64, 8, 128, dtype=torch.bfloat16), True),
    # heads 1..8 of 10 at every other position: strided, 16-byte aligned
    (lambda: torch.zeros(2, 128, 10, 128, dtype=torch.bfloat16)[:, ::2, 1:9],
     True),
    # a size-1 batch of stride 0: the stride is never used
    (lambda: torch.zeros(64, 8, 128, dtype=torch.bfloat16)
     .as_strided((1, 64, 8, 128), (0, 8 * 128, 128, 1)), True),
    (lambda: torch.zeros(2, 64, 2, 128, dtype=torch.int8), True),
    # broadcast over positions (stride 0 on a dim of 64): no tensor map
    (lambda: torch.zeros(2, 1, 2, 128, dtype=torch.bfloat16)
     .expand(2, 64, 2, 128), False),
    # a head stride of 4 bf16 values (8 bytes) is not 16-byte aligned
    (lambda: torch.zeros(2, 64, 8 * 132, dtype=torch.bfloat16)
     .as_strided((2, 64, 8, 128), (64 * 8 * 132, 8 * 132, 4, 1)), False),
])
def test_forward_launcher_stride_checks(make, ok):
    """The forward kernel reads q, k and v by TMA: the last dim contiguous,
    16-byte-aligned base and strides, and a positive stride on every dim
    wider than 1; `_launch` raises on anything else before a launch."""
    t = make()
    if ok:
        assert fa._tma_strides(t, 'x') == tuple(t.stride()[:3])
    else:
        with pytest.raises(ValueError):
            fa._tma_strides(t, 'x')


@pytest.mark.parametrize('which', ['dq', 'dkv'])
@pytest.mark.parametrize('broadcast', ['q', 'k', 'v', 'do'])
def test_backward_launcher_refuses_broadcast_views(which, broadcast):
    """K3 and K4 read q, k, v and dO by TMA: `_launch_bwd` raises on a
    broadcast (stride-0) view of any of them before a launch, as the
    forward's launcher does."""
    def full(s, h):
        return torch.zeros(1, s, h, 128, dtype=torch.bfloat16)

    def bcast(s, h):
        return torch.zeros(1, 1, h, 128, dtype=torch.bfloat16).expand(
            1, s, h, 128)

    t = {name: (bcast if name == broadcast else full)(64, h)
         for name, h in (('q', 4), ('k', 2), ('v', 2), ('do', 4))}
    lse = torch.zeros(1, 4, 64, 1)
    delta = torch.zeros(1, 4, 64)
    with pytest.raises(ValueError, match='positive stride'):
        fa._launch_bwd(which, t['q'], t['k'], t['v'], t['do'], lse, delta,
                       True, None, None, None)


# -- head_dim 256 (gemma2-2b/9b) ---------------------------------------------

@pytest.mark.parametrize('quant', [False, True], ids=['bf16', 'int8'])
def test_flash_plain_matches_reference_at_head_dim_256(quant):
    """K1's and K2's plain versions at d 256, with a window, a softcap and
    a q_offset past the window (rows whose window starts inside the
    cache), against the reference in interpret mode."""
    sq, skv, h, kv, bq, bk, window, softcap, off = (16, 64, 4, 2, 8, 16, 12,
                                                     25.0, 40)
    window_j, off_j = jnp.int32(window), jnp.int32(off)
    kw = dict(causal=True, block_q=bq, block_k=bk, window=window,
              softcap=softcap, q_offset=off)
    if quant:
        q, kq, ks, vq, vs = _quant_inputs(8, 2, sq, skv, h, kv, 256)
        want = np.asarray(ref.flash_attention_quant(
            jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks),
            jnp.asarray(vq), jnp.asarray(vs),
            **{**kw, 'window': window_j, 'q_offset': off_j}))
        t = torch.from_numpy
        got, lse = fa.flash_attention_quant_plain(t(q), t(kq), t(ks), t(vq),
                                                  t(vs), **kw)
        want_lse = _ref_lse(q, kq, vq, True, bq, bk, window, softcap, off,
                            ks, vs)
    else:
        q, k, v = _inputs(8, 2, sq, skv, h, kv, 256)
        want = np.asarray(ref.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            **{**kw, 'window': window_j, 'q_offset': off_j}))
        got, lse = fa.flash_attention_plain(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            **kw)
        want_lse = _ref_lse(q, k, v, True, bq, bk, window, softcap, off)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    _assert_lse_close(lse.numpy(), want_lse)


def test_kernel_head_dims_split_forward_and_backward():
    """The forward (K1/K2) and the backward (K3/K4) no longer split: since
    the d 256 backward instances, all four are built for d 64, 128 and
    256, one set the launchers' checks share, and each refuses a
    head_dim outside it."""
    assert fa.KERNEL_HEAD_DIMS == (64, 128, 256)
    assert not hasattr(fa, 'KERNEL_FWD_HEAD_DIMS')
    assert not hasattr(fa, 'KERNEL_BWD_HEAD_DIMS')
    q = torch.zeros(1, 8, 4, 256, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 256, dtype=torch.bfloat16)
    fa._check_attn_args(q, k, k, torch.bfloat16)
    fa._check_attn_args(q, k.to(torch.int8), k.to(torch.int8), torch.int8)
    with pytest.raises(ValueError, match='head_dim 16'):
        fa._check_attn_args(q[..., :16], k[..., :16], k[..., :16],
                            torch.bfloat16)
    with pytest.raises(ValueError, match='head_dim 96'):
        fa._check_attn_args(q[..., :96], k[..., :96], k[..., :96],
                            torch.bfloat16)


def test_launch_count_tallies_each_window():
    """`_count`, which each launcher calls once where its kernel launches,
    adds one to the wrapper's launches, one to its tally for that window,
    so a run can read a model's local and global layers apart, and one
    to its tally for the causal flag, so a run can read a ring hop's
    diagonal block from a past one. Every wrapper starts with empty
    tallies."""
    for wrapper in (fa.flash_attention, fa.flash_attention_quant,
                    fa.flash_attention_dq, fa.flash_attention_dkv):
        assert isinstance(wrapper.window_launches, dict)
        assert isinstance(wrapper.causal_launches, dict)

    def wrapper():
        pass

    wrapper.launches, wrapper.window_launches = 0, {}
    wrapper.causal_launches = {}
    for window, causal in ((4096, True), (2 ** 30, 1), (4096, False),
                           (None, True), (np.int64(4096), 0)):
        fa._count(wrapper, window, causal)
    assert wrapper.launches == 5
    assert wrapper.window_launches == {4096: 3, 2 ** 30: 1, None: 1}
    assert all(type(key) is int for key in wrapper.window_launches
               if key is not None)
    assert wrapper.causal_launches == {True: 3, False: 2}
    assert all(type(key) is bool for key in wrapper.causal_launches)


def test_head_dim_256_gradient_is_refused_for_cuda_before_the_forward():
    """On CUDA a call that needs a gradient at a head_dim K3/K4 are not
    built for (d 16) raises, naming ROADMAP, before K1 would launch; d
    256, gemma2-2b/9b's, is no longer refused: its backward has kernels.
    The CPU's plain versions take the gradient at any head_dim."""
    cuda = torch.device('cuda')
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        fa.check_backward(cuda, 16, needs_grad=True)
    fa.check_backward(cuda, 16, needs_grad=False)
    fa.check_backward(cuda, 256, needs_grad=True)
    fa.check_backward(cuda, 128, needs_grad=True)
    fa.check_backward(torch.device('cpu'), 16, needs_grad=True)
    fa.check_backward(torch.device('cpu'), 256, needs_grad=True)
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _inputs(9, 1, 16, 16, 2, 1, 256))
    out = fa.flash_attention(q, k, v, block_q=8, block_k=8, window=6,
                             softcap=20.0)
    out.square().sum().backward()
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in (q, k, v))
