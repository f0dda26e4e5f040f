"""The port's CUDA kernels on the card: K1/K2 (flash forward) and K3/K4
(flash backward) against their plain versions.

Every test here is marked `gpu` and skips without CUDA. The file imports
no JAX, so it runs on a machine with the card and without jax:

    python -m pytest tests/test_torch_kernels.py --noconftest -q -m gpu

(`--noconftest`: the suite's conftest.py sets up JAX.) Tolerance: bf16
outputs within 0.05 of the plain version (the bound chip_smoke.py and
the reference's `_tpu_flash_check.py` use); lse within 1e-3. Backward:
dQ, dK and dV within 0.02 of the plain version relative to its largest
magnitude (max|a-b| / max|b|, the limit chip_smoke.py holds K3/K4 to).
"""
import pytest
import torch

from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels run only on the card)')
    return torch.device('cuda')


# (B, Sq, Skv, H, KV, D, causal, q_offset, window, softcap)
CASES = {
    'ragged_offset_window_softcap': (2, 200, 700, 8, 2, 128, True, 450,
                                     300, 50.0),
    'two_rows_mha_d64': (1, 2, 65, 4, 4, 64, True, 63, None, None),
    'square_causal': (3, 130, 130, 6, 3, 64, True, None, None, None),
    'non_causal': (1, 100, 300, 4, 1, 128, False, None, None, None),
    'all_rows_masked': (1, 64, 128, 4, 2, 128, True, 1000, 16, None),
    # Edges of the 128-row q and kv tiles.
    'skv_below_one_tile': (2, 40, 100, 8, 2, 128, True, 60, None, None),
    'window_narrower_than_tile': (1, 300, 700, 8, 2, 128, True, 400, 50,
                                  None),
    'd64_sq129': (1, 129, 129, 4, 2, 64, True, None, None, None),
}


@pytest.mark.parametrize('quant', [False, True], ids=['bf16', 'int8'])
@pytest.mark.parametrize('case', list(CASES))
def test_kernel_matches_plain(cuda, case, quant):
    from skypilot_tpu_torch.inference.engine import quantize_kv
    b, sq, skv, h, kv, d, causal, off, window, softcap = CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, sq, h, d, generator=gen, device=cuda).bfloat16()
    k = torch.randn(b, skv, kv, d, generator=gen, device=cuda).bfloat16()
    v = torch.randn(b, skv, kv, d, generator=gen, device=cuda).bfloat16()
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    if quant:
        kq, vq = quantize_kv(k), quantize_kv(v)
        k, v = kq['q'], vq['q']
        scales = dict(k_scale=kq['s'], v_scale=vq['s'])
        want, want_lse = fa.flash_attention_quant_plain(
            q, k, kq['s'], v, vq['s'], **kw)
    else:
        scales = {}
        want, want_lse = fa.flash_attention_plain(q, k, v, **kw)
    counter = fa.flash_attention_quant if quant else fa.flash_attention
    before = counter.launches
    got, lse = fa.flash_fwd(q, k, v, **scales, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert float((got.float() - want.float()).abs().max()) < 0.05
    finite = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), finite)
    if bool(finite.any()):
        assert float((lse - want_lse)[finite].abs().max()) < 1e-3
    masked = ~finite[..., 0].permute(0, 2, 1)           # [B,Sq,H]
    assert bool((got[masked] == 0).all())


@pytest.mark.parametrize('quant', [False, True], ids=['bf16', 'int8'])
def test_kernel_takes_strided_q_view(cuda, quant):
    """q as a 16-byte-aligned view into a wider tensor (heads 1..8 of
    10, every other position), not a fresh contiguous tensor."""
    from skypilot_tpu_torch.inference.engine import quantize_kv
    gen = torch.Generator(device=cuda).manual_seed(2)
    wide = torch.randn(2, 400, 10, 128, generator=gen,
                       device=cuda).bfloat16()
    q = wide[:, ::2, 1:9]                           # [2, 200, 8, 128]
    assert not q.is_contiguous() and q.data_ptr() % 16 == 0
    k = torch.randn(2, 500, 2, 128, generator=gen, device=cuda).bfloat16()
    v = torch.randn(2, 500, 2, 128, generator=gen, device=cuda).bfloat16()
    kw = dict(causal=True, q_offset=250)
    if quant:
        kq, vq = quantize_kv(k), quantize_kv(v)
        got, lse = fa.flash_fwd(q, kq['q'], vq['q'], k_scale=kq['s'],
                                v_scale=vq['s'], **kw)
        want, want_lse = fa.flash_attention_quant_plain(
            q, kq['q'], kq['s'], vq['q'], vq['s'], **kw)
    else:
        got, lse = fa.flash_fwd(q, k, v, **kw)
        want, want_lse = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < 0.05
    assert float((lse - want_lse).abs().max()) < 1e-3


def test_wrapper_raises_instead_of_falling_back(cuda, monkeypatch):
    q = torch.randn(1, 64, 4, 128, device=cuda).bfloat16()
    k = torch.randn(1, 64, 2, 128, device=cuda).bfloat16()
    with pytest.raises(TypeError):          # f32 is not a kernel dtype
        fa.flash_attention(q.float(), k.float(), k.float())
    with pytest.raises(ValueError):         # head_dim 96 is not built
        fa.flash_attention(q[..., :96], k[..., :96], k[..., :96])
    with pytest.raises(ValueError):         # last dim not contiguous
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                           k, k)
    with pytest.raises(ValueError):         # broadcast kv: no tensor map
        fa.flash_attention(q, k[:, :1].expand(1, 64, 2, 128), k, q_offset=0)

    def no_library():
        raise RuntimeError('kernel library unavailable')

    monkeypatch.setattr(_build, 'library', no_library)
    with pytest.raises(RuntimeError, match='unavailable'):
        fa.flash_attention(q, k, k, q_offset=0)


def test_engine_prefill_through_kernel_matches_dense_path(cuda):
    """A small bf16 llama (head_dim 64, 2 layers) prefilled through K1
    and through the dense cached-attention path gives the same
    last-token logits (relative to their scale, bf16)."""
    from skypilot_tpu_torch.inference import engine as eng
    from skypilot_tpu_torch.models import llama
    config = llama.LlamaConfig(vocab_size=512, hidden_size=256,
                               intermediate_size=512, num_layers=2,
                               num_heads=4, num_kv_heads=2, head_dim=64,
                               max_seq_len=256)
    params = llama.init_params(
        config, torch.Generator(device=cuda).manual_seed(0), cuda)
    tokens = torch.randint(0, 512, (2, 192), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    lengths = torch.tensor([150, 37], dtype=torch.int32, device=cuda)

    def prefill(use_flash):
        cache = eng.init_cache(config, 2, 256, page_size=64, device=cuda)
        cache['table'][:] = torch.arange(1, 9, dtype=torch.int32,
                                         device=cuda).reshape(2, 4)
        before = fa.flash_attention.launches
        logits, _ = eng.prefill_chunked(params, tokens, lengths, cache,
                                        torch.arange(2, device=cuda),
                                        config, chunk=64,
                                        use_flash=use_flash)
        return logits, fa.flash_attention.launches - before

    flash, launched = prefill(True)
    dense, none = prefill(False)
    assert launched == 3 * config.num_layers and none == 0
    rel = float((flash - dense).abs().max() / dense.abs().max())
    assert rel < 0.05


# (B, Sq, Skv, H, KV, D, causal, q_offset, window, softcap)
BWD_CASES = {
    'ragged_gqa': (2, 200, 200, 8, 2, 128, True, None, None, None),
    'mha_d64': (1, 130, 130, 4, 4, 64, True, None, None, None),
    'non_causal_ragged': (1, 100, 300, 4, 1, 128, False, None, None, None),
    'window_softcap': (1, 300, 300, 8, 2, 128, True, None, 70, 30.0),
    'q_offset': (2, 96, 300, 8, 4, 64, True, 204, None, None),
    'masked_rows': (1, 64, 128, 4, 2, 128, True, 1000, 16, None),
    # Edges of the tiles each kernel owns (128 q rows in K3, 64 kv rows in
    # K4) and the 64-row tiles it streams.
    'kv_below_one_tile': (2, 40, 50, 8, 2, 128, True, 10, None, None),
    'window_narrower_than_tile': (1, 300, 700, 8, 2, 128, True, 400, 50,
                                  None),
    'd64_sq129': (1, 129, 129, 4, 2, 64, True, None, None, None),
}


def _bwd_inputs(cuda, b, sq, skv, h, kv, d, causal, off, window, softcap):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(b, sq, h, d, generator=gen, device=cuda).bfloat16()
    k = torch.randn(b, skv, kv, d, generator=gen, device=cuda).bfloat16()
    v = torch.randn(b, skv, kv, d, generator=gen, device=cuda).bfloat16()
    do = torch.randn(b, sq, h, d, generator=gen, device=cuda).bfloat16()
    o, lse = fa.flash_fwd(q, k, v, causal=causal, window=window,
                          softcap=softcap, q_offset=off)
    return q, k, v, do, o, lse


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize('case', list(BWD_CASES))
def test_backward_kernels_match_plain(cuda, case):
    b, sq, skv, h, kv, d, causal, off, window, softcap = BWD_CASES[case]
    q, k, v, do, o, lse = _bwd_inputs(cuda, b, sq, skv, h, kv, d, causal,
                                      off, window, softcap)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    before = (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    got = fa.flash_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for a, ref in zip(got, want):
        assert a.shape == ref.shape and a.dtype == torch.bfloat16
        assert bool(torch.isfinite(a).all())
        if bool((ref != 0).any()):
            assert _rel(a, ref) < 0.02
        else:                       # every row masked: zero gradients
            assert bool((a == 0).all())


def test_backward_kernels_take_strided_q_and_do_views(cuda):
    """q and dO as 16-byte-aligned views into wider tensors (heads 1..8 of
    10, every other position), which K3 and K4 read by TMA."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    wide = torch.randn(2, 2, 400, 10, 128, generator=gen,
                       device=cuda).bfloat16()
    q, do = wide[0, :, ::2, 1:9], wide[1, :, ::2, 1:9]  # [2, 200, 8, 128]
    assert not q.is_contiguous() and not do.is_contiguous()
    assert q.data_ptr() % 16 == 0 and do.data_ptr() % 16 == 0
    k = torch.randn(2, 500, 2, 128, generator=gen, device=cuda).bfloat16()
    v = torch.randn(2, 500, 2, 128, generator=gen, device=cuda).bfloat16()
    kw = dict(causal=True, q_offset=250)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    got = fa.flash_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q.contiguous(), k, v, o, lse,
                                        do.contiguous(), **kw)
    for a, ref in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert _rel(a, ref) < 0.02


def test_autograd_through_flash_launches_backward_kernels(cuda):
    b, sq, skv, h, kv, d, causal, off, window, softcap = BWD_CASES[
        'ragged_gqa']
    q, k, v, do, _, _ = _bwd_inputs(cuda, b, sq, skv, h, kv, d, causal, off,
                                    window, softcap)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (fa.flash_attention.launches, fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    out = fa.flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == tuple(n + 1 for n in before)
    dense = [t.clone().float().requires_grad_(True) for t in (q, k, v)]
    from skypilot_tpu_torch.ops import attention
    ref = attention.dense_attention(*dense)
    want = torch.autograd.grad(ref, dense, do.float())
    for a, w in zip(grads, want):
        assert _rel(a, w) < 0.05


def test_backward_wrapper_raises_instead_of_falling_back(cuda, monkeypatch):
    q, k, v, do, o, lse = _bwd_inputs(cuda, 1, 64, 64, 4, 2, 128, True,
                                      None, None, None)
    delta = fa.bwd_delta(o, do)
    with pytest.raises(TypeError):          # f32 is not a kernel dtype
        fa.flash_attention_dq(q.float(), k.float(), v.float(), do.float(),
                              lse, delta)
    with pytest.raises(ValueError):         # head_dim 96 is not built
        fa.flash_attention_dkv(q[..., :96], k[..., :96], v[..., :96],
                               do[..., :96], lse, delta)
    with pytest.raises(ValueError):         # lse must be contiguous f32
        fa.flash_attention_dq(q, k, v, do, lse.transpose(1, 2), delta)
    with pytest.raises(ValueError):         # last dim not contiguous
        fa.flash_attention_dkv(q, k.transpose(2, 3).contiguous()
                               .transpose(2, 3), v, do, lse, delta)
    with pytest.raises(ValueError):         # broadcast kv: no tensor map
        fa.flash_attention_dq(q, k[:, :1].expand(1, 64, 2, 128), v, do, lse,
                              delta)

    def no_library():
        raise RuntimeError('kernel library unavailable')

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves)
    monkeypatch.setattr(_build, 'library', no_library)
    with pytest.raises(RuntimeError, match='unavailable'):
        torch.autograd.grad(out, leaves, do)
