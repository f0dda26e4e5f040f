"""The port's CUDA kernels on the card: K1/K2 against their plain versions.

Every test here is marked `gpu` and skips without CUDA. The file imports
no JAX, so it runs on a machine with the card and without jax:

    python -m pytest tests/test_torch_kernels.py --noconftest -q -m gpu

(`--noconftest`: the suite's conftest.py sets up JAX.) Tolerance: bf16
outputs within 0.05 of the plain version (the bound chip_smoke.py and
the reference's `_tpu_flash_check.py` use); lse within 1e-3.
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
