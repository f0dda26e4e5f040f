"""Gemma family presets: the llama core with Gemma's knobs.

Ports `skypilot_tpu/models/gemma.py`: `CONFIGS` (gemma2-2b, gemma2-9b,
gemma2-27b, tiny-gemma) and the re-exported functional surface of the
shared core (`models/llama.py`). Gemma-2 is a GeGLU MLP, (1+w) RMSNorm
with zero init, the sqrt(hidden) embedding scale, tied embeddings,
post-norms, attention and final logit softcaps, and local (4096) /
global layers in turn; every one of these is a `LlamaConfig` knob. The
presets run `attention_impl='flash'`: on the card K1/K2 (serving) and
K1/K3/K4 (training) carry the window and the softcap inside the kernel,
at head_dim 256 for gemma2-2b and gemma2-9b.
"""
import torch

from skypilot_tpu_torch.models import llama

# Re-exported functional surface (families are config + shared core).
LlamaConfig = llama.LlamaConfig
init_params = llama.init_params
param_logical_axes = llama.param_logical_axes
forward = llama.forward
loss_fn = llama.loss_fn

_GEMMA = dict(
    activation='gelu',
    tied_embeddings=True,
    embed_scale=True,
    norm_plus_one=True,
    rope_theta=10000.0,
)
_GEMMA2 = dict(
    **_GEMMA,
    post_norms=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4096,
    sliding_window_pattern=2,   # alternate local / global
    attention_impl='flash',
)

CONFIGS = {
    'gemma2-2b': LlamaConfig(
        vocab_size=256128, hidden_size=2304, intermediate_size=9216,
        num_layers=26, num_heads=8, num_kv_heads=4, head_dim=256,
        max_seq_len=8192, **_GEMMA2),
    'gemma2-9b': LlamaConfig(
        vocab_size=256128, hidden_size=3584, intermediate_size=14336,
        num_layers=42, num_heads=16, num_kv_heads=8, head_dim=256,
        max_seq_len=8192, **_GEMMA2),
    'gemma2-27b': LlamaConfig(
        vocab_size=256128, hidden_size=4608, intermediate_size=36864,
        num_layers=46, num_heads=32, num_kv_heads=16, head_dim=128,
        max_seq_len=8192, query_pre_attn_scalar=144.0, **_GEMMA2),
    # CPU-test scale: a window narrower than the sequence, and 2 layers
    # so the local/global alternation has one of each.
    'tiny-gemma': LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        max_seq_len=128, dtype=torch.float32, remat=False,
        **{**_GEMMA2, 'sliding_window': 16, 'attention_impl': 'dense'}),
}
