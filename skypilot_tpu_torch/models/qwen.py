"""Qwen2/2.5 family presets: the llama core with biased q/k/v.

Ports `skypilot_tpu/models/qwen.py`: `CONFIGS` (qwen2-7b, qwen2.5-1.5b,
qwen2.5-72b, tiny-qwen, and deepseek-r1-distill-qwen-7b built from
qwen2-7b by `dataclasses.replace`) and the re-exported functional
surface of the shared core. Qwen2 is llama with bias terms on the
attention input projections (`attn_qkv_bias`), a 152k vocab and rope
theta 1e6; the small variants tie their embeddings.
"""
import dataclasses

import torch

from skypilot_tpu_torch.models import llama

LlamaConfig = llama.LlamaConfig
init_params = llama.init_params
param_logical_axes = llama.param_logical_axes
forward = llama.forward
loss_fn = llama.loss_fn

CONFIGS = {
    'qwen2-7b': LlamaConfig(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_layers=28, num_heads=28, num_kv_heads=4, head_dim=128,
        max_seq_len=32768, rope_theta=1000000.0, rms_norm_eps=1e-6,
        attn_qkv_bias=True, attention_impl='flash'),
    'qwen2.5-1.5b': LlamaConfig(
        vocab_size=151936, hidden_size=1536, intermediate_size=8960,
        num_layers=28, num_heads=12, num_kv_heads=2, head_dim=128,
        max_seq_len=32768, rope_theta=1000000.0, rms_norm_eps=1e-6,
        attn_qkv_bias=True, tied_embeddings=True,
        attention_impl='flash'),
    'qwen2.5-72b': LlamaConfig(
        vocab_size=152064, hidden_size=8192, intermediate_size=29568,
        num_layers=80, num_heads=64, num_kv_heads=8, head_dim=128,
        max_seq_len=32768, rope_theta=1000000.0, rms_norm_eps=1e-6,
        attn_qkv_bias=True, attention_impl='flash'),
    # CPU-test scale; the bias path on.
    'tiny-qwen': LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        max_seq_len=128, dtype=torch.float32, remat=False,
        rope_theta=1000000.0, attn_qkv_bias=True),
}

# DeepSeek-R1-Distill-Qwen-7B: the qwen2-7b geometry, derived by
# replace() so the shapes cannot drift, at rope theta 1e4 (its base,
# Qwen2.5-Math-7B, was trained at 1e4, not the chat model's 1e6).
CONFIGS['deepseek-r1-distill-qwen-7b'] = dataclasses.replace(
    CONFIGS['qwen2-7b'], rope_theta=10000.0)
