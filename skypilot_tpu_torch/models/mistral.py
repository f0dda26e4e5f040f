"""Mistral family presets: the llama core with a window on every layer.

Ports `skypilot_tpu/models/mistral.py`: `CONFIGS` (mistral-7b,
tiny-mistral) and the re-exported functional surface of the shared
core. Mistral-7B is llama with a 4096-token sliding window on every
layer (`sliding_window_pattern` 1), vocab 32k and rope theta 1e4; on
the card K1/K2 take the window inside the kernel at head_dim 128.
"""
import torch

from skypilot_tpu_torch.models import llama

LlamaConfig = llama.LlamaConfig
init_params = llama.init_params
param_logical_axes = llama.param_logical_axes
forward = llama.forward
loss_fn = llama.loss_fn

CONFIGS = {
    'mistral-7b': LlamaConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        max_seq_len=8192, rope_theta=10000.0, sliding_window=4096,
        attention_impl='flash'),
    # CPU-test scale; a window narrower than the sequence.
    'tiny-mistral': LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        max_seq_len=128, dtype=torch.float32, remat=False,
        rope_theta=10000.0, sliding_window=16),
}
