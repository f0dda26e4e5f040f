"""PyTorch/CUDA port of skypilot_tpu's compute stack, for NVIDIA Hopper.

A second package beside the JAX reference (`skypilot_tpu`), mirroring
its layout module for module. This slice serves Llama-family models:
`models/llama.py` (layer math), `inference/engine.py` (paged, chunked
prefill and fused decode), `inference/server.py` (HTTP), with every
prefill chunk's attention in the hand-written CUDA kernels of
`ops/csrc/flash_fwd.cu`. Entry points run on CUDA unless the caller
passes `device='cpu'`.
"""
