"""Inference for the port: the KV-cache engine and its HTTP server.

Ports `skypilot_tpu/inference/__init__.py`; `build_engine` (:21) is the
one engine-construction path for every entry point. Weights are drawn
from a seed on the device (checkpoint loading waits for a later slice).
"""
from typing import Optional, Union

import torch

from skypilot_tpu_torch.inference.engine import (DecodeState,
                                                 InferenceEngine,
                                                 SamplingParams,
                                                 SnapshotError,
                                                 decode_step,
                                                 fused_decode_steps,
                                                 init_cache,
                                                 prefill_chunked)

__all__ = ['DecodeState', 'InferenceEngine', 'SamplingParams',
           'SnapshotError', 'build_engine', 'decode_step',
           'fused_decode_steps', 'init_cache', 'prefill_chunked']


def build_engine(model: str, *,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0, batch_size: int = 8,
                 max_seq_len: Optional[int] = None,
                 prefill_chunk: int = 1024, kv_quant: str = 'auto',
                 prefill_interleave: Optional[int] = None,
                 decode_fuse_steps: Optional[int] = None,
                 kv_page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 prefix_cache_max_pages: Optional[int] = None,
                 use_flash: Optional[bool] = None) -> InferenceEngine:
    """Resolve `model`, draw its weights from `seed` on `device` (cuda
    unless named; raises without CUDA) and build the engine.
    `prefix_cache=None` follows SKYTPU_PREFIX_CACHE (on), as the
    reference's build_engine does."""
    from skypilot_tpu_torch import device as device_lib
    from skypilot_tpu_torch import models as models_lib

    dev = device_lib.resolve_device(device)
    family, config = models_lib.resolve(model)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = family.init_params(config, gen, dev)
    return InferenceEngine(params, config, batch_size=batch_size,
                           max_seq_len=max_seq_len, seed=seed,
                           prefill_chunk=prefill_chunk,
                           use_flash=use_flash, kv_quant=kv_quant,
                           prefill_interleave=prefill_interleave,
                           decode_fuse_steps=decode_fuse_steps,
                           kv_page_size=kv_page_size, kv_pages=kv_pages,
                           prefix_cache=prefix_cache,
                           prefix_cache_max_pages=prefix_cache_max_pages,
                           device=dev)
