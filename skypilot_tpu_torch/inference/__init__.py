"""Inference for the port: the KV-cache engine and its HTTP server.

Ports `skypilot_tpu/inference/__init__.py`; `build_engine` (:21) is the
one engine-construction path for every entry point. Weights come from an
HF safetensors checkpoint (`checkpoint=`, through
`skypilot_tpu_torch.checkpoints`) or are drawn from a seed on the device.
"""
from typing import Optional, Union

import torch

from skypilot_tpu_torch.inference.engine import (DecodeState,
                                                 InferenceEngine,
                                                 SamplingParams,
                                                 SnapshotError,
                                                 decode_step,
                                                 fused_decode_steps,
                                                 fused_spec_rounds,
                                                 init_cache,
                                                 prefill_chunked)

__all__ = ['DecodeState', 'InferenceEngine', 'SamplingParams',
           'SnapshotError', 'build_engine', 'decode_step', 'draw_params',
           'fused_decode_steps', 'fused_spec_rounds', 'init_cache',
           'prefill_chunked', 'restore_params']


def draw_params(model: str, seed: int, device: torch.device):
    """(params, config) of `model` with random weights drawn from a
    generator seeded `seed` on `device`: what build_engine serves."""
    from skypilot_tpu_torch import models as models_lib
    family, config = models_lib.resolve(model)
    gen = torch.Generator(device=device).manual_seed(seed)
    return family.init_params(config, gen, device), config


def restore_params(checkpoint: str, device: torch.device):
    """(params, config) of a checkpoint directory. An HF safetensors
    checkpoint streams in with the geometry its config.json declares,
    which wins over any preset name, as in the reference. Anything else
    would be an Orbax train checkpoint there, which the port cannot read
    yet: it raises rather than being ignored."""
    from skypilot_tpu_torch import checkpoints as ckpt_lib
    if not ckpt_lib.is_hf_checkpoint(checkpoint):
        raise NotImplementedError(
            f'{checkpoint!r} is not an HF safetensors checkpoint '
            '(config.json + *.safetensors). Train checkpoints are not '
            'ported yet (ROADMAP.md, Queue 1 item 6).')
    params, config, _stats = ckpt_lib.load_params(checkpoint,
                                                  device=device)
    return params, config


def build_engine(model: str, *,
                 device: Optional[Union[str, torch.device]] = None,
                 checkpoint: Optional[str] = None,
                 seed: int = 0, batch_size: int = 8,
                 max_seq_len: Optional[int] = None,
                 prefill_chunk: int = 1024, kv_quant: str = 'auto',
                 prefill_interleave: Optional[int] = None,
                 decode_fuse_steps: Optional[int] = None,
                 kv_page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 prefix_cache_max_pages: Optional[int] = None,
                 use_flash: Optional[bool] = None,
                 draft_model: Optional[str] = None,
                 draft_checkpoint: Optional[str] = None,
                 spec_k: Optional[int] = None,
                 spec_fuse_rounds: Optional[int] = None) -> InferenceEngine:
    """Resolve `model` and build its engine on `device` (cuda unless
    named; raises without CUDA). The weights come from `checkpoint`, an
    HF safetensors directory whose config.json geometry wins over
    `model` (`restore_params`), or are drawn from `seed`.
    `prefix_cache=None` follows SKYTPU_PREFIX_CACHE (on), as the
    reference's build_engine does. `draft_model` attaches a same-vocab
    draft for speculative decode: from `draft_checkpoint`, or drawn from
    its own generator seeded `seed + 1` (the reference draws the target
    from key 0 and the draft from key 1)."""
    from skypilot_tpu_torch import device as device_lib
    from skypilot_tpu_torch import models as models_lib

    dev = device_lib.resolve_device(device)
    if checkpoint:
        models_lib.resolve(model)  # an unknown name fails as without one
        params, config = restore_params(checkpoint, dev)
    else:
        params, config = draw_params(model, seed, dev)
    draft = None
    if draft_model:
        draft = (restore_params(draft_checkpoint, dev) if draft_checkpoint
                 else draw_params(draft_model, seed + 1, dev))
    return InferenceEngine(params, config, batch_size=batch_size,
                           max_seq_len=max_seq_len, seed=seed,
                           prefill_chunk=prefill_chunk,
                           use_flash=use_flash, kv_quant=kv_quant,
                           prefill_interleave=prefill_interleave,
                           draft=draft, spec_k=spec_k,
                           spec_fuse_rounds=spec_fuse_rounds,
                           decode_fuse_steps=decode_fuse_steps,
                           kv_page_size=kv_page_size, kv_pages=kv_pages,
                           prefix_cache=prefix_cache,
                           prefix_cache_max_pages=prefix_cache_max_pages,
                           device=dev)
