"""Inference for the port: the KV-cache engine and its HTTP server.

Ports `skypilot_tpu/inference/__init__.py`; `build_engine` (:21) is the
one engine-construction path for every entry point. Weights come from an
HF safetensors checkpoint (`checkpoint=`, through
`skypilot_tpu_torch.checkpoints`) or a port train checkpoint
(`skypilot_tpu_torch.train.checkpoints`), or are drawn from a seed on
the device. Under `mesh_arg` ('tensor=2') each process is one rank of
the mesh (`parallel.mesh_from_env`, from the SKYTPU_* gang variables)
and holds only its slice of the weights (heads over `tensor`, an MoE's
experts over `expert`, every weight's `embed` dim over `fsdp`) and of a
draft's.
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


def _shardings(mesh, config):
    """The `Shard` tree of `config`'s family (llama-core or MoE) on this
    rank of `mesh` (None without a mesh of several ranks)."""
    if mesh is None or mesh.world_size == 1:
        return None
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import sharding
    return sharding.tree_shardings(mesh, llama.logical_axes(config))


def draw_params(model: str, seed: int, device: torch.device, mesh=None):
    """(params, config) of `model` with random weights drawn from a
    generator seeded `seed` on `device`: what build_engine serves. With
    a `mesh` of several ranks the draws are the same and each leaf keeps
    this rank's slice (heads, MLP and vocab over `tensor`, an MoE's
    experts over `expert`, `embed` over `fsdp`), so a rank's peak is one
    full leaf above its shard."""
    from skypilot_tpu_torch import models as models_lib
    family, config = models_lib.resolve(model)
    gen = torch.Generator(device=device).manual_seed(seed)
    shardings = _shardings(mesh, config)
    if shardings is None:
        return family.init_params(config, gen, device), config
    return family.init_params(config, gen, device, shardings), config


def restore_params(checkpoint: str, device: torch.device, config,
                   mesh=None):
    """(params, config) of a checkpoint directory, layout auto-detected
    as in the reference (:59-69). An HF safetensors checkpoint streams in
    with the geometry its config.json declares, which wins over
    `config`; under a tensor-parallel `mesh` each rank places its own
    slice of each tensor. A port train checkpoint (`train/checkpoints.py`)
    gives its latest complete step's params with `config`, the named
    model's, as the reference gives an Orbax checkpoint's (under a mesh of
    several ranks each entry cut on the host to this rank's slice, an
    MoE's experts over `expert` too); params that do not fit it
    raise ValueError. An Orbax checkpoint of the JAX package raises
    NotImplementedError."""
    from skypilot_tpu_torch import checkpoints as ckpt_lib
    from skypilot_tpu_torch.train import checkpoints as train_ckpts
    if ckpt_lib.is_hf_checkpoint(checkpoint):
        params, config, _stats = ckpt_lib.load_params(checkpoint,
                                                      device=device,
                                                      mesh=mesh)
        return params, config
    return train_ckpts.restore_params(checkpoint, config, device,
                                      mesh=mesh), config


def build_engine(model: str, *,
                 device: Optional[Union[str, torch.device]] = None,
                 checkpoint: Optional[str] = None,
                 mesh_arg: Optional[str] = None,
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
    HF safetensors directory (its geometry wins over `model`) or a port
    train checkpoint of `model` (`restore_params`), or are drawn from
    `seed`.
    `prefix_cache=None` follows SKYTPU_PREFIX_CACHE (on), as the
    reference's build_engine does. `draft_model` attaches a same-vocab
    draft for speculative decode: from `draft_checkpoint`, or drawn from
    its own generator seeded `seed + 1` (the reference draws the target
    from key 0 and the draft from key 1).
    `mesh_arg` ('tensor=2', 'expert=2,tensor=2', 'fsdp=2', 'context=2',
    as the reference's :52-56) builds the mesh from the gang variables
    (`parallel.mesh_from_env`): this process is one rank, on its own
    device, with its slice of the same weights, a draft's too (drawn or
    imported cut); rank 0 takes the requests and the others run
    `engine.follow()`.
    What the mesh cannot serve raises before any weight is drawn
    (`engine.check_mesh`)."""
    from skypilot_tpu_torch import device as device_lib
    from skypilot_tpu_torch import models as models_lib
    from skypilot_tpu_torch.inference import engine as engine_lib

    mesh = None
    if mesh_arg:
        from skypilot_tpu_torch.parallel import mesh as mesh_lib
        mesh = mesh_lib.mesh_from_env(mesh_lib.MeshSpec.parse(mesh_arg),
                                      device)
        dev = mesh.device
    else:
        dev = device_lib.resolve_device(device)
    if mesh is not None and not checkpoint:
        engine_lib.check_mesh(
            mesh, models_lib.resolve(model)[1],
            models_lib.resolve(draft_model)[1]
            if draft_model and not draft_checkpoint else None)
    if checkpoint:
        params, config = restore_params(checkpoint, dev,
                                        models_lib.resolve(model)[1], mesh)
    else:
        params, config = draw_params(model, seed, dev, mesh)
    draft = None
    if draft_model:
        draft = (restore_params(draft_checkpoint, dev,
                                models_lib.resolve(draft_model)[1], mesh)
                 if draft_checkpoint
                 else draw_params(draft_model, seed + 1, dev, mesh))
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
                           mesh=mesh, device=dev)
