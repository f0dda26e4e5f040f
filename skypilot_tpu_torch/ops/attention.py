"""Attention ops: dense, blockwise (online softmax) and the dispatcher.

Ports `skypilot_tpu/ops/attention.py`: `_repeat_kv` (:30),
`dense_attention` (:40), `_block_update` (:79), `_finalize` (:108),
`blockwise_attention` (:114) and the `attention` dispatcher (:287).
Shapes: q [B,Sq,H,D], k/v [B,Skv,KV,D] -> [B,Sq,H,D]. Dense and
blockwise are plain tensor ops, differentiable through torch; `flash`
goes to `ops/flash_attention.py` (K1 forward, K3/K4 backward on the
card). Ring attention waits for the parallel slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

_NEG_INF = -1e30


def _repeat_kv(kv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B,S,KV,D] -> [B,S,H,D] by repeating each kv head H/KV times."""
    b, s, hkv, d = kv.shape
    if hkv == num_heads:
        return kv
    reps = num_heads // hkv
    return kv[:, :, :, None, :].expand(b, s, hkv, reps, d).reshape(
        b, s, num_heads, d)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0,
                    kv_offset: int = 0, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention. q_offset/kv_offset are the global
    positions of element 0; window: q attends k iff q_pos - k_pos <
    window (|q_pos - k_pos| < window when not causal); softcap:
    cap * tanh(scores / cap). Scores are f32, probabilities are cast to
    v's dtype before the value product, as in the reference."""
    num_heads = q.shape[2]
    k = _repeat_kv(k, num_heads)
    v = _repeat_kv(v, num_heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    dev = q.device
    q_pos = q_offset + torch.arange(q.shape[1], device=dev)
    k_pos = kv_offset + torch.arange(k.shape[1], device=dev)
    mask = None
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    elif window is not None:
        mask = (q_pos[:, None] - k_pos[None, :]).abs() < window
    if mask is not None:
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum('bhqk,bkhd->bqhd', probs.float(),
                        v.float()).to(v.dtype)


def _block_update(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor], acc_o: torch.Tensor,
                  acc_m: torch.Tensor, acc_l: torch.Tensor,
                  softcap: Optional[float] = None):
    """One online-softmax step: fold a KV block (heads already repeated)
    into acc_o [B,Q,H,D] f32 and acc_m/acc_l [B,H,Q] f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    new_m = torch.maximum(acc_m, scores.amax(dim=-1))
    # safe_m: rows whose keys so far are all masked shift by 0, so their
    # probabilities stay exactly 0.
    safe_m = torch.where(new_m <= _NEG_INF * 0.5, torch.zeros_like(new_m),
                         new_m)
    probs = torch.exp(scores - safe_m[..., None])
    correction = torch.exp(acc_m - safe_m)
    new_l = acc_l * correction + probs.sum(dim=-1)
    pv = torch.einsum('bhqk,bkhd->bqhd', probs.to(v.dtype).float(),
                      v.float())
    new_o = acc_o * correction.permute(0, 2, 1)[..., None] + pv
    return new_o, new_m, new_l


def _finalize(acc_o: torch.Tensor, acc_l: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    norm = acc_l.permute(0, 2, 1)[..., None]
    norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    return (acc_o / norm).to(dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, block_size: int = 512,
                        q_offset: int = 0, kv_offset: int = 0,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Memory-efficient attention: an online softmax over KV blocks of
    `block_size`, never materialising the full [Q,K] score matrix in the
    forward. window/softcap as in `dense_attention` (a non-causal window
    is symmetric)."""
    b, q_len, num_heads, _ = q.shape
    kv_len = k.shape[1]
    k = _repeat_kv(k, num_heads)
    v = _repeat_kv(v, num_heads)
    block_size = max(1, min(block_size, kv_len))
    dev = q.device
    q_pos = q_offset + torch.arange(q_len, device=dev)
    acc_o = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    acc_m = torch.full((b, num_heads, q_len), _NEG_INF, dtype=torch.float32,
                       device=dev)
    acc_l = torch.zeros((b, num_heads, q_len), dtype=torch.float32,
                        device=dev)
    for k0 in range(0, kv_len, block_size):
        k_blk = k[:, k0:k0 + block_size]
        v_blk = v[:, k0:k0 + block_size]
        k_pos = kv_offset + k0 + torch.arange(k_blk.shape[1], device=dev)
        mask = torch.ones((q_len, k_blk.shape[1]), dtype=torch.bool,
                          device=dev)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
            if not causal:
                mask = mask & (k_pos[None, :] - q_pos[:, None] < window)
        acc_o, acc_m, acc_l = _block_update(q, k_blk, v_blk,
                                            mask[None, None], acc_o, acc_m,
                                            acc_l, softcap=softcap)
    return _finalize(acc_o, acc_l, q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, impl: str = 'dense',
              block_size: int = 512, window: Optional[int] = None,
              softcap: Optional[float] = None) -> torch.Tensor:
    """Dispatch: 'dense' | 'blockwise' | 'flash' ('ring' waits for the
    parallel slice). window/softcap run in the flash kernels; the one
    flash fallback is a non-causal window, which goes to blockwise, as in
    the reference."""
    if impl == 'ring':
        raise NotImplementedError(
            "ring attention is not ported yet: it comes with the parallel "
            "slice (mesh, sharding, ring over NCCL; ROADMAP.md, Queue 1)")
    if impl == 'blockwise' or (impl == 'flash' and window is not None
                               and not causal):
        return blockwise_attention(q, k, v, causal=causal,
                                   block_size=block_size, window=window,
                                   softcap=softcap)
    if impl == 'flash':
        from skypilot_tpu_torch.ops import flash_attention as fa
        return fa.flash_attention(q, k, v, causal, block_size, block_size,
                                  window=window, softcap=softcap)
    if impl == 'dense':
        return dense_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    raise ValueError(f'Unknown attention impl {impl!r}; '
                     "expected 'dense' | 'blockwise' | 'ring' | 'flash'")
