"""Plain attention: the correctness reference for the rest of the port.

Ports `skypilot_tpu/ops/attention.py`: `_repeat_kv` (:30) and
`dense_attention` (:40). Shapes: q [B,Sq,H,D], k/v [B,Skv,KV,D] ->
[B,Sq,H,D]. Blockwise and ring attention wait for later slices.
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
