"""Attention ops: dense, blockwise (online softmax), ring and the
dispatcher.

Ports `skypilot_tpu/ops/attention.py`: `_repeat_kv` (:30),
`dense_attention` (:40), `_block_update` (:79), `_finalize` (:108),
`blockwise_attention` (:114), `ring_attention` (:170) and the
`attention` dispatcher (:287). Shapes: q [B,Sq,H,D], k/v [B,Skv,KV,D]
-> [B,Sq,H,D]. Dense and blockwise are plain tensor ops, differentiable
through torch; `flash` goes to `ops/flash_attention.py` (K1 forward,
K3/K4 backward on the card).

Under a mesh with a `context` axis the tensors are this rank's slice of
the sequence. `ring_attention` is the reference's: each rank folds the
K/V block it holds into an online softmax, then passes the block on to
the next rank (`parallel.collectives.shift`, differentiable), ring-size
times, the mask at global positions. On CUDA the ring runs the flash
kernels per hop (`flash_attention.ring_flash_attention`: K1 forward,
K3/K4 backward). Any other impl under `context` gathers K/V over the
axis and attends at this rank's query offset.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from skypilot_tpu_torch.parallel import collectives

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


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Any, axis: str = 'context', causal: bool = True,
                   block_size: int = 512) -> torch.Tensor:
    """Ring attention over `mesh`'s `axis` (the reference's :170-284).

    q/k/v are this rank's contiguous slice of the sequence (rank i holds
    positions [i L, (i+1) L)). Each of ring-size steps folds the K/V
    block this rank holds, at its global offset, into the online
    softmax, sub-block by sub-block ([L, sub] scores), then passes it to
    the next rank. With one rank on the axis it is blockwise attention.
    CUDA tensors run the flash kernels per hop
    (`flash_attention.ring_flash_attention`); CPU tensors this plain
    form, differentiable through `collectives.shift`."""
    ring = mesh.shape[axis]
    if ring == 1:
        return blockwise_attention(q, k, v, causal=causal,
                                   block_size=block_size)
    group = mesh.group(axis)
    if q.is_cuda:
        from skypilot_tpu_torch.ops import flash_attention as fa
        return fa.ring_flash_attention(q, k, v, group, causal=causal,
                                       block_q=block_size,
                                       block_k=block_size)
    b, local_len, num_heads, d = q.shape
    sub = block_size if local_len % block_size == 0 else local_len
    me = mesh.index(axis)
    dev = q.device
    q_pos = me * local_len + torch.arange(local_len, device=dev)
    acc_o = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    acc_m = torch.full((b, num_heads, local_len), _NEG_INF,
                       dtype=torch.float32, device=dev)
    acc_l = torch.zeros((b, num_heads, local_len), dtype=torch.float32,
                        device=dev)
    k_blk, v_blk, blk = k, v, me
    for step in range(ring):
        for s0 in range(0, local_len, sub):
            k_pos = blk * local_len + s0 + torch.arange(sub, device=dev)
            mask = ((q_pos[:, None] >= k_pos[None, :])[None, None]
                    if causal else None)
            # GQA heads repeat for the local compute only; the ring
            # carries compact K/V.
            acc_o, acc_m, acc_l = _block_update(
                q, _repeat_kv(k_blk[:, s0:s0 + sub], num_heads),
                _repeat_kv(v_blk[:, s0:s0 + sub], num_heads), mask, acc_o,
                acc_m, acc_l)
        if step < ring - 1:
            k_blk = collectives.shift(k_blk, group)
            v_blk = collectives.shift(v_blk, group)
            blk = (blk - 1) % ring
    return _finalize(acc_o, acc_l, q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, impl: str = 'dense',
              mesh: Optional[Any] = None, block_size: int = 512,
              window: Optional[int] = None,
              softcap: Optional[float] = None) -> torch.Tensor:
    """Dispatch: 'dense' | 'blockwise' | 'ring' | 'flash'. window/softcap
    run in the flash kernels; the one flash fallback is a non-causal
    window, which goes to blockwise, as in the reference. 'ring' needs a
    mesh and takes no window or softcap (it raises, as the reference's
    :304-310). Any other impl under a mesh whose `context` axis is
    larger than 1 gathers K/V over it (`collectives.gather_weight`: the
    gradient reduce-scattered back) and attends at this rank's global
    query offset."""
    if impl == 'ring':
        if mesh is None:
            raise ValueError('ring attention requires a mesh')
        if window is not None or softcap is not None:
            raise ValueError('ring attention does not support '
                             'window/softcap; use blockwise')
        return ring_attention(q, k, v, mesh, causal=causal,
                              block_size=block_size)
    q_offset = 0
    if mesh is not None and mesh.shape['context'] > 1:
        group = mesh.group('context')
        k = collectives.gather_weight(k, group, 1)
        v = collectives.gather_weight(v, group, 1)
        q_offset = mesh.index('context') * q.shape[1]
    if impl == 'blockwise' or (impl == 'flash' and window is not None
                               and not causal):
        return blockwise_attention(q, k, v, causal=causal,
                                   block_size=block_size, q_offset=q_offset,
                                   window=window, softcap=softcap)
    if impl == 'flash':
        from skypilot_tpu_torch.ops import flash_attention as fa
        offset = {'q_offset': q_offset} if q_offset else {}
        return fa.flash_attention(q, k, v, causal, block_size, block_size,
                                  window=window, softcap=softcap, **offset)
    if impl == 'dense':
        return dense_attention(q, k, v, causal=causal, q_offset=q_offset,
                               window=window, softcap=softcap)
    raise ValueError(f'Unknown attention impl {impl!r}; '
                     "expected 'dense' | 'blockwise' | 'ring' | 'flash'")
