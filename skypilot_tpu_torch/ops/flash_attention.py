"""Flash attention: hand-written CUDA kernels and their plain versions.

Ports `skypilot_tpu/ops/flash_attention.py`:
- the forward, `flash_attention` (:672) and `flash_attention_quant`
  (:632), i.e. the Pallas `_fwd_kernel` (:96) reached through
  `_flash_fwd_impl` (:340) with `quant=False` (K1) and `quant=True` (K2),
  in `csrc/flash_fwd.cu`;
- the backward, `_dq_kernel` (:178, K3) and `_dkv_kernel` (:229, K4)
  reached through `_flash_bwd_impl` (:450), in `csrc/flash_bwd.cu`;
- the `_flash` custom_vjp (:600-629) as `_FlashFn`, a
  `torch.autograd.Function` whose forward is K1 and whose backward is K3
  and K4 (delta = rowsum(dO * O) in one torch op between them);
- ring attention's hops (`ops/attention.py`'s `ring_attention`, the
  reference's :170-284) as `_RingFn`: K1 per hop, the hops' (O, lse)
  merged in f32, and K3/K4 per hop against the merged lse, the dK/dV of
  each block travelling back around the ring to the rank that holds it
  (`ring_flash_attention`);
- context serving's merge (the reference's GSPMD combine of a cache cut
  on its sequence dim) through the same `_merge`: each rank's (O, lse)
  over its span of keys, taken by K1/K2 at `q_offset` minus the span's
  start (negative where the span lies past a chunk's first rows: those
  rows see no key, give O = 0 and lse = +inf, and weigh 0 in the
  merge).
`_build.py` compiles the kernels for sm_90a at first use.

Each public entry point dispatches on where its tensors lie:
- CPU tensors run the plain PyTorch version in this module
  (`flash_attention_plain`, `flash_attention_quant_plain`): the same
  online-softmax recurrence over kv blocks, with the same masking order,
  `safe_m` rule, O = 0 and lse = +inf on fully-masked rows.
- CUDA tensors are checked (dtype, shape, last-dim contiguity, 16-byte
  aligned strides; for every tensor a kernel reads by TMA, q, k and v in
  the forward and q, k, v and dO in the backward, a positive stride on
  every dim wider than 1) and handed to the kernel, or the call raises.
  There is no fallback from the kernel to the plain version.
All four kernels are built for head_dim 64, 128 and 256
(`KERNEL_HEAD_DIMS`); at d 256 the window and the softcap run inside
K3/K4 as inside K1. On CUDA, `flash_attention` refuses a call that
needs a gradient at another head_dim before K1 runs (`check_backward`).

`flash_attention.launches`, `flash_attention_quant.launches`,
`flash_attention_dq.launches` and `flash_attention_dkv.launches` count
kernel launches (plain integers, never the plain version's calls); each
wrapper's `window_launches` splits the same launches by the window they
were given (None or its size), which tells a model's local layers from
its global ones, its `causal_launches` by the causal flag (True or
False), which tells a ring hop's diagonal block from a past one, and
K1's and K2's `offset_launches` by the `q_offset` of a launch given one,
which tells a context rank's chunks apart (negative: the rank's span
lies past the chunk's first row).

K4 differs from the reference in one place: it sums the q heads of a GQA
group inside the kernel in f32 and rounds dK/dV once, where the
reference writes per-q-head bf16 partials and sums them outside
(:537-541, :588-590). The plain version follows the reference's group
sum, in f32.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30
# Head dims the CUDA kernels are instantiated for: K1/K2
# (csrc/flash_fwd.cu) and K3/K4 (csrc/flash_bwd.cu).
KERNEL_HEAD_DIMS = (64, 128, 256)


def _check_args(causal: bool, window, q_offset) -> None:
    if window is not None and not causal:
        raise ValueError('flash window support is causal-only')
    if q_offset is not None and not causal:
        raise ValueError('q_offset (cached-prefill attention) requires '
                         'causal masking')


def _plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, block_k: int, window, softcap: Optional[float],
           q_offset, k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' function in ordinary tensor ops: an online softmax
    over kv blocks of `block_k` positions (reference `_fwd_kernel`).
    Products run in f32 on operands in the input dtype, as the kernel's
    bf16-in / f32-accumulate products do. Returns (O [B,Sq,H,D] in q's
    dtype, lse [B,H,Sq,1] f32)."""
    b, s_q, h, d = q.shape
    s_kv, h_kv = k.shape[1], k.shape[2]
    group = h // h_kv
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    off = int(q_offset) if q_offset is not None else 0
    # [B,KV,G,Sq,D] query groups against [B,KV,S,D] kv heads (no repeat).
    qg = q.reshape(b, s_q, h_kv, group, d).permute(0, 2, 3, 1, 4).float()
    q_pos = off + torch.arange(s_q, device=dev)
    acc = torch.zeros(b, h_kv, group, s_q, d, dtype=torch.float32,
                      device=dev)
    m = torch.full((b, h_kv, group, s_q, 1), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    bk = max(1, min(block_k, s_kv))
    for k0 in range(0, s_kv, bk):
        kb = k[:, k0:k0 + bk].to(q.dtype).permute(0, 2, 1, 3)  # [B,KV,bk,D]
        vb = v[:, k0:k0 + bk].to(q.dtype).permute(0, 2, 1, 3)
        s = torch.matmul(qg, kb.float()[:, :, None].transpose(-1, -2))
        s = s * scale                                      # [B,KV,G,Sq,bk]
        if k_scale is not None:
            s = s * k_scale[:, k0:k0 + bk].permute(0, 2, 1)[:, :, None,
                                                             None, :]
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        if causal:
            k_pos = k0 + torch.arange(kb.shape[2], device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask = mask & (q_pos[:, None] - k_pos[None, :]
                               < int(window))
            s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        safe_m = torch.where(m_new <= _NEG_INF * 0.5,
                             torch.zeros_like(m_new), m_new)
        p = torch.exp(s - safe_m)
        corr = torch.exp(m - safe_m)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        if v_scale is not None:
            p = p * v_scale[:, k0:k0 + bk].permute(0, 2, 1)[:, :, None,
                                                             None, :]
        pv = torch.matmul(p.to(vb.dtype).float(), vb.float()[:, :, None])
        acc = acc * corr + pv
        m = m_new
    norm = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / norm).to(q.dtype)                         # [B,KV,G,Sq,D]
    safe_m = torch.where(m <= _NEG_INF * 0.5, torch.zeros_like(m), m)
    lse = torch.where(l > 0.0,
                      safe_m + torch.log(torch.clamp(l, min=1e-37)),
                      torch.full_like(l, math.inf))
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s_q, h, d)
    return out, lse.reshape(b, h, s_q, 1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          block_q: int = 512, block_k: int = 512,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          q_offset: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1. Returns (O, lse)."""
    del block_q  # the recurrence is row-independent
    _check_args(causal, window, q_offset)
    return _plain(q, k, v, causal, block_k, window, softcap, q_offset)


def flash_attention_quant_plain(q: torch.Tensor, k_q: torch.Tensor,
                                k_scale: torch.Tensor, v_q: torch.Tensor,
                                v_scale: torch.Tensor, causal: bool = True,
                                block_q: int = 512, block_k: int = 512,
                                window: Optional[int] = None,
                                softcap: Optional[float] = None,
                                q_offset: Optional[int] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 (int8 K/V, f32 per-position scales
    [B,Skv,KV]). Returns (O, lse)."""
    del block_q
    _check_args(causal, window, q_offset)
    return _plain(q, k_q, v_q, causal, block_k, window, softcap, q_offset,
                  k_scale=k_scale, v_scale=v_scale)


def _plain_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
               causal: bool, block_k: int, window, softcap: Optional[float],
               q_offset, want_dq: bool = True, want_dkv: bool = True
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                          Optional[torch.Tensor]]:
    """K3 and K4 in ordinary tensor ops, kv block by kv block (reference
    `_dq_kernel` / `_dkv_kernel`): P = exp(S - lse) recomputed from the
    saved lse, dP = dO V^T, dS = P (dP - delta) (times 1 - tanh^2 under
    softcap) times the scale; dQ = dS K, and per q head dV = P^T dO,
    dK = dS^T Q, summed over the GQA group in f32. Products run in f32
    on operands in the input dtype, with P and dS cast to it before
    their products, as the kernels' bf16-in / f32-accumulate products
    do. lse [B,H,Sq,1] f32 (+inf on rows with no visible key gives
    P = 0), delta [B,H,Sq] f32. Returns (dq, dk, dv); the parts not
    wanted are None."""
    b, s_q, h, d = q.shape
    s_kv, h_kv = k.shape[1], k.shape[2]
    group = h // h_kv
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    off = int(q_offset) if q_offset is not None else 0
    # [B,KV,G,Sq,D] query groups against [B,KV,S,D] kv heads.
    def grouped(t):
        return t.reshape(b, s_q, h_kv, group, d).permute(0, 2, 3, 1, 4)
    qg, dog = grouped(q), grouped(do)
    lse_g = lse.reshape(b, h_kv, group, s_q, 1)
    delta_g = delta.reshape(b, h_kv, group, s_q, 1)
    q_pos = off + torch.arange(s_q, device=dev)
    dq = (torch.zeros(b, h_kv, group, s_q, d, dtype=torch.float32,
                      device=dev) if want_dq else None)
    dk_blocks, dv_blocks = [], []
    bk = max(1, min(block_k, s_kv))
    for k0 in range(0, s_kv, bk):
        kb = k[:, k0:k0 + bk].permute(0, 2, 1, 3)[:, :, None]  # [B,KV,1,bk,D]
        vb = v[:, k0:k0 + bk].permute(0, 2, 1, 3)[:, :, None]
        s = torch.matmul(qg.float(), kb.float().transpose(-1, -2)) * scale
        t = None
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = softcap * t
        if causal:
            k_pos = k0 + torch.arange(kb.shape[3], device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask = mask & (q_pos[:, None] - k_pos[None, :]
                               < int(window))
            s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
        p = torch.exp(s - lse_g)                           # [B,KV,G,Sq,bk]
        dp = torch.matmul(dog.float(), vb.float().transpose(-1, -2))
        ds = p * (dp - delta_g)
        if t is not None:
            ds = ds * (1.0 - t * t)
        ds = (ds * scale).to(q.dtype).float()
        if want_dq:
            dq = dq + torch.matmul(ds, kb.float())
        if want_dkv:
            pt = p.to(do.dtype).float().transpose(-1, -2)
            dv_blocks.append(torch.matmul(pt, dog.float()).sum(dim=2))
            dk_blocks.append(torch.matmul(ds.transpose(-1, -2),
                                          qg.float()).sum(dim=2))
    if want_dq:
        dq = dq.permute(0, 3, 1, 2, 4).reshape(b, s_q, h, d).to(q.dtype)
    dk = dv = None
    if want_dkv:                                          # [B,KV,Skv,D]
        dk = torch.cat(dk_blocks, dim=2).permute(0, 2, 1, 3).to(k.dtype)
        dv = torch.cat(dv_blocks, dim=2).permute(0, 2, 1, 3).to(v.dtype)
    return dq, dk, dv


def bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, [B,H,Sq] (reference :463-466)."""
    return torch.einsum('bshd,bshd->bhs', do.float(), o.float())


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True, block_q: int = 512,
                              block_k: int = 512,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              q_offset: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch version of K3 and K4: (dq, dk, dv) of the flash
    attention whose forward gave (o, lse)."""
    del block_q  # the recurrence is row-independent
    _check_args(causal, window, q_offset)
    return _plain_bwd(q, k, v, do, lse, bwd_delta(o, do), causal, block_k,
                      window, softcap, q_offset)


def _tma_strides(t: torch.Tensor, name: str) -> Tuple[int, int, int]:
    """(batch, seq, head) strides in elements of a tensor a kernel reads by
    TMA (q, k, v in the forward; q, k, v, dO in the backward): the last
    dim contiguous, the base pointer and every stride a multiple of 16
    bytes, and a positive stride on every dim wider than 1 (a broadcast
    view, stride 0, cannot be described by a tensor map)."""
    if t.stride(-1) != 1:
        raise ValueError(f'{name}: last dim must be contiguous, strides '
                         f'{tuple(t.stride())}')
    per16 = 16 // t.element_size()
    st = t.stride()[:3]
    if any(s % per16 for s in st) or t.data_ptr() % 16:
        raise ValueError(f'{name}: strides {tuple(t.stride())} and the '
                         'base pointer must be 16-byte aligned')
    if any(s <= 0 and n > 1 for s, n in zip(st, t.shape[:3])):
        raise ValueError(f'{name}: strides {tuple(t.stride())}: the TMA '
                         'tensor map needs a positive stride on every dim '
                         'wider than 1 (materialise broadcast views)')
    return st


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window, softcap: Optional[float], q_offset,
            k_scale: Optional[torch.Tensor] = None,
            v_scale: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the CUDA tensors and launch K1 (bf16) or K2 (int8)."""
    from skypilot_tpu_torch.ops import _build

    quant = k_scale is not None
    _check_attn_args(q, k, v, torch.int8 if quant else torch.bfloat16)
    b, s_q, h, d = q.shape
    tensors = [q, k, v] + ([k_scale, v_scale] if quant else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError('all inputs must be on one CUDA device')
    if quant:
        for name, sc in (('k_scale', k_scale), ('v_scale', v_scale)):
            if sc.shape != k.shape[:3] or sc.dtype != torch.float32:
                raise ValueError(f'{name} must be f32 {tuple(k.shape[:3])}, '
                                 f'got {sc.dtype} {tuple(sc.shape)}')
    if softcap is not None and softcap <= 0:
        raise ValueError(f'softcap must be positive, got {softcap}')
    out = torch.empty(b, s_q, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, s_q, 1, dtype=torch.float32, device=q.device)
    if s_q == 0 or b == 0:
        return out, lse
    lib = _build.library()
    prm = _build.FlashParams()
    prm.q, prm.k, prm.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    prm.o, prm.lse = out.data_ptr(), lse.data_ptr()
    (prm.q_sb, prm.q_ss, prm.q_sh) = _tma_strides(q, 'q')
    (prm.k_sb, prm.k_ss, prm.k_sh) = _tma_strides(k, 'k')
    (prm.v_sb, prm.v_ss, prm.v_sh) = _tma_strides(v, 'v')
    (prm.o_sb, prm.o_ss, prm.o_sh) = out.stride()[:3]
    if quant:
        prm.ks, prm.vs = k_scale.data_ptr(), v_scale.data_ptr()
        (prm.ks_sb, prm.ks_ss, prm.ks_sh) = k_scale.stride()
        (prm.vs_sb, prm.vs_ss, prm.vs_sh) = v_scale.stride()
    prm.B, prm.Sq, prm.Skv, prm.H, prm.KV, prm.D = (b, s_q, k.shape[1], h,
                                                    k.shape[2], d)
    prm.causal = int(causal)
    prm.windowed = int(window is not None)
    prm.window = int(window) if window is not None else 0
    prm.q_offset = int(q_offset) if q_offset is not None else 0
    prm.scale = 1.0 / math.sqrt(d)
    prm.softcap = float(softcap) if softcap is not None else 0.0
    fn = lib.skytpu_flash_fwd_int8 if quant else lib.skytpu_flash_fwd_bf16
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(ctypes.byref(prm), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f'flash forward kernel launch failed: CUDA '
                           f'error {err}')
    _count(flash_attention_quant if quant else flash_attention, window,
           causal, q_offset)
    return out, lse


def _count(wrapper, window, causal, q_offset=None) -> None:
    """One launch of `wrapper`'s kernel, also tallied under its window,
    under its causal flag and, given one, under its q_offset."""
    wrapper.launches += 1
    key = None if window is None else int(window)
    wrapper.window_launches[key] = wrapper.window_launches.get(key, 0) + 1
    flag = bool(causal)
    wrapper.causal_launches[flag] = wrapper.causal_launches.get(flag, 0) + 1
    if q_offset is not None:
        off = int(q_offset)
        wrapper.offset_launches[off] = wrapper.offset_launches.get(off,
                                                                   0) + 1


def _check_attn_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_dtype: torch.dtype) -> None:
    """Shapes, head_dim (one of KERNEL_HEAD_DIMS) and dtypes a kernel
    takes; raises otherwise."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f'want q [B,Sq,H,D], k/v [B,Skv,KV,D]; got '
                         f'{tuple(q.shape)} {tuple(k.shape)} '
                         f'{tuple(v.shape)}')
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f'incompatible q {tuple(q.shape)} and kv '
                         f'{tuple(k.shape)}')
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f'head_dim {d} not in the kernel\'s '
                         f'{KERNEL_HEAD_DIMS}')
    if q.dtype != torch.bfloat16:
        raise TypeError(f'q must be bfloat16, got {q.dtype}')
    if k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise TypeError(f'k/v must be {kv_dtype}, got {k.dtype}/{v.dtype}')


def _launch_bwd(which: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                delta: torch.Tensor, causal: bool, window,
                softcap: Optional[float], q_offset):
    """Check the CUDA tensors and launch K3 (`which='dq'`, returns dq) or
    K4 (`which='dkv'`, returns (dk, dv)). Both read q, k, v and dO by TMA;
    lse and delta by plain loads, as contiguous f32 [B,H,Sq]."""
    from skypilot_tpu_torch.ops import _build

    _check_attn_args(q, k, v, torch.bfloat16)
    b, s_q, h, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f'dO must be {q.dtype} {tuple(q.shape)}, got '
                         f'{do.dtype} {tuple(do.shape)}')
    for name, t in (('lse', lse), ('delta', delta)):
        if (t.dtype != torch.float32 or t.numel() != b * h * s_q
                or t.shape[:3] != (b, h, s_q) or not t.is_contiguous()):
            raise ValueError(f'{name} must be contiguous f32 [B,H,Sq], got '
                             f'{t.dtype} {tuple(t.shape)}')
    if any(t.device != q.device for t in (k, v, do, lse, delta)):
        raise ValueError('all inputs must be on one CUDA device')
    if softcap is not None and softcap <= 0:
        raise ValueError(f'softcap must be positive, got {softcap}')
    prm = _build.FlashBwdParams()
    prm.q, prm.k, prm.v, prm.dout = (q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), do.data_ptr())
    prm.lse, prm.delta = lse.data_ptr(), delta.data_ptr()
    (prm.q_sb, prm.q_ss, prm.q_sh) = _tma_strides(q, 'q')
    (prm.k_sb, prm.k_ss, prm.k_sh) = _tma_strides(k, 'k')
    (prm.v_sb, prm.v_ss, prm.v_sh) = _tma_strides(v, 'v')
    (prm.do_sb, prm.do_ss, prm.do_sh) = _tma_strides(do, 'dO')
    if which == 'dq':
        dq = torch.empty_like(q, memory_format=torch.contiguous_format)
        prm.dq = dq.data_ptr()
        (prm.dq_sb, prm.dq_ss, prm.dq_sh) = dq.stride()[:3]
        out = dq
    else:
        dk = torch.empty_like(k, memory_format=torch.contiguous_format)
        dv = torch.empty_like(v, memory_format=torch.contiguous_format)
        prm.dk, prm.dv = dk.data_ptr(), dv.data_ptr()
        (prm.dk_sb, prm.dk_ss, prm.dk_sh) = dk.stride()[:3]
        (prm.dv_sb, prm.dv_ss, prm.dv_sh) = dv.stride()[:3]
        out = (dk, dv)
    if b == 0 or s_q == 0 or k.shape[1] == 0:
        if which == 'dq':
            return dq.zero_()
        return dk.zero_(), dv.zero_()
    lib = _build.library()
    prm.B, prm.Sq, prm.Skv, prm.H, prm.KV, prm.D = (b, s_q, k.shape[1], h,
                                                    k.shape[2], d)
    prm.causal = int(causal)
    prm.windowed = int(window is not None)
    prm.window = int(window) if window is not None else 0
    prm.q_offset = int(q_offset) if q_offset is not None else 0
    prm.scale = 1.0 / math.sqrt(d)
    prm.softcap = float(softcap) if softcap is not None else 0.0
    fn = lib.skytpu_flash_bwd_dq if which == 'dq' else lib.skytpu_flash_bwd_dkv
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(ctypes.byref(prm), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f'flash backward ({which}) kernel launch failed: '
                           f'CUDA error {err}')
    _count(flash_attention_dq if which == 'dq' else flash_attention_dkv,
           window, causal)
    return out


def _bwd_device(q: torch.Tensor) -> str:
    if q.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {q.device}')
    return q.device.type


def flash_attention_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, causal: bool = True,
                       block_k: int = 512, window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       q_offset: Optional[int] = None) -> torch.Tensor:
    """dQ (K3) from the forward's lse [B,H,Sq,1] and delta [B,H,Sq]: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    _check_args(causal, window, q_offset)
    if _bwd_device(q) == 'cpu':
        return _plain_bwd(q, k, v, do, lse, delta, causal, block_k, window,
                          softcap, q_offset, want_dkv=False)[0]
    return _launch_bwd('dq', q, k, v, do, lse, delta, causal, window,
                       softcap, q_offset)


def flash_attention_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, causal: bool = True,
                        block_k: int = 512, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        q_offset: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) (K4), GQA groups summed: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    _check_args(causal, window, q_offset)
    if _bwd_device(q) == 'cpu':
        return _plain_bwd(q, k, v, do, lse, delta, causal, block_k, window,
                          softcap, q_offset, want_dq=False)[1:]
    return _launch_bwd('dkv', q, k, v, do, lse, delta, causal, window,
                       softcap, q_offset)


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool = True, block_q: int = 512, block_k: int = 512,
              window: Optional[int] = None, softcap: Optional[float] = None,
              q_offset: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) through `flash_attention_dq` and `flash_attention_dkv`:
    K3 and K4 for CUDA tensors (no path to the plain version), the plain
    backward for CPU tensors."""
    del block_q
    delta = bwd_delta(o, do)
    kw = dict(causal=causal, block_k=block_k, window=window, softcap=softcap,
              q_offset=q_offset)
    dq = flash_attention_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):
    """The reference's `_flash` custom_vjp: forward K1 (saving q, k, v, O
    and lse), backward K3 and K4; the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, window, softcap,
                q_offset):
        out, lse = flash_fwd(q, k, v, causal, block_q, block_k, window,
                             softcap, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, block_q, block_k, window, softcap, q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do.contiguous(),
                               *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, block_q: int = 512, block_k: int = 512,
              window: Optional[int] = None,
              softcap: Optional[float] = None,
              q_offset: Optional[int] = None,
              k_scale: Optional[torch.Tensor] = None,
              v_scale: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, lse) of K1, or of K2 when scales are given: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    _check_args(causal, window, q_offset)
    if q.device.type == 'cpu':
        return _plain(q, k, v, causal, block_k, window, softcap, q_offset,
                      k_scale=k_scale, v_scale=v_scale)
    if q.device.type != 'cuda':
        raise ValueError(f'unsupported device {q.device}')
    return _launch(q, k, v, causal, window, softcap, q_offset,
                   k_scale=k_scale, v_scale=v_scale)


def check_backward(device: torch.device, head_dim: int,
                   needs_grad: bool) -> None:
    """Refuse, before any kernel launches, a flash call on `device` whose
    backward has no kernel: on CUDA, a head_dim outside KERNEL_HEAD_DIMS
    with a gradient to take. The CPU's plain versions take any
    head_dim."""
    if (needs_grad and device.type == 'cuda'
            and head_dim not in KERNEL_HEAD_DIMS):
        raise NotImplementedError(
            f'flash attention with head_dim {head_dim} needs a gradient '
            f'on {device}, but the kernels are built for head_dim '
            f'{KERNEL_HEAD_DIMS} only (ROADMAP.md, Queue 2: a new head_dim '
            'is a new kernel instance). Train it on the CPU.')


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 512,
                    block_k: int = 512, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_offset: Optional[int] = None) -> torch.Tensor:
    """Flash attention. q [B,Sq,H,D], k/v [B,Skv,KV,D] -> [B,Sq,H,D].

    Differentiable: forward K1, backward K3 and K4 (`_FlashFn`). On CUDA
    a call that needs a gradient at a head_dim K3/K4 are not built for
    raises before K1 runs (`check_backward`).
    window: position q attends k iff q_pos - k_pos < window (causal
    only). softcap: cap * tanh(s / cap). q_offset: global position of q
    row 0 (cached-prefill chunk against a longer cache; causal only).
    block_q/block_k shape only the plain version's blocking."""
    check_backward(q.device, q.shape[-1], torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v)))
    return _FlashFn.apply(q, k, v, causal, block_q, block_k, window,
                          softcap, q_offset)


def _hop_causal(me: int, src: int, causal: bool) -> Optional[bool]:
    """How rank `me`'s queries attend the block rank `src` holds (both
    contiguous slices of one length): the causal mask at no offset (the
    diagonal block), all of it (a past block, or no causal mask), or
    None: a block wholly in the future, which no kernel runs."""
    if not causal:
        return False
    if src == me:
        return True
    return False if src < me else None


def _merge(o_acc, lse_acc, o, lse):
    """Fold one partial's (O [B,S,H,D], lse [B,H,S,1]) into the f32
    running (O, lse) of the partials before it over disjoint key sets (a
    ring hop's block, a context rank's span). A row the partial sees no
    key in has lse = +inf there (the kernels' and `_plain`'s convention)
    and weighs 0, where logaddexp would let it win; a row no partial
    sees keeps O = 0 and lse = +inf."""
    o = o.float()
    if o_acc is None:
        return o, lse
    unseen_acc, unseen = torch.isposinf(lse_acc), torch.isposinf(lse)
    new = torch.where(unseen_acc, lse, torch.where(
        unseen, lse_acc, torch.logaddexp(lse_acc, lse)))
    scale_acc = torch.where(unseen_acc, 0.0, torch.exp(lse_acc - new))
    scale = torch.where(unseen, 0.0, torch.exp(lse - new))
    return (o_acc * scale_acc.permute(0, 2, 1, 3)
            + o * scale.permute(0, 2, 1, 3), new)


class _RingFn(torch.autograd.Function):
    """Ring attention through the flash kernels. Forward: the K/V block
    of each hop (rank `me` holds block `me - hop` at hop `hop`) through
    K1 with that block's mask (`_hop_causal`; a block wholly in the
    future is skipped), the hops' (O, lse) merged in f32, then passed on
    (`collectives.send_recv`). Backward: delta = rowsum(dO * O) of the
    merged O; per hop K3 (dQ, summed in f32 here) and K4 (the block's dK,
    dV) against the MERGED lse; each block's dK/dV (f32) gathers its
    ranks' parts as it travels the ring, arriving at its owner after
    ring-size - 1 passes."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, block_q, block_k):
        from skypilot_tpu_torch.parallel import collectives
        n, me = collectives.group_size(group), collectives.group_rank(group)
        blocks = []
        o_acc = lse_acc = None
        k_blk, v_blk = k, v
        for hop in range(n):
            mode = _hop_causal(me, (me - hop) % n, causal)
            blocks += [k_blk, v_blk]
            if mode is not None:
                o, lse = flash_fwd(q, k_blk, v_blk, mode, block_q, block_k)
                o_acc, lse_acc = _merge(o_acc, lse_acc, o, lse)
            if hop < n - 1:
                k_blk = collectives.send_recv(k_blk, group, 1)
                v_blk = collectives.send_recv(v_blk, group, 1)
        out = o_acc.to(q.dtype)
        ctx.save_for_backward(q, out, lse_acc.contiguous(), *blocks)
        ctx.args = (group, causal, block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        from skypilot_tpu_torch.parallel import collectives
        q, out, lse, *blocks = ctx.saved_tensors
        group, causal, block_k = ctx.args
        n, me = collectives.group_size(group), collectives.group_rank(group)
        do = do.contiguous()
        delta = bwd_delta(out, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = dv = None
        # At pass s this rank holds the running dK/dV of block me-1-s,
        # the block of its hop s+1 (mod n): the last pass's is its own.
        for s in range(n):
            hop = (s + 1) % n
            k_blk, v_blk = blocks[2 * hop], blocks[2 * hop + 1]
            if s:
                dk = collectives.send_recv(dk, group, 1)
                dv = collectives.send_recv(dv, group, 1)
            else:
                dk = torch.zeros(k_blk.shape, dtype=torch.float32,
                                 device=q.device)
                dv = torch.zeros_like(dk)
            mode = _hop_causal(me, (me - hop) % n, causal)
            if mode is None:
                continue
            kw = dict(causal=mode, block_k=block_k)
            dq += flash_attention_dq(q, k_blk, v_blk, do, lse, delta,
                                     **kw).float()
            pk, pv = flash_attention_dkv(q, k_blk, v_blk, do, lse, delta,
                                         **kw)
            dk += pk.float()
            dv += pv.float()
        return (dq.to(q.dtype), dk.to(blocks[0].dtype),
                dv.to(blocks[1].dtype), None, None, None, None)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group, causal: bool = True, block_q: int = 512,
                         block_k: int = 512) -> torch.Tensor:
    """Ring attention over `group` (this rank's contiguous slice of the
    sequence in q, k, v; `_RingFn`): K1 per hop taken, K3/K4 per hop in
    the backward, on CUDA; the same hops through the plain versions for
    CPU tensors. A call that needs a gradient at a head_dim K3/K4 are
    not built for raises first (`check_backward`)."""
    check_backward(q.device, q.shape[-1], torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v)))
    return _RingFn.apply(q, k, v, group, causal, block_q, block_k)


def flash_attention_quant(q: torch.Tensor, k_q: torch.Tensor,
                          k_scale: torch.Tensor, v_q: torch.Tensor,
                          v_scale: torch.Tensor, causal: bool = True,
                          block_q: int = 512, block_k: int = 512,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          q_offset: Optional[int] = None) -> torch.Tensor:
    """Flash attention over an int8 KV cache (K2): k_q/v_q
    [B,Skv,KV,D] int8, scales [B,Skv,KV] f32 (the `quantize_kv`
    layout). Forward only."""
    return flash_fwd(q, k_q, v_q, causal, block_q, block_k, window,
                     softcap, q_offset, k_scale=k_scale,
                     v_scale=v_scale)[0]


for _wrapper in (flash_attention, flash_attention_quant, flash_attention_dq,
                 flash_attention_dkv):
    _wrapper.launches = 0
    _wrapper.window_launches = {}
    _wrapper.causal_launches = {}
    _wrapper.offset_launches = {}
del _wrapper
