"""Collectives that autograd differentiates: the port's stand-in for the
collectives GSPMD inserts into the reference's jitted train step.

Under `jax.jit` a sharding only places an array and the compiler writes
every collective of the forward and of its transpose. PyTorch has no
such pass, so the layer math (`models/llama.py`, `ops/attention.py`)
calls these, each a `torch.autograd.Function` whose backward is the
forward's transpose:

- `copy_to(x, group)`: identity forward, all-reduce backward: the input
  of a column-parallel product (`wq`/`wk`/`wv`, `w_gate`/`w_up`, a
  vocab-parallel head), whose ranks each see a part of its gradient;
- `reduce_from(x, group)`: all-reduce forward, identity backward: the
  output of a row-parallel product (`wo`, `w_down`), the vocab-parallel
  embedding, and a loss summed over the batch and context ranks;
- `gather_from(x, group, dim)`: all-gather forward, this rank's slice of
  the gradient backward: the vocab-parallel logits, whose loss every
  rank of the group computes whole;
- `gather_weight(x, group, dim)`: all-gather forward, reduce-scatter
  backward: an FSDP weight gathered for a layer's forward (and again
  under remat), whose gradient each rank sums over the group and keeps
  its own rows of; also K/V gathered over `context` for an attention
  that is not the ring;
- `shift(x, group, step)`: the ring's neighbour exchange, each rank's
  `x` sent `step` ranks on (the backward sends the gradient back).

The pipeline (`parallel/pipeline.py`) writes its own backward and calls
the plain ops: `send`/`recv` between neighbouring stages along `pipe`
and `broadcast` of the last stage's output to every stage.

Each takes a process group (None, or a group of one rank, makes it the
identity) and runs in the group's own rank order. Serving calls the same
functions under `torch.no_grad()`, where only the forward runs, so its
collectives are the forwards alone: an f32 all-reduce per row-parallel
product and the embedding, an all-gather of the logits.

gloo takes CUDA tensors for all-reduce and all-gather (it stages them
through the host itself) but not for point-to-point or reduce-scatter:
those stage through the host here, openly, in `reduce_scatter`, `send_recv`,
`send` and `recv`; `staged_bytes` counts the bytes each staged op moved
(the pipeline's stage exchange under 'pipe').
Nothing falls back: a collective that fails raises.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

# Bytes the host-staged ops (gloo point-to-point and reduce-scatter on
# CUDA tensors) copied off the device, by op: what staging costs.
staged_bytes = {'shift': 0, 'reduce_scatter': 0, 'pipe': 0}


def group_size(group: Any) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Any) -> int:
    return 0 if group is None else dist.get_rank(group)


def _stages(group: Any, t: torch.Tensor) -> bool:
    """Does an op on `t` over `group` go through the host (gloo on a
    CUDA tensor)?"""
    return t.is_cuda and dist.get_backend(group) == 'gloo'


def all_reduce_(t: torch.Tensor, group: Any) -> torch.Tensor:
    """Sum `t` over `group` in place (no autograd); returns it."""
    if group_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
    """Every rank's `t` concatenated along `dim`, in group rank order
    (no autograd)."""
    n = group_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
    """The sum of `t` over `group`, cut along `dim` into one part per
    rank; this rank's part (no autograd)."""
    n = group_size(group)
    if n == 1:
        return t
    parts = [p.contiguous() for p in t.chunk(n, dim=dim)]
    if _stages(group, t):
        staged_bytes['reduce_scatter'] += t.numel() * t.element_size()
        host = [p.cpu() for p in parts]
        out = torch.empty_like(host[0])
        dist.reduce_scatter(out, host, group=group)
        return out.to(t.device)
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def send_recv(t: torch.Tensor, group: Any, step: int) -> torch.Tensor:
    """Send `t` to the rank `step` places on in `group` and return what
    the rank `step` places back sent (no autograd)."""
    n = group_size(group)
    if n == 1 or step % n == 0:
        return t
    me = group_rank(group)
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    staged = _stages(group, t)
    buf = t.contiguous()
    if staged:
        staged_bytes['shift'] += buf.numel() * buf.element_size()
        buf = buf.cpu()
    out = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf, dst, group),
           dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(t.device) if staged else out


def send(t: torch.Tensor, group: Any, dst: int) -> None:
    """Send `t` to the rank at index `dst` of `group` (no autograd);
    returns once it is sent."""
    buf = t.contiguous()
    if _stages(group, t):
        staged_bytes['pipe'] += buf.numel() * buf.element_size()
        buf = buf.cpu()
    dist.send(buf, dist.get_global_rank(group, dst), group=group)


def recv(like: torch.Tensor, group: Any, src: int) -> torch.Tensor:
    """What the rank at index `src` of `group` sent: a tensor of
    `like`'s shape, dtype and device (no autograd)."""
    staged = _stages(group, like)
    out = torch.empty(like.shape, dtype=like.dtype,
                      device='cpu' if staged else like.device)
    if staged:
        staged_bytes['pipe'] += out.numel() * out.element_size()
    dist.recv(out, dist.get_global_rank(group, src), group=group)
    return out.to(like.device) if staged else out


def broadcast(t: torch.Tensor, group: Any, src: int) -> torch.Tensor:
    """The tensor of the rank at index `src` of `group`, on every rank
    (`t` gives the shape and dtype elsewhere; no autograd)."""
    if group_size(group) == 1:
        return t
    t = t.contiguous()
    dist.broadcast(t, dist.get_global_rank(group, src), group=group)
    return t


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.width = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        lo = group_rank(ctx.group) * ctx.width
        return g.narrow(ctx.dim, lo, ctx.width), None, None


class _GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return send_recv(x, group, step)

    @staticmethod
    def backward(ctx, g):
        return send_recv(g, ctx.group, -ctx.step), None, None


def _live(group: Any) -> bool:
    return group_size(group) > 1


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over `group`."""
    return _CopyTo.apply(x, group) if _live(group) and _grad(x) else x


def reduce_from(x: torch.Tensor, group: Any) -> torch.Tensor:
    """`x` all-reduced over `group`; the gradient passed through. With
    no gradient to take, `x` (a fresh tensor at every call site) is
    reduced in place, as serving always did."""
    if not _live(group):
        return x
    if _grad(x):
        return _ReduceFrom.apply(x, group)
    return all_reduce_(x.contiguous(), group)


def gather_from(x: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
    """`x` all-gathered along `dim`; the gradient's slice of this rank."""
    return _GatherFrom.apply(x, group, dim) if _live(group) else x


def gather_weight(x: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
    """`x` all-gathered along `dim`; the gradient reduce-scattered."""
    return _GatherWeight.apply(x, group, dim) if _live(group) else x


def shift(x: torch.Tensor, group: Any, step: int = 1) -> torch.Tensor:
    """`x` sent `step` ranks on around `group`'s ring; the gradient sent
    back."""
    return _Shift.apply(x, group, step) if _live(group) else x

