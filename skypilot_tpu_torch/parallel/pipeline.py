"""Pipeline parallelism: GPipe microbatching over the `pipe` mesh axis.

Ports `skypilot_tpu/parallel/pipeline.py`: `pipeline_apply` (:37-84),
`_stage_program` (:87-135) and `llama_pipeline_forward` (:156-193).

The reference runs the schedule inside a partial-manual `shard_map`:
each stage holds its contiguous chunk of the stacked layers (the layer
dim over `pipe`), stage 0 injects microbatch t at step t, every stage
runs its layers and `ppermute`s the activation one stage on, and the
last stage records microbatch t - (S-1); after M + S - 1 steps every
microbatch has crossed all S stages. `jax.grad` derives the reverse
schedule. Here one process runs each stage and the schedule is written
out in both directions:
- forward (`_forward`): stage s runs microbatch j at step s + j, taking
  it from stage s - 1 (`collectives.recv`) or, on stage 0, from the
  input, and handing its output to stage s + 1 (`collectives.send`).
  The reference's bubble steps (stage s before step s or after step
  s + M - 1) compute on values it discards, and its ring's wrap-around
  hands stage 0 a value it discards: neither runs here, so the values
  are the same and a stage launches its kernels M times a layer. The
  last stage's outputs are broadcast to every stage (the reference's
  slice of the last stage's slot, :84), so what follows the stack (the
  final norm and the head) runs on every stage, as the reference's
  replicated computation does;
- backward (`_Pipeline.backward`): the reverse GPipe schedule by hand,
  one `torch.autograd.Function` per call, so every stage runs every
  exchange in the same order (an autograd node per exchange would leave
  stage 0's discarded receive without a backward while its neighbour
  waits to send). The forward kept each microbatch's stage input; the
  backward takes the microbatches in reverse, recomputes the stage
  with autograd on (the stage's remat: the layers' own checkpoint is
  not taken again), takes the stage's gradients against the cotangent
  the next stage sent (the last stage: its own output's), and sends the
  input's gradient one stage back. The last stage's cotangent is the
  output's: every stage computed the same head on the same output, so
  the cotangents are equal and none is summed (the transpose of a
  replicated value). Stage 0's input gradients are broadcast to every
  stage: the embedding, replicated over `pipe`, takes the same gradient
  on every stage (the reference's psum over `pipe` of a replicated
  input's cotangent, where only stage 0's is nonzero). Param gradients
  are summed over the microbatches in f32 and cast once.

So each stage launches its attention kernels, per layer it holds, M
times in the forward and M times in the recompute (K1), and M times in
the backward (K3/K4).

Inside a stage every other axis keeps its collectives, as the
reference's partial-manual `shard_map` leaves them to GSPMD (:19-25):
the layer is `llama._layer` under the mesh (tensor, fsdp, context), and
the microbatch is this rank's cut of the batch. Under gloo on the card
the stage exchange stages through the host (`staged_bytes['pipe']`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import mesh as mesh_lib

Params = Dict[str, torch.Tensor]
LayerFn = Callable[[Params, torch.Tensor, int], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class _Schedule:
    """One stage's part of a GPipe run: the layer function, the leaves'
    names, the index of its first layer in the whole stack, the
    microbatch count, and where it sits along `pipe`."""
    layer_fn: LayerFn
    names: tuple
    first: int
    microbatches: int
    stage: int
    stages: int
    group: Any

    def params(self, leaves) -> Params:
        return dict(zip(self.names, leaves))


def _stage_program(local_params: Params, h: torch.Tensor, *,
                   layer_fn: LayerFn, first: int) -> torch.Tensor:
    """One microbatch through this stage's layers (their global indices
    start at `first`)."""
    n = next(iter(local_params.values())).shape[0]
    for i in range(n):
        h = layer_fn({k: v[i] for k, v in local_params.items()}, h,
                     first + i)
    return h


def _forward(s: _Schedule, x: torch.Tensor, leaves: List[torch.Tensor]):
    """The forward schedule (see the module docstring): the stack's
    output on every stage and this stage's inputs, one per microbatch."""
    x_mb = x.reshape(s.microbatches, -1, *x.shape[1:])
    params = s.params(leaves)
    inputs, outs = [], []
    for j in range(s.microbatches):
        h = (x_mb[j] if s.stage == 0
             else collectives.recv(x_mb[j], s.group, s.stage - 1))
        inputs.append(h)
        y = _stage_program(params, h, layer_fn=s.layer_fn, first=s.first)
        if s.stage < s.stages - 1:
            collectives.send(y, s.group, s.stage + 1)
        else:
            outs.append(y)
    out = (torch.stack(outs) if outs else torch.empty_like(x_mb))
    out = collectives.broadcast(out, s.group, s.stages - 1)
    return out.reshape(x.shape), inputs


class _Pipeline(torch.autograd.Function):
    """The forward schedule, with the reverse schedule as its backward."""

    @staticmethod
    def forward(ctx, s, x, *leaves):
        ctx.schedule = s
        out, inputs = _forward(s, x, list(leaves))
        ctx.inputs = inputs
        ctx.save_for_backward(*leaves)
        return out

    @staticmethod
    def backward(ctx, g):
        s = ctx.schedule
        leaves = ctx.saved_tensors
        want = [ctx.needs_input_grad[2 + i] for i in range(len(leaves))]
        g_mb = g.reshape(s.microbatches, -1, *g.shape[1:])
        acc: List[Optional[torch.Tensor]] = [None] * len(leaves)
        dx: List[Optional[torch.Tensor]] = [None] * s.microbatches
        for j in reversed(range(s.microbatches)):
            dy = (g_mb[j] if s.stage == s.stages - 1
                  else collectives.recv(g_mb[j], s.group, s.stage + 1))
            h = ctx.inputs[j].detach().requires_grad_(True)
            ps = [p.detach().requires_grad_(w) for p, w in zip(leaves, want)]
            with torch.enable_grad():
                y = _stage_program(s.params(ps), h, layer_fn=s.layer_fn,
                                   first=s.first)
            wrt = [h] + [p for p, w in zip(ps, want) if w]
            got = iter(torch.autograd.grad(y, wrt, dy, allow_unused=True))
            dh = next(got)
            for i, w in enumerate(want):
                if not w:
                    continue
                gi = next(got)
                if gi is not None:
                    gi = gi.float()
                    acc[i] = gi if acc[i] is None else acc[i].add_(gi)
            if s.stage > 0:
                collectives.send(dh, s.group, s.stage - 1)
            else:
                dx[j] = dh
        del ctx.inputs
        grads = [None if a is None else a.to(p.dtype)
                 for a, p in zip(acc, leaves)]
        return (None, _input_grads(s, dx, g_mb).reshape(g.shape), *grads)


def _input_grads(s: _Schedule, dx: List[Optional[torch.Tensor]],
                 like: torch.Tensor) -> torch.Tensor:
    """Stage 0's input gradients [M, mb, ...] on every stage: the stack's
    input is replicated over `pipe`, so every stage takes the same
    cotangent for it (the embedding's gradient is equal on every
    stage)."""
    dx_all = torch.stack(dx) if s.stage == 0 else torch.empty_like(like)
    return collectives.broadcast(dx_all, s.group, 0)


def pipeline_apply(layer_fn: LayerFn, stacked_params: Params,
                   x: torch.Tensor, mesh: Optional[mesh_lib.Mesh],
                   num_microbatches: Optional[int] = None,
                   num_layers: Optional[int] = None) -> torch.Tensor:
    """Run `x` through the stacked layers, pipelined over `pipe`.

    layer_fn(single_layer_params, activation, i) -> activation, for
    layer i (its index in the whole stack: a layer's window can depend
    on it); it keeps the activation's shape and dtype.
    stacked_params: every leaf with leading dim = layers: the whole
    stack, or this stage's slice (`sharding.stage_shard`) of a stack of
    `num_layers` layers (default: the leaves' leading dim, the whole
    stack).
    x: [batch, ...] activations entering layer 0, the same on every
    stage of the pipe group. Returns activations after the last layer,
    the same shape as x, on every stage.
    """
    names = tuple(sorted(stacked_params))
    have = stacked_params[names[0]].shape[0]
    num_layers = have if num_layers is None else num_layers
    stages = 1 if mesh is None else mesh.shape['pipe']
    if stages == 1:
        return _stage_program(stacked_params, x, layer_fn=layer_fn, first=0)
    batch = x.shape[0]
    m = num_microbatches or stages
    if batch % m:
        raise ValueError(f'batch {batch} % microbatches {m} != 0')
    if num_layers % stages:
        raise ValueError(f'layers {num_layers} % stages {stages} != 0')
    per = num_layers // stages
    stage = mesh.index('pipe')
    leaves = [stacked_params[k] for k in names]
    if have == num_layers:
        leaves = [v.narrow(0, stage * per, per) for v in leaves]
    elif have != per:
        raise ValueError(f'stacked params hold {have} layers: neither the '
                         f'stack of {num_layers} nor a stage of {per}')
    s = _Schedule(layer_fn, names, stage * per, m, stage, stages,
                  mesh.group('pipe'))
    if torch.is_grad_enabled() and (
            x.requires_grad or any(v.requires_grad for v in leaves)):
        return _Pipeline.apply(s, x, *leaves)
    return _forward(s, x, leaves)[0]


# --- llama convenience ------------------------------------------------------


def llama_pipeline_forward(params: Params, tokens: torch.Tensor, config: Any,
                           mesh: Optional[mesh_lib.Mesh],
                           num_microbatches: Optional[int] = None
                           ) -> torch.Tensor:
    """`llama.forward` with the layer stack pipelined over `pipe`:
    tokens [B,S] (this rank's cut) -> logits [B,S,V] f32 on every stage.

    `params['layers']` may be the whole stack or this stage's slice
    (`sharding.stage_shard`); the embedding, the final norm and the head
    are replicated over `pipe` and run on every stage (the embedding's
    output feeds stage 0 only). Inside a stage the layer is
    `llama._layer` under the mesh, so tensor, fsdp and context
    parallelism keep their collectives. Every knob `llama.forward`
    applies applies here too: `embed_scale`, the per-layer windows, the
    final norm's `norm_plus_one`, tied embeddings and
    `final_logit_softcap` (the reference's version skips them: ROADMAP.md
    Queue 3). With one stage it is `llama.forward`."""
    from skypilot_tpu_torch.models import llama
    c = config
    with mesh_lib.use_mesh(mesh):
        if mesh is None or mesh.shape['pipe'] == 1:
            return llama.forward(params, tokens, c)
        # Global positions: a context rank's slice starts where the
        # ranks before it end.
        positions = mesh.index('context') * tokens.shape[1] + torch.arange(
            tokens.shape[1], device=tokens.device)
        x = llama.embed(params, tokens, c)
        windows = llama.layer_windows(c)
        cuts = llama.shard_tree(c, mesh)
        layer_cuts = None if cuts is None else {
            k: v.per_layer() for k, v in cuts['layers'].items()}

        def layer_fn(layer_params, h, i):
            return llama._layer(h, layer_params, c, positions,
                                window=windows[i], cuts=layer_cuts,
                                mesh=mesh)

        x = pipeline_apply(layer_fn, params['layers'], x, mesh,
                           num_microbatches=num_microbatches,
                           num_layers=c.num_layers)
        x = llama._rms_norm(x, llama._whole(params, 'final_norm', c),
                            c.rms_norm_eps, c.norm_plus_one)
        return llama.project_logits(x, params, c)
