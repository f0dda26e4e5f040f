"""Mixture-of-Experts family (Mixtral-style) in PyTorch.

Ports `skypilot_tpu/models/moe.py`: `MoeConfig` (:31-73) with
`num_params`, `active_params` and `flops_per_token`, `CONFIGS`
(:76-92), `init_params` (:115), `_capacity` (:145), `_route` (:151),
`_moe_mlp` (:196), `_layer` (:221), `forward` (:249) and `loss_fn`
(:278). Attention is llama's (`models/llama.py`); only the MLP is the
routed expert layer. The parameter tree is the reference's: `router`
[L,E,X] (f32 in a bf16 model, as the reference keeps it),
`w_gate`/`w_up` [L,X,E,M], `w_down` [L,X,M,E], an untied `lm_head`,
with the reference's `param_logical_axes` (:95-112).

Routing is the reference's function in PyTorch's idiom. The reference
dispatches with dense one-hot [G,X,C] einsums, a TPU form: at serving
capacity C = G, so every expert runs every token's row, X/k times the
routed FLOPs. Here `_route` returns each token's k expert ids, its
capacity positions, keep flags and gate weights, with the reference's
exact rule: slot-major, slot 0's assignments take positions in token
order first, a later slot's base is the count of KEPT assignments of
the earlier slots (moe.py:184-187), and an assignment is dropped at
`pos >= capacity`. `_moe_mlp` then runs each expert on its kept rows
only, one of two ways:
- 'static' (`_static_expert_outputs`): rows scatter into an
  [X, min(C, G), E] buffer and one batched product per projection runs
  every expert; no shape depends on the data, so it adds no host sync.
  Decode (G = the slot count) and small chunks take it.
- 'grouped' (`_grouped_expert_outputs`): assignments are sorted by
  expert, the per-expert row counts are read to the host once per layer
  (one sync), and each expert's contiguous rows run through its own
  products: X·C rows become the routed G·k. Prefill chunks and training
  take it.
'auto' picks 'static' while the static buffer holds at most
`STATIC_ROWS` rows. Both write each kept assignment's expert output
back to its (token, slot) cell, so the combine is a fixed-order sum
over k with no atomics: two runs give the same bits.

Casts follow the reference's: the gate/up products in f32, the
activation product and the expert output in the config dtype, and the
combine weights cast to the config dtype BEFORE the weighted sum
(moe.py:217), which accumulates in f32 and rounds once.
`_moe_mlp_dense` keeps the reference's one-hot form: the plain version
for the tests and the card's check, used nowhere on a serving or
training path. `dispatch_combine` materialises a route's [G,X,C]
dispatch and combine tensors, which equal the reference's `_route`
outputs.

Under a mesh (the ambient mesh of more than one rank, as in
`models/llama.py`) each rank holds the cuts of `param_logical_axes`:
the experts over `expert` (`router` [L,E,X] on X, `w_*` [L,X,...] on
X), `mlp` over `tensor` and `embed` over `fsdp`. Attention is llama's
layer math under the mesh. The routed MLP (`_moe_mlp`) writes out what
GSPMD inserts into the reference's:
- the router is column-parallel over `expert`: each rank's logits for
  its experts, gathered over `expert` before the softmax and top-k
  (`gather_from`), so every expert rank routes the same tokens the
  same way (tokens are replicated over `expert`: the reference's
  `batch` rule is ('data', 'fsdp'));
- routing is global over the tokens' ranks (`data` x `fsdp` x
  `context`), as the reference's over its global batch flattened row
  by row: the capacity from the global token count, each expert's
  positions offset by the per-slot counts of every (row, context chunk)
  before the token's own (one all-gather of [k, rows, X] counts a
  layer), and the aux loss's means reduced over the group (`_assign`);
- each rank runs only its experts, on the rows routed to them; the
  expert outputs (one rank writes each (token, slot) cell, the others
  hold 0) are all-reduced over `expert` (`reduce_from`) and the combine
  runs on every rank, so the MLP's output and the gates' gradients are
  the same on every expert rank; under `tensor` each expert's `w_down`
  product is an f32 partial sum, all-reduced over `tensor` and cast
  once, as llama's row-parallel products;
- the MLP's input goes through `copy_to` over `expert` (its gradient,
  the router's columns' and the local experts' parts, summed over the
  expert ranks) and the experts' rows through `copy_to` over `tensor`.
Under `context` the sequence is cut as llama's (global RoPE positions,
attention over the gathered K/V or the ring).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import mesh as mesh_lib

Params = Dict[str, Any]

# 'auto' routes through the static buffer up to this many rows
# (X * min(C, G)): mixtral's decode at 8 slots is 64, a 256-token chunk
# 2048; a 512-row prefill chunk or a training batch goes grouped.
STATIC_ROWS = 2048


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    max_seq_len: int = 8192
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-5
    num_experts: int = 8
    num_experts_per_tok: int = 2
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.02
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    attention_impl: str = 'dense'
    attention_block_size: int = 512

    def num_params(self) -> int:
        e, m, v = self.hidden_size, self.intermediate_size, self.vocab_size
        h, kv, d = self.num_heads, self.num_kv_heads, self.head_dim
        x = self.num_experts
        per_layer = (e * h * d + 2 * e * kv * d + h * d * e
                     + 3 * e * m * x + e * x
                     + 2 * e)
        return self.num_layers * per_layer + 2 * v * e + e

    def active_params(self) -> int:
        """Params touched per token (top-k of the experts)."""
        e, m = self.hidden_size, self.intermediate_size
        h, kv, d = self.num_heads, self.num_kv_heads, self.head_dim
        k = self.num_experts_per_tok
        per_layer = (e * h * d + 2 * e * kv * d + h * d * e
                     + 3 * e * m * k + e * self.num_experts + 2 * e)
        return self.num_layers * per_layer + 2 * self.vocab_size * e + e

    def flops_per_token(self, seq_len: int) -> float:
        attn = 12 * self.num_layers * self.num_heads * self.head_dim * \
            seq_len
        return 6.0 * self.active_params() + attn


CONFIGS: Dict[str, MoeConfig] = {
    'mixtral-8x7b': MoeConfig(),
    # DBRX-style fine-grained MoE: more, smaller experts with a wider
    # top-k (16 choose 4) and a 32k context.
    'dbrx-moe': MoeConfig(vocab_size=100352, hidden_size=6144,
                          intermediate_size=10752, num_layers=40,
                          num_heads=48, num_kv_heads=8, head_dim=128,
                          max_seq_len=32768, num_experts=16,
                          num_experts_per_tok=4,
                          attention_impl='flash'),
    'tiny-moe': MoeConfig(vocab_size=256, hidden_size=64,
                          intermediate_size=128, num_layers=2,
                          num_heads=4, num_kv_heads=2, head_dim=16,
                          max_seq_len=128, num_experts=4,
                          num_experts_per_tok=2, dtype=torch.float32,
                          remat=False),
}


def param_logical_axes(config: MoeConfig) -> Params:
    """Logical axes of every param leaf, the reference's (:95-112)."""
    return {
        'embed': ('vocab', 'embed'),
        'layers': {
            'attn_norm': ('layers', 'embed'),
            'wq': ('layers', 'embed', 'heads', 'head_dim'),
            'wk': ('layers', 'embed', 'kv_heads', 'head_dim'),
            'wv': ('layers', 'embed', 'kv_heads', 'head_dim'),
            'wo': ('layers', 'heads', 'head_dim', 'embed'),
            'mlp_norm': ('layers', 'embed'),
            'router': ('layers', 'embed', 'expert'),
            'w_gate': ('layers', 'expert', 'embed', 'mlp'),
            'w_up': ('layers', 'expert', 'embed', 'mlp'),
            'w_down': ('layers', 'expert', 'mlp', 'embed'),
        },
        'final_norm': ('embed',),
        'lm_head': ('embed', 'vocab'),
    }


def init_params(config: MoeConfig, generator: torch.Generator,
                device: torch.device, shardings: Optional[Params] = None
                ) -> Params:
    """Scaled-normal init in the reference's layout and scales, drawn as
    `llama.init_params` draws (f32 normals one layer at a time on the
    generator's device, cast to the config dtype). The router is rounded
    to the config dtype and kept in f32, as the reference's. With
    `shardings` (`llama.shard_tree`) each leaf keeps only this rank's
    slice of the unsharded draw, as `llama.init_params`."""
    c = config
    dt = c.dtype
    gen_dev = generator.device
    cuts = shardings or {}
    layer_cuts = cuts.get('layers', {})

    def normal(shape, fan_in, shard=None):
        scale = 1.0 / math.sqrt(fan_in)
        full = (torch.randn(shape, generator=generator, device=gen_dev,
                            dtype=torch.float32) * scale).to(dt)
        if shard is not None and shard.cuts:
            # A cut is cloned: a view would keep the whole leaf alive.
            full = shard(full).clone()
        return full.to(device)

    def stacked(name, shape, fan_in, out_dtype=dt):
        per_layer = layer_cuts[name].per_layer() if name in layer_cuts \
            else None
        shape_out = per_layer.local_shape(shape) if per_layer else shape
        out = torch.empty((c.num_layers,) + shape_out, dtype=out_dtype,
                          device=device)
        for i in range(c.num_layers):
            out[i] = normal(shape, fan_in, per_layer)
        return out

    def ones(name, shape):
        shard = layer_cuts.get(name) if name else cuts.get('final_norm')
        if shard is not None:
            shape = shard.local_shape(shape)
        return torch.ones(shape, dtype=dt, device=device)

    L, e, m = c.num_layers, c.hidden_size, c.intermediate_size
    h, kv, d, x = c.num_heads, c.num_kv_heads, c.head_dim, c.num_experts
    return {
        'embed': normal((c.vocab_size, e), e, cuts.get('embed')),
        'layers': {
            'attn_norm': ones('attn_norm', (L, e)),
            'wq': stacked('wq', (e, h, d), e),
            'wk': stacked('wk', (e, kv, d), e),
            'wv': stacked('wv', (e, kv, d), e),
            'wo': stacked('wo', (h, d, e), h * d),
            'mlp_norm': ones('mlp_norm', (L, e)),
            'router': stacked('router', (e, x), e, torch.float32),
            'w_gate': stacked('w_gate', (x, e, m), e),
            'w_up': stacked('w_up', (x, e, m), e),
            'w_down': stacked('w_down', (x, m, e), m),
        },
        'final_norm': ones(None, (e,)),
        'lm_head': normal((e, c.vocab_size), e, cuts.get('lm_head')),
    }


def param_shapes(config: MoeConfig) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """(leaf path) -> shape of every leaf `init_params` makes."""
    c = config
    L, e, m = c.num_layers, c.hidden_size, c.intermediate_size
    h, kv, d, x = c.num_heads, c.num_kv_heads, c.head_dim, c.num_experts
    layers = {'attn_norm': (L, e), 'wq': (L, e, h, d), 'wk': (L, e, kv, d),
              'wv': (L, e, kv, d), 'wo': (L, h, d, e), 'mlp_norm': (L, e),
              'router': (L, e, x), 'w_gate': (L, x, e, m),
              'w_up': (L, x, e, m), 'w_down': (L, x, m, e)}
    out = {('layers', k): v for k, v in layers.items()}
    out.update({('embed',): (c.vocab_size, e), ('final_norm',): (e,),
                ('lm_head',): (e, c.vocab_size)})
    return out


# Leaves kept in f32 whatever the config dtype.
F32_LEAVES = (('layers', 'router'),)


def _capacity(config: MoeConfig, num_tokens: int) -> int:
    c = math.ceil(config.capacity_factor * num_tokens *
                  config.num_experts_per_tok / config.num_experts)
    return max(4, int(c))


class Route(NamedTuple):
    """One routing decision over G tokens, k slots each."""
    experts: torch.Tensor     # [G,k] int64 expert id, slot-ordered
    positions: torch.Tensor   # [G,k] int64 position in the expert buffer
    keep: torch.Tensor        # [G,k] bool: position < capacity
    gates: torch.Tensor       # [G,k] f32 renormalised top-k probability
    capacity: int
    aux_loss: torch.Tensor    # f32 scalar
    tokens: int               # tokens routed together (the batch group's)


def _route(h: torch.Tensor, router: torch.Tensor, config: MoeConfig
           ) -> Route:
    """Top-k routing with static capacity over h [G,E] (the reference's
    `_route`, returning the assignment lists instead of the one-hot
    tensors; `dispatch_combine` turns one into the other). Static
    shapes throughout: no host sync."""
    logits = h.float() @ router.float()                       # [G,X]
    return _assign(torch.softmax(logits, dim=-1), config)


def _assign(probs: torch.Tensor, config: MoeConfig,
            mesh: Optional[mesh_lib.Mesh] = None, rows: int = 1) -> Route:
    """The routing decision from the router's probabilities [G,X]. Under
    `mesh` (this rank's G tokens are `rows` rows of its cut of the batch,
    each its `context` rank's chunk of the row) the route is the one the
    global batch would take, flattened row-major as the reference
    flattens it: the capacity from the global token count, each
    assignment's position offset by the same slot's assignments to its
    expert in every earlier (row, context chunk) of every rank, and the
    aux loss's means over every token."""
    c = config
    g = probs.shape[0]
    x_n, k = c.num_experts, c.num_experts_per_tok
    group = None if mesh is None else mesh.group(mesh_lib.GRAD_AXES)
    n = collectives.group_size(group)
    cap = _capacity(c, g * n)

    # Aux load-balancing loss (Switch-style): mean prob * mean assignment.
    top1 = torch.argmax(probs, dim=-1)
    if n == 1:
        me = probs.mean(dim=0)
        ce = F.one_hot(top1, x_n).float().mean(dim=0)
    else:
        me = collectives.reduce_from(probs.sum(dim=0), group) / (g * n)
        ce = collectives.all_reduce_(
            F.one_hot(top1, x_n).float().sum(dim=0), group) / (g * n)
    aux_loss = x_n * torch.sum(me * ce)

    topk_probs, topk_idx = torch.topk(probs, k, dim=-1)
    topk_probs = topk_probs / torch.clamp(
        topk_probs.sum(dim=-1, keepdim=True), min=1e-9)

    experts = torch.arange(x_n, device=probs.device)[:, None, None]
    # One-hot [X, rows, G / rows] per slot: the running count scans each
    # row's chunk.
    onehots = [(experts == topk_idx[:, slot].view(1, rows, -1)).to(
        torch.int32) for slot in range(k)]
    # Each slot's assignments per expert in each (row, context chunk) of
    # every rank of the group, in the global order: batch rank, row,
    # context rank (the group's ranks are batch-major). An assignment's
    # offset is the count of every chunk before its own; the slot's
    # global positions of expert x are base_x .. base_x + total_x - 1,
    # and those below capacity are kept. Static shapes: no host sync.
    counts = torch.stack([o.sum(dim=2, dtype=torch.int32).T
                          for o in onehots])                # [k, rows, X]
    every = collectives.all_gather(counts[None], group, 0)
    n_ctx = 1 if mesh is None else mesh.shape['context']
    chunks = every.view(n // n_ctx, n_ctx, k, rows, x_n).permute(
        2, 0, 3, 1, 4).reshape(k, -1, x_n)                  # [k, chunks, X]
    offsets = torch.cumsum(chunks, dim=1, dtype=torch.int32) - chunks
    me_batch = 0 if mesh is None else mesh.index(('data', 'fsdp'))
    me_ctx = 0 if mesh is None else mesh.index('context')
    mine = (me_batch * rows + torch.arange(rows, device=probs.device)) \
        * n_ctx + me_ctx
    offsets = offsets[:, mine]                              # [k, rows, X]
    total = chunks.sum(dim=1, dtype=torch.int32)            # [k, X]
    row_of = torch.arange(g, device=probs.device) // (g // rows)
    base = torch.zeros((x_n,), dtype=torch.int32, device=probs.device)
    positions, keeps = [], []
    for slot, onehot in enumerate(onehots):
        idx = topk_idx[:, slot]
        # This slot's earlier assignments to the same expert in its
        # chunk, plus the earlier chunks', plus the kept assignments of
        # the earlier slots.
        before = (torch.cumsum(onehot, dim=2, dtype=torch.int32)
                  - onehot).reshape(x_n, g)
        pos = (torch.gather(before, 0, idx[None, :])[0]
               + offsets[slot][row_of, idx] + base[idx]).long()
        keep = pos < cap
        base = base + torch.clamp(cap - base, min=0).minimum(total[slot])
        positions.append(pos)
        keeps.append(keep)
    return Route(topk_idx, torch.stack(positions, 1), torch.stack(keeps, 1),
                 topk_probs, cap, aux_loss, g * n)


def dispatch_combine(route: Route, num_experts: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's [G,X,C] dispatch (one-hot, f32) and combine (gate
    weights) of `route`. A token takes an expert at most once, so its
    cells never collide."""
    g = route.experts.shape[0]
    cap = route.capacity
    cell = route.experts * cap + torch.clamp(route.positions, max=cap - 1)
    keep = route.keep.to(route.gates.dtype)
    dispatch = torch.zeros((g, num_experts * cap), dtype=keep.dtype,
                           device=keep.device).scatter(1, cell, keep)
    combine = torch.zeros_like(dispatch).scatter(1, cell,
                                                 route.gates * keep)
    return (dispatch.view(g, num_experts, cap),
            combine.view(g, num_experts, cap))


def _expert(rows: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, config: MoeConfig, partial: bool = False
            ) -> torch.Tensor:
    """SwiGLU expert(s): f32 gate/up, activation product and output in
    the config dtype. rows [..., N, E] against [..., E, M] weights. With
    `partial` (a tensor rank's MLP columns) the output is the f32 partial
    sum over them, uncast."""
    gate = torch.matmul(rows, w_gate).float()
    up = torch.matmul(rows, w_up).float()
    act = (F.silu(gate) * up).to(config.dtype)
    if partial:
        if w_down.dim() == 2:
            return llama._f32_product(act, w_down)
        return torch.stack([llama._f32_product(a, w)
                            for a, w in zip(act, w_down)])
    return torch.matmul(act, w_down).to(config.dtype)


def _static_expert_outputs(flat: torch.Tensor, route: Route,
                           layer_params: Params, config: MoeConfig,
                           first: int = 0, partial: bool = False
                           ) -> torch.Tensor:
    """[G,k,E] expert outputs (zero where dropped, or routed to an expert
    this rank does not hold: `layer_params` holds experts `first`.. on)
    through one [X, min(C,G), E] buffer: every shape is static, no host
    sync."""
    g, e = flat.shape
    k = config.num_experts_per_tok
    x_n = layer_params['w_gate'].shape[0]
    slots = min(route.capacity, route.tokens)  # a token takes an expert once
    dummy = x_n * slots
    local = route.experts - first
    mine = route.keep & (local >= 0) & (local < x_n)
    cell = torch.where(mine, local * slots + route.positions,
                       torch.full_like(route.positions, dummy)).reshape(-1)
    token = torch.arange(g * k, device=flat.device) // k
    buf = torch.zeros((dummy + 1, e), dtype=flat.dtype, device=flat.device)
    buf = buf.index_put((cell,), flat[token])
    out = _expert(buf[:dummy].view(x_n, slots, e), layer_params['w_gate'],
                  layer_params['w_up'], layer_params['w_down'], config,
                  partial)
    out = torch.cat([out.reshape(dummy, e),
                     torch.zeros((1, e), dtype=out.dtype, device=out.device)])
    return out[cell].view(g, k, e)


def _grouped_dispatch(flat: torch.Tensor, route: Route, config: MoeConfig,
                      first: int = 0, count: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """The kept assignments to experts `first` .. `first + count` (default
    all) sorted by expert: (their rows [N,E], their (token, slot) cells
    [N] as token * k + slot, rows per expert). The counts are read to the
    host: the one sync of the grouped path."""
    k = config.num_experts_per_tok
    x_n = config.num_experts if count is None else count
    local = route.experts - first
    mine = route.keep & (local >= 0) & (local < x_n)
    key = torch.where(mine, local, torch.full_like(local, x_n)).reshape(-1)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=x_n + 1)[:x_n].tolist()
    cells = order[:sum(counts)]
    return flat[cells // k], cells, counts


def _grouped_experts(rows: torch.Tensor, counts: List[int],
                     layer_params: Params, config: MoeConfig,
                     partial: bool = False) -> torch.Tensor:
    """Each expert's contiguous rows through its own products."""
    pieces, off = [], 0
    for x, n in enumerate(counts):
        if n:
            pieces.append(_expert(rows[off:off + n],
                                  layer_params['w_gate'][x],
                                  layer_params['w_up'][x],
                                  layer_params['w_down'][x], config,
                                  partial))
        off += n
    if not pieces:
        return rows[:0].float() if partial else rows[:0]
    return torch.cat(pieces)


def _grouped_undispatch(outputs: torch.Tensor, cells: torch.Tensor,
                        num_tokens: int, config: MoeConfig) -> torch.Tensor:
    """Sorted expert outputs back to their cells: [G,k,E], zero where
    dropped. Each cell is written once: no atomics."""
    k, e = config.num_experts_per_tok, outputs.shape[-1]
    out = torch.zeros((num_tokens * k, e), dtype=outputs.dtype,
                      device=outputs.device)
    return out.index_copy(0, cells, outputs).view(num_tokens, k, e)


def _grouped_expert_outputs(flat: torch.Tensor, route: Route,
                            layer_params: Params, config: MoeConfig,
                            first: int = 0, partial: bool = False
                            ) -> torch.Tensor:
    """[G,k,E] expert outputs (zero where dropped, or routed to an expert
    this rank does not hold): assignments sorted by expert, each
    expert's rows through its own products."""
    rows, cells, counts = _grouped_dispatch(
        flat, route, config, first, layer_params['w_gate'].shape[0])
    outputs = _grouped_experts(rows, counts, layer_params, config, partial)
    return _grouped_undispatch(outputs, cells, flat.shape[0], config)


def _combine(outputs: torch.Tensor, route: Route, config: MoeConfig
             ) -> torch.Tensor:
    """sum_k w * expert output, w cast to the config dtype first and the
    sum accumulated in f32, rounded once (the reference's bf16 combine
    einsum)."""
    w = (route.gates * route.keep).to(config.dtype).float()
    return (outputs.float() * w[..., None]).sum(dim=1).to(config.dtype)


def _moe_mlp(h: torch.Tensor, layer_params: Params, config: MoeConfig,
             mode: str = 'auto', valid: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h [B,S,E] -> (out [B,S,E], aux_loss), running each expert on its
    kept rows only. `mode`: 'static' (no host sync), 'grouped' (one) or
    'auto' (static while the buffer fits `STATIC_ROWS`). `valid` [B,S]
    (the cached engine's real tokens) drops every other row as capacity
    drops a token: its output is 0 and it takes no expert's rows, so a
    padded chunk's padding, whose attention reads whatever its pages
    hold, never changes the row counts the real tokens run at. Under
    the ambient mesh this rank's experts run (see the module
    docstring)."""
    c = config
    b, s, e = h.shape
    flat = h.reshape(b * s, e)
    mesh = mesh_lib.current()
    first, experts_group, tensor_group = 0, None, None
    if mesh is None:
        route = _route(flat, layer_params['router'], c)
    else:
        experts_group = mesh.group('expert')
        tensor_group = mesh.group('tensor')
        first = mesh.index('expert') * layer_params['w_gate'].shape[0]
        flat = collectives.copy_to(flat, experts_group)
        logits = collectives.gather_from(
            flat.float() @ layer_params['router'].float(), experts_group, -1)
        route = _assign(torch.softmax(logits, dim=-1), c, mesh, b)
    if valid is not None:
        route = route._replace(keep=route.keep & valid.reshape(-1, 1))
    if mode == 'auto':
        rows = c.num_experts * min(route.capacity, b * s)
        mode = 'static' if rows <= STATIC_ROWS else 'grouped'
    partial = collectives.group_size(tensor_group) > 1
    rows_in = collectives.copy_to(flat, tensor_group)
    if mode == 'static':
        outputs = _static_expert_outputs(rows_in, route, layer_params, c,
                                         first, partial)
    elif mode == 'grouped':
        outputs = _grouped_expert_outputs(rows_in, route, layer_params, c,
                                          first, partial)
    else:
        raise ValueError(f'mode must be auto|static|grouped, got {mode!r}')
    if partial:
        outputs = collectives.reduce_from(outputs, tensor_group).to(c.dtype)
    # One rank wrote each cell, the others hold 0: the sum is exact.
    outputs = collectives.reduce_from(outputs, experts_group)
    return _combine(outputs, route, c).reshape(b, s, e), route.aux_loss


def _moe_mlp_dense(h: torch.Tensor, layer_params: Params,
                   config: MoeConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's `_moe_mlp` form: one-hot [G,X,C] dispatch and
    combine einsums, every expert over its whole capacity buffer. The
    plain version of `_moe_mlp`."""
    c = config
    b, s, e = h.shape
    flat = h.reshape(b * s, e)
    route = _route(flat, layer_params['router'], c)
    dispatch, combine = dispatch_combine(route, c.num_experts)
    expert_in = torch.einsum('gxc,ge->xce', dispatch.to(c.dtype), flat)
    expert_out = _expert(expert_in, layer_params['w_gate'],
                         layer_params['w_up'], layer_params['w_down'], c)
    out = torch.einsum('gxc,xce->ge', combine.to(c.dtype), expert_out)
    return out.reshape(b, s, e), route.aux_loss


def _layer(x: torch.Tensor, layer_params: Params, config: MoeConfig,
           positions: torch.Tensor, cuts: Optional[Params] = None,
           mesh: Optional[mesh_lib.Mesh] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """llama's attention (plain norms, no window or softcap), then the
    routed expert MLP, under `mesh` (made the ambient mesh inside, as
    `llama._layer`: a checkpointed layer's recompute runs outside the
    caller's). `cuts` (the layer's per-layer `Shard`s under a mesh)
    gathers its FSDP-cut weights first, inside the layer."""
    with mesh_lib.use_mesh(mesh):
        c = config
        if cuts is not None:
            layer_params = {k: llama.unshard(v, cuts[k], mesh)
                            for k, v in layer_params.items()}
        h = llama._rms_norm(x, layer_params['attn_norm'], c.rms_norm_eps)
        q, k, v = llama._qkv(h, layer_params, c)
        q = llama._rope(q, positions, c)
        k = llama._rope(k, positions, c)
        attn = attention_ops.attention(q, k, v, causal=True,
                                       impl=c.attention_impl, mesh=mesh,
                                       block_size=c.attention_block_size)
        x = x + llama._row_parallel(attn, layer_params['wo'],
                                    'bshd,hde->bse', c)
        h = llama._rms_norm(x, layer_params['mlp_norm'], c.rms_norm_eps)
        moe_out, aux_loss = _moe_mlp(h, layer_params, c)
        return x + moe_out, aux_loss


def embed(params: Params, tokens: torch.Tensor,
          config: MoeConfig) -> torch.Tensor:
    """Token embeddings (`llama.embed`: vocab-parallel under tensor,
    gathered under fsdp; no scale)."""
    return llama.embed(params, tokens, config)


def project_logits(x: torch.Tensor, params: Params,
                   config: MoeConfig) -> torch.Tensor:
    """Final-norm hidden states -> f32 logits (untied head, no softcap;
    `llama.project_logits`)."""
    return llama.project_logits(x, params, config)


def forward(params: Params, tokens: torch.Tensor, config: MoeConfig,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S] -> (logits [B,S,V] f32, total aux loss). With
    `config.remat` and autograd on, each layer is checkpointed and
    recomputed whole in the backward, as `llama.forward`; under the
    ambient mesh each rank runs its cut (the module docstring)."""
    c = config
    mesh = mesh_lib.current()
    if positions is None:
        # Global positions: a context rank's slice starts where the
        # ranks before it end.
        start = 0 if mesh is None else mesh.index('context') * tokens.shape[1]
        positions = start + torch.arange(tokens.shape[1],
                                         device=tokens.device)
    x = embed(params, tokens, c)
    cuts = llama.shard_tree(c, mesh)
    layer_cuts = None if cuts is None else {
        k: v.per_layer() for k, v in cuts['layers'].items()}
    remat = c.remat and torch.is_grad_enabled()
    ambient = mesh_lib.ambient()
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(c.num_layers):
        lp = llama.layer_params_at(params, i)
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                _layer, x, lp, c, positions, layer_cuts, ambient,
                use_reentrant=False)
        else:
            x, aux = _layer(x, lp, c, positions, layer_cuts, ambient)
        aux_total = aux_total + aux
    x = llama._rms_norm(x, llama._whole(params, 'final_norm', c),
                        c.rms_norm_eps)
    return project_logits(x, params, c), aux_total


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: MoeConfig) -> torch.Tensor:
    """Next-token cross-entropy (`llama.cross_entropy`, global under a
    mesh) plus `router_aux_loss_coef` times the summed aux loss."""
    logits, aux_loss = forward(params, batch['tokens'], config)
    return (llama.cross_entropy(logits, batch)
            + config.router_aux_loss_coef * aux_loss)
