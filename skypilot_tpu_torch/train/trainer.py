"""Trainer: train state, the optimizer, one train step, MFU accounting.

Ports `skypilot_tpu/train/trainer.py`: `TrainerConfig` (:23-58),
`make_optimizer` (:61), `batch_shardings` (:75), `make_train_state`
(:82), `make_train_step` (:109), `synthetic_batch` (:136), `mfu` (:154),
`PEAK_FLOPS` (:162) and `detect_chip` (:171). Where the reference takes
a mesh these take a `parallel.Mesh` (one process per device, built by
`mesh_from_env`) or, for a one-device run, a device (None = CUDA,
raising without it).

Under a mesh every rank holds its cut of the state
(`sharding.tree_shardings` of `param_logical_axes`: `embed` over
`fsdp`, heads, MLP and vocab over `tensor`) and of the batch
(`batch_shardings`: batch over `data` x `fsdp`, seq over `context`).
The step is the reference's GSPMD step written out: the loss and its
gradient through the model's collectives (`models/llama.py`), each
gradient all-reduced over the axes of `mesh.GRAD_AXES` it is not cut
along (an FSDP-cut leaf's reduce-scatter over `fsdp` happened in the
backward), the global norm summed over every shard once (a rank adds a
leaf's squares only at coordinate 0 of each axis the leaf is replicated
over), and AdamW on the shards in place. The pipeline and expert axes,
and an MoE model under a mesh, are refused (`check_mesh`): the next
parallel slice.

The optimizer is the port's own copy of the reference's
`optax.chain(clip_by_global_norm(grad_clip), adamw(
warmup_cosine_decay_schedule(0, lr, warmup, max(max_steps, warmup + 1)),
b1=0.9, b2=0.95, weight_decay, mu_dtype))` (optax 0.2.6), written in
plain torch because `torch.optim.AdamW` differs in the clip, in
`mu_dtype` and in the schedule hook:
- the learning rate of an update is the schedule at the count BEFORE
  the update (step 1 runs at lr 0 when warmup > 0);
- the clip scales every leaf by 1 if norm < max, else max / norm, with
  the global norm of the unclipped grads, which the step also reports;
- m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, both bias-corrected
  by 1 - b^t; the update is m_hat / (sqrt(v_hat) + eps) with eps 1e-8
  outside the sqrt, plus weight_decay * param on every leaf (decoupled),
  times -lr;
- mu is kept in `mu_dtype` (or the param dtype), nu in the param dtype,
  as optax keeps them. The update arithmetic runs in f32 per leaf and
  is rounded once into each stored tensor (optax runs it in the leaf
  dtype; in f32 the two are the same).
Params and moments are updated IN PLACE: the state dict a step returns
is the one it was given, with its tensors overwritten.

Neither the optimizer nor the loss is a Pallas kernel in the reference,
so no hand-written kernel stands behind them; the attention inside the
loss is the flash kernels K1/K3/K4 when the model's `attention_impl` is
'flash', at head_dim 64, 128 and 256: gemma2-2b trains on the card with
its sliding window and attention softcap inside K1/K3/K4. On CUDA a
flash config at a head_dim K3/K4 are not built for is refused before
any step (`check_kernels`); the CPU trains it through the plain
versions. The MoE family trains through its own `loss_fn` (cross-entropy
plus the router aux loss), its router kept in f32 in a bf16 model
(`weights.cast_params`); its MFU counts the active params
(`MoeConfig.flops_per_token`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from skypilot_tpu_torch import device as device_lib
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.ops import flash_attention as fa
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding

B1, B2, EPS = 0.9, 0.95, 1e-8


@dataclasses.dataclass
class TrainerConfig:
    model: str = 'tiny'
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    max_steps: int = 1000
    batch_size: int = 8          # global
    seq_len: int = 512
    grad_clip: float = 1.0
    # Adam first moment dtype: 'bfloat16' halves its footprint; None
    # keeps the param dtype (as optax does).
    mu_dtype: Optional[str] = None
    # Override the preset's attention impl (dense/blockwise/flash).
    attention_impl: Optional[str] = None

    def model_config(self):
        import skypilot_tpu_torch.models as models_lib
        cfg = models_lib.resolve(self.model)[1]
        if self.attention_impl is not None:
            if not hasattr(cfg, 'attention_impl'):
                raise ValueError(
                    f'Model {self.model!r} does not support an '
                    'attention override.')
            cfg = dataclasses.replace(cfg, attention_impl=self.attention_impl)
        return cfg

    def model_family(self):
        import skypilot_tpu_torch.models as models_lib
        return models_lib.resolve(self.model)[0]


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order (jax.tree's order)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in
                tree_leaves(tree[key])]
    return [tree]


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {key: tree_map(fn, val) for key, val in tree.items()}
    return fn(tree)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every tensor, in f32 (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor optax.clip_by_global_norm applies to every leaf: 1 if
    norm < max_norm, else max_norm / norm (a device scalar: no host
    sync). optax computes g / norm * max_norm; g * (max_norm / norm)
    differs from it by at most one rounding."""
    return torch.where(norm < max_norm, torch.ones_like(norm),
                       max_norm / norm)


class AdamW:
    """clip_by_global_norm + AdamW with a warmup-cosine schedule (see the
    module docstring for the exact rules)."""

    def __init__(self, cfg: TrainerConfig) -> None:
        self.peak = cfg.learning_rate
        self.warmup = cfg.warmup_steps
        self.decay_steps = max(cfg.max_steps, cfg.warmup_steps + 1)
        self.weight_decay = cfg.weight_decay
        self.grad_clip = cfg.grad_clip
        self.mu_dtype = torch.bfloat16 if cfg.mu_dtype == 'bfloat16' else None

    def learning_rate(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay) at
        `count`: linear from 0 over the warmup, then cosine to 0 over the
        remaining decay_steps - warmup."""
        if count < self.warmup:
            return self.peak * count / self.warmup
        span = self.decay_steps - self.warmup
        t = min(count - self.warmup, span)
        return self.peak * 0.5 * (1.0 + math.cos(math.pi * t / span))

    def init(self, params: Any) -> Dict[str, Any]:
        return {'count': 0,
                'mu': tree_map(lambda p: torch.zeros_like(
                    p, dtype=self.mu_dtype or p.dtype), params),
                'nu': tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update_(self, grads: List[torch.Tensor], opt_state: Dict[str, Any],
                params: Any, norm: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Apply one update in place to `params` and `opt_state`, with
        `grads` in `tree_leaves(params)` order. Returns the global norm
        of the grads before clipping (a device scalar: no host sync);
        `norm` gives it (a sharded state's, `sharded_norm`) instead of
        the norm of `grads`."""
        if norm is None:
            norm = global_norm(grads)
        scale = clip_scale(norm, self.grad_clip)
        count = opt_state['count'] + 1
        lr = self.learning_rate(opt_state['count'])
        bc1, bc2 = 1.0 - B1 ** count, 1.0 - B2 ** count
        # f32 arithmetic, in place where it can be: `.float()` of an f32
        # tensor is the tensor itself, so f32 moments and params update
        # where they lie (their copies back are no-ops) and m, v must not
        # be changed after. The grads are consumed.
        for p, g, mu, nu in zip(tree_leaves(params), grads,
                                tree_leaves(opt_state['mu']),
                                tree_leaves(opt_state['nu'])):
            g32 = g.float().mul_(scale)
            m = mu.float().mul_(B1).add_(g32, alpha=1.0 - B1)
            v = nu.float().mul_(B2).addcmul_(g32, g32, value=1.0 - B2)
            mu.copy_(m)
            nu.copy_(v)
            u = m.div(bc1).div_(v.div(bc2).sqrt_().add_(EPS))
            p32 = p.float()
            u.add_(p32, alpha=self.weight_decay)
            p.copy_(p32.add_(u, alpha=-lr))
        opt_state['count'] = count
        return norm


def check_kernels(config: llama.LlamaConfig, device: torch.device) -> None:
    """Refuse a model config whose training step has no kernel on
    `device`: flash attention at a head_dim the backward kernels are not
    built for raises NotImplementedError naming ROADMAP.md, before any
    parameter is drawn or any kernel launches."""
    if getattr(config, 'attention_impl', None) == 'flash':
        fa.check_backward(device, config.head_dim, needs_grad=True)


def make_optimizer(cfg: TrainerConfig) -> AdamW:
    return AdamW(cfg)


Where = Union[None, str, torch.device, mesh_lib.Mesh]


def placement(mesh: Where = None) -> mesh_lib.Mesh:
    """The mesh a train entry point runs on: `mesh` itself, or for a
    device (None = CUDA) a one-rank mesh on it, so the ambient mesh is
    always set (ring attention on one rank is blockwise, as the
    reference's one-device mesh makes it)."""
    if isinstance(mesh, mesh_lib.Mesh):
        return mesh
    dev = device_lib.resolve_device(mesh)
    return mesh_lib.Mesh(mesh_lib.MeshSpec().resolve(1), 0, 1, dev)


def check_mesh(config: Any, mesh: mesh_lib.Mesh) -> None:
    """Refuse, before any parameter is drawn, what the trainer does not
    run under a mesh yet: the pipeline and expert axes, and an MoE
    model. Each is the next parallel slice (ROADMAP.md, Queue 1)."""
    if mesh.world_size == 1:
        return
    for axis in ('pipe', 'expert'):
        if mesh.shape[axis] > 1:
            raise NotImplementedError(
                f'--mesh {axis}={mesh.shape[axis]}: the trainer runs the '
                "'data', 'fsdp', 'tensor' and 'context' axes; the pipeline "
                'and expert parallelism are the next parallel slice '
                '(ROADMAP.md, Queue 1)')
    if isinstance(config, moe.MoeConfig):
        raise NotImplementedError(
            'an MoE model under a mesh of more than one device is the next '
            'parallel slice (expert parallelism, ROADMAP.md, Queue 1); '
            'train it on one device')


def batch_shardings(mesh: mesh_lib.Mesh) -> Dict[str, sharding.Shard]:
    """The cut of each batch leaf on this rank (the reference's :75-79):
    ('batch', 'seq') over ('data', 'fsdp') x 'context'."""
    cut = sharding.batch_shard(mesh)
    return {'tokens': cut, 'mask': cut}


def _cut_params(params: Any, cuts: Optional[Any]) -> Any:
    """Each full leaf cut to this rank's slice (`cuts` None: whole), as a
    copy (a view would keep the full leaf alive)."""
    if cuts is None:
        return tree_map(torch.Tensor.clone, params)
    return sharding.tree_map(lambda leaf, shard: shard(leaf).clone(),
                             params, cuts)


def make_train_state(cfg: TrainerConfig, mesh: Where = None, seed: int = 0,
                     params: Optional[Any] = None) -> Dict[str, Any]:
    """Params (random from `seed`, or a copy of the given tree on the
    device in the config's dtypes, `weights.cast_params`), the optimizer
    state and the step count. Under a mesh every rank draws each full
    leaf (a layer at a time) and keeps its cut, so the state is the
    one-device init cut, on any mesh; given `params` (full leaves) are
    cut the same way."""
    mesh = placement(mesh)
    dev = mesh.device
    mcfg = cfg.model_config()
    check_kernels(mcfg, dev)
    check_mesh(mcfg, mesh)
    cuts = llama.shard_tree(mcfg, mesh)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        kw = {} if cuts is None else {'shardings': cuts}
        params = cfg.model_family().init_params(mcfg, gen, dev, **kw)
    else:
        # In the config's dtypes: the MoE router stays f32 in a bf16
        # model, as the reference keeps it.
        params = _cut_params(weights.cast_params(params, mcfg, dev), cuts)
    params = tree_map(lambda p: p.requires_grad_(True), params)
    return {'params': params,
            'opt_state': make_optimizer(cfg).init(params), 'step': 0}


def shard_state(state: Dict[str, Any], cfg: TrainerConfig,
                mesh: Where = None) -> Dict[str, Any]:
    """A full train state (`weights.from_jax_train_state`'s, or a
    one-device state) as this rank's: the params in the config's dtypes
    and the moments in their own, each leaf cut (copied) onto the mesh's
    device; the count and the step kept."""
    mesh = placement(mesh)
    mcfg = cfg.model_config()
    cuts = llama.shard_tree(mcfg, mesh)
    params = _cut_params(weights.cast_params(state['params'], mcfg,
                                             mesh.device), cuts)
    opt = state['opt_state']
    moments = {k: _cut_params(tree_map(lambda t: t.to(mesh.device),
                                       opt[k]), cuts)
               for k in ('mu', 'nu')}
    return {'params': tree_map(lambda p: p.requires_grad_(True), params),
            'opt_state': {'count': int(opt['count']), **moments},
            'step': int(state['step'])}


def _reduce_axes(shard: sharding.Shard) -> Tuple[str, ...]:
    """The gradient axes a leaf's gradient is all-reduced over: those of
    `mesh.GRAD_AXES` it is not cut along."""
    cut = {a for c in shard.cuts for a in c.axes}
    return tuple(a for a in mesh_lib.GRAD_AXES if a not in cut)


def reduce_grads_(grads: List[torch.Tensor], cuts: List[sharding.Shard],
                  mesh: mesh_lib.Mesh) -> None:
    """All-reduce each gradient, in place, over the gradient axes it is
    not cut along (`_reduce_axes`)."""
    for g, shard in zip(grads, cuts):
        collectives.all_reduce_(g, mesh.group(_reduce_axes(shard)))


def sharded_norm(grads: List[torch.Tensor], cuts: List[sharding.Shard],
                 mesh: mesh_lib.Mesh) -> torch.Tensor:
    """The global norm of a sharded gradient tree (f32): each element's
    square counted once, by the ranks at coordinate 0 of every axis its
    leaf is replicated over, summed over the world."""
    coords = mesh.coords
    sq = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for g, shard in zip(grads, cuts):
        cut = {a for c in shard.cuts for a in c.axes}
        if all(coords[a] == 0 for a in mesh_lib.AXIS_ORDER if a not in cut):
            sq = sq + torch.linalg.vector_norm(g, dtype=torch.float32) ** 2
    collectives.all_reduce_(sq, mesh.group(mesh_lib.AXIS_ORDER))
    return sq.sqrt()


def make_train_step(cfg: TrainerConfig, mesh: Where = None
                    ) -> Callable[[Dict[str, Any], Dict[str, Any]],
                                  Tuple[Dict[str, Any], Dict[str, Any]]]:
    """Returns (state, batch) -> (state, metrics). The step updates the
    params and the optimizer moments IN PLACE and returns the same state
    dict with 'step' advanced; metrics hold 'loss' and 'grad_norm' (both
    global under a mesh) as device scalars and 'step' as an int. Under a
    mesh `batch` is this rank's cut (`batch_shardings`)."""
    mesh = placement(mesh)
    mcfg = cfg.model_config()
    check_kernels(mcfg, mesh.device)
    check_mesh(mcfg, mesh)
    family = cfg.model_family()
    optimizer = make_optimizer(cfg)
    cuts = llama.shard_tree(mcfg, mesh)
    leaf_cuts = None if cuts is None else tree_leaves(cuts)

    def step_fn(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state['params']
        with mesh_lib.use_mesh(mesh):
            loss = family.loss_fn(params, batch, mcfg)
            grads = list(torch.autograd.grad(loss, tree_leaves(params)))
        norm = None
        if leaf_cuts is not None:
            reduce_grads_(grads, leaf_cuts, mesh)
            norm = sharded_norm(grads, leaf_cuts, mesh)
        grad_norm = optimizer.update_(grads, state['opt_state'], params,
                                      norm=norm)
        del grads
        state['step'] += 1
        return state, {'loss': loss.detach(), 'grad_norm': grad_norm,
                       'step': state['step']}

    return step_fn


def synthetic_batch(cfg: TrainerConfig, mesh: Where = None, seed: int = 1
                    ) -> Dict[str, torch.Tensor]:
    """Random-token batch (bench/tests): the global batch drawn on the
    device from `seed`, then this rank's cut (`batch_shardings`)."""
    mesh = placement(mesh)
    dev = mesh.device
    mcfg = cfg.model_config()
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, mcfg.vocab_size, (cfg.batch_size, cfg.seq_len),
                           generator=gen, device=dev)
    mask = torch.ones((cfg.batch_size, cfg.seq_len), dtype=torch.float32,
                      device=dev)
    cut = batch_shardings(mesh)
    return {'tokens': cut['tokens'](tokens).contiguous(),
            'mask': cut['mask'](mask).contiguous()}


def mfu(tokens_per_sec: float, config: llama.LlamaConfig, seq_len: int,
        peak_flops_per_chip: float, num_chips: int = 1) -> float:
    """Model FLOPs utilization against the chip's peak."""
    achieved = tokens_per_sec * config.flops_per_token(seq_len)
    return achieved / (peak_flops_per_chip * num_chips)


# Peak dense bf16 FLOP/s per chip (public spec sheets).
PEAK_FLOPS = {
    'v4': 275e12,
    'v5e': 197e12,
    'v5p': 459e12,
    'v6e': 918e12,
    'h100': 989e12,   # H100 SXM, dense bf16 tensor cores
    'cpu': 1e12,      # arbitrary, for tests
}


def detect_chip(device: Optional[Union[str, torch.device]] = None) -> str:
    """'h100' for an H100, 'cpu' for the CPU, else the device's name in
    lower case (then `PEAK_FLOPS` has no entry and MFU is not computed)."""
    dev = device_lib.resolve_device(device)
    if dev.type == 'cpu':
        return 'cpu'
    name = torch.cuda.get_device_name(dev)
    return 'h100' if 'H100' in name else name.lower()
