"""Trainer: train state, the optimizer, one train step, MFU accounting.

Ports `skypilot_tpu/train/trainer.py`: `TrainerConfig` (:23-58),
`make_optimizer` (:61), `make_train_state` (:82), `make_train_step`
(:109), `synthetic_batch` (:136), `mfu` (:154), `PEAK_FLOPS` (:162) and
`detect_chip` (:171). It runs on one device: where the reference takes a
mesh, these take a `device` (None = CUDA, raising without it); sharding
waits for the parallel slice (ROADMAP.md, Queue 1).

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
versions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from skypilot_tpu_torch import device as device_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import flash_attention as fa

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
                params: Any) -> torch.Tensor:
        """Apply one update in place to `params` and `opt_state`, with
        `grads` in `tree_leaves(params)` order. Returns the global norm
        of the grads before clipping (a device scalar: no host sync)."""
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


def make_train_state(cfg: TrainerConfig,
                     device: Optional[Union[str, torch.device]] = None,
                     seed: int = 0, params: Optional[Any] = None
                     ) -> Dict[str, Any]:
    """Params (random from `seed`, or the given tree moved to `device`
    and the config dtype), the optimizer state and the step count."""
    dev = device_lib.resolve_device(device)
    mcfg = cfg.model_config()
    check_kernels(mcfg, dev)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = cfg.model_family().init_params(mcfg, gen, dev)
    else:
        params = tree_map(lambda p: p.to(device=dev, dtype=mcfg.dtype)
                          .clone(), params)
    params = tree_map(lambda p: p.requires_grad_(True), params)
    return {'params': params,
            'opt_state': make_optimizer(cfg).init(params), 'step': 0}


def make_train_step(cfg: TrainerConfig,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Callable[[Dict[str, Any], Dict[str, Any]],
                                  Tuple[Dict[str, Any], Dict[str, Any]]]:
    """Returns (state, batch) -> (state, metrics). The step updates the
    params and the optimizer moments IN PLACE and returns the same state
    dict with 'step' advanced; metrics hold 'loss' and 'grad_norm' as
    device scalars and 'step' as an int."""
    mcfg = cfg.model_config()
    check_kernels(mcfg, device_lib.resolve_device(device))
    family = cfg.model_family()
    optimizer = make_optimizer(cfg)

    def step_fn(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state['params']
        loss = family.loss_fn(params, batch, mcfg)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        grad_norm = optimizer.update_(list(grads), state['opt_state'],
                                      params)
        del grads
        state['step'] += 1
        return state, {'loss': loss.detach(), 'grad_norm': grad_norm,
                       'step': state['step']}

    return step_fn


def synthetic_batch(cfg: TrainerConfig,
                    device: Optional[Union[str, torch.device]] = None,
                    seed: int = 1) -> Dict[str, torch.Tensor]:
    """Random-token batch (bench/tests), drawn on `device` from `seed`."""
    dev = device_lib.resolve_device(device)
    mcfg = cfg.model_config()
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, mcfg.vocab_size, (cfg.batch_size, cfg.seq_len),
                           generator=gen, device=dev)
    mask = torch.ones((cfg.batch_size, cfg.seq_len), dtype=torch.float32,
                      device=dev)
    return {'tokens': tokens, 'mask': mask}


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
