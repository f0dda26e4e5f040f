"""Llama-family model in PyTorch: plain functions over stacked-layer params.

Ports `skypilot_tpu/models/llama.py`: `LlamaConfig` (:38), the llama
`CONFIGS` (:96), `init_params` (:219), `layer_windows` (:294),
`_rms_norm` (:309), `_rope_freqs` (:317), `_rope` (:339), `_layer`
(:354), `forward` (:415), `loss_fn` (:467) and `LlamaConfig.num_params` /
`flops_per_token` (:80-92). The parameter layout is the reference's at
the public boundary: `[L, ...]` leaves, `wq` [E,H,D], `wk`/`wv`
[E,KV,D], `wo` [H,D,E], `w_gate`/`w_up` [E,M], `w_down` [M,E], so
weights map one to one. Attention dispatches through
`ops.attention.attention` on `config.attention_impl` ('dense' |
'blockwise' | 'flash'; 'flash' runs K1 forward and K3/K4 backward on the
card). `forward` is differentiable; serving callers run it under
`torch.inference_mode()`.

Remat differs from the reference. With `remat=True` and autograd on,
each layer runs under `torch.utils.checkpoint.checkpoint(
use_reentrant=False)`: the backward recomputes the WHOLE layer, the
flash forward (K1) included, and keeps only the layer's input. The
reference's default policy ('dots' = `dots_with_no_batch_dims_saveable`)
keeps the matmul outputs and recomputes only the elementwise work; its
'save_attn' policy also keeps the attention output. PyTorch has no
policy-driven checkpoint in eager mode, so both policies map to the
whole-layer recompute here: more FLOPs (one more forward per layer),
less memory.

Under a mesh (`parallel.use_mesh`, the ambient mesh of more than one
rank) each rank holds the slices `param_logical_axes` gives it under
`parallel.sharding.DEFAULT_RULES` and the layer math writes out the
collectives GSPMD inserts into the reference's jitted step, through the
autograd-aware ops of `parallel/collectives.py`:
- `tensor`: each rank computes its local heads and MLP columns. The
  inputs of the column-parallel products (`_qkv`, `_mlp`, the head) go
  through `copy_to` (their gradient all-reduced); the products that
  contract a split axis (`wo`, `w_down`) run in f32 per rank, are
  all-reduced in f32 and cast once (`_row_parallel`), so the result
  rounds once as the unsharded product does. The embedding is
  vocab-parallel (a masked lookup on the local rows, then an
  all-reduce; this covers a tied head too) and the logits are
  all-gathered over vocab (`gather_from`) before the final softcap.
- `fsdp`: every weight and norm is cut along `embed`; a layer gathers
  its weights for its forward (`gather_weight`: the gradient
  reduce-scattered back to the shards) inside the checkpointed layer,
  so the gathered copies are freed after the forward and gathered again
  by the remat recompute. The embedding, the final norm and the head
  gather the same way.
- `context`: the sequence is cut over `context`; RoPE takes global
  positions, attention is the ring (`ops.attention.ring_attention`; any
  other impl gathers K/V over `context`), and `loss_fn` takes each
  rank's last target from the next rank's first token.
- `data` x `fsdp` cut the batch; `loss_fn` normalises by the global mask
  count and sums the loss over the batch and context ranks.
The trainer reduces the gradients over what these do not
(`train/trainer.py`).

Products follow the reference's casts: q/k/v/o and the MLP output are
cast to the config dtype, the MLP gate/up and the logits are f32. In f32
(the CPU tests) every product is f32 end to end. In bf16 on the card the
products run as bf16 matmuls (f32 accumulate, bf16 result), so the
gate/up and logits are rounded to bf16 before the f32 upcast.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding as sharding_lib

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = 'dots'
    attention_impl: str = 'dense'
    attention_block_size: int = 512
    # --- family knobs (Gemma / Mistral share this core) ----------------
    activation: str = 'silu'
    tied_embeddings: bool = False
    embed_scale: bool = False
    norm_plus_one: bool = False
    post_norms: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    sliding_window: Optional[int] = None
    sliding_window_pattern: int = 1
    attn_qkv_bias: bool = False
    rope_scaling_factor: Optional[float] = None
    rope_scaling_low_freq_factor: float = 1.0
    rope_scaling_high_freq_factor: float = 4.0
    rope_scaling_original_max: int = 8192

    def num_params(self) -> int:
        e, m, v = self.hidden_size, self.intermediate_size, self.vocab_size
        h, kv, d = self.num_heads, self.num_kv_heads, self.head_dim
        per_layer = (e * h * d + 2 * e * kv * d + h * d * e  # attn
                     + 3 * e * m                              # mlp
                     + (4 if self.post_norms else 2) * e)     # norms
        head = v * e if not self.tied_embeddings else 0
        return self.num_layers * per_layer + v * e + head + e

    def flops_per_token(self, seq_len: int) -> float:
        """Approx train-step FLOPs/token (fwd+bwd ~ 6 x params + attn)."""
        attn = 12 * self.num_layers * self.num_heads * self.head_dim * seq_len
        return 6.0 * self.num_params() + attn


# The reference's llama presets (published architecture tables).
CONFIGS: Dict[str, LlamaConfig] = {
    'llama3-8b': LlamaConfig(),
    'llama3-70b': LlamaConfig(hidden_size=8192, intermediate_size=28672,
                              num_layers=80, num_heads=64, num_kv_heads=8),
    'llama3-405b': LlamaConfig(hidden_size=16384,
                               intermediate_size=53248, num_layers=126,
                               num_heads=128, num_kv_heads=8,
                               max_seq_len=8192,
                               attention_impl='flash'),
    'llama3-1b': LlamaConfig(vocab_size=128256, hidden_size=2048,
                             intermediate_size=8192, num_layers=16,
                             num_heads=32, num_kv_heads=8, head_dim=64),
    'deepseek-r1-distill-8b': LlamaConfig(attention_impl='flash',
                                          rope_scaling_factor=8.0),
    'llama2-7b': LlamaConfig(vocab_size=32000, hidden_size=4096,
                             intermediate_size=11008, num_layers=32,
                             num_heads=32, num_kv_heads=32,
                             head_dim=128, max_seq_len=4096,
                             rope_theta=10000.0,
                             attention_impl='flash'),
    'llama2-13b': LlamaConfig(vocab_size=32000, hidden_size=5120,
                              intermediate_size=13824, num_layers=40,
                              num_heads=40, num_kv_heads=40,
                              head_dim=128, max_seq_len=4096,
                              rope_theta=10000.0,
                              attention_impl='flash'),
    'codellama-7b': LlamaConfig(vocab_size=32016, hidden_size=4096,
                                intermediate_size=11008,
                                num_layers=32, num_heads=32,
                                num_kv_heads=32, head_dim=128,
                                max_seq_len=16384,
                                rope_theta=1000000.0,
                                attention_impl='flash'),
    'llama32-3b': LlamaConfig(vocab_size=128256, hidden_size=3072,
                              intermediate_size=8192, num_layers=28,
                              num_heads=24, num_kv_heads=8,
                              head_dim=128, max_seq_len=8192,
                              tied_embeddings=True,
                              rope_scaling_factor=32.0,
                              attention_impl='flash'),
    'yi-6b': LlamaConfig(vocab_size=64000, hidden_size=4096,
                         intermediate_size=11008, num_layers=32,
                         num_heads=32, num_kv_heads=4, head_dim=128,
                         max_seq_len=4096, rope_theta=5000000.0,
                         attention_impl='flash'),
    'tiny': LlamaConfig(vocab_size=256, hidden_size=64,
                        intermediate_size=128, num_layers=2, num_heads=4,
                        num_kv_heads=2, head_dim=16, max_seq_len=128,
                        dtype=torch.float32, remat=False),
    'bench-1b': LlamaConfig(vocab_size=32768, hidden_size=2048,
                            intermediate_size=8192, num_layers=16,
                            num_heads=16, num_kv_heads=8, head_dim=128,
                            max_seq_len=2048, attention_impl='flash',
                            attention_block_size=1024),
    'bench-8b': LlamaConfig(vocab_size=32768, hidden_size=4096,
                            intermediate_size=14336, num_layers=5,
                            num_heads=32, num_kv_heads=8, head_dim=128,
                            max_seq_len=4096, attention_impl='flash',
                            attention_block_size=1024),
}


def param_logical_axes(config: LlamaConfig) -> Params:
    """Logical axes of every param leaf (a tree mirroring init_params),
    the reference's (:190-216)."""
    layers = {
        'attn_norm': ('layers', 'embed'),
        'wq': ('layers', 'embed', 'heads', 'head_dim'),
        'wk': ('layers', 'embed', 'kv_heads', 'head_dim'),
        'wv': ('layers', 'embed', 'kv_heads', 'head_dim'),
        'wo': ('layers', 'heads', 'head_dim', 'embed'),
        'mlp_norm': ('layers', 'embed'),
        'w_gate': ('layers', 'embed', 'mlp'),
        'w_up': ('layers', 'embed', 'mlp'),
        'w_down': ('layers', 'mlp', 'embed'),
    }
    if config.post_norms:
        layers['post_attn_norm'] = ('layers', 'embed')
        layers['post_mlp_norm'] = ('layers', 'embed')
    if config.attn_qkv_bias:
        layers['bq'] = ('layers', 'heads', 'head_dim')
        layers['bk'] = ('layers', 'kv_heads', 'head_dim')
        layers['bv'] = ('layers', 'kv_heads', 'head_dim')
    out = {
        'embed': ('vocab', 'embed'),
        'layers': layers,
        'final_norm': ('embed',),
    }
    if not config.tied_embeddings:
        out['lm_head'] = ('embed', 'vocab')
    return out


def axis_sizes(config: LlamaConfig) -> Dict[str, int]:
    """The size of each logical axis under `config`."""
    c = config
    return {'layers': c.num_layers, 'embed': c.hidden_size,
            'heads': c.num_heads, 'kv_heads': c.num_kv_heads,
            'head_dim': c.head_dim, 'mlp': c.intermediate_size,
            'vocab': c.vocab_size}


def init_params(config: LlamaConfig, generator: torch.Generator,
                device: torch.device, shardings: Optional[Params] = None
                ) -> Params:
    """Scaled-normal init, stacked over layers (reference layout and
    scales; the numbers differ from jax.random's). Normals are drawn in
    f32 one layer at a time on `generator`'s device, scaled, cast to
    the config dtype and placed on `device`. With `shardings` (a tree
    of `parallel.sharding.Shard`, from `tree_shardings`) each leaf keeps
    only this rank's slice: the draws are the unsharded ones, in the
    same order, cut one full leaf (or layer) at a time."""
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

    def stacked(name, shape, fan_in):
        per_layer = layer_cuts[name].per_layer() if name in layer_cuts \
            else None
        shape_out = per_layer.local_shape(shape) if per_layer else shape
        out = torch.empty((c.num_layers,) + shape_out, dtype=dt,
                          device=device)
        for i in range(c.num_layers):
            out[i] = normal(shape, fan_in, per_layer)
        return out

    def filled(fill, shape, shard):
        if shard is not None:
            shape = shard.local_shape(shape)
        return fill(shape, dtype=dt, device=device)

    def zeros(name, shape):
        return filled(torch.zeros, shape, layer_cuts.get(name))

    e, m = c.hidden_size, c.intermediate_size
    h, kv, d = c.num_heads, c.num_kv_heads, c.head_dim
    L = c.num_layers
    ones = torch.zeros if c.norm_plus_one else torch.ones

    def norm_init(name):
        return filled(ones, (L, e), layer_cuts.get(name))

    layers = {
        'attn_norm': norm_init('attn_norm'),
        'wq': stacked('wq', (e, h, d), e),
        'wk': stacked('wk', (e, kv, d), e),
        'wv': stacked('wv', (e, kv, d), e),
        'wo': stacked('wo', (h, d, e), h * d),
        'mlp_norm': norm_init('mlp_norm'),
        'w_gate': stacked('w_gate', (e, m), e),
        'w_up': stacked('w_up', (e, m), e),
        'w_down': stacked('w_down', (m, e), m),
    }
    if c.post_norms:
        layers['post_attn_norm'] = norm_init('post_attn_norm')
        layers['post_mlp_norm'] = norm_init('post_mlp_norm')
    if c.attn_qkv_bias:
        layers['bq'] = zeros('bq', (L, h, d))
        layers['bk'] = zeros('bk', (L, kv, d))
        layers['bv'] = zeros('bv', (L, kv, d))
    out = {
        'embed': normal((c.vocab_size, e), e, cuts.get('embed')),
        'layers': layers,
        'final_norm': filled(ones, (e,), cuts.get('final_norm')),
    }
    if not c.tied_embeddings:
        out['lm_head'] = normal((e, c.vocab_size), e, cuts.get('lm_head'))
    return out


def layer_windows(config: LlamaConfig) -> List[Optional[int]]:
    """Per-layer sliding-window sizes: local layers get
    `sliding_window`, every `sliding_window_pattern`-th layer is global
    (sentinel 2**30). All None when the model has no window. The
    forward and the cached decode path share this schedule."""
    if getattr(config, 'sliding_window', None) is None:    # MoeConfig
        return [None] * config.num_layers
    out = []
    for i in range(config.num_layers):
        is_global = (config.sliding_window_pattern > 1
                     and (i + 1) % config.sliding_window_pattern == 0)
        out.append(2 ** 30 if is_global else int(config.sliding_window))
    return out


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
              plus_one: bool = False) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    normed = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * (1.0 + weight) if plus_one else normed * weight


def _rope_freqs(d_half: int, config) -> torch.Tensor:
    """Inverse frequencies (f32, on the CPU), with optional llama3-style
    scaling: wavelengths longer than original_max/low_freq_factor divide
    by `factor`, shorter than original_max/high_freq_factor stay, the
    band between interpolates."""
    c = config
    freqs = torch.tensor(c.rope_theta, dtype=torch.float32) ** (
        -torch.arange(0, d_half, dtype=torch.float32) / d_half)
    factor = getattr(c, 'rope_scaling_factor', None)
    if factor is None:
        return freqs
    lo = c.rope_scaling_low_freq_factor
    hi = c.rope_scaling_high_freq_factor
    orig = c.rope_scaling_original_max
    wavelen = 2.0 * math.pi / freqs
    smooth = torch.clamp((orig / wavelen - lo) / (hi - lo), 0.0, 1.0)
    interp = (1.0 - smooth) * freqs / factor + smooth * freqs
    return torch.where(wavelen > orig / lo, freqs / factor,
                       torch.where(wavelen < orig / hi, freqs, interp))


@functools.lru_cache(maxsize=32)
def _rope_freqs_on(d_half: int, config, device: torch.device
                   ) -> torch.Tensor:
    """`_rope_freqs` placed on `device`, built once per (width, config,
    device): the cached forward calls `_rope` twice per layer."""
    return _rope_freqs(d_half, config).to(device)


def _rope(x: torch.Tensor, positions: torch.Tensor, config
          ) -> torch.Tensor:
    """Rotary embedding on halves (not interleaved). x [B,S,H,D];
    positions [S] or [B,S]."""
    d = x.shape[-1]
    freqs = _rope_freqs_on(d // 2, config, x.device)
    angles = positions.float()[..., None] * freqs         # [...,S,D/2]
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _act(gate: torch.Tensor, config) -> torch.Tensor:
    if config.activation == 'gelu':
        return F.gelu(gate, approximate='tanh')
    return F.silu(gate)


def _tp_group() -> Any:
    """The ambient mesh's `tensor` group (None without tensor
    parallelism)."""
    tp = mesh_lib.tensor_parallel()
    return None if tp is None else tp.tensor_group


def _mlp(h: torch.Tensor, layer_params: Params, config) -> torch.Tensor:
    """GLU MLP: f32 gate/up, activation product cast to the config
    dtype, down projection cast to the config dtype."""
    c = config
    h = collectives.copy_to(h, _tp_group())
    gate = torch.einsum('bse,em->bsm', h, layer_params['w_gate']).float()
    up = torch.einsum('bse,em->bsm', h, layer_params['w_up']).float()
    act = (_act(gate, c) * up).to(c.dtype)
    return _row_parallel(act, layer_params['w_down'], 'bsm,me->bse', c)


class _F32Product(torch.autograd.Function):
    """x @ w with an f32 result on CUDA (`torch.mm(out_dtype=)`); the
    backward's products run in the inputs' dtype, as the unsharded
    product's do."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w.T, x.T @ g


def _f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [N, K] @ w [K, M] with an f32 result: the inputs' own dtype
    multiplies with f32 accumulation, and the sum is not rounded to it
    (on CUDA `torch.mm(out_dtype=)`; elsewhere the f32 product)."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return _F32Product.apply(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


def _row_parallel(x: torch.Tensor, w: torch.Tensor, equation: str,
                  config) -> torch.Tensor:
    """A product that contracts `w`'s leading axes (`wo` over heads,
    `w_down` over MLP columns), cast to the config dtype. Under tensor
    parallelism each rank holds a partial sum over its slice of those
    axes: computed in f32, all-reduced in f32 and cast once."""
    tp = mesh_lib.tensor_parallel()
    if tp is None:
        return torch.einsum(equation, x, w).to(config.dtype)
    k = math.prod(w.shape[:-1])
    part = _f32_product(x.reshape(-1, k), w.reshape(k, w.shape[-1]))
    part = collectives.reduce_from(part, tp.tensor_group)
    lead = x.shape[:x.dim() - (w.dim() - 1)]
    return part.reshape(lead + (w.shape[-1],)).to(config.dtype)


def _qkv(h: torch.Tensor, layer_params: Params, config):
    c = config
    h = collectives.copy_to(h, _tp_group())
    q = torch.einsum('bse,ehd->bshd', h, layer_params['wq']).to(c.dtype)
    k = torch.einsum('bse,ehd->bshd', h, layer_params['wk']).to(c.dtype)
    v = torch.einsum('bse,ehd->bshd', h, layer_params['wv']).to(c.dtype)
    if getattr(c, 'attn_qkv_bias', False):    # MoeConfig has no biases
        q = q + layer_params['bq']
        k = k + layer_params['bk']
        v = v + layer_params['bv']
    return q, k, v


def shard_tree(config, mesh: Optional[mesh_lib.Mesh]) -> Optional[Params]:
    """The `Shard` of every param on this rank of `mesh` (None without a
    mesh of more than one rank)."""
    if mesh is None or mesh.world_size == 1:
        return None
    return sharding_lib.tree_shardings(mesh, param_logical_axes(config))


def unshard(leaf: torch.Tensor, shard: Optional[sharding_lib.Shard],
            mesh: Optional[mesh_lib.Mesh]) -> torch.Tensor:
    """`leaf` gathered along every cut but `tensor`'s (the FSDP weight a
    layer's math reads whole; its gradient is reduce-scattered back)."""
    if shard is None:
        return leaf
    for c in shard.cuts:
        if c.axes == ('tensor',):
            continue
        if 'tensor' in c.axes:
            raise ValueError(f'{c.logical} is cut over {c.axes}: a '
                             'dimension cut by tensor and another axis is '
                             'not gathered')
        leaf = collectives.gather_weight(leaf, mesh.group(c.axes), c.dim)
    return leaf


def _layer(x: torch.Tensor, layer_params: Params, config: LlamaConfig,
           positions: torch.Tensor,
           window: Optional[int] = None,
           cuts: Optional[Params] = None,
           mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """One decoder layer under `mesh` (made the ambient mesh inside: a
    checkpointed layer is recomputed in the backward, which on CUDA runs
    on autograd's own thread, where the caller's ambient mesh is not
    set). `cuts` (the layer's per-layer `Shard`s under a mesh) gathers
    its FSDP-cut weights first, inside the layer, so a checkpointed
    layer gathers them again when it is recomputed."""
    with mesh_lib.use_mesh(mesh):
        return _layer_math(x, layer_params, config, positions, window, cuts,
                           mesh)


def _layer_math(x, layer_params, config, positions, window, cuts, mesh):
    c = config
    if cuts is not None:
        layer_params = {k: unshard(v, cuts[k], mesh)
                        for k, v in layer_params.items()}
    plus_one = c.norm_plus_one
    h = _rms_norm(x, layer_params['attn_norm'], c.rms_norm_eps, plus_one)
    q, k, v = _qkv(h, layer_params, c)
    q = _rope(q, positions, c)
    k = _rope(k, positions, c)
    if c.query_pre_attn_scalar is not None:
        q = q * math.sqrt(c.head_dim / c.query_pre_attn_scalar)
    attn = attention_ops.attention(q, k, v, causal=True,
                                   impl=c.attention_impl, mesh=mesh,
                                   block_size=c.attention_block_size,
                                   window=window,
                                   softcap=c.attn_logit_softcap)
    attn_out = _row_parallel(attn, layer_params['wo'], 'bshd,hde->bse', c)
    if c.post_norms:
        attn_out = _rms_norm(attn_out, layer_params['post_attn_norm'],
                             c.rms_norm_eps, plus_one)
    x = x + attn_out
    h = _rms_norm(x, layer_params['mlp_norm'], c.rms_norm_eps, plus_one)
    down = _mlp(h, layer_params, c)
    if c.post_norms:
        down = _rms_norm(down, layer_params['post_mlp_norm'],
                         c.rms_norm_eps, plus_one)
    return x + down


def layer_params_at(params: Params, i: int) -> Params:
    """Layer i's leaves (views into the stacked [L, ...] arrays)."""
    return {name: leaf[i] for name, leaf in params['layers'].items()}


def _whole(params: Params, name: str, config) -> torch.Tensor:
    """A top-level param gathered along its FSDP cut under the ambient
    mesh (as it is otherwise)."""
    mesh = mesh_lib.current()
    if mesh is None:
        return params[name]
    shard = sharding_lib.leaf_shard(mesh, param_logical_axes(config)[name])
    return unshard(params[name], shard, mesh)


def embed(params: Params, tokens: torch.Tensor, config) -> torch.Tensor:
    """Token embeddings [.., E]. Under tensor parallelism the table holds
    this rank's vocab rows: a lookup masked to them, all-reduced (one
    rank holds each row, so the f32 sum is exact)."""
    c = config
    table = _whole(params, 'embed', config).to(c.dtype)
    tp = mesh_lib.tensor_parallel()
    if tp is None:
        x = table[tokens]
    else:
        rows = table.shape[0]
        local = tokens - tp.tensor_rank * rows
        mine = (local >= 0) & (local < rows)
        x = torch.where(mine[..., None], table[local.clamp(0, rows - 1)],
                        torch.zeros((), dtype=c.dtype, device=table.device))
        x = collectives.reduce_from(x.float(), tp.tensor_group).to(c.dtype)
    if c.embed_scale:
        x = x * torch.tensor(math.sqrt(c.hidden_size), dtype=c.dtype,
                             device=x.device)
    return x


def project_logits(x: torch.Tensor, params: Params, config) -> torch.Tensor:
    """Final-norm hidden states -> f32 logits (tied embeddings and the
    final softcap live here), over the whole vocab under tensor
    parallelism too."""
    c = config
    lm_head = (_whole(params, 'embed', c).to(c.dtype).T if c.tied_embeddings
               else _whole(params, 'lm_head', c))
    group = _tp_group()
    x = collectives.copy_to(x, group)
    logits = torch.einsum('...e,ev->...v', x, lm_head).float()
    # Each rank's columns are its vocab rows; every rank samples (or
    # takes its loss) from the same gathered logits.
    logits = collectives.gather_from(logits, group, -1)
    if c.final_logit_softcap is not None:
        cap = c.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


def forward(params: Params, tokens: torch.Tensor, config: LlamaConfig,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B,S] int -> logits [B,S,vocab] f32. Differentiable; with
    `config.remat` and autograd on, each layer is checkpointed (see the
    module docstring)."""
    c = config
    mesh = mesh_lib.current()
    if positions is None:
        # Global positions: a context rank's slice starts where the
        # ranks before it end.
        start = 0 if mesh is None else mesh.index('context') * tokens.shape[1]
        positions = start + torch.arange(tokens.shape[1],
                                         device=tokens.device)
    x = embed(params, tokens, c)
    cuts = shard_tree(c, mesh)
    layer_cuts = None if cuts is None else {
        k: v.per_layer() for k, v in cuts['layers'].items()}
    remat = c.remat and torch.is_grad_enabled()
    ambient = mesh_lib.ambient()
    for i, window in enumerate(layer_windows(c)):
        lp = layer_params_at(params, i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _layer, x, lp, c, positions, window, layer_cuts, ambient,
                use_reentrant=False)
        else:
            x = _layer(x, lp, c, positions, window=window, cuts=layer_cuts,
                       mesh=ambient)
    x = _rms_norm(x, _whole(params, 'final_norm', c), c.rms_norm_eps,
                  c.norm_plus_one)
    return project_logits(x, params, c)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: LlamaConfig) -> torch.Tensor:
    """Next-token cross-entropy; batch: {'tokens': [B,S], 'mask': [B,S]}.

    Targets are the tokens shifted left; the last position is masked, so
    no host-side shifting is needed. The fused form (target logit minus
    logsumexp) never builds the [B,S,V] log-probabilities.

    Under a mesh the batch is this rank's cut (`sharding.batch_shard`):
    the last target of a context rank is the next rank's first token,
    and only the last rank masks its last position; the mask count is
    all-reduced over the gradient group (`mesh.GRAD_AXES`) and the
    masked sum too (`reduce_from`), so every rank returns the global
    loss, and its gradient is this rank's part of the global one."""
    tokens = batch['tokens']
    mesh = mesh_lib.current()
    logits = forward(params, tokens, config)
    nxt = torch.zeros_like(tokens[:, :1])
    last = True
    if mesh is not None and mesh.shape['context'] > 1:
        firsts = collectives.all_gather(tokens[:, :1].contiguous(),
                                        mesh.group('context'), 1)
        at = mesh.index('context')
        last = at == mesh.shape['context'] - 1
        if not last:
            nxt = firsts[:, at + 1:at + 2]
    targets = torch.cat([tokens[:, 1:], nxt], dim=1)
    mask = batch.get('mask')
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
    mask = mask.float().clone()
    if last:
        mask[:, -1] = 0.0
    target_logit = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    token_ll = target_logit - torch.logsumexp(logits, dim=-1)
    total = -(token_ll * mask).sum()
    count = mask.sum()
    if mesh is not None:
        group = mesh.group(mesh_lib.GRAD_AXES)
        count = collectives.all_reduce_(count, group)
        total = collectives.reduce_from(total, group)
    return total / torch.clamp(count, min=1.0)
