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


def init_params(config: LlamaConfig, generator: torch.Generator,
                device: torch.device) -> Params:
    """Scaled-normal init, stacked over layers (reference layout and
    scales; the numbers differ from jax.random's). Normals are drawn in
    f32 one layer at a time on `generator`'s device, scaled, cast to
    the config dtype and placed on `device`."""
    c = config
    dt = c.dtype
    gen_dev = generator.device

    def normal(shape, fan_in):
        scale = 1.0 / math.sqrt(fan_in)
        return (torch.randn(shape, generator=generator, device=gen_dev,
                            dtype=torch.float32) * scale).to(dt).to(device)

    def stacked(shape, fan_in):
        out = torch.empty((c.num_layers,) + shape, dtype=dt, device=device)
        for i in range(c.num_layers):
            out[i] = normal(shape, fan_in)
        return out

    e, m = c.hidden_size, c.intermediate_size
    h, kv, d = c.num_heads, c.num_kv_heads, c.head_dim
    L = c.num_layers
    norm_init = torch.zeros if c.norm_plus_one else torch.ones
    layers = {
        'attn_norm': norm_init((L, e), dtype=dt, device=device),
        'wq': stacked((e, h, d), e),
        'wk': stacked((e, kv, d), e),
        'wv': stacked((e, kv, d), e),
        'wo': stacked((h, d, e), h * d),
        'mlp_norm': norm_init((L, e), dtype=dt, device=device),
        'w_gate': stacked((e, m), e),
        'w_up': stacked((e, m), e),
        'w_down': stacked((m, e), m),
    }
    if c.post_norms:
        layers['post_attn_norm'] = norm_init((L, e), dtype=dt, device=device)
        layers['post_mlp_norm'] = norm_init((L, e), dtype=dt, device=device)
    if c.attn_qkv_bias:
        layers['bq'] = torch.zeros((L, h, d), dtype=dt, device=device)
        layers['bk'] = torch.zeros((L, kv, d), dtype=dt, device=device)
        layers['bv'] = torch.zeros((L, kv, d), dtype=dt, device=device)
    out = {
        'embed': normal((c.vocab_size, e), e),
        'layers': layers,
        'final_norm': norm_init((e,), dtype=dt, device=device),
    }
    if not c.tied_embeddings:
        out['lm_head'] = normal((e, c.vocab_size), e)
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


def _mlp(h: torch.Tensor, layer_params: Params, config) -> torch.Tensor:
    """GLU MLP: f32 gate/up, activation product cast to the config
    dtype, down projection cast to the config dtype."""
    c = config
    gate = torch.einsum('bse,em->bsm', h, layer_params['w_gate']).float()
    up = torch.einsum('bse,em->bsm', h, layer_params['w_up']).float()
    act = (_act(gate, c) * up).to(c.dtype)
    return torch.einsum('bsm,me->bse', act,
                        layer_params['w_down']).to(c.dtype)


def _qkv(h: torch.Tensor, layer_params: Params, config):
    c = config
    q = torch.einsum('bse,ehd->bshd', h, layer_params['wq']).to(c.dtype)
    k = torch.einsum('bse,ehd->bshd', h, layer_params['wk']).to(c.dtype)
    v = torch.einsum('bse,ehd->bshd', h, layer_params['wv']).to(c.dtype)
    if getattr(c, 'attn_qkv_bias', False):    # MoeConfig has no biases
        q = q + layer_params['bq']
        k = k + layer_params['bk']
        v = v + layer_params['bv']
    return q, k, v


def _layer(x: torch.Tensor, layer_params: Params, config: LlamaConfig,
           positions: torch.Tensor,
           window: Optional[int] = None) -> torch.Tensor:
    c = config
    plus_one = c.norm_plus_one
    h = _rms_norm(x, layer_params['attn_norm'], c.rms_norm_eps, plus_one)
    q, k, v = _qkv(h, layer_params, c)
    q = _rope(q, positions, c)
    k = _rope(k, positions, c)
    if c.query_pre_attn_scalar is not None:
        q = q * math.sqrt(c.head_dim / c.query_pre_attn_scalar)
    attn = attention_ops.attention(q, k, v, causal=True,
                                   impl=c.attention_impl,
                                   block_size=c.attention_block_size,
                                   window=window,
                                   softcap=c.attn_logit_softcap)
    attn_out = torch.einsum('bshd,hde->bse', attn,
                            layer_params['wo']).to(c.dtype)
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


def embed(params: Params, tokens: torch.Tensor, config) -> torch.Tensor:
    c = config
    x = params['embed'].to(c.dtype)[tokens]
    if c.embed_scale:
        x = x * torch.tensor(math.sqrt(c.hidden_size), dtype=c.dtype,
                             device=x.device)
    return x


def project_logits(x: torch.Tensor, params: Params, config) -> torch.Tensor:
    """Final-norm hidden states -> f32 logits (tied embeddings and the
    final softcap live here)."""
    c = config
    lm_head = (params['embed'].to(c.dtype).T if c.tied_embeddings
               else params['lm_head'])
    logits = torch.einsum('...e,ev->...v', x, lm_head).float()
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
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed(params, tokens, c)
    remat = c.remat and torch.is_grad_enabled()
    for i, window in enumerate(layer_windows(c)):
        lp = layer_params_at(params, i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _layer, x, lp, c, positions, window, use_reentrant=False)
        else:
            x = _layer(x, lp, c, positions, window=window)
    x = _rms_norm(x, params['final_norm'], c.rms_norm_eps, c.norm_plus_one)
    return project_logits(x, params, c)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: LlamaConfig) -> torch.Tensor:
    """Next-token cross-entropy; batch: {'tokens': [B,S], 'mask': [B,S]}.

    Targets are the tokens shifted left; the last position is masked, so
    no host-side shifting is needed. The fused form (target logit minus
    logsumexp) never builds the [B,S,V] log-probabilities."""
    tokens = batch['tokens']
    logits = forward(params, tokens, config)
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                        dim=1)
    mask = batch.get('mask')
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
    mask = mask.float().clone()
    mask[:, -1] = 0.0
    target_logit = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    token_ll = target_logit - torch.logsumexp(logits, dim=-1)
    return -(token_ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
