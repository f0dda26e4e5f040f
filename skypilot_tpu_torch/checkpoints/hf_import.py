"""HF safetensors -> the port's parameter layout: streaming weight import.

Ports `skypilot_tpu/checkpoints/hf_import.py`: `is_hf_checkpoint` (:66),
`detect_config` (:161) with `_read_config_json`, `_dtype_of`,
`_rope_scaling_knobs` and `_require`, `infer_family` (:232),
`TensorSpec` and `param_specs` (:247-318), `is_ignorable` (:321),
`expected_hf_names` (:330), `_engine_shape`, `_hf_shape`, `_to_engine`
and `_to_hf` (:341-415), `_HostBudget`, `ImportStats`, `load_params`
(:473) with `_place_layer` (:448-548; the reference's `_alloc_stacked`
is a `torch.empty` of this rank's shape here), and `_check_names`
(:605).

1. `detect_config()`: `config.json` -> the port's `LlamaConfig` (llama,
   llama3 rope scaling, gemma, gemma2, mistral, qwen2), the knob set
   `models/llama.py` serves; an explicit null softcap stays off.
2. The name table: HF's per-layer `[out, in]` projections -> the stacked
   `[L, ...]` einsum layouts of `llama.init_params` (transposes and head
   reshapes).
3. `load_params()` streams layer by layer: it reads one shard slice (an
   mmap view), transforms it on the host into an owned tensor of the
   config dtype, and copies it into a preallocated stacked `[L, ...]`
   tensor on the target device (CUDA unless named). Peak host memory is
   O(largest tensor) x SKYTPU_HF_IMPORT_CONCURRENCY, never O(model):
   `ImportStats.peak_host_bytes` counts it.

Each import reports `ImportStats` through the port's instruments, as
the reference does (:594-596): `CKPT_IMPORT_SECONDS`, `_BYTES` and
`_TENSORS`. Under a `mesh` each rank places only its slice of each
tensor (`llama.param_logical_axes` under `parallel.sharding`: heads,
MLP and vocab over `tensor`, `embed` over `fsdp`), cut on the host
before the copy. Knobs:
SKYTPU_HF_IMPORT_STRICT
(an unexpected tensor is an error, not a warning) and
SKYTPU_HF_IMPORT_CONCURRENCY (read/transform threads running ahead of
placement).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from skypilot_tpu_torch import device as device_lib
from skypilot_tpu_torch import envs
from skypilot_tpu_torch.checkpoints import safetensors_io
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.observability import instruments as obs
from skypilot_tpu_torch.parallel import sharding as sharding_lib

logger = logging.getLogger(__name__)

CONFIG_FILENAME = 'config.json'

# HF names present in some checkpoints that carry no weight here (old
# llama exports kept their rotary tables).
_IGNORABLE_SUFFIXES = ('.rotary_emb.inv_freq',)

SUPPORTED_FAMILIES = ('llama', 'gemma', 'gemma2', 'mistral', 'qwen2')


class HFImportError(ValueError):
    """A checkpoint that cannot map onto the model's layout; the message
    names the tensors or fields at fault."""


def is_hf_checkpoint(path: str) -> bool:
    """Does `path` look like an HF safetensors checkpoint (a .safetensors
    file, or a directory with shards or an index)? A directory of shards
    without config.json is an HF checkpoint with a problem, reported
    later by `detect_config`."""
    path = os.path.abspath(os.path.expanduser(path))
    if os.path.isfile(path):
        return path.endswith('.safetensors')
    if not os.path.isdir(path):
        return False
    if os.path.exists(os.path.join(path, safetensors_io.INDEX_FILENAME)):
        return True
    return any(fn.endswith('.safetensors') for fn in os.listdir(path))


# --- config.json -> LlamaConfig ---------------------------------------------


def _read_config_json(ckpt_dir: str) -> Dict[str, Any]:
    root = os.path.abspath(os.path.expanduser(ckpt_dir))
    if os.path.isfile(root):
        # A bare model.safetensors path: its config.json sits beside it.
        root = os.path.dirname(root)
    path = os.path.join(root, CONFIG_FILENAME)
    if not os.path.exists(path):
        raise HFImportError(
            f'{ckpt_dir}: safetensors shards found but no '
            f'{CONFIG_FILENAME}; HF checkpoints carry the model geometry '
            'there.')
    with open(path, encoding='utf-8') as f:
        try:
            return json.load(f)
        except json.JSONDecodeError as e:
            raise HFImportError(f'{path}: invalid JSON ({e})') from None


def _dtype_of(cfg: Dict[str, Any]) -> torch.dtype:
    # float16 checkpoints serve as bf16, as in the reference.
    return (torch.float32 if cfg.get('torch_dtype', 'bfloat16') == 'float32'
            else torch.bfloat16)


def _rope_scaling_knobs(cfg: Dict[str, Any],
                        family: str) -> Dict[str, Any]:
    """Checked for every family: a scaled rope served without its
    scaling decodes off-distribution."""
    rs = cfg.get('rope_scaling')
    if not rs:
        return {}
    kind = rs.get('rope_type', rs.get('type'))
    if kind == 'default':
        return {}
    if kind != 'llama3' or family != 'llama':
        raise HFImportError(
            f'rope_scaling type {kind!r} on family {family!r} is not '
            "supported (only llama's llama3 scheme maps onto the model's "
            'rope); serving the checkpoint without it would decode '
            'off-distribution.')
    if 'factor' not in rs:
        raise HFImportError("rope_scaling is missing required key 'factor'")
    return {
        'rope_scaling_factor': float(rs['factor']),
        'rope_scaling_low_freq_factor': float(rs.get('low_freq_factor', 1.0)),
        'rope_scaling_high_freq_factor':
            float(rs.get('high_freq_factor', 4.0)),
        'rope_scaling_original_max':
            int(rs.get('original_max_position_embeddings', 8192)),
    }


def _require(cfg: Dict[str, Any], key: str) -> Any:
    if key not in cfg:
        raise HFImportError(
            f'config.json is missing required key {key!r} (model_type '
            f'{cfg.get("model_type")!r}): an incomplete download, or a '
            'hand-written config without the model geometry.')
    return cfg[key]


def detect_config(ckpt_dir: str) -> Tuple[str, llama.LlamaConfig]:
    """config.json -> (family name, LlamaConfig): the inverse of the knobs
    `models/{gemma,mistral,qwen}.py` set for their presets."""
    cfg = _read_config_json(ckpt_dir)
    family = cfg.get('model_type')
    if family not in SUPPORTED_FAMILIES:
        raise HFImportError(
            f'model_type {family!r} is not an importable family; '
            f'supported: {list(SUPPORTED_FAMILIES)}')

    def opt(key: str, default: Any) -> Any:
        """An absent key takes HF's default; an explicit null stays None
        (a disabled softcap must not come back)."""
        return cfg[key] if key in cfg else default

    heads = int(_require(cfg, 'num_attention_heads'))
    hidden = int(_require(cfg, 'hidden_size'))
    kw: Dict[str, Any] = dict(
        vocab_size=int(_require(cfg, 'vocab_size')),
        hidden_size=hidden,
        intermediate_size=int(_require(cfg, 'intermediate_size')),
        num_layers=int(_require(cfg, 'num_hidden_layers')),
        num_heads=heads,
        num_kv_heads=int(cfg.get('num_key_value_heads') or heads),
        head_dim=int(cfg.get('head_dim') or hidden // heads),
        max_seq_len=int(cfg.get('max_position_embeddings') or 8192),
        rope_theta=float(cfg.get('rope_theta') or 10000.0),
        rms_norm_eps=float(cfg.get('rms_norm_eps') or 1e-5),
        tied_embeddings=bool(cfg.get('tie_word_embeddings', False)),
        dtype=_dtype_of(cfg),
    )
    kw.update(_rope_scaling_knobs(cfg, family))
    if family == 'mistral':
        if cfg.get('sliding_window'):
            kw.update(sliding_window=int(cfg['sliding_window']),
                      sliding_window_pattern=1)
    elif family == 'qwen2':
        kw.update(attn_qkv_bias=True)
        if cfg.get('use_sliding_window') and cfg.get('sliding_window'):
            kw.update(sliding_window=int(cfg['sliding_window']),
                      sliding_window_pattern=1)
    elif family in ('gemma', 'gemma2'):
        # Gemma ties its embeddings by default, but an untied finetune
        # keeps its trained lm_head.
        kw.update(activation='gelu',
                  tied_embeddings=bool(cfg.get('tie_word_embeddings', True)),
                  embed_scale=True, norm_plus_one=True)
        if family == 'gemma2':
            asc = opt('attn_logit_softcapping', 50.0)
            fsc = opt('final_logit_softcapping', 30.0)
            window = opt('sliding_window', 4096)
            kw.update(post_norms=True,
                      attn_logit_softcap=None if asc is None else float(asc),
                      final_logit_softcap=None if fsc is None else float(fsc))
            if window is not None:
                # HF alternates local and global layers in code, not in
                # the config: every second gemma2 layer is global.
                kw.update(sliding_window=int(window),
                          sliding_window_pattern=2)
            qpa = cfg.get('query_pre_attn_scalar')
            if qpa is not None and float(qpa) != float(kw['head_dim']):
                kw.update(query_pre_attn_scalar=float(qpa))
    return family, llama.LlamaConfig(**kw)


def infer_family(config: llama.LlamaConfig) -> str:
    """LlamaConfig knobs -> HF model_type."""
    if config.norm_plus_one:
        return 'gemma2' if config.post_norms else 'gemma'
    if config.attn_qkv_bias:
        return 'qwen2'
    if (config.sliding_window is not None
            and config.sliding_window_pattern == 1):
        return 'mistral'
    return 'llama'


# --- the HF-name <-> stacked-params table -----------------------------------


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """One param leaf <-> one HF tensor (per layer when stacked). `kind`
    names the layout transform:

      none       copy as-is (norms, embed [vocab, e])
      linear     HF [out, in]        -> [in, out]       (mlp, lm_head)
      in_heads   HF [H*D, e]         -> [e, H, D]       (q/k/v proj)
      out_heads  HF [e, H*D]         -> [H, D, e]       (o proj)
      head_bias  HF [H*D]            -> [H, D]          (qwen2 bias)
    """
    key: str
    hf: str
    kind: str
    stacked: bool = True
    heads: int = 0


def param_specs(config: llama.LlamaConfig) -> List[TensorSpec]:
    """`llama.init_params`' tree, leaf for leaf."""
    c = config
    pre = 'model.layers.{i}.'
    # The pre-MLP norm: HF's post_attention_layernorm slot, except in the
    # post-norm families (gemma2), whose four norms have their own names.
    mlp_norm_hf = (pre + 'pre_feedforward_layernorm.weight' if c.post_norms
                   else pre + 'post_attention_layernorm.weight')
    specs = [
        TensorSpec('attn_norm', pre + 'input_layernorm.weight', 'none'),
        TensorSpec('wq', pre + 'self_attn.q_proj.weight', 'in_heads',
                   heads=c.num_heads),
        TensorSpec('wk', pre + 'self_attn.k_proj.weight', 'in_heads',
                   heads=c.num_kv_heads),
        TensorSpec('wv', pre + 'self_attn.v_proj.weight', 'in_heads',
                   heads=c.num_kv_heads),
        TensorSpec('wo', pre + 'self_attn.o_proj.weight', 'out_heads',
                   heads=c.num_heads),
        TensorSpec('mlp_norm', mlp_norm_hf, 'none'),
        TensorSpec('w_gate', pre + 'mlp.gate_proj.weight', 'linear'),
        TensorSpec('w_up', pre + 'mlp.up_proj.weight', 'linear'),
        TensorSpec('w_down', pre + 'mlp.down_proj.weight', 'linear'),
    ]
    if c.post_norms:
        specs += [
            TensorSpec('post_attn_norm',
                       pre + 'post_attention_layernorm.weight', 'none'),
            TensorSpec('post_mlp_norm',
                       pre + 'post_feedforward_layernorm.weight', 'none'),
        ]
    if c.attn_qkv_bias:
        specs += [
            TensorSpec('bq', pre + 'self_attn.q_proj.bias', 'head_bias',
                       heads=c.num_heads),
            TensorSpec('bk', pre + 'self_attn.k_proj.bias', 'head_bias',
                       heads=c.num_kv_heads),
            TensorSpec('bv', pre + 'self_attn.v_proj.bias', 'head_bias',
                       heads=c.num_kv_heads),
        ]
    specs += [
        TensorSpec('embed', 'model.embed_tokens.weight', 'none',
                   stacked=False),
        TensorSpec('final_norm', 'model.norm.weight', 'none', stacked=False),
    ]
    if not c.tied_embeddings:
        specs.append(TensorSpec('lm_head', 'lm_head.weight', 'linear',
                                stacked=False))
    return specs


def is_ignorable(name: str, config: llama.LlamaConfig) -> bool:
    """HF tensors that may be present but carry no weight here."""
    if name.endswith(_IGNORABLE_SUFFIXES):
        return True
    return config.tied_embeddings and name == 'lm_head.weight'


def expected_hf_names(config: llama.LlamaConfig) -> List[str]:
    names = []
    for spec in param_specs(config):
        if spec.stacked:
            names.extend(spec.hf.format(i=i)
                         for i in range(config.num_layers))
        else:
            names.append(spec.hf)
    return names


def _engine_shape(spec: TensorSpec,
                  config: llama.LlamaConfig) -> Tuple[int, ...]:
    """The shape `_to_engine` gives (per layer for stacked specs), known
    before any tensor is read."""
    c = config
    if spec.kind == 'in_heads':
        return (c.hidden_size, spec.heads, c.head_dim)
    if spec.kind == 'out_heads':
        return (spec.heads, c.head_dim, c.hidden_size)
    if spec.kind == 'head_bias':
        return (spec.heads, c.head_dim)
    hf = _hf_shape(spec, c)
    return hf[::-1] if spec.kind == 'linear' else hf


def _hf_shape(spec: TensorSpec,
              config: llama.LlamaConfig) -> Tuple[int, ...]:
    """The shape the HF tensor must have, from the config geometry."""
    c = config
    e, m, d = c.hidden_size, c.intermediate_size, c.head_dim
    if spec.kind == 'in_heads':
        return (spec.heads * d, e)
    if spec.kind == 'out_heads':
        return (e, spec.heads * d)
    if spec.kind == 'head_bias':
        return (spec.heads * d,)
    if spec.kind == 'linear':
        return {'w_gate': (m, e), 'w_up': (m, e), 'w_down': (e, m),
                'lm_head': (c.vocab_size, e)}[spec.key]
    return {'attn_norm': (e,), 'mlp_norm': (e,), 'post_attn_norm': (e,),
            'post_mlp_norm': (e,), 'final_norm': (e,),
            'embed': (c.vocab_size, e)}[spec.key]


def _to_engine(spec: TensorSpec, tensor: safetensors_io.LazyTensor,
               config: llama.LlamaConfig) -> torch.Tensor:
    """HF layout -> the port's layout: one owned, contiguous host tensor
    of the config dtype (never a view of the shard's mmap)."""
    d, e = config.head_dim, config.hidden_size
    arr = tensor.read()
    if spec.kind == 'in_heads':
        arr = arr.T.reshape(e, spec.heads, d)
    elif spec.kind == 'out_heads':
        arr = arr.T.reshape(spec.heads, d, e)
    elif spec.kind == 'head_bias':
        arr = arr.reshape(spec.heads, d)
    elif spec.kind == 'linear':
        arr = arr.T
    host = np.ascontiguousarray(arr)
    if not host.flags.owndata:
        host = host.copy()
    return safetensors_io.to_torch(host, tensor.tag).to(config.dtype)


def _to_hf(spec: TensorSpec, t: torch.Tensor,
           config: llama.LlamaConfig) -> torch.Tensor:
    """The port's layout -> HF layout (the inverse of `_to_engine`), as a
    contiguous host tensor."""
    d, e = config.head_dim, config.hidden_size
    t = t.detach().cpu()
    if spec.kind == 'in_heads':
        t = t.reshape(e, spec.heads * d).T
    elif spec.kind == 'out_heads':
        t = t.reshape(spec.heads * d, e).T
    elif spec.kind == 'head_bias':
        t = t.reshape(spec.heads * d)
    elif spec.kind == 'linear':
        t = t.T
    return t.contiguous()


# --- streaming loader -------------------------------------------------------


class _HostBudget:
    """Bytes of live host copies (prefetch threads add from theirs)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.live = 0
        self.peak = 0

    def add(self, n: int) -> None:
        with self._lock:
            self.live += n
            self.peak = max(self.peak, self.live)

    def sub(self, n: int) -> None:
        with self._lock:
            self.live -= n


@dataclasses.dataclass
class ImportStats:
    seconds: float = 0.0
    bytes_read: int = 0
    tensors: int = 0
    shards: int = 0
    peak_host_bytes: int = 0
    largest_tensor_bytes: int = 0
    stacked_layer_bytes: int = 0   # largest single-layer slice placed


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _place_layer(stacked: torch.Tensor, host: torch.Tensor, i: int,
                 shard: sharding_lib.Shard) -> None:
    """Layer i of a host tensor, cut to this rank's slice (`shard` of the
    stacked leaf, its dim one past the layer's), into `stacked`. A copy
    from pageable host memory returns once the host buffer is read."""
    stacked[i].copy_(shard.per_layer()(host))


def load_params(
        ckpt_dir: str,
        config: Optional[llama.LlamaConfig] = None,
        device: Optional[Union[str, torch.device]] = None,
        strict: Optional[bool] = None,
        concurrency: Optional[int] = None,
        mesh: Optional[Any] = None,
) -> Tuple[Dict[str, Any], llama.LlamaConfig, ImportStats]:
    """Import an HF safetensors checkpoint onto `device` (CUDA unless
    named; a mesh's own device under `mesh`). Returns (params in
    `llama.init_params`' layout, this rank's slices under a
    mesh, the config served, detected from config.json
    unless given, and the stats)."""
    t0 = time.perf_counter()
    if config is None:
        _family, config = detect_config(ckpt_dir)
    if strict is None:
        strict = envs.SKYTPU_HF_IMPORT_STRICT.get()
    if concurrency is None:
        concurrency = envs.SKYTPU_HF_IMPORT_CONCURRENCY.get()
    concurrency = max(1, int(concurrency))
    dev = mesh.device if mesh is not None else device_lib.resolve_device(
        device)
    c = config
    specs = param_specs(c)
    shardings = sharding_lib.tree_shardings(
        mesh, llama.param_logical_axes(c)) if mesh is not None else None

    def shard_of(spec: TensorSpec) -> sharding_lib.Shard:
        if shardings is None:
            return sharding_lib.Shard()
        return (shardings['layers'][spec.key] if spec.stacked
                else shardings[spec.key])
    budget = _HostBudget()
    stats = ImportStats()

    with safetensors_io.CheckpointReader(ckpt_dir) as reader:
        stats.shards = reader.num_shards
        _check_names(reader, c, strict)
        stats_lock = threading.Lock()

        def fetch(spec: TensorSpec, hf_name: str) -> torch.Tensor:
            tensor = reader.tensor(hf_name)
            want = _hf_shape(spec, c)
            if tensor.shape != want:
                raise HFImportError(
                    f'{hf_name}: shape {tensor.shape} does not match the '
                    f'config geometry {want} (shard {tensor.shard}): the '
                    'wrong config.json for these weights?')
            host = _to_engine(spec, tensor, c)
            budget.add(_nbytes(host))
            with stats_lock:
                stats.bytes_read += tensor.nbytes
                stats.tensors += 1
                stats.largest_tensor_bytes = max(
                    stats.largest_tensor_bytes, tensor.nbytes)
                if spec.stacked:
                    stats.stacked_layer_bytes = max(
                        stats.stacked_layer_bytes, _nbytes(host))
            return host

        stacked_specs = [s for s in specs if s.stacked]
        bufs: Dict[str, torch.Tensor] = {
            s.key: torch.empty(shard_of(s).local_shape(
                (c.num_layers,) + _engine_shape(s, c)), dtype=c.dtype,
                device=dev)
            for s in stacked_specs}

        def place_one(spec: TensorSpec, host: torch.Tensor, i: int) -> None:
            _place_layer(bufs[spec.key], host, i, shard_of(spec))
            budget.sub(_nbytes(host))

        # Layer-major, the order HF checkpoints ship (a shard holds
        # consecutive layers): each shard's pages are read once.
        items = [(i, s) for i in range(c.num_layers) for s in stacked_specs]
        if concurrency > 1 and items:
            # At most `concurrency` transformed tensors live at once.
            import concurrent.futures as cf
            with cf.ThreadPoolExecutor(concurrency) as pool:
                pending = []
                for i, spec in items:
                    pending.append((i, spec, pool.submit(
                        fetch, spec, spec.hf.format(i=i))))
                    if len(pending) >= concurrency:
                        j, sp, fut = pending.pop(0)
                        place_one(sp, fut.result(), j)
                for j, sp, fut in pending:
                    place_one(sp, fut.result(), j)
        else:
            for i, spec in items:
                place_one(spec, fetch(spec, spec.hf.format(i=i)), i)

        out: Dict[str, Any] = {'layers': bufs}
        for spec in specs:
            if not spec.stacked:
                host = fetch(spec, spec.hf)
                out[spec.key] = shard_of(spec)(host).clone().to(dev)
                budget.sub(_nbytes(host))
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    stats.peak_host_bytes = budget.peak
    stats.seconds = time.perf_counter() - t0
    obs.CKPT_IMPORT_SECONDS.observe(stats.seconds)
    obs.CKPT_IMPORT_BYTES.inc(stats.bytes_read)
    obs.CKPT_IMPORT_TENSORS.inc(stats.tensors)
    logger.info('hf import: %d tensors / %.1f MiB from %d shard(s) in '
                '%.2fs (peak host %.1f MiB)', stats.tensors,
                stats.bytes_read / 2**20, stats.shards, stats.seconds,
                stats.peak_host_bytes / 2**20)
    return out, config, stats


def _check_names(reader: safetensors_io.CheckpointReader,
                 config: llama.LlamaConfig, strict: bool) -> None:
    """A missing tensor is always fatal; an unexpected one is fatal under
    SKYTPU_HF_IMPORT_STRICT (the default: it usually means the wrong
    config.json or family) and logged otherwise."""
    present = set(reader.names())
    expected = set(expected_hf_names(config))
    missing = sorted(expected - present)
    if missing:
        head = ', '.join(missing[:4])
        raise HFImportError(
            f'checkpoint is missing {len(missing)} expected tensor(s): '
            f'{head}{", ..." if len(missing) > 4 else ""} (a torn '
            'download, or config.json geometry that does not match these '
            'weights); nearest present to the first: '
            f'{safetensors_io._nearest(missing[0], present)}')
    extra = sorted(name for name in present - expected
                   if not is_ignorable(name, config))
    if extra:
        head = ', '.join(extra[:4])
        msg = (f'checkpoint carries {len(extra)} unexpected tensor(s): '
               f'{head}{", ..." if len(extra) > 4 else ""} (a wrong '
               'family, or weights the model would drop). Set '
               'SKYTPU_HF_IMPORT_STRICT=0 to import anyway.')
        if strict:
            raise HFImportError(msg)
        logger.warning('hf import (non-strict): %s', msg)
