"""The port's params -> HF safetensors: the round trip for fine-tuned
weights.

Ports `skypilot_tpu/checkpoints/hf_export.py`: `ExportStats` (:36),
`hf_config_dict` (:44) and `export_params` (:101). A model fine-tuned by
`train/loop.py` leaves a port train checkpoint; this writes its params
back in the HF layout (sharded `model-0000i-of-0000n.safetensors` +
index + `config.json`), which any HF consumer reads and `hf_import`
re-imports. The shards are byte-identical to the reference's export of
the same params (a test pins it).

Streaming as the importer does: one LAYER slice is pulled off the device
at a time (`params['layers'][key][i]`), turned into the HF layout on
the host (`hf_import._to_hf`) and handed to the `ShardedWriter`, which
appends its bytes straight to the shard's payload file. Peak host
memory is O(largest tensor). Each export reports through
`CKPT_EXPORT_SECONDS` and `CKPT_EXPORT_BYTES`, as in the reference
(:146-147).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Dict, Optional

import torch

from skypilot_tpu_torch.checkpoints import hf_import
from skypilot_tpu_torch.checkpoints import safetensors_io
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.observability import instruments as obs

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ExportStats:
    seconds: float = 0.0
    bytes_written: int = 0
    tensors: int = 0
    shards: int = 0


def hf_config_dict(config: llama.LlamaConfig,
                   family: Optional[str] = None) -> Dict[str, Any]:
    """LlamaConfig -> the config.json the detector round-trips. Every
    geometry knob the importer reads is written explicitly, so defaults
    drifting between HF versions cannot change what re-imports."""
    c = config
    family = family or hf_import.infer_family(c)
    torch_dtype = 'float32' if c.dtype == torch.float32 else 'bfloat16'
    out: Dict[str, Any] = {
        'model_type': family,
        'architectures': [{
            'llama': 'LlamaForCausalLM',
            'gemma': 'GemmaForCausalLM',
            'gemma2': 'Gemma2ForCausalLM',
            'mistral': 'MistralForCausalLM',
            'qwen2': 'Qwen2ForCausalLM',
        }[family]],
        'vocab_size': c.vocab_size,
        'hidden_size': c.hidden_size,
        'intermediate_size': c.intermediate_size,
        'num_hidden_layers': c.num_layers,
        'num_attention_heads': c.num_heads,
        'num_key_value_heads': c.num_kv_heads,
        'head_dim': c.head_dim,
        'max_position_embeddings': c.max_seq_len,
        'rope_theta': c.rope_theta,
        'rms_norm_eps': c.rms_norm_eps,
        'tie_word_embeddings': c.tied_embeddings,
        'torch_dtype': torch_dtype,
    }
    if c.rope_scaling_factor is not None:
        out['rope_scaling'] = {
            'rope_type': 'llama3',
            'factor': c.rope_scaling_factor,
            'low_freq_factor': c.rope_scaling_low_freq_factor,
            'high_freq_factor': c.rope_scaling_high_freq_factor,
            'original_max_position_embeddings':
                c.rope_scaling_original_max,
        }
    if family == 'mistral' or (family == 'qwen2'
                               and c.sliding_window is not None):
        out['sliding_window'] = c.sliding_window
        if family == 'qwen2':
            out['use_sliding_window'] = True
    if family == 'gemma2':
        out['attn_logit_softcapping'] = c.attn_logit_softcap
        out['final_logit_softcapping'] = c.final_logit_softcap
        out['sliding_window'] = c.sliding_window
        if c.query_pre_attn_scalar is not None:
            out['query_pre_attn_scalar'] = c.query_pre_attn_scalar
    return out


def export_params(params: Dict[str, Any],
                  config: llama.LlamaConfig,
                  out_dir: str,
                  family: Optional[str] = None,
                  max_shard_bytes: int = 5 * 2**30) -> ExportStats:
    """Write `params` (the `llama.init_params` tree, on any device) as an
    HF checkpoint dir. Tensor order is HF's: embeddings, then layers in
    order (so a shard holds consecutive layers and the importer's
    layer-major pass reads each shard once), then the final norm and
    lm_head. An MoE config raises NotImplementedError: the HF layout
    covers the llama-core families only (`hf_import.SUPPORTED_FAMILIES`),
    as in the reference."""
    if isinstance(config, moe.MoeConfig):
        raise NotImplementedError(
            'HF export of an MoE model is not supported: the HF layout '
            f'covers {list(hf_import.SUPPORTED_FAMILIES)}. Keep the train '
            'checkpoint; the server and batch read it with --checkpoint.')
    t0 = time.perf_counter()
    c = config
    out_dir = os.path.abspath(os.path.expanduser(out_dir))
    specs = {spec.key: spec for spec in hf_import.param_specs(c)}
    writer = safetensors_io.ShardedWriter(
        out_dir, max_shard_bytes=max_shard_bytes,
        metadata={'format': 'pt'})
    stats = ExportStats()

    def add(spec_key: str, hf_name: str, t: torch.Tensor) -> None:
        host = hf_import._to_hf(specs[spec_key], t, c)
        writer.add(hf_name, host)
        stats.bytes_written += host.numel() * host.element_size()
        stats.tensors += 1

    add('embed', specs['embed'].hf, params['embed'])
    layer_keys = [k for k in specs if specs[k].stacked]
    for i in range(c.num_layers):
        for key in layer_keys:
            # One [i] slice off the device at a time, never the stacked
            # tensor.
            add(key, specs[key].hf.format(i=i), params['layers'][key][i])
    add('final_norm', specs['final_norm'].hf, params['final_norm'])
    if not c.tied_embeddings:
        add('lm_head', specs['lm_head'].hf, params['lm_head'])
    written = writer.close()
    stats.shards = sum(1 for fn in written if fn.endswith('.safetensors'))

    with open(os.path.join(out_dir, hf_import.CONFIG_FILENAME), 'w',
              encoding='utf-8') as f:
        json.dump(hf_config_dict(c, family), f, indent=2, sort_keys=True)

    stats.seconds = time.perf_counter() - t0
    obs.CKPT_EXPORT_SECONDS.observe(stats.seconds)
    obs.CKPT_EXPORT_BYTES.inc(stats.bytes_written)
    logger.info('hf export: %d tensors / %.1f MiB -> %s (%d shard(s)) in '
                '%.2fs', stats.tensors, stats.bytes_written / 2**20,
                out_dir, stats.shards, stats.seconds)
    return stats
