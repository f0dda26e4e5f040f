"""Checkpoints for the port: HF safetensors import and export.

Ports `skypilot_tpu/checkpoints/__init__.py`:
`load_params(dir)` streams an HF checkpoint (family detected from its
config.json) onto a device, `export_params(params, config, dir)` writes
the params back as an HF checkpoint (the fine-tune round trip),
`hf_config_dict` gives its config.json, `is_hf_checkpoint(dir)` tells an
HF directory from anything else, and `safetensors_io` owns the file
format (no `safetensors` package, no `ml_dtypes`).
`python -m skypilot_tpu_torch.checkpoints` inspects, imports, verifies
and exports from the shell.
"""
from skypilot_tpu_torch.checkpoints.hf_export import (ExportStats,
                                                      export_params,
                                                      hf_config_dict)
from skypilot_tpu_torch.checkpoints.hf_import import (HFImportError,
                                                      ImportStats,
                                                      detect_config,
                                                      infer_family,
                                                      is_hf_checkpoint,
                                                      load_params)
from skypilot_tpu_torch.checkpoints.safetensors_io import (
    CheckpointFormatError, CheckpointReader, ShardedWriter,
    write_safetensors)

__all__ = [
    'CheckpointFormatError', 'CheckpointReader', 'ExportStats',
    'HFImportError', 'ImportStats', 'ShardedWriter', 'detect_config',
    'export_params', 'hf_config_dict', 'infer_family',
    'is_hf_checkpoint', 'load_params', 'write_safetensors',
]
