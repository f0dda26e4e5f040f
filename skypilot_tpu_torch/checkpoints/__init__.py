"""Checkpoints for the port: HF safetensors import.

Ports the import half of `skypilot_tpu/checkpoints/__init__.py`:
`load_params(dir)` streams an HF checkpoint (family detected from its
config.json) onto a device, `is_hf_checkpoint(dir)` tells an HF
directory from anything else, and `safetensors_io` owns the file format
(no `safetensors` package, no `ml_dtypes`). `hf_export` and the
`python -m skypilot_tpu.checkpoints` command line wait for a later
slice (ROADMAP.md, Queue 1 item 4).
"""
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
    'CheckpointFormatError', 'CheckpointReader', 'HFImportError',
    'ImportStats', 'ShardedWriter', 'detect_config', 'infer_family',
    'is_hf_checkpoint', 'load_params', 'write_safetensors',
]
