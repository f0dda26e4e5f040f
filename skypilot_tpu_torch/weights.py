"""Parameters and configs handed over from the JAX reference, as numpy.

`from_jax_params` turns a parameter tree of numpy arrays (the reference
`init_params` output after `np.asarray` on each leaf) into the port's
tree of tensors, leaf for leaf, in the same stacked layout. bfloat16
arrays (numpy dtype name 'bfloat16') are reinterpreted through a uint16
view, so neither JAX nor ml_dtypes is imported here.
`config_from_dict` builds the port's `LlamaConfig` from
`dataclasses.asdict(reference_config)`, with the dtype given by name or
as any object numpy recognises as a dtype.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from skypilot_tpu_torch.models import llama

_TORCH_DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32,
                 'float16': torch.float16}


def to_tensor(arr: Any, device: Union[str, torch.device] = 'cpu'
              ) -> torch.Tensor:
    """One numpy array (bf16 included) -> a tensor on `device`."""
    arr = np.asarray(arr)
    if arr.dtype.name == 'bfloat16':
        t = torch.from_numpy(
            np.ascontiguousarray(arr).view(np.uint16).copy()).view(
                torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def from_jax_params(tree: Any, config: Optional[llama.LlamaConfig] = None,
                    device: Union[str, torch.device] = 'cpu') -> Any:
    """Nested dicts of numpy arrays -> the same nesting of tensors.
    With `config`, floating leaves are cast to its dtype."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, config, device)
                for k, v in tree.items()}
    t = to_tensor(tree, device)
    if config is not None and t.is_floating_point():
        t = t.to(config.dtype)
    return t


def dtype_from_name(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(getattr(dtype, 'dtype', dtype)).name
    if name not in _TORCH_DTYPES:
        raise ValueError(f'unsupported dtype {dtype!r}')
    return _TORCH_DTYPES[name]


def config_from_dict(d: Dict[str, Any]) -> llama.LlamaConfig:
    """The port's LlamaConfig from a reference config's fields."""
    fields = dict(d)
    fields['dtype'] = dtype_from_name(fields.get('dtype', 'bfloat16'))
    return llama.LlamaConfig(**fields)
