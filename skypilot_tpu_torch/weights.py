"""Parameters and configs handed over from the JAX reference, as numpy.

`from_jax_params` turns a parameter tree of numpy arrays (the reference
`init_params` output after `np.asarray` on each leaf) into the port's
tree of tensors, leaf for leaf, in the same stacked layout. bfloat16
arrays (numpy dtype name 'bfloat16') are reinterpreted through a uint16
view, so neither JAX nor ml_dtypes is imported here. With a config,
floating leaves take its dtype, except the leaves the family keeps in
f32 whatever the model dtype (the MoE router, `moe.F32_LEAVES`).
`config_from_dict` builds the port's `LlamaConfig`, or `MoeConfig` when
the fields name experts, from `dataclasses.asdict(reference_config)`,
with the dtype given by name or as any object numpy recognises as a
dtype. `from_jax_train_state` carries a whole reference train state
across (params, and optax's AdamW mu, nu and count), for the tests that
hold the port's step under a mesh against the reference's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import moe

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


def from_jax_params(tree: Any, config: Optional[Any] = None,
                    device: Union[str, torch.device] = 'cpu') -> Any:
    """Nested dicts of numpy arrays -> the same nesting of tensors.
    With `config`, floating leaves take its dtypes (`cast_params`)."""
    tree = _map(lambda a, _path: to_tensor(a, device), tree)
    return tree if config is None else cast_params(tree, config)


def _adam_state(opt_state: Any) -> Any:
    """The first node of an optax state (nested tuples and named tuples)
    that carries `mu` and `nu`: `ScaleByAdamState`."""
    if hasattr(opt_state, 'mu') and hasattr(opt_state, 'nu'):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for node in opt_state:
            found = _adam_state(node)
            if found is not None:
                return found
    return None


def from_jax_train_state(state: Dict[str, Any], config: Optional[Any] = None,
                         device: Union[str, torch.device] = 'cpu'
                         ) -> Dict[str, Any]:
    """A reference train state ({'params', 'opt_state', 'step'} with
    numpy leaves: the reference's `make_train_state` or a step's output
    after `np.asarray` on each leaf) -> the port's full train state:
    params (in `config`'s dtypes, with one), the AdamW moments in their
    own dtypes, the count and the step (`trainer.shard_state` cuts it to
    a rank's slice)."""
    adam = _adam_state(state['opt_state'])
    if adam is None:
        raise ValueError('the optimizer state holds no AdamW mu/nu')
    return {'params': from_jax_params(state['params'], config, device),
            'opt_state': {'count': int(np.asarray(adam.count)),
                          'mu': from_jax_params(adam.mu, None, device),
                          'nu': from_jax_params(adam.nu, None, device)},
            'step': int(np.asarray(state['step']))}


def _map(fn, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """fn(leaf, path) over a nested dict, path the keys down to it."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(tree, path)


def cast_params(tree: Any, config: Any,
                device: Optional[Union[str, torch.device]] = None) -> Any:
    """A params tree in `config`'s dtypes (on `device` if given):
    floating leaves in the config dtype, except the leaves the family
    keeps in f32 (`moe.F32_LEAVES`), in f32. Leaves already right are
    returned as they are."""
    keep = moe.F32_LEAVES if isinstance(config, moe.MoeConfig) else ()

    def cast(t, path):
        if t.is_floating_point():
            t = t.to(torch.float32 if path in keep else config.dtype)
        return t if device is None else t.to(device)

    return _map(cast, tree)


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


def config_from_dict(d: Dict[str, Any]) -> Any:
    """The port's LlamaConfig, or MoeConfig when the fields name
    `num_experts`, from a reference config's fields."""
    fields = dict(d)
    fields['dtype'] = dtype_from_name(fields.get('dtype', 'bfloat16'))
    if 'num_experts' in fields:
        return moe.MoeConfig(**fields)
    return llama.LlamaConfig(**fields)
