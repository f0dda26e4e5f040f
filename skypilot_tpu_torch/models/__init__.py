"""Model zoo of the port. This slice ports the llama family only.

`resolve(name)` mirrors `skypilot_tpu/models/__init__.py::resolve`: a
config name -> (family module, config). Names of the families still to
be ported raise `NotImplementedError`.
"""
from typing import Any, Tuple

from skypilot_tpu_torch.models import llama

# Presets of the reference's other families (skypilot_tpu/models/
# gemma.py, mistral.py, moe.py, qwen.py), not ported yet.
_UNPORTED = {
    'gemma': ('gemma2-2b', 'gemma2-9b', 'gemma2-27b', 'tiny-gemma'),
    'mistral': ('mistral-7b', 'tiny-mistral'),
    'moe': ('mixtral-8x7b', 'dbrx-moe', 'tiny-moe'),
    'qwen': ('qwen2-7b', 'qwen2.5-1.5b', 'qwen2.5-72b', 'tiny-qwen'),
}


def resolve(name: str) -> Tuple[Any, Any]:
    """Config name -> (family module, config dataclass)."""
    if name in llama.CONFIGS:
        return llama, llama.CONFIGS[name]
    for family, names in _UNPORTED.items():
        if name in names:
            raise NotImplementedError(
                f'{name!r} is a {family} preset; the PyTorch port serves '
                'the llama family only so far (see ROADMAP.md, Queue 1).')
    raise ValueError(f'Unknown model {name!r}; available: '
                     f'{sorted(llama.CONFIGS)}')


__all__ = ['llama', 'resolve']
