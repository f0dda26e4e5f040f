"""Model zoo of the port: the llama core and its family presets.

`resolve(name)` mirrors `skypilot_tpu/models/__init__.py::resolve`: a
config name -> (family module, config). The llama, gemma, mistral and
qwen families share the core in `models/llama.py`; each family module
re-exports its functional surface beside its `CONFIGS`. The MoE presets
are not ported yet and raise `NotImplementedError`.
"""
from typing import Any, Tuple

from skypilot_tpu_torch.models import llama

# The reference's MoE presets (skypilot_tpu/models/moe.py), not ported.
_MOE = ('mixtral-8x7b', 'dbrx-moe', 'tiny-moe')


def resolve(name: str) -> Tuple[Any, Any]:
    """Config name -> (family module, config dataclass)."""
    if name in llama.CONFIGS:
        return llama, llama.CONFIGS[name]
    from skypilot_tpu_torch.models import gemma
    from skypilot_tpu_torch.models import mistral
    from skypilot_tpu_torch.models import qwen
    families = (gemma, mistral, qwen)
    for family in families:
        if name in family.CONFIGS:
            return family, family.CONFIGS[name]
    if name in _MOE:
        raise NotImplementedError(
            f'{name!r} is a MoE preset; the PyTorch port serves the llama, '
            'gemma, mistral and qwen families so far (MoE is ROADMAP.md, '
            'Queue 1 item 5).')
    known = sorted(llama.CONFIGS) + sorted(
        n for family in families for n in family.CONFIGS)
    raise ValueError(f'Unknown model {name!r}; available: {known}')


__all__ = ['llama', 'resolve']
