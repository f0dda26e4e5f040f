"""Model zoo of the port: the llama core, its family presets and MoE.

`resolve(name)` mirrors `skypilot_tpu/models/__init__.py::resolve`: a
config name -> (family module, config). The llama, gemma, mistral and
qwen families share the core in `models/llama.py`; each family module
re-exports its functional surface beside its `CONFIGS`. The MoE presets
(mixtral-8x7b, dbrx-moe, tiny-moe) resolve to `models/moe.py`.
"""
from typing import Any, Tuple

from skypilot_tpu_torch.models import llama


def resolve(name: str) -> Tuple[Any, Any]:
    """Config name -> (family module, config dataclass)."""
    if name in llama.CONFIGS:
        return llama, llama.CONFIGS[name]
    from skypilot_tpu_torch.models import gemma
    from skypilot_tpu_torch.models import mistral
    from skypilot_tpu_torch.models import moe
    from skypilot_tpu_torch.models import qwen
    families = (gemma, mistral, moe, qwen)
    for family in families:
        if name in family.CONFIGS:
            return family, family.CONFIGS[name]
    known = sorted(llama.CONFIGS) + sorted(
        n for family in families for n in family.CONFIGS)
    raise ValueError(f'Unknown model {name!r}; available: {known}')


__all__ = ['llama', 'resolve']
