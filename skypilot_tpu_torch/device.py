"""Device resolution for every entry point of the port.

The port runs on CUDA unless the caller names another device (the CPU
tests pass `device='cpu'`). Without CUDA and without an explicit device
it raises instead of carrying on silently on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` -> cuda (raises when CUDA is absent); anything else is
    taken as given, with a CUDA device checked for availability."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available: skypilot_tpu_torch runs on an NVIDIA '
            "GPU by default. Pass device='cpu' explicitly to run the "
            'plain PyTorch paths on the CPU.')
    return dev

