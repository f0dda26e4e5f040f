"""Training on one device: trainer (state, optimizer, step) and loop (fit)."""
from skypilot_tpu_torch.train import trainer

__all__ = ['trainer']
