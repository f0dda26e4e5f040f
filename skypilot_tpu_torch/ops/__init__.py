"""Attention ops: the plain reference (`attention.py`) and the flash
forward kernels (`flash_attention.py`, sources in `csrc/`)."""
