"""Build and bind the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources under `csrc/` are compiled at first use on the machine with
the card, for `sm_90a`, into a plain-C shared library, and loaded with
`ctypes` (no PyTorch headers: the build takes seconds, not minutes).
The library lands in `ops/_build/` (git-ignored) under a name keyed by
the hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. There is no fallback: without `nvcc`, or when
the build fails, `library()` raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, 'csrc')
BUILD_DIR = os.path.join(_HERE, '_build')
SOURCES = ('flash_fwd.cu',)
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-lineinfo', '-Xptxas=-v', '-shared',
              '-Xcompiler', '-fPIC')


class FlashParams(ctypes.Structure):
    """ctypes mirror of `struct FlashParams` in csrc/flash_fwd.cu."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in ('q', 'k', 'v', 'ks', 'vs', 'o',
                                        'lse')]
        + [(f'{t}_s{a}', ctypes.c_int64)
           for t in ('q', 'k', 'v', 'ks', 'vs', 'o') for a in 'bsh']
        + [(n, ctypes.c_int32) for n in ('B', 'Sq', 'Skv', 'H', 'KV', 'D',
                                         'causal', 'windowed', 'window',
                                         'q_offset')]
        + [('scale', ctypes.c_float), ('softcap', ctypes.c_float)])


class BuildInfo:
    """What the last `library()` call did: the .so path, whether it
    compiled (vs reused a cached build), seconds spent and nvcc's log
    (register/spill report from -Xptxas=-v)."""

    def __init__(self, path: str, compiled: bool, seconds: float,
                 log: str) -> None:
        self.path = path
        self.compiled = compiled
        self.seconds = seconds
        self.log = log


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None


def find_nvcc() -> str:
    nvcc = shutil.which('nvcc')
    if nvcc is None and os.path.exists('/usr/local/cuda/bin/nvcc'):
        nvcc = '/usr/local/cuda/bin/nvcc'
    if nvcc is None:
        raise RuntimeError(
            'nvcc not found: the flash-attention kernels are built from '
            'skypilot_tpu_torch/ops/csrc at first use and need the CUDA '
            'toolkit (nvcc on PATH or /usr/local/cuda/bin/nvcc).')
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), 'rb') as f:
            h.update(name.encode() + b'\0' + f.read())
    return h.hexdigest()[:16]


def _compile(out_path: str) -> str:
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, '-o', tmp,
           *[os.path.join(CSRC, s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          check=False)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{log}')
    with open(out_path + '.log', 'w') as f:
        f.write(log)
    os.replace(tmp, out_path)  # atomic: a concurrent load never sees half
    return log


def library() -> ctypes.CDLL:
    """The kernel library, built if the sources changed since the last
    build. Thread-safe; raises on any build or load failure."""
    global _lib, _info
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        path = os.path.join(BUILD_DIR, f'libskytpu_kernels_{_digest()}.so')
        compiled = not os.path.exists(path)
        if compiled:
            log = _compile(path)
        else:
            with open(path + '.log') as f:
                log = f.read()
        lib = ctypes.CDLL(path)
        lib.skytpu_flash_params_size.argtypes = []
        lib.skytpu_flash_params_size.restype = ctypes.c_int
        for name in ('skytpu_flash_fwd_bf16', 'skytpu_flash_fwd_int8'):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(FlashParams), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        size = lib.skytpu_flash_params_size()
        if size != ctypes.sizeof(FlashParams):
            raise RuntimeError(
                f'FlashParams layout mismatch: C {size} bytes, ctypes '
                f'{ctypes.sizeof(FlashParams)} bytes')
        _info = BuildInfo(path, compiled, time.perf_counter() - t0, log)
        _lib = lib
        return lib


def build_info() -> Optional[BuildInfo]:
    return _info
