"""Build and bind the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources under `csrc/` (`SOURCES`: the flash forward K1/K2 and the
flash backward K3/K4, both including the shared PTX helpers of
`hopper.cuh`) are compiled at first use on the machine with the card,
for `sm_90a`, one nvcc process per source started together, then
linked into one plain-C shared library loaded with `ctypes` (no PyTorch
headers: the build takes seconds, not minutes).
The library lands in `ops/_build/` (git-ignored) under a name keyed by
the hash of every file under `csrc/` and the flags, so an edited source
or header rebuilds and an unchanged tree is reused. There is no
fallback: without `nvcc`, or when the build fails, `library()` raises.
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
SOURCES = ('flash_fwd.cu', 'flash_bwd.cu')
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = (*ARCH_FLAGS, '-std=c++17', '-O3', '-lineinfo', '-Xptxas=-v',
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


class FlashBwdParams(ctypes.Structure):
    """ctypes mirror of `struct FlashBwdParams` in csrc/flash_bwd.cu."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in ('q', 'k', 'v', 'dout', 'lse',
                                        'delta', 'dq', 'dk', 'dv')]
        + [(f'{t}_s{a}', ctypes.c_int64)
           for t in ('q', 'k', 'v', 'do', 'dq', 'dk', 'dv') for a in 'bsh']
        + [(n, ctypes.c_int32) for n in ('B', 'Sq', 'Skv', 'H', 'KV', 'D',
                                         'causal', 'windowed', 'window',
                                         'q_offset')]
        + [('scale', ctypes.c_float), ('softcap', ctypes.c_float)])


# Entry points of the library: name -> its params struct.
_ENTRY_POINTS = {
    'skytpu_flash_fwd_bf16': FlashParams,
    'skytpu_flash_fwd_int8': FlashParams,
    'skytpu_flash_bwd_dq': FlashBwdParams,
    'skytpu_flash_bwd_dkv': FlashBwdParams,
}
_SIZE_CHECKS = {
    'skytpu_flash_params_size': FlashParams,
    'skytpu_flash_bwd_params_size': FlashBwdParams,
}


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
    """Hash of the flags and of every file under `csrc/`: the sources and
    the headers they include (`hopper.cuh`), so an edited header rebuilds
    as an edited source does."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        path = os.path.join(CSRC, name)
        if os.path.isfile(path):
            with open(path, 'rb') as f:
                h.update(name.encode() + b'\0' + f.read())
    return h.hexdigest()[:16]


def _compile(out_path: str) -> str:
    """One nvcc per source, all started together, into objects in a
    temporary directory; then one link into `out_path`. Returns the
    compilers' log (ptxas register and spill report included)."""
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, name + '.o') for name in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, '-c', '-o', obj, os.path.join(CSRC, name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, obj in zip(SOURCES, objs)]
        log = ''
        failed = []
        for name, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            log += f'== {name}\n{out}'
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f'nvcc failed on {failed}:\n{log}')
        tmp = os.path.join(tmpdir, 'lib.so')
        proc = subprocess.run(
            [nvcc, *ARCH_FLAGS, '-shared', '-o', tmp, *objs],
            capture_output=True, text=True, check=False)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc link failed ({proc.returncode}):\n'
                               f'{log}')
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
        for name, struct in _ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(struct), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name, struct in _SIZE_CHECKS.items():
            fn = getattr(lib, name)
            fn.argtypes = []
            fn.restype = ctypes.c_int
            if fn() != ctypes.sizeof(struct):
                raise RuntimeError(
                    f'{struct.__name__} layout mismatch: C {fn()} bytes, '
                    f'ctypes {ctypes.sizeof(struct)} bytes')
        _info = BuildInfo(path, compiled, time.perf_counter() - t0, log)
        _lib = lib
        return lib


def build_info() -> Optional[BuildInfo]:
    return _info
