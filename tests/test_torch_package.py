"""The port stands alone: no JAX, no ml_dtypes, no aiohttp, no skypilot_tpu.

A subprocess blocks those packages in `sys.modules`, then imports every
module of `skypilot_tpu_torch` and the root `chip_smoke.py` and
`kernel_fault_check.py`; any
forbidden import fails it. Entry points raise without CUDA unless the
caller names a device.
"""
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r'''
import pkgutil
import sys

BLOCKED = ('jax', 'jaxlib', 'ml_dtypes', 'aiohttp', 'skypilot_tpu')
for name in BLOCKED:
    sys.modules[name] = None  # any import of it now raises ImportError

import skypilot_tpu_torch
names = ['skypilot_tpu_torch']
for info in pkgutil.walk_packages(skypilot_tpu_torch.__path__,
                                  'skypilot_tpu_torch.'):
    __import__(info.name)
    names.append(info.name)
import chip_smoke
import kernel_fault_check
leaked = sorted(m for m in sys.modules
                if m.split('.')[0] in BLOCKED and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names), ' '.join(sorted(names)))
'''


def test_port_imports_without_jax_or_the_reference_package():
    proc = subprocess.run([sys.executable, '-c', _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, 'PYTHONPATH': REPO})
    assert proc.returncode == 0, proc.stderr
    count, names = proc.stdout.split(' ', 1)
    for module in ('skypilot_tpu_torch.ops.flash_attention',
                   'skypilot_tpu_torch.ops._build',
                   'skypilot_tpu_torch.inference.engine',
                   'skypilot_tpu_torch.inference.prefix_cache',
                   'skypilot_tpu_torch.inference.server',
                   'skypilot_tpu_torch.models.llama',
                   'skypilot_tpu_torch.weights',
                   'skypilot_tpu_torch.envs',
                   'skypilot_tpu_torch.device',
                   'skypilot_tpu_torch.train',
                   'skypilot_tpu_torch.train.trainer',
                   'skypilot_tpu_torch.train.loop'):
        assert module in names.split()
    assert int(count) >= 16


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('CUDA present: the default device is valid here')
    from skypilot_tpu_torch import device as device_lib
    from skypilot_tpu_torch import inference
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        inference.build_engine('tiny')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        device_lib.resolve_device(None)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        device_lib.resolve_device('cuda')
    assert device_lib.resolve_device('cpu') == torch.device('cpu')


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """Alone in a directory, or without CUDA, chip_smoke prints no result
    and exits non-zero."""
    if torch.cuda.is_available():
        pytest.skip('CUDA present')
    for cwd, script in ((REPO, os.path.join(REPO, 'chip_smoke.py')),
                        (tmp_path, None)):
        if script is None:
            script = tmp_path / 'chip_smoke.py'
            script.write_text(open(os.path.join(REPO, 'chip_smoke.py')).read())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
