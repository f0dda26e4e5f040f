"""The port stands alone: no JAX, no ml_dtypes, no aiohttp, no transformers,
no yaml, no skypilot_tpu.

A subprocess blocks those packages in `sys.modules`, then imports every
module of `skypilot_tpu_torch` (the serving data plane and control plane
under `serve/`, `resilience/circuit.py`, `task.py` and `fleetsim/` among
them) and the root `chip_smoke.py`, `kernel_fault_check.py`,
`spec_fault_check.py`, `lb_fault_check.py`, `serve_fault_check.py` and
`obs_overhead_check.py`; any forbidden import fails it. Entry points
raise without CUDA unless the caller names a device.
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

BLOCKED = ('jax', 'jaxlib', 'ml_dtypes', 'aiohttp', 'transformers', 'yaml',
           'skypilot_tpu')
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
import lb_fault_check
import obs_overhead_check
import serve_fault_check
import spec_fault_check
leaked = sorted(m for m in sys.modules
                if m.split('.')[0] in BLOCKED and sys.modules[m] is not None)
assert not leaked, leaked
# As on the card: a tokenizer needs transformers, and says so.
from skypilot_tpu_torch.inference import openai_api
try:
    openai_api.load_tokenizer('/nonexistent')
except ImportError as e:
    assert 'transformers' in str(e), e
else:
    raise AssertionError('load_tokenizer without transformers')
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
                   'skypilot_tpu_torch.models.gemma',
                   'skypilot_tpu_torch.models.mistral',
                   'skypilot_tpu_torch.models.qwen',
                   'skypilot_tpu_torch.models.moe',
                   'skypilot_tpu_torch.checkpoints',
                   'skypilot_tpu_torch.checkpoints.hf_import',
                   'skypilot_tpu_torch.checkpoints.safetensors_io',
                   'skypilot_tpu_torch.weights',
                   'skypilot_tpu_torch.envs',
                   'skypilot_tpu_torch.device',
                   'skypilot_tpu_torch.train',
                   'skypilot_tpu_torch.train.trainer',
                   'skypilot_tpu_torch.train.loop',
                   'skypilot_tpu_torch.observability.metrics',
                   'skypilot_tpu_torch.observability.tracing',
                   'skypilot_tpu_torch.observability.spans',
                   'skypilot_tpu_torch.observability.instruments',
                   'skypilot_tpu_torch.observability.timeseries',
                   'skypilot_tpu_torch.observability.watchdog',
                   'skypilot_tpu_torch.observability.top',
                   'skypilot_tpu_torch.observability.trace_dump',
                   'skypilot_tpu_torch.resilience.faults',
                   'skypilot_tpu_torch.resilience.retries',
                   'skypilot_tpu_torch.resilience.circuit',
                   'skypilot_tpu_torch.serve',
                   'skypilot_tpu_torch.serve.load_balancer',
                   'skypilot_tpu_torch.serve.load_balancing_policies',
                   'skypilot_tpu_torch.serve.service_spec',
                   'skypilot_tpu_torch.serve.autoscalers',
                   'skypilot_tpu_torch.serve.serve_state',
                   'skypilot_tpu_torch.serve.spot_placer',
                   'skypilot_tpu_torch.serve.replica_managers',
                   'skypilot_tpu_torch.serve.controller',
                   'skypilot_tpu_torch.serve.core',
                   'skypilot_tpu_torch.task',
                   'skypilot_tpu_torch.utils.paths',
                   'skypilot_tpu_torch.fleetsim',
                   'skypilot_tpu_torch.fleetsim.__main__',
                   'skypilot_tpu_torch.fleetsim.clock',
                   'skypilot_tpu_torch.fleetsim.traffic',
                   'skypilot_tpu_torch.fleetsim.chaos',
                   'skypilot_tpu_torch.fleetsim.slo',
                   'skypilot_tpu_torch.fleetsim.replicas',
                   'skypilot_tpu_torch.fleetsim.runner',
                   'skypilot_tpu_torch.utils.schemas',
                   'skypilot_tpu_torch.exceptions',
                   'skypilot_tpu_torch.inference.openai_api',
                   'skypilot_tpu_torch.inference.batch',
                   'skypilot_tpu_torch.checkpoints.hf_export',
                   'skypilot_tpu_torch.checkpoints.__main__',
                   'skypilot_tpu_torch.train.checkpoints',
                   'skypilot_tpu_torch.parallel',
                   'skypilot_tpu_torch.parallel.mesh',
                   'skypilot_tpu_torch.parallel.sharding',
                   'skypilot_tpu_torch.parallel.control'):
        assert module in names.split()
    assert int(count) >= 40


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


def test_decode_state_keeps_every_tensor_on_the_resolved_device(
        monkeypatch):
    """DecodeState with no device resolves it once, for the cache and the
    last-token row alike (it used to leave the row on the CPU beside a
    CUDA cache). 'meta' stands in for the card here."""
    from skypilot_tpu_torch import device as device_lib
    from skypilot_tpu_torch.inference import engine as eng
    from skypilot_tpu_torch.models import llama
    monkeypatch.setattr(device_lib, 'resolve_device',
                        lambda device=None: torch.device(device or 'meta'))
    state = eng.DecodeState(llama.CONFIGS['tiny'], 2, page_size=8,
                            draft_config=llama.CONFIGS['tiny'])
    for t in (state.last_tokens, state.cache['length'],
              state.draft_cache['table']):
        assert t.device.type == 'meta'


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
