"""chip_smoke's lb_serve phase rehearsed on the CPU at the tiny size.

Three tiny engines of the port (batch 4, a paged cache with the prefix
cache on, as the migration phase's engines on the card) behind the port's
load balancer, every K1 launch counted by a stand-in that computes the
plain version (as `tests/test_torch_chip_phases.py` counts them), the
prompt sizes cut to the tiny engines: legs (a)-(f) run their gates, the
sound run breaks none, and every fault `lb_fault_check.py` plants breaks
the gate it names (`lb_fault_check.check`, the card's own loop).
"""
import os
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import lb_fault_check  # noqa: E402

TINY_KW = dict(batch_size=4, max_seq_len=160, prefill_chunk=16,
               kv_page_size=8, decode_fuse_steps=2)


@pytest.fixture
def counted_kernels(monkeypatch):
    """Each K1/K2 call through `_launch` (the wrappers' `flash_fwd`
    routed there) counted as the wrappers count a launch (`_count`), the
    plain version computing; the engines serve through the flash path;
    CUDA-only calls made no-ops."""
    from skypilot_tpu_torch.inference import engine as eng
    from skypilot_tpu_torch.ops import flash_attention as fa

    def launch(q, k, v, causal, window, softcap, q_offset, k_scale=None,
               v_scale=None):
        fa._count(fa.flash_attention if k_scale is None
                  else fa.flash_attention_quant, window, causal, q_offset)
        return fa._plain(q, k, v, causal, 512, window, softcap, q_offset,
                         k_scale=k_scale, v_scale=v_scale)

    def flash_fwd(q, k, v, causal=True, block_q=512, block_k=512,
                  window=None, softcap=None, q_offset=None, k_scale=None,
                  v_scale=None):
        return fa._launch(q, k, v, causal, window, softcap, q_offset,
                          k_scale=k_scale, v_scale=v_scale)

    monkeypatch.setattr(fa, '_launch', launch)
    monkeypatch.setattr(fa, 'flash_fwd', flash_fwd)
    monkeypatch.setattr(eng, 'default_use_flash', lambda device: True)
    for name in ('synchronize', 'empty_cache'):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(chip_smoke, 'DEV', 'cpu')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield fa
    torch.set_num_threads(threads)


@pytest.fixture
def tiny_fleet(monkeypatch, counted_kernels):
    """The phase's sizes cut to `tiny`, and three tiny engines on one set
    of weights, each step slowed a little so a drain lands mid-stream."""
    from skypilot_tpu_torch import inference
    monkeypatch.setattr(chip_smoke, 'LB_HANDOFF', (40, 8))
    monkeypatch.setattr(chip_smoke, 'LB_DRAIN', (20, 24))
    monkeypatch.setattr(chip_smoke, 'LB_FAMILY', (32, 8, 4))
    monkeypatch.setattr(chip_smoke, 'LB_SHORT', (8, 2))
    monkeypatch.setattr(chip_smoke, 'LB_TTFT_RUNS', 2)
    monkeypatch.setattr(chip_smoke, 'LB_ENV', {
        **chip_smoke.LB_ENV, 'SKYTPU_LB_POOL_PROMPT_THRESHOLD': '40',
        'SKYTPU_LB_POOL_MAX_NEW_THRESHOLD': '8',
        'SKYTPU_LB_AFFINITY_PAGE_TOKENS': '8'})
    first = inference.build_engine('tiny', device='cpu', **TINY_KW)
    engines = [first] + [inference.InferenceEngine(
        first.params, first.config, device='cpu', **TINY_KW)
        for _ in range(2)]
    for engine in engines:
        step = engine.step

        def slow_step(step=step):
            time.sleep(0.01)
            step()
        engine.step = slow_step

    def run_phase(fault):
        return chip_smoke.lb_serve_phase(torch, inference, counted_kernels,
                                         engines, np.random.default_rng(17),
                                         fault=fault)
    return run_phase


def test_lb_serve_phase_and_its_faults_rehearse_on_cpu(tiny_fleet):
    lines, failed = lb_fault_check.check(tiny_fleet,
                                         list(chip_smoke.LB_FAULTS))
    assert not failed, lines
    sound = lines[0]
    assert sound['fault'] is None and not sound['broken']
    for line in lines[1:]:
        assert line['breaks_its_gate'], line


def test_lb_serve_readings_on_cpu(tiny_fleet):
    """The sound run's readings: the handoff's K1 launches on the
    prefill replica alone, the decode leg on the decode replica, each
    family on one replica, the breaker open after three failures, the
    federated series of every replica."""
    out = tiny_fleet(None)
    assert not out['faults'], out['faults']
    handoff = out['handoff']
    assert handoff['k1_by_replica'] == {
        'prefill': handoff['k1_expected'], 'decode': 0, 'general': 0}
    assert handoff['admissions_by_replica'] == {'prefill': 1, 'decode': 1,
                                                'general': 0}
    assert out['fallback']['counters']['HANDOFF_FALLBACKS'] == 1
    assert out['drain']['migrated_streams'] == 1
    for family in out['affinity']['families']:
        assert len(set(family['replicas'])) == 1
    assert out['affinity']['counters']['LB_AFFINITY_HITS'] >= 4
    assert out['dead_replica']['counters']['CIRCUIT_OPEN'] == 1
    assert all(n > 1 for n in out['surface']['federated_series'])
    assert set(out['surface']['autoscalers']) == {'prefill', 'decode',
                                                  'general'}
    assert out['kernel_launches'] >= handoff['k1_expected']
