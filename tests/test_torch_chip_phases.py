"""chip_smoke's openai, shedding, batch and roundtrip phases rehearsed on
the CPU at the tiny sizes, with a counting stand-in for each kernel
launch (K1/K2 through `_launch`, K3/K4 wrapped), so their control flow,
their checks and their launch accounting run here before the card: the
/v1 requests against /generate, the shed requests and REQUESTS_SHED, the
batch process's JSONL against run_batch in process, and the fine-tune,
resume, export, serve, torn-step, re-export and CLI steps of the round
trip.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture
def counted_kernels(monkeypatch):
    """Each K1/K2 call through `_launch` (serving and training alike) and
    each K3/K4 call counted as the wrappers count a launch, the plain
    version computing; CUDA-only calls made no-ops; one torch thread."""
    import inspect

    from skypilot_tpu_torch.inference import engine as eng
    from skypilot_tpu_torch.ops import flash_attention as fa

    def launch(q, k, v, causal, window, softcap, q_offset, k_scale=None,
               v_scale=None):
        counter = fa.flash_attention if k_scale is None else \
            fa.flash_attention_quant
        counter.launches += 1
        return fa._plain(q, k, v, causal, 512, window, softcap, q_offset,
                         k_scale=k_scale, v_scale=v_scale)

    def flash_fwd(q, k, v, causal=True, block_q=512, block_k=512,
                  window=None, softcap=None, q_offset=None, k_scale=None,
                  v_scale=None):
        return fa._launch(q, k, v, causal, window, softcap, q_offset,
                          k_scale=k_scale, v_scale=v_scale)

    def counting(fn):
        def wrapper(*args, **kwargs):
            window = inspect.signature(fn).bind(
                *args, **kwargs).arguments.get('window')
            fa._count(wrapper, window)
            return fn(*args, **kwargs)
        wrapper.launches, wrapper.window_launches = 0, {}
        return wrapper

    monkeypatch.setattr(fa, '_launch', launch)
    monkeypatch.setattr(fa, 'flash_fwd', flash_fwd)
    for name in ('flash_attention_dq', 'flash_attention_dkv'):
        monkeypatch.setattr(fa, name, counting(getattr(fa, name)))
    # The engines in this process serve through the (counted) flash path.
    monkeypatch.setattr(eng, 'default_use_flash', lambda device: True)
    for name in ('synchronize', 'empty_cache'):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(chip_smoke, 'DEV', 'cpu')
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield fa
    torch.set_num_threads(threads)


def test_openai_and_shedding_phases_rehearse_on_cpu(monkeypatch,
                                                    counted_kernels):
    from skypilot_tpu_torch import models as models_lib
    monkeypatch.setattr(chip_smoke, 'OPENAI_KW', dict(
        batch_size=4, max_seq_len=512, prefill_chunk=32, kv_page_size=8,
        prefill_interleave=0, prefix_cache=False, use_flash=True))
    monkeypatch.setattr(chip_smoke, 'OPENAI_PROMPT', 30)
    monkeypatch.setattr(chip_smoke, 'OPENAI_TEXT_WORDS', 12)
    monkeypatch.setattr(chip_smoke, 'OPENAI_NEW', 8)
    monkeypatch.setattr(chip_smoke, 'SHED_REQUESTS', 6)
    monkeypatch.setattr(chip_smoke, 'SHED_PROMPT', 8)
    monkeypatch.setattr(chip_smoke, 'SHED_NEW', 400)
    family, config = models_lib.resolve('tiny')
    params = family.init_params(config, torch.Generator().manual_seed(0),
                                'cpu')
    out, shed = chip_smoke.openai_phase(torch, counted_kernels, params,
                                        config, np.random.default_rng(8))
    assert all(v is not False for v in out['checks'].values())
    assert out['checks']['logprob_max_abs_diff'] == 0.0
    assert out['kernel_launches'] == out['expected_launches'] > 0
    assert out['metrics_deltas'] == out['metrics_want']
    assert shed['shed_delta'] == shed['shed_delta_final'] == 2
    assert shed['queue_depth_seen'] == 2 and shed['streams_ok']
    assert {v['status'] for v in shed['shed'].values()} == {503}


def test_batch_and_roundtrip_phases_rehearse_on_cpu(monkeypatch, tmp_path,
                                                    counted_kernels):
    """The checkpoint phase writes the HF directory both read (tiny-gemma
    through flash with remat, as gemma2-2b trains)."""
    from skypilot_tpu_torch import inference
    from skypilot_tpu_torch.models import gemma
    monkeypatch.setitem(gemma.CONFIGS, 'tiny-gemma', dataclasses.replace(
        gemma.CONFIGS['tiny-gemma'], attention_impl='flash', remat=True))
    monkeypatch.setattr(chip_smoke, 'CKPT_MODEL', 'tiny-gemma')
    monkeypatch.setattr(chip_smoke, 'CKPT_KW', dict(
        batch_size=2, max_seq_len=64, prefill_chunk=16, kv_page_size=8))
    monkeypatch.setattr(chip_smoke, 'CKPT_PROMPT', 20)
    monkeypatch.setattr(chip_smoke, 'CKPT_NEW', 6)
    monkeypatch.setattr(chip_smoke, 'BATCH_MODEL', 'tiny')
    monkeypatch.setattr(chip_smoke, 'BATCH_REQUESTS', 6)
    monkeypatch.setattr(chip_smoke, 'BATCH_PROMPT_LENGTHS', (5, 40))
    monkeypatch.setattr(chip_smoke, 'BATCH_NEW', 4)
    monkeypatch.setattr(chip_smoke, 'BATCH_FLAGS', (
        '--max-seq-len', '64', '--batch-size', '2', '--kv-page-size', '8'))
    monkeypatch.setattr(chip_smoke, 'RT_SEQ', 32)
    monkeypatch.setattr(chip_smoke, 'RT_LR', 1e-2)
    monkeypatch.setattr(chip_smoke, 'RT_BATCH_REQUESTS', 4)
    monkeypatch.setattr(chip_smoke, 'RT_BATCH_NEW', 4)
    rng = np.random.default_rng(8)
    hf_dir = str(tmp_path / 'hf')
    out = chip_smoke.checkpoint_phase(torch, inference, rng, keep=hf_dir)
    assert out['tokens_equal'] and os.path.isdir(hf_dir)
    fa = counted_kernels
    batch = chip_smoke.batch_phase(torch, inference, fa, rng, hf_dir,
                                   str(tmp_path))
    for name in ('bf16', 'int8', 'checkpoint'):
        run = batch[name]
        assert run['outputs_equal'] and run['kernel_launches'] == \
            run['expected_launches'] > 0
        assert len(run['admissions']) >= 2   # 6 requests, 2 slots
    assert batch['int8']['kernel'] == 'K2'
    rt = chip_smoke.roundtrip_phase(torch, inference, fa, rng, hf_dir,
                                    str(tmp_path))
    layers = chip_smoke.CKPT_LAYERS
    assert rt['fine_tune_launches'] == {'K1': 2 * layers * 4, 'K2': 0,
                                        'K3': layers * 4, 'K4': layers * 4}
    assert rt['resume_launches']['K3'] == layers * 2
    assert rt['resume_loss_abs_diff'] == [0.0, 0.0]
    assert rt['resume_param_max_abs_diff'] == 0.0 and rt['first_leg_equal']
    # The planted restore faults (optimizer state dropped, a stale step)
    # each break the resume limit.
    assert set(rt['planted_loss_abs_diff']) == {'moments_dropped',
                                                'stale_step'}
    assert min(rt['planted_loss_abs_diff'].values()) >= \
        chip_smoke.TOL_RESUME_LOSS
    assert rt['export_loads_equal'] and rt['serve']['tokens_equal']
    assert rt['batch']['outputs_equal']
    assert rt['torn'] == {'latest_step': 4, 'restored_step': 4}
    assert rt['reexport']['identical'] == rt['reexport']['files']
    assert rt['cli']['verify_clean']['rc'] == 0
    assert rt['cli']['verify_nan']['rc'] == 1
    assert rt['cli']['verify_truncated']['first_line'].startswith(
        'VERIFY FAILED (structural)')
