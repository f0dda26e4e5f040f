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
        fa._count(fa.flash_attention if k_scale is None
                  else fa.flash_attention_quant, window)
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


@pytest.fixture
def host_syncs(monkeypatch):
    """torch.cuda.set_sync_debug_mode as the card applies it, on the
    CPU: in 'warn' mode a host read of a tensor (`item`, `tolist`,
    `bool`, `int`, `float`) warns 'called a synchronizing CUDA
    operation', in 'error' mode it raises."""
    import warnings
    mode = {'now': 0}

    def set_mode(m):
        mode['now'] = m

    def checked(fn):
        def wrapper(self, *args, **kwargs):
            if mode['now'] == 'error':
                raise RuntimeError('called a synchronizing CUDA operation')
            if mode['now'] == 'warn':
                warnings.warn('called a synchronizing CUDA operation')
            return fn(self, *args, **kwargs)
        return wrapper

    monkeypatch.setattr(torch.cuda, 'set_sync_debug_mode', set_mode)
    for name in ('item', 'tolist', '__bool__', '__int__', '__float__'):
        monkeypatch.setattr(torch.Tensor, name,
                            checked(getattr(torch.Tensor, name)))
    return mode


def test_moe_phases_rehearse_on_cpu(monkeypatch, counted_kernels,
                                    host_syncs):
    """moe_serve (bf16, as on the card) and moe_train (f32) on tiny-moe
    with remat: launches held to the admissions' and the layers' counts, the
    expert MLP against its one-hot form with its planted faults caught,
    tokens equal across two runs, the fused decode dispatch's MoE layers
    free of host reads and one read a step around them."""
    from skypilot_tpu_torch.inference import engine as eng
    from skypilot_tpu_torch.models import moe
    monkeypatch.setitem(moe.CONFIGS, 'tiny-moe', dataclasses.replace(
        moe.CONFIGS['tiny-moe'], dtype=torch.bfloat16, remat=True))
    monkeypatch.setattr(chip_smoke, 'MOE_MODEL', 'tiny-moe')
    monkeypatch.setattr(chip_smoke, 'MOE_SERVE_LAYERS', 2)
    monkeypatch.setattr(chip_smoke, 'MOE_KW', dict(
        batch_size=4, max_seq_len=128, prefill_chunk=32, kv_page_size=8,
        prefix_cache=False))
    monkeypatch.setattr(chip_smoke, 'MOE_PROMPT_LENGTHS', (5, 60))
    monkeypatch.setattr(chip_smoke, 'MOE_LONG', 100)
    monkeypatch.setattr(chip_smoke, 'MOE_NEW', 6)
    monkeypatch.setattr(chip_smoke, 'MOE_TRAIN_SEQ', 64)
    monkeypatch.setattr(chip_smoke, 'MOE_TRAIN_STEPS', 4)
    monkeypatch.setattr(chip_smoke, 'TRAIN_LR', 1e-2)
    monkeypatch.setattr(chip_smoke, 'TRAIN_WARMUP', 1)
    # The card-only readings: device time, profiles, throughput at 2048
    # positions and peak memory.
    monkeypatch.setattr(chip_smoke, 'time_ms', lambda torch, fn, **kw: 0.0)
    monkeypatch.setattr(chip_smoke, 'profile_breakdown',
                        lambda torch, fn, **kw: {})
    monkeypatch.setattr(chip_smoke, 'throughput', lambda *a, **kw: {})
    monkeypatch.setattr(torch.cuda, 'reset_peak_memory_stats',
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, 'max_memory_allocated', lambda *a: 0)
    fa = counted_kernels
    out, launches = chip_smoke.moe_serve_phase(torch, inference_module(),
                                               eng, fa,
                                               np.random.default_rng(9))
    bf16, int8 = out['bf16'], out['int8']
    assert bf16['capacity_factor'] == 2.0
    for run, key in ((bf16, 'bf16'), (int8, 'int8')):
        path = run['main_path']
        assert path['kernel_launches'] == path['expected_launches'] == \
            launches[key] > 0
        assert len(path['admissions']) >= 2      # 9 requests, 4 slots
    assert bf16['greedy_tokens_equal_across_runs']
    mlp = bf16['moe_mlp']
    assert mlp['rel_err'] < chip_smoke.TOL_MOE_REL
    assert min(mlp['faults'][key] for key in (
        'second_slot_dropped', 'swapped_experts')) >= chip_smoke.TOL_MOE_REL
    assert sum(mlp['rows_per_expert']) == 2 * mlp['tokens']
    syncs = bf16['decode_syncs']
    assert syncs['syncs_in_dispatch'] == syncs['steps']
    assert syncs['moe_layers_run'] == syncs['steps'] * 2
    # The grouped path reads its counts to the host: forced into the
    # decode dispatch, it raises there.
    monkeypatch.setattr(moe, 'STATIC_ROWS', 0)
    with pytest.raises((AssertionError, RuntimeError)):
        chip_smoke.moe_serve_phase(torch, inference_module(), eng, fa,
                                   np.random.default_rng(9))
    monkeypatch.setattr(moe, 'STATIC_ROWS', 2048)

    # Training in f32: at tiny-moe's width a bf16 rounding step moves
    # router logits across near-ties, so flash and dense would route
    # some tokens to other experts (the card reads the full width).
    monkeypatch.setitem(moe.CONFIGS, 'tiny-moe', dataclasses.replace(
        moe.CONFIGS['tiny-moe'], dtype=torch.float32))
    parity, train = chip_smoke.moe_train_phase(torch, fa)
    assert not chip_smoke.train_faults(parity)
    assert parity['routing_flips'] == 0          # f32: no near-tie moves
    layers, steps = chip_smoke.MOE_TRAIN_LAYERS, 4
    assert train['launches'] == {'K1': 2 * layers * steps, 'K2': 0,
                                 'K3': layers * steps, 'K4': layers * steps}
    assert train['attention_impl'] == 'flash' and train['aux_loss'] > 0


def inference_module():
    from skypilot_tpu_torch import inference
    return inference
