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
import json
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
                  else fa.flash_attention_quant, window, causal, q_offset)
        return fa._plain(q, k, v, causal, 512, window, softcap, q_offset,
                         k_scale=k_scale, v_scale=v_scale)

    def flash_fwd(q, k, v, causal=True, block_q=512, block_k=512,
                  window=None, softcap=None, q_offset=None, k_scale=None,
                  v_scale=None):
        return fa._launch(q, k, v, causal, window, softcap, q_offset,
                          k_scale=k_scale, v_scale=v_scale)

    def counting(fn):
        def wrapper(*args, **kwargs):
            bound = inspect.signature(fn).bind(*args, **kwargs)
            bound.apply_defaults()
            fa._count(wrapper, bound.arguments['window'],
                      bound.arguments['causal'])
            return fn(*args, **kwargs)
        wrapper.launches, wrapper.window_launches = 0, {}
        wrapper.causal_launches = {}
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
    CPU (`emulate_sync_debug_mode`)."""
    return emulate_sync_debug_mode(monkeypatch.setattr)


def emulate_sync_debug_mode(setattr_=setattr):
    """torch.cuda.set_sync_debug_mode on the CPU: in 'warn' mode a host
    read of a tensor (`item`, `tolist`, `bool`, `int`, `float`) warns
    'called a synchronizing CUDA operation', in 'error' mode it
    raises."""
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

    setattr_(torch.cuda, 'set_sync_debug_mode', set_mode)
    for name in ('item', 'tolist', '__bool__', '__int__', '__float__'):
        setattr_(torch.Tensor, name, checked(getattr(torch.Tensor, name)))
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


def stub_rank_kernels():
    """In a tp_serve rank process (chip_smoke.TP_RANK_SETUP): what
    `counted_kernels` does in this one, each K1/K2 launch counted with
    the plain version computing, CUDA-only calls no-ops, one thread."""
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

    fa._launch = launch
    fa.flash_fwd = flash_fwd
    eng.default_use_flash = lambda device: True
    for name in ('synchronize', 'empty_cache'):
        setattr(torch.cuda, name, lambda *a: None)
    emulate_sync_debug_mode()
    torch.set_num_threads(1)


def _rehearse_tp_serve(monkeypatch):
    """chip_smoke's tp_serve constants at the tiny sizes (f32): tiny at
    tensor 2, tiny-moe (2 layers) at expert 2."""
    monkeypatch.setattr(chip_smoke, 'TP_MODEL', 'tiny')
    monkeypatch.setattr(chip_smoke, 'TP_KW', dict(
        batch_size=8, max_seq_len=128, prefill_chunk=16, kv_page_size=8))
    monkeypatch.setattr(chip_smoke, 'TP_PROMPT_LENGTHS', (5, 60))
    # Past the migration leg's two dispatches of 8 steps.
    monkeypatch.setattr(chip_smoke, 'TP_NEW', 20)
    monkeypatch.setattr(chip_smoke, 'TP_SERVER_REQUESTS', (
        (20, 4, False), (40, 5, False), (30, 6, True)))
    monkeypatch.setattr(chip_smoke, 'TP_DRAIN_REQUEST', (20, 100))
    monkeypatch.setattr(chip_smoke, 'TP_CLOCK_PROBE', (10, 2, 32))
    monkeypatch.setattr(chip_smoke, 'MOE_MODEL', 'tiny-moe')
    monkeypatch.setattr(chip_smoke, 'MOE_MESH_LAYERS', 2)
    monkeypatch.setattr(chip_smoke, 'MOE_KW', dict(
        batch_size=8, max_seq_len=128, prefill_chunk=16, kv_page_size=8,
        prefix_cache=False))
    monkeypatch.setattr(chip_smoke, 'MOE_PROMPT_LENGTHS', (5, 60))
    monkeypatch.setattr(chip_smoke, 'MOE_LONG', 100)
    monkeypatch.setattr(chip_smoke, 'MOE_NEW', 6)
    monkeypatch.setattr(chip_smoke, 'TP_RANK_SETUP', (
        'test_torch_chip_phases:stub_rank_kernels',
        os.path.dirname(os.path.abspath(__file__))))
    # The context leg: 40 positions, spans [0, 20) and [20, 40), chunks of
    # 8, so the chunk [16, 24) straddles the boundary; the fsdp and
    # context legs run in the second gang here (one gang fewer to start).
    monkeypatch.setattr(chip_smoke, 'FSDP_PROMPT_LENGTHS', (5, 60))
    monkeypatch.setattr(chip_smoke, 'CTX_LAYERS', 2)
    monkeypatch.setattr(chip_smoke, 'CTX_KW', dict(
        batch_size=2, max_seq_len=40, prefill_chunk=8, kv_page_size=0))
    monkeypatch.setattr(chip_smoke, 'CTX_PROMPT', 30)
    monkeypatch.setattr(chip_smoke, 'CTX_NEW', 4)
    monkeypatch.setattr(chip_smoke, 'TP_GANGS', (
        ('spec', 'migration', 'moe'),
        ('bf16', 'server', 'int8', 'fsdp', 'context')))


def test_tp_serve_phase_rehearses_on_cpu(monkeypatch, counted_kernels):
    """tp_serve on tiny (f32) at tensor 2: two rank processes over gloo
    against the unsharded engine here (logits, tokens, launches on each
    rank), the NCCL refusal, the target as its own draft, snapshot /
    restore / handoff with the restored pages byte-equal on each rank,
    tiny-moe over expert 2 against its unsharded engine, then the server
    as two processes token for token, drained into an unsharded engine,
    and its follower's exit after SIGTERM to rank 0; tiny over fsdp 2
    (half the weights a rank, the bf16 reference's first tokens) and
    over context 2 (half the cache a rank, rank 1's first chunk at an
    offset before its span), bf16 and int8."""
    _rehearse_tp_serve(monkeypatch)
    out, launches = chip_smoke.tp_serve_phase(
        torch, inference_module(), counted_kernels,
        np.random.default_rng(10))
    assert out['faults'] == []
    fsdp = out['fsdp']
    assert fsdp['launches_per_rank'] == [fsdp['expected_launches']] * 2
    assert fsdp['tokens_equal_unsharded'] == chip_smoke.FSDP_PROMPTS
    assert fsdp['ranks_tokens_equal']
    assert fsdp['logits_rel_err'] < 1e-5
    assert [2 * b for b in fsdp['weight_bytes_per_rank']] == \
        [fsdp['unsharded_weight_bytes']] * 2
    assert launches['fsdp'] == fsdp['launches_per_rank']
    ctx = out['context']
    assert ctx['span_rel_err'] < 1e-6
    for key in ('bf16', 'int8'):
        run = ctx[key]
        # 2 layers x 4 chunks of 8 over the 32-token bucket, per rank.
        assert run['launches_per_rank'] == [run['expected_launches']] * 2 \
            == [8, 8]
        assert run['offset_launches_per_rank'][1] == {
            '-20': 2, '-12': 2, '-4': 2, '4': 2}
        assert run['tokens_equal_unsharded'] and run['ranks_tokens_equal']
        assert run['logits_rel_err'] < 1e-5
        assert run['cache_positions_per_rank'] == [20, 20]
        assert [2 * b for b in run['cache_bytes_per_rank']] == \
            [run['unsharded_cache_bytes']] * 2
        assert launches[f'context_{key}'] == run['launches_per_rank']
    spec = out['spec']
    assert spec['launches_per_rank'] == [spec['expected_launches']] * 2
    # Every drafted token is accepted but those past a request's budget.
    assert spec['acceptance'] >= chip_smoke.TOL_SPEC_ACCEPT
    assert spec['ranks_tokens_equal']
    assert spec['tokens_equal_bf16'] == 8
    assert spec['draft_local_heads'] == [2, 2]
    mig = out['migration']
    assert mig['tokens_equal_bf16_per_rank'] == [8, 8]
    assert mig['restored_bytes_equal_per_rank'] == [[True] * 3] * 2
    assert mig['blob_kv_heads'] == [[2]] * 3 and mig['handoff_paused']
    assert mig['launches_per_rank'] == [mig['expected_launches']] * 2
    moe = out['moe']
    assert moe['local_experts'] == [2, 2] and moe['ranks_tokens_equal']
    assert moe['tokens_equal_unsharded'] == 8
    assert moe['logits_rel_err'] < 1e-5
    assert moe['launches_per_rank'] == [moe['expected_launches']] * 2
    assert [s['moe_layers_run'] for s in moe['decode_syncs']] == \
        [chip_smoke.MOE_DECODE_STEPS * 2] * 2
    assert launches['moe'] == moe['launches_per_rank']
    drain = out['server']['drain']
    assert drain['equal_sharded'] and drain['new_request_status'] == 503
    assert 0 < drain['sent'] == len(drain['streamed']) < 100
    for key in ('bf16', 'int8'):
        run = out[key]
        assert run['launches_per_rank'] == [run['expected_launches']] * 2
        assert launches[key] == run['launches_per_rank']
        assert run['expected_launches'] > 0 and run['ranks_tokens_equal']
        assert run['tokens_equal_unsharded']
        assert run['logits_rel_err'] < 1e-5
    assert [r['local_heads'] for r in out['per_rank']] == [2, 2]
    assert [r['local_vocab'] for r in out['per_rank']] == [128, 128]
    server = out['server']
    assert server['tokens_equal'] and server['v1_equal']
    assert server['exit_codes'] == [0, 0]
    assert server['follower_exit_s'] < chip_smoke.TP_FOLLOWER_EXIT_S
    assert out['nccl_refusal']['rcs'][0] not in (0, None)
    layers = 2
    for key in ('bf16', 'int8'):
        clock = out[key]['collectives']
        # The embedding and two reductions a layer, and the logits'
        # gather, per prefill chunk (4 at the 60-token bucket) and per
        # decode step (19 after the first token).
        assert clock['prefill_calls'] == 4 * (2 * layers + 1) + 1
        assert clock['decode_calls'] == 19 * (2 * layers + 2)
        assert 0 < clock['share_of_prefill'] < 1
        assert 0 < clock['share_of_decode'] < 1
        # One plan hash a message on each rank: rank 0's publishes, the
        # follower's receipts.
        lead, follow = out[key]['scheduler']['per_rank']
        assert lead['plan_calls'] == lead['publish_calls'] == \
            follow['plan_calls'] > 0 and follow['publish_calls'] == 0
        assert 0 < out[key]['scheduler']['share_of_wall'] < 1
    over = out['clock_overhead']
    assert over['plain_ms'] > 0 and over['synced_ms'] > 0
    assert over['added_ms'] == pytest.approx(over['synced_ms']
                                             - over['plain_ms'])
    assert {'share_of_bf16_wall', 'share_of_int8_wall'} <= set(over)


@pytest.mark.parametrize('fault', sorted(chip_smoke.TP_FAULT_LEGS))
def test_tp_serve_faults_break_a_gate_on_cpu(monkeypatch, counted_kernels,
                                             fault):
    """mesh_fault_check.py's serving faults, each on the legs it touches:
    every one breaks a tp_serve gate (the sound legs pass in the test
    above), its named gate where it has one, and a fault that leaves the
    outputs as they were (`TP_FAULTS_ALONE`) that gate only."""
    _rehearse_tp_serve(monkeypatch)
    out, _ = chip_smoke.tp_serve_phase(
        torch, inference_module(), counted_kernels,
        np.random.default_rng(10), legs=chip_smoke.TP_FAULT_LEGS[fault],
        fault=fault)
    assert out['faults'], fault
    gate = chip_smoke.TP_FAULT_GATES.get(fault)
    if gate is not None:
        assert any(f.startswith(gate) for f in out['faults']), out['faults']
    if fault in chip_smoke.TP_FAULTS_ALONE:
        assert all(f.startswith(gate) for f in out['faults']), out['faults']


@pytest.mark.parametrize('tail, caught', [
    ("RuntimeError: rank 1's host plan (7) left rank 0's (9): the "
     'replicas diverged', True),
    ('torch.OutOfMemoryError: CUDA out of memory', False)])
def test_mesh_fault_check_counts_failed_ranks_only_by_their_divergence(
        monkeypatch, capsys, tail, caught):
    """mesh_fault_check.py's serving check: a fault whose ranks fail is
    caught only where a follower raised on the ranks' divergence (the
    text `InferenceEngine.follow` raises), and a sound run whose ranks
    fail is not sound."""
    import inspect

    import mesh_fault_check
    from skypilot_tpu_torch.inference import engine as port_engine
    assert mesh_fault_check.DIVERGED in inspect.getsource(
        port_engine.InferenceEngine.follow)

    def ranks_fail(*args, **kwargs):
        raise AssertionError(f'tp ranks failed: rcs [1, 1]: [{tail!r}]')

    monkeypatch.setattr(chip_smoke, 'tp_serve_phase', ranks_fail)
    assert not mesh_fault_check.check_serving(
        torch, chip_smoke, ['serve_expert_not_reduced'])
    sound, fault = [json.loads(line)
                    for line in capsys.readouterr().out.splitlines()]
    assert sound['sound'] is False and fault['caught'] is caught
    assert bool(fault['broken']) is caught and tail[-20:] in fault['raised']


def stub_mesh_rank_kernels():
    """In a mesh_train rank process (chip_smoke.MT_RANK_SETUP): the
    tp_serve stand-in for K1, K3/K4 counted as `counted_kernels` counts
    them, and ring attention on the CUDA path's hops
    (`ring_flash_attention`, its K1/K3/K4 through the counting
    stand-ins) where the CPU would run the plain ring."""
    from skypilot_tpu_torch.ops import attention
    from skypilot_tpu_torch.ops import flash_attention as fa
    stub_rank_kernels()

    def counting(fn):
        def wrapper(*args, **kwargs):
            fa._count(wrapper, kwargs.get('window'),
                      kwargs.get('causal', True))
            return fn(*args, **kwargs)
        wrapper.launches, wrapper.window_launches = 0, {}
        wrapper.causal_launches = {}
        return wrapper

    for name in ('flash_attention_dq', 'flash_attention_dkv'):
        setattr(fa, name, counting(getattr(fa, name)))

    def ring(q, k, v, mesh, axis='context', causal=True, block_size=512):
        return fa.ring_flash_attention(q, k, v, mesh.group(axis),
                                       causal=causal, block_q=block_size,
                                       block_k=block_size)
    attention.ring_attention = ring


def _rehearse_mesh_train(monkeypatch):
    """chip_smoke's mesh_train constants at the tiny sizes (f32, 2
    layers, global batch 2 x 32, flash on the fsdp and tensor legs; the
    expert leg on tiny-moe, 2 layers, 1 x 32)."""
    monkeypatch.setattr(chip_smoke, 'MT_MODEL', 'tiny')
    monkeypatch.setattr(chip_smoke, 'MT_SEQ', 32)
    monkeypatch.setattr(chip_smoke, 'MT_LEGS', (
        ('fsdp', 'fsdp=-1', 'flash', ((1, 0), (1, 0))),
        ('tensor', 'tensor=2', 'flash', ((1, 0), (1, 0))),
        ('ring', 'context=2', 'ring', ((1, 0), (1, 1)))))
    monkeypatch.setattr(chip_smoke, 'MT_EXPERT_MODEL', 'tiny-moe')
    monkeypatch.setattr(chip_smoke, 'MT_RANK_SETUP', (
        'test_torch_chip_phases:stub_mesh_rank_kernels',
        os.path.dirname(os.path.abspath(__file__))))


def test_mesh_train_phase_rehearses_on_cpu(monkeypatch, counted_kernels):
    """mesh_train on tiny (f32): two rank processes over gloo through
    train.loop.main per leg (fsdp from the seed weights as an HF
    --checkpoint, saving; tensor and its resume of the fsdp checkpoint;
    ring), against the unsharded steps here: no limit
    broken, each rank's launches by causal flag those
    `mt_expected_launches` writes from the code, the checkpoint's save
    and restore read."""
    _rehearse_mesh_train(monkeypatch)
    out = chip_smoke.mesh_train_phase(torch)
    assert out['faults'] == []
    want = chip_smoke.mt_expected_launches(chip_smoke.MT_LEGS, 2, 2, False)

    def split(causal, full, k2=(0, 0)):
        return {k: {'causal': c, 'full': f} for k, (c, f) in (
            ('K1', (causal, full)), ('K2', k2), ('K3', (causal, full)),
            ('K4', (causal, full)))}
    assert want['ring'] == [split(4, 0), split(4, 4)]
    assert want['resume'] == [split(2, 0)] * 2
    assert [chip_smoke.mt_total(n) for n in want['ring']] == [
        {'K1': 4, 'K2': 0, 'K3': 4, 'K4': 4},
        {'K1': 8, 'K2': 0, 'K3': 8, 'K4': 8}]
    legs = out['legs']
    for leg in ('fsdp', 'tensor', 'ring'):
        assert legs[leg]['launches_per_rank'] == want[leg]
        assert legs[leg]['world'] == 2 and legs[leg]['replicated_equal']
        assert 0 < legs[leg]['collectives_share'] < 1
        assert len(legs[leg]['losses']) == chip_smoke.MT_STEPS
    assert legs['tensor']['local_heads'] == 2
    assert legs['ring']['replicated_leaves'] == 12
    assert legs['fsdp']['replicated_leaves'] == 0
    assert legs['fsdp']['save_gb_per_s'] > 0
    assert '--checkpoint' in legs['fsdp']['argv']
    assert legs['tensor']['resume']['launches_per_rank'] == want['resume']
    assert legs['tensor']['resume']['restore_gb_per_s'] > 0
    assert legs['tensor']['resume']['save_gb_per_s'] > 0
    # The pipe leg: one layer a stage, 2 microbatches, K1 in the forward
    # and the recompute, no bubble work; the expert leg: tiny-moe has no
    # remat, so K1 once a layer and step.
    extra = out['extra_legs']
    want_extra = chip_smoke.mt_extra_launches(('pipe', 'expert'), 2, 2, 2,
                                              2, 2, False)
    assert [chip_smoke.mt_total(n) for n in want_extra['pipe']] == [
        {'K1': 4, 'K2': 0, 'K3': 2, 'K4': 2}] * 2
    assert want_extra['expert'] == [split(4, 0)] * 2
    pipe = extra['pipe']
    assert pipe['launches_per_rank'] == want_extra['pipe']
    assert pipe['local_layers'] == [1, 1] and pipe['replicated_leaves'] == 3
    assert pipe['replicated_equal'] and pipe['logits_equal']
    assert pipe['missing_leaves'] == [] and 0 < pipe['collectives_share'] < 1
    assert pipe['staged_bytes']['pipe'] == 0      # gloo takes CPU tensors
    expert = extra['expert']
    assert expert['launches_per_rank'] == want_extra['expert']
    assert expert['local_experts'] == 2 and expert['world'] == 2
    assert expert['ranks_agree'] and expert['replicated_equal']
    assert len(expert['losses']) == chip_smoke.MT_STEPS
    assert out['unsharded']['moe']['steps'] and 'pipe_loss' in out[
        'unsharded']
    # The set-up's clock: the fsdp leg imports the seed checkpoint, which
    # the ranks wait for after their start.
    assert set(legs['fsdp']['setup_s']) == {'mesh', 'train_state',
                                            'checkpoint_import'}
    starts = out['rank_start']
    assert all(0 < a <= b <= c for a, b, c in zip(
        starts['import_s'], starts['start_s'], starts['ready_s']))


@pytest.mark.parametrize('fault', ['batch_reduce', 'column_allreduce',
                                   'boundary_masked', 'local_lse',
                                   'stages_swapped', 'microbatch_off_by_one',
                                   'embed_stage0_only', 'head_summed_twice',
                                   'expert_not_reduced', 'topk_local'])
def test_mesh_train_faults_break_a_limit_on_cpu(monkeypatch, counted_kernels,
                                                fault):
    """mesh_fault_check.py's faults planted in the tiny rehearsal's
    ranks, each on the legs it touches: each breaks a limit."""
    import mesh_fault_check
    _rehearse_mesh_train(monkeypatch)
    legs = {leg[0]: leg for leg in chip_smoke.MT_LEGS}
    names = mesh_fault_check.FAULT_LEGS[fault]
    out = chip_smoke.mesh_train_phase(
        torch, legs=tuple(legs[n] for n in names if n in legs), fault=fault,
        extra=tuple(n for n in names if n in chip_smoke.MT_EXTRA_LEGS))
    # A numeric limit breaks: not only the launch count or the ranks'
    # agreement.
    assert any('loss' in f or 'grad norm' in f or 'logits' in f
               for f in out['faults']), (fault, out['faults'])
