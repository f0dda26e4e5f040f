"""The limits chip_smoke.py holds the kernels (K1-K4) and the training
parity to, and the planted faults of kernel_fault_check.py that show
those limits catch a wrong kernel.

The readings themselves come from the card; here the verdict functions
are held to their limits and every planted fault is held to apply
exactly once to the kernel source.
"""
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import kernel_fault_check  # noqa: E402

SOUND = {'max_abs_err': 0.0078125, 'lse_max_abs_err': 2e-6,
         'inf_rows_agree': True, 'masked_rows': 2624,
         'masked_rows_max_abs_o': 0.0}


def test_sound_kernel_reading_passes():
    assert chip_smoke.kernel_faults(SOUND) == []


@pytest.mark.parametrize('key,value,needle', [
    ('max_abs_err', chip_smoke.TOL_O, 'max|dO|'),
    ('max_abs_err', float('nan'), 'max|dO|'),
    ('lse_max_abs_err', chip_smoke.TOL_LSE, 'max|dlse|'),
    ('lse_max_abs_err', 0.03, 'max|dlse|'),
    ('inf_rows_agree', False, '+inf rows'),
    ('masked_rows_max_abs_o', 1e-3, 'O = 0'),
])
def test_kernel_reading_over_a_limit_fails(key, value, needle):
    faults = chip_smoke.kernel_faults({**SOUND, key: value})
    assert len(faults) == 1 and needle in faults[0]


def test_kernel_limits_sit_between_sound_and_faulty_readings():
    """On the H100 a sound kernel reads max |dO| 0.0078 (one bf16 step at
    |O| in [1, 2), the training shape; 0.0039 at the serving shapes) and
    max |dlse| 1.9e-6; the mildest planted fault (drop_diagonal) reads
    0.058 and 0.021. Both limits stay inside that gap."""
    assert SOUND['max_abs_err'] < chip_smoke.TOL_O <= 0.058 / 5
    assert SOUND['lse_max_abs_err'] < chip_smoke.TOL_LSE <= 0.021 / 20


def test_logits_limits():
    sound = {'prefill_logits_finite': True,
             'prefill_logits_rel_err_vs_plain': 0.0176,
             'prefill_logits_rel_err_vs_dense_forward': 0.0157}
    assert chip_smoke.logits_faults(sound) == []
    int8 = {k: v for k, v in sound.items() if 'dense' not in k}
    assert chip_smoke.logits_faults(int8) == []
    bad = {**sound, 'prefill_logits_rel_err_vs_dense_forward':
           chip_smoke.TOL_LOGITS_REL}
    assert len(chip_smoke.logits_faults(bad)) == 1
    assert chip_smoke.logits_faults(
        {**sound, 'prefill_logits_finite': False}) == ['non-finite logits']


# A sound K3/K4 reading at the training shape on the H100 (chip_smoke's
# check_bwd): max|a-b| / max|b| of dQ, dK, dV against the plain version,
# and K1's (O, lse) at the same shape against its plain version.
SOUND_BWD = {'finite': True, 'dq_rel_err': 0.00084, 'dk_rel_err': 0.0029,
             'dv_rel_err': 0.0030, 'dq_max_abs_err': 0.0039,
             'dk_max_abs_err': 0.0156, 'dv_max_abs_err': 0.0313,
             'masked_rows': 0, 'masked_rows_max_abs_dq': 0.0,
             'fwd': {**SOUND, 'masked_rows': 0}}


def test_sound_backward_reading_passes():
    assert chip_smoke.bwd_faults(SOUND_BWD) == []


@pytest.mark.parametrize('key,value,needle', [
    ('dq_rel_err', chip_smoke.TOL_BWD_REL, 'dq'),
    ('dk_rel_err', float('nan'), 'dk'),
    ('dv_rel_err', 0.3, 'dv'),
    ('finite', False, 'non-finite'),
    ('masked_rows_max_abs_dq', 1e-3, 'dQ = 0'),
])
def test_backward_reading_over_a_limit_fails(key, value, needle):
    faults = chip_smoke.bwd_faults({**SOUND_BWD, key: value})
    assert len(faults) == 1 and needle in faults[0]


@pytest.mark.parametrize('key,value,needle', [
    ('max_abs_err', chip_smoke.TOL_O, 'max|dO|'),
    ('lse_max_abs_err', chip_smoke.TOL_LSE, 'max|dlse|'),
])
def test_backward_reading_holds_k1_at_the_training_shape(key, value, needle):
    """check_bwd also holds K1's (O, lse), which both backwards take,
    to TOL_O / TOL_LSE at every backward case."""
    faults = chip_smoke.bwd_faults(
        {**SOUND_BWD, 'fwd': {**SOUND_BWD['fwd'], key: value}})
    assert len(faults) == 1 and faults[0].startswith('K1 ')
    assert needle in faults[0]


def test_train_parity_limits():
    """The sound readings at bench-8b widths on the H100 (2 layers,
    S2048): loss 10.8878 vs 10.8875, grad norm 7.44114 vs 7.44135, wq /
    wk / wv grads 0.0136 / 0.0136 / 0.0131 apart relative to their
    largest. The planted K3/K4 faults read grad-norm differences of
    0.0050-0.0076 (dq_drop_kv_tile), 0.0081 (dkv_drop_delta), 0.059
    (dkv_drop_q_head) and far more (bwd_stale_stage,
    dq_frontier_tile_unmasked), and 0.31 (wq; K3 fault) and 0.20-0.67
    (wk, wv; K4 faults) on the grads of the projection each breaks."""
    sound = {'flash_loss': 10.88781, 'dense_loss': 10.88749,
             'flash_grad_norm': 7.44114, 'dense_grad_norm': 7.44135,
             'loss_abs_diff': 3.1e-4, 'grad_norm_rel_diff': 2.8e-5,
             'wq_grad_rel_err': 0.0136, 'wk_grad_rel_err': 0.0136,
             'wv_grad_rel_err': 0.0131}
    assert chip_smoke.train_faults(sound) == []
    assert sound['loss_abs_diff'] * 10 < chip_smoke.TOL_TRAIN_LOSS
    assert (sound['grad_norm_rel_diff'] * 10 < chip_smoke.TOL_TRAIN_GRAD_REL
            < 0.0050 / 3)
    for name in chip_smoke.PARITY_PROJ:
        assert (sound[f'{name}_grad_rel_err'] * 3
                < chip_smoke.TOL_TRAIN_PROJ_REL < 0.20 / 3)
    for key, value in (('loss_abs_diff', chip_smoke.TOL_TRAIN_LOSS),
                       ('grad_norm_rel_diff', chip_smoke.TOL_TRAIN_GRAD_REL),
                       ('wq_grad_rel_err', chip_smoke.TOL_TRAIN_PROJ_REL),
                       ('wk_grad_rel_err', 0.51),
                       ('wv_grad_rel_err', 0.20),
                       ('flash_loss', float('nan'))):
        assert len(chip_smoke.train_faults({**sound, key: value})) == 1


def test_backward_limit_sits_between_sound_and_faulty_readings():
    """Both outputs are bf16, so a sound reading is whole bf16 steps of
    some element over max|b|: one step at the largest element reads
    2^-8 to 2^-7, by where max|b| falls in its binade. On the H100
    (bwd_accuracy.py, seeds 3-5, every BWD_CASES case) the sound K3/K4
    readings peak at 0.0061, one step at the non-causal ragged case's
    largest dK (seed 3), and the earlier mma.sync kernels read the same
    0.0061 on the same inputs. The limit admits two steps at the largest
    element wherever it falls in its binade and sits 3.3x over the sound
    peak; the mildest planted fault (dkv_drop_delta, q_offset case)
    reads 0.073-0.082, 3.6x over it."""
    assert 2 * 2 ** -7 < chip_smoke.TOL_BWD_REL < 0.073 / 3
    assert 0.0061 * 3 < chip_smoke.TOL_BWD_REL


def test_bwd_bounds_count_the_training_shape():
    """bench-8b attention at S4096: 6*d and 8*d FLOP a visible pair over
    S(S+1)/2 pairs a head; both bound by the tensor cores."""
    bounds = chip_smoke.bwd_bounds(1, 4096, 4096, 32, 8, 128, None, None)
    pairs = 4096 * 4097 // 2
    assert bounds['dq'][2] == 6 * 128 * pairs * 32
    assert bounds['dkv'][2] == 8 * 128 * pairs * 32
    assert bounds['dq'][1] == bounds['dkv'][1] == 'operations'
    assert bounds['dq'][0] == pytest.approx(
        bounds['dq'][2] / chip_smoke.H100_BF16_FLOPS * 1e3)


def test_fwd_bound_counts_the_training_shape():
    """K1 at the train phase's attention (bench-8b heads, S4096, causal):
    4*d FLOP a visible pair over S(S+1)/2 pairs a head, bound by the
    tensor cores at about 0.139 ms."""
    b, t, s, h, kv, d, off = chip_smoke.TRAIN_TIMING_SHAPE
    assert (b, t, s, h, kv, d, off) == (1, 4096, 4096, 32, 8, 128, 0)
    ms, bound_by, flops = chip_smoke.bound_ms(b, t, s, h, kv, d, off, None,
                                              False)
    assert flops == 4 * 128 * (4096 * 4097 // 2) * 32
    assert bound_by == 'operations'
    assert ms == pytest.approx(flops / chip_smoke.H100_BF16_FLOPS * 1e3)
    assert ms == pytest.approx(0.139, abs=5e-4)


def test_bwd_cases_keep_training_first_and_add_masked_and_ragged():
    """The training shape stays first (it is BWD_TIMING_CASE); rows with
    no visible key and ragged tiles of both backward kernels follow."""
    names = [case[0] for case in chip_smoke.BWD_CASES]
    assert names[:3] == ['training', 'masked_rows', 'ragged_tiles']
    assert chip_smoke.BWD_TIMING_CASE[0] == 'training'
    cases = {name: rest for name, *rest in chip_smoke.BWD_CASES}
    b, sq, skv, h, kv, d, causal, off, window, softcap = cases['masked_rows']
    assert causal and off + sq - 1 - window + 1 >= skv  # last rows see none
    b, sq, skv, h, kv, d, causal, off, window, softcap = cases[
        'ragged_tiles']
    assert sq % 64 and skv % 64 and h != kv


def test_ptxas_entries_read_registers_spills_and_serialisation():
    log = (
        "ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async"
        " instructions are serialized due to insufficient register resources"
        " for the function '_Z20flash_bwd_dkv_kernelILi128ELb0EEvv'\n"
        "ptxas info    : Compiling entry function "
        "'_Z19flash_bwd_dq_kernelILi128ELb0EEvv' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function "
        "'_Z20flash_bwd_dkv_kernelILi128ELb0EEvv' for 'sm_90a'\n"
        "    200 bytes stack frame, 376 bytes spill stores, 216 bytes spill "
        "loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function "
        "'_Z16flash_fwd_kernelILi64ELb0ELb0EEvv' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n")
    dq, dkv = chip_smoke.ptxas_entries(log, 'flash_bwd_')
    assert (dq['registers'], dq['spill_stores'], dq['spill_loads'],
            dq['serialized']) == (168, 0, 0, False)
    assert (dkv['spill_stores'], dkv['spill_loads'], dkv['serialized']) == (
        376, 216, True)
    assert len(chip_smoke.ptxas_entries(log, 'flash_')) == 3


def test_step_reading_counts_bf16_steps():
    """bwd_accuracy.py reads a miss in bf16 steps at max|b|: 1.0 against
    1.0078125 is half a step at max|b| = 3 (a step there is 2^-6), and
    reads 2^-7 / 3; one whole step at 3 would read 2^-6 / 3."""
    import bwd_accuracy
    a = torch.tensor([0.6, 1.0, -3.0]).bfloat16()
    b = torch.tensor([0.6, 1.0078125, -3.0]).bfloat16()
    r = bwd_accuracy.step_reading(a, b)
    assert (r['steps_at_max'], r['n_diff']) == (0.5, 1)
    assert r['rel_err'] == pytest.approx(2 ** -7 / 3)
    assert r['one_step_at_max'] == pytest.approx(2 ** -6 / 3)
    same = bwd_accuracy.step_reading(b, b)
    assert (same['rel_err'], same['steps_at_max'], same['n_diff']) == (
        0, 0, 0)


def test_check_cases_include_ragged_tiles():
    """A ragged last q tile at an offset off the 128-row kv tile grid."""
    cases = {name: rest for name, *rest in chip_smoke.CHECK_CASES}
    b, t, s, h, kv, d, off, window, softcap = cases['ragged_tiles']
    assert t % 128 and off % 128 and s % 128


@pytest.mark.parametrize('fault', sorted(kernel_fault_check.FAULTS))
def test_planted_fault_applies_once(fault):
    with open(os.path.join(REPO, kernel_fault_check.source_of(fault))) as f:
        source = f.read()
    planted = kernel_fault_check.plant(source, fault)
    assert planted != source
    with pytest.raises(ValueError, match='anchor occurs 0 times'):
        kernel_fault_check.plant(planted.replace(
            kernel_fault_check.FAULTS[fault][2], ''), fault)


def test_backward_faults_target_the_backward_source():
    assert set(kernel_fault_check.BWD_FAULTS) <= set(kernel_fault_check.FAULTS)
    for fault in kernel_fault_check.FAULTS:
        want = ('flash_bwd.cu' if fault in kernel_fault_check.BWD_FAULTS
                else 'flash_fwd.cu')
        assert kernel_fault_check.source_of(fault).endswith(want)


def test_fault_check_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('CUDA present')
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, 'kernel_fault_check.py')],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert 'missed_by_kernel_checks' not in proc.stdout


def test_check_cases_include_warm_tails():
    """Warm-tail prefill after a prefix hit: 16 and 64 q rows (one
    mostly-padded 128-row tile) at page-aligned offsets off the 128-row
    kv tile grid (1088) and on it (1024), against the 2048-row view; the
    prefix phase's widest warm chunk, and its repeated prompt's last
    token at 1215."""
    cases = {name: rest for name, *rest in chip_smoke.CHECK_CASES}
    assert cases['warm_tail'] == [1, 16, 2048, 32, 8, 128, 1088, None, None]
    assert cases['warm_tail_64'] == [4, 64, 2048, 32, 8, 128, 1024, None,
                                     None]
    assert cases['warm_tail_512'] == [1, 512, 2048, 32, 8, 128,
                                      chip_smoke.PREFIX_LEN, None, None]
    repeat_at = chip_smoke.PREFIX_LEN + chip_smoke.COLD_TAIL - 1
    assert cases['warm_repeat'] == [1, 16, 2048, 32, 8, 128, repeat_at,
                                    None, None]
    page = chip_smoke.ENGINE_KW['kv_page_size']
    assert 1088 % page == 0 and 1088 % 128
    assert max(chip_smoke.WARM_TAILS) <= 512


def test_prefix_and_migration_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke's prefix and migration phases at the `tiny` size on the
    CPU, with a stand-in for the kernel launch that counts like the
    wrappers and computes the plain version: every warm request matches
    the whole prefix, the repeat is a full-prompt match with one copy on
    write, and both migrations give the uninterrupted tokens."""
    import numpy as np

    from skypilot_tpu_torch import inference
    from skypilot_tpu_torch import models as models_lib
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

    monkeypatch.setattr(fa, '_launch', launch)
    monkeypatch.setattr(fa, 'flash_fwd', flash_fwd)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda: None)
    monkeypatch.setattr(chip_smoke, 'profile_breakdown',
                        lambda torch, fn, **kw: fn() and {})
    monkeypatch.setattr(chip_smoke, 'DEV', 'cpu')
    monkeypatch.setattr(chip_smoke, 'ENGINE_KW', dict(
        batch_size=8, max_seq_len=128, prefill_chunk=32, kv_page_size=8,
        prefill_interleave=96, use_flash=True))
    monkeypatch.setattr(chip_smoke, 'PREFIX_LEN', 32)
    monkeypatch.setattr(chip_smoke, 'COLD_TAIL', 8)
    monkeypatch.setattr(chip_smoke, 'WARM_TAILS', (8, 12, 16, 20, 24, 31))
    family, config = models_lib.resolve('tiny')
    params = family.init_params(config, torch.Generator().manual_seed(0),
                                'cpu')
    rng = np.random.default_rng(0)
    for quant in (False, True):
        out = chip_smoke.prefix_phase(torch, inference, fa, params, config,
                                      rng, quant)
        warm = [r for r in out['requests'] if r['request'] != 'cold'][:-1]
        assert [r['matched_tokens'] for r in warm] == [32] * 6
        assert {r['chunks'][0]['rows'] for r in warm} == {16, 32}
        assert out['warm_tail_launches'] == 6 * config.num_layers
        # Launches by shape over the cache hits: three 16-row and three
        # 32-row warm chunks at 32, the repeat's last token at 39.
        hit = {(h['shape'][1], h['shape'][-1]): h['launches']
               for h in out['hit_shapes']}
        layers = config.num_layers
        assert hit == {(16, 32): 3 * layers, (32, 32): 3 * layers,
                       (16, 39): layers}
        readings = chip_smoke.hit_shape_readings(torch, fa, quant,
                                                 out['hit_shapes'])
        assert [r['shape'] + [r['q_offset']] for r in readings] == [
            h['shape'] for h in out['hit_shapes']]
        assert not any(chip_smoke.kernel_faults(r) for r in readings)
        assert out['requests'][-1]['cow_copies'] == 1
        assert out['pages']['free'] + out['pages']['cached'] == \
            out['pages']['total']
    small = chip_smoke.prompt_tokens
    monkeypatch.setattr(chip_smoke, 'prompt_tokens',
                        lambda rng, n, vocab: small(rng, max(4, n // 20),
                                                    vocab))
    out = chip_smoke.migration_phase(torch, inference, params, config, rng)
    assert out['engine_to_engine']['tokens_at_snapshot'] == [17, 17]
    srv = out['server_to_server']
    assert srv['corrupted_blob_status'] == 400 and srv['equal']
    assert srv['tokens_before_drain'] + srv['tokens_after_restore'] == 64
