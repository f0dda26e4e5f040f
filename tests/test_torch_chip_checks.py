"""The limits chip_smoke.py holds the kernels (K1-K4), the training
parity and speculative decode to, and the planted faults of
kernel_fault_check.py and spec_fault_check.py that show those limits
catch a wrong kernel or a wrong round.

The readings themselves come from the card; here the verdict functions
are held to their limits and every planted fault is held to apply
exactly once to the kernel source.
"""
import math
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import kernel_fault_check  # noqa: E402
import obs_overhead_check  # noqa: E402
import spec_fault_check  # noqa: E402

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
    reads 0.073-0.082, 3.6x over it. The head_dim 256 instances read at
    most 0.0043 on their six cases (seeds 3-5), under a third of the
    limit; their planted faults read 0.339 and more on their strongest
    case."""
    assert 2 * 2 ** -7 < chip_smoke.TOL_BWD_REL < 0.073 / 3
    assert 0.0061 * 3 < chip_smoke.TOL_BWD_REL
    assert 0.0043 * 3 < chip_smoke.TOL_BWD_REL < 0.339 / 3


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


@pytest.mark.parametrize('path, q_rows, ms', [('cp_masked', 0, 0.0038),
                                               ('cp_partial', 768, 0.0066)])
def test_fwd_bound_reads_q_only_for_rows_that_see_a_key(path, q_rows, ms):
    """K1 at a context rank's shapes (llama3-8b heads over a span of
    2304, a chunk of 1536 at offset -2304 or -768): q is read only for
    the rows that see a key of the span, O and lse are written for every
    row, and the kv rows the seeing rows need are read once; both are
    bound by memory."""
    b, t, s, h, kv, d, off = dict(chip_smoke.CTX_TIMING_SHAPES)[path]
    pairs, kv_rows, rows = chip_smoke.visible_span(t, s, off, None)
    assert rows == q_rows and kv_rows == min(s, max(0, off + t))
    got, bound_by, flops = chip_smoke.bound_ms(b, t, s, h, kv, d, off, None,
                                               False)
    nbytes = (b * rows * h * d * 2 + 2 * b * kv_rows * kv * d * 2
              + b * t * h * d * 2 + b * h * t * 4)
    assert flops == 4 * d * pairs * b * h
    assert bound_by == 'bytes'
    assert got == pytest.approx(nbytes / chip_smoke.H100_HBM_BYTES * 1e3)
    assert got == pytest.approx(ms, abs=1e-4)


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


# -- the spec phase ------------------------------------------------------------


def test_divergence_rule():
    """A divergence passes only as a near-tie: both tokens within the
    limit of the target's top logit (an exact tie, a three-way near-tie);
    a token further down, or a length mismatch, fails."""
    limit = chip_smoke.TOL_SPEC_GAP
    sound = {'equal': False, 'index': 7, 'plain_token': 11,
             'spec_token': 42, 'top2': [42, 11], 'gap': 0.0,
             'deficits': [0.0, 0.0]}
    three_way = {**sound, 'top2': [42, 90], 'gap': 0.03125,
                 'deficits': [0.0625, 0.0]}
    assert chip_smoke.divergence_faults(
        [{'equal': True}, sound, three_way]) == []
    for bad in ({'deficits': [0.0, limit]},                # spec too low
                {'deficits': [4.5, 0.0]},                  # plain too low
                {'deficits': None, 'top2': None}):         # length differs
        faults = chip_smoke.divergence_faults([{**sound, **bad}])
        assert len(faults) == 1 and 'request 0' in faults[0]
    # The limit sits between the sound readings on the H100 (deficits 0
    # to 0.0625) and spec_fault_check.py's wrong rounds (0.25 to 7.7).
    assert 0.0625 < limit <= 0.25
    assert chip_smoke.first_divergence([1, 2, 3], [1, 2, 3]) is None
    assert chip_smoke.first_divergence([1, 2, 3], [1, 5, 3]) == 1
    assert chip_smoke.first_divergence([1, 2], [1, 2, 3]) == 2
    limit = chip_smoke.TOL_SPEC_ACCEPT
    assert chip_smoke.acceptance_faults(31, 32) == []
    assert chip_smoke.acceptance_faults(236, 272) == []    # sound, H100
    assert chip_smoke.acceptance_faults(int(limit * 100) - 1, 100)
    assert chip_smoke.acceptance_faults(191, 396)          # a length fault
    assert 0.48 < limit < 0.8676
    assert chip_smoke.acceptance_faults(0, 0)


def _planted_engine(fault):
    """The engine module with one of spec_fault_check.py's faults planted
    in its source."""
    import types

    from skypilot_tpu_torch.inference import engine as eng
    with open(eng.__file__) as f:
        source = f.read()
    module = types.ModuleType('planted_engine')
    # The engine's dataclasses resolve their annotations through
    # sys.modules while the source runs.
    sys.modules[module.__name__] = module
    try:
        exec(compile(spec_fault_check.plant(source, fault), eng.__file__,
                     'exec'), module.__dict__)
    finally:
        del sys.modules[module.__name__]
    return module


@pytest.fixture
def one_torch_thread(monkeypatch):
    """The tiny engines (in this process and in a server process it
    starts) gain nothing from intra-op threads, and the suite runs in
    several worker processes on few cores."""
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_spec_phase_rehearses_on_cpu(monkeypatch, one_torch_thread):
    """chip_smoke's spec phase at the `tiny` size on the CPU (f32, so the
    spec path equals plain greedy exactly), with a counting stand-in for
    the kernel launch, the server as a process included. Then two
    planted faults: m+1 drafted tokens emitted on a miss fails the
    divergence rule, and a draft table row left unwritten (the pairing)
    fails the target-as-draft acceptance limit: both are planted from
    spec_fault_check.py's list."""
    import numpy as np

    from skypilot_tpu_torch import inference
    from skypilot_tpu_torch.inference import engine as eng
    from skypilot_tpu_torch.models import llama
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
    monkeypatch.setattr(chip_smoke, 'SPEC_KW', dict(
        batch_size=8, max_seq_len=128, prefill_chunk=32, kv_page_size=8,
        use_flash=True))
    monkeypatch.setattr(chip_smoke, 'SPEC_MODEL', 'tiny')
    monkeypatch.setattr(chip_smoke, 'SPEC_DRAFT', 'tiny')
    monkeypatch.setattr(chip_smoke, 'SPEC_NEW', 9)
    monkeypatch.setattr(chip_smoke, 'SPEC_PROMPT_LENGTHS', (8, 30))
    monkeypatch.setattr(chip_smoke, 'SPEC_SERVER_PROMPT', 20)
    params, config = inference.draw_params('tiny', 0, 'cpu')
    out = chip_smoke.spec_phase(torch, inference, fa, params, config,
                                np.random.default_rng(0))
    for kv in ('bf16', 'int8'):
        run = out[kv]
        assert run['draft']['tokens_equal'] == 8
        assert run['kernel_launches'] > 0
        assert run['draft']['spec_rounds'] > 0
    tad = out['bf16']['target_as_draft']
    assert tad['tokens_equal'] == 8 and tad['acceptance'] == 8 / 8
    assert out['server']['tokens_equal']
    assert out['server']['health_spec']['rounds'] > 0

    dparams, dconfig = inference.draw_params('tiny', 1, 'cpu')
    rng = np.random.default_rng(1)
    prompts = [chip_smoke.prompt_tokens(rng, int(n), config.vocab_size)
               for n in rng.integers(8, 31, size=4)]
    assert out['faults'] == []
    with monkeypatch.context() as m:
        m.setattr(eng, 'fused_spec_rounds', _planted_engine(
            'emit_drafted_on_miss').fused_spec_rounds)
        faults = chip_smoke.spec_engines(
            torch, inference, fa, llama, params, config, dparams, dconfig,
            prompts, False, target_as_draft=False)['faults']
        assert faults and all('diverges' in f for f in faults)
    monkeypatch.setattr(
        eng.InferenceEngine, '_set_table_rows', _planted_engine(
            'draft_table_row_unwritten').InferenceEngine._set_table_rows)
    faults = chip_smoke.spec_engines(
        torch, inference, fa, llama, params, config, dparams, dconfig,
        prompts, False, target_as_draft=True)['faults']
    assert len(faults) == 1 and 'target_as_draft: accepted' in faults[0]


@pytest.mark.parametrize('fault', sorted(spec_fault_check.FAULTS))
def test_planted_spec_fault_applies_once(fault):
    """Each spec fault's anchor occurs once in the engine source and the
    planted source still compiles."""
    with open(os.path.join(REPO, spec_fault_check.ENGINE_SOURCE)) as f:
        source = f.read()
    planted = spec_fault_check.plant(source, fault)
    assert planted != source
    compile(planted, spec_fault_check.ENGINE_SOURCE, 'exec')


def test_spec_fault_check_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('CUDA present')
    proc = subprocess.run([sys.executable, os.path.join(
        REPO, 'spec_fault_check.py')], capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 2 and 'wrong_verdicts' not in proc.stdout


# -- the gemma and checkpoint phases ------------------------------------------


def test_gemma_and_checkpoint_phases_rehearse_on_cpu(monkeypatch,
                                                     one_torch_thread):
    """chip_smoke's gemma phases at the tiny-gemma size on the CPU (local
    and global layers, softcaps), with a counting stand-in for the kernel
    launch: the main path launches exactly the count the batched prefill
    must make (every chunk of every layer), for bf16 and int8 KV. Then
    the checkpoint phase: the port's writer, the import, build_engine and
    the server as a process with --checkpoint, token for token."""
    import numpy as np

    from skypilot_tpu_torch import inference
    from skypilot_tpu_torch.inference import engine as eng
    from skypilot_tpu_torch.models import llama
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
    monkeypatch.setattr(torch.cuda, 'max_memory_allocated', lambda: 0)
    monkeypatch.setattr(chip_smoke, 'profile_breakdown',
                        lambda torch, fn, **kw: fn() and {})
    monkeypatch.setattr(chip_smoke, 'DEV', 'cpu')
    monkeypatch.setattr(chip_smoke, 'GEMMA_KW', dict(
        batch_size=8, max_seq_len=128, prefill_chunk=16, kv_page_size=8,
        prefill_interleave=0, use_flash=True))
    monkeypatch.setattr(chip_smoke, 'GEMMA_PROMPT_LENGTHS', (20, 100))
    monkeypatch.setattr(chip_smoke, 'GEMMA_LONG_LENGTHS', (70, 100))
    monkeypatch.setattr(chip_smoke, 'GEMMA_CHECK_LENGTHS', (60, 30))
    monkeypatch.setattr(chip_smoke, 'GEMMA_NEW', 6)
    monkeypatch.setattr(chip_smoke, 'GEMMA_PROFILE_LENGTHS', (10, 40))
    params, config = inference.draw_params('tiny-gemma', 0, 'cpu')
    assert config.sliding_window == 16 and config.final_logit_softcap
    rng = np.random.default_rng(0)
    for quant in (False, True):
        engine = inference.InferenceEngine(
            params, config, kv_quant='int8' if quant else 'none',
            device='cpu', **chip_smoke.GEMMA_KW)
        out, launches = chip_smoke.gemma_phase(torch, inference, eng, fa,
                                               llama, engine, rng, quant)
        # Prompts of up to 100 tokens pad to 128: 8 chunks of 16 a layer.
        assert launches == out['expected_launches'] == 8 * config.num_layers
        assert max(out['prompt_lengths']) >= 70
        assert not chip_smoke.logits_faults(out)
        assert out['prefill_tok_s'] > 0 and out['decode_tok_s'] > 0
    monkeypatch.setattr(chip_smoke, 'CKPT_MODEL', 'tiny-gemma')
    monkeypatch.setattr(chip_smoke, 'CKPT_KW', dict(
        batch_size=2, max_seq_len=64, prefill_chunk=16, kv_page_size=8))
    monkeypatch.setattr(chip_smoke, 'CKPT_PROMPT', 20)
    monkeypatch.setattr(chip_smoke, 'CKPT_NEW', 6)
    out = chip_smoke.checkpoint_phase(torch, inference, rng)
    assert out['tokens_equal'] and out['tokens'] == 6
    assert out['import']['shards'] == 2
    assert 'model.safetensors.index.json' in out['files']
    assert 0 < out['import']['peak_host_bytes'] <= \
        out['import']['largest_tensor_bytes']


# -- head_dim 256 backward (gemma2-2b training) ------------------------------

@pytest.mark.parametrize('name,pairs,dq_ms,dkv_ms', [
    ('gemma2b_global', 33_558_528, 0.417, 0.556),
    ('gemma2b_local', 25_167_872, 0.313, 0.417),
])
def test_bwd_bounds_count_gemma2b_training_attention(name, pairs, dq_ms,
                                                     dkv_ms):
    """gemma2-2b's training attention (B 1, S 8192, 8 / 4 heads, d 256,
    causal): S(S+1)/2 visible pairs a head on a global layer (window
    2**30), 4096 * 4097 / 2 + 4096 * 4096 on a local one (window 4096);
    6*d (K3) and 8*d (K4) FLOP a pair, both bound by the tensor cores."""
    cases = {case[0]: case[1:] for case in chip_smoke.BWD_CASES}
    b, sq, skv, h, kv, d, causal, off, window, softcap = cases[name]
    assert (b, sq, skv, h, kv, d, causal, off, softcap) == (
        1, 8192, 8192, 8, 4, 256, True, None, 50.0)
    assert chip_smoke.visible_span(sq, skv, 0, window) == (pairs, 8192,
                                                           8192)
    bounds = chip_smoke.bwd_bounds(b, sq, skv, h, kv, d, off, window)
    for kernel, per_pair, ms in (('dq', 6, dq_ms), ('dkv', 8, dkv_ms)):
        assert bounds[kernel][2] == per_pair * d * pairs * h
        assert bounds[kernel][1] == 'operations'
        assert bounds[kernel][0] == pytest.approx(ms, abs=5e-4)
    assert cases[name] in [c[1:] for c in chip_smoke.BWD_GEMMA_TIMING_CASES]


def test_bwd_cases_add_head_dim_256():
    """The d 256 backward cases: gemma2-2b's local and global layers at
    seq 8192 (the timing cases), rows with no visible key, ragged tiles
    of both kernels (64-row q tiles in K3, 64-row kv tiles in K4),
    non-causal, and a softcap whose Jacobian is far from 1."""
    cases = {name: rest for name, *rest in chip_smoke.BWD_CASES}
    d256 = [name for name, rest in cases.items() if rest[5] == 256]
    assert d256 == ['gemma2b_local', 'gemma2b_global', 'masked_rows_d256',
                    'ragged_tiles_d256', 'non_causal_d256',
                    'softcap_jacobian_d256']
    assert [c[0] for c in chip_smoke.BWD_GEMMA_TIMING_CASES] == [
        'gemma2b_local', 'gemma2b_global']
    assert cases['gemma2b_local'][8] == 4096
    assert cases['gemma2b_global'][8] == 2 ** 30
    b, sq, skv, h, kv, d, causal, off, window, softcap = cases[
        'masked_rows_d256']
    assert causal and off + sq - 1 - window + 1 >= skv  # last rows see none
    b, sq, skv, h, kv, d, causal, off, window, softcap = cases[
        'ragged_tiles_d256']
    assert sq % 64 and skv % 64 and h != kv
    assert not cases['non_causal_d256'][6]
    # Scores about N(0, 1): tanh(3 / 2)^2 = 0.82, so 1 - tanh^2 is far
    # from 1 on the larger scores.
    assert cases['softcap_jacobian_d256'][9] <= 2.0


def test_d256_backward_faults_are_read_at_gemma_widths():
    """The three d 256 backward faults are backward faults, planted in
    the d 256 instances only, and read by train_parity at gemma2-2b's
    widths (bench-8b's d 128 cannot see them)."""
    d256 = kernel_fault_check.D256_BWD_FAULTS
    assert len(d256) == 3 and set(d256) <= set(kernel_fault_check.BWD_FAULTS)
    assert len(kernel_fault_check.FAULTS) == 15
    assert chip_smoke.PARITY_GEMMA == ('gemma2-2b', 2, 8192)
    for fault in d256:
        _, old, new = kernel_fault_check.FAULTS[fault]
        assert 'D == 256' in new or 'D != 256' in new
        assert '256' not in old


@pytest.fixture
def tiny_gemma_d256(monkeypatch):
    """tiny-gemma at head_dim 256 through flash with remat on, as the
    preset 'tiny-gemma-d256'."""
    import dataclasses

    from skypilot_tpu_torch.models import gemma
    config = dataclasses.replace(
        gemma.CONFIGS['tiny-gemma'], head_dim=256, num_heads=2,
        num_kv_heads=1, attention_impl='flash', attention_block_size=16,
        remat=True)
    monkeypatch.setitem(gemma.CONFIGS, 'tiny-gemma-d256', config)
    return config


def test_gemma_train_phases_rehearse_on_cpu(monkeypatch, one_torch_thread,
                                            tiny_gemma_d256):
    """chip_smoke's train_parity and train phases on a tiny d 256 gemma
    (a local and a global layer, softcaps, remat) on the CPU, with
    counting stand-ins for the K1/K3/K4 launches (each tallied under its
    window, as the launchers do): flash against dense within the limits,
    then fit() with exactly 2 x layers x steps K1, layers x steps K3 and
    K4, and no K2 launches, split between the local and the global
    window as the layers are, the loss falling."""
    import inspect

    from skypilot_tpu_torch.ops import flash_attention as fa

    def counting(fn, counter=None):
        def wrapper(*args, **kwargs):
            bound = inspect.signature(fn).bind(*args, **kwargs)
            bound.apply_defaults()
            fa._count(counter or wrapper, bound.arguments['window'],
                      bound.arguments['causal'])
            return fn(*args, **kwargs)
        wrapper.launches, wrapper.window_launches = 0, {}
        wrapper.causal_launches = {}
        return wrapper

    monkeypatch.setattr(fa, 'flash_fwd',
                        counting(fa.flash_fwd, fa.flash_attention))
    monkeypatch.setattr(fa.flash_attention, 'launches', 0)
    monkeypatch.setattr(fa.flash_attention, 'window_launches', {})
    for name in ('flash_attention_dq', 'flash_attention_dkv'):
        monkeypatch.setattr(fa, name, counting(getattr(fa, name)))
    for name in ('synchronize', 'empty_cache', 'reset_peak_memory_stats'):
        monkeypatch.setattr(torch.cuda, name, lambda: None)
    monkeypatch.setattr(torch.cuda, 'max_memory_allocated', lambda: 0)
    monkeypatch.setattr(chip_smoke, 'profile_breakdown',
                        lambda torch, fn, **kw: (fn(), {})[1])
    monkeypatch.setattr(chip_smoke, 'time_ms',
                        lambda torch, fn, **kw: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, 'DEV', 'cpu')
    monkeypatch.setattr(chip_smoke, 'TRAIN_LR', 1e-2)
    monkeypatch.setattr(chip_smoke, 'TRAIN_WARMUP', 1)
    parity = chip_smoke.train_parity(torch, 'tiny-gemma-d256', 2, 32)
    assert chip_smoke.train_faults(parity) == []
    assert parity['loss_abs_diff'] < 1e-4
    out = chip_smoke.train_phase(torch, fa, 'tiny-gemma-d256', 32, 4)
    layers = tiny_gemma_d256.num_layers
    assert out['launches'] == {'K1': 2 * layers * 4, 'K2': 0,
                               'K3': layers * 4, 'K4': layers * 4}
    local = tiny_gemma_d256.sliding_window
    assert out['window_launches'] == {
        'K1': {local: 8, 2 ** 30: 8}, 'K2': {},
        'K3': {local: 4, 2 ** 30: 4}, 'K4': {local: 4, 2 ** 30: 4}}
    assert out['heads'] == [2, 1, 256] and out['remat']
    assert out['losses'][-1] < out['losses'][0]


# -- the telemetry plane (server phase, overhead phase) -----------------------

OBS_WANT = {'skytpu_prompt_tokens_total': 1800,
            'skytpu_generated_tokens_total': 36,
            'skytpu_requests_finished_total': 3,
            'skytpu_http_requests_total{plane="inference",method="POST",'
            'code="200"}': 3,
            'skytpu_decode_host_steps_total': 5,
            'skytpu_prefill_seconds_count': 2}


def test_counter_delta_check_catches_a_missing_increment():
    assert chip_smoke.counter_faults(dict(OBS_WANT), OBS_WANT) == []
    short = {**OBS_WANT, 'skytpu_prompt_tokens_total': 1500}
    faults = chip_smoke.counter_faults(short, OBS_WANT)
    assert len(faults) == 1 and 'skytpu_prompt_tokens_total' in faults[0]
    missing = {k: v for k, v in OBS_WANT.items()
               if k != 'skytpu_prompt_tokens_total'}
    assert len(chip_smoke.counter_faults(missing, OBS_WANT)) == 1


def test_parse_metrics_reads_the_exposition():
    from skypilot_tpu_torch.observability import metrics
    reg = metrics.Registry()
    c = metrics.Counter('skytpu_x_total', 'X.', labelnames=('code',),
                        registry=reg)
    h = metrics.Histogram('skytpu_x_seconds', 'X.', buckets=(0.1, 1.0),
                          registry=reg)
    c.labels(code='200').inc(3)
    h.observe(0.05, trace_id='ab' * 16)
    h.observe(0.5)
    got = chip_smoke.parse_metrics(reg.generate_text())
    assert got['skytpu_x_total{code="200"}'] == 3
    assert got['skytpu_x_seconds_bucket{le="0.1"}'] == 1
    assert got['skytpu_x_seconds_count'] == 2
    assert got['skytpu_x_seconds_sum'] == pytest.approx(0.55)


def _trace_doc(orphan=False, late=False):
    """An /internal/trace document: a request span and its engine
    phases (optionally one whose parent is lost, or one that ends after
    the request span)."""
    from skypilot_tpu_torch.observability import spans
    root = {'name': 'inference.request', 'trace_id': 't' * 32,
            'span_id': 'r' * 16, 'parent_id': None, 'start': 10.0,
            'end': 12.0, 'attrs': {}, 'status': 'ok'}
    recs = [root]
    for k, name in enumerate(('engine.admission_wait', 'engine.prefill',
                              'engine.decode', 'engine.decode')):
        recs.append({**root, 'name': name, 'span_id': f'{k:016x}',
                     'parent_id': root['span_id'], 'start': 10.1 + 0.3 * k,
                     'end': 10.3 + 0.3 * k})
    if orphan:
        recs[-1] = {**recs[-1], 'parent_id': 'f' * 16}
    if late:
        recs[-1] = {**recs[-1], 'end': 12.5}
    return {'trace_id': root['trace_id'], 'spans': recs,
            'tree': spans.tree_view(recs)}


def test_span_tree_check_catches_an_orphan_engine_span():
    assert chip_smoke.span_tree_faults(_trace_doc()) == []
    faults = chip_smoke.span_tree_faults(_trace_doc(orphan=True))
    assert len(faults) == 1 and 'roots' in faults[0]
    faults = chip_smoke.span_tree_faults(_trace_doc(late=True))
    assert faults == ['engine.decode outside the request span']
    doc = _trace_doc()
    doc['tree'][0]['children'] = [c for c in doc['tree'][0]['children']
                                  if c['name'] != 'engine.prefill']
    assert chip_smoke.span_tree_faults(doc) == [
        'no engine.prefill or engine.prefill_chunk']


def test_overhead_limit():
    assert chip_smoke.overhead_faults({'overhead_frac': 0.031}) == []
    assert chip_smoke.overhead_faults({'overhead_frac': -0.02}) == []
    faults = chip_smoke.overhead_faults({'overhead_frac': 0.2})
    assert len(faults) == 1 and 'overhead_frac 0.2' in faults[0]
    assert chip_smoke.overhead_faults({'overhead_frac': float('nan')})
    assert chip_smoke.TOL_OBS_OVERHEAD == 0.10


def test_telemetry_modes_restore_knobs_and_stop_threads(monkeypatch):
    import threading

    from skypilot_tpu_torch.observability import watchdog
    monkeypatch.setenv('SKYTPU_TRACE_SAMPLE', '0.5')
    monkeypatch.delenv('SKYTPU_TRACE_MAX_SPANS', raising=False)
    with chip_smoke.telemetry('off'):
        assert os.environ['SKYTPU_TRACE_MAX_SPANS'] == '0'
        assert 'SKYTPU_TRACE_SAMPLE' not in os.environ
        names = {t.name for t in threading.enumerate()}
        assert not names & {'skytpu-ts-sampler', 'skytpu-watchdog'}
    with chip_smoke.telemetry('threads'):
        assert os.environ['SKYTPU_TRACE_MAX_SPANS'] == '0'
        names = {t.name for t in threading.enumerate()}
        assert {'skytpu-ts-sampler', 'skytpu-watchdog'} <= names
    with chip_smoke.telemetry('on'):
        assert os.environ['SKYTPU_TRACE_SAMPLE'] == '1.0'
        names = {t.name for t in threading.enumerate()}
        assert {'skytpu-ts-sampler', 'skytpu-watchdog'} <= names
        assert watchdog.get_watchdog() is not None
    names = {t.name for t in threading.enumerate()}
    assert not names & {'skytpu-ts-sampler', 'skytpu-watchdog'}
    assert os.environ['SKYTPU_TRACE_SAMPLE'] == '0.5'
    assert 'SKYTPU_TRACE_MAX_SPANS' not in os.environ


def test_server_and_overhead_phases_rehearse_on_cpu(monkeypatch,
                                                    one_torch_thread):
    """chip_smoke's server phase, its telemetry checks included, and the
    overhead phase at the `tiny` size on the CPU, with the counting
    stand-in for the kernel launch: the /metrics deltas equal the
    prompts, the tokens and the engine's stats, each trace is a request
    span over the engine's phases, and the four engines are timed."""
    from skypilot_tpu_torch import inference
    from skypilot_tpu_torch import models as models_lib
    from skypilot_tpu_torch.ops import flash_attention as fa

    def launch(q, k, v, causal, window, softcap, q_offset, k_scale=None,
               v_scale=None):
        fa.flash_attention.launches += 1
        return fa._plain(q, k, v, causal, 512, window, softcap, q_offset,
                         k_scale=k_scale, v_scale=v_scale)

    def flash_fwd(q, k, v, causal=True, block_q=512, block_k=512,
                  window=None, softcap=None, q_offset=None, k_scale=None,
                  v_scale=None):
        return fa._launch(q, k, v, causal, window, softcap, q_offset,
                          k_scale=k_scale, v_scale=v_scale)

    monkeypatch.setattr(fa, '_launch', launch)
    monkeypatch.setattr(fa, 'flash_fwd', flash_fwd)
    monkeypatch.setattr(chip_smoke, 'DEV', 'cpu')
    monkeypatch.setattr(chip_smoke, 'SERVER_KW', dict(
        batch_size=4, max_seq_len=128, prefill_chunk=32, kv_page_size=8,
        use_flash=True))
    monkeypatch.setattr(chip_smoke, 'SERVER_REQUESTS',
                        ((30, 8, False), (90, 12, False), (60, 16, True)))
    monkeypatch.setattr(chip_smoke, 'ENGINE_KW', dict(
        batch_size=4, max_seq_len=128, prefill_chunk=32, kv_page_size=8))
    monkeypatch.setattr(chip_smoke, 'OVERHEAD_PROMPT', 12)
    _short_overhead_blocks(monkeypatch)
    from skypilot_tpu_torch.observability import instruments as obs
    # On the card earlier phases made the generated-tokens series; a
    # fresh process has none until its first increment.
    obs.GENERATED_TOKENS.inc(0)
    family, config = models_lib.resolve('tiny')
    params = family.init_params(config, torch.Generator().manual_seed(0),
                                'cpu')
    out = chip_smoke.server_phase(torch, inference, fa, params, config)
    obs = out['observability']
    assert obs['deltas'] == obs['want']
    assert obs['want']['skytpu_prompt_tokens_total'] == 180
    assert obs['want']['skytpu_generated_tokens_total'] == 36
    assert len(obs['traces']) == 3 and obs['generated_tokens_rate'] > 0
    for trace in obs['traces']:
        assert trace['children']['engine.admission_wait'] == 1
        assert trace['children']['engine.decode'] >= 1
    assert set(obs['statuses'].values()) == {200}
    assert obs['alert_rules'] == ['anomaly(decode_step)', 'anomaly(ttft)']
    out = chip_smoke.overhead_phase(torch, inference, params, config)
    _check_overhead_reading(out)


def _short_overhead_blocks(monkeypatch):
    """The overhead phase, obs_overhead_check's block reading and the
    threads' intervals at the tiny engine's scale, with room in its
    budget for every step."""
    monkeypatch.setattr(chip_smoke, 'ENGINE_KW', dict(
        batch_size=4, max_seq_len=512, prefill_chunk=32, kv_page_size=8))
    monkeypatch.setattr(chip_smoke, 'OVERHEAD_ROUNDS', 12)
    monkeypatch.setattr(obs_overhead_check, 'BLOCK_CYCLES', 2)
    monkeypatch.setattr(obs_overhead_check, 'BLOCK_SECONDS', 0.15)
    fast = {'SKYTPU_TS_SAMPLE_SECONDS': '0.01',
            'SKYTPU_WATCHDOG_TICK_SECONDS': '0.02'}
    monkeypatch.setitem(chip_smoke.OBS_ENV, 'on', {
        'SKYTPU_TRACE_SAMPLE': '1.0', **fast})
    monkeypatch.setitem(chip_smoke.OBS_ENV, 'threads', {
        'SKYTPU_TRACE_MAX_SPANS': '0', **fast})


def _check_overhead_reading(out):
    assert set(out['p50_ms']) == {'off', 'off2', 'on'}
    assert all(v > 0 for v in out['p50_ms'].values())
    for key in ('steps_frac', 'aa_frac', 'overhead_frac'):
        assert math.isfinite(out[key])
    assert out['overhead_frac'] == \
        out['steps_frac'] + out['telemetry_host_share']
    # The threads ran inside the timed rounds.
    assert out['thread_passes']['samples'] > 0
    assert out['thread_passes']['ticks'] > 0
    assert out['host_ms']['sample_ms'] > 0 and out['host_ms']['tick_ms'] > 0
    assert out['telemetry_host_share'] > 0


def test_overhead_phase_reads_a_planted_registry_walk(monkeypatch,
                                                      one_torch_thread):
    """obs_overhead_check's planted fault, a render of the registry per
    generated token in the traced engine, reads above TOL_OBS_OVERHEAD in
    the overhead phase at the tiny size; the plant is gone afterwards,
    and the block reading of the threads runs."""
    from skypilot_tpu_torch import inference
    from skypilot_tpu_torch import models as models_lib
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    monkeypatch.setattr(chip_smoke, 'DEV', 'cpu')
    monkeypatch.setattr(chip_smoke, 'OVERHEAD_PROMPT', 12)
    _short_overhead_blocks(monkeypatch)
    family, config = models_lib.resolve('tiny')
    params = family.init_params(config, torch.Generator().manual_seed(0),
                                'cpu')
    count = InferenceEngine._count
    with obs_overhead_check.planted('registry_walk_per_token'):
        out = chip_smoke.overhead_phase(torch, inference, params, config)
    assert InferenceEngine._count is count
    _check_overhead_reading(out)
    assert out['steps_frac'] > chip_smoke.TOL_OBS_OVERHEAD
    assert chip_smoke.overhead_faults(out)
    reading = obs_overhead_check.reading(
        chip_smoke, out, 'planted', 'registry_walk_per_token',
        obs_overhead_check.walk_ms())
    assert reading['renders_a_step'] == 4 * 2
    assert reading['caught'] and reading['planted_cost_frac'] > 0.10
    assert reading['right']
    blocks = obs_overhead_check.threads_blocks(chip_smoke, inference,
                                               params, config)
    assert blocks['blocks'] == 5 and len(blocks['block_p50_ms']) == 5
    assert blocks['thread_passes']['samples'] > 0
    assert blocks['thread_passes']['ticks'] > 0
    assert math.isfinite(blocks['threads_frac'])
    assert math.isfinite(blocks['aa_frac'])


def test_overhead_check_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('CUDA present')
    proc = subprocess.run([sys.executable, os.path.join(
        REPO, 'obs_overhead_check.py')], capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 2 and proc.stdout == ''
