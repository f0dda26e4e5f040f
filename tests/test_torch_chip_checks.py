"""The limits chip_smoke.py holds the kernels to, and the planted faults of
kernel_fault_check.py that show those limits catch a wrong kernel.

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

SOUND = {'max_abs_err': 0.00390625, 'lse_max_abs_err': 1e-6,
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
    """On the H100 a sound kernel reads max |dO| 0.0039 and max |dlse|
    9.5e-7; the mildest planted fault (drop_diagonal) reads 0.058 and
    0.022. Both limits stay well inside that gap."""
    assert SOUND['max_abs_err'] < chip_smoke.TOL_O <= 0.058 / 5
    assert SOUND['lse_max_abs_err'] < chip_smoke.TOL_LSE <= 0.022 / 20


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


@pytest.mark.parametrize('fault', sorted(kernel_fault_check.FAULTS))
def test_planted_fault_applies_once(fault):
    with open(os.path.join(REPO, kernel_fault_check.KERNEL_SOURCE)) as f:
        source = f.read()
    planted = kernel_fault_check.plant(source, fault)
    assert planted != source
    with pytest.raises(ValueError, match='anchor occurs 0 times'):
        kernel_fault_check.plant(planted.replace(
            kernel_fault_check.FAULTS[fault][2], ''), fault)


def test_fault_check_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('CUDA present')
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, 'kernel_fault_check.py')],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert 'missed_by_kernel_checks' not in proc.stdout
