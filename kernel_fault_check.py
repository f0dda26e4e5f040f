#!/usr/bin/env python3
"""Mutation check of chip_smoke.py's limits, on one GPU.

    python3 kernel_fault_check.py

For each planted fault it copies `skypilot_tpu_torch/`, `chip_smoke.py`
and this script into a temporary directory, plants the fault in the
copy's `ops/csrc/flash_fwd.cu`, and runs this script again inside the
copy (so the copy's kernel is built and loaded). There it takes the
readings chip_smoke.py holds to its limits:

  - K1 and K2 against their plain versions on every CHECK_CASES case
    (max |dO| < TOL_O, max |dlse| < TOL_LSE, the lse = +inf rows);
  - the llama3-8b prefill logits through the kernel against the plain
    version and the dense forward (max|a-b| / max|b| < TOL_LOGITS_REL),
    bf16 and int8 KV caches, full width and depth, random weights.

Each fault prints one JSON line with every reading beside its limit and
the limits it breaks. The script exits non-zero if any fault passes
the kernel checks, since a wrong kernel must not get past chip_smoke's
first gate. Whether the logits limit alone would catch it is reported.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile

KERNEL_SOURCE = os.path.join('skypilot_tpu_torch', 'ops', 'csrc',
                             'flash_fwd.cu')
_LOOP_TOP = '    __syncthreads();  // the previous tile is consumed\n'
# name -> (what it breaks, text in flash_fwd.cu, its replacement)
FAULTS = {
    'drop_kv_tile': (
        'the kv loop skips the second tile it would visit',
        _LOOP_TOP,
        '    if (k0 == (kv_lo / kBK) * kBK + kBK) continue;\n' + _LOOP_TOP),
    'drop_diagonal': (
        'the causal mask hides each query\'s own position',
        'ok = ok && qpos[half] >= kpos;',
        'ok = ok && qpos[half] > kpos;'),
}


def plant(source, fault):
    """`source` with `fault` planted; raises unless its anchor text
    occurs exactly once."""
    _, old, new = FAULTS[fault]
    if source.count(old) != 1:
        raise ValueError(f'{fault}: anchor occurs {source.count(old)} '
                         'times in the kernel source, want 1')
    return source.replace(old, new)


def readings(fault):
    """Inside a planted copy: the readings of chip_smoke's checks."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from skypilot_tpu_torch import inference
    from skypilot_tpu_torch.inference import engine as eng
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import flash_attention as fa

    out = {'fault': fault, 'planted': FAULTS[fault][0],
           'limits': {'tol_o': cs.TOL_O, 'tol_lse': cs.TOL_LSE,
                      'tol_logits_rel': cs.TOL_LOGITS_REL},
           'kernel': {}, 'logits': {}}
    for quant, name in ((False, 'flash_attention'),
                        (True, 'flash_attention_quant')):
        cases = cs.kernel_readings(torch, fa, quant)
        out['kernel'][name] = {
            case: {'max_abs_err': c['max_abs_err'],
                   'lse_max_abs_err': c['lse_max_abs_err'],
                   'inf_rows_agree': c['inf_rows_agree'],
                   'breaks': cs.kernel_faults(c)}
            for case, c in cases.items()}
    rng = np.random.default_rng(0)
    engine = inference.build_engine('llama3-8b', device=cs.DEV, seed=0,
                                    kv_quant='none', **cs.ENGINE_KW)
    for quant in ('none', 'int8'):
        if quant == 'int8':
            params, config = engine.params, engine.config
            del engine
            torch.cuda.empty_cache()
            engine = inference.InferenceEngine(params, config,
                                               kv_quant='int8', device=cs.DEV,
                                               **cs.ENGINE_KW)
        r = cs.logits_readings(torch, eng, fa, llama, engine, rng)
        out['logits'][quant] = {**r, 'breaks': cs.logits_faults(r)}
    out['caught_by_kernel_checks'] = all(
        any(c['breaks'] for c in cases.values())
        for cases in out['kernel'].values())
    out['caught_by_logits_check'] = {
        quant: bool(r['breaks']) for quant, r in out['logits'].items()}
    return out


def run_planted(here, fault, workdir):
    """Copy the port into `workdir`, plant `fault`, run the readings
    there in a subprocess; returns its JSON result."""
    copy = os.path.join(workdir, fault)
    shutil.copytree(os.path.join(here, 'skypilot_tpu_torch'),
                    os.path.join(copy, 'skypilot_tpu_torch'),
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    for name in ('chip_smoke.py', os.path.basename(__file__)):
        shutil.copy(os.path.join(here, name), copy)
    path = os.path.join(copy, KERNEL_SOURCE)
    with open(path) as f:
        planted = plant(f.read(), fault)
    with open(path, 'w') as f:
        f.write(planted)
    proc = subprocess.run(
        [sys.executable, os.path.join(copy, os.path.basename(__file__)),
         '--inside', fault], cwd=copy, capture_output=True, text=True,
        check=False)
    if proc.returncode != 0:
        raise RuntimeError(f'{fault}: readings failed '
                           f'({proc.returncode}):\n{proc.stderr[-4000:]}')
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv):
    if argv[:1] == ['--inside']:
        print(json.dumps(readings(argv[1])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print('kernel_fault_check: torch.cuda.is_available() is false; '
              'this script runs on an NVIDIA GPU', file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    faults = list(FAULTS)
    missed = []
    workdir = tempfile.mkdtemp(prefix='kernel_fault_check_')
    try:
        for fault in faults:
            result = run_planted(here, fault, workdir)
            print(json.dumps(result), flush=True)
            if not result['caught_by_kernel_checks']:
                missed.append(fault)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({'faults': faults, 'missed_by_kernel_checks': missed}),
          flush=True)
    return 1 if missed else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
