#!/usr/bin/env python3
"""Mutation check of chip_smoke.py's lb_serve gates, on one GPU.

    python3 lb_fault_check.py [FAULT ...]

Builds the kernels, then llama3-8b at full width and depth (random
weights, seed 0) as three engines of the migration phase's shape
(chip_smoke.MIGRATION_KW) on one set of weights, and runs chip_smoke's
lb_serve phase on them once sound and once with each planted fault of
chip_smoke.LB_FAULTS (all of them by default), which `lb_plant` patches
into the phase's LoadBalancer:
- handoff_frame_forwarded: the relay passes the handoff frame to the
  client;
- restore_to_prefill: the decode leg's blob goes back to the prefill
  replica;
- sent_uncounted: the relay counts a frame the client never got into
  the restore's `sent`;
- affinity_ignored: the policy's select drops the fingerprints;
- breaker_never_opens: the breaker drops every failure.

Each run prints one JSON line with the gates it broke; a fault's line
says whether it broke its own gate and lists the others it broke beside
it (`other_broken`). The script exits non-zero if the sound run breaks a
gate or a fault leaves its own gate standing.
"""
import json
import os
import sys


def check(run_phase, names):
    """Run `run_phase(fault)` sound (fault None) and with each fault of
    `names`; the JSON-able line of each run, and the runs that failed
    (the sound run breaking a gate, a fault missing its own)."""
    import chip_smoke
    lines, failed = [], []
    for fault in [None, *names]:
        out = run_phase(fault)
        broken = sorted(out['faults'])
        line = {'fault': fault, 'broken': broken,
                'phase_s': out['phase_s']}
        if fault is None:
            ok = not broken
            line['details'] = out['faults']
            line['readings'] = out
        else:
            gate = chip_smoke.LB_FAULTS[fault]
            ok = gate in broken
            line.update(gate=gate, breaks_its_gate=ok,
                        detail=out['faults'].get(gate),
                        other_broken=[g for g in broken if g != gate])
        line['ok'] = ok
        lines.append(line)
        if not ok:
            failed.append(fault or 'sound')
    return lines, failed


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print('lb_fault_check: torch.cuda.is_available() is false; this '
              'script runs on an NVIDIA GPU', file=sys.stderr)
        return 2
    import numpy as np
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke
    unknown = [name for name in argv if name not in chip_smoke.LB_FAULTS]
    if unknown:
        print(f'unknown faults {unknown}; known: '
              f'{sorted(chip_smoke.LB_FAULTS)}', file=sys.stderr)
        return 2
    chip_smoke.bytecode_cache()
    from skypilot_tpu_torch import inference
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import flash_attention as fa
    smi = chip_smoke.sh(['nvidia-smi', '--query-gpu=name,power.limit',
                         '--format=csv,noheader']).splitlines()[0]
    _build.library()
    first = inference.build_engine('llama3-8b', device='cuda', seed=0,
                                   **chip_smoke.MIGRATION_KW)
    engines = [first] + [
        inference.InferenceEngine(first.params, first.config, device='cuda',
                                  **chip_smoke.MIGRATION_KW)
        for _ in range(2)]

    def run_phase(fault):
        return chip_smoke.lb_serve_phase(torch, inference, fa, engines,
                                         np.random.default_rng(17),
                                         fault=fault)

    lines, failed = check(run_phase, argv or list(chip_smoke.LB_FAULTS))
    for line in lines:
        print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': not failed, 'failed': failed}), flush=True)
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
