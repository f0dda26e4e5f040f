#!/usr/bin/env python3
"""Mutation check of chip_smoke.py's serve_ctl gates, on one GPU.

    python3 serve_fault_check.py [FAULT ...]

Builds the kernels, then llama3-8b at full width and depth (random
weights, seed 0) in this process for the in-process answers
(chip_smoke.ctl_reference, SERVER_KW's engine arguments), and runs
chip_smoke's serve_ctl phase once sound and once with each planted fault
of chip_smoke.CTL_FAULTS (all of them by default), which `ctl_plant`
patches into the phase's controller process:
- probe_never_passes: every readiness probe fails;
- lost_replica_unreplaced: no replica is launched past the first;
- v1_retired_before_v2_ready: the update retires v1 as soon as the
  surge replica is launched;
- down_leaks_replica: shutting down terminates no replica;
- lb_never_synced: the LB's replica list is never set.

Each run prints one JSON line with the gates it broke; a fault's line
says whether it broke its own gate and lists the others it broke beside
it (`other_broken`). A fault run stops at the leg that breaks, and
skips the legs its fault does not need (chip_smoke.CTL_FAULT_LEGS). The
script exits non-zero if the sound run breaks a gate or a fault leaves
its own gate standing. Every run starts its
controller and replicas afresh in a state directory of its own and
leaves no process behind.
"""
import json
import os
import shutil
import sys
import tempfile


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
                'phase_s': out['phase_s'], 'details': out['faults']}
        if fault is None:
            ok = not broken
            line['readings'] = out
        else:
            gate = chip_smoke.CTL_FAULTS[fault]
            ok = gate in broken
            line.update(gate=gate, breaks_its_gate=ok,
                        detail=out['faults'].get(gate),
                        other_broken=[g for g in broken if g != gate])
        line['ok'] = ok
        lines.append(line)
        if not ok:
            failed.append(fault or 'sound')
    return lines, failed


def run_in_state_dir(torch, ref, fault, root=None):
    """chip_smoke.serve_ctl_phase in a fresh SKYTPU_STATE_DIR (under
    `root`, else the temporary directory) under CTL_ENV, with the card's
    free memory read before it."""
    import chip_smoke
    tmp = tempfile.mkdtemp(prefix='serve_fault_check_', dir=root)
    try:
        with chip_smoke.env_set({**chip_smoke.CTL_ENV,
                                 'SKYTPU_STATE_DIR': tmp}):
            free_before = chip_smoke.ctl_free_bytes(torch)
            out = chip_smoke.serve_ctl_phase(torch, ref, tmp, fault=fault)
            chip_smoke.ctl_memory_gate(torch, free_before, out)
            return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print('serve_fault_check: torch.cuda.is_available() is false; '
              'this script runs on an NVIDIA GPU', file=sys.stderr)
        return 2
    import numpy as np
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke
    unknown = [name for name in argv if name not in chip_smoke.CTL_FAULTS]
    if unknown:
        print(f'unknown faults {unknown}; known: '
              f'{sorted(chip_smoke.CTL_FAULTS)}', file=sys.stderr)
        return 2
    chip_smoke.bytecode_cache()
    from skypilot_tpu_torch import inference
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import flash_attention as fa
    smi = chip_smoke.sh(['nvidia-smi', '--query-gpu=name,power.limit',
                         '--format=csv,noheader']).splitlines()[0]
    _build.library()
    engine = inference.build_engine(chip_smoke.CTL_MODEL, device='cuda',
                                    seed=0, **chip_smoke.CTL_KW)
    ref = chip_smoke.ctl_reference(torch, inference, fa, engine,
                                   np.random.default_rng(18))
    del engine
    torch.cuda.empty_cache()

    lines, failed = check(lambda fault: run_in_state_dir(torch, ref, fault),
                          argv or list(chip_smoke.CTL_FAULTS))
    for line in lines:
        print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': not failed, 'failed': failed}), flush=True)
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
