#!/usr/bin/env python3
"""K3/K4 against their plain version, in bf16 steps, over several seeds.

    python3 bwd_accuracy.py [--seeds 3 4 5] [--tree DIR]

For each seed and each of chip_smoke.py's BWD_CASES (drawn in order from
one generator per seed, as chip_smoke.py's check_bwd draws them with
seed 3), it runs K3 (flash_attention_dq) and K4 (flash_attention_dkv)
and flash_attention_bwd_plain on the same bf16 inputs and prints one JSON
line a case. For each of dQ, dK and dV:

  - rel_err: max|a-b| / max|b|, the reading chip_smoke.py holds to
    TOL_BWD_REL;
  - steps_at_max: max|a-b| in bf16 steps (ulps) at max|b|;
  - one_step_at_max: that step over max|b|, what a miss of one step at
    the largest element reads as rel_err (between 2^-8 and 2^-7, set by
    where max|b| falls in its binade);
  - n_diff, share_diff: how many elements differ at all, and their share.

Both outputs are bf16, so a sound kernel's rel_err is a whole number of
steps of some element over max|b|; these columns tell a kernel that is
less accurate (more differing elements, larger misses) from a reading
that moved with the inputs.

`--tree DIR` reads the kernels of the port under DIR (a checkout of
another commit, e.g. the parent) on this checkout's cases and inputs, so
two versions can be compared on the same card in one run. A last line
times K3 and K4 at the training shape as chip_smoke.py's timing_bwd
does. Needs one CUDA device.
"""
import argparse
import importlib.util
import json
import math
import os
import sys


def _chip_smoke():
    """This checkout's chip_smoke.py, whatever --tree puts first on
    sys.path."""
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        '_bwd_accuracy_chip_smoke', os.path.join(here, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def step_reading(a, ref):
    """rel_err, steps_at_max, one_step_at_max, n_diff and share_diff of
    a bf16 output `a` against its bf16 reference `ref`."""
    a, ref = a.float(), ref.float()
    diff = (a - ref).abs()
    err = float(diff.max())
    top = float(ref.abs().max())
    # The bf16 step at |x| in [2^e, 2^(e+1)) is 2^(e-7); frexp gives
    # x = m 2^f with m in [0.5, 1), so e = f - 1.
    step = math.ldexp(1.0, math.frexp(top)[1] - 8) if top > 0 else 0.0
    n_diff = int((diff > 0).sum())
    return {'rel_err': err / max(top, 1e-30), 'max_abs_err': err,
            'steps_at_max': err / step if step else 0.0,
            'one_step_at_max': step / top if top > 0 else 0.0,
            'n_diff': n_diff, 'share_diff': n_diff / diff.numel()}


def case_reading(torch, cs, fa, gen, case):
    _, b, sq, skv, h, kv, d, causal, off, window, softcap = case
    q, k, v, do, o, lse, delta = cs.bwd_inputs(torch, fa, gen, b, sq, skv, h,
                                               kv, d, causal, off, window,
                                               softcap)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    got = (fa.flash_attention_dq(q, k, v, do, lse, delta, **kw),
           *fa.flash_attention_dkv(q, k, v, do, lse, delta, **kw))
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    return {name: step_reading(a, ref)
            for name, a, ref in zip(('dq', 'dk', 'dv'), got, want)}


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seeds', type=int, nargs='+', default=[3, 4, 5])
    ap.add_argument('--tree', default=None,
                    help='root of another checkout whose kernels to read')
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('bwd_accuracy: torch.cuda.is_available() is false; this '
              'script runs on an NVIDIA GPU', file=sys.stderr)
        return 2
    cs = _chip_smoke()
    tree = os.path.abspath(args.tree or os.path.dirname(
        os.path.abspath(__file__)))
    sys.path.insert(0, tree)
    from skypilot_tpu_torch.ops import flash_attention as fa
    if not os.path.abspath(fa.__file__).startswith(tree):
        raise RuntimeError(f'imported {fa.__file__}, not from {tree}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        gen = torch.Generator(device=cs.DEV).manual_seed(seed)
        for case in cs.BWD_CASES:
            print(json.dumps({'tree': tree, 'seed': seed, 'case': case[0],
                              **case_reading(torch, cs, fa, gen, case)}),
                  flush=True)
            torch.cuda.empty_cache()
    timing = cs.bwd_timing(torch, fa)
    print(json.dumps({'tree': tree, 'timing_bwd': {
        name: {k: t[k] for k in ('ms', 'library_ms', 'tflops')}
        for name, t in timing.items()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
