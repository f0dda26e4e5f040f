#!/usr/bin/env python3
"""Readings of chip_smoke.py's telemetry overhead phase on one GPU,
sound and with planted faults, and the sampler's and the watchdog's
share read in alternating blocks.

    python3 obs_overhead_check.py [--repeats N]

Builds the kernels, draws llama3-8b with random weights at full width
and depth (seed 0, as chip_smoke's engine phases serve it), then:
- runs chip_smoke's `overhead_phase` N times (default 2);
- reads the threads' share in blocks (`threads_blocks`): one untraced
  engine steps in BLOCK_CYCLES cycles of two blocks of at least
  BLOCK_SECONDS, the sampler and the watchdog running through the
  whole of every second block ('threads') and stopped in the others
  ('off'), then a last 'off' block. Each block's p50 step is read
  against that of each 'off' block beside it; `threads_frac` is the
  median ratio minus 1, and `aa_frac` reads the odd 'off' blocks the
  same way against the even ones (the noise floor between blocks);
- runs `overhead_phase` once with each fault of FAULTS planted in every
  engine that traces: the whole registry rendered as Prometheus text
  once, or four times, per generated token.

Each run prints one JSON line. A planted run gives the cost the fault
alone adds to a host step (`planted_cost_frac`: the host time of one
render, `walk_ms`, times the renders a host step makes, over the 'off'
engine's p50); the limit should catch it if and only if that cost is
above TOL_OBS_OVERHEAD. The script exits non-zero if a sound run
breaks the limit or a planted one gets the other verdict.
"""
import contextlib
import json
import os
import sys
import time

# name -> renders of the registry a generated token.
FAULTS = {'registry_walk_per_token': 1, 'registry_walk_4x_per_token': 4}
# The block reading: cycles, and each block's least length (about five
# sampler passes and two watchdog ticks in a 'threads' block).
BLOCK_CYCLES = 20
BLOCK_SECONDS = 1.0
BLOCK_STEPS = 3


@contextlib.contextmanager
def planted(fault):
    """`fault` planted, for the block, where an engine counts its
    generated tokens, in the engines whose requests are traced."""
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.observability import metrics
    if fault not in FAULTS:
        raise ValueError(f'unknown fault {fault!r}')
    count = InferenceEngine._count

    def walking(self, key, counter, n=1):
        if key == 'generated_tokens' and self._req_trace:
            for _ in range(int(n) * FAULTS[fault]):
                metrics.REGISTRY.generate_text()
        count(self, key, counter, n)

    InferenceEngine._count = walking
    try:
        yield
    finally:
        InferenceEngine._count = count


def walk_ms():
    """Host ms of one render of the registry (the median of 21)."""
    from skypilot_tpu_torch.observability import metrics
    runs = []
    for _ in range(21):
        t0 = time.perf_counter()
        metrics.REGISTRY.generate_text()
        runs.append((time.perf_counter() - t0) * 1e3)
    return sorted(runs)[10]


def threads_blocks(cs, inference, params, config):
    """The sampler's and the watchdog's share of a decode host step,
    read in alternating blocks on one untraced engine (see the module
    docstring)."""
    from skypilot_tpu_torch.observability import timeseries, watchdog
    engine = cs.overhead_engines(inference, params, config,
                                 (('off', 'off'),))['off']
    blocks = ['off', 'threads'] * BLOCK_CYCLES + ['off']
    times = [[] for _ in blocks]
    passes = {'samples': 0, 'ticks': 0}
    for b, mode in enumerate(blocks):
        with contextlib.ExitStack() as stack:
            stack.enter_context(cs.counted(timeseries.STORE, 'sample_now',
                                           passes, 'samples'))
            stack.enter_context(cs.telemetry(mode))
            if mode == 'threads':
                stack.enter_context(cs.counted(
                    watchdog.get_watchdog(), 'tick', passes, 'ticks'))
            t_block = time.perf_counter()
            while (len(times[b]) < BLOCK_STEPS or
                   time.perf_counter() - t_block < BLOCK_SECONDS):
                if any(s is None for s in engine.state.slots):
                    raise AssertionError('threads_blocks: the engine '
                                         'spent its budget')
                t0 = time.perf_counter()
                engine.step()
                times[b].append(time.perf_counter() - t0)
    engine.abort_all()
    if not passes['samples'] or not passes['ticks']:
        raise AssertionError(f'threads_blocks: no pass in the threads '
                             f'blocks: {passes}')

    def p50(b):
        return sorted(times[b])[len(times[b]) // 2]

    def median_frac(which, base):
        ratios = sorted(p50(b) / p50(o) for b in which for o in (
            max(o for o in base if o < b), min(o for o in base if o > b)))
        return ratios[len(ratios) // 2] - 1

    off = [b for b, m in enumerate(blocks) if m == 'off']
    on = [b for b, m in enumerate(blocks) if m == 'threads']
    return {'blocks': len(blocks), 'block_seconds': BLOCK_SECONDS,
            'steps': {'off': sum(len(times[b]) for b in off),
                      'threads': sum(len(times[b]) for b in on)},
            'block_p50_ms': [p50(b) * 1e3 for b in range(len(blocks))],
            'threads_frac': median_frac(on, off),
            'aa_frac': median_frac(off[1::2], off[0::2]),
            'thread_passes': passes}


def reading(cs, out, run, fault=None, walk=None):
    """One overhead run's line; for a planted `fault`, `walk` is the
    host ms of one render."""
    keys = ('p50_ms', 'steps_frac', 'telemetry_host_share',
            'overhead_frac', 'aa_frac', 'thread_passes', 'host_ms')
    caught = bool(cs.overhead_faults(out))
    line = {'run': run, 'fault': fault, **{k: out[k] for k in keys},
            'tol_overhead': cs.TOL_OBS_OVERHEAD, 'caught': caught}
    if fault is None:
        return {**line, 'right': not caught}
    renders = out['slots'] * out['fused_steps'] * FAULTS[fault]
    cost = renders * walk / out['p50_ms']['off']
    return {**line, 'walk_ms': walk, 'renders_a_step': renders,
            'planted_cost_frac': cost,
            'right': caught == (cost > cs.TOL_OBS_OVERHEAD)}


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print('obs_overhead_check: torch.cuda.is_available() is false; '
              'this script runs on an NVIDIA GPU', file=sys.stderr)
        return 2
    repeats = int(argv[argv.index('--repeats') + 1]) \
        if '--repeats' in argv else 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    from skypilot_tpu_torch import inference
    from skypilot_tpu_torch.ops import _build
    _build.library()
    smi = cs.sh(['nvidia-smi', '--query-gpu=name,power.limit',
                 '--format=csv,noheader']).splitlines()[0]
    print(json.dumps({'gpu': smi}), flush=True)
    params, config = inference.draw_params('llama3-8b', 0, cs.DEV)
    results = []
    for i in range(repeats):
        out = cs.overhead_phase(torch, inference, params, config)
        results.append(reading(cs, out, f'sound {i + 1}'))
        print(json.dumps(results[-1]), flush=True)
    print(json.dumps({'run': 'threads in blocks',
                      **threads_blocks(cs, inference, params, config)}),
          flush=True)
    for fault in FAULTS:
        with planted(fault):
            out = cs.overhead_phase(torch, inference, params, config)
        results.append(reading(cs, out, 'planted', fault, walk_ms()))
        print(json.dumps(results[-1]), flush=True)
    wrong = [r['run'] + (f' {r["fault"]}' if r['fault'] else '')
             for r in results if not r['right']]
    print(json.dumps({'runs': len(results), 'wrong_verdicts': wrong}),
          flush=True)
    return 1 if wrong else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
