#!/usr/bin/env python3
"""Mutation check of chip_smoke.py's speculative-decode limits, on one GPU.

    python3 spec_fault_check.py

Builds the kernels once, then for the sound engine and for each planted
fault copies `skypilot_tpu_torch/` (its built kernels included),
`chip_smoke.py` and this script into a temporary directory, plants the
fault in the copy's `inference/engine.py`, and runs this script again
inside the copy. There it takes the readings of chip_smoke's spec phase
on bf16 KV (`spec_engines`): llama3-8b with random weights at full width
and depth, 8 greedy prompts of 100-1500 tokens and 32 new tokens each,
through the engine without a draft, with the llama3-1b draft and with
the target as its own draft; each divergence from the draft-free tokens
under the rule (TOL_SPEC_GAP, a top-two swap), and the target-as-draft
acceptance against TOL_SPEC_ACCEPT.

Each run prints one JSON line with its readings beside the limits and
the limits it breaks. The script exits non-zero if the sound engine
breaks a limit or a planted fault breaks none.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile

ENGINE_SOURCE = os.path.join('skypilot_tpu_torch', 'inference', 'engine.py')
# name -> (what it breaks, text in ENGINE_SOURCE, its replacement).
FAULTS = {
    'emit_drafted_on_miss': (
        'on a miss the round emits m+1 drafted tokens and no correction',
        'idx < m[:, None], drafts,', 'idx <= m[:, None], drafts,'),
    'target_length_not_rolled_back': (
        "the target cache's length keeps every verified key (L + k)",
        "        cache['length'] = new_len\n",
        "        cache['length'] = torch.where(act, length + k, length)\n"),
    'draft_length_not_rolled_back': (
        "the draft cache's length keeps its k proposals",
        "        draft_cache['length'] = new_len.clone()\n", ''),
    'draft_table_row_unwritten': (
        "admission maps a slot's pages in the target's table only",
        "            self.state.draft_cache['table'][slot] = row\n",
        '            pass\n'),
    'draft_not_prefilled': (
        'admission never prefills the draft cache',
        '        if self._draft_params is not None:\n'
        '            # The draft cache holds the prompts too',
        '        if False:\n'
        '            # The draft cache holds the prompts too'),
}


def plant(source, fault):
    """`source` with `fault` planted; raises unless its anchor text
    occurs exactly once."""
    _, old, new = FAULTS[fault]
    if source.count(old) != 1:
        raise ValueError(f'{fault}: anchor occurs {source.count(old)} '
                         'times in the engine source, want 1')
    return source.replace(old, new)


def readings(fault):
    """Inside a (planted) copy: chip_smoke's spec readings on bf16 KV."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from skypilot_tpu_torch import inference
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import flash_attention as fa

    params, config = inference.draw_params(cs.SPEC_MODEL, 0, cs.DEV)
    dparams, dconfig = inference.draw_params(cs.SPEC_DRAFT, 1, cs.DEV)
    rng = np.random.default_rng(0)
    lo, hi = cs.SPEC_PROMPT_LENGTHS
    prompts = [cs.prompt_tokens(rng, int(n), config.vocab_size)
               for n in rng.integers(lo, hi + 1, size=8)]
    out = cs.spec_engines(torch, inference, fa, llama, params, config,
                          dparams, dconfig, prompts, False,
                          target_as_draft=True)
    runs = {name: {key: out[name][key] for key in (
        'tokens_equal', 'divergences', 'acceptance', 'accepted_tokens',
        'proposed_tokens', 'accepted_per_round', 'spec_rounds')}
        for name in ('draft', 'target_as_draft')}
    return {'fault': fault,
            'planted': FAULTS[fault][0] if fault in FAULTS else None,
            'limits': {'tol_spec_gap': cs.TOL_SPEC_GAP,
                       'tol_spec_accept': cs.TOL_SPEC_ACCEPT},
            **runs, 'breaks': out['faults'], 'caught': bool(out['faults'])}


def run_copy(here, fault, workdir):
    """Copy the port (built kernels included) into `workdir`, plant
    `fault` unless it is 'sound', run the readings there in a
    subprocess; returns its JSON result."""
    copy = os.path.join(workdir, fault)
    shutil.copytree(os.path.join(here, 'skypilot_tpu_torch'),
                    os.path.join(copy, 'skypilot_tpu_torch'),
                    ignore=shutil.ignore_patterns('__pycache__'))
    for name in ('chip_smoke.py', os.path.basename(__file__)):
        shutil.copy(os.path.join(here, name), copy)
    if fault in FAULTS:
        path = os.path.join(copy, ENGINE_SOURCE)
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
        print('spec_fault_check: torch.cuda.is_available() is false; this '
              'script runs on an NVIDIA GPU', file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from skypilot_tpu_torch.ops import _build
    _build.library()                   # built once; each copy reuses it
    workdir = tempfile.mkdtemp(prefix='spec_fault_check_')
    wrong = []
    try:
        for fault in ('sound', *FAULTS):
            result = run_copy(here, fault, workdir)
            print(json.dumps(result), flush=True)
            if result['caught'] != (fault in FAULTS):
                wrong.append(fault)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({'faults': list(FAULTS), 'wrong_verdicts': wrong}),
          flush=True)
    return 1 if wrong else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
