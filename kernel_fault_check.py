#!/usr/bin/env python3
"""Mutation check of chip_smoke.py's limits, on one GPU.

    python3 kernel_fault_check.py [FAULT ...]   # every fault, or those named

For each planted fault it copies `skypilot_tpu_torch/`, `chip_smoke.py`
and this script into a temporary directory, plants the fault in the
copy's kernel source (`ops/csrc/flash_fwd.cu` for K1/K2, `flash_bwd.cu`
for K3/K4), and runs this script again inside the copy (so the copy's
kernels are built and loaded). There it takes the readings chip_smoke.py
holds to its limits:

  - head_dim 256 faults (the last 64-column slab of V left out of P V,
    the tile across a window's lower edge left unmasked, the window's
    first kv tile skipped), planted in the d 256 instances only: K1 and
    K2 against their plain versions on every CHECK_CASES case (the
    gemma2 cases among them);
  - forward faults (a kv tile dropped, the diagonal masked, a stale ring
    stage read, the frontier tile left unmasked): K1 and K2 against
    their plain versions on every
    CHECK_CASES case (max |dO| < TOL_O, max |dlse| < TOL_LSE, the
    lse = +inf rows), and the llama3-8b prefill logits through the
    kernel against the plain version and the dense forward
    (max|a-b| / max|b| < TOL_LOGITS_REL), bf16 and int8 KV caches, full
    width and depth, random weights; and K1 against its plain version
    at every BWD_CASES case (the training shape among them), as
    check_bwd holds it;
  - backward faults (K3 drops a kv tile or leaves its frontier tile
    unmasked; K4 drops a GQA head, drops delta or reads a stale ring
    stage), and head_dim 256 backward faults planted in the d 256
    instances only (K4 leaves dK's last 64-column slab unwritten, K4
    leaves the kv tile across a window's edge unmasked, K3 drops the
    softcap's Jacobian): K3 and K4 against flash_attention_bwd_plain on
    every BWD_CASES case (max|a-b| / max|b| < TOL_BWD_REL for dQ, dK,
    dV, and dQ = 0 on rows with no visible key), and train_parity (flash
    against dense loss_fn + backward at bench-8b widths, or gemma2-2b's
    for the d 256 faults: loss, grad norm, wq/wk/wv grads).

Each fault prints one JSON line with every reading beside its limit and
the limits it breaks. The script exits non-zero if any fault passes
the kernel checks, since a wrong kernel must not get past chip_smoke's
first gate. Whether the logits limit, the training-shape K1 check or
train_parity alone would catch it is reported.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile

KERNEL_SOURCE = os.path.join('skypilot_tpu_torch', 'ops', 'csrc',
                             'flash_fwd.cu')
BWD_SOURCE = os.path.join('skypilot_tpu_torch', 'ops', 'csrc',
                          'flash_bwd.cu')
# The top of the forward consumers' per-tile math, and of K3's.
_FWD_TILE_TOP = ('      // S = Q K^T over the tile (wgmma, both operands in '
                 'shared memory).\n')
_DQ_TILE_TOP = ('      // S = Q K^T and dP = dO V^T over the kv tile '
                '(SS wgmma, K-major).\n')
_SKIP_STAGE = ('      if (i == 1) {  '
               '// the stage is released, its tile unread\n'
               '        if (lane == 0) mbar_arrive(empty0 + 8 * stage);\n'
               '        continue;\n'
               '      }\n')
# name -> (what it breaks, text in its kernel source, its replacement);
# the source is KERNEL_SOURCE unless BWD_FAULTS names the fault.
FAULTS = {
    'drop_kv_tile': (
        'the kv loop skips the second tile it would visit',
        _FWD_TILE_TOP, _SKIP_STAGE + _FWD_TILE_TOP),
    'drop_diagonal': (
        'the causal mask hides each query\'s own position',
        'ok = ok && qpos >= kpos;',
        'ok = ok && qpos > kpos;'),
    'stale_stage': (
        'the consumers read the ring stage after the one their barrier '
        'released',
        'const uint32_t stage_base = operands + stage * L::kStageBytes;',
        'const uint32_t stage_base =\n'
        '          operands + ((stage + 1) % kStages) * L::kStageBytes;'),
    'frontier_tile_unmasked': (
        'a kv tile crossing the causal frontier takes the unmasked path',
        'const bool crosses_frontier = p.causal && k0 + kBK - 1 > qp_lo;',
        'const bool crosses_frontier = false;'),
    'dq_drop_kv_tile': (
        'K3 skips the second kv tile it would visit',
        _DQ_TILE_TOP, _SKIP_STAGE + _DQ_TILE_TOP),
    'dkv_drop_q_head': (
        'K4 drops the last q head of each GQA group',
        '    const bool dkv_tile_hidden =\n',
        '    const bool dkv_tile_hidden = hh + 1 == group ||\n'),
    'dkv_drop_delta': (
        'K4 computes dS = P dP, without - delta',
        'math.dscore(pe, dpt[4 * j + e], col_dlt, th);',
        'math.dscore(pe, dpt[4 * j + e], 0.f, th);'),
    'bwd_stale_stage': (
        'K4\'s consumers read the ring stage after the one their barrier '
        'released',
        'const uint32_t q_tile = ring + stage * L::kStageBytes;',
        'const uint32_t q_tile =\n'
        '        ring + ((stage + 1) % kStages) * L::kStageBytes;'),
    'd256_drop_last_v_slab': (
        'at d 256, P V leaves out V\'s last 64-column slab (O columns '
        '192-255 stay 0)',
        '          wgmma_rs_n128(acc + 64, pa[kt],\n',
        '          wgmma_rs_n64(acc + 64, pa[kt],\n'),
    'd256_window_edge_unmasked': (
        'at d 256, the kv tile across a window\'s lower edge takes the '
        'unmasked path',
        'p.causal && p.windowed && k0 <= qp_hi - p.window;',
        'p.causal && p.windowed &&\n'
        '          k0 + (D == 256 ? kBK : 0) <= qp_hi - p.window;'),
    'd256_window_tile_skipped': (
        'at d 256, the windowed kv loop starts one 64-row tile late',
        'const int k_first = (kv_lo / kBK) * kBK;',
        'const int k_first = (kv_lo / kBK + (D == 256 && p.windowed)) * '
        'kBK;'),
    'dq_frontier_tile_unmasked': (
        'a kv tile crossing the causal frontier of K3\'s rows takes the '
        'unmasked path',
        'const bool crosses_frontier =\n'
        '            p.causal && k0 + kRingRows - 1 > qp_lo;',
        'const bool crosses_frontier = false;'),
    'd256_dk_last_slab_unwritten': (
        'at d 256, K4 leaves dK\'s last 64-column slab (columns 192-255) '
        'unwritten',
        '    for (int j = 0; j < D / 8; ++j) {\n'
        '      *reinterpret_cast<uint32_t*>(out + row * out_ss',
        '    for (int j = 0; j < (IS_DK && D == 256 ? D / 8 - 8 : D / 8); '
        '++j) {\n'
        '      *reinterpret_cast<uint32_t*>(out + row * out_ss'),
    'd256_dkv_window_edge_unmasked': (
        'at d 256, the q tile across a window\'s edge of K4\'s kv rows '
        'takes the unmasked path',
        'p.causal && p.windowed && qp0 + kRingRows - 1 - kp_lo >= p.window;',
        'D != 256 && p.causal && p.windowed &&\n'
        '          qp0 + kRingRows - 1 - kp_lo >= p.window;'),
    'd256_dq_softcap_jacobian_dropped': (
        'at d 256, K3 computes dS without the softcap\'s Jacobian '
        '1 - tanh^2',
        'sc[4 * j + e] = math.dscore(pe, dp[4 * j + e], dlt[e >> 1], th);',
        'sc[4 * j + e] =\n'
        '                math.dscore(pe, dp[4 * j + e], dlt[e >> 1],\n'
        '                            D == 256 ? 0.f : th);'),
}
# Faults in the head_dim 256 backward instances only: train_parity reads
# them at gemma2-2b's widths.
D256_BWD_FAULTS = ('d256_dk_last_slab_unwritten',
                   'd256_dkv_window_edge_unmasked',
                   'd256_dq_softcap_jacobian_dropped')
BWD_FAULTS = ('dq_drop_kv_tile', 'dkv_drop_q_head', 'dkv_drop_delta',
              'bwd_stale_stage', 'dq_frontier_tile_unmasked',
              *D256_BWD_FAULTS)
# Faults in the head_dim 256 instances only: the llama3-8b readings
# (d 128) cannot see them, so only the kernel checks are read.
D256_FAULTS = ('d256_drop_last_v_slab', 'd256_window_edge_unmasked',
               'd256_window_tile_skipped')


def source_of(fault):
    """The kernel source (repo-relative path) a fault is planted in."""
    return BWD_SOURCE if fault in BWD_FAULTS else KERNEL_SOURCE


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

    if fault in BWD_FAULTS:
        cases = cs.bwd_readings(torch, fa)
        out = {'fault': fault, 'planted': FAULTS[fault][0],
               'source': source_of(fault),
               'limits': {'tol_bwd_rel': cs.TOL_BWD_REL},
               'kernel': {'flash_attention_bwd': {
                   case: {**{k: c[k] for k in ('dq_rel_err', 'dk_rel_err',
                                               'dv_rel_err', 'finite',
                                               'masked_rows_max_abs_dq')},
                          'breaks': cs.bwd_faults(c)}
                   for case, c in cases.items()}}}
        out['caught_by_kernel_checks'] = any(
            c['breaks'] for c in out['kernel']['flash_attention_bwd']
            .values())
        torch.cuda.empty_cache()
        parity = cs.train_parity(torch, *(
            cs.PARITY_GEMMA if fault in D256_BWD_FAULTS else cs.PARITY_BENCH))
        out['limits'].update(tol_train_loss=cs.TOL_TRAIN_LOSS,
                             tol_train_grad_rel=cs.TOL_TRAIN_GRAD_REL,
                             tol_train_proj_rel=cs.TOL_TRAIN_PROJ_REL)
        out['train_parity'] = {**parity, 'breaks': cs.train_faults(parity)}
        out['caught_by_train_parity'] = bool(out['train_parity']['breaks'])
        return out
    out = {'fault': fault, 'planted': FAULTS[fault][0],
           'source': source_of(fault),
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
    if fault in D256_FAULTS:
        out['caught_by_kernel_checks'] = all(
            any(c['breaks'] for c in out['kernel'][name].values())
            for name in ('flash_attention', 'flash_attention_quant'))
        return out
    out['kernel']['flash_attention_at_bwd_cases'] = {
        case: {'max_abs_err': c['fwd']['max_abs_err'],
               'lse_max_abs_err': c['fwd']['lse_max_abs_err'],
               'inf_rows_agree': c['fwd']['inf_rows_agree'],
               'breaks': cs.kernel_faults(c['fwd'])}
        for case, c in cs.bwd_readings(torch, fa).items()}
    torch.cuda.empty_cache()
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
        any(c['breaks'] for c in out['kernel'][name].values())
        for name in ('flash_attention', 'flash_attention_quant'))
    out['caught_by_training_shape_check'] = bool(
        out['kernel']['flash_attention_at_bwd_cases']['training']['breaks'])
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
    path = os.path.join(copy, source_of(fault))
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
    faults = argv or list(FAULTS)
    unknown = sorted(set(faults) - set(FAULTS))
    if unknown:
        print(f'kernel_fault_check: unknown faults {unknown}; known: '
              f'{sorted(FAULTS)}', file=sys.stderr)
        return 2
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
