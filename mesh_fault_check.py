"""Plant faults in the mesh training path and check that chip_smoke's
mesh_train limits catch each one.

    python3 mesh_fault_check.py [FAULT ...]

Runs chip_smoke's `mesh_train_phase` once sound (every leg), then once
per fault with the fault planted in the rank processes
(`chip_smoke.mt_plant`) on the legs it touches:
- batch_reduce: the gradient reductions over the batch axes left out
  (the FSDP reduce-scatter keeps this rank's part unsummed, the
  data/context all-reduce does nothing): the fsdp and ring legs;
- column_allreduce: the column-parallel inputs' backward all-reduce left
  out: the tensor leg;
- boundary_masked: each context rank's last target masked, the one at
  the boundary included: the ring leg;
- local_lse: the ring backward run on the diagonal hop's lse instead of
  the merged one: the ring leg;
- stages_swapped: each pipeline stage holding the other's layers;
  microbatch_off_by_one: the last stage's outputs recorded one
  microbatch on; embed_stage0_only: the stack's input gradient (the
  embedding's) left on stage 0; head_summed_twice: the replicated
  leaves' gradients all-reduced over `pipe` by the trainer's reduction,
  summed over the stages: the pipe leg;
- expert_not_reduced: the expert outputs not all-reduced over `expert`;
  topk_local: the router's top-k over each rank's own experts' logits:
  the expert leg.
Prints one JSON line a run (its limits' readings and the limits it
broke) and exits non-zero unless the sound run breaks none and every
fault breaks at least one. Needs one CUDA device; about 8 minutes.
"""
import json
import sys
import time

FAULT_LEGS = {'batch_reduce': ('fsdp', 'ring'),
              'column_allreduce': ('tensor',),
              'boundary_masked': ('ring',),
              'local_lse': ('ring',),
              'stages_swapped': ('pipe',),
              'microbatch_off_by_one': ('pipe',),
              'embed_stage0_only': ('pipe',),
              'head_summed_twice': ('pipe',),
              'expert_not_reduced': ('expert',),
              'topk_local': ('expert',)}


def readings(out):
    """The numbers the limits read, by leg: each step's loss and grad
    norm against the unsharded ones (relative differences) and the
    probe loss's absolute difference."""
    ref = out['unsharded']
    got = {}
    for leg, r in out['legs'].items():
        steps = r['losses'] + (r['resume']['losses'] if 'resume' in r
                               else [])
        want = ref['steps'][:len(r['losses'])] + (
            ref['steps'][len(r['losses']):len(steps)])
        got[leg] = {
            'loss_rel': [abs(a[0] - b[0]) / abs(b[0])
                         for a, b in zip(steps, want)],
            'norm_rel': [abs(a[1] - b[1]) / b[1]
                         for a, b in zip(steps, want)],
            'probe_abs': abs(r['probe_loss'] - ref['probe_loss']),
            'replicated_equal': r['replicated_equal']}
    extra = out['extra_legs']
    if 'pipe' in extra:
        got['pipe'] = {key: extra['pipe'][key] for key in (
            'logits_rel', 'loss_rel', 'grad_norm_rel', 'worst_leaf',
            'logits_equal', 'replicated_equal')}
    if 'expert' in extra:
        r = extra['expert']
        got['expert'] = {
            'loss_rel': [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(
                r['losses'], ref['moe']['steps'])],
            'norm_rel': [abs(a[1] - b[1]) / b[1] for a, b in zip(
                r['losses'], ref['moe']['steps'])],
            'ranks_agree': r['ranks_agree'],
            'replicated_equal': r['replicated_equal']}
    return got


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print('mesh_fault_check: needs a CUDA device', file=sys.stderr)
        return 2
    import chip_smoke
    chip_smoke.bytecode_cache()
    from skypilot_tpu_torch.ops import _build
    _build.library()
    faults = argv or list(FAULT_LEGS)
    unknown = [f for f in faults if f not in FAULT_LEGS]
    if unknown:
        print(f'mesh_fault_check: unknown faults {unknown}; known: '
              f'{sorted(FAULT_LEGS)}', file=sys.stderr)
        return 2
    legs = {leg[0]: leg for leg in chip_smoke.MT_LEGS}
    ok = True
    t0 = time.perf_counter()
    for fault in [None] + faults:
        names = legs if fault is None else FAULT_LEGS[fault]
        run_legs = tuple(legs[name] for name in names if name in legs)
        extra = (chip_smoke.MT_EXTRA_LEGS if fault is None else
                 tuple(n for n in FAULT_LEGS[fault]
                       if n in chip_smoke.MT_EXTRA_LEGS))
        out = chip_smoke.mesh_train_phase(torch, legs=run_legs, fault=fault,
                                          extra=extra)
        broken = out['faults']
        caught = bool(broken) if fault else not broken
        ok &= caught
        print(json.dumps({'fault': fault, 'caught' if fault else 'sound':
                          caught, 'broken': broken,
                          'readings': readings(out),
                          'phase_s': out['phase_s']}), flush=True)
    print(json.dumps({'ok': ok, 'seconds': time.perf_counter() - t0,
                      'limits': {'loss_rel': chip_smoke.TOL_MT_LOSS_REL,
                                 'norm_rel': chip_smoke.TOL_MT_NORM_REL,
                                 'probe_abs': chip_smoke.TOL_MT_PROBE,
                                 'pipe_logits_rel':
                                     chip_smoke.TOL_PIPE_LOGITS_REL,
                                 'pipe_loss_rel': chip_smoke.TOL_PIPE_LOSS_REL,
                                 'pipe_norm_rel':
                                     chip_smoke.TOL_PIPE_NORM_REL}}),
          flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
