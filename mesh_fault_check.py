"""Plant faults in the mesh training and serving paths and check that
chip_smoke's mesh_train and tp_serve limits catch each one.

    python3 mesh_fault_check.py [FAULT ...]

Runs chip_smoke's `mesh_train_phase` once sound (every leg), then once
per training fault with the fault planted in the rank processes
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
The serving faults run chip_smoke's `tp_serve_phase` once sound (the
bf16, spec, migration and moe legs), then once per fault planted in its
ranks (`chip_smoke.tp_plant`) on the legs it touches
(`chip_smoke.TP_FAULT_LEGS`):
- serve_expert_not_reduced: the expert outputs not all-reduced over
  `expert` on the serving path: the moe leg;
- draft_off_mesh: the draft's layers run off the mesh in the
  speculative rounds (its row-parallel products unreduced): the spec
  leg;
- snapshot_rank0_heads: the snapshot packs rank 0's KV heads in every
  rank's place; restore_rank0_heads: the restore hands every rank rank
  0's heads: the migration leg;
- fsdp_layer_ungathered: each layer's weights read from rank 0's fsdp
  shard alone, never gathered whole; fsdp_weights_whole: every rank
  keeping each weight whole: the fsdp leg;
- context_lse_unmerged: the context ranks' partials folded by a bare
  logaddexp, a span with no visible key left at lse = +inf;
  context_write_other_span: each context rank writes every new position
  into its own span; context_cache_whole: every rank keeping the whole
  cache; context_masked_unlaunched: a rank's chunk that sees no key of
  its span taken without its K1/K2 launch: the context leg.
These count only where their named gate breaks
(`chip_smoke.TP_FAULT_GATES`: the fsdp logits and weight bytes, the
context bf16 logits, the context spans' layer-0 K rows, the context
bf16 cache bytes and launches); the gates a fault broke beside its
named one are listed as `other_broken`, and a fault of
`chip_smoke.TP_FAULTS_ALONE` (outputs unchanged) counts only with none.
Prints one JSON line a run (its limits' readings and the limits it
broke) and exits non-zero unless each sound run breaks none and every
fault breaks at least one. A serving run whose ranks failed counts as
caught only where a follower raised on the ranks' divergence (the
ranks-equal gate, `raised_gates`), never for any other error. Needs one
CUDA device; about 8 minutes for the training faults, about 10 for the
tensor and expert legs' four serving faults, about 5 for the fsdp and
context legs' six.
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


def serve_readings(out):
    """The numbers tp_serve's gates read on the legs a run took."""
    got = {}
    if 'spec' in out:
        got['spec'] = {k: out['spec'].get(k) for k in (
            'acceptance', 'ranks_tokens_equal', 'tokens_equal_bf16')}
    if 'migration' in out:
        got['migration'] = {k: out['migration'][k] for k in (
            'tokens_equal_bf16_per_rank', 'restored_bytes_equal_per_rank',
            'blob_kv_heads')}
    if 'moe' in out:
        got['moe'] = {k: out['moe'][k] for k in (
            'logits_rel_err', 'ranks_tokens_equal',
            'tokens_equal_unsharded')}
    if 'fsdp' in out:
        got['fsdp'] = {k: out['fsdp'][k] for k in (
            'logits_rel_err', 'ranks_tokens_equal',
            'tokens_equal_unsharded', 'launches_per_rank',
            'weight_bytes_per_rank')}
    if 'context' in out:
        got['context'] = {'span_rel_err': out['context']['span_rel_err'],
                          **{key: {k: out['context'][key][k] for k in (
                              'logits_rel_err', 'ranks_tokens_equal',
                              'tokens_equal_unsharded', 'launches_per_rank',
                              'cache_bytes_per_rank')}
                             for key in ('bf16', 'int8')}}
    return got


# A serving fault may set the ranks apart before a gate reads the run: a
# follower's host plan (its requests' last tokens among it) then leaves
# rank 0's, `InferenceEngine.follow` raises with this text and the gang
# fails. That is the ranks-equal gate, checked in the run.
DIVERGED = 'the replicas diverged'


def raised_gates(text):
    """The gates a tp_serve run that raised `text` broke: the ranks-equal
    gate where a rank's log holds DIVERGED, none otherwise (a run that
    failed for another reason caught nothing)."""
    if DIVERGED in text:
        return ["ranks_equal: a follower's host plan left rank 0's "
                f'({DIVERGED!r} in its log)']
    return []


def named_gates(fault, broken):
    """The broken gates a fault is counted by: those of its named gate
    (`chip_smoke.TP_FAULT_GATES`) where it has one, else every one."""
    import chip_smoke
    gate = chip_smoke.TP_FAULT_GATES.get(fault)
    return broken if gate is None else [b for b in broken
                                        if b.startswith(gate)]


def check_serving(torch, chip_smoke, faults):
    """The sound tp_serve legs, then each serving fault on its legs;
    True when the sound run raises nothing and breaks no gate, and every
    fault breaks a named gate (`out['faults']`, or `raised_gates`)."""
    import numpy as np

    from skypilot_tpu_torch import inference
    from skypilot_tpu_torch.ops import flash_attention as fa
    sound = tuple(leg for leg in chip_smoke.TP_LEGS if any(
        leg in chip_smoke.TP_FAULT_LEGS[f] for f in faults))
    ok = True
    for fault in [None] + faults:
        legs = sound if fault is None else chip_smoke.TP_FAULT_LEGS[fault]
        t0 = time.perf_counter()
        raised = None
        try:
            out, _ = chip_smoke.tp_serve_phase(
                torch, inference, fa, np.random.default_rng(10), legs=legs,
                fault=fault)
            every = out['faults']
            broken, readings = named_gates(fault, every), serve_readings(out)
        except AssertionError as e:
            raised = str(e)
            every = broken = raised_gates(raised)
            readings = {}
        other = [b for b in every if b not in broken]
        caught = (bool(broken) and not (
            fault in chip_smoke.TP_FAULTS_ALONE and other)) if fault else \
            not broken and raised is None
        ok &= caught
        line = {'fault': fault, 'caught' if fault else 'sound': caught,
                'broken': broken, 'other_broken': other,
                'readings': readings,
                'phase_s': time.perf_counter() - t0}
        if raised is not None:
            at = raised.find(DIVERGED)
            line['raised'] = (raised[max(0, at - 300):at + 100] if at >= 0
                              else raised[-2000:])
        print(json.dumps(line), flush=True)
    return ok


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print('mesh_fault_check: needs a CUDA device', file=sys.stderr)
        return 2
    import chip_smoke
    chip_smoke.bytecode_cache()
    from skypilot_tpu_torch.ops import _build
    _build.library()
    faults = argv or list(FAULT_LEGS) + list(chip_smoke.TP_FAULT_LEGS)
    unknown = [f for f in faults if f not in FAULT_LEGS
               and f not in chip_smoke.TP_FAULT_LEGS]
    if unknown:
        print(f'mesh_fault_check: unknown faults {unknown}; known: '
              f'{sorted(FAULT_LEGS) + sorted(chip_smoke.TP_FAULT_LEGS)}',
              file=sys.stderr)
        return 2
    serving = [f for f in faults if f in chip_smoke.TP_FAULT_LEGS]
    faults = [f for f in faults if f in FAULT_LEGS]
    legs = {leg[0]: leg for leg in chip_smoke.MT_LEGS}
    ok = True
    t0 = time.perf_counter()
    if serving:
        ok &= check_serving(torch, chip_smoke, serving)
    for fault in ([None] + faults) if faults else []:
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
