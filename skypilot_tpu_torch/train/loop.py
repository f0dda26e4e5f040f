"""fit(): the training loop on a mesh or one device, with checkpoint
and resume.

    python -m skypilot_tpu_torch.train.loop --model gemma2-2b \
        --batch-size 1 --seq-len 8192 --max-steps 100 \
        --checkpoint-dir /ckpts/run1 [--checkpoint HF_OR_TRAIN_DIR]

A mesh runs one process per device, each started with the gang
variables (SKYTPU_COORDINATOR_ADDR=host:port of process 0,
SKYTPU_NUM_PROCESSES, SKYTPU_PROCESS_ID; SKYTPU_TORCH_DIST_BACKEND=gloo
for several ranks on one card) and the same flags:

    SKYTPU_PROCESS_ID=$i python -m skypilot_tpu_torch.train.loop \
        --model bench-8b --mesh fsdp=-1 --batch-size 2 --seq-len 4096

Ports `skypilot_tpu/train/loop.py`: `_save_with_retries` (:26-39), `fit`
(:44-156) and `main` (:161-195), with the same flags plus `--device`
(default CUDA; `--device cpu` runs the plain paths on the CPU). A run
resumes from the latest complete step in `--checkpoint-dir` (a managed
job's relaunch after a preemption), saves every `--checkpoint-every`
steps and at the end, and with `--checkpoint` starts a fine-tune from
an HF safetensors directory or a port train checkpoint (resume wins
over it). Saves go through `train/checkpoints.py` under the shared
retry policy. Each log window logs its loss, tokens/s and MFU through
`log_fn` and records them in the result's `history`. Every step reports
through the port's instruments at the reference's points (:135-147):
`TRAIN_STEP_SECONDS` (the step's wall time, asynchronous dispatch
included: the loss read of a log window is the only sync),
`TRAIN_TOKENS` (the global batch's tokens) and `TRAIN_STEP`; each log
window sets `TRAIN_MFU` (over the world's chips) and `TRAIN_LOSS`.
`main` builds its mesh with `mesh_from_env(MeshSpec.parse(--mesh))`
(default `fsdp=-1`: every rank of the gang on the fsdp axis), as the
reference's :185-187; the trainer takes every axis (`pipe` and, for a
dense model, `expert` replicate it; an MoE's experts are cut over
`expert`).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Optional

import torch

from skypilot_tpu_torch import envs
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.observability import instruments as obs
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.resilience import retries
from skypilot_tpu_torch.train import checkpoints
from skypilot_tpu_torch.train import trainer as trainer_lib


def _save_with_retries(checkpoint_dir: str, state: Dict[str, Any],
                       step: int, mesh: Optional[Any] = None,
                       config: Optional[Any] = None) -> None:
    """A transient save failure (a storage blip) must not kill a long
    run: retry under the shared policy; give up only after the budget
    and let the caller's exception surface. Under a mesh every rank
    calls it and sees rank 0's failure, so all retry together."""
    retries.call(
        lambda: checkpoints.save_train_state(checkpoint_dir, state,
                                             step=step, mesh=mesh,
                                             config=config),
        policy=retries.RetryPolicy(
            max_attempts=3,
            base_delay=envs.SKYTPU_CKPT_RETRY_GAP.get(),
            max_delay=30.0),
        retry_on=(Exception,),
        describe=f'checkpoint save step {step}')


def _adopt(params: Dict[str, Any], loaded: Dict[str, Any]) -> None:
    """Copy `loaded` into the train state's `params`, leaf for leaf, in
    place and in the state's dtype; a structure or shape mismatch raises
    ValueError."""
    if sorted(params) != sorted(loaded):
        raise ValueError(f'tree structure: model leaves {sorted(params)} '
                         f'vs checkpoint {sorted(loaded)}')
    for key, cur in params.items():
        new = loaded[key]
        if isinstance(cur, dict):
            _adopt(cur, new)
            continue
        if cur.shape != new.shape:
            raise ValueError(
                f'--checkpoint geometry mismatch: leaf shape '
                f'{tuple(new.shape)} vs model {tuple(cur.shape)} — does '
                f'--model match the checkpoint?')
        with torch.no_grad():
            cur.copy_(new.to(cur.dtype))


def _local_batch(batch: Dict[str, Any], cfg: trainer_lib.TrainerConfig,
                 cuts: Dict[str, Any]) -> Dict[str, Any]:
    """A batch of the global shape cut to this rank's slice
    (`trainer.batch_shardings`); a batch already cut is kept."""
    if tuple(batch['tokens'].shape) != (cfg.batch_size, cfg.seq_len):
        return batch
    return {k: cuts[k](v).contiguous() if k in cuts else v
            for k, v in batch.items()}


def fit(cfg: trainer_lib.TrainerConfig,
        mesh: trainer_lib.Where = None,
        batch_fn: Optional[Callable[[int], Dict[str, Any]]] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 100,
        log_every: int = 10,
        init_checkpoint: Optional[str] = None,
        log_fn=print) -> Dict[str, Any]:
    """Train to cfg.max_steps on `mesh` (a `parallel.Mesh`, every rank
    calling fit; or a device, None = CUDA, for one device); resume from
    checkpoint_dir if it holds a complete step (saved under any mesh).

    `init_checkpoint` seeds the starting params (the fine-tune case): an
    HF safetensors dir streams in through the importer, a port train
    checkpoint restores its params; a resume checkpoint in
    `checkpoint_dir` wins over it. Without `batch_fn` every step trains
    on one fixed synthetic batch; under a mesh a batch of the global
    shape is cut to this rank's slice. The loss is read (a host sync)
    once per log window, as in the reference. Returns {'state',
    'metrics', 'final_step', 'history'}, where `history` holds one dict
    per log window: step, loss, the window's wall seconds per step,
    tokens/s and MFU (None where `PEAK_FLOPS` has no entry for the
    device)."""
    mesh = trainer_lib.placement(mesh)
    dev = mesh.device
    mcfg = cfg.model_config()
    state = trainer_lib.make_train_state(cfg, mesh)
    cuts = llama.shard_tree(mcfg, mesh)
    start_step = 0
    if checkpoint_dir is not None:
        step = checkpoints.latest_step(checkpoint_dir)
        if step is not None:
            checkpoints.restore_train_state(checkpoint_dir, state, step=step,
                                            shardings=cuts)
            start_step = step
            log_fn(f'[fit] resumed from step {step}')

    if init_checkpoint is not None and start_step == 0:
        loaded = checkpoints.restore_params(
            init_checkpoint, mcfg if mesh.world_size > 1 else None,
            device=dev, mesh=mesh)
        try:
            _adopt(state['params'], loaded)
        except ValueError as e:
            # Lead with what the operator must fix.
            raise ValueError(
                f'--checkpoint geometry mismatch: {init_checkpoint!r} '
                f'does not hold params for model {cfg.model!r} '
                '(different family knobs — tied embeddings, biases, '
                f'post-norms — or sizes): {str(e)[:500]}') from None
        del loaded
        log_fn(f'[fit] initialized params from {init_checkpoint}')

    step_fn = trainer_lib.make_train_step(cfg, mesh)
    if batch_fn is None:
        fixed = trainer_lib.synthetic_batch(cfg, mesh)
        batch_fn = lambda i: fixed  # noqa: E731
    batch_cuts = trainer_lib.batch_shardings(mesh)

    peak = trainer_lib.PEAK_FLOPS.get(trainer_lib.detect_chip(dev))
    tokens_per_step = cfg.batch_size * cfg.seq_len
    history = []
    metrics: Dict[str, Any] = {}
    t_last = time.perf_counter()
    t_step = t_last
    for i in range(start_step, cfg.max_steps):
        state, metrics = step_fn(state, _local_batch(batch_fn(i), cfg,
                                                     batch_cuts))
        # The serving planes' registry: per-step wall time (dispatch
        # included; no sync is added for it), tokens and progress.
        now = time.perf_counter()
        obs.TRAIN_STEP_SECONDS.observe(now - t_step)
        t_step = now
        obs.TRAIN_TOKENS.inc(tokens_per_step)
        obs.TRAIN_STEP.set(i + 1)
        if (i + 1) % log_every == 0:
            loss = float(metrics['loss'])
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            tps = tokens_per_step * log_every / dt
            mfu = (trainer_lib.mfu(tps, mcfg, cfg.seq_len, peak,
                                   mesh.world_size) if peak else None)
            if mfu is not None:
                obs.TRAIN_MFU.set(mfu)
            obs.TRAIN_LOSS.set(loss)
            history.append({'step': i + 1, 'loss': loss,
                            'step_s': dt / log_every,
                            'tokens_per_s': tps, 'mfu': mfu})
            mfu_text = f'{mfu:.2%}' if mfu is not None else 'n/a'
            log_fn(f'[fit] step {i + 1}/{cfg.max_steps} '
                   f'loss={loss:.4f} tokens/s={tps:.0f} mfu={mfu_text}')
        if checkpoint_dir is not None and \
                (i + 1) % checkpoint_every == 0:
            _save_with_retries(checkpoint_dir, state, i + 1, mesh, mcfg)
    if checkpoint_dir is not None and \
            checkpoints.latest_step(checkpoint_dir) != cfg.max_steps:
        _save_with_retries(checkpoint_dir, state, cfg.max_steps, mesh, mcfg)
    return {'state': state, 'metrics': metrics,
            'final_step': cfg.max_steps, 'history': history}


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='tiny')
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--seq-len', type=int, default=512)
    parser.add_argument('--max-steps', type=int, default=100)
    parser.add_argument('--learning-rate', type=float, default=3e-4)
    parser.add_argument('--checkpoint-dir', default=None,
                        help='Train checkpoints go here (the port\'s '
                             'format); a relaunch resumes from its latest '
                             'complete step.')
    parser.add_argument('--checkpoint-every', type=int, default=100)
    parser.add_argument('--checkpoint', default=None,
                        help='Initial weights for a fine-tune: an HF '
                             'safetensors dir (streamed import) or a port '
                             'train checkpoint, layout auto-detected. A '
                             'resume checkpoint in --checkpoint-dir takes '
                             'precedence.')
    parser.add_argument('--mesh', default='fsdp=-1',
                        help='Comma-separated axis=size, e.g. '
                        'data=2,fsdp=4,tensor=2 (-1 fills): one process '
                        'per device, joined by the SKYTPU_* gang '
                        'variables.')
    parser.add_argument('--attention', default=None,
                        choices=['dense', 'blockwise', 'ring', 'flash'],
                        help='Override the preset attention impl '
                        '(ring = context-parallel long sequences).')
    parser.add_argument('--device', default=None,
                        help="Default CUDA; 'cpu' runs the plain paths.")
    args = parser.parse_args(argv)
    mesh = mesh_lib.mesh_from_env(mesh_lib.MeshSpec.parse(args.mesh),
                                  args.device)
    cfg = trainer_lib.TrainerConfig(
        model=args.model, batch_size=args.batch_size,
        seq_len=args.seq_len, max_steps=args.max_steps,
        learning_rate=args.learning_rate,
        attention_impl=args.attention)
    return fit(cfg, mesh, checkpoint_dir=args.checkpoint_dir,
               checkpoint_every=args.checkpoint_every,
               log_every=max(1, min(10, args.max_steps)),
               init_checkpoint=args.checkpoint)


if __name__ == '__main__':
    main()
