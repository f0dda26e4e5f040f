"""fit(): the training loop on one device, and its command line.

    python -m skypilot_tpu_torch.train.loop --model bench-8b \
        --batch-size 1 --seq-len 4096 --max-steps 20

Ports `skypilot_tpu/train/loop.py`: `fit` (:42-158) and `main`
(:161-195), with the same flags plus `--device` (default CUDA; `--device
cpu` runs the plain paths on the CPU). Each log window logs its loss,
tokens/s and MFU through `log_fn` and records them in the result's
`history`. Every step reports through the port's instruments at the
reference's points (:135-147): `TRAIN_STEP_SECONDS` (the step's wall
time, asynchronous dispatch included: the loss read of a log window is
the only sync), `TRAIN_TOKENS` and `TRAIN_STEP`; each log window sets
`TRAIN_MFU` and `TRAIN_LOSS`. Not ported yet, and refused rather than
ignored: checkpoints (`--checkpoint-dir`, `--checkpoint`; ROADMAP.md's
checkpoint slice) and a mesh of more than one device (`--mesh`; the
parallel slice).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Optional, Union

import torch

from skypilot_tpu_torch import device as device_lib
from skypilot_tpu_torch.observability import instruments as obs
from skypilot_tpu_torch.train import trainer as trainer_lib

_CHECKPOINT_SLICE = ('checkpoints are not ported yet: they come with the '
                     'checkpoint slice (ROADMAP.md, Queue 1)')


def fit(cfg: trainer_lib.TrainerConfig,
        device: Optional[Union[str, torch.device]] = None,
        batch_fn: Optional[Callable[[int], Dict[str, Any]]] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 100,
        log_every: int = 10,
        init_checkpoint: Optional[str] = None,
        log_fn=print) -> Dict[str, Any]:
    """Train to cfg.max_steps on one device from random params.

    Without `batch_fn` every step trains on one fixed synthetic batch.
    The loss is read (a host sync) once per log window, as in the
    reference. Returns {'state', 'metrics', 'final_step', 'history'},
    where `history` holds one dict per log window: step, loss, the
    window's wall seconds per step, tokens/s and MFU (None where
    `PEAK_FLOPS` has no entry for the device)."""
    del checkpoint_every
    if checkpoint_dir is not None or init_checkpoint is not None:
        raise NotImplementedError(_CHECKPOINT_SLICE)
    dev = device_lib.resolve_device(device)
    state = trainer_lib.make_train_state(cfg, dev)
    step_fn = trainer_lib.make_train_step(cfg, dev)
    if batch_fn is None:
        fixed = trainer_lib.synthetic_batch(cfg, dev)
        batch_fn = lambda i: fixed  # noqa: E731

    mcfg = cfg.model_config()
    peak = trainer_lib.PEAK_FLOPS.get(trainer_lib.detect_chip(dev))
    tokens_per_step = cfg.batch_size * cfg.seq_len
    history = []
    metrics: Dict[str, Any] = {}
    t_last = time.perf_counter()
    t_step = t_last
    for i in range(cfg.max_steps):
        state, metrics = step_fn(state, batch_fn(i))
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
            mfu = (trainer_lib.mfu(tps, mcfg, cfg.seq_len, peak)
                   if peak else None)
            if mfu is not None:
                obs.TRAIN_MFU.set(mfu)
            obs.TRAIN_LOSS.set(loss)
            history.append({'step': i + 1, 'loss': loss,
                            'step_s': dt / log_every,
                            'tokens_per_s': tps, 'mfu': mfu})
            mfu_text = f'{mfu:.2%}' if mfu is not None else 'n/a'
            log_fn(f'[fit] step {i + 1}/{cfg.max_steps} '
                   f'loss={loss:.4f} tokens/s={tps:.0f} mfu={mfu_text}')
    return {'state': state, 'metrics': metrics,
            'final_step': cfg.max_steps, 'history': history}


def _one_device_mesh(spec: str) -> None:
    """Accept only a mesh spec that resolves to one device: every axis
    of size 1 or -1 (fill)."""
    sizes = {}
    for part in spec.split(','):
        axis, _, size = part.partition('=')
        sizes[axis.strip()] = int(size)
    if any(s not in (1, -1) for s in sizes.values()):
        raise NotImplementedError(
            f'--mesh {spec!r} spans more than one device; the port trains '
            'on one device until the parallel slice (ROADMAP.md, Queue 1)')


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='tiny')
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--seq-len', type=int, default=512)
    parser.add_argument('--max-steps', type=int, default=100)
    parser.add_argument('--learning-rate', type=float, default=3e-4)
    parser.add_argument('--checkpoint-dir', default=None,
                        help='Not ported yet (raises).')
    parser.add_argument('--checkpoint-every', type=int, default=100)
    parser.add_argument('--checkpoint', default=None,
                        help='Not ported yet (raises).')
    parser.add_argument('--mesh', default='fsdp=-1',
                        help='Comma-separated axis=size; only a one-device '
                        'mesh is accepted.')
    parser.add_argument('--attention', default=None,
                        choices=['dense', 'blockwise', 'ring', 'flash'],
                        help='Override the preset attention impl.')
    parser.add_argument('--device', default=None,
                        help="Default CUDA; 'cpu' runs the plain paths.")
    args = parser.parse_args(argv)
    if args.checkpoint_dir is not None or args.checkpoint is not None:
        raise NotImplementedError(_CHECKPOINT_SLICE)
    _one_device_mesh(args.mesh)
    cfg = trainer_lib.TrainerConfig(
        model=args.model, batch_size=args.batch_size,
        seq_len=args.seq_len, max_steps=args.max_steps,
        learning_rate=args.learning_rate,
        attention_impl=args.attention)
    return fit(cfg, args.device,
               log_every=max(1, min(10, args.max_steps)))


if __name__ == '__main__':
    main()
