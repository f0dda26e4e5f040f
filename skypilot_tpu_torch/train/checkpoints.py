"""Training checkpoints for the port: save, resume and params restore.

Ports `skypilot_tpu/train/checkpoints.py`: `COMPLETE_SENTINEL`,
`save_train_state` (:43-79), `flush` (:82-87), `latest_step` (:90-106),
`restore_train_state` (:109-121) and `restore_params` (:135-160). The
reference writes Orbax, which the card cannot read, so the port writes
a format of its own:

    <ckpt_dir>/<step>/params/model.safetensors   the model params
    <ckpt_dir>/<step>/mu/model.safetensors       AdamW first moments
    <ckpt_dir>/<step>/nu/model.safetensors       AdamW second moments
    <ckpt_dir>/<step>/train_state.json           step and count
    <ckpt_dir>/<step>/.skytpu-complete           written last

Each group is one safetensors file (`safetensors_io.write_safetensors`:
the header from the tensors' shapes, then each tensor copied off the
device as it is written); a stacked `[L, ...]` leaf is written a layer
at a time, as `layers.<key>.<i>`, so the host holds one layer slice at
most, and no pickle is involved. The sentinel is written only after every file of
the step is flushed to disk (`os.fsync`), so a save killed part way is
never a resume candidate (`latest_step`).

Against the reference:
- `restore_train_state` restores in place into the tensors of a
  `trainer.make_train_state` on the device the caller chose. It
  replaces the reference's `abstract_train_state` (a `jax.eval_shape`
  of the state as Orbax's restore target), which torch does not need:
  the state's own tensors give every shape, dtype and device.
- There is no mesh: one device (the parallel slice, ROADMAP.md).
- `save_train_state(wait=False)` copies every tensor to host memory
  before it returns (the train step updates the params in place), then
  writes in a background thread: its host peak is the whole state. An
  error in that thread is raised by `flush()`.
- An Orbax directory written by the JAX package raises
  NotImplementedError; `python -m skypilot_tpu.checkpoints export`
  turns one into an HF directory, which the port reads.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from skypilot_tpu_torch import device as device_lib
from skypilot_tpu_torch.checkpoints import safetensors_io
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.resilience import faults

# Completeness sentinel: written only after every byte of the step is
# flushed; latest_step requires it.
COMPLETE_SENTINEL = '.skytpu-complete'
STATE_FILE = 'train_state.json'
SHARD = 'model.safetensors'
FORMAT = 'skypilot_tpu_torch.train_state/1'
# Marker files of an Orbax step directory (the JAX package's format).
_ORBAX_MARKERS = ('_METADATA', '_CHECKPOINT_METADATA', 'manifest.ocdbt',
                  '.orbax-checkpoint-tmp')

_pending_lock = threading.Lock()
_pending: List[threading.Thread] = []
_errors: List[Exception] = []


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(_abs(ckpt_dir), str(step))


def _flat(tree: Dict[str, Any]) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of a params-shaped tree, one per file entry: every
    leaf under 'layers' split into its layer slices."""
    for key in sorted(tree):
        value = tree[key]
        if key == 'layers':
            for sub in sorted(value):
                for i in range(value[sub].shape[0]):
                    yield f'layers.{sub}.{i}', value[sub][i]
        elif isinstance(value, dict):
            raise ValueError(f'unexpected subtree {key!r} in the state')
        else:
            yield key, value


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_step(path: str, groups: List[Tuple[str, Dict[str, Any]]],
                meta: Dict[str, Any]) -> None:
    """Write every group, the state file, fsync them all, then the
    sentinel (itself fsynced, with its directory)."""
    for group, tensors in groups:
        os.makedirs(os.path.join(path, group))
        safetensors_io.write_safetensors(
            os.path.join(path, group, SHARD), tensors,
            metadata={'format': 'pt'})
    with open(os.path.join(path, STATE_FILE), 'w', encoding='utf-8') as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    for root, _dirs, files in os.walk(path):
        for fn in files:
            _fsync(os.path.join(root, fn))
        _fsync(root)
    sentinel = os.path.join(path, COMPLETE_SENTINEL)
    with open(sentinel, 'w', encoding='utf-8') as f:
        f.write('complete\n')
        f.flush()
        os.fsync(f.fileno())
    _fsync(path)


def save_train_state(ckpt_dir: str, state: Dict[str, Any],
                     step: Optional[int] = None, wait: bool = True) -> str:
    """Save {params, opt_state (mu, nu, count), step} under
    ckpt_dir/<step>.

    wait=False returns once every tensor is copied to the host; a
    background thread writes the files and the sentinel (join it with
    `flush()`), so the step becomes visible to latest_step only when it
    is durable."""
    if step is None:
        step = int(state.get('step', 0))
    path = _step_path(ckpt_dir, step)
    faults.inject('checkpoint.save')
    opt = state['opt_state']
    meta = {'format': FORMAT, 'step': int(step),
            'count': int(opt['count'])}
    if os.path.exists(path):
        # An earlier save of this step (complete or torn) is replaced,
        # sentinel first so it is never a candidate half-overwritten.
        sentinel = os.path.join(path, COMPLETE_SENTINEL)
        if os.path.exists(sentinel):
            os.remove(sentinel)
        shutil.rmtree(path)
    os.makedirs(path)
    trees = (('params', state['params']), ('mu', opt['mu']),
             ('nu', opt['nu']))
    if wait:
        # The writer copies one tensor at a time off the device.
        _write_step(path, [(g, dict(_flat(tree))) for g, tree in trees],
                    meta)
        return path

    host = [(g, {n: t.detach().to('cpu', copy=True)
                 for n, t in _flat(tree)}) for g, tree in trees]

    def _finalize():
        try:
            _write_step(path, host, meta)
        except Exception as e:  # noqa: BLE001 — raised by flush()
            with _pending_lock:
                _errors.append(e)

    thread = threading.Thread(target=_finalize, daemon=True,
                              name=f'ckpt-save-{step}')
    with _pending_lock:
        # Prune finished savers: periodic async saves must not grow
        # this list for the life of the process.
        _pending[:] = [t for t in _pending if t.is_alive()]
        _pending.append(thread)
    thread.start()
    return path


def flush() -> None:
    """Join every in-flight async save; raise the first error one of
    them hit."""
    with _pending_lock:
        threads, _pending[:] = list(_pending), []
    for t in threads:
        t.join()
    with _pending_lock:
        errors, _errors[:] = list(_errors), []
    if errors:
        raise errors[0]


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest COMPLETE step. A step without the sentinel (killed
    mid-save, or an async save still writing) is never a resume
    candidate."""
    ckpt_dir = _abs(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        full = os.path.join(ckpt_dir, name)
        if (name.isdigit() and os.path.isdir(full)
                and os.path.exists(os.path.join(full, COMPLETE_SENTINEL))):
            steps.append(int(name))
    return max(steps) if steps else None


def is_orbax_checkpoint(path: str) -> bool:
    """Does `path` hold an Orbax step directory (the JAX package's
    train checkpoints)?"""
    path = _abs(path)
    if not os.path.isdir(path):
        return False
    for name in os.listdir(path):
        full = os.path.join(path, name)
        if name.isdigit() and os.path.isdir(full) and any(
                os.path.exists(os.path.join(full, m))
                for m in _ORBAX_MARKERS):
            return True
    return False


def _resolve_step(ckpt_dir: str, step: Optional[int]) -> int:
    """`step`, or the latest complete one, if it is a step of the port's
    format; an Orbax directory (the JAX package's, which writes the same
    sentinel) raises NotImplementedError, an empty one
    FileNotFoundError."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is not None and os.path.exists(
            os.path.join(_step_path(ckpt_dir, step), STATE_FILE)):
        return step
    if is_orbax_checkpoint(ckpt_dir):
        raise NotImplementedError(
            f'{ckpt_dir!r} is an Orbax train checkpoint of the JAX '
            'package, which the port does not read (the card has no '
            'Orbax; ROADMAP.md, Queue 1). Convert it with `python -m '
            'skypilot_tpu.checkpoints export --orbax DIR --model NAME '
            '--out HF_DIR` and pass the HF directory.')
    if step is None:
        raise FileNotFoundError(f'No checkpoint found under {ckpt_dir!r}')
    raise FileNotFoundError(
        f'{_step_path(ckpt_dir, step)} has no {STATE_FILE}: not a train '
        'checkpoint of the port')


def read_state_file(ckpt_dir: str, step: Optional[int] = None
                    ) -> Dict[str, Any]:
    """The state file of `step` (default: the latest complete one)."""
    path = _step_path(ckpt_dir, _resolve_step(ckpt_dir, step))
    with open(os.path.join(path, STATE_FILE), encoding='utf-8') as f:
        meta = json.load(f)
    if meta.get('format') != FORMAT:
        raise ValueError(f'{path}: unknown train-state format '
                         f'{meta.get("format")!r}, expected {FORMAT!r}')
    return meta


def _host_tensor(tensor: safetensors_io.LazyTensor) -> torch.Tensor:
    """An owned host copy of one entry (the mmap view dies here)."""
    return safetensors_io.to_torch(np.array(tensor.read()), tensor.tag)


def _restore_group(reader: safetensors_io.CheckpointReader,
                   tree: Dict[str, Any], where: str) -> None:
    """Copy every entry of `reader` into the matching slice of `tree`,
    in place; names, shapes and dtypes must match exactly."""
    want = dict(_flat(tree))
    have = set(reader.names())
    if set(want) != have:
        missing = sorted(set(want) - have)[:4]
        extra = sorted(have - set(want))[:4]
        raise ValueError(f'{where}: the checkpoint does not hold this '
                         f'state (missing {missing}, unexpected {extra})')
    with torch.no_grad():
        for name, dst in want.items():
            src = _host_tensor(reader.tensor(name))
            if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                raise ValueError(
                    f'{where}: {name} is {src.dtype}{list(src.shape)} in '
                    f'the checkpoint, {dst.dtype}{list(dst.shape)} in the '
                    'state')
            dst.copy_(src)


def restore_train_state(ckpt_dir: str, state: Dict[str, Any],
                        step: Optional[int] = None) -> Dict[str, Any]:
    """Restore `step` (default: the latest complete one) in place into
    `state`, a `trainer.make_train_state` of the same config on any
    device; returns it. Every tensor's name, shape and dtype must
    match."""
    step = _resolve_step(ckpt_dir, step)
    path = _step_path(ckpt_dir, step)
    meta = read_state_file(ckpt_dir, step)
    opt = state['opt_state']
    for group, tree in (('params', state['params']), ('mu', opt['mu']),
                        ('nu', opt['nu'])):
        with safetensors_io.CheckpointReader(
                os.path.join(path, group)) as reader:
            _restore_group(reader, tree, os.path.join(path, group))
    if state['params']['embed'].device.type == 'cuda':
        torch.cuda.synchronize(state['params']['embed'].device)
    opt['count'] = int(meta['count'])
    state['step'] = int(meta['step'])
    return state


def _read_params(path: str, device: torch.device) -> Dict[str, Any]:
    """The params group of a step directory as the family's
    `init_params` tree on `device`, layer slices restacked."""
    out: Dict[str, Any] = {}
    layers: Dict[str, Dict[int, safetensors_io.LazyTensor]] = {}
    with safetensors_io.CheckpointReader(path) as reader:
        for name in reader.names():
            parts = name.split('.')
            if parts[0] == 'layers' and len(parts) == 3:
                layers.setdefault(parts[1], {})[int(parts[2])] = \
                    reader.tensor(name)
            elif len(parts) == 1:
                out[name] = _host_tensor(reader.tensor(name)).to(device)
            else:
                raise ValueError(f'{path}: unexpected tensor {name!r}')
        stacked = {}
        for key, slices in layers.items():
            n = len(slices)
            if sorted(slices) != list(range(n)):
                raise ValueError(f'{path}: layers of {key!r} are '
                                 f'{sorted(slices)}, not 0..{n - 1}')
            first = _host_tensor(slices[0])
            buf = torch.empty((n,) + tuple(first.shape), dtype=first.dtype,
                              device=device)
            buf[0].copy_(first)
            for i in range(1, n):
                buf[i].copy_(_host_tensor(slices[i]))
            stacked[key] = buf
    out['layers'] = stacked
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    return out


def check_geometry(params: Dict[str, Any], config: Any) -> None:
    """Raise ValueError unless `params` has exactly the leaves and
    shapes the family's `init_params(config)` gives (the llama core's
    from `hf_import.param_specs`, MoE's from `moe.param_shapes`)."""
    from skypilot_tpu_torch.checkpoints import hf_import
    if isinstance(config, moe.MoeConfig):
        want = moe.param_shapes(config)
    else:
        want = {}
        for spec in hf_import.param_specs(config):
            shape = hf_import._engine_shape(spec, config)
            if spec.stacked:
                want[('layers', spec.key)] = (config.num_layers,) + shape
            else:
                want[(spec.key,)] = shape
    have = {}
    for key, value in params.items():
        if isinstance(value, dict):
            have.update({(key, k): tuple(v.shape) for k, v in value.items()})
        else:
            have[(key,)] = tuple(value.shape)
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))[:4]
        raise ValueError(
            f'params do not fit the config (num_layers '
            f'{config.num_layers}, hidden {config.hidden_size}, vocab '
            f'{config.vocab_size}); first differences, as (leaf, shape): '
            f'{diff}')


def restore_params(ckpt_dir: str,
                   config: Optional[llama.LlamaConfig] = None,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Dict[str, Any]:
    """Just the model params (the inference and fine-tune path), on
    `device` (CUDA unless named). An HF safetensors directory is
    auto-detected and streams in through `checkpoints.load_params` with
    its own config.json geometry; otherwise the latest complete step of
    a port train checkpoint. With `config`, train-checkpoint params must
    fit it (`check_geometry`)."""
    from skypilot_tpu_torch import checkpoints as hf_ckpts
    dev = device_lib.resolve_device(device)
    if hf_ckpts.is_hf_checkpoint(ckpt_dir):
        params, _detected, _stats = hf_ckpts.load_params(ckpt_dir,
                                                         device=dev)
        return params
    step = _resolve_step(ckpt_dir, None)
    params = _read_params(os.path.join(_step_path(ckpt_dir, step),
                                       'params'), dev)
    if config is not None:
        check_geometry(params, config)
    return params
