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
- Under a mesh (a save takes the mesh and the model config, a restore
  the state's cuts, `llama.shard_tree` of its params) the format stays
  the same, independent of the mesh, as the reference's Orbax
  checkpoints are:
  each file entry holds the full tensor. A save gathers every rank's
  slice to rank 0 over the CPU control group (`_gather_full`: one entry
  at a time, moved as its bytes, each slice placed by its rank's
  `Shard`), rank 0 writes the step and its sentinel, and every rank
  learns that it is durable before the save returns. A restore reads
  the full entries on every rank and keeps its cut, so a state saved
  under one mesh resumes under any other (or on one device).
- `save_train_state(wait=False)` copies every tensor to host memory
  before it returns (the train step updates the params in place), then
  writes in a background thread: its host peak is the whole state. An
  error in that thread is raised by `flush()`.
- An Orbax directory written by the JAX package raises
  NotImplementedError; `python -m skypilot_tpu.checkpoints export`
  turns one into an HF directory, which the port reads.
"""
from __future__ import annotations

import functools
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


def _entry_cuts(tree: Dict[str, Any], shardings: Optional[Dict[str, Any]]
                ) -> Dict[str, Any]:
    """The `Shard` of each file entry of `tree` (`_flat`'s names): a
    layer slice takes its stacked leaf's cut one dimension down. Without
    `shardings`, whole entries (an empty Shard each)."""
    from skypilot_tpu_torch.parallel import sharding
    if shardings is None:
        return {name: sharding.Shard() for name, _ in _flat(tree)}
    out = {}
    for name, _ in _flat(tree):
        parts = name.split('.')
        out[name] = (shardings['layers'][parts[1]].per_layer()
                     if parts[0] == 'layers' else shardings[name])
    return out


def _gather_full(tree: Dict[str, Any], mesh: Any, config: Any
                 ) -> Optional[Dict[str, torch.Tensor]]:
    """Every entry of a sharded tree put back whole on rank 0's host (on
    the other ranks, None): each rank's slice is gathered to rank 0 over
    the CPU control group as its bytes (gloo takes no bf16 or int16),
    and placed by that rank's `Shard` (replicated slices land on the same
    place)."""
    import torch.distributed as dist

    from skypilot_tpu_torch.models import llama as llama_lib
    from skypilot_tpu_torch.parallel import sharding
    logical = llama_lib.param_logical_axes(config)
    sizes = llama_lib.axis_sizes(config)
    every = [_entry_cuts(tree, sharding.tree_shardings(mesh, logical,
                                                       rank=r))
             for r in range(mesh.world_size)]
    out = {} if mesh.rank == 0 else None
    for name, local in _flat(tree):
        part = local.detach().to('cpu').contiguous()
        bits = part.view(torch.uint8)
        parts = ([torch.empty_like(bits) for _ in range(mesh.world_size)]
                 if mesh.rank == 0 else None)
        dist.gather(bits, parts, dst=0, group=mesh.control_group)
        if mesh.rank != 0:
            continue
        keys = name.split('.')
        axes = (logical['layers'][keys[1]][1:] if keys[0] == 'layers'
                else logical[name])
        full_shape = [sizes[a] for a in axes]
        full = torch.empty(full_shape, dtype=part.dtype)
        for r, got in enumerate(parts):
            full[every[r][name].place(full_shape)] = got.view(part.dtype)
        out[name] = full
    return out


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


def _save_sharded(path: str, trees, meta: Dict[str, Any], mesh: Any,
                  config: Any) -> None:
    """A mesh's save: every group gathered whole to rank 0
    (`_gather_full`), rank 0 writes the step and its sentinel, and every
    rank raises if rank 0's write failed (so every rank retries, or
    none)."""
    import torch.distributed as dist
    host = [(g, _gather_full(tree, mesh, config)) for g, tree in trees]
    error = None
    if mesh.rank == 0:
        try:
            _replace_dir(path)
            _write_step(path, host, meta)
        except Exception as e:  # noqa: BLE001 — every rank raises below
            error = f'{type(e).__name__}: {e}'
    del host
    errors: List[Any] = [None] * mesh.world_size
    dist.all_gather_object(errors, error, group=mesh.control_group)
    if errors[0] is not None:
        raise RuntimeError(f'checkpoint save of {path} failed on rank 0: '
                           f'{errors[0]}')


def _replace_dir(path: str) -> None:
    if os.path.exists(path):
        # An earlier save of this step (complete or torn) is replaced,
        # sentinel first so it is never a candidate half-overwritten.
        sentinel = os.path.join(path, COMPLETE_SENTINEL)
        if os.path.exists(sentinel):
            os.remove(sentinel)
        shutil.rmtree(path)
    os.makedirs(path)


def save_train_state(ckpt_dir: str, state: Dict[str, Any],
                     step: Optional[int] = None, wait: bool = True,
                     mesh: Optional[Any] = None,
                     config: Optional[Any] = None) -> str:
    """Save {params, opt_state (mu, nu, count), step} under
    ckpt_dir/<step>.

    wait=False returns once every tensor is copied to the host; a
    background thread writes the files and the sentinel (join it with
    `flush()`), so the step becomes visible to latest_step only when it
    is durable. Under a mesh of more than one rank (`mesh`, with the
    model `config` whose param axes cut the state) every rank calls it:
    the slices are gathered to rank 0, which writes the full entries,
    and the save returns on every rank once the step is durable
    (`wait` is ignored)."""
    if step is None:
        step = int(state.get('step', 0))
    path = _step_path(ckpt_dir, step)
    faults.inject('checkpoint.save')
    opt = state['opt_state']
    meta = {'format': FORMAT, 'step': int(step),
            'count': int(opt['count'])}
    trees = (('params', state['params']), ('mu', opt['mu']),
             ('nu', opt['nu']))
    if mesh is not None and mesh.world_size > 1:
        _save_sharded(path, trees, meta, mesh, config)
        return path
    _replace_dir(path)
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
                   tree: Dict[str, Any], where: str,
                   shardings: Optional[Dict[str, Any]] = None) -> None:
    """Copy every entry of `reader` into the matching slice of `tree`,
    in place, each cut to this rank's slice by `shardings` (the tree's
    `Shard`s; None: whole); names, shapes and dtypes must match
    exactly."""
    want = dict(_flat(tree))
    cuts = _entry_cuts(tree, shardings)
    have = set(reader.names())
    if set(want) != have:
        missing = sorted(set(want) - have)[:4]
        extra = sorted(have - set(want))[:4]
        raise ValueError(f'{where}: the checkpoint does not hold this '
                         f'state (missing {missing}, unexpected {extra})')
    with torch.no_grad():
        for name, dst in want.items():
            src = cuts[name](_host_tensor(reader.tensor(name)))
            if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                raise ValueError(
                    f'{where}: {name} is {src.dtype}{list(src.shape)} in '
                    f'the checkpoint, {dst.dtype}{list(dst.shape)} in the '
                    'state')
            dst.copy_(src)


def restore_train_state(ckpt_dir: str, state: Dict[str, Any],
                        step: Optional[int] = None,
                        shardings: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, Any]:
    """Restore `step` (default: the latest complete one) in place into
    `state`, a `trainer.make_train_state` of the same config on any
    device or mesh (`shardings`: its `llama.shard_tree`, which
    cut each full entry to this rank's slice); returns it. Every
    tensor's name, shape (after the cut) and dtype must match."""
    step = _resolve_step(ckpt_dir, step)
    path = _step_path(ckpt_dir, step)
    meta = read_state_file(ckpt_dir, step)
    opt = state['opt_state']
    for group, tree in (('params', state['params']), ('mu', opt['mu']),
                        ('nu', opt['nu'])):
        with safetensors_io.CheckpointReader(
                os.path.join(path, group)) as reader:
            _restore_group(reader, tree, os.path.join(path, group),
                           shardings)
    if state['params']['embed'].device.type == 'cuda':
        torch.cuda.synchronize(state['params']['embed'].device)
    opt['count'] = int(meta['count'])
    state['step'] = int(meta['step'])
    return state


def _read_params(path: str, device: torch.device,
                 config: Optional[Any] = None,
                 cuts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The params group of a step directory as the family's
    `init_params` tree on `device`, layer slices restacked. With
    `config` the entries must fit it (`check_geometry`, read from the
    header before any tensor is); with `cuts` (the tree's `Shard`s)
    each entry is cut to this rank's slice on the host, so the device
    never holds more than the slice."""
    from skypilot_tpu_torch.parallel import sharding
    top: Dict[str, safetensors_io.LazyTensor] = {}
    layers: Dict[str, Dict[int, safetensors_io.LazyTensor]] = {}
    with safetensors_io.CheckpointReader(path) as reader:
        for name in reader.names():
            parts = name.split('.')
            if parts[0] == 'layers' and len(parts) == 3:
                layers.setdefault(parts[1], {})[int(parts[2])] = \
                    reader.tensor(name)
            elif len(parts) == 1:
                top[name] = reader.tensor(name)
            else:
                raise ValueError(f'{path}: unexpected tensor {name!r}')
        for key, slices in layers.items():
            if sorted(slices) != list(range(len(slices))):
                raise ValueError(f'{path}: layers of {key!r} are '
                                 f'{sorted(slices)}, not 0..'
                                 f'{len(slices) - 1}')
        if config is not None:
            meta = functools.partial(torch.empty, device='meta')
            check_geometry({**{k: meta(t.shape) for k, t in top.items()},
                            'layers': {k: meta((len(v),) + v[0].shape)
                                       for k, v in layers.items()}},
                           config)
        cuts = cuts or {}
        layer_cuts = cuts.get('layers', {})
        out: Dict[str, Any] = {
            name: cuts.get(name, sharding.Shard())(_host_tensor(t)).to(
                device, copy=True)
            for name, t in top.items()}
        stacked = {}
        for key, slices in layers.items():
            cut = (layer_cuts[key].per_layer() if key in layer_cuts
                   else sharding.Shard())
            first = cut(_host_tensor(slices[0]))
            buf = torch.empty((len(slices),) + tuple(first.shape),
                              dtype=first.dtype, device=device)
            buf[0].copy_(first)
            for i in range(1, len(slices)):
                buf[i].copy_(cut(_host_tensor(slices[i])))
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
                   device: Optional[Union[str, torch.device]] = None,
                   mesh: Optional[Any] = None) -> Dict[str, Any]:
    """Just the model params (the inference and fine-tune path), on
    `device` (CUDA unless named; the mesh's device under `mesh`). An HF
    safetensors directory is auto-detected and streams in through
    `checkpoints.load_params` with its own config.json geometry (under a
    mesh, this rank's slices); otherwise the latest complete step of a
    port train checkpoint (under a mesh of more than one rank, each
    entry cut on the host by the `config`'s param axes). With `config`,
    train-checkpoint params must fit it (`check_geometry`)."""
    from skypilot_tpu_torch import checkpoints as hf_ckpts
    sharded = mesh is not None and mesh.world_size > 1
    dev = mesh.device if mesh is not None else device_lib.resolve_device(
        device)
    if hf_ckpts.is_hf_checkpoint(ckpt_dir):
        params, _detected, _stats = hf_ckpts.load_params(
            ckpt_dir, device=dev, mesh=mesh if sharded else None)
        return params
    step = _resolve_step(ckpt_dir, None)
    cuts = None
    if sharded:
        from skypilot_tpu_torch.parallel import sharding
        cuts = sharding.tree_shardings(mesh,
                                       llama.param_logical_axes(config))
    return _read_params(os.path.join(_step_path(ckpt_dir, step), 'params'),
                        dev, config, cuts)
