"""Device meshes for the port: named axes over one process per device.

Ports `skypilot_tpu/parallel/mesh.py`: `AXIS_ORDER` (:29), the axis
aliases and `canonical_axis` (:31-64), `MeshSpec` (:67-123),
`make_mesh` (:126), `make_hybrid_mesh` (:150), `use_mesh` (:181),
`initialize_distributed` (:190) and `mesh_from_env` (:226).

JAX drives every local chip from one process and lays a
`jax.sharding.Mesh` over them; PyTorch runs one process per device. So a
`Mesh` here is this process's view of the mesh: the resolved spec, its
rank and the world size, its device (`cuda:{rank % device_count}`, or
the CPU), and the process group of its `tensor` axis. Ranks are laid
out row-major over `AXIS_ORDER`, so the trailing axes (tensor, context)
hold consecutive ranks, which a launcher places on one host's NVLink,
and `data` is the outermost: the only axis that crosses slices
(`make_hybrid_mesh`). A one-process mesh needs no process group.

The collectives' backend is explicit: `nccl` on CUDA and `gloo` on the
CPU, unless SKYTPU_TORCH_DIST_BACKEND names one. NCCL refuses two ranks
on one device, so `make_mesh` raises before it builds an NCCL group
there; `gloo` serves that case (its CUDA paths stage through the host).
Every rank also joins a CPU `gloo` group over all ranks
(`Mesh.control_group`): the replicated scheduler's channel
(`parallel/control.py`).

`use_mesh` sets the ambient mesh, as the reference's does: the cached
forward (`models/llama.py`, `inference/engine.py`) reads it to find the
`tensor` group its reductions run over (`tensor_parallel`).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import math
import os
import socket
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

AXIS_ORDER = ('data', 'pipe', 'fsdp', 'expert', 'context', 'tensor')

# Aliases accepted from YAML / CLI knobs.
_AXIS_ALIASES = {
    'dp': 'data',
    'data_parallel': 'data',
    'pp': 'pipe',
    'pipeline': 'pipe',
    'pipeline_parallel': 'pipe',
    'stage': 'pipe',
    'zero': 'fsdp',
    'fsdp_parallel': 'fsdp',
    'ep': 'expert',
    'expert_parallel': 'expert',
    'sp': 'context',
    'cp': 'context',
    'sequence': 'context',
    'context_parallel': 'context',
    'ring': 'context',
    'tp': 'tensor',
    'model': 'tensor',
    'tensor_parallel': 'tensor',
}

# The port's copy of the slice-count variable the provisioner sets
# (`skypilot_tpu/skylet/constants.py`, ENV_MEGASCALE_NUM_SLICES).
ENV_MEGASCALE_NUM_SLICES = 'MEGASCALE_NUM_SLICES'

# How long a collective may wait for its peers before it raises: the
# rendezvous and the tensor group. The control group has its own, shorter
# limit (`parallel/control.py`).
_GROUP_TIMEOUT = datetime.timedelta(seconds=600)


def canonical_axis(name: str) -> str:
    name = name.lower()
    name = _AXIS_ALIASES.get(name, name)
    if name not in AXIS_ORDER:
        raise ValueError(
            f'Unknown mesh axis {name!r}; valid: {AXIS_ORDER} '
            f'(aliases: {sorted(_AXIS_ALIASES)})')
    return name


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named parallelism degrees. -1 on at most one axis means "fill".

    Examples:
        MeshSpec(fsdp=-1)                      # pure FSDP over all devices
        MeshSpec(data=2, fsdp=4, tensor=4)     # 32-device 3D mesh
        MeshSpec.from_dict({'dp': 2, 'tp': 8})
    """
    data: int = 1
    pipe: int = 1
    fsdp: int = -1
    expert: int = 1
    context: int = 1
    tensor: int = 1

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> 'MeshSpec':
        kwargs: Dict[str, int] = {}
        for key, value in d.items():
            axis = canonical_axis(key)
            if axis in kwargs and kwargs[axis] != int(value):
                raise ValueError(f'Axis {axis!r} specified twice via aliases')
            kwargs[axis] = int(value)
        return cls(**kwargs)

    @classmethod
    def parse(cls, arg: str) -> 'MeshSpec':
        """A 'tensor=2,fsdp=-1' argument, as the reference's
        build_engine splits it (`inference/__init__.py:52-55`)."""
        return cls.from_dict(dict(kv.split('=') for kv in arg.split(',')))

    def sizes(self) -> Dict[str, int]:
        return {axis: getattr(self, axis) for axis in AXIS_ORDER}

    def resolve(self, n_devices: int) -> 'MeshSpec':
        """Fill the single -1 axis so the product equals n_devices."""
        sizes = self.sizes()
        fill_axes = [a for a, s in sizes.items() if s == -1]
        if len(fill_axes) > 1:
            raise ValueError(f'At most one -1 axis allowed, got {fill_axes}')
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if fill_axes:
            if n_devices % fixed != 0:
                raise ValueError(
                    f'{n_devices} devices not divisible by fixed axes '
                    f'product {fixed} ({sizes})')
            sizes[fill_axes[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f'Mesh {sizes} needs {fixed} devices, have {n_devices}')
        return MeshSpec(**sizes)

    def axis_names(self) -> Tuple[str, ...]:
        return AXIS_ORDER

    def shape(self) -> Tuple[int, ...]:
        sizes = self.sizes()
        if any(s == -1 for s in sizes.values()):
            raise ValueError('Call resolve() before shape()')
        return tuple(sizes[a] for a in AXIS_ORDER)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's view of a resolved mesh (see the module docstring).
    `shape` maps axis -> size, as `jax.sharding.Mesh.shape` does."""
    spec: MeshSpec
    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str] = None
    tensor_group: Any = None
    tensor_rank: int = 0
    control_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return self.spec.sizes()

    @property
    def tensor_size(self) -> int:
        return self.spec.tensor


def _backend(device: torch.device) -> str:
    from skypilot_tpu_torch import envs
    name = envs.SKYTPU_TORCH_DIST_BACKEND.get()
    if name:
        return name
    return 'nccl' if device.type == 'cuda' else 'gloo'


def rank_device(process_id: int, device: Union[str, torch.device,
                                               None] = None
                ) -> torch.device:
    """The device a rank runs on: `cuda:{process_id % device_count}`,
    unless the caller names the CPU. Raises without CUDA (as
    `device.resolve_device`)."""
    from skypilot_tpu_torch import device as device_lib
    dev = device_lib.resolve_device(device)
    if dev.type != 'cuda':
        return dev
    return torch.device('cuda', process_id % torch.cuda.device_count())


def check_distinct_devices(backend: str,
                           placements: Sequence[Tuple[str, str]]) -> None:
    """Refuse NCCL where two ranks of one host share a device, given
    every rank's (host, device): NCCL cannot run them ("Duplicate GPU")
    and would fail or hang inside its first collective."""
    if backend != 'nccl':
        return
    seen: Dict[Tuple[str, str], int] = {}
    for rank, place in enumerate(placements):
        place = tuple(place)
        if place in seen:
            raise RuntimeError(
                f'ranks {seen[place]} and {rank} share {place[1]} on '
                f'{place[0]}: NCCL cannot run two ranks on one device. '
                'Give each rank its own GPU, or set '
                'SKYTPU_TORCH_DIST_BACKEND=gloo.')
        seen[place] = rank


def _tensor_groups(shape: Tuple[int, ...]) -> List[List[int]]:
    """The ranks of each `tensor` group: ranks that share every other
    coordinate, consecutive because tensor is the last axis."""
    t = shape[-1]
    return np.arange(math.prod(shape)).reshape(-1, t).tolist()


def make_mesh(spec: MeshSpec,
              device: Union[str, torch.device, None] = None) -> Mesh:
    """This process's `Mesh` of `spec`, resolved over the world of the
    default process group (one process without one). Builds the tensor
    groups (every rank takes part in building each) and the CPU control
    group. `device`: None for CUDA, or the CPU."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    try:
        spec = spec.resolve(world)
    except ValueError as e:
        if world > 1:
            raise
        raise ValueError(
            f'{e}: a mesh of several devices runs one process per device, '
            'each started with SKYTPU_COORDINATOR_ADDR, '
            'SKYTPU_NUM_PROCESSES and SKYTPU_PROCESS_ID') from None
    dev = rank_device(rank, device)
    if world == 1:
        return Mesh(spec, 0, 1, dev)
    backend = _backend(dev)
    placements: List[Any] = [None] * world
    dist.all_gather_object(placements, (socket.gethostname(), str(dev)))
    check_distinct_devices(backend, placements)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    tensor_group = None
    tensor_rank = 0
    for ranks in _tensor_groups(spec.shape()):
        group = dist.new_group(ranks, backend=backend,
                               timeout=_GROUP_TIMEOUT)
        if rank in ranks:
            tensor_group, tensor_rank = group, ranks.index(rank)
    from skypilot_tpu_torch.parallel import control
    control_group = dist.new_group(
        list(range(world)), backend='gloo',
        timeout=datetime.timedelta(seconds=control.TIMEOUT_SECONDS))
    return Mesh(spec, rank, world, dev, backend, tensor_group, tensor_rank,
                control_group)


def make_hybrid_mesh(spec: MeshSpec, num_slices: int,
                     device: Union[str, torch.device, None] = None) -> Mesh:
    """Multi-slice mesh: `data` is the only axis that crosses slices. The
    rank-major layout already puts `data` outermost, so each slice holds
    whole data shards once its ranks are numbered slice by slice."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    sizes = spec.resolve(world).sizes()
    if sizes['data'] % num_slices != 0:
        raise ValueError(
            f"data axis ({sizes['data']}) must be a multiple of "
            f'num_slices ({num_slices}): only data parallel crosses '
            'slices')
    return make_mesh(spec, device)


_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    'skytpu_mesh', default=None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Set the ambient mesh for the block (this thread's context)."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def tensor_parallel() -> Optional[Mesh]:
    """The ambient mesh when its `tensor` axis is larger than 1, else
    None: what the forward's reductions key on."""
    mesh = _AMBIENT.get()
    return mesh if mesh is not None and mesh.tensor_size > 1 else None


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """`torch.distributed.init_process_group` (gloo, the control channel;
    each mesh axis gets its own group in `make_mesh`) from the SKYTPU_*
    gang coordinates: SKYTPU_COORDINATOR_ADDR (host:port of process 0),
    SKYTPU_NUM_PROCESSES and SKYTPU_PROCESS_ID. The count and id parse
    strictly (a malformed or empty value raises: two processes at id 0
    would hang the rendezvous). Returns False, with no process group,
    for a one-process job or without a coordinator; True once the group
    exists (idempotent)."""
    import torch.distributed as dist

    from skypilot_tpu_torch import envs
    coordinator = coordinator or envs.SKYTPU_COORDINATOR_ADDR.get()
    if num_processes is None:
        num_processes = envs.SKYTPU_NUM_PROCESSES.get(strict=True)
    if process_id is None:
        process_id = envs.SKYTPU_PROCESS_ID.get(strict=True)
    if num_processes <= 1 or not coordinator:
        return False
    if not 0 <= process_id < num_processes:
        raise ValueError(f'SKYTPU_PROCESS_ID={process_id} is outside '
                         f'[0, SKYTPU_NUM_PROCESSES={num_processes})')
    if dist.is_initialized():
        return True
    dist.init_process_group('gloo', init_method=f'tcp://{coordinator}',
                            world_size=num_processes, rank=process_id,
                            timeout=_GROUP_TIMEOUT)
    return True


def mesh_from_env(spec: Optional[MeshSpec] = None,
                  device: Union[str, torch.device, None] = None) -> Mesh:
    """One-call bootstrap: join the gang (if any), then build the mesh
    over every rank, hybrid across slices when MEGASCALE_NUM_SLICES says
    there are several."""
    initialize_distributed()
    spec = spec or MeshSpec()
    num_slices = int(os.environ.get(ENV_MEGASCALE_NUM_SLICES, '1'))
    if num_slices > 1:
        return make_hybrid_mesh(spec, num_slices, device)
    return make_mesh(spec, device)
