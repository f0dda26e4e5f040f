"""Device meshes for the port: named axes over one process per device.

Ports `skypilot_tpu/parallel/mesh.py`: `AXIS_ORDER` (:29), the axis
aliases and `canonical_axis` (:31-64), `MeshSpec` (:67-123),
`make_mesh` (:126), `make_hybrid_mesh` (:150), `use_mesh` (:181),
`initialize_distributed` (:190) and `mesh_from_env` (:226).

JAX drives every local chip from one process and lays a
`jax.sharding.Mesh` over them; PyTorch runs one process per device. So a
`Mesh` here is this process's view of the mesh: the resolved spec, its
rank and the world size, its device (`cuda:{rank % device_count}`, or
the CPU), its coordinate on every axis, and the process groups its
collectives run over. Ranks are laid out row-major over `AXIS_ORDER`, so
the trailing axes (tensor, context) hold consecutive ranks, which a
launcher places on one host's NVLink, and `data` is the outermost: the
only axis that crosses slices (`make_hybrid_mesh`). A one-process mesh
needs no process group.

`make_mesh` builds one group per axis of size > 1 (the ranks that share
every other coordinate), plus the groups the trainer reduces over: the
batch group (`data` x `fsdp`, the axes the batch is cut along), the
gradient group (`data` x `fsdp` x `context`, every axis a gradient sums
over) and every other set of those axes, and the world.
`Mesh.group(axes)` returns the group of any of these axis sets (None
where it holds one rank). The layers read the `pipe` group (a stage's
index is `Mesh.index('pipe')`, its neighbours the group's ranks beside
it: `parallel/pipeline.py`) and the `expert` group (an MoE's experts,
`models/moe.py`).

The collectives' backend is explicit: `nccl` on CUDA and `gloo` on the
CPU, unless SKYTPU_TORCH_DIST_BACKEND names one. NCCL refuses two ranks
on one device, so `make_mesh` raises before it builds an NCCL group
there; `gloo` serves that case (`parallel/collectives.py` stages through
the host what gloo cannot take on CUDA). Every rank also joins a CPU
`gloo` group over all ranks (`Mesh.control_group`): the replicated
scheduler's channel (`parallel/control.py`) and the checkpoint writer's.

`use_mesh` sets the ambient mesh, as the reference's does: the forward
(`models/llama.py`, `inference/engine.py`) reads it to find the groups
its collectives run over (`tensor_parallel`, `current`).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import itertools
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
    # Axis tuple -> process group, for every axis set of `_GROUP_AXES`
    # that holds more than one rank (`group`).
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return self.spec.sizes()

    @property
    def tensor_size(self) -> int:
        return self.spec.tensor

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on every axis (row-major ranks)."""
        return coords_of(self.spec, self.rank)

    def index(self, axes: Union[str, Sequence[str]]) -> int:
        """This rank's index along `axes`, rank-major in the order given
        (GSPMD's order for a dimension cut by several axes)."""
        return index_along(self.spec, self.rank, axes)

    def group(self, axes: Union[str, Sequence[str]]) -> Any:
        """The process group of this rank along `axes`; None when they
        hold one rank. Raises for an axis set `make_mesh` did not
        build."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        live = tuple(a for a in AXIS_ORDER if a in axes
                     and self.spec.sizes()[a] > 1)
        if not live:
            return None
        if live not in self.groups:
            raise KeyError(f'no process group over {live} in this mesh '
                           f'(built: {sorted(self.groups)})')
        return self.groups[live]


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


# The axes a gradient sums over (the batch's data x fsdp and the
# sequence's context). Not `pipe` or `expert`: the batch is replicated
# over both (the reference's `batch` rule is ('data', 'fsdp')), so every
# rank along them computes the same gradient of a leaf they share; a
# pipeline stage's layers and an expert rank's experts are its own.
# The axis sets that get a process group (where they hold > 1 rank):
# each axis alone, every set of gradient axes (the batch group and the
# gradient group among them: a leaf cut along some of them reduces over
# the rest), and the world.
GRAD_AXES = ('data', 'fsdp', 'context')
_GROUP_AXES = (tuple((a,) for a in AXIS_ORDER)
               + tuple(c for n in (2, 3)
                       for c in itertools.combinations(GRAD_AXES, n))
               + (AXIS_ORDER,))


def coords_of(spec: MeshSpec, rank: int) -> Dict[str, int]:
    """A rank's coordinate on every axis of a resolved spec."""
    return dict(zip(AXIS_ORDER, (int(c) for c in np.unravel_index(
        rank, spec.shape()))))


def index_along(spec: MeshSpec, rank: int,
                axes: Union[str, Sequence[str]]) -> int:
    """A rank's index along `axes`, the first axis major."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    coords, sizes = coords_of(spec, rank), spec.sizes()
    index = 0
    for a in axes:
        index = index * sizes[a] + coords[a]
    return index


def axis_groups(shape: Tuple[int, ...], axes: Sequence[str]
                ) -> List[List[int]]:
    """The ranks of each group along `axes`: ranks that share every
    other coordinate, in rank order."""
    ranks = np.arange(math.prod(shape)).reshape(shape)
    keep = [i for i, a in enumerate(AXIS_ORDER) if a in axes]
    rest = [i for i in range(len(AXIS_ORDER)) if i not in keep]
    n = math.prod(shape[i] for i in keep)
    return np.transpose(ranks, rest + keep).reshape(-1, n).tolist()


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
    # Every rank takes part in building every group, in one order.
    groups: Dict[Tuple[str, ...], Any] = {}
    sizes = spec.sizes()
    for axes in _GROUP_AXES:
        live = tuple(a for a in AXIS_ORDER if a in axes and sizes[a] > 1)
        if not live or live in groups:
            continue
        for ranks in axis_groups(spec.shape(), live):
            group = dist.new_group(ranks, backend=backend,
                                   timeout=_GROUP_TIMEOUT)
            if rank in ranks:
                groups[live] = group
    tensor_group = groups.get(('tensor',))
    tensor_rank = coords_of(spec, rank)['tensor']
    from skypilot_tpu_torch.parallel import control
    control_group = dist.new_group(
        list(range(world)), backend='gloo',
        timeout=datetime.timedelta(seconds=control.TIMEOUT_SECONDS))
    return Mesh(spec, rank, world, dev, backend, tensor_group, tensor_rank,
                control_group, groups)


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


def ambient() -> Optional[Mesh]:
    """The ambient mesh as it was set (a one-rank mesh included)."""
    return _AMBIENT.get()


def current() -> Optional[Mesh]:
    """The ambient mesh when it spans more than one rank, else None."""
    mesh = _AMBIENT.get()
    return mesh if mesh is not None and mesh.world_size > 1 else None


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
