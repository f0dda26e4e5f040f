"""Logical-axis sharding rules for the port.

Ports `skypilot_tpu/parallel/sharding.py`: `DEFAULT_RULES` (:20),
`spec_for` (:34), `kv_page_axes` (:74) and `tree_shardings` (:110).

Model code names each parameter's axes logically ('embed', 'heads', ...)
and a rule table maps them to mesh axes, as in the reference. Under GSPMD
a sharding only places an array and the compiler inserts the
collectives; here every rank holds its own slice and the forward writes
its collectives out (`models/llama.py`, `inference/engine.py`). So:
- `spec_for` returns a plain tuple of mesh-axis entries (None, an axis,
  or a tuple of axes), `tuple(PartitionSpec)` of the reference's;
- `tree_shardings` gives each leaf a `Shard`, the function that cuts a
  full leaf to this rank's slice along its `tensor` axis;
- `shard` (the reference's `with_sharding_constraint`) has no
  counterpart: it places nothing the port computes.

Only the `tensor` axis cuts (the slice's serving mesh). A dimension the
tensor degree does not divide raises, where GSPMD would pad it, with one
exception the reference's tests serve: KV heads fewer than the tensor
degree, which divides by them, are replicated, so each rank keeps the KV
head its query heads read.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Optional, Sequence, Tuple,
                    Union)

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, MeshAxes]

# Default rules: FSDP shards params + optimizer state over ('data','fsdp'),
# tensor parallel splits heads/mlp, context parallel splits sequence.
DEFAULT_RULES: Rules = {
    'batch': ('data', 'fsdp'),
    'seq': 'context',
    'embed': ('fsdp',),
    'heads': 'tensor',
    'kv_heads': 'tensor',
    'head_dim': None,
    'mlp': 'tensor',
    'vocab': 'tensor',
    'expert': 'expert',
    'layers': None,
}

# The logical axis that may be replicated instead of cut.
_REPLICABLE = ('kv_heads',)


def spec_for(logical_axes: Sequence[Optional[str]],
             rules: Optional[Rules] = None) -> Tuple[MeshAxes, ...]:
    """logical axis names -> mesh-axis entries, one per dimension."""
    rules = DEFAULT_RULES if rules is None else rules
    entries = []
    used: set = set()
    for name in logical_axes:
        if name is None:
            entries.append(None)
            continue
        axes = rules.get(name)
        if axes is None:
            entries.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        # A mesh axis may appear only once per array; drop duplicates.
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        if not axes:
            entries.append(None)
        elif len(axes) == 1:
            entries.append(axes[0])
        else:
            entries.append(axes)
    return tuple(entries)


def kv_page_axes(ndim: int, stacked: bool = False
                 ) -> Tuple[Optional[str], ...]:
    """Logical axes of a paged-KV pool leaf (or its per-slot gathered
    view): the pool shards its KV-HEADS axis over 'tensor' and nothing
    else; page and position axes stay replicated, because the block
    tables and gather indices are host-built and identical on every
    rank, so each rank touches its own head slice of the same pages.

    Leaf ranks covered (quantized scale leaves drop the trailing D):
      stacked pool      [L, P, page, KV(, D)]  -> stacked=True
      per-layer pool    [P, page, KV(, D)]     -> stacked=False
      gathered view     [B, S, KV(, D)]        -> stacked=False
    """
    lead = 3 if stacked else 2
    if ndim not in (lead + 1, lead + 2):
        raise ValueError(
            f'kv_page_axes: rank-{ndim} leaf does not look like a '
            f'{"stacked " if stacked else ""}page-pool leaf')
    axes: Tuple[Optional[str], ...] = (None,) * lead + ('kv_heads',)
    if ndim == lead + 2:
        axes += (None,)
    return axes


def cut(n: int, parts: int, index: int, logical: Optional[str] = None
        ) -> Tuple[int, int]:
    """[start, stop) of part `index` of a dimension of size `n` split
    `parts` ways. A replicable axis (KV heads) smaller than `parts`,
    which it divides, gives each part the one entry its group reads."""
    if n % parts == 0:
        size = n // parts
        return index * size, (index + 1) * size
    if logical in _REPLICABLE and parts % n == 0:
        start = index // (parts // n)
        return start, start + 1
    raise ValueError(
        f'{logical or "an axis"} of size {n} does not split over tensor '
        f'degree {parts}: the port shards only what divides (KV heads '
        'may also replicate when the degree is a multiple of them)')


@dataclasses.dataclass(frozen=True)
class Shard:
    """Cut a leaf to one rank's slice: dimension `dim` split `parts`
    ways, part `index` kept (`dim` None keeps the leaf whole)."""
    dim: Optional[int] = None
    parts: int = 1
    index: int = 0
    logical: Optional[str] = None

    def bounds(self, n: int) -> Tuple[int, int]:
        return cut(n, self.parts, self.index, self.logical)

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        shape = tuple(shape)
        if self.dim is None:
            return shape
        lo, hi = self.bounds(shape[self.dim])
        return shape[:self.dim] + (hi - lo,) + shape[self.dim + 1:]

    def __call__(self, leaf: torch.Tensor) -> torch.Tensor:
        if self.dim is None:
            return leaf
        lo, hi = self.bounds(leaf.shape[self.dim])
        return leaf.narrow(self.dim, lo, hi - lo)

    def per_layer(self) -> 'Shard':
        """The cut of one layer of a leaf stacked over layers (its
        leading axis, which never cuts)."""
        if self.dim is None:
            return self
        if self.dim == 0:
            raise ValueError('the layers axis of a stacked leaf does not cut')
        return dataclasses.replace(self, dim=self.dim - 1)


def leaf_shard(mesh: Any, logical_axes: Sequence[Optional[str]],
               rules: Optional[Rules] = None) -> Shard:
    """The `Shard` of one leaf on this rank of `mesh`."""
    for dim, (name, entry) in enumerate(zip(logical_axes,
                                            spec_for(logical_axes, rules))):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        if 'tensor' in axes and mesh.tensor_size > 1:
            return Shard(dim, mesh.tensor_size, mesh.tensor_rank, name)
    return Shard()


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """fn over the leaves of nested dicts (a tuple of logical axes is a
    leaf), with the matching leaves of `rest` as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_shardings(mesh: Any, logical_tree: Any,
                   rules: Optional[Rules] = None) -> Any:
    """A pytree of logical-axis tuples -> the same pytree of `Shard`s."""
    return tree_map(lambda axes: leaf_shard(mesh, axes, rules), logical_tree)
