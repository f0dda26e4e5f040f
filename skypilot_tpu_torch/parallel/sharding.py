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
  full leaf to this rank's slice along every mesh axis its rules name
  (`embed` over `fsdp`, heads, MLP and vocab over `tensor`; a batch's
  `batch` over `data` x `fsdp` and `seq` over `context`,
  `batch_shard`);
- `shard` (the reference's `with_sharding_constraint`) has no
  counterpart: it places nothing the port computes.

A dimension cut by two axes at once takes GSPMD's order: the first axis
of the rule is the major one (`batch` over ('data', 'fsdp'): data index
times the fsdp degree plus the fsdp index). A dimension a degree does
not divide raises, where GSPMD would pad it, with one exception the
reference's tests serve: KV heads fewer than the tensor degree, which
divides by them, are replicated, so each rank keeps the KV head its
query heads read.
"""
from __future__ import annotations

import dataclasses
import math
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


def cut(n: int, parts: int, index: int, logical: Optional[str] = None,
        axes: Union[str, Tuple[str, ...]] = 'tensor') -> Tuple[int, int]:
    """[start, stop) of part `index` of a dimension of size `n` split
    `parts` ways over mesh `axes`. A replicable axis (KV heads) smaller
    than `parts`, which it divides, gives each part the one entry its
    group reads."""
    if n % parts == 0:
        size = n // parts
        return index * size, (index + 1) * size
    if logical in _REPLICABLE and parts % n == 0:
        start = index // (parts // n)
        return start, start + 1
    over = axes if isinstance(axes, str) else ' x '.join(axes)
    raise ValueError(
        f'{logical or "an axis"} of size {n} does not split over {over} '
        f'degree {parts}: the port shards only what divides (KV heads '
        'may also replicate when the degree is a multiple of them)')


@dataclasses.dataclass(frozen=True)
class Cut:
    """Dimension `dim` split `parts` ways over mesh `axes`, part `index`
    kept."""
    dim: int
    parts: int
    index: int
    logical: Optional[str] = None
    axes: Tuple[str, ...] = ('tensor',)

    def bounds(self, n: int) -> Tuple[int, int]:
        return cut(n, self.parts, self.index, self.logical, self.axes)


@dataclasses.dataclass(frozen=True)
class Shard:
    """Cut a leaf to one rank's slice: each `Cut` of `cuts` narrows its
    dimension (no cuts keep the leaf whole)."""
    cuts: Tuple[Cut, ...] = ()

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        shape = list(shape)
        for c in self.cuts:
            lo, hi = c.bounds(shape[c.dim])
            shape[c.dim] = hi - lo
        return tuple(shape)

    def __call__(self, leaf: torch.Tensor) -> torch.Tensor:
        for c in self.cuts:
            lo, hi = c.bounds(leaf.shape[c.dim])
            leaf = leaf.narrow(c.dim, lo, hi - lo)
        return leaf

    def place(self, full_shape: Sequence[int]) -> Tuple[slice, ...]:
        """This slice's index into the full leaf (a tuple of slices)."""
        index = [slice(None)] * len(full_shape)
        for c in self.cuts:
            lo, hi = c.bounds(full_shape[c.dim])
            index[c.dim] = slice(lo, hi)
        return tuple(index)

    def per_layer(self) -> 'Shard':
        """The cut of one layer of a leaf stacked over layers (its
        leading axis, which never cuts)."""
        if any(c.dim == 0 for c in self.cuts):
            raise ValueError('the layers axis of a stacked leaf does not cut')
        return Shard(tuple(dataclasses.replace(c, dim=c.dim - 1)
                           for c in self.cuts))


def leaf_shard(mesh: Any, logical_axes: Sequence[Optional[str]],
               rules: Optional[Rules] = None, rank: Optional[int] = None
               ) -> Shard:
    """The `Shard` of one leaf on this rank of `mesh` (or on `rank`):
    every dimension whose rule names mesh axes of size > 1 is cut over
    them, the first axis major."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    rank = mesh.rank if rank is None else rank
    sizes = mesh.spec.sizes()
    cuts = []
    for dim, (name, entry) in enumerate(zip(logical_axes,
                                            spec_for(logical_axes, rules))):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        axes = tuple(a for a in axes if sizes[a] > 1)
        if axes:
            cuts.append(Cut(dim, math.prod(sizes[a] for a in axes),
                            mesh_lib.index_along(mesh.spec, rank, axes),
                            name, axes))
    return Shard(tuple(cuts))


def batch_shard(mesh: Any, rules: Optional[Rules] = None) -> Shard:
    """The cut of a [batch, seq] array (tokens, mask) on this rank: the
    reference's `batch_shardings`, batch over ('data', 'fsdp') and seq
    over 'context'."""
    return leaf_shard(mesh, ('batch', 'seq'), rules)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """fn over the leaves of nested dicts (a tuple of logical axes is a
    leaf), with the matching leaves of `rest` as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_shardings(mesh: Any, logical_tree: Any,
                   rules: Optional[Rules] = None,
                   rank: Optional[int] = None) -> Any:
    """A pytree of logical-axis tuples -> the same pytree of `Shard`s
    (this rank's, or `rank`'s)."""
    return tree_map(lambda axes: leaf_shard(mesh, axes, rules, rank),
                    logical_tree)
