"""KV-cache inference engine in PyTorch: chunked paged prefill, fused decode.

Ports the serving path of `skypilot_tpu/inference/engine.py`.

Device math: `quantize_kv` (:92), `init_cache` (:344),
`_paged_read`/`_paged_write` (:138, :168), `_flash_prefill_ok` (:471),
`_cached_attention` (:488), `_attn_with_cache`, `_layer_with_cache`,
`_moe_layer_with_cache`, `_moe_hidden_with_cache` (:698-749),
`_hidden_with_cache`, `_project_logits` (:581-830), `prefill_chunked`
(:852), `prefill_chunk_at` (:941), `_sample` (:997), `decode_step`
(:1041), `fused_decode_steps` (:1067) and `fused_spec_rounds` (:1144),
the greedy draft-propose / verify / accept rounds of speculative decode.

Request state (:200-343): the page-pool and dense-row copies
(`_copy_pool_page`, `_gather_pool_pages`, `_splice_pool_pages`,
`_gather_dense_row`, `_splice_dense_row`) as plain indexed tensor copies
in place, and the migration blob (`SnapshotError`, `_snapshot_pack`,
`_snapshot_unpack`, `SNAPSHOT_VERSION`), byte-compatible with the
reference's `SKTPUSNP` v1 so the two engines trade requests.

Host side: `SamplingParams`, `_Slot`, `DecodeState` (with the draft
model's cache, :1360) and `InferenceEngine` (:1397) with its page
allocator and FIFO admission (`_insert_from_queue`), the radix prefix
cache with copy-on-write pages (`_reclaim`, `_enforce_cache_cap`,
`_cow_slot_page`, `_cow_guard`, publish in `_free_slot`), interleaved
and warm-tail prefill (`_advance_prefill`), snapshot/restore, the
planned prefill->decode handoff with its lease, speculative rounds
(`_spec_round`, :2730), eviction, abort and the `step()` loop. Page
bookkeeping follows the reference decision for decision (FIFO
allocator, the same `extend` orders), so the two engines hand out the
same page ids for the same request sequence.

Differences by design, each stated where it happens:
- The KV cache is updated IN PLACE (the reference returns a new,
  donated cache); functions that take a cache also return it, mutated,
  so call sites read like the reference's.
- `fused_decode_steps` is a Python loop of up to `n_steps` decode
  steps that stops once no slot is active (one `.any()` host sync per
  step), where the reference runs a `lax.while_loop`;
  `fused_spec_rounds` likewise checks once per round, never inside its
  draft decodes.
- Randomness comes from a `torch.Generator`; sampled tokens differ
  from `jax.random`'s, greedy tokens and logprobs do not.
- H100 policy: `use_flash` defaults on for CUDA (off on the CPU, where
  True runs the kernels' plain versions); `kv_quant='auto'` resolves to
  'none'; `_flash_prefill_ok` accepts what the CUDA kernel serves.
- Observability as the reference's, through the port's own copy
  (`skypilot_tpu_torch/observability`, `resilience/faults.py`): every
  `obs.*` instrument at the reference's points, the phase spans
  (`_trace_begin`/`_trace_phase`/`_trace_finish`/`_trace_exemplar`,
  :2172-2225: admission_wait, page_pool_wait, prefix_match, prefill,
  prefill_chunk, cow_copy, decode, spec_decode), the `engine.snapshot`
  and `engine.restore` spans and the `engine.snapshot` and
  `engine.handoff_lease` chaos seams. A phase that syncs ends at the
  host read that syncs it (`.tolist()`); none adds a device sync.
  The registry is process-global, so `InferenceEngine.stats` stays the
  per-engine view of the same counts (one process may run many
  engines). `_count` and `_observe_phase` write each count to both
  at once.
- The snapshot gathers only the request's pages, where the reference
  pads the gather to the table width so one XLA compile serves every
  request; nothing here compiles per shape.
- The MoE family (`models/moe.py`) serves at the reference's drop-free
  capacity (`InferenceEngine.__init__`). Its expert MLP adds no host
  sync where the routed rows are few (decode: `moe._moe_mlp`'s static
  path) and one per layer on a prefill chunk (its grouped path).

- Serving on a mesh (`mesh=`, reference :1455-1514) runs one process
  per device, over every axis the reference serves (`check_mesh`).
  Each rank holds its slice of the params (the family's
  `param_logical_axes` under `parallel.sharding.DEFAULT_RULES`: heads,
  MLP and vocab over `tensor`, an MoE's experts over `expert`, every
  weight's `embed` dim over `fsdp`; `data` and `pipe` replicate, as the
  reference's cached path places them) and of the cache
  (`init_cache(mesh=)`: KV heads over `tensor`, a dense cache's
  sequence over `context`, whole on every other rank), and runs the
  forward under `parallel.use_mesh`, whose groups carry the reductions
  `models/llama.py` and `models/moe.py` write out. Under `fsdp` the
  cached layer math gathers one layer's weights at a time
  (`_layer_at`, `llama.unshard`), the embedding, final norm and head as
  the forward does (`llama._whole`). Under `context` (reference
  :369-391, :452-456: a dense cache, no pages, so no prefix cache)
  each rank attends its span of keys and the ranks' (O, lse) merge
  over the `context` group (`_context_attention`,
  `_merge_over_context`): a prefill chunk through K1/K2 at the span's
  offset (negative for a span past the chunk's first rows, whose rows
  give lse = +inf and weigh 0), decode through the dense partial
  softmax; each rank writes only its span's positions (`_span_write`).
  The flash kernels run per rank on its own heads and span (the
  reference turns its Pallas kernel off under a mesh). A draft is cut
  as a llama, its cache sharded like the target's (reference
  :1384-1392, where GSPMD places the draft's params; here each rank's
  draft attends its own cache heads and span). The host side runs on
  every rank, replicated: rank 0
  publishes its host events once per step and the others follow
  (`parallel/control.py`, `follow`). A snapshot, a restore, a handoff
  resume and a lease's expiry are events too: rank 0 publishes a
  snapshot or a restore at once, then every rank joins the all-gather
  of the request's KV heads over its `tensor` group (rank 0 keeps the
  result) or the broadcast of the blob's leaves from rank 0 (each rank
  keeps its own heads), on the pool's device, so a blob carries every
  KV head, as an unsharded engine's does, and crosses packages and
  geometries; under `context` the request's dense row is all-gathered
  over the spans first, and each rank splices its span of a restored
  row.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import struct
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from skypilot_tpu_torch import device as device_lib
from skypilot_tpu_torch import envs
from skypilot_tpu_torch.inference import prefix_cache as prefix_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import moe as moe_lib
from skypilot_tpu_torch.observability import instruments as obs
from skypilot_tpu_torch.observability import spans
from skypilot_tpu_torch.ops import flash_attention as fa_lib
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import control as control_lib
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding as sharding_lib
from skypilot_tpu_torch.resilience import faults

Params = Dict[str, Any]
Cache = Dict[str, Any]
KV = Union[torch.Tensor, Dict[str, torch.Tensor]]

_NEG_INF = -1e30


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 0.0     # 0 => greedy
    top_k: int = 0               # 0 => no top-k filtering
    top_p: float = 1.0           # 1 => no nucleus filtering
    max_new_tokens: int = 128
    eos_token_id: Optional[int] = None

    def __post_init__(self):
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f'top_p must be in (0, 1], got {self.top_p}')


def quantize_kv(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[.., D] -> {'q': int8 [.., D], 's': f32 [..]}: per-(position,
    head) absmax scale over D. torch.round rounds half to even, like
    jnp.round, so the codes are bit-identical to the reference's."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127,
                    127).to(torch.int8)
    return {'q': q, 's': scale}


def _is_quant(kv) -> bool:
    return isinstance(kv, dict)


def _is_paged(cache: Cache) -> bool:
    return 'table' in cache


def _leaf(kv: KV) -> torch.Tensor:
    return kv['q'] if _is_quant(kv) else kv


def _map_kv(fn, kv: KV) -> KV:
    if _is_quant(kv):
        return {'q': fn(kv['q']), 's': fn(kv['s'])}
    return fn(kv)


def cache_capacity(cache: Cache) -> int:
    """Logical KV positions addressable per slot (every rank's span of a
    dense cache cut over the ambient mesh's `context` axis)."""
    leaf = _leaf(cache['k'])
    if _is_paged(cache):
        return int(cache['table'].shape[1]) * int(leaf.shape[2])
    return _context_span(int(leaf.shape[2]))[2]


def _context_span(local_len: int) -> Tuple[Any, int, int]:
    """(the `context` group, the first position of this rank's span, the
    whole sequence length) of a dense cache leaf whose sequence dim holds
    `local_len` positions here, under the ambient mesh (no group, 0 and
    `local_len` when the mesh does not cut the sequence)."""
    mesh = mesh_lib.current()
    if mesh is None or mesh.shape['context'] == 1:
        return None, 0, local_len
    return (mesh.group('context'), mesh.index('context') * local_len,
            mesh.shape['context'] * local_len)


def init_cache(config: llama.LlamaConfig, batch_size: int,
               max_seq_len: Optional[int] = None, pad_to: int = 1,
               kv_quant: str = 'none', page_size: int = 0,
               num_pages: int = 0,
               device: Optional[Union[str, torch.device]] = None,
               mesh: Optional[mesh_lib.Mesh] = None) -> Cache:
    """Zeroed KV cache + per-slot lengths on `device` (cuda unless
    named). Dense leaves are [L,B,S,KV,D]; paged leaves are a pool
    [L,P,page,KV,D] whose page 0 is the scratch page every empty table
    entry points at, plus a [B,W] block table. int8 leaves are
    {'q': int8, 's': f32 [..]}. With a mesh, KV is this rank's KV heads
    (the heads axis splits over 'tensor') and a dense leaf's sequence
    dim splits over 'context' (reference :452-456): rank c of the
    context axis holds positions [c S/C, (c+1) S/C), S rounded up to a
    multiple of the context degree (and of `pad_to`) as the reference
    rounds it (:369-374). A paged cache takes no context axis
    (ValueError, reference :376-391); tables and lengths are whole on
    every rank."""
    c = config
    device = device_lib.resolve_device(device)
    s = max_seq_len or c.max_seq_len
    ctx = 1 if mesh is None else mesh.shape['context']
    multiple = math.lcm(max(1, pad_to), ctx)
    s = -(-s // multiple) * multiple
    if kv_quant not in ('none', 'int8'):
        raise ValueError(f'kv_quant must be none|int8, got {kv_quant!r}')
    if page_size > 0 and ctx > 1:
        raise ValueError(
            'paged KV (page_size > 0) is incompatible with a '
            "context-sharded cache (mesh axis 'context' > 1): "
            'pages indirect the sequence dim the context axis '
            'partitions. Drop the context axis (tensor-sharded '
            'meshes page fine) or set page_size=0 for the dense '
            'layout, whose sequence dim context-shards.')
    # Dense and paged leaves alike are [L, B or P, S or page, KV, D].
    cut = sharding_lib.Shard() if mesh is None else sharding_lib.leaf_shard(
        mesh, (None, None, None if page_size > 0 else 'seq', 'kv_heads',
               None))

    def kv_zeros(shape):
        if kv_quant == 'int8':
            return {'q': torch.zeros(shape, dtype=torch.int8, device=device),
                    's': torch.zeros(shape[:-1], dtype=torch.float32,
                                     device=device)}
        return torch.zeros(shape, dtype=c.dtype, device=device)

    length = torch.zeros((batch_size,), dtype=torch.int32, device=device)
    if page_size > 0:
        step = math.lcm(multiple, page_size)
        s = -(-s // step) * step
        w = s // page_size
        p = (num_pages + 1) if num_pages > 0 else (batch_size * w + 1)
        shape = cut.local_shape(
            (c.num_layers, p, page_size, c.num_kv_heads, c.head_dim))
        return {'k': kv_zeros(shape), 'v': kv_zeros(shape),
                'length': length,
                'table': torch.zeros((batch_size, w), dtype=torch.int32,
                                     device=device)}
    shape = cut.local_shape(
        (c.num_layers, batch_size, s, c.num_kv_heads, c.head_dim))
    return {'k': kv_zeros(shape), 'v': kv_zeros(shape), 'length': length}


def _paged_read(pages: KV, table: torch.Tensor) -> KV:
    """Per-layer page pool [P,page,...] -> per-slot dense view
    [B, W*page, ...] through the block table [B,W]. Like the
    reference, this materializes one layer's view per call; unallocated
    entries read the scratch page, beyond every slot's length."""
    def read_leaf(leaf):
        page = leaf.shape[1]
        flat = leaf.reshape((-1,) + tuple(leaf.shape[2:]))
        idx = (table[:, :, None].long() * page
               + torch.arange(page, device=leaf.device)[None, None, :]
               ).reshape(table.shape[0], -1)
        return flat[idx]

    return _map_kv(read_leaf, pages)


def _paged_write(pages: KV, new: torch.Tensor, table: torch.Tensor,
                 write_at: torch.Tensor) -> KV:
    """Scatter T new rows per slot ([B,T,KV,D], landing at logical
    positions write_at[b]..+T-1) into the page pool, in place.
    Positions past the table clip to its last entry, as the reference
    does. Writes that resolve to the scratch page may collide; that
    page is never read inside any slot's length."""
    def write_leaf(leaf, new_leaf):
        page = leaf.shape[1]
        flat = leaf.view((-1,) + tuple(leaf.shape[2:]))
        t = new_leaf.shape[1]
        pos = write_at[:, None].long() + torch.arange(
            t, device=leaf.device)[None]
        pos = torch.clamp(pos, 0, table.shape[1] * page - 1)
        pidx = torch.gather(table.long(), 1, pos // page)
        idx = pidx * page + pos % page
        flat[idx] = new_leaf.to(flat.dtype)
        return leaf

    if _is_quant(pages):
        newq = quantize_kv(new)
        write_leaf(pages['q'], newq['q'])
        write_leaf(pages['s'], newq['s'])
        return pages
    return write_leaf(pages, new)


def _dense_write(cache_kv: KV, new: torch.Tensor,
                 write_at: torch.Tensor) -> KV:
    """Write [B,T,...] rows at write_at[b] of a dense [B,S,...] layer
    cache, in place. The start clamps to S - T like the reference's
    dynamic_update_slice. Under a mesh that cuts the sequence over
    `context` the leaf holds this rank's span of S, and the rank writes
    only the positions inside it (`_span_write`)."""
    def write_leaf(leaf, new_leaf):
        group, lo, s = _context_span(leaf.shape[1])
        t = new_leaf.shape[1]
        start = torch.clamp(write_at.long(), 0, s - t)
        rows = torch.arange(leaf.shape[0], device=leaf.device)[:, None]
        if group is not None:
            _span_write(leaf, new_leaf, start - lo, rows)
            return leaf
        idx = start[:, None] + torch.arange(t, device=leaf.device)[None]
        leaf[rows, idx] = new_leaf.to(leaf.dtype)
        return leaf

    if _is_quant(cache_kv):
        newq = quantize_kv(new)
        write_leaf(cache_kv['q'], newq['q'])
        write_leaf(cache_kv['s'], newq['s'])
        return cache_kv
    return write_leaf(cache_kv, new)


def _span_write(leaf: torch.Tensor, new: torch.Tensor,
                local_start: torch.Tensor, rows: torch.Tensor) -> None:
    """Write `new` [B,T,...] at local positions local_start[b].. of
    `leaf` [B,S_local,...], in place, keeping only the positions that
    fall inside [0, S_local): a chunk that straddles two ranks' spans
    lands half here, half on the other rank. Each piece of at most
    S_local rows goes to its positions modulo S_local, distinct within
    the piece, with the old row put back where a position lies outside
    the span, so no two writes of a piece collide and no host sync is
    needed."""
    s_loc, t = leaf.shape[1], new.shape[1]
    for p0 in range(0, t, s_loc):
        piece = new[:, p0:p0 + s_loc].to(leaf.dtype)
        local = local_start[:, None] + p0 + torch.arange(
            piece.shape[1], device=leaf.device)[None]
        mine = (local >= 0) & (local < s_loc)
        idx = torch.remainder(local, s_loc)
        mine = mine.view(mine.shape + (1,) * (piece.dim() - 2))
        leaf[rows, idx] = torch.where(mine, piece, leaf[rows, idx])


def _leaves(kv: KV) -> List[torch.Tensor]:
    return [kv['q'], kv['s']] if _is_quant(kv) else [kv]


def _copy_pool_page(pool: KV, src: int, dst: int) -> None:
    """Copy page `src` onto page `dst` across every layer of one page
    pool ([L, P, page, ...] leaves, raw or {'q','s'}), in place: the
    device half of copy-on-write. Only the page's slice moves; no second
    pool is allocated."""
    for leaf in _leaves(pool):
        leaf[:, dst].copy_(leaf[:, src])


def _gather_pool_pages(pool: KV, pages: List[int]) -> KV:
    """Pages `pages` of a pool's [L, P, page, ...] leaves -> new
    [L, len(pages), page, ...] leaves (the snapshot half of migration;
    the pool keeps serving). Unlike the reference this gathers only the
    pages asked for: nothing here compiles per shape."""
    def gather(leaf):
        return leaf.index_select(1, torch.tensor(pages, dtype=torch.long,
                                                 device=leaf.device))
    return _map_kv(gather, pool)


def _splice_pool_pages(pool: KV, pages: List[int], data: KV) -> None:
    """Write restored [L, len(pages), page, ...] leaves into page ids
    `pages` of the pool, in place."""
    for leaf, d in zip(_leaves(pool), _leaves(data)):
        leaf.index_copy_(1, torch.tensor(pages, dtype=torch.long,
                                         device=leaf.device),
                         d.to(leaf.device))


def _gather_dense_row(cache_kv: KV, slot: int, length: int) -> KV:
    """Positions 0..length-1 of one slot's dense-cache row per leaf:
    [L, B, S, ...] -> [L, length, ...]. Under a mesh that cuts the
    sequence over `context`, each rank's span is all-gathered first (on
    the leaf's device), so every rank holds the whole row."""
    return _map_kv(lambda leaf: collectives.all_gather(
        leaf[:, slot], _context_span(leaf.shape[2])[0], 1)[:, :length],
        cache_kv)


def _splice_dense_row(cache_kv: KV, slot: int, data: KV) -> None:
    """Write restored [L, n, ...] leaves into slot `slot` of a dense
    cache, in place: the positions of this rank's span (all of them
    unless the ambient mesh cuts the sequence over `context`); the rest
    of the row zeroes, as the reference's zero-padded splice leaves
    it."""
    for leaf, d in zip(_leaves(cache_kv), _leaves(data)):
        start = _context_span(leaf.shape[2])[1]
        part = d[:, start:start + leaf.shape[2]]
        n = part.shape[1]
        leaf[:, slot, :n].copy_(part.to(leaf.device))
        leaf[:, slot, n:].zero_()


# -- request snapshot blobs (migration) -------------------------------------
# Wire format, the reference's `SKTPUSNP` v1 byte for byte:
#   magic(8) | version u32 | header_len u32 | header JSON |
#   array payload (raw C-order bytes, concatenated in header order) |
#   crc32 u32 over everything after the magic.
_SNAP_MAGIC = b'SKTPUSNP'
SNAPSHOT_VERSION = 1
# Array dtype as the header names it (the reference writes numpy's
# `str(a.dtype)`) -> (torch dtype, same-width integer the bytes go
# through). bfloat16 travels as int16 bits: numpy has no bfloat16
# without ml_dtypes, which the port does not use.
_BLOB_DTYPES = {
    'bfloat16': (torch.bfloat16, torch.int16, np.int16),
    'float16': (torch.float16, torch.int16, np.int16),
    'float32': (torch.float32, torch.int32, np.int32),
    'int8': (torch.int8, torch.int8, np.int8),
}
_DTYPE_NAMES = {t: name for name, (t, _, _) in _BLOB_DTYPES.items()}


class SnapshotError(ValueError):
    """A migration blob that cannot be trusted or applied: bad magic,
    version mismatch, truncation, CRC failure, or an engine-geometry
    mismatch (layout / page size / max_seq_len / shape / dtype)."""


def _snapshot_pack(header: Dict[str, Any],
                   arrays: List[Tuple[str, torch.Tensor]]) -> bytes:
    """header + named tensors (any device) -> a blob."""
    header = dict(header)
    header['arrays'] = [
        {'name': name, 'dtype': _DTYPE_NAMES[a.dtype],
         'shape': list(a.shape)} for name, a in arrays]
    hj = json.dumps(header).encode('utf-8')
    body = bytearray(struct.pack('<II', SNAPSHOT_VERSION, len(hj)))
    body += hj
    for _, a in arrays:
        bits = _BLOB_DTYPES[_DTYPE_NAMES[a.dtype]][1]
        body += a.detach().cpu().contiguous().view(bits).numpy().tobytes()
    return (_SNAP_MAGIC + bytes(body)
            + struct.pack('<I', zlib.crc32(body)))


def _snapshot_unpack(blob: bytes
                     ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """A blob -> (header, name -> CPU tensor); SnapshotError for
    anything that cannot be trusted."""
    if not isinstance(blob, (bytes, bytearray)):
        raise SnapshotError('snapshot blob must be bytes')
    if len(blob) < len(_SNAP_MAGIC) + 12:
        raise SnapshotError(
            f'snapshot blob truncated ({len(blob)} bytes)')
    if bytes(blob[:len(_SNAP_MAGIC)]) != _SNAP_MAGIC:
        raise SnapshotError('bad snapshot magic — not a migration blob')
    # One writable copy of the body: the arrays are views into it.
    body = bytearray(blob[len(_SNAP_MAGIC):-4])
    (crc,) = struct.unpack('<I', blob[-4:])
    if zlib.crc32(body) != crc:
        raise SnapshotError('snapshot CRC mismatch — blob corrupted '
                            'in transit')
    version, hlen = struct.unpack('<II', body[:8])
    if version != SNAPSHOT_VERSION:
        raise SnapshotError(
            f'snapshot version {version} != supported '
            f'{SNAPSHOT_VERSION}')
    if len(body) < 8 + hlen:
        raise SnapshotError('snapshot blob truncated inside header')
    try:
        header = json.loads(body[8:8 + hlen].decode('utf-8'))
        specs = [(str(spec['name']), str(spec['dtype']),
                  tuple(int(n) for n in spec['shape']))
                 for spec in header.get('arrays', ())]
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        raise SnapshotError(f'snapshot header unparseable: {e}') from e
    arrays: Dict[str, torch.Tensor] = {}
    off = 8 + hlen
    for name, dtype, shape in specs:
        if dtype not in _BLOB_DTYPES or any(n < 0 for n in shape):
            raise SnapshotError(
                f'snapshot array {name!r}: unsupported dtype {dtype!r} '
                f'or shape {list(shape)}')
        t_dtype, _, bits = _BLOB_DTYPES[dtype]
        count = math.prod(shape)
        nbytes = np.dtype(bits).itemsize * count
        if off + nbytes > len(body):
            raise SnapshotError(
                f'snapshot blob truncated inside array {name!r}')
        host = np.frombuffer(body, dtype=bits, count=count, offset=off)
        arrays[name] = torch.from_numpy(host).view(t_dtype).reshape(shape)
        off += nbytes
    if off != len(body):
        raise SnapshotError(
            f'{len(body) - off} trailing bytes after snapshot arrays')
    return header, arrays


def _flash_prefill_ok(t: int, s: int, d: int,
                      device: torch.device) -> bool:
    """Can the flash path serve a [T]-query chunk against an
    [S]-position cache? On CUDA: what the kernel serves (t >= 2 and a
    head dim it is built for; it masks ragged tiles itself). On the CPU
    the plain version keeps the reference's block-divisibility rule,
    so routing matches the reference there."""
    if t < 2:
        return False
    if device.type == 'cuda':
        return d in fa_lib.KERNEL_HEAD_DIMS
    bq, bk = min(512, t), min(512, s)
    return not (t % bq or s % bk)


def _cached_attention(q: torch.Tensor, k_cache: KV, v_cache: KV,
                      q_positions: torch.Tensor, lengths: torch.Tensor,
                      window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      q_offset: Optional[int] = None) -> torch.Tensor:
    """Attention of q [B,T,H,D] against the cache view [B,S,KV,D].

    Keys visible to slot b: positions < lengths[b] and <= the query's
    position (and within `window`). With `q_offset` (prefill chunks,
    every slot's chunk starting at that cache position) the flash
    kernels serve the chunk: they mask causally from q_offset only, so
    rows past a prompt's end differ from the dense path's; prefill
    never reads those rows. Otherwise the grouped-query dense path runs
    (f32 scores, probabilities cast to the value dtype, as the
    reference)."""
    quant = _is_quant(k_cache)
    k_arr = _leaf(k_cache)
    group, lo, _ = _context_span(k_arr.shape[1])
    if group is not None:
        return _context_attention(q, k_cache, v_cache, q_positions, lengths,
                                  window, softcap, q_offset, group, lo)
    if q_offset is not None and _flash_prefill_ok(
            q.shape[1], k_arr.shape[1], q.shape[3], q.device):
        if quant:
            return fa_lib.flash_attention_quant(
                q, k_cache['q'], k_cache['s'], v_cache['q'], v_cache['s'],
                causal=True, block_q=min(512, q.shape[1]),
                block_k=min(512, k_arr.shape[1]), window=window,
                softcap=softcap, q_offset=q_offset)
        return fa_lib.flash_attention(
            q, k_cache, v_cache, causal=True,
            block_q=min(512, q.shape[1]),
            block_k=min(512, k_arr.shape[1]), window=window,
            softcap=softcap, q_offset=q_offset)
    scores, _ = _dense_scores(q, k_cache, q_positions, lengths, window,
                              softcap)
    out = _dense_values(torch.softmax(scores, dim=-1), q, v_cache)
    return out if quant else out.to(v_cache.dtype)


def _dense_scores(q: torch.Tensor, k_cache: KV, q_positions: torch.Tensor,
                  lengths: torch.Tensor, window: Optional[int],
                  softcap: Optional[float], start: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grouped-query dense path's f32 scores [B,KV,G,T,S] of q
    [B,T,H,D] against the cache view [B,S,KV,D] (its keys at positions
    start..), -1e30 where a key is not visible, and the visibility
    [B,1,1,T,S]: positions < lengths[b], <= the query's position and
    within `window`."""
    k_arr = _leaf(k_cache)
    b, s, hkv, d = k_arr.shape
    qg = q.reshape(b, q.shape[1], hkv, q.shape[2] // hkv, d)
    scale = 1.0 / math.sqrt(d)
    quant = _is_quant(k_cache)
    k_val = k_cache['q'].to(q.dtype) if quant else k_cache
    scores = torch.einsum('btkgd,bskd->bkgts', qg.float(),
                          k_val.float()) * scale
    if quant:
        scores = scores * k_cache['s'].permute(0, 2, 1)[:, :, None, None, :]
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    k_pos = start + torch.arange(s, device=q.device)
    visible = ((k_pos[None, None, :] <= q_positions[:, :, None])
               & (k_pos[None, None, :] < lengths[:, None, None]))
    if window is not None:
        visible = visible & (q_positions[:, :, None] - k_pos[None, None, :]
                             < window)
    visible = visible[:, None, None]
    return (torch.where(visible, scores, torch.full_like(scores, _NEG_INF)),
            visible)


def _dense_values(probs: torch.Tensor, q: torch.Tensor,
                  v_cache: KV) -> torch.Tensor:
    """Probabilities [B,KV,G,T,S] times the cache view's values -> f32
    [B,T,H,D]: cast to the value dtype first (to q's and scaled on an
    int8 cache), as the reference."""
    if _is_quant(v_cache):
        probs = probs.to(q.dtype) * v_cache['s'].permute(0, 2, 1)[
            :, :, None, None, :].to(q.dtype)
        values = v_cache['q'].to(q.dtype)
    else:
        probs, values = probs.to(v_cache.dtype), v_cache
    out = torch.einsum('bkgts,bskd->btkgd', probs.float(), values.float())
    return out.reshape(q.shape[0], q.shape[1], q.shape[2], q.shape[3])


def _context_attention(q: torch.Tensor, k_cache: KV, v_cache: KV,
                       q_positions: torch.Tensor, lengths: torch.Tensor,
                       window: Optional[int], softcap: Optional[float],
                       q_offset: Optional[int], group: Any,
                       lo: int) -> torch.Tensor:
    """`_cached_attention` over a cache cut on its sequence dim over
    `context`: this rank attends its span of keys (positions lo..), then
    the ranks' (O, lse) merge over `group` (`_merge_over_context`).

    A prefill chunk (`q_offset`) runs K1 (K2 on an int8 cache) at the
    span's offset, q_offset - lo: negative for a span that lies past the
    chunk's first row, whose rows before the span see no key and give
    O = 0, lse = +inf. Otherwise (decode, a verify slab) the partial
    softmax of the dense path runs in plain torch. The output's dtype is
    the unsharded path's: q's for flash, the value dtype for a
    bf16 cache, f32 for an int8 one."""
    quant = _is_quant(k_cache)
    b, s, _, d = _leaf(k_cache).shape
    t, num_heads = q.shape[1], q.shape[2]
    if q_offset is not None and _flash_prefill_ok(t, s, d, q.device):
        kw = dict(causal=True, block_q=min(512, t), block_k=min(512, s),
                  window=window, softcap=softcap, q_offset=q_offset - lo)
        if quant:
            o, lse = fa_lib.flash_fwd(q, k_cache['q'], v_cache['q'],
                                      k_scale=k_cache['s'],
                                      v_scale=v_cache['s'], **kw)
        else:
            o, lse = fa_lib.flash_fwd(q, k_cache, v_cache, **kw)
        return _merge_over_context(o, lse, group).to(q.dtype)
    scores, visible = _dense_scores(q, k_cache, q_positions, lengths, window,
                                    softcap, start=lo)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(visible, torch.exp(scores - m), torch.zeros_like(scores))
    denom = p.sum(dim=-1, keepdim=True)
    # No visible key in this span: lse = +inf, as the kernels give it.
    lse = torch.where(denom > 0, m + torch.log(denom),
                      torch.full_like(denom, math.inf))
    out = _dense_values(
        p / torch.where(denom > 0, denom, torch.ones_like(denom)), q,
        v_cache)
    out = _merge_over_context(out, lse.reshape(b, num_heads, t, 1), group)
    return out if quant else out.to(v_cache.dtype)


def _merge_over_context(o: torch.Tensor, lse: torch.Tensor,
                        group: Any) -> torch.Tensor:
    """Each `context` rank's partial attention (O [B,T,H,D], lse
    [B,H,T,1]) -> the whole attention, f32 [B,T,H,D]: the ranks' (O,
    lse) all-gathered in one tensor and folded in f32 by
    `flash_attention._merge` in rank order, so every rank holds the same
    bits (a span with no visible key in a row weighs 0 there)."""
    packed = torch.cat([o.float(), lse.permute(0, 2, 1, 3)], dim=-1)
    out = lse_acc = None
    for part in collectives.all_gather(packed[None], group, 0):
        out, lse_acc = fa_lib._merge(out, lse_acc, part[..., :-1],
                                     part[..., -1:].permute(0, 2, 1, 3))
    return out


def _attn_with_cache(x: torch.Tensor, layer_params: Params, k_cache: KV,
                     v_cache: KV, positions: torch.Tensor,
                     lengths: torch.Tensor, write_at: torch.Tensor,
                     config: llama.LlamaConfig,
                     window: Optional[int] = None,
                     q_offset: Optional[int] = None,
                     table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention block over T new tokens [B,T,E] at `positions` [B,T];
    writes their K/V into the layer's cache in place at write_at[b]
    (through `table` when the cache is paged) and returns x + attn.
    Shared by the llama-core and MoE layers: the getattr defaults cover
    a config (MoeConfig) that carries no family knob, as in the
    reference (:606-627)."""
    c = config
    plus_one = getattr(c, 'norm_plus_one', False)
    h = llama._rms_norm(x, layer_params['attn_norm'], c.rms_norm_eps,
                        plus_one)
    q, k, v = llama._qkv(h, layer_params, c)
    q = llama._rope(q, positions, c)
    k = llama._rope(k, positions, c)
    qpa = getattr(c, 'query_pre_attn_scalar', None)
    if qpa is not None:
        q = q * math.sqrt(c.head_dim / qpa)
    if table is not None:
        _paged_write(k_cache, k, table, write_at)
        _paged_write(v_cache, v, table, write_at)
        k_read = _paged_read(k_cache, table)
        v_read = _paged_read(v_cache, table)
    else:
        _dense_write(k_cache, k, write_at)
        _dense_write(v_cache, v, write_at)
        k_read, v_read = k_cache, v_cache
    attn = _cached_attention(q, k_read, v_read, positions, lengths,
                             window=window,
                             softcap=getattr(c, 'attn_logit_softcap', None),
                             q_offset=q_offset)
    attn_out = llama._row_parallel(attn.to(c.dtype), layer_params['wo'],
                                   'bshd,hde->bse', c)
    if getattr(c, 'post_norms', False):
        attn_out = llama._rms_norm(attn_out, layer_params['post_attn_norm'],
                                   c.rms_norm_eps, plus_one)
    return x + attn_out


def _layer_with_cache(x: torch.Tensor, layer_params: Params, k_cache: KV,
                      v_cache: KV, positions: torch.Tensor,
                      lengths: torch.Tensor, write_at: torch.Tensor,
                      config: llama.LlamaConfig,
                      window: Optional[int] = None,
                      q_offset: Optional[int] = None,
                      table: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """One llama-core layer (attention + GLU MLP) with cache."""
    c = config
    x = _attn_with_cache(x, layer_params, k_cache, v_cache, positions,
                         lengths, write_at, c, window=window,
                         q_offset=q_offset, table=table)
    h = llama._rms_norm(x, layer_params['mlp_norm'], c.rms_norm_eps,
                        c.norm_plus_one)
    down = llama._mlp(h, layer_params, c)
    if c.post_norms:
        down = llama._rms_norm(down, layer_params['post_mlp_norm'],
                               c.rms_norm_eps, c.norm_plus_one)
    return x + down


def _moe_layer_with_cache(x: torch.Tensor, layer_params: Params,
                          k_cache: KV, v_cache: KV, positions: torch.Tensor,
                          lengths: torch.Tensor, write_at: torch.Tensor,
                          config: moe_lib.MoeConfig,
                          q_offset: Optional[int] = None,
                          table: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """One MoE layer (llama attention + routed expert MLP) with cache.
    Routing is per-token feedforward and needs no cache of its own; the
    aux loss only regularises training and is dropped. Only the real
    tokens (positions < lengths) are routed: at the engine's drop-free
    capacity that changes no real token's output (the reference routes
    the padding too), and a padded chunk's padding, which attends
    whatever its pages hold, cannot change the expert row counts the
    real tokens' products run at."""
    c = config
    x = _attn_with_cache(x, layer_params, k_cache, v_cache, positions,
                         lengths, write_at, c, q_offset=q_offset,
                         table=table)
    h = llama._rms_norm(x, layer_params['mlp_norm'], c.rms_norm_eps)
    out, _aux = moe_lib._moe_mlp(h, layer_params, c,
                                 valid=positions < lengths[:, None],
                                 replicated=True)
    return x + out


def _layer_cuts(config: Any) -> Optional[Params]:
    """Each layer leaf's per-layer `Shard` when the ambient mesh cuts the
    layers' weights over `fsdp` (their `embed` dim), else None."""
    mesh = mesh_lib.current()
    if mesh is None or mesh.shape['fsdp'] == 1:
        return None
    return {k: v.per_layer()
            for k, v in llama.shard_tree(config, mesh)['layers'].items()}


def _layer_at(params: Params, i: int, cuts: Optional[Params]) -> Params:
    """Layer i's weights as the cached layer math reads them: under
    `fsdp` each leaf gathered whole along its `embed` cut
    (`llama.unshard`), one layer at a time, so a rank holds its shards
    and one gathered layer; its tensor columns and experts stay cut."""
    lp = llama.layer_params_at(params, i)
    if cuts is None:
        return lp
    mesh = mesh_lib.current()
    return {k: llama.unshard(v, cuts[k], mesh) for k, v in lp.items()}


def _moe_hidden_with_cache(params: Params, tokens: torch.Tensor,
                           cache: Cache, positions: torch.Tensor,
                           write_at: torch.Tensor, new_lengths: torch.Tensor,
                           config: moe_lib.MoeConfig,
                           q_offset: Optional[int] = None) -> torch.Tensor:
    """MoE variant of `_hidden_with_cache` (plain norms, no windows or
    softcaps, as `moe.forward`)."""
    c = config
    table = cache.get('table')
    cuts = _layer_cuts(c)
    x = moe_lib.embed(params, tokens, c)
    for i in range(c.num_layers):
        x = _moe_layer_with_cache(
            x, _layer_at(params, i, cuts),
            _map_kv(lambda a: a[i], cache['k']),
            _map_kv(lambda a: a[i], cache['v']), positions, new_lengths,
            write_at, c, q_offset=q_offset, table=table)
    return llama._rms_norm(x, llama._whole(params, 'final_norm', c),
                           c.rms_norm_eps)


def _hidden_with_cache(params: Params, tokens: torch.Tensor, cache: Cache,
                       positions: torch.Tensor, write_at: torch.Tensor,
                       new_lengths: torch.Tensor,
                       config: llama.LlamaConfig,
                       q_offset: Optional[int] = None) -> torch.Tensor:
    """tokens [B,T] at `positions` -> final-norm hidden states [B,T,E];
    the cache's k/v leaves are updated in place (`new_lengths` masks
    the attention; cache['length'] is left to the caller)."""
    if isinstance(config, moe_lib.MoeConfig):
        return _moe_hidden_with_cache(params, tokens, cache, positions,
                                      write_at, new_lengths, config,
                                      q_offset=q_offset)
    c = config
    table = cache.get('table')
    cuts = _layer_cuts(c)
    x = llama.embed(params, tokens, c)
    for i, window in enumerate(llama.layer_windows(c)):
        x = _layer_with_cache(
            x, _layer_at(params, i, cuts),
            _map_kv(lambda a: a[i], cache['k']),
            _map_kv(lambda a: a[i], cache['v']), positions, new_lengths,
            write_at, c, window=window, q_offset=q_offset, table=table)
    return llama._rms_norm(x, llama._whole(params, 'final_norm', c),
                           c.rms_norm_eps, c.norm_plus_one)


def _project_logits(x: torch.Tensor, params: Params,
                    config: llama.LlamaConfig) -> torch.Tensor:
    """Final-norm hidden states -> f32 logits."""
    if isinstance(config, moe_lib.MoeConfig):
        return moe_lib.project_logits(x, params, config)
    return llama.project_logits(x, params, config)


def _slot_subset(cache: Cache, slot_ids: torch.Tensor) -> Cache:
    """The cache as the prefill of `slot_ids` sees it: paged caches
    share the pool (each slot owns its pages) with the sub-table; dense
    caches gather copies of the slots' rows, scattered back after."""
    if _is_paged(cache):
        return {'k': cache['k'], 'v': cache['v'],
                'table': cache['table'][slot_ids]}
    return {'k': _map_kv(lambda a: a[:, slot_ids], cache['k']),
            'v': _map_kv(lambda a: a[:, slot_ids], cache['v'])}


def _scatter_slots(cache: Cache, sub: Cache, slot_ids: torch.Tensor
                   ) -> None:
    if _is_paged(cache):
        return
    for name in ('k', 'v'):
        if _is_quant(cache[name]):
            for part in ('q', 's'):
                cache[name][part][:, slot_ids] = sub[name][part]
        else:
            cache[name][:, slot_ids] = sub[name]


@torch.no_grad()
def prefill_chunked(params: Params, tokens: torch.Tensor,
                    prompt_lengths: torch.Tensor, cache: Cache,
                    slot_ids: torch.Tensor, config: llama.LlamaConfig,
                    chunk: int, use_flash: bool = False
                    ) -> Tuple[torch.Tensor, Cache]:
    """Prefill right-padded prompts [N, K*chunk] into slots `slot_ids`
    as K chunk-wide passes (K=1 is one-shot prefill). Returns the
    last-token logits [N,V] (each prompt's true last position) and the
    cache, updated in place. `use_flash` sends each chunk's attention
    through the flash kernels (q_offset = the chunk's start)."""
    n, padded_len = tokens.shape
    n_chunks = padded_len // chunk
    sub = _slot_subset(cache, slot_ids)
    dev = tokens.device
    last_hidden = torch.zeros((n, config.hidden_size),
                              dtype=config.dtype, device=dev)
    last_idx = prompt_lengths.long() - 1
    rows = torch.arange(n, device=dev)
    for ci in range(n_chunks):
        start = ci * chunk
        positions = start + torch.arange(chunk, device=dev)[None].expand(
            n, chunk)
        write_at = torch.full((n,), start, dtype=torch.int32, device=dev)
        visible = torch.clamp(prompt_lengths, max=start + chunk)
        x = _hidden_with_cache(
            params, tokens[:, start:start + chunk], sub, positions,
            write_at, visible, config,
            q_offset=start if use_flash else None)
        in_chunk = (last_idx >= start) & (last_idx < start + chunk)
        gathered = x[rows, torch.clamp(last_idx - start, 0, chunk - 1)]
        last_hidden = torch.where(in_chunk[:, None], gathered, last_hidden)
    _scatter_slots(cache, sub, slot_ids)
    cache['length'][slot_ids] = prompt_lengths.to(torch.int32)
    return _project_logits(last_hidden, params, config), cache


@torch.no_grad()
def prefill_chunk_at(params: Params, chunk_tokens: torch.Tensor,
                     start: int, visible: torch.Tensor, cache: Cache,
                     slot_ids: torch.Tensor, config: llama.LlamaConfig,
                     chunk: int, use_flash: bool = False
                     ) -> Tuple[torch.Tensor, Cache]:
    """ONE [N, chunk] slab of prompt written at cache position `start`
    for `slot_ids` (interleaved prefill). Returns the chunk's hidden
    states [N, chunk, E] and the cache, updated in place; `visible`
    [N] becomes each slot's cache length."""
    n = chunk_tokens.shape[0]
    dev = chunk_tokens.device
    positions = start + torch.arange(chunk, device=dev)[None].expand(
        n, chunk)
    write_at = torch.full((n,), start, dtype=torch.int32, device=dev)
    sub = _slot_subset(cache, slot_ids)
    x = _hidden_with_cache(params, chunk_tokens, sub, positions, write_at,
                           visible, config,
                           q_offset=start if use_flash else None)
    _scatter_slots(cache, sub, slot_ids)
    cache['length'][slot_ids] = visible.to(torch.int32)
    return x, cache


def _sample(logits: torch.Tensor, temperature: torch.Tensor,
            top_k: torch.Tensor, top_p: torch.Tensor,
            generator: Optional[torch.Generator]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot temperature/top-k/top-p sampling (temperature 0 =>
    greedy); both filters reduce to a per-row logit threshold. Returns
    (tokens [B] int32, logprobs [B] f32 of each token under the RAW
    model distribution). Sampling is Gumbel-max over `generator`."""
    vocab = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    k_idx = torch.clamp(top_k.long() - 1, 0, vocab - 1)
    kth = torch.where(
        top_k > 0, torch.gather(sorted_logits, 1, k_idx[:, None])[:, 0],
        torch.full_like(sorted_logits[:, 0], -math.inf))
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    probs = torch.softmax(sorted_logits / temp, dim=-1)
    in_nucleus = (torch.cumsum(probs, dim=-1) - probs) < top_p[:, None]
    pth = torch.where(in_nucleus, sorted_logits,
                      torch.full_like(sorted_logits, math.inf)).amin(dim=-1)
    pth = torch.where(top_p >= 1.0, torch.full_like(pth, -math.inf), pth)
    thresh = torch.maximum(kth, pth)
    filtered = torch.where(logits >= thresh[:, None], logits,
                           torch.full_like(logits, _NEG_INF))
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    sampled = torch.argmax(filtered / temp + gumbel, dim=-1)
    tokens = torch.where(temperature <= 0.0, greedy,
                         sampled).to(torch.int32)
    raw_logprobs = torch.log_softmax(logits.float(), dim=-1)
    chosen = torch.gather(raw_logprobs, 1, tokens.long()[:, None])[:, 0]
    return tokens, chosen


@torch.no_grad()
def decode_step(params: Params, cache: Cache, last_tokens: torch.Tensor,
                active: torch.Tensor, temperature: torch.Tensor,
                top_k: torch.Tensor, top_p: torch.Tensor,
                generator: Optional[torch.Generator],
                config: llama.LlamaConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, Cache]:
    """One token for every slot [B]; inactive slots don't advance.
    Returns (tokens, raw-model logprobs, cache updated in place)."""
    lengths = cache['length']
    new_lengths = torch.where(active, lengths + 1, lengths)
    x = _hidden_with_cache(params, last_tokens[:, None], cache,
                           lengths[:, None], lengths, new_lengths, config)
    logits = _project_logits(x[:, 0], params, config)
    nxt, logprobs = _sample(logits, temperature, top_k, top_p, generator)
    nxt = torch.where(active, nxt, last_tokens)
    cache['length'] = new_lengths
    return nxt, logprobs, cache


@torch.no_grad()
def fused_decode_steps(params: Params, cache: Cache,
                       last_tokens: torch.Tensor, active: torch.Tensor,
                       temperature: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor, eos_ids: torch.Tensor,
                       budgets: torch.Tensor, max_len: int,
                       generator: Optional[torch.Generator],
                       config: llama.LlamaConfig, n_steps: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor, Cache]:
    """Up to `n_steps` decode steps per host round: the same per-token
    math as `decode_step`, stopping early once every slot is done (one
    `.any()` sync per step). A slot deactivates right after it emits
    `eos_ids[b]`, exhausts `budgets[b]`, or reaches `max_len` cache
    positions, and emits nothing further (`emitted` gates what the host
    appends). Returns (tokens [B,n_steps], logprobs [B,n_steps],
    emitted [B], new last tokens [B], cache updated in place)."""
    b = last_tokens.shape[0]
    dev = last_tokens.device
    toks = torch.zeros((b, n_steps), dtype=torch.int32, device=dev)
    lps = torch.zeros((b, n_steps), dtype=torch.float32, device=dev)
    emitted = torch.zeros((b,), dtype=torch.int32, device=dev)
    last = last_tokens.clone()
    active = active.clone()
    for i in range(n_steps):
        if not bool(active.any()):
            break
        lengths = cache['length']
        new_lengths = torch.where(active, lengths + 1, lengths)
        x = _hidden_with_cache(params, last[:, None], cache,
                               lengths[:, None], lengths, new_lengths,
                               config)
        logits = _project_logits(x[:, 0], params, config)
        nxt, lp = _sample(logits, temperature, top_k, top_p, generator)
        nxt = torch.where(active, nxt, last)
        cache['length'] = new_lengths
        toks[:, i] = nxt
        lps[:, i] = lp
        emitted = emitted + active.to(torch.int32)
        done = ((nxt == eos_ids) | (emitted >= budgets)
                | (new_lengths >= max_len))
        active = active & ~done
        last = nxt
    return toks, lps, emitted, last, cache


@torch.no_grad()
def fused_spec_rounds(params: Params, cache: Cache, draft_params: Params,
                      draft_cache: Cache, last_tokens: torch.Tensor,
                      active: torch.Tensor, eos_ids: torch.Tensor,
                      budgets: torch.Tensor, max_len: int, slab_cap: int,
                      config: llama.LlamaConfig,
                      draft_config: llama.LlamaConfig, k: int,
                      n_rounds: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor, int, torch.Tensor,
                                 torch.Tensor, Cache, Cache]:
    """Up to `n_rounds` GREEDY speculative rounds per host dispatch.

    One round: the draft proposes `k` tokens (k sequential 1-token
    decodes over its own cache), the target verifies them in ONE [B, k]
    forward at positions L..L+k-1 fed [last, d1..d_{k-1}], and the
    longest matching prefix m is emitted plus the target's correction at
    m (emit = m+1 if m < k, else k: no bonus token, so both caches stay
    position-aligned). Greedy output is token for token plain greedy
    decode's. Per slot, the remaining budget caps a round's emission,
    then the cache-full bound `max_len`, then the first eos inside the
    budgeted span ends it at the eos. Both caches' lengths roll back to
    L + emitted; stale keys past it are invisible. A slot deactivates on
    eos, budget or `max_len`; when any live slot's next k-wide verify
    slab would pass `slab_cap`, the WHOLE batch ends its burst (a dense
    cache's clamped write would land on visible keys of a slot that
    resumes through plain decode). One `.any()` host sync per round,
    none inside the draft decodes; caches update in place.

    Returns (tokens [B, n_rounds*k] packed per slot, logprobs [B,
    n_rounds*k], emitted [B], new last tokens [B], rounds run (int),
    proposed tokens (scalar tensor), accepted [B, n_rounds] drafted
    tokens emitted per round (-1 where the slot sat out), cache,
    draft_cache)."""
    b = last_tokens.shape[0]
    dev = last_tokens.device
    idx = torch.arange(k, device=dev)[None]
    rows = torch.arange(b, device=dev)[:, None]
    toks = torch.zeros((b, n_rounds * k), dtype=torch.int32, device=dev)
    lps = torch.zeros((b, n_rounds * k), dtype=torch.float32, device=dev)
    accepted = torch.full((b, n_rounds), -1, dtype=torch.int32, device=dev)
    emitted = torch.zeros((b,), dtype=torch.int32, device=dev)
    proposed = torch.zeros((), dtype=torch.int32, device=dev)
    last = last_tokens.clone()
    act = active.clone()
    rounds = 0
    for r in range(n_rounds):
        if not bool(act.any()):
            break
        rounds += 1
        length = cache['length']
        dlast, drafts = last, []
        for _ in range(k):
            dlen = draft_cache['length']
            new_dlen = torch.where(act, dlen + 1, dlen)
            x = _hidden_with_cache(draft_params, dlast[:, None], draft_cache,
                                   dlen[:, None], dlen, new_dlen,
                                   draft_config)
            nxt = torch.argmax(_project_logits(x[:, 0], draft_params,
                                               draft_config),
                               dim=-1).to(torch.int32)
            dlast = torch.where(act, nxt, dlast)
            draft_cache['length'] = new_dlen
            drafts.append(dlast)
        drafts = torch.stack(drafts, dim=1)                  # [B, k]
        # The logits at step j predict position L+j+1: the token d_{j+1}
        # claims to be.
        inputs = torch.cat([last[:, None], drafts[:, :k - 1]], dim=1)
        x = _hidden_with_cache(params, inputs, cache, length[:, None] + idx,
                               length, torch.where(act, length + k, length),
                               config)
        logits = _project_logits(x, params, config)          # [B, k, V]
        preds = torch.argmax(logits, dim=-1).to(torch.int32)
        lp_full = torch.log_softmax(logits.float(), dim=-1)
        m = torch.cumprod((drafts == preds).to(torch.int32), dim=1).sum(
            dim=1).to(torch.int32)                           # in [0, k]
        emit = torch.where(m < k, m + 1, torch.full_like(m, k))
        corr = torch.gather(preds, 1,
                            torch.clamp(m, max=k - 1).long()[:, None])
        tokens_out = torch.where(
            idx < m[:, None], drafts,
            torch.where(idx == m[:, None], corr, torch.zeros_like(drafts)))
        chosen_lp = torch.gather(lp_full, 2,
                                 tokens_out.long()[..., None])[..., 0]
        # Truncation in the reference's order: budget, cache-full bound,
        # then the first eos inside the budgeted span.
        emit_b = torch.minimum(emit, torch.clamp(budgets - emitted, min=0))
        emit_b = torch.minimum(emit_b, torch.clamp(max_len - length, min=0))
        is_eos = (tokens_out == eos_ids[:, None]) & (idx < emit_b[:, None])
        has_eos = is_eos.any(dim=1)
        emit_eff = torch.where(has_eos, is_eos.to(torch.int32).argmax(dim=1)
                               .to(torch.int32) + 1, emit_b)
        emit_eff = torch.where(act, emit_eff, torch.zeros_like(emit_eff))
        # Pack at each slot's running offset; what lies past emit_eff is
        # overwritten by the next round or never read.
        cols = (emitted[:, None] + idx).long()
        toks[rows, cols] = tokens_out
        lps[rows, cols] = chosen_lp
        new_len = torch.where(act, length + emit_eff, length)
        cache['length'] = new_len
        draft_cache['length'] = new_len.clone()
        last_tok = torch.gather(
            tokens_out, 1, torch.clamp(emit_eff - 1, 0, k - 1).long()[:, None]
        )[:, 0]
        last = torch.where(act & (emit_eff > 0), last_tok, last)
        # Accepted counts DRAFTED tokens emitted (not the correction).
        accepted[:, r] = torch.where(act, torch.minimum(m, emit_eff),
                                     torch.full_like(m, -1))
        proposed = proposed + k * act.sum().to(torch.int32)
        emitted = emitted + emit_eff
        done = has_eos | (emitted >= budgets) | (new_len >= max_len)
        act = act & ~done
        fits = torch.where(act, new_len + k <= slab_cap,
                           torch.ones_like(act))
        act = act & fits.all()
    return (toks, lps, emitted, last, rounds, proposed, accepted, cache,
            draft_cache)


# -- host side ---------------------------------------------------------------


def default_use_flash(device: torch.device) -> bool:
    """H100 policy for `use_flash=None`: the flash kernels serve every
    prefill chunk on CUDA (the reference enables its Pallas kernel only
    on unsharded TPU engines). On the CPU the default stays dense;
    use_flash=True there runs the kernels' plain versions."""
    return device.type == 'cuda'


def resolve_kv_quant(kv_quant: Optional[str]) -> str:
    """H100 policy for kv_quant 'auto' (the reference resolves it to
    int8 on TPU): 'none' (bf16 KV) in this slice, because decode
    attention over an int8 cache is plain torch here. 'int8' stays
    fully supported; its prefill runs K2."""
    if kv_quant in (None, 'auto'):
        kv_quant = envs.SKYTPU_KV_QUANT.get()
    return 'none' if kv_quant == 'auto' else kv_quant


@dataclasses.dataclass
class _Slot:
    request_id: int
    params: SamplingParams
    generated: List[int]
    logprobs: List[float]
    prompt_len: int
    # Interleaved or warm-tail prefill: the full prompt while chunks are
    # still being written (None once decoding), and the next write
    # position.
    pending: Optional[List[int]] = None
    pos: int = 0
    # The truncated prompt: publishing a finished request's pages to the
    # prefix cache, and a snapshot, need the tokens its KV holds.
    prompt: List[int] = dataclasses.field(default_factory=list)
    # Planned handoff: paused at the prefill->decode boundary under a
    # lease; the slot and its KV stay live but sit out decode.
    handoff_pause: bool = False


class DecodeState:
    """Host-side view of the device cache + slots, on `device` (cuda
    unless named, like every entry point), holding this rank's KV heads
    under a mesh (the draft's too). With `draft_config`,
    `draft_cache` mirrors the cache for speculative decode: never
    quantised, and paged with the main cache's geometry (the same table
    width and pool size, read from the main pool's int8 leaf when the
    main cache is int8), so one allocation decision serves both tables.
    Without a draft it is None."""

    def __init__(self, config: llama.LlamaConfig, batch_size: int,
                 max_seq_len: Optional[int] = None,
                 prefill_chunk: int = 0, kv_quant: str = 'none',
                 page_size: int = 0, num_pages: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 draft_config: Optional[llama.LlamaConfig] = None,
                 mesh: Optional[mesh_lib.Mesh] = None):
        device = device_lib.resolve_device(device)
        self.max_seq_len = max_seq_len or config.max_seq_len
        pad_to = (prefill_chunk
                  if 0 < prefill_chunk < self.max_seq_len else 1)
        self.cache = init_cache(config, batch_size, self.max_seq_len,
                                pad_to=pad_to, kv_quant=kv_quant,
                                page_size=page_size, num_pages=num_pages,
                                device=device, mesh=mesh)
        self.draft_cache: Optional[Cache] = None
        if draft_config is not None:
            draft_pages = num_pages
            if page_size > 0:
                draft_pages = int(_leaf(self.cache['k']).shape[1]) - 1
            self.draft_cache = init_cache(
                draft_config, batch_size, self.max_seq_len, pad_to=pad_to,
                page_size=page_size, num_pages=draft_pages, device=device,
                mesh=mesh)
        self.last_tokens = torch.zeros((batch_size,), dtype=torch.int32,
                                       device=device)
        self.slots: List[Optional[_Slot]] = [None] * batch_size


class InferenceEngine:
    """Continuous batching over a fixed slot count.

    submit() enqueues prompts; step() admits queued requests into free
    slots (batched chunked prefill, or one chunk per step for long
    prompts and prefix-cache hits) and runs one decode round of up to
    `decode_fuse_steps` tokens for every decoding slot; results come out
    of finished(). On a paged, chunked engine the radix prefix cache is
    on unless `prefix_cache=False` or SKYTPU_PREFIX_CACHE says otherwise:
    finished requests publish their full pages, and a new prompt that
    shares a cached prefix maps those pages copy-on-write and prefills
    only its tail. snapshot_request/restore_request move a request
    between engines (of either package). Defaults come from the port's
    env registry (envs.py); explicit arguments win. Runs on CUDA unless
    `device` says otherwise.

    With a `mesh` (`parallel.mesh_from_env`; any axis, see `check_mesh`)
    this process is one rank of a sharded replica: `params` (and a
    draft's) are the full tree or this rank's slices of it, the cache
    holds this rank's KV heads (and, under `context`, its span of a
    dense cache's positions), and on a mesh of several processes rank 0
    takes the requests (submit, abort, step, snapshot, restore,
    resume_handoff) while every other rank runs `follow()`. Rank 0 calls
    `heartbeat()` while idle and `stop_followers()` when done. The paged
    layout stays the default unless SKYTPU_KV_PAGES_SHARDED says
    otherwise or the mesh has a `context` axis (dense there; an explicit
    page size raises, as in the reference), and `use_flash` stays on for
    CUDA: the kernels run per rank on its own heads and span.
    """

    def __init__(self, params: Params, config: llama.LlamaConfig,
                 batch_size: int = 8,
                 max_seq_len: Optional[int] = None,
                 seed: int = 0,
                 mesh: Optional[Any] = None,
                 prefill_chunk: int = 1024,
                 use_flash: Optional[bool] = None,
                 kv_quant: str = 'auto',
                 prefill_interleave: Optional[int] = None,
                 draft: Optional[Tuple[Params, Any]] = None,
                 spec_k: Optional[int] = None,
                 spec_fuse_rounds: Optional[int] = None,
                 decode_fuse_steps: Optional[int] = None,
                 kv_page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 prefix_cache_max_pages: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if not isinstance(config, (llama.LlamaConfig, moe_lib.MoeConfig)):
            raise NotImplementedError(
                'InferenceEngine serves llama-core families '
                '(llama/gemma/mistral/qwen) and MoE; got '
                f'{type(config).__name__}.')
        if isinstance(config, moe_lib.MoeConfig):
            # Serving must be deterministic: capacity drops depend on the
            # padded chunk's shape. A token's top-k experts are distinct,
            # so capacity_factor = X/k (cap = tokens) drops none
            # (reference :1444-1454).
            exact_cf = config.num_experts / config.num_experts_per_tok
            if config.capacity_factor < exact_cf:
                config = dataclasses.replace(config,
                                             capacity_factor=exact_cf)
        if mesh is not None:
            check_mesh(mesh, config, None if draft is None else draft[1])
            if (device is not None
                    and torch.device(device).type != mesh.device.type):
                raise ValueError(f'device {device} is not this rank\'s '
                                 f'mesh device {mesh.device}')
            device = mesh.device
        self.mesh = mesh
        # Several ranks: each holds its cut of the params.
        self._sharded = mesh is not None and mesh.world_size > 1
        self.device = device_lib.resolve_device(device)
        if use_flash is None:
            use_flash = default_use_flash(self.device)
        self._use_flash = bool(use_flash)
        kv_quant = resolve_kv_quant(kv_quant)
        if decode_fuse_steps is None:
            decode_fuse_steps = envs.SKYTPU_DECODE_FUSE_STEPS.get()
        self.decode_fuse_steps = max(1, int(decode_fuse_steps))
        explicit_paged = kv_page_size is not None
        if kv_page_size is None:
            kv_page_size = envs.SKYTPU_KV_PAGE_SIZE.get()
        if mesh is not None and not explicit_paged and (
                mesh.shape['context'] > 1
                or not envs.SKYTPU_KV_PAGES_SHARDED.get()):
            # A context axis cuts the dense cache's sequence dim, which
            # pages would indirect (reference :1496-1500): the default
            # layout is dense there, and an explicit page size raises.
            kv_page_size = 0
        self.kv_page_size = max(0, int(kv_page_size))
        if kv_pages is None:
            kv_pages = envs.SKYTPU_KV_PAGES.get()
        self.params = (_place_params(params, config, mesh, self.device)
                       if self._sharded else _to_device(params, self.device))
        self.config = config
        self.prefill_chunk = prefill_chunk
        explicit_interleave = prefill_interleave is not None
        if prefill_interleave is None:
            env_interleave = envs.SKYTPU_PREFILL_INTERLEAVE.get()
            if env_interleave is not None and env_interleave >= 0:
                prefill_interleave = env_interleave
        if prefill_interleave is None:
            prefill_interleave = 4 * prefill_chunk if prefill_chunk else 0
        if prefill_chunk <= 0:
            prefill_interleave = 0
        # Speculative decode (greedy, lossless: fused_spec_rounds). The
        # draft cache must hold every prompt, which the batched one-shot
        # prefill writes, so a draft turns interleaved prefill off.
        self._draft_params: Optional[Params] = None
        self._draft_config: Optional[llama.LlamaConfig] = None
        if spec_k is None:
            spec_k = envs.SKYTPU_SPEC_K.get()
        self.spec_k = int(spec_k)
        if spec_fuse_rounds is None:
            spec_fuse_rounds = envs.SKYTPU_SPEC_FUSE_ROUNDS.get()
        self.spec_fuse_rounds = max(1, int(spec_fuse_rounds))
        if draft is not None:
            dparams, dconfig = draft
            if dconfig.vocab_size != config.vocab_size:
                raise ValueError(
                    'draft model must share the vocab: '
                    f'{dconfig.vocab_size} != {config.vocab_size}')
            if self.spec_k < 1:
                raise ValueError(f'spec_k must be >= 1, got {self.spec_k}')
            if explicit_interleave and prefill_interleave > 0:
                raise ValueError(
                    'prefill_interleave is incompatible with a draft model '
                    '(the draft cache needs one-shot prefill); drop one of '
                    'the two.')
            self._draft_params = (
                _place_params(dparams, dconfig, mesh, self.device)
                if self._sharded else _to_device(dparams, self.device))
            self._draft_config = dconfig
            prefill_interleave = 0
        eff_max_seq_len = max_seq_len or config.max_seq_len
        if prefill_interleave > 0 and prefill_chunk >= eff_max_seq_len:
            if explicit_interleave:
                raise ValueError(
                    f'prefill_interleave={prefill_interleave} needs '
                    f'prefill_chunk ({prefill_chunk}) < max_seq_len '
                    f'({eff_max_seq_len}): interleaved prefill writes '
                    'chunk-wide slices into a cache padded to the chunk.')
            prefill_interleave = 0
        self.prefill_interleave = prefill_interleave
        self.kv_quant = kv_quant
        self.state = DecodeState(config, batch_size, max_seq_len,
                                 prefill_chunk=prefill_chunk,
                                 kv_quant=kv_quant,
                                 page_size=self.kv_page_size,
                                 num_pages=max(0, int(kv_pages)),
                                 device=self.device,
                                 draft_config=self._draft_config,
                                 mesh=mesh)
        with self._mesh_ctx():
            self._capacity = cache_capacity(self.state.cache)
        # Host-side page allocator: pages 1..P-1 are allocatable; page 0
        # is the scratch page every empty table entry points at.
        self._page_alloc: List[int] = []
        self._slot_pages: List[List[int]] = [[] for _ in range(batch_size)]
        # Per-slot table indices mapped copy-on-write from the prefix
        # cache: reads are free, a write there copies the page first.
        self._slot_shared: List[set] = [set() for _ in range(batch_size)]
        self._pages_total = 0
        if _is_paged(self.state.cache):
            self._pages_total = int(_leaf(self.state.cache['k']).shape[1]) - 1
            self._page_alloc = list(range(1, self._pages_total + 1))
        # The radix prefix cache needs the paged layout (reuse is table
        # edits over shared pages), a draft-free engine (reusing only the
        # target's pages would desynchronise the draft cache) and chunked
        # prefill (warm tails resume through prefill_chunk_at).
        if prefix_cache is None:
            prefix_cache = envs.SKYTPU_PREFIX_CACHE.get()
        if prefix_cache_max_pages is None:
            prefix_cache_max_pages = envs.SKYTPU_PREFIX_CACHE_MAX_PAGES.get()
        self.prefix_cache_max_pages = max(0, int(prefix_cache_max_pages))
        self._prefix: Optional[prefix_lib.RadixPrefixCache] = None
        if (prefix_cache and self.kv_page_size
                and self._draft_params is None and self.prefill_chunk > 0):
            self._prefix = prefix_lib.RadixPrefixCache(self.kv_page_size)
        # Per-request span parents (the server's request span, rebound
        # across the engine-loop thread hop, or an engine-owned root),
        # the submit and page-wait stamps, the head-sampling coin cached
        # at submit (no collector lock per dispatch) and the phase spans,
        # buffered as raw tuples until _trace_finish flushes them.
        self._req_trace: Dict[int, spans.SpanContext] = {}
        self._req_submit_t: Dict[int, float] = {}
        self._req_wait_t: Dict[int, float] = {}
        self._req_kept: Dict[int, bool] = {}
        self._req_phases: Dict[int, List[tuple]] = {}
        self._queue: List[Tuple[int, List[int], SamplingParams]] = []
        # Planned handoff: requests admitted with the flag, the lease
        # deadline of each paused one, and those whose snapshot the
        # server already exported.
        self._handoff_requests: set = set()
        self._handoff_deadline: Dict[int, float] = {}
        self._handoff_exported: set = set()
        self._finished: Dict[int, List[int]] = {}
        self._finished_logprobs: Dict[int, List[float]] = {}
        self._last_logprobs: Dict[int, List[float]] = {}
        self._next_id = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # This engine's share of the process-global instruments (the
        # reference's prompt/generated token, prefix-cache, handoff and
        # speculative counters and prefill/decode latency sums and
        # counts). Times cover work that ends in a host sync.
        # `spec_accepted_per_round[n]` counts (slot, round) cells that
        # accepted n drafted tokens.
        self.stats = {'prompt_tokens': 0, 'generated_tokens': 0,
                      'prefill_seconds': 0.0, 'decode_seconds': 0.0,
                      'decode_dispatches': 0, 'prefix_hits': 0,
                      'prefix_misses': 0, 'prefix_reused_tokens': 0,
                      'prefix_evictions': 0, 'cow_copies': 0,
                      'handoff_fallbacks': 0, 'spec_dispatches': 0,
                      'spec_rounds': 0, 'spec_proposed_tokens': 0,
                      'spec_accepted_tokens': 0,
                      'spec_accepted_per_round': [0] * (
                          max(0, self.spec_k) + 1)}
        # The replicated scheduler: rank 0's host events since its last
        # publish, and the channel the ranks meet on (the last step of
        # construction: every rank enters it together).
        self._events: List[tuple] = []
        self._channel: Optional[control_lib.Channel] = (
            control_lib.Channel(mesh)
            if mesh is not None and mesh.world_size > 1 else None)

    # -- public --------------------------------------------------------------

    def submit(self, prompt_tokens: List[int],
               sampling: Optional[SamplingParams] = None,
               handoff: bool = False) -> int:
        """`handoff=True` pauses the request at the prefill->decode
        boundary (first token emitted, slot held under a lease) so a
        load balancer can restore it elsewhere; on lease expiry or
        resume_handoff it decodes here as if never flagged. Ignored on
        a speculative engine (its snapshots are refused anyway). Under
        a mesh only rank 0 submits."""
        self._check_leader('submit')
        sampling = sampling or SamplingParams()
        request_id = self._submit(prompt_tokens, sampling, handoff)
        if self._channel is not None:
            self._events.append(('submit', request_id,
                                 [int(t) for t in prompt_tokens],
                                 dataclasses.asdict(sampling),
                                 bool(handoff)))
        return request_id

    def _submit(self, prompt_tokens: List[int], sampling: SamplingParams,
                handoff: bool = False) -> int:
        if not prompt_tokens:
            raise ValueError('prompt_tokens must be non-empty')
        if self.kv_page_size:
            need = self._pages_needed(
                len(prompt_tokens[:self.state.max_seq_len - 1]),
                sampling.max_new_tokens)
            if need > self._pages_total:
                raise ValueError(
                    f'request needs {need} KV pages (prompt + '
                    f'max_new_tokens) but the pool holds only '
                    f'{self._pages_total}; shorten the request or '
                    'raise kv_pages.')
        request_id = self._next_id
        self._next_id += 1
        self._queue.append((request_id, list(prompt_tokens), sampling))
        if handoff and self._draft_params is None:
            self._handoff_requests.add(request_id)
        obs.QUEUE_DEPTH.set(len(self._queue))
        self._trace_begin(request_id)
        return request_id

    def finished(self) -> Dict[int, List[int]]:
        out, self._finished = self._finished, {}
        if out:
            self._last_logprobs = self._finished_logprobs
            self._finished_logprobs = {}
        return out

    def finished_logprobs(self) -> Dict[int, List[float]]:
        """Raw-model logprobs of each generated token, for the requests
        reported by the most recent finished() call."""
        out, self._last_logprobs = self._last_logprobs, {}
        return out

    def active_progress(self) -> Dict[int, List[int]]:
        """request_id -> tokens generated so far for in-flight slots."""
        return {s.request_id: list(s.generated)
                for s in self.state.slots if s is not None}

    def abort(self, request_id: int) -> None:
        """Drop one queued or in-flight request: its pins on cached
        pages release and nothing is published. Unknown ids are a
        no-op."""
        self._check_leader('abort')
        self._abort(request_id)
        if self._channel is not None:
            self._events.append(('abort', request_id))

    def _abort(self, request_id: int) -> None:
        before = len(self._queue)
        self._queue = [(rid, t, s) for rid, t, s in self._queue
                       if rid != request_id]
        self._handoff_requests.discard(request_id)
        aborted = before - len(self._queue)
        self._finished.pop(request_id, None)
        self._finished_logprobs.pop(request_id, None)
        self._last_logprobs.pop(request_id, None)
        for i, slot in enumerate(self.state.slots):
            if slot is not None and slot.request_id == request_id:
                self._free_slot(i)
                aborted += 1
        if aborted:
            obs.REQUESTS_ABORTED.inc(aborted)
        self._trace_finish(request_id)
        self._update_gauges()

    def abort_all(self) -> None:
        """Drop every queued and in-flight request, and the whole prefix
        cache (error recovery must not trust cached KV)."""
        self._check_leader('abort_all')
        self._abort_all()
        if self._channel is not None:
            self._events.append(('abort_all',))

    def _abort_all(self) -> None:
        aborted = len(self._queue)
        self._queue.clear()
        self._handoff_requests.clear()
        self._handoff_deadline.clear()
        self._handoff_exported.clear()
        self._finished.clear()
        self._finished_logprobs.clear()
        self._last_logprobs.clear()
        for i, slot in enumerate(self.state.slots):
            if slot is not None:
                self._free_slot(i)
                aborted += 1
        if self._prefix is not None:
            self._page_alloc.extend(self._prefix.clear())
        if aborted:
            obs.REQUESTS_ABORTED.inc(aborted)
        for rid in list(self._req_trace):
            self._trace_finish(rid)
        self._update_gauges()

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(
            s is not None for s in self.state.slots)

    @property
    def has_runnable_work(self) -> bool:
        """has_work minus slots parked under a handoff lease."""
        return bool(self._queue) or any(
            s is not None and not s.handoff_pause
            for s in self.state.slots)

    def queue_depth(self) -> int:
        return len(self._queue)

    def pages_free(self) -> int:
        return len(self._page_alloc)

    def pages_total(self) -> int:
        return self._pages_total

    def pages_cached(self) -> int:
        """Pages the prefix cache indexes (pinned + reclaimable)."""
        return self._prefix.num_pages() if self._prefix is not None else 0

    def run_to_completion(self, max_steps: int = 100000
                          ) -> Dict[int, List[int]]:
        results: Dict[int, List[int]] = {}
        steps = 0
        while self.has_work and steps < max_steps:
            self.step()
            results.update(self.finished())
            steps += 1
        results.update(self.finished())
        return results

    # -- planned prefill->decode handoff -------------------------------------

    def handoff_pending(self) -> List[int]:
        """Requests paused at the prefill->decode boundary whose snapshot
        has not been exported yet. A pause only happens after the first
        token exists, so an exported blob always carries KV."""
        return [s.request_id for s in self.state.slots
                if s is not None and s.handoff_pause
                and s.request_id not in self._handoff_exported]

    def mark_handoff_exported(self, request_id: int) -> None:
        self._handoff_exported.add(request_id)

    def resume_handoff(self, request_id: int) -> bool:
        """Resume local decode of a handoff-paused request. False when
        it is not paused here (resumed by lease expiry, finished,
        aborted or never admitted): calling twice is harmless. Under a
        mesh rank 0 resumes, and its followers with it."""
        self._check_leader('resume_handoff')
        resumed = self._resume_handoff(request_id)
        if resumed and self._channel is not None:
            self._events.append(('resume', request_id))
        return resumed

    def _resume_handoff(self, request_id: int) -> bool:
        for s in self.state.slots:
            if s is not None and s.request_id == request_id:
                if not s.handoff_pause:
                    return False
                s.handoff_pause = False
                self._handoff_deadline.pop(request_id, None)
                return True
        return False

    def _maybe_pause_handoff(self, slot: _Slot) -> None:
        """Pause a handoff-flagged request now that its first token
        exists, unless it is already done or a draft is attached. An
        armed `engine.handoff_lease` fault refuses the lease: the
        request decodes here and no handoff frame is exported."""
        rid = slot.request_id
        if rid not in self._handoff_requests:
            return
        self._handoff_requests.discard(rid)
        if self._draft_params is not None:
            return
        s = slot.params
        done = (len(slot.generated) >= s.max_new_tokens
                or (s.eos_token_id is not None and slot.generated
                    and slot.generated[-1] == s.eos_token_id)
                or (slot.prompt_len + len(slot.generated)
                    >= self.state.max_seq_len - 1))
        if done:
            return
        try:
            faults.inject('engine.handoff_lease')
        except Exception:  # noqa: BLE001 — chaos seam, not a failure
            return
        slot.handoff_pause = True
        self._handoff_deadline[rid] = (
            time.monotonic() + envs.SKYTPU_HANDOFF_LEASE_SECONDS.get())

    def _expire_handoff_leases(self) -> None:
        """A lease that runs out resumes its request locally (counted as
        a fallback, never an error). Under a mesh rank 0's clock decides
        and its followers resume with it (an event; they count
        nothing)."""
        if not self._handoff_deadline:
            return
        now = time.monotonic()
        for slot in self.state.slots:
            if slot is None or not slot.handoff_pause:
                continue
            deadline = self._handoff_deadline.get(slot.request_id)
            if deadline is not None and now >= deadline:
                self._resume_handoff(slot.request_id)
                self._count('handoff_fallbacks', obs.HANDOFF_FALLBACKS)
                if self._channel is not None:
                    self._events.append(('resume', slot.request_id))

    # -- request migration (snapshot / restore) ------------------------------

    def snapshot_request(self, request_id: int) -> bytes:
        """Serialize one queued or in-flight request into a migration
        blob: its KV pages (dense: its cache row) plus prompt, generated
        tokens, logprobs, sampling state and length. Non-destructive:
        the request runs on until the caller aborts it. Queued and
        mid-prefill requests snapshot as host state only (prefill
        repays on restore; no token was generated yet). KeyError for a
        request that is not here; SnapshotError over
        SKYTPU_MIGRATION_MAX_BYTES, or for a decoding request of a
        speculative engine (its draft cache would desynchronise). An
        armed `engine.snapshot` fault raises before any device read.
        Under a mesh rank 0 snapshots: its followers join the gather of
        the request's KV heads (an event), and the blob holds every
        head."""
        self._check_leader('snapshot_request')
        faults.inject('engine.snapshot')
        with spans.span('engine.snapshot',
                        attrs={'request_id': request_id}):
            return self._snapshot_locked(request_id)

    def _snapshot_locked(self, request_id: int) -> bytes:
        for rid, tokens, sampling in self._queue:
            if rid == request_id:
                return self._pack_host_only(request_id, tokens, sampling)
        for i, slot in enumerate(self.state.slots):
            if slot is not None and slot.request_id == request_id:
                break
        else:
            raise KeyError(
                f'request {request_id} is not queued or in flight '
                '(finished or aborted — nothing to snapshot)')
        if slot.pending is not None:
            return self._pack_host_only(request_id, slot.pending,
                                        slot.params)
        if self._draft_params is not None:
            raise SnapshotError(
                'speculative engines are not migratable (the draft cache '
                'pages would desynchronize); drop the draft or let the '
                'request honest-terminate')
        length = slot.prompt_len + len(slot.generated) - 1
        header = self._snapshot_header(
            request_id, slot.prompt, slot.params, slot.prompt_len,
            generated=slot.generated, logprobs=slot.logprobs,
            length=length,
            layout='paged' if self.kv_page_size else 'dense')
        if self._channel is not None:
            # The followers join the gather now, not at the next step.
            self._events.append(('snapshot', request_id))
            self._publish()
        got = self._snapshot_kv(i, length)
        arrays: List[Tuple[str, torch.Tensor]] = []
        for name in ('k', 'v'):
            leaf = got[name]
            if _is_quant(leaf):
                arrays.append((f'{name}.q', leaf['q']))
                arrays.append((f'{name}.s', leaf['s']))
            else:
                arrays.append((name, leaf))
        nbytes = sum(a.numel() * a.element_size() for _, a in arrays)
        cap = envs.SKYTPU_MIGRATION_MAX_BYTES.get()
        if cap and nbytes > cap:
            raise SnapshotError(
                f'snapshot payload is {nbytes} bytes, over '
                f'SKYTPU_MIGRATION_MAX_BYTES={cap}; the request '
                'honest-terminates instead of shipping it')
        return _snapshot_pack(header, arrays)

    def _snapshot_kv(self, i: int, length: int) -> Optional[Dict[str, KV]]:
        """Slot i's KV at positions 0..length-1 (its pages, or its dense
        row), every KV head: under a mesh every rank gathers its
        `context` group's spans of the row and its `tensor` group's
        heads, and only rank 0 keeps the result (None elsewhere)."""
        if self.kv_page_size:
            n_used = -(-length // self.kv_page_size)
            pages = self._slot_pages[i][:n_used]
            got = {name: _gather_pool_pages(self.state.cache[name], pages)
                   for name in ('k', 'v')}
        else:
            with self._mesh_ctx():
                got = {name: _gather_dense_row(self.state.cache[name], i,
                                               length)
                       for name in ('k', 'v')}
        if not self._sharded:
            return got
        out = {}
        for name, kv in got.items():
            if _is_quant(kv):
                out[name] = {'q': self._all_heads(kv['q'], kv['q'].dim() - 2),
                             's': self._all_heads(kv['s'], kv['s'].dim() - 1)}
            else:
                out[name] = self._all_heads(kv, kv.dim() - 2)
        return out if self.mesh.rank == 0 else None

    def _all_heads(self, leaf: torch.Tensor, dim: int) -> torch.Tensor:
        """Every KV head of a leaf whose `dim` holds this rank's heads:
        gathered over `tensor` on the leaf's device (a host tensor never
        meets an NCCL group) and placed by each rank's cut."""
        tp = self.mesh.tensor_size
        parts = collectives.all_gather(leaf.contiguous(),
                                       self.mesh.tensor_group, dim)
        shape = list(leaf.shape)
        shape[dim] = self.config.num_kv_heads
        whole = leaf.new_empty(shape)
        for (lo, hi), part in zip(self._head_cuts(), parts.chunk(tp, dim)):
            whole.narrow(dim, lo, hi - lo).copy_(part)
        return whole

    def _head_cuts(self) -> List[Tuple[int, int]]:
        """Each `tensor` rank's [start, stop) of the KV heads."""
        tp = self.mesh.tensor_size
        return [sharding_lib.cut(self.config.num_kv_heads, tp, r, 'kv_heads')
                for r in range(tp)]

    def _snapshot_header(self, request_id: int, prompt: List[int],
                         sampling: SamplingParams, prompt_len: int,
                         generated: List[int] = (),
                         logprobs: List[float] = (), length: int = 0,
                         layout: str = 'none') -> Dict[str, Any]:
        """A blob's JSON header, its keys in the reference's order (the
        blobs are byte-identical). The defaults describe a host-only
        request: nothing generated, no KV."""
        return {
            'fmt': 'skytpu-kv-snapshot',
            'request_id': request_id,
            'prompt': list(prompt),
            'generated': list(generated),
            'logprobs': list(logprobs),
            'prompt_len': prompt_len,
            'sampling': dataclasses.asdict(sampling),
            'length': length,
            'max_seq_len': self.state.max_seq_len,
            'page_size': self.kv_page_size,
            'layout': layout,
        }

    def _pack_host_only(self, request_id: int, tokens: List[int],
                        sampling: SamplingParams) -> bytes:
        return _snapshot_pack(self._snapshot_header(
            request_id, tokens, sampling, len(tokens)), [])

    def restore_request(self, blob: bytes) -> int:
        """Splice a snapshot_request blob (from either package) into
        this engine and resume it: pages come from the allocator
        (reclaiming cold prefix-cache pages first) and the next step()
        decodes the next token, so greedy output continues token for
        token. Returns the NEW request id. SnapshotError for a blob
        that cannot be trusted or does not fit this engine's geometry;
        RuntimeError when no slot or not enough pages are free. Under a
        mesh rank 0 checks the blob (its arrays hold every KV head) and
        commits the host state, then publishes the restore and hands
        each rank its heads."""
        self._check_leader('restore_request')
        header, arrays = _snapshot_unpack(blob)
        with spans.span('engine.restore',
                        attrs={'origin_request_id':
                               header.get('request_id')}):
            return self._restore_locked(header, arrays)

    def _restore_locked(self, header: Dict[str, Any],
                        arrays: Optional[Dict[str, torch.Tensor]]) -> int:
        """The restore of a blob's `header` and `arrays` (None on a
        follower, which replays rank 0's checked restore and receives its
        heads)."""
        try:
            sampling = SamplingParams(**header['sampling'])
            prompt = [int(t) for t in header['prompt']]
            generated = [int(t) for t in header['generated']]
            logprobs = [float(x) for x in header['logprobs']]
            prompt_len = int(header['prompt_len'])
            length = int(header['length'])
            layout = header['layout']
            page_size = int(header['page_size'])
            max_seq_len = int(header['max_seq_len'])
        except (KeyError, TypeError, ValueError) as e:
            raise SnapshotError(
                f'snapshot header missing/malformed field: {e}') from e
        if layout == 'none' or not generated:
            # Host-only snapshot: prefill repays from scratch.
            return self.submit(prompt, sampling)
        if self._draft_params is not None:
            raise SnapshotError(
                'speculative engines are not migratable; restore on a '
                'draft-free replica')
        want_layout = 'paged' if self.kv_page_size else 'dense'
        if layout != want_layout:
            raise SnapshotError(
                f'snapshot layout {layout!r} != engine layout '
                f'{want_layout!r}')
        if self.kv_page_size and page_size != self.kv_page_size:
            raise SnapshotError(
                f'snapshot page_size {page_size} != engine '
                f'page_size {self.kv_page_size}')
        if max_seq_len != self.state.max_seq_len:
            # The eviction bound (max_seq_len - 1) decides when a
            # request stops.
            raise SnapshotError(
                f'snapshot max_seq_len {max_seq_len} != '
                f'engine max_seq_len {self.state.max_seq_len}')
        if length != prompt_len + len(generated) - 1:
            raise SnapshotError(
                f'snapshot length {length} inconsistent with '
                f'prompt_len {prompt_len} + {len(generated)} '
                'generated tokens')
        free = [i for i, s in enumerate(self.state.slots) if s is None]
        if not free:
            raise RuntimeError(
                'restore refused: no free slot (try another replica)')
        i = free[0]
        page = self.kv_page_size
        n_used = -(-length // page) if page else 0

        def check_and_get(key, leaf):
            if key not in arrays:
                raise SnapshotError(f'snapshot missing array {key!r}')
            arr = arrays[key]
            # The blob holds every KV head (dim 3 of a pool or cache leaf).
            shape = list(leaf.shape)
            shape[3] = self.config.num_kv_heads
            tail = shape[2:] if page else shape[3:]
            want_rows = n_used if page else length
            if (arr.dim() < 2 or arr.shape[0] != leaf.shape[0]
                    or arr.shape[1] != want_rows
                    or tuple(arr.shape[2:]) != tuple(tail)):
                raise SnapshotError(
                    f'snapshot array {key!r} shape {tuple(arr.shape)} '
                    f'does not fit engine leaf {tuple(leaf.shape)}')
            if arr.dtype != leaf.dtype:
                raise SnapshotError(
                    f'snapshot array {key!r} dtype '
                    f'{_DTYPE_NAMES[arr.dtype]} != engine dtype '
                    f'{_DTYPE_NAMES.get(leaf.dtype, leaf.dtype)}')
            return arr

        def build(name):
            leaf = self.state.cache[name]
            if _is_quant(leaf):
                return {'q': check_and_get(f'{name}.q', leaf['q']),
                        's': check_and_get(f'{name}.s', leaf['s'])}
            return check_and_get(name, leaf)

        data = ({'k': build('k'), 'v': build('v')} if arrays is not None
                else None)
        if page:
            w = int(self.state.cache['table'].shape[1])
            if n_used > w:
                raise SnapshotError(
                    f'snapshot spans {n_used} pages, over the table '
                    f'width {w}')
            need = max(n_used, self._pages_needed(
                prompt_len, sampling.max_new_tokens))
            if need > len(self._page_alloc):
                short = need - len(self._page_alloc)
                self._reclaim(short)
                if need > len(self._page_alloc):
                    if self._channel is not None:
                        # The eviction stands: the followers evict too.
                        self._events.append(('reclaim', short))
                    raise RuntimeError(
                        f'restore refused: needs {need} free KV pages, '
                        f'pool has {len(self._page_alloc)} (try another '
                        'replica)')
            pages = self._page_alloc[:need]
            del self._page_alloc[:need]
            self._slot_pages[i] = pages
            self._slot_shared[i] = set()
            self._set_table_rows(i, pages)
        request_id = self._next_id
        self._next_id += 1
        self._trace_begin(request_id)
        self.state.slots[i] = _Slot(request_id, sampling, generated,
                                    logprobs, prompt_len, prompt=prompt)
        if self._channel is not None and self._channel.leader:
            # The host state is committed: the followers replay it (the
            # plan hash covers the pages taken), then every rank takes
            # its heads.
            self._events.append(('restore', {
                k: v for k, v in header.items() if k != 'arrays'},
                request_id))
            self._publish()
        if self._sharded:
            data = self._scatter_kv(data, length, n_used)
        for name in ('k', 'v'):
            if page:
                _splice_pool_pages(self.state.cache[name], pages[:n_used],
                                   data[name])
            else:
                with self._mesh_ctx():
                    _splice_dense_row(self.state.cache[name], i, data[name])
        self.state.cache['length'][i] = length
        self.state.last_tokens[i] = generated[-1]
        self._update_gauges()
        return request_id

    def _scatter_kv(self, data: Optional[Dict[str, KV]], length: int,
                    n_used: int) -> Dict[str, KV]:
        """This rank's KV heads of a restore's `data` (every head, on
        rank 0; None elsewhere): rank 0's leaves broadcast to every rank
        on the pool's device, each rank keeping its own heads."""
        world = self.mesh.group(mesh_lib.AXIS_ORDER)
        lo, hi = self._head_cuts()[self.mesh.tensor_rank]
        lead = (n_used,) if self.kv_page_size else (length,)

        def mine(whole, pool, off):
            # The leaf of every head: [L, n_used or length, ...], the
            # heads `off` dims from the end.
            shape = [pool.shape[0], *lead,
                     *pool.shape[2 if self.kv_page_size else 3:]]
            shape[-off] = self.config.num_kv_heads
            buf = (torch.empty(shape, dtype=pool.dtype, device=pool.device)
                   if whole is None else whole.to(pool.device))
            buf = collectives.broadcast(buf, world, 0)
            return buf.narrow(len(shape) - off, lo, hi - lo)

        out = {}
        for name in ('k', 'v'):
            pool = self.state.cache[name]
            whole = None if data is None else data[name]
            if _is_quant(pool):
                out[name] = {
                    part: mine(None if whole is None else whole[part],
                               pool[part], off)
                    for part, off in (('q', 2), ('s', 1))}
            else:
                out[name] = mine(whole, pool, 2)
        return out

    # -- span plumbing (host-side phase attribution) -------------------------

    def _trace_begin(self, request_id: int) -> None:
        """Capture the span parent of this request at submit: the
        caller's context (the server's request span) or an engine-owned
        root when nothing upstream traces. SKYTPU_TRACE_MAX_SPANS=0
        switches phase tracing off."""
        if envs.SKYTPU_TRACE_MAX_SPANS.get() <= 0:
            return
        ctx = spans.current_context()
        if ctx is None:
            ctx = spans.SpanContext(spans.new_trace_id(),
                                    spans.new_span_id())
        spans.COLLECTOR.start_trace(ctx.trace_id)
        self._req_trace[request_id] = ctx
        self._req_kept[request_id] = spans.COLLECTOR.is_kept(ctx.trace_id)
        self._req_submit_t[request_id] = time.time()
        self._req_phases[request_id] = []

    def _trace_phase(self, request_id: int, name: str, start: float,
                     end: float, **attrs) -> None:
        buf = self._req_phases.get(request_id)
        if buf is not None:
            buf.append((name, start, end, attrs))

    def _trace_finish(self, request_id: int) -> None:
        """Completion or abort: flush the buffered phase spans and
        release the parent. A server-owned trace finalises when the
        request span closes; an engine-owned one finalises here."""
        ctx = self._req_trace.pop(request_id, None)
        phases = self._req_phases.pop(request_id, None)
        self._req_kept.pop(request_id, None)
        self._req_submit_t.pop(request_id, None)
        self._req_wait_t.pop(request_id, None)
        if ctx is None:
            return
        for name, start, end, attrs in phases or ():
            spans.COLLECTOR.record_span(
                f'engine.{name}', trace_id=ctx.trace_id,
                parent_id=ctx.span_id, start=start, end=end, attrs=attrs)
        spans.COLLECTOR.finish_trace(ctx.trace_id)

    def _trace_exemplar(self, request_ids) -> Optional[str]:
        """A kept trace id among `request_ids`, for the exemplar of a
        batched observation (the first kept wins), from the coin cached
        at submit."""
        for rid in request_ids:
            if self._req_kept.get(rid):
                return self._req_trace[rid].trace_id
        return None

    def _count(self, key: str, counter, n=1) -> None:
        """Add `n` to this engine's `stats[key]` and to the
        process-wide `counter`: each count is written here once, so the
        two cannot drift apart."""
        self.stats[key] += n
        counter.inc(n)

    def _observe_phase(self, phase: str, hist, elapsed: float,
                       request_ids) -> None:
        """Add `elapsed` to `stats[phase + '_seconds']` and observe it
        on `hist`, with a kept trace among `request_ids` as its
        exemplar."""
        self.stats[phase + '_seconds'] += elapsed
        hist.observe(elapsed, trace_id=self._trace_exemplar(request_ids))

    # -- admission and pages -------------------------------------------------

    def _pages_needed(self, prompt_len: int, max_new: int) -> int:
        """Worst-case pages a request can touch (prompt + budget + the
        speculative verify slab), capped at capacity."""
        slack = self.spec_k if self._draft_params is not None else 0
        reserve = min(prompt_len + max_new + slack, self._capacity)
        return -(-reserve // self.kv_page_size)

    def _set_table_rows(self, slot: int, pages: List[int]) -> None:
        """Point slot `slot`'s block-table row (main and draft caches)
        at `pages`; the tail targets scratch page 0."""
        w = self.state.cache['table'].shape[1]
        row = torch.tensor(pages + [0] * (w - len(pages)),
                           dtype=torch.int32).to(self.device)
        self.state.cache['table'][slot] = row
        if self.state.draft_cache is not None:
            self.state.draft_cache['table'][slot] = row

    def _insert_from_queue(self) -> None:
        free = [i for i, s in enumerate(self.state.slots) if s is None]
        if not free or not self._queue:
            return
        inserts: List[Tuple[int, List[int], SamplingParams]] = []
        slot_ids: List[int] = []
        while free and self._queue:
            matched: Optional[prefix_lib.MatchResult] = None
            t_match: Optional[Tuple[float, float]] = None
            pinned: List[int] = []
            try:
                if self.kv_page_size:
                    # FIFO page admission BEFORE popping: an
                    # oversubscribed pool holds the head request until
                    # evictions free pages.
                    _rid, peek_tokens, peek_sampling = self._queue[0]
                    peek_trunc = peek_tokens[:self.state.max_seq_len - 1]
                    need = self._pages_needed(
                        len(peek_trunc), peek_sampling.max_new_tokens)
                    need_private = need
                    if self._prefix is not None:
                        # Matched full pages map COW into the table;
                        # acquire() BEFORE any reclaim below, so eviction
                        # never harvests the pages this request matched.
                        t_match0 = time.time()
                        matched = self._prefix.match(peek_trunc)
                        t_match = (t_match0, time.time())
                        if matched.pages:
                            self._prefix.acquire(matched.pages)
                            pinned = list(matched.pages)
                        # A fully-cached prompt re-writes its last token
                        # for the first logits, which COWs the final
                        # page: one extra private page.
                        cow = 1 if (matched.pages and matched.tokens
                                    >= len(peek_trunc)) else 0
                        need_private = need - len(matched.pages) + cow
                    if need_private > len(self._page_alloc):
                        # Live requests outrank cached history.
                        self._reclaim(need_private - len(self._page_alloc))
                        if need_private > len(self._page_alloc):
                            if pinned:
                                self._prefix.release(pinned)
                                pinned = []
                            # The head request's pool wait starts here
                            # (once); its span records at admission.
                            if _rid in self._req_trace:
                                self._req_wait_t.setdefault(_rid,
                                                            time.time())
                            break
                slot = free.pop(0)
                request_id, tokens, sampling = self._queue.pop(0)
                if request_id in self._req_trace:
                    now = time.time()
                    submit_t = self._req_submit_t.pop(request_id, None)
                    if submit_t is not None:
                        self._trace_phase(request_id, 'admission_wait',
                                          submit_t, now)
                    wait_t = self._req_wait_t.pop(request_id, None)
                    if wait_t is not None:
                        self._trace_phase(request_id, 'page_pool_wait',
                                          wait_t, now)
                    if t_match is not None:
                        n_pages = len(matched.pages) if matched else 0
                        self._trace_phase(
                            request_id, 'prefix_match', t_match[0],
                            t_match[1], matched_pages=n_pages,
                            matched_tokens=(matched.tokens
                                            if n_pages else 0))
                tokens = tokens[:self.state.max_seq_len - 1]
                if self.kv_page_size:
                    fresh = self._page_alloc[:need_private]
                    del self._page_alloc[:need_private]
                    if matched is not None and matched.pages:
                        # Matched pages head the table; the one extra
                        # `cow` page rides at the END of `fresh` and goes
                        # back to the head of the free list, where
                        # _cow_slot_page takes it.
                        pages = list(matched.pages) + fresh
                        self._slot_pages[slot] = pages[:need]
                        self._slot_shared[slot] = set(
                            range(len(matched.pages)))
                        if len(pages) > need:
                            self._page_alloc[:0] = pages[need:]
                    else:
                        self._slot_pages[slot] = fresh
                        self._slot_shared[slot] = set()
                    self._set_table_rows(slot, self._slot_pages[slot])
                # The slot's page list owns the pins from here on.
                pinned = []
            except BaseException:
                # A failure between acquire() and the hand-over would
                # leak the pins forever.
                if pinned and self._prefix is not None:
                    self._prefix.release(pinned)
                raise
            # Counted after truncation, at insert: the tokens the engine
            # prefills.
            self._count('prompt_tokens', obs.PROMPT_TOKENS, len(tokens))
            if self._prefix is not None:
                hit = matched is not None and bool(matched.pages)
                if hit:
                    self._count('prefix_hits', obs.PREFIX_CACHE_HITS)
                else:
                    self._count('prefix_misses', obs.PREFIX_CACHE_MISSES)
            if matched is not None and matched.pages:
                # Warm request: prefill resumes at the first unmatched
                # token, one narrow chunk per step. A fully-cached
                # prompt re-runs only its last token, whose write lands
                # in the final shared page: COW it first.
                start = matched.tokens
                if start >= len(tokens):
                    start = len(tokens) - 1
                    self._cow_slot_page(slot, start // self.kv_page_size)
                self._count('prefix_reused_tokens',
                            obs.PREFIX_CACHE_REUSED_TOKENS, start)
                # Until its first chunk runs, the slot sits out decode
                # rounds whose masked write lands at cache['length']:
                # at 0 that is the shared page 0, so park it at the
                # resume point, in a private page. (The reference
                # leaves it at 0 and corrupts the cached prefix.)
                self.state.cache['length'][slot] = start
                self.state.slots[slot] = _Slot(
                    request_id, sampling, [], [], len(tokens),
                    pending=tokens, pos=start, prompt=tokens)
                continue
            if (self.prefill_interleave
                    and len(tokens) > self.prefill_interleave):
                # Long prompt: one chunk per step().
                self.state.slots[slot] = _Slot(
                    request_id, sampling, [], [], len(tokens),
                    pending=tokens, pos=0, prompt=tokens)
                continue
            self.state.slots[slot] = _Slot(request_id, sampling, [], [],
                                           len(tokens), prompt=tokens)
            inserts.append((request_id, tokens, sampling))
            slot_ids.append(slot)
        if not inserts:
            return
        # Power-of-two pad buckets, then whole chunks.
        max_len = max(len(t) for _, t, _ in inserts)
        bucket = 16
        while bucket < max_len:
            bucket *= 2
        bucket = min(bucket, self.state.max_seq_len - 1)
        chunk = (self.prefill_chunk
                 if 0 < self.prefill_chunk < bucket else bucket)
        bucket = -(-bucket // chunk) * chunk
        dev = self.device
        padded = torch.tensor(
            [t + [0] * (bucket - len(t)) for _, t, _ in inserts],
            dtype=torch.int64, device=dev)
        lengths = torch.tensor([len(t) for _, t, _ in inserts],
                               dtype=torch.int32, device=dev)
        slot_arr = torch.tensor(slot_ids, dtype=torch.int64, device=dev)
        t0 = time.perf_counter()
        w_prefill = time.time()
        logits, _ = prefill_chunked(
            self.params, padded, lengths, self.state.cache, slot_arr,
            self.config, chunk, use_flash=self._use_flash)
        if self._draft_params is not None:
            # The draft cache holds the prompts too (its logits are
            # discarded); dense attention, as the reference's.
            prefill_chunked(self._draft_params, padded, lengths,
                            self.state.draft_cache, slot_arr,
                            self._draft_config, chunk, use_flash=False)
        first, first_lp = self._sample_host_params(
            logits, [s for _, _, s in inserts])
        self.state.last_tokens[slot_arr] = first
        # One host sync for the whole insert; the observed latency ends
        # there and so covers the whole batched prefill.
        first_host, lp_host = first.tolist(), first_lp.tolist()
        elapsed = time.perf_counter() - t0
        self._observe_phase('prefill', obs.PREFILL_SECONDS, elapsed,
                            (r for r, _, _ in inserts))
        w_end = time.time()
        for rid, t, _s in inserts:
            self._trace_phase(rid, 'prefill', w_prefill, w_end,
                              bucket=bucket, chunk=chunk,
                              prompt_tokens=len(t))
        for i, slot in enumerate(slot_ids):
            self.state.slots[slot].generated.append(int(first_host[i]))
            self.state.slots[slot].logprobs.append(float(lp_host[i]))
            self._maybe_pause_handoff(self.state.slots[slot])
        self._count('generated_tokens', obs.GENERATED_TOKENS, len(slot_ids))

    def _sample_host_params(self, logits: torch.Tensor,
                            params: List[Optional[SamplingParams]]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """_sample with per-row sampling params built host-side (None
        rows sample greedily)."""
        dev = self.device
        temps = torch.tensor([p.temperature if p else 0.0 for p in params],
                             dtype=torch.float32, device=dev)
        topks = torch.tensor([p.top_k if p else 0 for p in params],
                             dtype=torch.int32, device=dev)
        topps = torch.tensor([p.top_p if p else 1.0 for p in params],
                             dtype=torch.float32, device=dev)
        return _sample(logits, temps, topks, topps, self._gen)

    # -- prefix-cache page machinery -----------------------------------------

    def _reclaim(self, n_pages: int) -> None:
        """LRU-evict up to `n_pages` cold refcount-0 prefix-cache pages
        back into the free pool (pinned pages are never touched)."""
        if self._prefix is None:
            return
        freed = self._prefix.evict_lru(n_pages)
        if freed:
            self._page_alloc.extend(freed)
            self._count('prefix_evictions', obs.PREFIX_CACHE_EVICTIONS,
                        len(freed))

    def _enforce_cache_cap(self) -> None:
        """Hold the radix index at prefix_cache_max_pages after a
        publish (0 = bounded only by the pool)."""
        cap = self.prefix_cache_max_pages
        if self._prefix is None or not cap:
            return
        over = self._prefix.num_pages() - cap
        if over > 0:
            self._reclaim(over)

    def _cow_slot_page(self, i: int, idx: int) -> None:
        """Copy-on-write: slot i's table entry `idx` maps a page shared
        with the radix cache and is about to be written. Copy it into a
        private page first (in-place device copy + table edit), so the
        cached original survives for the next match."""
        src = self._slot_pages[i][idx]
        if not self._page_alloc:
            self._reclaim(1)
        if not self._page_alloc:
            # Admission reserved one page per possible COW, so this is a
            # bookkeeping bug, not a load condition.
            raise RuntimeError('COW needs a free page but the pool is empty')
        dst = self._page_alloc.pop(0)
        w_cow = time.time()
        _copy_pool_page(self.state.cache['k'], src, dst)
        _copy_pool_page(self.state.cache['v'], src, dst)
        self.stats['cow_copies'] += 1
        cow_slot = self.state.slots[i]
        if cow_slot is not None:
            # Dispatch-only timing (a copy never syncs): the span marks
            # that a copy happened, and of which page.
            self._trace_phase(cow_slot.request_id, 'cow_copy', w_cow,
                              time.time(), page=src)
        self._slot_pages[i][idx] = dst
        self._slot_shared[i].discard(idx)
        self._set_table_rows(i, self._slot_pages[i])
        self._prefix.release([src])
        if not self._prefix.owns(src):
            self._page_alloc.append(src)

    def _cow_guard(self, i: int, first_pos: int, last_pos: int) -> None:
        """Before writes land at positions [first_pos, last_pos] of slot
        i, COW any shared page in that span. Matches are page-aligned
        and below the prefill resume point, so this fires only for the
        full-prompt match's last page; every write path runs it all the
        same."""
        shared = self._slot_shared[i]
        if not shared:
            return
        page = self.kv_page_size
        for idx in range(first_pos // page, last_pos // page + 1):
            if idx in shared:
                self._cow_slot_page(i, idx)

    # -- interleaved / resumed prefill ---------------------------------------

    def _advance_prefill(self) -> None:
        """ONE long-prompt chunk per step, plus every slot whose
        remainder fits one chunk (warm prefix-cache tails)."""
        long_done = False
        for i, slot in enumerate(self.state.slots):
            if slot is None or slot.pending is None:
                continue
            remaining = len(slot.pending) - slot.pos
            if remaining > self.prefill_chunk:
                if long_done:
                    continue
                long_done = True
            self._advance_prefill_slot(i, slot)

    def _advance_prefill_slot(self, i: int, slot: _Slot) -> None:
        """One chunk of prefill for slot i, at the narrowest
        power-of-two bucket that covers the remainder: a 16-token warm
        tail runs a 16-row chunk."""
        chunk = self.prefill_chunk
        start = slot.pos
        remaining = len(slot.pending) - start
        if remaining < chunk:
            bucket = 16
            while bucket < remaining:
                bucket *= 2
            chunk = min(chunk, bucket)
        toks = slot.pending[start:start + chunk]
        # The whole chunk width writes (padding included).
        self._cow_guard(i, start, start + chunk - 1)
        dev = self.device
        arr = torch.tensor([toks + [0] * (chunk - len(toks))],
                           dtype=torch.int64, device=dev)
        visible = torch.tensor([min(len(slot.pending), start + len(toks))],
                               dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        w_chunk = time.time()
        hidden, _ = prefill_chunk_at(
            self.params, arr, start, visible, self.state.cache,
            torch.tensor([i], dtype=torch.int64, device=dev), self.config,
            chunk, use_flash=self._use_flash)
        slot.pos = start + len(toks)
        if slot.pos < len(slot.pending):
            # A non-final chunk does not sync: no latency observation,
            # but its span records (dispatch only, final=False).
            self._trace_phase(slot.request_id, 'prefill_chunk', w_chunk,
                              time.time(), width=chunk, pos=start,
                              final=False)
            return
        last_idx = len(slot.pending) - 1 - start
        logits = _project_logits(hidden[:, last_idx], self.params,
                                 self.config)
        first, first_lp = self._sample_host_params(logits, [slot.params])
        self.state.last_tokens[i] = first[0]
        token, lp = int(first[0]), float(first_lp[0])
        elapsed = time.perf_counter() - t0
        self._observe_phase('prefill', obs.PREFILL_SECONDS, elapsed,
                            (slot.request_id,))
        self._trace_phase(slot.request_id, 'prefill_chunk', w_chunk,
                          time.time(), width=chunk, pos=start, final=True)
        slot.generated.append(token)
        slot.logprobs.append(lp)
        slot.pending = None
        self._count('generated_tokens', obs.GENERATED_TOKENS)
        self._maybe_pause_handoff(slot)

    # -- slots and decode ----------------------------------------------------

    def _free_slot(self, i: int, publish: bool = False) -> None:
        """Release slot i: its length zeroes in both caches (stale keys
        invisible), its table rows reset to the scratch page (its masked
        decode writes never land in a re-issued page) and its pages go
        back. With
        `publish` (normal completion) and the prefix cache, the full
        pages of prompt + generated[:-1] go to the radix index instead;
        pins on matched pages release either way."""
        slot = self.state.slots[i]
        self.state.slots[i] = None
        if slot is not None:
            self._handoff_requests.discard(slot.request_id)
            self._handoff_deadline.pop(slot.request_id, None)
            self._handoff_exported.discard(slot.request_id)
        self.state.cache['length'][i] = 0
        if self.state.draft_cache is not None:
            self.state.draft_cache['length'][i] = 0
        if not (self.kv_page_size and self._slot_pages[i]):
            self._slot_shared[i] = set()
            return
        pages = self._slot_pages[i]
        shared_pages = [pages[j] for j in sorted(self._slot_shared[i])]
        self._slot_pages[i] = []
        self._slot_shared[i] = set()
        self._set_table_rows(i, [])
        published_upto = 0
        if (publish and self._prefix is not None and slot is not None
                and slot.pending is None and slot.generated):
            # Positions 0..length-1 hold the KV of prompt +
            # generated[:-1] (the last sampled token was never fed back).
            length = slot.prompt_len + len(slot.generated) - 1
            full = length // self.kv_page_size
            if full > 0:
                seq = (slot.prompt
                       + slot.generated)[:full * self.kv_page_size]
                # Duplicates (the same span published first under other
                # page ids) come back and return to the pool.
                leftover = self._prefix.insert(seq, pages[:full])
                published_upto = full
                self._page_alloc.extend(leftover)
        if self._prefix is not None and shared_pages:
            self._prefix.release(shared_pages)
            # A released page the tree no longer owns (after clear())
            # returns to the pool.
            self._page_alloc.extend(
                p for p in shared_pages if not self._prefix.owns(p))
        shared_set = set(shared_pages)
        self._page_alloc.extend(
            p for j, p in enumerate(pages)
            if j >= published_upto and p not in shared_set)
        self._enforce_cache_cap()

    def _slot_bounds(self) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Per-slot device bounds of a decode round: remaining budgets,
        eos ids (-1 = none) and the cache-full length (max_seq_len - 2,
        exactly the host's eviction bound: see the reference)."""
        slots = self.state.slots
        dev = self.device
        budgets = torch.tensor(
            [max(0, s.params.max_new_tokens - len(s.generated))
             if (s is not None and s.pending is None) else 0
             for s in slots], dtype=torch.int32, device=dev)
        eos_arr = torch.tensor(
            [s.params.eos_token_id
             if (s is not None and s.pending is None
                 and s.params.eos_token_id is not None) else -1
             for s in slots], dtype=torch.int32, device=dev)
        return budgets, eos_arr, self.state.max_seq_len - 2

    def _spec_round(self, active_mask: List[bool]) -> None:
        """ONE speculative host dispatch: up to `spec_fuse_rounds`
        draft/verify rounds (fused_spec_rounds), up to
        spec_fuse_rounds * spec_k tokens per slot. Budget and eos
        truncation happen on the device, so the host appends exactly
        `emitted[i]` tokens, as on the fused decode path."""
        slots = self.state.slots
        active = torch.tensor(active_mask, dtype=torch.bool,
                              device=self.device)
        budgets, eos_arr, max_len = self._slot_bounds()
        t0 = time.perf_counter()
        w_step = time.time()
        (toks, lps, emitted_dev, new_last, rounds, proposed_dev,
         accepted_dev, _, _) = fused_spec_rounds(
            self.params, self.state.cache, self._draft_params,
            self.state.draft_cache, self.state.last_tokens, active,
            eos_arr, budgets, max_len, self._capacity, self.config,
            self._draft_config, self.spec_k, self.spec_fuse_rounds)
        self.state.last_tokens = new_last
        # One host sync for every output of the dispatch.
        toks_host, lps_host, emit_host, proposed, acc_host = (
            toks.tolist(), lps.tolist(), emitted_dev.tolist(),
            int(proposed_dev), accepted_dev.tolist())
        w_end = time.time()
        elapsed = time.perf_counter() - t0
        self._observe_phase('decode', obs.DECODE_STEP_SECONDS, elapsed, (
            s.request_id for s in slots
            if s is not None and s.pending is None))
        self._count('decode_dispatches', obs.DECODE_HOST_STEPS)
        self.stats['spec_dispatches'] += 1
        self._count('spec_rounds', obs.SPEC_ROUNDS, rounds)
        self._count('spec_proposed_tokens', obs.SPEC_PROPOSED_TOKENS,
                    proposed)
        # -1 marks (slot, round) cells the slot sat out; the histogram
        # drains one bulk observe per acceptance value.
        counts = [0] * (self.spec_k + 1)
        for row in acc_host:
            for n in row:
                if n >= 0:
                    counts[n] += 1
        per_round = self.stats['spec_accepted_per_round']
        accepted = 0
        for n, c in enumerate(counts):
            if c:
                per_round[n] += c
                accepted += n * c
                obs.SPEC_ACCEPTED_PER_ROUND.observe_count(float(n), c)
        self._count('spec_accepted_tokens', obs.SPEC_ACCEPTED_TOKENS,
                    accepted)
        emitted = 0
        for i, slot in enumerate(slots):
            if slot is None or slot.pending is not None:
                continue
            n = int(emit_host[i])
            slot.generated.extend(int(t) for t in toks_host[i][:n])
            slot.logprobs.extend(float(x) for x in lps_host[i][:n])
            emitted += n
            self._trace_phase(slot.request_id, 'spec_decode', w_step,
                              w_end, tokens=n, rounds=rounds,
                              proposed=proposed)
        self._count('generated_tokens', obs.GENERATED_TOKENS, emitted)
        if emitted:
            obs.DECODE_TOKENS_PER_STEP.observe(emitted)

    def _evict_finished(self) -> None:
        for i, slot in enumerate(self.state.slots):
            if slot is None or slot.pending is not None:
                continue
            s = slot.params
            hit_eos = (s.eos_token_id is not None and slot.generated and
                       slot.generated[-1] == s.eos_token_id)
            full = (slot.prompt_len + len(slot.generated) >=
                    self.state.max_seq_len - 1)
            if hit_eos or full or len(slot.generated) >= s.max_new_tokens:
                self._finished[slot.request_id] = slot.generated
                self._finished_logprobs[slot.request_id] = slot.logprobs
                self._free_slot(i, publish=True)
                obs.REQUESTS_FINISHED.inc()
                self._trace_finish(slot.request_id)

    def _update_gauges(self) -> None:
        """Refresh the continuous-batching gauges from host-side slot
        state (no device sync; slot bookkeeping mirrors the cache
        lengths)."""
        slots = self.state.slots
        active = sum(1 for s in slots if s is not None)
        obs.BATCH_SLOTS_ACTIVE.set(active)
        obs.BATCH_OCCUPANCY.set(active / max(1, len(slots)))
        obs.QUEUE_DEPTH.set(len(self._queue))
        used = sum((s.pos if s.pending is not None
                    else s.prompt_len + len(s.generated))
                   for s in slots if s is not None)
        obs.KV_CACHE_UTILIZATION.set(
            used / max(1, len(slots) * self.state.max_seq_len))
        if self.kv_page_size:
            # free + cached (radix tree) + private (slot-exclusive) =
            # total.
            obs.KV_PAGES_TOTAL.set(self._pages_total)
            obs.KV_PAGES_FREE.set(len(self._page_alloc))
            cached = self.pages_cached()
            obs.PREFIX_CACHE_PAGES.set(cached)
            obs.KV_PAGES_PRIVATE.set(
                self._pages_total - len(self._page_alloc) - cached)

    def _slab_fits(self, i: int) -> bool:
        """Does slot i's next k-wide verify slab fit the cache? Read from
        host bookkeeping: a decoding slot's cache length is exactly
        prompt_len + len(generated) - 1."""
        s = self.state.slots[i]
        return (s.prompt_len + len(s.generated) - 1
                + self.spec_k) <= self._capacity

    # -- the replicated scheduler (several ranks) ----------------------------

    def _check_leader(self, what: str) -> None:
        if self._channel is not None and not self._channel.leader:
            raise RuntimeError(
                f'{what} runs on rank 0 of the mesh; rank '
                f'{self.mesh.rank} follows it (follow())')

    def _mesh_ctx(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        return mesh_lib.use_mesh(self.mesh)

    def _plan(self) -> int:
        """A hash of the host state every rank must hold alike: ids,
        queue, slots (with their last token and handoff pause) and page
        books (a restore's pages among them)."""
        slots = tuple(
            None if s is None else (s.request_id, s.prompt_len,
                                    len(s.generated), s.generated[-1:],
                                    s.pending is None, s.pos,
                                    s.handoff_pause)
            for s in self.state.slots)
        return zlib.crc32(repr((
            self._next_id, [rid for rid, _, _ in self._queue], slots,
            self._page_alloc, self._slot_pages,
            [sorted(shared) for shared in self._slot_shared],
            self.pages_cached())).encode())

    def _publish(self, step: bool = False, stop: bool = False) -> None:
        events, self._events = self._events, []
        self._channel.publish(events, self._plan(), step=step, stop=stop)

    def _apply(self, event: tuple) -> None:
        """One of rank 0's host events, replayed on a follower: the
        host state changes as on rank 0, and a snapshot or a restore
        joins rank 0's exchange of the request's KV heads."""
        kind = event[0]
        if kind == 'submit':
            _, request_id, prompt, sampling, handoff = event
            got = self._submit(prompt, SamplingParams(**sampling), handoff)
            self._check_id('admitted', request_id, got)
        elif kind == 'abort':
            self._abort(event[1])
        elif kind == 'abort_all':
            self._abort_all()
        elif kind == 'resume':
            self._resume_handoff(event[1])
        elif kind == 'reclaim':
            self._reclaim(event[1])
        elif kind == 'snapshot':
            for i, slot in enumerate(self.state.slots):
                if slot is not None and slot.request_id == event[1]:
                    self._snapshot_kv(
                        i, slot.prompt_len + len(slot.generated) - 1)
                    break
            else:
                raise RuntimeError(f'rank {self.mesh.rank} holds no request '
                                   f'{event[1]} to snapshot')
        elif kind == 'restore':
            _, header, request_id = event
            self._check_id('restored', request_id,
                           self._restore_locked(header, None))
        else:
            raise ValueError(f'unknown host event {event!r}')

    def _check_id(self, what: str, want: int, got: int) -> None:
        if got != want:
            raise RuntimeError(f'rank {self.mesh.rank} {what} request '
                               f'{want} as {got}')

    def heartbeat(self) -> None:
        """On rank 0 of a mesh of several processes: publish (the events
        so far, no step) when the followers have heard nothing for a
        heartbeat. A no-op elsewhere."""
        ch = self._channel
        if ch is not None and ch.leader and not ch.closed and ch.due():
            self._publish()

    def stop_followers(self) -> None:
        """On rank 0: end every follower's `follow()` (once; a no-op
        without followers)."""
        ch = self._channel
        if ch is not None and ch.leader and not ch.closed:
            self._publish(stop=True)

    def follow(self) -> None:
        """On every rank but 0: apply rank 0's host events and step with
        it until it stops the followers. Raises when rank 0 is gone or
        silent past `control.TIMEOUT_SECONDS`, or when this rank's host
        plan differs from rank 0's."""
        ch = self._channel
        if ch is None or ch.leader:
            raise RuntimeError('follow() runs on the ranks after rank 0 of '
                               'a mesh of several processes')
        while True:
            msg = ch.receive()
            for event in msg['events']:
                self._apply(event)
            plan = self._plan()
            if plan != msg['plan']:
                raise RuntimeError(
                    f'rank {self.mesh.rank}\'s host plan ({plan}) left rank '
                    f'0\'s ({msg["plan"]}): the replicas diverged')
            if msg['stop']:
                return
            if msg['step']:
                with self._mesh_ctx():
                    self._step()
                # Rank 0 reports the results; a follower drops its copy.
                self.finished()
                self.finished_logprobs()

    def step(self) -> None:
        """Admit, prefill and run one decode round. On rank 0 of a mesh
        of several processes the host events since the last step (the
        leases its clock expired among them) go to the followers first,
        which step with it."""
        if self._channel is not None:
            self._check_leader('step')
        self._expire_handoff_leases()
        if self._channel is not None:
            self._publish(step=True)
        with self._mesh_ctx():
            self._step()

    def _step(self) -> None:
        self._evict_finished()
        self._insert_from_queue()
        self._advance_prefill()
        # Slots mid-prefill and slots paused under a handoff lease sit
        # out decode.
        active_mask = [s is not None and s.pending is None
                       and not s.handoff_pause for s in self.state.slots]
        if not any(active_mask):
            self._update_gauges()
            return
        if self._prefix is not None:
            # A decode write aimed at a shared page COWs it first.
            for i, on in enumerate(active_mask):
                if not on or not self._slot_shared[i]:
                    continue
                s = self.state.slots[i]
                length = s.prompt_len + len(s.generated) - 1
                self._cow_guard(i, length,
                                length + self.decode_fuse_steps - 1)
        if (self._draft_params is not None
                and all(s.params.temperature <= 0.0
                        for s in self.state.slots
                        if s is not None and s.pending is None)
                and all(self._slab_fits(i)
                        for i, on in enumerate(active_mask) if on)):
            # Greedy batch with a draft: fused speculative rounds. Near
            # the cache end the k-wide verify slab would clamp onto
            # valid keys, so such a step runs plain fused decode.
            self._spec_round(active_mask)
            self._evict_finished()
            self._update_gauges()
            return
        slots = self.state.slots
        dev = self.device
        temps = torch.tensor([s.params.temperature if s else 0.0
                              for s in slots], dtype=torch.float32,
                             device=dev)
        topks = torch.tensor([s.params.top_k if s else 0 for s in slots],
                             dtype=torch.int32, device=dev)
        topps = torch.tensor([s.params.top_p if s else 1.0 for s in slots],
                             dtype=torch.float32, device=dev)
        active = torch.tensor(active_mask, dtype=torch.bool, device=dev)
        budgets, eos_arr, max_len = self._slot_bounds()
        t0 = time.perf_counter()
        w_step = time.time()
        toks, lps, emitted_dev, new_last, _ = fused_decode_steps(
            self.params, self.state.cache, self.state.last_tokens, active,
            temps, topks, topps, eos_arr, budgets, max_len, self._gen,
            self.config, self.decode_fuse_steps)
        self.state.last_tokens = new_last
        # One host sync for every output of the round.
        toks_host, lps_host, emit_host = (toks.tolist(), lps.tolist(),
                                          emitted_dev.tolist())
        w_end = time.time()
        elapsed = time.perf_counter() - t0
        self._observe_phase('decode', obs.DECODE_STEP_SECONDS, elapsed, (
            s.request_id for s in slots
            if s is not None and s.pending is None))
        self._count('decode_dispatches', obs.DECODE_HOST_STEPS)
        emitted = 0
        for i, slot in enumerate(slots):
            if slot is None or slot.pending is not None:
                continue
            n = int(emit_host[i])
            slot.generated.extend(int(t) for t in toks_host[i][:n])
            slot.logprobs.extend(float(x) for x in lps_host[i][:n])
            emitted += n
            self._trace_phase(slot.request_id, 'decode', w_step, w_end,
                              tokens=n, fused_steps=self.decode_fuse_steps)
        # Per-token accounting of a multi-token host step, observed once
        # per step (never per slot per token).
        self._count('generated_tokens', obs.GENERATED_TOKENS, emitted)
        if emitted:
            obs.DECODE_TOKENS_PER_STEP.observe(emitted)
        self._evict_finished()
        self._update_gauges()


def check_mesh(mesh: mesh_lib.Mesh, config: Any,
               draft_config: Any = None) -> None:
    """What a mesh serves: every axis, as the reference's engine (its
    params placed by their logical axes, :1504-1513). `tensor` cuts
    heads, MLP and vocab and the cache's KV heads, `expert` an MoE's
    experts, `fsdp` every weight's `embed` dim (each layer gathered for
    its math), `context` the dense cache's sequence dim; `data` and
    `pipe` replicate (the cached path cuts no batch and runs every
    layer). The config's (and a draft's) head, KV head, MLP and vocab
    counts must split over the tensor degree (KV heads may instead
    replicate, when the degree is a multiple of them), its hidden size
    over the fsdp degree, an MoE's experts over the expert degree (a
    dense model replicates over `expert`). Raises ValueError
    (`sharding.cut`)."""
    for cfg in (config, draft_config):
        if cfg is None:
            continue
        sizes = llama.axis_sizes(cfg)
        for name in ('heads', 'kv_heads', 'mlp', 'vocab'):
            sharding_lib.cut(sizes[name], mesh.tensor_size, 0, name)
        sharding_lib.cut(sizes['embed'], mesh.shape['fsdp'], 0, 'embed',
                         'fsdp')
    if isinstance(config, moe_lib.MoeConfig):
        sharding_lib.cut(config.num_experts, mesh.shape['expert'], 0,
                         'expert', 'expert')


def _place_params(params: Params, config: Any, mesh: mesh_lib.Mesh,
                  device: torch.device) -> Params:
    """This rank's slice of every leaf on `device`: a full leaf is cut
    (`sharding.tree_shardings`), one already cut to this rank's shape is
    kept; any other shape raises."""
    sizes = llama.axis_sizes(config)

    def place(leaf, shard, axes):
        full = tuple(sizes[a] for a in axes)
        local = shard.local_shape(full)
        if tuple(leaf.shape) == full and local != full:
            leaf = shard(leaf).clone()   # a view would keep the leaf alive
        elif tuple(leaf.shape) != local:
            raise ValueError(f'a param of axes {axes} has shape '
                             f'{tuple(leaf.shape)}: neither the full {full} '
                             f'nor this rank\'s slice {local}')
        return leaf.contiguous().to(device)

    logical = llama.logical_axes(config)
    return sharding_lib.tree_map(
        place, params, sharding_lib.tree_shardings(mesh, logical), logical)


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
