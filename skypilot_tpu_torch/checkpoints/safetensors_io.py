"""The port's safetensors reader and writer (mmap'd lazy views).

Ports `skypilot_tpu/checkpoints/safetensors_io.py` (`dtype_tag`,
`is_float_dtype`, `LazyTensor`, `SafeTensorsFile`, `CheckpointReader`,
`_nearest`, `write_safetensors`, `ShardedWriter`) without `ml_dtypes`
and without the `safetensors` package. The format:

    [8 bytes LE u64: header length N][N bytes JSON header][payload]

where the header maps tensor name -> {"dtype", "shape",
"data_offsets": [begin, end]} (offsets relative to the payload start)
plus an optional "__metadata__" string map. Multi-shard checkpoints add
`model.safetensors.index.json` with {"weight_map": {name -> shard}}.

bf16 has no numpy dtype here: a BF16 tensor is read as its raw bits, a
numpy uint16 view (`LazyTensor.read`), and `to_torch` reinterprets those
bits as `torch.bfloat16`, as `weights.py` does. The writer takes numpy
arrays (uint16 is written as BF16; an array whose dtype is named
'bfloat16' too) or torch tensors of any dtype the format has.

A shard is mmap'd once; `LazyTensor.read()` is a zero-copy view onto the
mapping, so bytes enter memory only as they are touched. Copies (casts,
the transposes of `hf_import`) happen downstream, where the importer
accounts for them. Headers are validated at open: offsets must tile the
payload exactly, and an index naming a missing shard or tensor fails.
"""
from __future__ import annotations

import dataclasses
import json
import mmap
import os
import shutil
import struct
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

INDEX_FILENAME = 'model.safetensors.index.json'

# safetensors dtype tag -> the numpy dtype its bytes are read as (BF16:
# raw bits as uint16) and the torch dtype they hold.
_DTYPES: Dict[str, Tuple[np.dtype, torch.dtype]] = {
    'F64': (np.dtype(np.float64), torch.float64),
    'F32': (np.dtype(np.float32), torch.float32),
    'F16': (np.dtype(np.float16), torch.float16),
    'BF16': (np.dtype(np.uint16), torch.bfloat16),
    'I64': (np.dtype(np.int64), torch.int64),
    'I32': (np.dtype(np.int32), torch.int32),
    'I16': (np.dtype(np.int16), torch.int16),
    'I8': (np.dtype(np.int8), torch.int8),
    'U8': (np.dtype(np.uint8), torch.uint8),
    'BOOL': (np.dtype(np.bool_), torch.bool),
}
_NP_TAGS = {np_dtype: tag for tag, (np_dtype, _) in _DTYPES.items()}
_TORCH_TAGS = {t_dtype: tag for tag, (_, t_dtype) in _DTYPES.items()}

# One header must not be able to exhaust memory before validation (a
# 100B-class model's header is ~10 MB).
_MAX_HEADER_BYTES = 512 * 1024 * 1024


class CheckpointFormatError(ValueError):
    """A safetensors file or directory that violates the format: the
    message names the file, the tensor and what was expected."""


def dtype_tag(dtype: Any) -> str:
    """A numpy dtype (uint16 or one named 'bfloat16' is BF16) or a torch
    dtype -> its safetensors tag ('BF16', 'F32', ...)."""
    if isinstance(dtype, torch.dtype):
        tag = _TORCH_TAGS.get(dtype)
    else:
        np_dtype = np.dtype(dtype)
        tag = ('BF16' if np_dtype.name == 'bfloat16'
               else _NP_TAGS.get(np_dtype))
    if tag is None:
        raise CheckpointFormatError(
            f'dtype {dtype} has no safetensors encoding; supported: '
            f'{sorted(_DTYPES)}')
    return tag


_FLOAT_TAGS = frozenset(('F64', 'F32', 'F16', 'BF16'))


def is_float_dtype(tag: str) -> bool:
    """Is this safetensors dtype tag a float (BF16 included, whose bits
    are read as uint16 here)?"""
    return tag in _FLOAT_TAGS


def to_float32(arr: np.ndarray, tag: str) -> np.ndarray:
    """A float array of `tag`'s storage dtype widened to f32 (BF16: its
    uint16 bits shifted into the high half of an f32)."""
    if tag == 'BF16':
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.astype(np.float32)


def to_torch(arr: np.ndarray, tag: str) -> torch.Tensor:
    """A numpy array of `tag`'s storage dtype -> a tensor of its torch
    dtype over the same memory (BF16: the uint16 bits reinterpreted)."""
    if tag == 'BF16':
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _host_array(x: Any) -> Tuple[str, np.ndarray]:
    """(tag, C-contiguous numpy array of the bytes to write) of a numpy
    array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        tag = dtype_tag(t.dtype)
        if tag == 'BF16':
            return tag, t.view(torch.int16).numpy().view(np.uint16)
        return tag, t.numpy()
    arr = np.ascontiguousarray(x)
    tag = dtype_tag(arr.dtype)
    if tag == 'BF16':
        arr = arr.view(np.uint16)
    return tag, arr


@dataclasses.dataclass(frozen=True)
class LazyTensor:
    """One tensor's header entry and a window onto its shard's mmap.
    `read()` is zero-copy: a numpy view of the mapped bytes (BF16 as
    uint16); `to_torch(view, tensor.tag)` gives the tensor."""
    name: str
    tag: str
    dtype: np.dtype               # the storage dtype read() returns
    shape: Tuple[int, ...]
    nbytes: int
    shard: str                    # shard filename (diagnostics)
    _mm: mmap.mmap = dataclasses.field(repr=False)
    _start: int = 0               # absolute offset into the shard file

    def read(self) -> np.ndarray:
        count = int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1
        flat = np.frombuffer(self._mm, dtype=self.dtype, count=count,
                             offset=self._start)
        return flat.reshape(self.shape)


def _parse_header(raw: bytes, path: str) -> Dict[str, Any]:
    try:
        header = json.loads(raw.decode('utf-8'))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CheckpointFormatError(
            f'{path}: header is not valid JSON ({e})') from None
    if not isinstance(header, dict):
        raise CheckpointFormatError(
            f'{path}: header must be a JSON object, got '
            f'{type(header).__name__}')
    return header


class SafeTensorsFile:
    """One mmap'd .safetensors shard: the header parsed and validated at
    open, its tensors as LazyTensor views."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, 'rb')  # noqa: SIM115 — lives with self
        try:
            size = os.fstat(self._file.fileno()).st_size
            if size < 8:
                raise CheckpointFormatError(
                    f'{path}: {size} bytes is too short to hold the '
                    '8-byte header length')
            (header_len,) = struct.unpack('<Q', self._file.read(8))
            if header_len > _MAX_HEADER_BYTES or 8 + header_len > size:
                raise CheckpointFormatError(
                    f'{path}: header length {header_len} exceeds the '
                    f'file ({size} bytes): truncated or corrupt')
            header = _parse_header(self._file.read(header_len), path)
            self.metadata: Dict[str, str] = header.pop('__metadata__',
                                                       {}) or {}
            self._mm = mmap.mmap(self._file.fileno(), 0,
                                 access=mmap.ACCESS_READ)
            payload_start = 8 + header_len
            payload_size = size - payload_start
            self.tensors: Dict[str, LazyTensor] = {}
            spans: List[Tuple[int, int, str]] = []
            for name, entry in header.items():
                self.tensors[name] = self._entry(
                    name, entry, payload_start, payload_size)
                begin, end = entry['data_offsets']
                spans.append((int(begin), int(end), name))
            # Offsets must tile the payload exactly: a gap is a truncated
            # rewrite, an overlap aliased garbage.
            spans.sort()
            cursor = 0
            for begin, end, name in spans:
                if begin != cursor:
                    raise CheckpointFormatError(
                        f'{path}: tensor {name!r} starts at payload '
                        f'offset {begin}, expected {cursor} (gap or '
                        'overlap: corrupt header)')
                cursor = end
            if cursor != payload_size:
                raise CheckpointFormatError(
                    f'{path}: payload is {payload_size} bytes but the '
                    f'header accounts for {cursor}: truncated file or '
                    'stale header')
        except Exception:
            self._file.close()
            raise

    def _entry(self, name: str, entry: Any, payload_start: int,
               payload_size: int) -> LazyTensor:
        if not isinstance(entry, dict) or not all(
                k in entry for k in ('dtype', 'shape', 'data_offsets')):
            raise CheckpointFormatError(
                f'{self.path}: tensor {name!r} entry must carry '
                'dtype/shape/data_offsets')
        tag = entry['dtype']
        if tag not in _DTYPES:
            raise CheckpointFormatError(
                f'{self.path}: tensor {name!r} has unsupported dtype '
                f'{tag!r}; supported: {sorted(_DTYPES)}')
        dtype = _DTYPES[tag][0]
        shape = tuple(int(d) for d in entry['shape'])
        begin, end = (int(v) for v in entry['data_offsets'])
        count = 1
        for d in shape:
            count *= d
        expected = count * dtype.itemsize
        if begin < 0 or end < begin or end > payload_size:
            raise CheckpointFormatError(
                f'{self.path}: tensor {name!r} data_offsets '
                f'[{begin}, {end}) fall outside the {payload_size}-'
                'byte payload: truncated file or corrupt header')
        if end - begin != expected:
            raise CheckpointFormatError(
                f'{self.path}: tensor {name!r} spans {end - begin} '
                f'bytes but shape {shape} x {tag} needs {expected}')
        return LazyTensor(name=name, tag=tag, dtype=dtype, shape=shape,
                          nbytes=expected,
                          shard=os.path.basename(self.path),
                          _mm=self._mm, _start=payload_start + begin)

    def close(self) -> None:
        self._mm.close()
        self._file.close()

    def __enter__(self) -> 'SafeTensorsFile':
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class CheckpointReader:
    """A checkpoint directory (or one file): every shard's tensors behind
    one name -> LazyTensor namespace. `model.safetensors.index.json`
    names the shards when present (and only those files are opened);
    otherwise every *.safetensors file in the directory is a shard."""

    def __init__(self, path: str):
        path = os.path.abspath(os.path.expanduser(path))
        self.path = path
        self._files: List[SafeTensorsFile] = []
        self.tensors: Dict[str, LazyTensor] = {}
        self.weight_map: Dict[str, str] = {}
        if os.path.isfile(path):
            shard_paths = [path]
        else:
            index_path = os.path.join(path, INDEX_FILENAME)
            if os.path.exists(index_path):
                with open(index_path, encoding='utf-8') as f:
                    try:
                        index = json.load(f)
                    except json.JSONDecodeError as e:
                        raise CheckpointFormatError(
                            f'{index_path}: invalid JSON ({e})') from None
                weight_map = index.get('weight_map')
                if not isinstance(weight_map, dict) or not weight_map:
                    raise CheckpointFormatError(
                        f'{index_path}: missing/empty "weight_map"')
                self.weight_map = dict(weight_map)
                shard_paths = [os.path.join(path, fn) for fn in
                               sorted(set(weight_map.values()))]
                missing = [p for p in shard_paths if not os.path.exists(p)]
                if missing:
                    raise CheckpointFormatError(
                        f'{index_path} names shards that do not exist: '
                        f'{[os.path.basename(p) for p in missing]}')
            else:
                shard_paths = sorted(
                    os.path.join(path, fn) for fn in os.listdir(path)
                    if fn.endswith('.safetensors'))
                if not shard_paths:
                    raise CheckpointFormatError(
                        f'{path}: no *.safetensors shards and no '
                        f'{INDEX_FILENAME}')
        try:
            for shard_path in shard_paths:
                shard = SafeTensorsFile(shard_path)
                self._files.append(shard)
                for name, tensor in shard.tensors.items():
                    if name in self.tensors:
                        raise CheckpointFormatError(
                            f'tensor {name!r} appears in both '
                            f'{self.tensors[name].shard} and '
                            f'{tensor.shard}')
                    self.tensors[name] = tensor
        except Exception:
            self.close()
            raise
        # Every index entry must resolve: a weight_map naming a tensor its
        # shard lacks is a torn download.
        for name, fn in self.weight_map.items():
            got = self.tensors.get(name)
            if got is None or got.shard != fn:
                raise CheckpointFormatError(
                    f'{INDEX_FILENAME} maps {name!r} -> {fn!r} but the '
                    'shard holds '
                    f'{"nothing" if got is None else repr(got.shard)}')

    def names(self) -> List[str]:
        return sorted(self.tensors)

    def tensor(self, name: str) -> LazyTensor:
        try:
            return self.tensors[name]
        except KeyError:
            raise KeyError(
                f'{self.path}: no tensor {name!r}; nearest: '
                f'{_nearest(name, self.tensors)}') from None

    @property
    def total_bytes(self) -> int:
        return sum(t.nbytes for t in self.tensors.values())

    @property
    def num_shards(self) -> int:
        return len(self._files)

    def close(self) -> None:
        for f in self._files:
            f.close()

    def __enter__(self) -> 'CheckpointReader':
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _nearest(name: str, names: Iterable[str], k: int = 3) -> List[str]:
    """Suggestions for an error message: the longest shared prefix wins
    (HF names are dotted paths, so this finds the right layer and
    projection)."""
    def shared(a: str, b: str) -> int:
        n = 0
        for ca, cb in zip(a, b):
            if ca != cb:
                break
            n += 1
        return n
    return sorted(names, key=lambda other: -shared(name, other))[:k]


def _layout(x: Any) -> Tuple[str, List[int], int]:
    """(tag, shape, bytes) of a numpy array or a torch tensor on any
    device, without copying it."""
    if isinstance(x, torch.Tensor):
        return (dtype_tag(x.dtype), list(x.shape),
                x.numel() * x.element_size())
    arr = np.asarray(x)
    return dtype_tag(arr.dtype), list(arr.shape), arr.nbytes


def write_safetensors(path: str, tensors: Dict[str, Any],
                      metadata: Optional[Dict[str, str]] = None) -> int:
    """Write one shard of numpy arrays or torch tensors (on any device),
    in insertion order (so offsets are deterministic); returns payload
    bytes. The header comes from the tensors' shapes and dtypes, and
    each tensor's bytes are copied to the host only as it is written,
    so the host holds one tensor at a time."""
    header: Dict[str, Any] = {}
    if metadata:
        header['__metadata__'] = dict(metadata)
    cursor = 0
    for name, x in tensors.items():
        tag, shape, nbytes = _layout(x)
        header[name] = {'dtype': tag, 'shape': shape,
                        'data_offsets': [cursor, cursor + nbytes]}
        cursor += nbytes
    raw = json.dumps(header, separators=(',', ':')).encode('utf-8')
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        f.write(struct.pack('<Q', len(raw)))
        f.write(raw)
        for x in tensors.values():
            _tag, arr = _host_array(x)
            arr.tofile(f)  # straight from the buffer, no bytes copy
    os.replace(tmp, path)  # no torn shard if the write dies
    return cursor


class ShardedWriter:
    """Streaming multi-shard writer: `add()` tensors one at a time; a new
    shard starts when the current one would exceed `max_shard_bytes`.
    `close()` names the shards HF's way (`model-0000i-of-0000n
    .safetensors`, or `model.safetensors` alone with no index) and writes
    the index. Each tensor's bytes go to the shard's payload file inside
    `add()`, so the writer holds no more than the tensor it was given."""

    def __init__(self, out_dir: str, max_shard_bytes: int = 5 * 2**30,
                 metadata: Optional[Dict[str, str]] = None):
        if max_shard_bytes <= 0:
            raise ValueError('max_shard_bytes must be positive')
        self.out_dir = os.path.abspath(os.path.expanduser(out_dir))
        os.makedirs(self.out_dir, exist_ok=True)
        self.max_shard_bytes = max_shard_bytes
        self.metadata = metadata
        self._header: Dict[str, Any] = {}
        self._payload = None          # open temp file of raw bytes
        self._payload_path: Optional[str] = None
        self._current_bytes = 0
        # Finished shards, not named yet: (tmp path, names). The i-of-n
        # names need n, known only at close().
        self._done: List[Tuple[str, List[str]]] = []
        self._total = 0

    def add(self, name: str, x: Any) -> None:
        if name in self._header or any(
                name in names for _, names in self._done):
            raise ValueError(f'tensor {name!r} added twice')
        tag, arr = _host_array(x)
        if (self._payload is not None
                and self._current_bytes + arr.nbytes > self.max_shard_bytes):
            self._finish_shard()
        if self._payload is None:
            self._payload_path = os.path.join(
                self.out_dir, f'.shard-{len(self._done):05d}.payload')
            self._payload = open(self._payload_path, 'wb')  # noqa: SIM115
            self._header = {}
            self._current_bytes = 0
        self._header[name] = {
            'dtype': tag, 'shape': list(arr.shape),
            'data_offsets': [self._current_bytes,
                             self._current_bytes + arr.nbytes]}
        arr.tofile(self._payload)
        self._current_bytes += arr.nbytes
        self._total += arr.nbytes

    def _finish_shard(self) -> None:
        if self._payload is None:
            return
        self._payload.close()
        header: Dict[str, Any] = {}
        if self.metadata:
            header['__metadata__'] = dict(self.metadata)
        header.update(self._header)
        raw = json.dumps(header, separators=(',', ':')).encode('utf-8')
        tmp = self._payload_path + '.shard'
        with open(tmp, 'wb') as out, \
                open(self._payload_path, 'rb') as payload:
            out.write(struct.pack('<Q', len(raw)))
            out.write(raw)
            shutil.copyfileobj(payload, out)
        os.remove(self._payload_path)
        self._done.append((tmp, list(self._header)))
        self._payload = self._payload_path = None
        self._header, self._current_bytes = {}, 0

    def close(self) -> List[str]:
        """Finish every shard and the index; returns the file names
        written. Shards and an index left in the directory by an earlier
        export are removed: the reader would trust them."""
        self._finish_shard()
        if not self._done:
            raise ValueError('no tensors were added')
        n = len(self._done)
        written: List[str] = []
        weight_map: Dict[str, str] = {}
        for i, (tmp, names) in enumerate(self._done):
            fn = ('model.safetensors' if n == 1 else
                  f'model-{i + 1:05d}-of-{n:05d}.safetensors')
            os.replace(tmp, os.path.join(self.out_dir, fn))
            for name in names:
                weight_map[name] = fn
            written.append(fn)
        if n > 1:
            index = {'metadata': {'total_size': self._total},
                     'weight_map': weight_map}
            with open(os.path.join(self.out_dir, INDEX_FILENAME), 'w',
                      encoding='utf-8') as f:
                json.dump(index, f, indent=2, sort_keys=True)
            written.append(INDEX_FILENAME)
        keep = set(written)
        for fn in os.listdir(self.out_dir):
            if fn in keep:
                continue
            if fn.endswith('.safetensors') or fn == INDEX_FILENAME:
                os.remove(os.path.join(self.out_dir, fn))
        return written
