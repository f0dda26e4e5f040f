"""The port's copy of the SKYTPU_* knobs its serving path reads.

Same names, types and defaults as the declarations in
`skypilot_tpu/envs.py` (the reference registry); a test pins them
against it. Values are read at call time, never at import time, and a
malformed value falls back to the default, as in the reference.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

_FALSEY = ('0', 'false', 'no', 'off')


@dataclasses.dataclass(frozen=True)
class EnvVar:
    name: str
    type: type
    default: Any
    doc: str

    def get(self) -> Any:
        value = os.environ.get(self.name)
        if value is None or value == '':
            return self.default
        if self.type is bool:
            return value.strip().lower() not in _FALSEY
        try:
            return self.type(value)
        except (TypeError, ValueError):
            return self.default


_REGISTRY: Dict[str, EnvVar] = {}


def _declare(name: str, type_: type, default: Any, doc: str) -> EnvVar:
    var = EnvVar(name, type_, default, doc)
    _REGISTRY[name] = var
    return var


def declared() -> Dict[str, EnvVar]:
    return dict(_REGISTRY)


SKYTPU_DECODE_FUSE_STEPS = _declare(
    'SKYTPU_DECODE_FUSE_STEPS', int, 8,
    'Decode steps run per engine host step before tokens return to the '
    'host. 1 runs one decode step per host step.')
SKYTPU_KV_QUANT = _declare(
    'SKYTPU_KV_QUANT', str, 'auto',
    'Default KV-cache quantization for engines built without an '
    'explicit kv_quant: none | int8 | auto (the port resolves auto to '
    'none on CUDA and on the CPU).')
SKYTPU_KV_PAGE_SIZE = _declare(
    'SKYTPU_KV_PAGE_SIZE', int, 64,
    'Positions per KV-cache page for the paged allocator; 0 runs the '
    'dense per-slot cache.')
SKYTPU_KV_PAGES = _declare(
    'SKYTPU_KV_PAGES', int, 0,
    'Paged KV pool size in pages (plus one scratch page); 0 sizes the '
    'pool to the dense equivalent.')
SKYTPU_PREFILL_INTERLEAVE = _declare(
    'SKYTPU_PREFILL_INTERLEAVE', int, -1,
    'Interleaved-prefill threshold in tokens: longer prompts prefill '
    'one chunk per engine step. -1 keeps the default (4x '
    'prefill_chunk); 0 disables.')
SKYTPU_PREFIX_CACHE = _declare(
    'SKYTPU_PREFIX_CACHE', bool, True,
    'Cross-request prefix KV reuse: finished requests\' full KV pages '
    'stay indexed in a radix tree; a new prompt sharing a cached prefix '
    'maps those pages copy-on-write and prefills only the unmatched '
    'tail. Paged, chunked engines only; false disables.')
SKYTPU_PREFIX_CACHE_MAX_PAGES = _declare(
    'SKYTPU_PREFIX_CACHE_MAX_PAGES', int, 0,
    'Cap on KV pages the prefix cache keeps after a publish (LRU-evicted '
    'down to it). 0 bounds it by the page pool only.')
SKYTPU_MIGRATION_ENABLE = _declare(
    'SKYTPU_MIGRATION_ENABLE', bool, True,
    'Request migration: the server honours X-SkyTPU-Handoff (planned '
    'prefill->decode handoff). Off, handoff requests serve co-located.')
SKYTPU_DRAIN_DEADLINE_SECONDS = _declare(
    'SKYTPU_DRAIN_DEADLINE_SECONDS', float, 10.0,
    'Seconds /internal/drain waits for in-flight requests to finish '
    'before snapshotting the stragglers for migration.')
SKYTPU_MIGRATION_MAX_BYTES = _declare(
    'SKYTPU_MIGRATION_MAX_BYTES', int, 256 * 1024 * 1024,
    'Cap on one request\'s serialized KV snapshot; snapshot_request '
    'refuses larger blobs. 0 disables the cap.')
SKYTPU_HANDOFF_LEASE_SECONDS = _declare(
    'SKYTPU_HANDOFF_LEASE_SECONDS', float, 5.0,
    'Seconds a handoff-paused request holds its slot waiting for the '
    'decode-leg restore or /internal/resume; past it the engine resumes '
    'decoding locally.')
