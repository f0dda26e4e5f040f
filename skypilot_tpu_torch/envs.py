"""The port's copy of the SKYTPU_* knobs its serving, import,
observability and load-balancing paths read.

Same names, types and defaults as the declarations in
`skypilot_tpu/envs.py` (the reference registry); a test pins them
against it. One knob is the port's own, SKYTPU_TORCH_DIST_BACKEND (the
collectives' backend; the reference's mesh needs none). Values are read
at call time, never at import time, and a malformed value falls back to
the default, as in the reference (`strict` reads raise instead).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

_FALSEY = ('0', 'false', 'no', 'off')
_UNSET = object()


@dataclasses.dataclass(frozen=True)
class EnvVar:
    name: str
    type: type
    default: Any
    doc: str

    def get(self, default: Any = _UNSET, strict: bool = False) -> Any:
        """The parsed value; unset, empty or malformed reads give the
        declared default, or `default` where the caller's plane has its
        own (as the reference's per-call override). `strict=True`
        raises on an empty or malformed value instead, as the
        reference's does for the gang identity (two processes silently
        at process id 0 would hang the rendezvous)."""
        fallback = self.default if default is _UNSET else default
        value = os.environ.get(self.name)
        if value is None:
            return fallback
        if value == '':
            if strict:
                raise ValueError(f'{self.name} is set but empty; expected '
                                 f'a {self.type.__name__}')
            return fallback
        if self.type is bool:
            return value.strip().lower() not in _FALSEY
        try:
            return self.type(value)
        except (TypeError, ValueError):
            if strict:
                raise ValueError(f'{self.name}={value!r} is not a valid '
                                 f'{self.type.__name__}') from None
            return fallback


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
SKYTPU_MIGRATION_DEADLINE_SECONDS = _declare(
    'SKYTPU_MIGRATION_DEADLINE_SECONDS', float, 15.0,
    'Total wall-clock budget for one stream migration on the LB '
    '(snapshot fetch + restore attempts across replicas); past it '
    'the stream falls back to honest termination.')
SKYTPU_HANDOFF_DEADLINE_SECONDS = _declare(
    'SKYTPU_HANDOFF_DEADLINE_SECONDS', float, 3.0,
    'Total wall-clock budget for the LB\'s planned prefill->decode '
    'handoff (restore attempts across the decode pool); past it the '
    'LB resumes the request co-located on the prefill replica: a '
    'counted fallback, never an error. Keep it under '
    'SKYTPU_HANDOFF_LEASE_SECONDS or the lease resumes first.')
SKYTPU_HANDOFF_MAX_BYTES = _declare(
    'SKYTPU_HANDOFF_MAX_BYTES', int, 256 * 1024 * 1024,
    'Cap on a planned-handoff KV blob the LB will ship to the decode '
    'pool; larger blobs skip the transfer and resume co-located on the '
    'prefill replica (counted as a fallback).')
# The load balancer (serve/load_balancer.py) and its routing policies.
SKYTPU_LB_STREAM_READ_TIMEOUT = _declare(
    'SKYTPU_LB_STREAM_READ_TIMEOUT', float, 120.0,
    'Seconds the LB waits for the NEXT chunk from an upstream that '
    'already sent response bytes; a wedged upstream terminates the '
    'client stream instead of hanging it. 0 disables.')
SKYTPU_LB_POLICY = _declare(
    'SKYTPU_LB_POLICY', str, None,
    'Override the load-balancing policy the service spec picked '
    '(round_robin / least_load / prefix_affinity) without editing the '
    'spec: an operator escape hatch for live A/B routing runs.')
SKYTPU_LB_AFFINITY_BOUND = _declare(
    'SKYTPU_LB_AFFINITY_BOUND', float, 2.0,
    'Bounded-load constant c for prefix-affinity routing: the affine '
    'replica is skipped (least-load fallback) once its load would '
    'exceed ceil(c * (total_load + 1) / replicas).')
SKYTPU_LB_AFFINITY_PAGE_TOKENS = _declare(
    'SKYTPU_LB_AFFINITY_PAGE_TOKENS', int, 64,
    'Token-page granularity of the LB\'s prompt-prefix fingerprint '
    'index. Match the engine\'s SKYTPU_KV_PAGE_SIZE so affinity '
    'decisions align with what a replica\'s radix cache can reuse.')
SKYTPU_LB_AFFINITY_MAX_ENTRIES = _declare(
    'SKYTPU_LB_AFFINITY_MAX_ENTRIES', int, 65536,
    'LRU cap on prompt-prefix fingerprints the LB affinity index holds '
    '(each entry maps one page-aligned prefix to the replicas that '
    'served it).')
SKYTPU_LB_AFFINITY_LOAD_WINDOW = _declare(
    'SKYTPU_LB_AFFINITY_LOAD_WINDOW', float, 1.0,
    'Seconds of recent request starts counted (on top of in-flight '
    'requests) as a replica\'s load in the bounded-load check. 0 uses '
    'pure in-flight load.')
SKYTPU_LB_POOL_PROMPT_THRESHOLD = _declare(
    'SKYTPU_LB_POOL_PROMPT_THRESHOLD', int, 1024,
    'Prompt-token count at or above which a request counts as '
    'long-prompt for replica-pool routing (long-prompt + short-gen '
    'requests prefer the prefill-role pool).')
SKYTPU_LB_POOL_MAX_NEW_THRESHOLD = _declare(
    'SKYTPU_LB_POOL_MAX_NEW_THRESHOLD', int, 32,
    'max_new_tokens at or below which a request counts as short-gen for '
    'replica-pool routing; paired with SKYTPU_LB_POOL_PROMPT_THRESHOLD.')
SKYTPU_SPEC_K = _declare(
    'SKYTPU_SPEC_K', int, 4,
    'Speculative-decoding draft length: tokens the draft model proposes '
    'per big-model verify pass when a draft is attached.')
SKYTPU_SPEC_FUSE_ROUNDS = _declare(
    'SKYTPU_SPEC_FUSE_ROUNDS', int, 8,
    'Speculative draft/verify rounds fused into ONE dispatch per engine '
    'host step (up to rounds * SKYTPU_SPEC_K tokens per round-trip), '
    'aligned with SKYTPU_DECODE_FUSE_STEPS by default. 1 falls back to '
    'one host dispatch per speculative round.')
SKYTPU_WATCHDOG_INTERVAL = _declare(
    'SKYTPU_WATCHDOG_INTERVAL', float, 30.0,
    'Seconds between watchdog checks (the inference server\'s '
    'parent-death watchdog overrides the default to 5s).')
SKYTPU_HF_IMPORT_STRICT = _declare(
    'SKYTPU_HF_IMPORT_STRICT', bool, True,
    'HF checkpoint import: fail on tensors that do not map onto the '
    'parameter tree (usually a wrong config.json or family). 0 turns '
    'unexpected-tensor errors into warnings; missing tensors are always '
    'fatal.')
SKYTPU_HF_IMPORT_CONCURRENCY = _declare(
    'SKYTPU_HF_IMPORT_CONCURRENCY', int, 1,
    'Shard read/transform threads running ahead of device placement '
    'during HF checkpoint import. 1 is synchronous; N>1 keeps up to N '
    'transformed tensors on the host at once.')

# --- load shedding and training checkpoints ---------------------------------

SKYTPU_MAX_QUEUE_DEPTH = _declare(
    'SKYTPU_MAX_QUEUE_DEPTH', int, 0,
    'Inference-server load shedding: queue depth beyond which requests '
    'get a fast 503 + Retry-After. 0/unset disables.')
SKYTPU_CKPT_RETRY_GAP = _declare(
    'SKYTPU_CKPT_RETRY_GAP', float, 2.0,
    'Base backoff between checkpoint-save retries.')

# --- the observability plane (spans, time series, watchdog) and chaos -------

SKYTPU_FAULTS = _declare(
    'SKYTPU_FAULTS', str, '',
    'Comma-separated fault-injection specs '
    '(point[:times|forever[:latency]]), re-read at inject time.')
SKYTPU_TRACE_SAMPLE = _declare(
    'SKYTPU_TRACE_SAMPLE', float, 0.01,
    'Head-sampling rate for request span trees (0..1). Errored and slow '
    'requests are kept regardless of the coin; 1.0 keeps every trace.')
SKYTPU_TRACE_MAX_SPANS = _declare(
    'SKYTPU_TRACE_MAX_SPANS', int, 20000,
    'Process-wide cap on buffered spans (active + completed). Over the cap '
    'the collector evicts the oldest completed trees, then drops new spans '
    '(counted, never raised). 0 switches the engine\'s phase tracing off.')
SKYTPU_TRACE_RECORDER_CAPACITY = _declare(
    'SKYTPU_TRACE_RECORDER_CAPACITY', int, 32,
    'Completed span trees kept in the per-process flight-recorder ring.')
SKYTPU_TRACE_SLOW_SECONDS = _declare(
    'SKYTPU_TRACE_SLOW_SECONDS', float, 5.0,
    'Trace trees whose wall duration meets this threshold are kept even '
    'when the head-sampling coin said drop.')
SKYTPU_TRACE_DUMP_DIR = _declare(
    'SKYTPU_TRACE_DUMP_DIR', str, None,
    'When set, the watchdog dumps the flight-recorder ring plus the '
    'offending metric window here (TRACE_<reason>_<pid>.json, '
    'WATCHDOG_<rule>_<pid>.json) whenever a rule fires.')
SKYTPU_TS_SAMPLE_SECONDS = _declare(
    'SKYTPU_TS_SAMPLE_SECONDS', float, 5.0,
    'Seconds between background samples of the whole skytpu_* registry '
    'into the in-process time-series ring (/internal/timeseries). 0 '
    'disables the sampler thread.')
SKYTPU_TS_CAPACITY = _declare(
    'SKYTPU_TS_CAPACITY', int, 240,
    'Samples retained per series in the time-series ring.')
SKYTPU_TS_MAX_SERIES = _declare(
    'SKYTPU_TS_MAX_SERIES', int, 4096,
    'Hard cap on distinct series the time-series store retains; past it '
    'new series only displace stale ones.')
SKYTPU_WATCHDOG_TICK_SECONDS = _declare(
    'SKYTPU_WATCHDOG_TICK_SECONDS', float, 15.0,
    'Seconds between live watchdog rule evaluations over the time-series '
    'store. 0 disables the watchdog thread. (Distinct from '
    'SKYTPU_WATCHDOG_INTERVAL, the server\'s parent-death watchdog.)')
SKYTPU_WATCHDOG_RULES = _declare(
    'SKYTPU_WATCHDOG_RULES', str, None,
    'Semicolon-separated live SLO rules: pNN(metric) < x @ window, '
    'ratio(num/den1+den2) >= x @ window, within(metric, lo, hi), '
    'anomaly(metric). Unset means the built-in anomaly detectors only.')
SKYTPU_WATCHDOG_WINDOW_SECONDS = _declare(
    'SKYTPU_WATCHDOG_WINDOW_SECONDS', float, 60.0,
    'Default query window (seconds) for watchdog rules without their own '
    '@window suffix.')
SKYTPU_WATCHDOG_BREACH_TICKS = _declare(
    'SKYTPU_WATCHDOG_BREACH_TICKS', int, 2,
    'Consecutive breached watchdog evaluations before a rule fires.')
SKYTPU_WATCHDOG_CLEAR_TICKS = _declare(
    'SKYTPU_WATCHDOG_CLEAR_TICKS', int, 3,
    'Consecutive healthy watchdog evaluations before a firing rule '
    'clears.')
SKYTPU_WATCHDOG_ANOMALY_Z = _declare(
    'SKYTPU_WATCHDOG_ANOMALY_Z', float, 8.0,
    'Robust-z threshold of the EWMA anomaly detector over the decode-step '
    'and prefill latency series. 0 disables the built-in anomaly rules.')

# --- the parallel layer: gang coordinates, the sharded pool, the backend ----

SKYTPU_KV_PAGES_SHARDED = _declare(
    'SKYTPU_KV_PAGES_SHARDED', bool, True,
    'Whether engines on a tensor-sharded mesh default to the PAGED KV '
    'layout (the page pool holds each rank\'s KV heads; block tables '
    'stay replicated). 0 keeps sharded engines dense by default; an '
    'explicit kv_page_size always wins.')
SKYTPU_NUM_PROCESSES = _declare(
    'SKYTPU_NUM_PROCESSES', int, 1,
    'Injected into job processes: total processes in the gang (one per '
    'device in the port).')
SKYTPU_PROCESS_ID = _declare(
    'SKYTPU_PROCESS_ID', int, 0,
    'Injected into job processes: global index of this process (its '
    'rank).')
SKYTPU_COORDINATOR_ADDR = _declare(
    'SKYTPU_COORDINATOR_ADDR', str, None,
    'Injected into job processes: ip:port of process 0 for '
    'torch.distributed\'s rendezvous.')
SKYTPU_TORCH_DIST_BACKEND = _declare(
    'SKYTPU_TORCH_DIST_BACKEND', str, None,
    'Port-only: the backend of the mesh\'s tensor collectives (nccl | '
    'gloo). Unset: nccl on CUDA, gloo on the CPU. gloo serves several '
    'ranks on one GPU, which NCCL refuses.')
