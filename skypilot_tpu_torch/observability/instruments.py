"""The skytpu_* instrument catalog of the port, in one place.

The port's copy of the parts of `skypilot_tpu/observability/instruments.py`
that its serving, training and import paths reach: every instrument
the port's code touches, and every one the reference's engine, server,
train loop, hf_import, fault registry and watchdog touch on those
paths, with the reference's names, types, help strings, label names
and buckets (a test pins them), so one dashboard and one set of alert
rules read either package. `_UNTRACED_PATHS` and `http_middleware`
(reference :512-578) come too; the middleware wraps the port's
stdlib `BaseHTTPRequestHandler` instead of an aiohttp app.

The serving data plane's come too (`serve/load_balancer.py`, its
policies and autoscalers, `resilience/circuit.py`): `LB_*`, `POOL_*`,
`CIRCUIT_*`, and the LB-side `MIGRATION_*` and
`HANDOFF_ATTEMPTS/SUCCESSES/TRANSFER_SECONDS`.

The serve control plane's come too (`serve/controller.py`):
`SERVE_REPLICAS` and `AUTOSCALER_TARGET_REPLICAS` /
`AUTOSCALER_ACTUAL_REPLICAS` (reference :192-213), and the fleet
simulator's client-side view (`fleetsim/`): `FLEETSIM_*` (:385-).

Left out, because the port has no such plane yet: the skylet
heartbeats (`HEARTBEAT*`).

All land in metrics.REGISTRY, so the server's /metrics exposes
whatever its process touched.
"""
import contextlib
import time
import urllib.parse

from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.observability import spans
from skypilot_tpu_torch.observability import tracing

# -- inference engine (the tokens/sec/chip substrate) -----------------

PREFILL_SECONDS = metrics.Histogram(
    'skytpu_prefill_seconds',
    'Latency of one prefill call (batched insert or one interleaved '
    'chunk), including the host sync.')

DECODE_STEP_SECONDS = metrics.Histogram(
    'skytpu_decode_step_seconds',
    'Latency of one engine decode HOST step, including the host sync. '
    'One host step may cover many device decode steps (a fused '
    'lax.fori_loop round of SKYTPU_DECODE_FUSE_STEPS tokens, or a '
    'speculative round) — divide by skytpu_decode_host_step_tokens '
    'for per-token latency.')

DECODE_HOST_STEPS = metrics.Counter(
    'skytpu_decode_host_steps_total',
    'Decode host dispatches the engine issued (each covers one fused '
    'device loop, speculative round, or plain step). '
    'rate(skytpu_generated_tokens_total) / rate(this) = tokens per '
    'host round-trip — the device-residency ratio.')

DECODE_TOKENS_PER_STEP = metrics.Histogram(
    'skytpu_decode_host_step_tokens',
    'Tokens emitted per decode host step, summed over the batch: the '
    'fused-loop amortization actually achieved (N fused steps x '
    'active slots, shrunk by eos/budget early-exit).',
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
             512.0))

SPEC_ROUNDS = metrics.Counter(
    'skytpu_spec_rounds_total',
    'Speculative draft/verify rounds the engine executed on device '
    '(one round = a spec_k-token draft scan plus one big-model verify '
    'pass over the batch). With fused speculative decode '
    '(SKYTPU_SPEC_FUSE_ROUNDS) one decode host step covers many '
    'rounds; zero on engines without a draft model.')

SPEC_PROPOSED_TOKENS = metrics.Counter(
    'skytpu_spec_proposed_tokens_total',
    'Draft tokens proposed to the big model for verification '
    '(spec_k per active slot per speculative round). '
    'rate(skytpu_spec_accepted_tokens_total) / rate(this) = the '
    'draft acceptance rate — the ratio the spec_decode fleetsim '
    'scenario gates from counter deltas.')

SPEC_ACCEPTED_TOKENS = metrics.Counter(
    'skytpu_spec_accepted_tokens_total',
    'Drafted tokens the big model verified and the engine emitted. '
    'The big-model correction emitted on a mismatch is NOT counted '
    '(it was not drafted), so acceptance = this / proposed stays in '
    '[0, 1].')

SPEC_ACCEPTED_PER_ROUND = metrics.Histogram(
    'skytpu_spec_accepted_per_round',
    'Accepted draft tokens per (slot, speculative round) — the '
    'per-round acceptance distribution behind the counter ratio '
    '(0 = the first draft token was rejected; spec_k = the whole '
    'proposal accepted).',
    buckets=(0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0))

PROMPT_TOKENS = metrics.Counter(
    'skytpu_prompt_tokens_total',
    'Prompt tokens the engine prefilled (counted at slot insert, '
    'after max_seq_len truncation).')

GENERATED_TOKENS = metrics.Counter(
    'skytpu_generated_tokens_total',
    'Tokens generated by the engine. tokens/sec/chip = '
    'rate(this) / chip count.')

BATCH_OCCUPANCY = metrics.Gauge(
    'skytpu_batch_occupancy',
    'Fraction of decode-batch slots occupied (0-1): the continuous-'
    'batching utilization the throughput ceiling depends on.')

BATCH_SLOTS_ACTIVE = metrics.Gauge(
    'skytpu_batch_slots_active',
    'Decode-batch slots currently holding a request (in-flight batch '
    'size).')

QUEUE_DEPTH = metrics.Gauge(
    'skytpu_queue_depth',
    'Requests accepted but not yet inserted into a decode slot.')

KV_CACHE_UTILIZATION = metrics.Gauge(
    'skytpu_kv_cache_utilization',
    'Fraction of KV-cache positions holding live tokens '
    '(sum of per-slot lengths / (batch_size * max_seq_len)). With the '
    'paged cache this counts LOGICAL positions, not pages — see '
    'skytpu_kv_pages_free for pool pressure.')

KV_PAGES_TOTAL = metrics.Gauge(
    'skytpu_kv_pages',
    'Allocatable pages in the paged KV-cache pool (0 when the engine '
    'runs the dense per-slot cache).')

KV_PAGES_FREE = metrics.Gauge(
    'skytpu_kv_pages_free',
    'Pages currently free in the paged KV-cache pool; requests queue '
    'at insert when their worst-case reservation does not fit.')

KV_PAGES_PRIVATE = metrics.Gauge(
    'skytpu_kv_pages_private',
    'Pages held exclusively by in-flight requests (allocated at '
    'insert or copied out of the prefix cache on write; returned or '
    'published at eviction). free + private + '
    'skytpu_prefix_cache_pages = skytpu_kv_pages.')

PREFIX_CACHE_HITS = metrics.Counter(
    'skytpu_prefix_cache_hits_total',
    'Requests admitted with at least one full prompt page matched in '
    'the radix prefix cache (those pages mapped copy-on-write, '
    'prefill skipped the matched span).')

PREFIX_CACHE_MISSES = metrics.Counter(
    'skytpu_prefix_cache_misses_total',
    'Requests admitted with no cached prompt prefix (full prefill). '
    'hits / (hits + misses) over a window = the cache hit ratio the '
    'shared_prefix fleetsim scenario gates.')

PREFIX_CACHE_REUSED_TOKENS = metrics.Counter(
    'skytpu_prefix_cache_reused_tokens_total',
    'Prompt tokens whose KV was served from the prefix cache instead '
    'of recomputed by prefill. rate(this) / '
    'rate(skytpu_prompt_tokens_total) = fraction of prompt work '
    'saved.')

PREFIX_CACHE_EVICTIONS = metrics.Counter(
    'skytpu_prefix_cache_evictions_total',
    'KV pages LRU-evicted from the prefix cache (refcount-0 leaves '
    'only), to admit live requests or hold '
    'SKYTPU_PREFIX_CACHE_MAX_PAGES.')

PREFIX_CACHE_PAGES = metrics.Gauge(
    'skytpu_prefix_cache_pages',
    'KV pages currently indexed by the radix prefix cache (shared: '
    'pinned by live slots or reclaimable at refcount 0).')

REQUESTS_FINISHED = metrics.Counter(
    'skytpu_requests_finished_total',
    'Requests the engine ran to completion (eos / max tokens / cache '
    'full).')

REQUESTS_ABORTED = metrics.Counter(
    'skytpu_requests_aborted_total',
    'Requests dropped before completion (client gone, stop-string '
    'abort, engine error recovery).')

HANDOFF_FALLBACKS = metrics.Counter(
    'skytpu_handoff_fallbacks_total',
    'Handoffs that resumed decoding CO-LOCATED on the prefill '
    'replica instead of transferring: the decode pool was full, '
    'dead, or breaker-open inside SKYTPU_HANDOFF_DEADLINE_SECONDS, '
    'the blob was over SKYTPU_HANDOFF_MAX_BYTES, or the lease '
    'expired first. A fallback is a degraded success, never an '
    'error — the client stream just continues.')

REQUESTS_SHED = metrics.Counter(
    'skytpu_requests_shed_total',
    'Requests rejected with 503 + Retry-After because engine queue '
    'depth crossed the load-shedding threshold.')

# -- the load balancer and its routing policies (serve/) ------------

LB_REPLICA_REQUESTS = metrics.Counter(
    'skytpu_lb_replica_requests_total',
    'Requests the load balancer proxied, per replica endpoint.',
    labelnames=('replica',))

LB_PROXY_ERRORS = metrics.Counter(
    'skytpu_lb_proxy_errors_total',
    'Proxied requests that failed upstream (502/truncated stream).')

LB_NO_REPLICA = metrics.Counter(
    'skytpu_lb_no_replica_total',
    'Requests refused with 503 because no replica was ready.')

LB_UPSTREAM_RETRIES = metrics.Counter(
    'skytpu_lb_upstream_retries_total',
    'Proxied requests re-sent to another READY replica after an '
    'upstream failed before any response bytes were written.')

LB_AFFINITY_HITS = metrics.Counter(
    'skytpu_lb_affinity_hits_total',
    'Requests the prefix-affinity policy routed to a replica its '
    'fingerprint index predicted holds the prompt\'s warm prefix '
    'pages. hits / (hits + misses) = the LB-side affinity rate — '
    'compare against the fleet\'s skytpu_prefix_cache_* hit ratio to '
    'see whether routing or replica cache capacity moved it.')

LB_AFFINITY_MISSES = metrics.Counter(
    'skytpu_lb_affinity_misses_total',
    'Requests with a routable prompt whose page-prefix fingerprints '
    'matched no replica in the affinity index (first sight of the '
    'prefix, or its entries were LRU-evicted): routed least-load '
    'and indexed for the next request.')

LB_AFFINITY_FALLBACKS = metrics.Counter(
    'skytpu_lb_affinity_fallbacks_total',
    'Affinity-matched requests routed AWAY from their affine replica '
    'because its load exceeded the bounded-load cap '
    '(SKYTPU_LB_AFFINITY_BOUND x fleet mean): the hotspot guard '
    'firing. A sustained rate here means one prefix family is hotter '
    'than a single replica can absorb.')

LB_AFFINITY_ENTRIES = metrics.Gauge(
    'skytpu_lb_affinity_entries',
    'Prompt-prefix fingerprints currently held by the LB affinity '
    'index (LRU-capped at SKYTPU_LB_AFFINITY_MAX_ENTRIES).')

LB_POOL_REQUESTS = metrics.Counter(
    'skytpu_lb_pool_requests_total',
    'Requests the LB restricted to one replica-pool role by request '
    'shape (long-prompt/short-gen -> prefill, everything else -> '
    'decode). Requests with no parseable prompt context route '
    'unrestricted and are not counted here.',
    labelnames=('pool',))

LB_MIDSTREAM_FAILURES = metrics.Counter(
    'skytpu_lb_midstream_failures_total',
    'Proxied streams whose upstream died AFTER response bytes were '
    'written and could NOT be migrated: the LB closes the client '
    'connection (honest truncation) instead of retrying or hanging. '
    'The last rung of the failure ladder — migrated streams are '
    'counted in skytpu_migration_successes_total instead.')

# -- the serve controller (replica lifecycle, autoscaler decisions) --

SERVE_REPLICAS = metrics.Gauge(
    'skytpu_serve_replicas',
    'Replica count per service and lifecycle state.',
    labelnames=('service', 'state'))

AUTOSCALER_TARGET_REPLICAS = metrics.Gauge(
    'skytpu_autoscaler_target_replicas',
    'Replica count the autoscaler currently wants.',
    labelnames=('service',))

AUTOSCALER_ACTUAL_REPLICAS = metrics.Gauge(
    'skytpu_autoscaler_actual_replicas',
    'Live (non-failed, non-terminating) replica count the autoscaler '
    'saw at its last decision.',
    labelnames=('service',))

# -- replica pools (the autoscalers' per-pool signals) --------------

POOL_TARGET_REPLICAS = metrics.Gauge(
    'skytpu_pool_target_replicas',
    'Replica count a pool\'s signal-driven autoscaler currently '
    'wants, per service and named replica pool.',
    labelnames=('service', 'pool'))

POOL_READY_REPLICAS = metrics.Gauge(
    'skytpu_pool_ready_replicas',
    'READY replica count per service and named replica pool at the '
    'controller\'s last reconcile tick.',
    labelnames=('service', 'pool'))

POOL_QUEUE_DEPTH = metrics.Gauge(
    'skytpu_pool_queue_depth',
    'Requests accepted but not yet decoding, aggregated per replica '
    'pool — the prefill pool\'s upscale signal. Written by whatever '
    'shares the process (fleetsim, a co-located engine); absent '
    'series fall back to the fleet-wide skytpu_queue_depth.',
    labelnames=('pool',))

POOL_KV_UTILIZATION = metrics.Gauge(
    'skytpu_pool_kv_cache_utilization',
    'Mean KV-cache utilization (0-1) per replica pool — the decode '
    'pool\'s saturation signal. Absent series fall back to the '
    'fleet-wide skytpu_kv_cache_utilization.',
    labelnames=('pool',))

# -- circuit breakers (resilience/circuit.py) -----------------------

CIRCUIT_STATE = metrics.Gauge(
    'skytpu_circuit_state',
    'Circuit breaker state per breaker group and target: 0 closed, '
    '1 open, 2 half-open. An open circuit means the target is being '
    'routed around.',
    labelnames=('breaker', 'target'))

CIRCUIT_OPEN = metrics.Counter(
    'skytpu_circuit_open_total',
    'Transitions into the open state per breaker group and target '
    '(each one is a target that crossed its consecutive-failure '
    'threshold).',
    labelnames=('breaker', 'target'))

# -- mid-stream request migration, the LB's side --------------------

MIGRATION_ATTEMPTS = metrics.Counter(
    'skytpu_migration_attempts_total',
    'Interrupted in-flight requests the LB tried to migrate (one '
    'increment per interrupted request, not per restore retry): '
    'replica drain handed over a snapshot, or a mid-stream upstream '
    'death left a fetchable one.')

MIGRATION_SUCCESSES = metrics.Counter(
    'skytpu_migration_successes_total',
    'Migrations that resumed the client stream on another replica '
    'with no duplicated or dropped tokens (greedy decode continues '
    'token-for-token from the spliced KV snapshot).')

MIGRATION_FAILURES = metrics.Counter(
    'skytpu_migration_failures_total',
    'Migrations that exhausted the SKYTPU_MIGRATION_DEADLINE_SECONDS '
    'budget or every candidate replica; the stream falls through to '
    'honest termination (skytpu_lb_midstream_failures_total).')

MIGRATION_SECONDS = metrics.Histogram(
    'skytpu_migration_seconds',
    'End-to-end duration of one successful migration: interruption '
    'detected -> snapshot in hand -> restored stream\'s first byte.',
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 3.5, 5.0, 7.5, 10.0,
             15.0, 30.0))

MIGRATION_INTERRUPTION_SECONDS = metrics.Histogram(
    'skytpu_migration_interruption_seconds',
    'Client-visible token gap a migration introduced: last token '
    'before the interruption -> first token from the restored '
    'replica. The user-facing cost of surviving a preemption.',
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 3.5, 5.0, 7.5, 10.0,
             15.0, 30.0))

# -- planned prefill->decode handoff, the LB's side -----------------

HANDOFF_ATTEMPTS = metrics.Counter(
    'skytpu_handoff_attempts_total',
    'Planned prefill->decode handoffs started (one increment per '
    'exported handoff frame the LB acts on, not per restore retry).')

HANDOFF_SUCCESSES = metrics.Counter(
    'skytpu_handoff_successes_total',
    'Handoffs whose decode-pool restore resumed the client stream '
    'with no duplicated or dropped tokens; the prefill replica\'s '
    'lease releases and its slot frees.')

HANDOFF_TRANSFER_SECONDS = metrics.Histogram(
    'skytpu_handoff_transfer_seconds',
    'Duration of one successful planned handoff: handoff frame '
    'received -> restored decode-pool stream\'s first byte.',
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 3.5, 5.0, 7.5, 10.0,
             15.0, 30.0))

# -- HTTP planes ------------------------------------------------------

HTTP_REQUESTS = metrics.Counter(
    'skytpu_http_requests_total',
    'HTTP requests served, by plane (api/inference/lb), method and '
    'status code.',
    labelnames=('plane', 'method', 'code'))

HTTP_REQUEST_SECONDS = metrics.Histogram(
    'skytpu_http_request_seconds',
    'HTTP request handling latency by plane.',
    labelnames=('plane',))

# -- plane-wide: the watchdog and fault injection ---------------------

WATCHDOG_ALERTS = metrics.Counter(
    'skytpu_watchdog_alerts_total',
    'Watchdog rule transitions (state is fire or clear).',
    labelnames=('rule', 'state'))

FAULTS_INJECTED = metrics.Counter(
    'skytpu_faults_injected_total',
    'Faults fired by the deterministic fault-injection registry, per '
    'fault point (nonzero outside tests means SKYTPU_FAULTS is set).',
    labelnames=('point',))

# -- fleet simulation (the soak harness's client-side view) ---------------
# Written by skypilot_tpu_torch/fleetsim against the same registry the
# serve plane exports, so SLO assertions read one scrape — never logs.

FLEETSIM_REQUESTS = metrics.Counter(
    'skytpu_fleetsim_requests_total',
    'Simulated client requests by outcome: ok, error (every upstream '
    'failed, a real 502), no_replica / all_open (503 classes).',
    labelnames=('outcome',))

# Finer-than-default buckets around interactive TTFT: SLO p95s
# resolve to a bucket upper bound, so resolution IS assertion
# precision.
_TTFT_BUCKETS = (0.05, 0.1, 0.2, 0.35, 0.5, 0.75, 1.0, 1.5, 2.0,
                 3.0, 4.5, 7.0, 10.0, 20.0, 60.0)

FLEETSIM_TTFT_SECONDS = metrics.Histogram(
    'skytpu_fleetsim_ttft_seconds',
    'Simulated time-to-first-token per successful request (replica '
    'TTFT distribution inflated by modeled per-replica load).',
    buckets=_TTFT_BUCKETS)

FLEETSIM_DECODE_TTFT_SECONDS = metrics.Histogram(
    'skytpu_fleetsim_decode_ttft_seconds',
    'Simulated TTFT for requests served BY the decode pool — the '
    'population disaggregation protects: when the prefill pool '
    'absorbs long prompts (and hands their decode leg back), short '
    'interactive requests stop queueing behind 2k-token prefills. '
    'Compared against the co-located baseline pass in the '
    'disaggregation scenario report.',
    buckets=_TTFT_BUCKETS)

FLEETSIM_REQUEST_SECONDS = metrics.Histogram(
    'skytpu_fleetsim_request_seconds',
    'Simulated end-to-end request latency (TTFT + decoded tokens x '
    'per-token decode latency).',
    buckets=(0.25, 0.5, 1.0, 2.0, 3.5, 5.0, 7.5, 10.0, 15.0, 25.0,
             40.0, 60.0, 120.0))

FLEETSIM_RECOVERY_SECONDS = metrics.Gauge(
    'skytpu_fleetsim_recovery_seconds',
    'Simulated seconds from a chaos event (zone loss, preemption '
    'wave) until the ready-replica count recovered to its recovery '
    'target; -1 while recovery is still pending.',
    labelnames=('event',))

# -- train loop -------------------------------------------------------

TRAIN_STEP_SECONDS = metrics.Histogram(
    'skytpu_train_step_seconds',
    'Wall time of one training step (host-observed, includes async '
    'dispatch overlap).')

TRAIN_TOKENS = metrics.Counter(
    'skytpu_train_tokens_total',
    'Tokens consumed by the training loop (batch_size * seq_len per '
    'step).')

TRAIN_MFU = metrics.Gauge(
    'skytpu_train_mfu',
    'Model FLOPs utilization over the last logging window (0-1).')

TRAIN_LOSS = metrics.Gauge(
    'skytpu_train_loss',
    'Training loss at the last logging window.')

TRAIN_STEP = metrics.Gauge(
    'skytpu_train_step',
    'Last completed training step.')

# -- checkpoint plane (HF safetensors import/export) ------------------

CKPT_IMPORT_SECONDS = metrics.Histogram(
    'skytpu_ckpt_import_seconds',
    'Wall time of one HF checkpoint import (open + stream + device '
    'placement). One sample per load_params call; replica cold-start '
    'time is dominated by this plus compile.',
    buckets=(0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 120.0, 300.0, 600.0,
             1800.0))

CKPT_IMPORT_BYTES = metrics.Counter(
    'skytpu_ckpt_import_bytes_total',
    'Checkpoint bytes streamed from safetensors shards onto devices. '
    'rate(this) during a load = effective import bandwidth.')

CKPT_IMPORT_TENSORS = metrics.Counter(
    'skytpu_ckpt_import_tensors_total',
    'Tensors imported from HF checkpoints (per-layer tensors count '
    'individually — the streaming unit).')

CKPT_EXPORT_SECONDS = metrics.Histogram(
    'skytpu_ckpt_export_seconds',
    'Wall time of one HF checkpoint export (device pull + shard '
    'write + index/config emit).',
    buckets=(0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 120.0, 300.0, 600.0,
             1800.0))

CKPT_EXPORT_BYTES = metrics.Counter(
    'skytpu_ckpt_export_bytes_total',
    'Checkpoint bytes written to safetensors shards by the HF '
    'exporter.')


# Endpoints whose requests are not worth a span tree of their own
# (scrapers and probes poll them constantly and would churn the
# flight-recorder ring); an inbound traceparent still wins — if an
# upstream cared enough to propagate, we record our leg.
_UNTRACED_PATHS = frozenset(
    ('/metrics', '/health', '/internal/stats', '/internal/trace',
     '/internal/timeseries', '/internal/alerts'))


def http_middleware(plane: str):
    """Class decorator for a stdlib `BaseHTTPRequestHandler` (the
    reference's aiohttp middleware, :512-578, rebuilt): every `do_*`
    method runs inside a request-ID scope (an inbound X-Request-ID
    wins) and, unless its path is in `_UNTRACED_PATHS` with no inbound
    `traceparent`, a `<plane>.request` span grafted onto that
    traceparent, whose trace id every response carries as
    `X-Trace-ID`. Each request counts once in `HTTP_REQUESTS{plane,
    method, code}` and observes `HTTP_REQUEST_SECONDS{plane}` (with
    the trace as exemplar when kept). The code is the status the
    handler sent; 499 when the client went away (BrokenPipeError or
    ConnectionResetError out of the handler, swallowed: nobody is
    left to answer); 500 when the handler raised (a 500 is sent if no
    status was yet, and the exception propagates to the server's
    error log)."""

    def wrap(handler_cls):
        class Handler(handler_cls):
            _obs_code = None
            _obs_ctx = None

            def send_response(self, code, message=None):
                super().send_response(code, message)
                self._obs_code = code
                if self._obs_ctx is not None:
                    self.send_header(spans.TRACE_ID_RESPONSE_HEADER,
                                     self._obs_ctx.trace_id)

        def observed(method):
            def run(self):
                rid = self.headers.get('X-Request-ID') or \
                    tracing.new_request_id(plane)
                path = urllib.parse.urlsplit(self.path).path
                parent = spans.parse_traceparent(
                    self.headers.get(spans.TRACEPARENT_HEADER))
                traced = parent is not None or \
                    path not in _UNTRACED_PATHS
                start = time.perf_counter()
                self._obs_code = None
                self._obs_ctx = None
                with contextlib.ExitStack() as stack:
                    stack.enter_context(tracing.request_scope(rid))
                    attrs = {'rid': rid, 'method': self.command,
                             'path': path}
                    if traced:
                        self._obs_ctx = stack.enter_context(spans.span(
                            f'{plane}.request', parent=parent,
                            attrs=attrs))
                    code = 499
                    try:
                        method(self)
                        code = self._obs_code or 500
                    except (BrokenPipeError, ConnectionResetError):
                        code = 499
                    except Exception:
                        code = 500
                        if self._obs_code is None:
                            self.send_error(500)
                        raise
                    finally:
                        attrs['status'] = code
                        ctx, trace_id = self._obs_ctx, None
                        if ctx is not None:
                            if code >= 500:
                                spans.COLLECTOR.mark_error(ctx.trace_id)
                            trace_id = spans.exemplar_trace_id(
                                ctx.trace_id)
                        HTTP_REQUESTS.labels(plane=plane,
                                             method=self.command,
                                             code=str(code)).inc()
                        HTTP_REQUEST_SECONDS.labels(plane=plane).observe(
                            time.perf_counter() - start,
                            trace_id=trace_id)

            run.__name__ = method.__name__
            return run

        for name in dir(handler_cls):
            if name.startswith('do_'):
                setattr(Handler, name,
                        observed(getattr(handler_cls, name)))
        Handler.__name__ = Handler.__qualname__ = handler_cls.__name__
        return Handler

    return wrap
