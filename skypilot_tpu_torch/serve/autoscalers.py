"""Autoscalers: QPS-target scaling with hysteresis + load signals.

The port's copy of `skypilot_tpu/serve/autoscalers.py`: `LoadSignals`
(:25), `MetricsSignalSource` (:47), which reads the port's
`observability/timeseries` store (`skytpu_prefill_seconds` p95 from
histogram bucket deltas, per-pool gauges before the fleet-wide ones),
`FixedReplicaAutoscaler` (:175), `RequestRateAutoscaler` (:184),
`FallbackRequestRateAutoscaler` (:265), `PoolAutoscaler` (:327),
`make_pool_autoscalers` (:378) and `make_autoscaler` (:388).

`RequestRateAutoscaler` scales target_qps_per_replica with
upscale/downscale delays so transient spikes/dips don't thrash;
`LoadSignals` feeds engine-side pressure (queue depth, KV-cache
utilization, latency p95s from the `skytpu_*` registry) into the same
hysteresis pipeline, so scaling can react to saturation the request
*rate* alone can't see (long prompts, slow decodes).
"""
import dataclasses
import time
from typing import Dict, List, Optional

from skypilot_tpu_torch.serve import service_spec as spec_lib


@dataclasses.dataclass
class ScalingDecision:
    target_replicas: int
    reason: str = ''


@dataclasses.dataclass(frozen=True)
class LoadSignals:
    """One reading of the fleet's load beyond raw request rate.

    queue_depth is requests accepted but not yet decoding; kv_util
    is the mean fraction of KV-cache positions holding live tokens
    (0-1); ttft_p95 / decode_step_p95 are windowed latency quantiles
    (seconds) resolved from histogram bucket deltas — the saturation
    signals the per-pool autoscalers breach-test. None means "signal
    unavailable" — scaling then falls back to whatever signals
    remain (ultimately request rate).
    """
    queue_depth: Optional[float] = None
    kv_util: Optional[float] = None
    ttft_p95: Optional[float] = None
    decode_step_p95: Optional[float] = None


# Below this many histogram samples in a read window, a p95 is noise,
# not a signal — report it unavailable instead.
_P95_MIN_SAMPLES = 5


class MetricsSignalSource:
    """Reads LoadSignals off THIS process's skytpu_* registry — the
    same series /metrics exposes, so what the autoscaler acted on is
    always scrape-able after the fact.

    Gauges (queue depth, KV utilization) read instantaneously, with
    per-pool series (skytpu_pool_queue_depth{pool=...}) preferred and
    the fleet-wide gauge as fallback when a pool series was never
    written. Latency p95s resolve from histogram bucket DELTAS
    between successive read_pools() calls (the same
    bucket-upper-bound convention the reference's fleetsim SLO
    evaluator uses), so
    one controller tick sees that tick's latency, not the process
    lifetime's.

    Scope caveat: these series are written by whatever shares the
    process — a fleet simulator, or a co-located engine. A controller
    whose replicas run elsewhere reads 0.0 (signals absent, scaling
    falls back to request rate) until a scraping source is wired in:
    the reference's controller takes any object with
    read()/read_pools() via its signal_source seam.

    The histogram windows live in the shared time-series ring
    (observability/timeseries.py): each read_pools() call appends one
    targeted sample of just its two histograms and resolves the p95
    from the bucket delta since its previous call — the identical
    window any operator can query back out of /internal/timeseries,
    instead of private snapshot bookkeeping only this object saw."""

    def __init__(self, ttft_metric: str = 'skytpu_prefill_seconds',
                 decode_step_metric: str = 'skytpu_decode_step_seconds',
                 store=None, now_fn=None) -> None:
        self.ttft_metric = ttft_metric
        self.decode_step_metric = decode_step_metric
        self._store = store
        self._now_fn = now_fn
        self._last_read: Optional[float] = None

    def _pool_gauge(self, gauge, pool: Optional[str],
                    fallback) -> float:
        """Per-pool series when it exists, fleet-wide otherwise: a
        never-written labeled gauge reads 0.0 through value(), which
        would look like 'no pressure' — existence-check instead."""
        if pool is not None:
            for series, labels, value in gauge.samples():
                if dict(labels).get('pool') == pool:
                    return value
        return fallback.value()

    def _p95_delta(self, metric_name: str, now: float
                   ) -> Optional[float]:
        import math
        store = self._resolved_store()
        # since=None on the first read means "everything so far" —
        # the same lifetime-baseline first reading the old private
        # snapshots produced.
        delta = store.hist_delta(metric_name, window=None, now=now,
                                 since=self._last_read)
        if delta is None:
            return None
        buckets, count = delta
        if count < _P95_MIN_SAMPLES:
            return None
        top_finite = None
        for bound, cum in sorted(buckets):
            if bound != math.inf:
                top_finite = bound
            if cum >= 0.95 * count:
                # A p95 past the top finite bucket is still a BREACH
                # signal, not a missing one: report the top finite
                # bound as a known floor — returning None here would
                # blind the pool autoscaler exactly at worst
                # saturation.
                return top_finite if bound == math.inf else bound
        return None

    def _resolved_store(self):
        if self._store is None:
            from skypilot_tpu_torch.observability import timeseries
            self._store = timeseries.STORE
        return self._store

    def read(self) -> LoadSignals:
        from skypilot_tpu_torch.observability import instruments as obs
        return LoadSignals(queue_depth=obs.QUEUE_DEPTH.value(),
                           kv_util=obs.KV_CACHE_UTILIZATION.value())

    def read_pools(self, pools) -> Dict[Optional[str], LoadSignals]:
        """One snapshot for all pools: the histogram windows are
        consumed ONCE per call (per-pool calls would hand the delta
        to whichever pool asked first)."""
        from skypilot_tpu_torch.observability import instruments as obs
        now = (self._now_fn or time.time)()
        # One targeted sample of just our two histograms — the whole
        # registry is the background Sampler's job, not the
        # controller tick's.
        self._resolved_store().sample_now(
            now=now, names=(self.ttft_metric,
                            self.decode_step_metric))
        ttft_p95 = self._p95_delta(self.ttft_metric, now)
        decode_p95 = self._p95_delta(self.decode_step_metric, now)
        self._last_read = now
        out: Dict[Optional[str], LoadSignals] = {}
        for pool in pools:
            out[pool] = LoadSignals(
                queue_depth=self._pool_gauge(
                    obs.POOL_QUEUE_DEPTH, pool, obs.QUEUE_DEPTH),
                kv_util=self._pool_gauge(
                    obs.POOL_KV_UTILIZATION, pool,
                    obs.KV_CACHE_UTILIZATION),
                ttft_p95=ttft_p95,
                decode_step_p95=decode_p95)
        return out


class Autoscaler:
    def __init__(self, spec: spec_lib.ServiceSpec) -> None:
        self.spec = spec

    def update_spec(self, spec: spec_lib.ServiceSpec) -> None:
        self.spec = spec

    def decide(self, num_ready: int, num_total: int,
               qps: Optional[float],
               signals: Optional[LoadSignals] = None) -> ScalingDecision:
        raise NotImplementedError


class FixedReplicaAutoscaler(Autoscaler):
    """No autoscaling: hold min_replicas."""

    def decide(self, num_ready: int, num_total: int,
               qps: Optional[float],
               signals: Optional[LoadSignals] = None) -> ScalingDecision:
        return ScalingDecision(self.spec.min_replicas, 'fixed')


class RequestRateAutoscaler(Autoscaler):
    """Scale so qps/replica ~= target, with upscale/downscale delays."""

    def __init__(self, spec: spec_lib.ServiceSpec,
                 now_fn=time.time) -> None:
        super().__init__(spec)
        self._now = now_fn
        self._upscale_since: Optional[float] = None
        self._downscale_since: Optional[float] = None

    def _desired(self, qps: float,
                 signals: Optional[LoadSignals] = None) -> int:
        import math
        target = self.spec.target_qps_per_replica
        desired = math.ceil(qps / target) if target else \
            self.spec.min_replicas
        # Pressure signals only ever RAISE the rate-derived target:
        # queue depth / KV saturation mean the current fleet is behind
        # even if qps looks fine; their absence (or low values) must
        # not fight the rate signal downward.
        if signals is not None:
            tqd = self.spec.target_queue_per_replica
            if tqd and signals.queue_depth:
                desired = max(desired,
                              math.ceil(signals.queue_depth / tqd))
            kv_hi = self.spec.kv_util_upscale_threshold
            if kv_hi is not None and signals.kv_util is not None and \
                    signals.kv_util >= kv_hi:
                # Saturated caches: one more replica per decision
                # round — bounded pressure relief, hysteresis still
                # paces the actual resize.
                desired += 1
        lo = self.spec.min_replicas
        hi = self.spec.max_replicas or max(lo, desired)
        return max(lo, min(hi, desired))

    def decide(self, num_ready: int, num_total: int,
               qps: Optional[float],
               signals: Optional[LoadSignals] = None) -> ScalingDecision:
        if qps is None:
            return ScalingDecision(max(num_total, self.spec.min_replicas),
                                   'no traffic data')
        desired = self._desired(qps, signals)
        now = self._now()
        if desired > num_total:
            self._downscale_since = None
            if self._upscale_since is None:
                self._upscale_since = now
            if now - self._upscale_since >= self.spec.upscale_delay_seconds:
                self._upscale_since = None
                return ScalingDecision(
                    desired, f'qps={qps:.2f} sustained above target')
            return ScalingDecision(num_total, 'upscale pending delay')
        if desired < num_total:
            self._upscale_since = None
            if self._downscale_since is None:
                self._downscale_since = now
            if now - self._downscale_since >= \
                    self.spec.downscale_delay_seconds:
                self._downscale_since = None
                return ScalingDecision(
                    desired, f'qps={qps:.2f} sustained below target')
            return ScalingDecision(num_total, 'downscale pending delay')
        self._upscale_since = None
        self._downscale_since = None
        return ScalingDecision(num_total, 'at target')


@dataclasses.dataclass
class MixedScalingDecision:
    """Spot + on-demand targets (reference FallbackRequestRateAutoscaler,
    autoscalers.py:557)."""
    target_spot: int
    target_ondemand: int
    reason: str = ''

    @property
    def target_replicas(self) -> int:
        return self.target_spot + self.target_ondemand


class FallbackRequestRateAutoscaler(RequestRateAutoscaler):
    """Request-rate scaling over a spot fleet with on-demand fallback.

    The traffic-derived target is served by spot. On top of that:
    - base_ondemand_fallback_replicas are ALWAYS on-demand (a safety
      floor that survives any spot stockout);
    - with dynamic_ondemand_fallback, spot capacity lost to preemption
      is covered by extra on-demand replicas until spot recovers.
    """

    def decide_mixed(self, num_ready_spot: int, num_spot: int,
                     num_ondemand: int,
                     qps: Optional[float],
                     signals: Optional[LoadSignals] = None
                     ) -> MixedScalingDecision:
        base = self.spec.base_ondemand_fallback_replicas
        dynamic = self.spec.dynamic_ondemand_fallback
        current = num_spot + num_ondemand
        # Hysteresis-filtered total target over the whole fleet.
        total = self.decide(num_ready_spot + num_ondemand, current,
                            qps, signals).target_replicas
        if total == current:
            # Hold: no resize is due (at target, or a scale is pending
            # its hysteresis delay) — keep the pools as they are, only
            # covering unready spot with on-demand if dynamic.
            spot_target, ondemand_target = num_spot, num_ondemand
            if dynamic:
                shortfall = max(0, num_spot - num_ready_spot)
                # Cap the cover at what the RATE actually needs beyond
                # ready spot. Capping at the hysteresis-held `total`
                # (== current) compounds instead: every tick's cover
                # inflates `current`, which licenses a bigger cover
                # next tick — during a spot stockout that launched
                # shortfall-many NEW on-demand replicas per tick,
                # unboundedly (caught by the reference's fleetsim
                # preemption_wave soak).
                if qps is None:
                    cover_cap = num_ondemand
                else:
                    cover_cap = max(0, self._desired(qps, signals)
                                    - num_ready_spot)
                ondemand_target = min(num_ondemand + shortfall,
                                      max(num_ondemand, cover_cap))
                if self.spec.max_replicas is not None:
                    # The user's hard spend ceiling outranks cover:
                    # spot pool + cover together never exceed it.
                    ondemand_target = min(
                        ondemand_target,
                        max(0, self.spec.max_replicas - num_spot))
        else:
            spot_target = max(0, total - base)
            ondemand_target = min(base, total)
            if dynamic:
                # Cover the spot shortfall (requested minus ready) with
                # on-demand; shrinks automatically as spot recovers.
                shortfall = max(0, spot_target - num_ready_spot)
                ondemand_target = min(total, ondemand_target + shortfall)
        return MixedScalingDecision(
            spot_target, ondemand_target,
            f'total={total} spot_ready={num_ready_spot}')


class PoolAutoscaler(RequestRateAutoscaler):
    """Signal-driven scaling for ONE named replica pool.

    The pool's role picks its saturation signals via the PoolSpec
    thresholds: a prefill pool scales on queue depth + TTFT p95, a
    decode pool on KV utilization + decode-step p95 — never raw
    request rate alone (target_qps_per_replica is optional and, when
    set, interprets the FLEET rate as a floor, since per-pool request
    rates are not separable at the tracker). Inherits the
    upscale/downscale hysteresis so p95 blips don't thrash the pool.
    """

    def __init__(self, pool: spec_lib.PoolSpec,
                 now_fn=time.time) -> None:
        # PoolSpec quacks like the spec the hysteresis base class
        # reads (min/max_replicas, delays); Autoscaler.__init__ just
        # stores it.
        super().__init__(pool, now_fn=now_fn)

    def _desired(self, qps: float,
                 signals: Optional[LoadSignals] = None) -> int:
        import math
        p = self.spec
        desired = p.min_replicas
        if p.target_qps_per_replica:
            desired = max(desired,
                          math.ceil(qps / p.target_qps_per_replica))
        # Pressure signals only ever RAISE the target (same rule as
        # the fleet-wide autoscaler): their absence must not fight
        # the other signals downward.
        if signals is not None:
            if p.target_queue_per_replica and signals.queue_depth:
                desired = max(
                    desired, math.ceil(signals.queue_depth
                                       / p.target_queue_per_replica))
            for value, threshold in (
                    (signals.kv_util, p.kv_util_upscale_threshold),
                    (signals.ttft_p95, p.ttft_p95_upscale_threshold),
                    (signals.decode_step_p95,
                     p.decode_step_p95_upscale_threshold)):
                if threshold is not None and value is not None and \
                        value >= threshold:
                    # One extra replica per breached signal per
                    # decision round: bounded relief, hysteresis
                    # still paces the resize.
                    desired += 1
        hi = p.max_replicas if p.max_replicas is not None else \
            max(p.min_replicas, desired)
        return max(p.min_replicas, min(hi, desired))


def make_pool_autoscalers(spec: spec_lib.ServiceSpec,
                          now_fn=time.time
                          ) -> Dict[str, PoolAutoscaler]:
    """One PoolAutoscaler per named pool (empty for poolless specs)."""
    if not spec.pools:
        return {}
    return {name: PoolAutoscaler(pool, now_fn=now_fn)
            for name, pool in spec.pools.items()}


def make_autoscaler(spec: spec_lib.ServiceSpec,
                    now_fn=time.time) -> Autoscaler:
    """now_fn is the hysteresis clock seam: a simulator or a test runs
    upscale/downscale delays on a virtual clock, production uses
    time.time."""
    if spec.use_spot and (spec.base_ondemand_fallback_replicas > 0
                          or spec.dynamic_ondemand_fallback):
        return FallbackRequestRateAutoscaler(spec, now_fn=now_fn)
    if spec.max_replicas is not None and \
            spec.max_replicas > spec.min_replicas and \
            spec.target_qps_per_replica is not None:
        return RequestRateAutoscaler(spec, now_fn=now_fn)
    return FixedReplicaAutoscaler(spec)
