"""Mock replica processes: the fleet the real controller reconciles.

The port of `skypilot_tpu/fleetsim/replicas.py` (`ReplicaProfile`,
`SimReplica`, `SimFleet`: scale_up / scale_down / probe_all /
ready_endpoints / terminate_all, the chaos sweep, the migration and
handoff ladders, `handle_request`, `end_tick`).

`SimFleet` implements the exact surface `serve.controller.
ServeController` needs from a replica manager (scale_up / scale_down /
probe_all / ready_endpoints / terminate_all) and keeps the REAL
serve_state DB as its source of truth — the controller's rolling
updates, surge protection and autoscaling read the same rows they
would in production. What is simulated is the replica itself:
startup latency, per-request TTFT / decode-latency distributions
(lognormal, seeded), and death.

Chaos composition: replicas die THROUGH the resilience.faults
registry. A zone marked lost routes every kill through the
`fleet.zone_loss` point; a preemption wave kills exactly as many spot
replicas as the point's armed `times` bound. Kills are therefore
visible in `skytpu_faults_injected_total` and can be armed from
SKYTPU_FAULTS like any other fault.
"""
import dataclasses
import enum
import math
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch.observability import instruments as obs
from skypilot_tpu_torch.resilience import faults
from skypilot_tpu_torch.serve import serve_state


class ReplicaKilled(Exception):
    """Raised through a fleet.* fault point to kill one replica."""


@dataclasses.dataclass(frozen=True)
class ReplicaProfile:
    """Latency/capacity shape of one mock replica process.

    Two decode parameterizations:
    - legacy: `decode_per_token_s` (flat per-token cost, no histogram
      traffic) — the pre-fused-engine model, kept so existing
      scenarios reproduce bit-for-bit;
    - fused-loop: `decode_step_s` > 0 models the engine's
      device-resident rounds — each request costs
      ceil(tokens / fused_steps) HOST steps whose latencies are
      sampled lognormally around `decode_step_s` and observed into
      the REAL skytpu_decode_step_seconds histogram, so SLOs gate the
      same series production scrapes.
    """
    startup_median_s: float = 60.0     # provision + model load
    startup_sigma: float = 0.35        # lognormal spread
    ttft_median_s: float = 0.35        # unloaded time-to-first-token
    ttft_sigma: float = 0.45
    decode_per_token_s: float = 0.03   # per generated token (legacy)
    tokens_median: int = 64            # generated tokens per request
    concurrency: int = 16              # decode slots per replica
    decode_step_s: float = 0.0         # fused host-step median; 0=off
    decode_step_sigma: float = 0.3
    fused_steps: int = 8               # device steps per host step
    # Prefix-cache term: fraction of requests whose prompt
    # prefix is warm in the replica's radix cache. A hit skips the
    # matched span's prefill — its TTFT sample scales by
    # warm_ttft_factor BEFORE load inflation (warm requests still
    # queue behind busy slots) — and hits/misses/reused-tokens land
    # in the REAL skytpu_prefix_cache_* counters, so the
    # shared_prefix scenario's hit-ratio SLO reads the same series a
    # production engine exports.
    prefix_hit_ratio: float = 0.0      # 0 = no prefix-cache modeling
    warm_ttft_factor: float = 0.12     # warm TTFT / cold TTFT
    shared_prefix_tokens: int = 0      # reused tokens per hit
    # CONTENT-aware prefix cache: capacity > 0 replaces
    # the random hit model above with a per-replica LRU over the
    # prefix keys the replica has actually served — a hit happens iff
    # THIS replica saw THIS prefix family recently, so the fleet-wide
    # hit ratio becomes a function of ROUTING (prefix-affinity keeps
    # families pinned, least_load scatters them), which is exactly
    # what the prefix_affinity scenario measures. Hits/misses land in
    # the same REAL skytpu_prefix_cache_* counters.
    prefix_cache_capacity: int = 0     # prefix families cached; 0=off
    # Speculative decode term: spec_k > 0 models fused
    # draft-propose/verify rounds — each round the draft proposes
    # spec_k tokens, a leading run of Bernoulli(spec_accept_prob)
    # matches is accepted (plus the big-model correction on a
    # mismatch), and hits land in the REAL skytpu_spec_* counters so
    # the spec_decode scenario's acceptance-ratio SLO reads the same
    # series a production engine exports. Host dispatches cover
    # spec_fuse_rounds rounds each; decode_step_s stays the
    # per-DISPATCH latency knob (one skytpu_decode_step_seconds
    # sample per dispatch, like the fused engine).
    spec_k: int = 0                    # 0 = no speculative modeling
    spec_accept_prob: float = 0.0      # per-draft-token match prob
    spec_fuse_rounds: int = 8          # rounds per host dispatch
    # Sharded replica topology: each replica is one
    # `--mesh`-sharded engine, e.g. (('tensor', 4),) for a four-way
    # tensor split. `decode_step_s`/`ttft_median_s` stay the
    # per-DISPATCH knobs the operator measures ON that topology (the
    # fused round already includes the per-layer all-reduces), so
    # mesh_shape does not rescale latencies — it declares the
    # topology and enforces the engine's own composition rule: a
    # context-sharded replica runs the DENSE layout, so modeling a
    # prefix-cache hit ratio there would gate an SLO on counters the
    # real engine could never emit (validated in __post_init__).
    mesh_shape: tuple = ()             # (('tensor', 4),) etc.
    # Preemption-safe serving term: > 0 turns on mid-decode
    # migration modeling. When a chaos kill lands on a READY replica,
    # each busy decode slot attempts the drain -> snapshot -> restore
    # ladder onto a surviving READY replica; attempts/successes/
    # failures and the client-visible interruption gap land in the
    # REAL skytpu_migration_* series the production LB emits, so the
    # preemption_migration scenario's SLOs read the same counters a
    # live fleet scrapes. A failed ladder (no survivor, or an armed
    # `lb.migrate` fault) is an honest termination — it ALSO counts
    # skytpu_lb_midstream_failures_total, mirroring the LB.
    migration_latency_s: float = 0.0   # snapshot+restore median; 0=off
    migration_latency_sigma: float = 0.4
    # Planned prefill->decode handoff: > 0 on a PREFILL-
    # pool profile turns on two-leg modeling. A handoff-eligible
    # request (the real lb.handoff_eligible predicate: streamed +
    # tokenized + prefill-shaped) prefills here, then its decode
    # remainder hands off to a READY decode-pool replica — the
    # transfer gap sampled around this median lands in the REAL
    # skytpu_handoff_transfer_seconds histogram, and attempts/
    # successes/fallbacks land in the real skytpu_handoff_* counters
    # the production LB emits. No decode-pool survivor (or an armed
    # `lb.handoff` fault) is a COUNTED co-located fallback — the
    # request still completes; a handoff is never a failure.
    handoff_transfer_s: float = 0.0    # KV transfer median; 0 = off
    handoff_transfer_sigma: float = 0.4

    def __post_init__(self):
        ways = dict(self.mesh_shape)
        if (self.prefix_hit_ratio > 0
                or self.prefix_cache_capacity > 0) and \
                ways.get('context', 1) > 1:
            raise ValueError(
                'prefix_hit_ratio > 0 needs the paged KV layout, but '
                'a context-sharded replica (mesh_shape context > 1) '
                'runs dense — drop the context axis or the prefix '
                'term (mirrors the engine rule: pages never compose '
                'with context sharding).')

    def mesh_ways(self, axis: str) -> int:
        return dict(self.mesh_shape).get(axis, 1)

    def spec_mean_emit(self) -> float:
        """Expected tokens one speculative round emits (accepted
        leading run + the correction on a mismatch, capped at k)."""
        p, k = self.spec_accept_prob, self.spec_k
        e_m = sum(p ** j for j in range(1, k + 1))
        return min(float(k), e_m + 1.0 - p ** k)

    def service_mean_s(self) -> float:
        """Mean busy time one request costs a decode slot."""
        ttft = self.ttft_median_s
        if self.prefix_hit_ratio > 0:
            ttft *= (1.0 - self.prefix_hit_ratio
                     * (1.0 - self.warm_ttft_factor))
        if self.decode_step_s > 0:
            if self.spec_k > 0:
                rounds = math.ceil(self.tokens_median
                                   / max(self.spec_mean_emit(), 1.0))
                dispatches = -(-rounds // self.spec_fuse_rounds)
                return ttft + dispatches * self.decode_step_s
            host_steps = -(-self.tokens_median // self.fused_steps)
            return ttft + host_steps * self.decode_step_s
        return ttft + self.tokens_median * self.decode_per_token_s


class _State(enum.Enum):
    PROVISIONING = 'PROVISIONING'
    STARTING = 'STARTING'
    READY = 'READY'
    DEAD = 'DEAD'


class SimReplica:
    __slots__ = ('replica_id', 'zone', 'use_spot', 'endpoint', 'state',
                 'provision_done', 'ready_at', 'tick_requests',
                 'tick_busy_s', 'pool', 'prefix_cache')

    def __init__(self, replica_id: int, zone: Optional[str],
                 use_spot: bool, created_at: float,
                 startup_s: float, pool: Optional[str] = None) -> None:
        self.replica_id = replica_id
        self.zone = zone
        self.use_spot = use_spot
        self.pool = pool
        self.endpoint = f'http://replica-{replica_id}.sim:8080'
        self.state = _State.PROVISIONING
        # Cluster up (endpoint known) well before the app is ready —
        # mirrors PROVISIONING -> STARTING -> READY in production.
        self.provision_done = created_at + 0.25 * startup_s
        self.ready_at = created_at + startup_s
        self.tick_requests = 0
        self.tick_busy_s = 0.0
        # Content-aware radix-cache model: LRU over served prefix
        # keys (a fresh replica boots COLD — routing has to re-warm
        # it, exactly like production churn).
        self.prefix_cache: 'OrderedDict' = OrderedDict()


class SimFleet:
    """The controller-facing replica manager for a simulated fleet."""

    def __init__(self, service_name: str, clock, rng,
                 profile: ReplicaProfile,
                 zones: Optional[List[str]] = None,
                 default_use_spot: bool = False,
                 pool_profiles: Optional[
                     Dict[str, ReplicaProfile]] = None,
                 handoff_enabled: bool = True) -> None:
        self.service_name = service_name
        self.profile = profile
        # Disaggregated pools: per-pool latency/capacity shapes
        # (prefill-heavy vs decode-heavy hardware); replicas in an
        # unlisted pool fall back to the default profile.
        self.pool_profiles = dict(pool_profiles or {})
        # False = the co-located baseline pass: handoff-eligible
        # requests decode where they prefilled, even when the profile
        # models a transfer cost.
        self.handoff_enabled = handoff_enabled
        self.zones = list(zones or [])
        self.default_use_spot = default_use_spot
        self._clock = clock
        self._rng = rng
        self._replicas: Dict[int, SimReplica] = {}
        self._by_endpoint: Dict[str, SimReplica] = {}
        self._lost_zones: set = set()
        self._preemption_pending = False
        self._preempt_pending = 0
        self._preempt_pool: Optional[str] = None
        self._tick_seconds = 1.0

    def profile_for(self, pool: Optional[str]) -> ReplicaProfile:
        if pool is not None and pool in self.pool_profiles:
            return self.pool_profiles[pool]
        return self.profile

    # -- chaos hooks ---------------------------------------------------------

    def mark_zone_lost(self, zone: str) -> None:
        self._lost_zones.add(zone)

    def restore_zone(self, zone: str) -> None:
        self._lost_zones.discard(zone)

    def begin_preemption_wave(self) -> None:
        """Kill spot replicas through `fleet.preemption_wave` on the
        next probe sweep; the point's armed `times` bound is the wave
        size."""
        self._preemption_pending = True

    def begin_preempt(self, count: int,
                      pool: Optional[str] = None) -> None:
        """Kill the `count` BUSIEST ready replicas through
        `replica.preempt` on the next probe sweep — a preemption
        notice landing on replicas that hold in-flight decodes, the
        case the snapshot/migrate ladder exists for. The point's
        armed `times` bound caps how many actually die. `pool`
        restricts the busiest-first ranking to one pool (the
        disaggregation scenario aims notices at the decode pool —
        the replicas holding handed-off legs)."""
        self._preempt_pending = max(self._preempt_pending, int(count))
        self._preempt_pool = pool

    # -- the ReplicaManager surface ------------------------------------------

    def scale_up(self, n: int = 1,
                 use_spot: Optional[bool] = None,
                 pool: Optional[str] = None) -> List[int]:
        service = serve_state.get_service(self.service_name)
        version = service['version'] if service else 1
        spot = self.default_use_spot if use_spot is None else use_spot
        profile = self.profile_for(pool)
        now = self._clock.now()
        launched = []
        for _ in range(n):
            rid = serve_state.next_replica_id(self.service_name)
            zone = self._pick_zone()
            startup = self._rng.lognormvariate(
                _mu(profile.startup_median_s),
                profile.startup_sigma)
            r = SimReplica(rid, zone, spot, now, startup, pool=pool)
            self._replicas[rid] = r
            self._by_endpoint[r.endpoint] = r
            serve_state.add_replica(self.service_name, rid,
                                    f'sim-{self.service_name}-{rid}',
                                    version, use_spot=spot, zone=zone,
                                    pool=pool)
            launched.append(rid)
        return launched

    def _pick_zone(self) -> Optional[str]:
        usable = [z for z in self.zones if z not in self._lost_zones]
        if not usable:
            return None
        counts = {z: 0 for z in usable}
        for r in self._replicas.values():
            if r.state != _State.DEAD and r.zone in counts:
                counts[r.zone] += 1
        return min(usable, key=lambda z: (counts[z], z))

    def scale_down(self, replica_ids: List[int]) -> None:
        for rid in replica_ids:
            r = self._replicas.pop(rid, None)
            if r is not None:
                self._by_endpoint.pop(r.endpoint, None)
            serve_state.set_replica_status(
                self.service_name, rid,
                serve_state.ReplicaStatus.SHUTTING_DOWN)
            serve_state.remove_replica(self.service_name, rid)

    def terminate_all(self) -> None:
        self.scale_down(list(self._replicas))

    def probe_all(self) -> None:
        """One reconcile sweep on the virtual clock: chaos kills,
        then startup transitions, then replacement of dead replicas —
        the same replace-on-loss behavior the real manager has."""
        self._chaos_sweep()
        now = self._clock.now()
        dead = []
        for r in list(self._replicas.values()):
            if r.state == _State.DEAD:
                dead.append(r)
                continue
            if r.state == _State.PROVISIONING and \
                    now >= r.provision_done:
                r.state = _State.STARTING
                serve_state.set_replica_status(
                    self.service_name, r.replica_id,
                    serve_state.ReplicaStatus.STARTING,
                    endpoint=r.endpoint)
            if r.state == _State.STARTING and now >= r.ready_at:
                r.state = _State.READY
                serve_state.set_replica_status(
                    self.service_name, r.replica_id,
                    serve_state.ReplicaStatus.READY)
        for r in dead:
            serve_state.set_replica_status(
                self.service_name, r.replica_id,
                serve_state.ReplicaStatus.PREEMPTED)
            self.scale_down([r.replica_id])
            # Replacement stays in the dead replica's pool: a lost
            # prefill replica must not come back decode-shaped.
            self.scale_up(1, use_spot=r.use_spot, pool=r.pool)

    def ready_endpoints(self) -> List[str]:
        return [r.endpoint for r in self._replicas.values()
                if r.state == _State.READY]

    # -- chaos sweep ---------------------------------------------------------

    def _chaos_sweep(self) -> None:
        order = list(self._replicas.values())
        if self._preemption_pending:
            # Shuffled so an armed `times=N` wave hits a random N
            # spot replicas, not the N oldest.
            self._rng.shuffle(order)
        for r in order:
            if r.state == _State.DEAD:
                continue
            if r.zone is not None and r.zone in self._lost_zones:
                try:
                    faults.inject('fleet.zone_loss',
                                  sleep_fn=self._clock.sleep,
                                  env_exc=ReplicaKilled)
                except Exception:  # noqa: BLE001 — armed exc = a kill
                    r.state = _State.DEAD
                    self._migrate_inflight(r)
                    continue
            if self._preemption_pending and r.use_spot:
                try:
                    faults.inject('fleet.preemption_wave',
                                  sleep_fn=self._clock.sleep,
                                  env_exc=ReplicaKilled)
                except Exception:  # noqa: BLE001 — armed exc = a kill
                    r.state = _State.DEAD
                    self._migrate_inflight(r)
        self._preemption_pending = False
        if self._preempt_pending:
            # Preemption notices target the BUSIEST ready replicas —
            # the ones whose in-flight decodes the migration ladder
            # has to rescue.
            busy = sorted(
                (r for r in self._replicas.values()
                 if r.state == _State.READY
                 and (self._preempt_pool is None
                      or r.pool == self._preempt_pool)),
                key=lambda r: (-r.tick_requests, r.replica_id))
            for r in busy[:self._preempt_pending]:
                try:
                    faults.inject('replica.preempt',
                                  sleep_fn=self._clock.sleep,
                                  env_exc=ReplicaKilled)
                except Exception:  # noqa: BLE001 — armed exc = a kill
                    r.state = _State.DEAD
                    self._migrate_inflight(r)
            self._preempt_pending = 0
            self._preempt_pool = None

    def _migrate_inflight(self, r: 'SimReplica') -> None:
        """The drain -> snapshot -> migrate ladder for the requests a
        killed replica held mid-decode. One attempt per busy decode
        slot (last tick's dispatch count, capped at the profile's
        concurrency); each succeeds iff a READY survivor exists and
        the `lb.migrate` point doesn't fire, observing the modeled
        interruption gap into the real migration histograms. The
        failure rung mirrors the LB's honest termination: the client
        stream dies and skytpu_lb_midstream_failures_total counts it."""
        p = self.profile_for(r.pool)
        if p.migration_latency_s <= 0:
            return
        inflight = min(p.concurrency, r.tick_requests)
        targets = [
            x for x in self._replicas.values()
            if x is not r and x.state == _State.READY
            and (x.zone is None or x.zone not in self._lost_zones)]
        for _ in range(inflight):
            obs.MIGRATION_ATTEMPTS.inc()
            ok = bool(targets)
            if ok:
                try:
                    faults.inject('lb.migrate',
                                  sleep_fn=self._clock.sleep,
                                  env_exc=OSError)
                except Exception:  # noqa: BLE001 — armed = a failure
                    ok = False
            if not ok:
                obs.MIGRATION_FAILURES.inc()
                obs.LB_MIDSTREAM_FAILURES.inc()
                continue
            gap = self._rng.lognormvariate(
                _mu(p.migration_latency_s), p.migration_latency_sigma)
            obs.MIGRATION_SECONDS.observe(gap)
            obs.MIGRATION_INTERRUPTION_SECONDS.observe(gap)
            obs.MIGRATION_SUCCESSES.inc()
            # The survivor absorbs the decode remainder (half a mean
            # service time of extra busy-slot load, on average).
            tgt = self._rng.choice(targets)
            tgt.tick_busy_s += 0.5 * p.service_mean_s()

    # -- the traffic-facing surface ------------------------------------------

    def begin_tick(self, tick_seconds: float) -> None:
        self._tick_seconds = max(tick_seconds, 1e-9)
        for r in self._replicas.values():
            r.tick_requests = 0
            r.tick_busy_s = 0.0

    def handle_request(self, endpoint: str,
                       context: Optional[Dict[str, Any]] = None):
        """One request hitting `endpoint`. Returns (ttft_s, total_s)
        on success, None when the replica is gone or not serving (the
        LB's dispatch() treats that as a transport failure and fails
        over). `context` is the same routing context the LB peeked —
        content-aware replicas key their prefix-cache model off its
        `prefix_key`."""
        r = self._by_endpoint.get(endpoint)
        if r is None or r.state != _State.READY:
            return None
        p = self.profile_for(r.pool)
        # Per-tick utilization of this replica's decode slots; TTFT
        # inflates hyperbolically toward saturation (open-loop
        # arrivals queue behind busy slots).
        rho = r.tick_busy_s / (self._tick_seconds * p.concurrency)
        ttft = self._rng.lognormvariate(_mu(p.ttft_median_s),
                                        p.ttft_sigma)
        if p.prefix_cache_capacity > 0 and context is not None:
            # Content-aware model: warm iff THIS replica served THIS
            # prefix recently — the hit ratio is now a routing
            # outcome, not a profile constant. A request with no
            # prefix key (unique long prompt) is an honest miss.
            key = context.get('prefix_key')
            if key is not None and key in r.prefix_cache:
                r.prefix_cache.move_to_end(key)
                ttft *= p.warm_ttft_factor
                obs.PREFIX_CACHE_HITS.inc()
                reused = context.get('prefix_tokens',
                                     p.shared_prefix_tokens)
                if reused:
                    obs.PREFIX_CACHE_REUSED_TOKENS.inc(reused)
            else:
                obs.PREFIX_CACHE_MISSES.inc()
                if key is not None:
                    r.prefix_cache[key] = True
                    while len(r.prefix_cache) > \
                            p.prefix_cache_capacity:
                        r.prefix_cache.popitem(last=False)
        elif p.prefix_hit_ratio > 0:
            if self._rng.random() < p.prefix_hit_ratio:
                # Warm prefix: the matched span's prefill is skipped.
                ttft *= p.warm_ttft_factor
                obs.PREFIX_CACHE_HITS.inc()
                if p.shared_prefix_tokens:
                    obs.PREFIX_CACHE_REUSED_TOKENS.inc(
                        p.shared_prefix_tokens)
            else:
                obs.PREFIX_CACHE_MISSES.inc()
        ttft /= max(0.05, 1.0 - min(rho, 0.95))
        tokens = max(1, int(self._rng.lognormvariate(
            _mu(float(p.tokens_median)), 0.5)))
        if p.decode_step_s > 0 and p.spec_k > 0:
            # Fused-SPECULATIVE parameterization: rounds propose
            # spec_k drafts, accept a leading Bernoulli run (+ the
            # correction), and land in the REAL skytpu_spec_*
            # counters; one host dispatch covers spec_fuse_rounds
            # rounds and observes one decode-step sample — the two
            # signals the spec_decode scenario's SLOs gate.
            decode = 0.0
            remaining = tokens
            while remaining > 0:
                for _ in range(max(1, p.spec_fuse_rounds)):
                    if remaining <= 0:
                        break
                    m = 0
                    while (m < p.spec_k
                           and self._rng.random() < p.spec_accept_prob):
                        m += 1
                    emit = p.spec_k if m >= p.spec_k else m + 1
                    emit = min(emit, remaining)
                    obs.SPEC_ROUNDS.inc()
                    obs.SPEC_PROPOSED_TOKENS.inc(p.spec_k)
                    obs.SPEC_ACCEPTED_TOKENS.inc(min(m, emit))
                    obs.SPEC_ACCEPTED_PER_ROUND.observe(min(m, emit))
                    remaining -= emit
                step = self._rng.lognormvariate(_mu(p.decode_step_s),
                                                p.decode_step_sigma)
                obs.DECODE_STEP_SECONDS.observe(step)
                decode += step
            total = ttft + decode
        elif p.decode_step_s > 0:
            # Fused-loop parameterization: the request decodes as
            # ceil(tokens / fused_steps) host rounds, each observed
            # into the engine's decode-step histogram — the signal
            # the fused_decode scenario's SLO asserts on.
            decode = 0.0
            for _ in range(-(-tokens // p.fused_steps)):
                step = self._rng.lognormvariate(_mu(p.decode_step_s),
                                                p.decode_step_sigma)
                obs.DECODE_STEP_SECONDS.observe(step)
                decode += step
            total = ttft + decode
        else:
            total = ttft + tokens * p.decode_per_token_s
        if r.pool == 'decode':
            # The population disaggregation protects: short requests
            # served by the decode pool, free of long-prefill
            # convoying. Gated against the co-located baseline.
            obs.FLEETSIM_DECODE_TTFT_SECONDS.observe(ttft)
        handed = self._maybe_handoff(r, p, context, ttft, total)
        if handed is not None:
            return handed
        r.tick_requests += 1
        r.tick_busy_s += total
        return ttft, total

    def _maybe_handoff(self, r: 'SimReplica', p: ReplicaProfile,
                       context: Optional[Dict[str, Any]],
                       ttft: float, total: float):
        """The planned two-leg route for one request that prefilled on
        `r`: eligibility is the REAL LB predicate (streamed +
        tokenized + prefill-shaped), the decode remainder moves to a
        READY decode-pool survivor, and the transfer gap / outcome
        counters land in the same skytpu_handoff_* series the
        production LB emits. Returns (ttft, total) when the leg moved
        (the caller must not re-account the request), or None for the
        single-leg path — including the COUNTED co-located fallback,
        which is a degraded success, never a failed request."""
        from skypilot_tpu_torch.serve import load_balancer as lb_lib
        if (not self.handoff_enabled or p.handoff_transfer_s <= 0
                or r.pool != 'prefill'
                or not lb_lib.handoff_eligible(context)):
            return None
        obs.HANDOFF_ATTEMPTS.inc()
        targets = [
            x for x in self._replicas.values()
            if x is not r and x.state == _State.READY
            and x.pool == 'decode'
            and (x.zone is None or x.zone not in self._lost_zones)]
        ok = bool(targets)
        if ok:
            try:
                faults.inject('lb.handoff',
                              sleep_fn=self._clock.sleep,
                              env_exc=OSError)
            except Exception:  # noqa: BLE001 — armed = forced fallback
                ok = False
        if not ok:
            obs.HANDOFF_FALLBACKS.inc()
            return None
        decode_s = max(0.0, total - ttft)
        gap = self._rng.lognormvariate(
            _mu(p.handoff_transfer_s), p.handoff_transfer_sigma)
        obs.HANDOFF_TRANSFER_SECONDS.observe(gap)
        obs.HANDOFF_SUCCESSES.inc()
        tgt = self._rng.choice(targets)
        # The decode remainder is billed at the source profile's
        # decode parameterization (token count is the request's, not
        # the hardware's) onto the TARGET's slots.
        tgt.tick_busy_s += decode_s
        r.tick_requests += 1
        # The source slot stays live under the lease until the
        # restore confirms — prefill work plus the transfer window.
        r.tick_busy_s += ttft + gap
        return ttft, ttft + gap + decode_s

    def end_tick(self) -> None:
        """Publish fleet-wide pressure to the same gauges the engine
        exports in production (skytpu_queue_depth,
        skytpu_kv_cache_utilization) so MetricsSignalSource — and
        therefore the autoscaler under test — reads real registry
        series. Pooled replicas ALSO publish per-pool series
        (skytpu_pool_queue_depth{pool=...}) — the signals each
        pool's autoscaler consumes."""
        queued = 0.0
        utils = []
        by_pool: Dict[str, List] = {}
        for r in self._replicas.values():
            if r.state != _State.READY:
                continue
            p = self.profile_for(r.pool)
            cap = self._tick_seconds * p.concurrency
            rho = r.tick_busy_s / cap if cap else 0.0
            utils.append(min(1.0, rho))
            excess_s = max(0.0, r.tick_busy_s - cap)
            q = excess_s / max(p.service_mean_s(), 1e-9)
            queued += q
            if r.pool is not None:
                by_pool.setdefault(r.pool, []).append(
                    (min(1.0, rho), q))
        obs.QUEUE_DEPTH.set(queued)
        obs.KV_CACHE_UTILIZATION.set(
            sum(utils) / len(utils) if utils else 0.0)
        for pool, samples in by_pool.items():
            obs.POOL_QUEUE_DEPTH.labels(pool=pool).set(
                sum(q for _rho, q in samples))
            obs.POOL_KV_UTILIZATION.labels(pool=pool).set(
                sum(rho for rho, _q in samples) / len(samples))

    # -- introspection --------------------------------------------------------

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self._replicas.values():
            out[r.state.value] = out.get(r.state.value, 0) + 1
        return out


def _mu(median: float) -> float:
    """ln(median) — the lognormal mu that yields this median."""
    return math.log(max(median, 1e-9))
