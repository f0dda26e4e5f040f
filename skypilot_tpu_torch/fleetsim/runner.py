"""Scenario runner: the real control plane, a simulated fleet.

The port of `skypilot_tpu/fleetsim/runner.py`: `Scenario`,
`_PrefixWorkload`, `FleetSim` (`run`, `_run_pass` :270-330 and on,
`_apply_event`, `_improvement_assert`) and the scenario catalog, every
scenario of the reference's with its numbers (`smoke`, `fused_decode`,
`spec_decode`, `shared_prefix`, `sharded_serve`, `prefix_affinity`,
`watchdog`, `zone_loss`, `rolling_update`, `trace_breach`,
`preemption_wave`, `preemption_migration`, `disaggregation`). The
scenarios' latency anchors are the reference's, taken on its TPU
engines: they shape simulated replicas and measure nothing of the port.

One `FleetSim.run()` wires the port's `ServeController` (real
reconcile loop, real rolling updates, real autoscalers) and the
port's `LoadBalancer` routing/breaker discipline to a `SimFleet`
of mock replicas on a `VirtualClock`, replays open-loop traffic
through `LoadBalancer.dispatch`, fires the scenario's chaos schedule,
and evaluates SLOs from the live metrics registry into
`SLO_<scenario>.json`.

Determinism: one seed reproduces one run bit-for-bit (seeded RNGs,
virtual clock, deterministic fault registry). Wall time is bounded by
SKYTPU_FLEETSIM_MAX_WALL_SECONDS — a wedged sim writes a failing
report instead of hanging CI.
"""
import dataclasses
import random
import time
from typing import Any, Dict, Optional, Tuple

from skypilot_tpu_torch import envs
from skypilot_tpu_torch.fleetsim import chaos as chaos_lib
from skypilot_tpu_torch.fleetsim import clock as clock_lib
from skypilot_tpu_torch.fleetsim import replicas as replicas_lib
from skypilot_tpu_torch.fleetsim import slo as slo_lib
from skypilot_tpu_torch.fleetsim import traffic as traffic_lib
from skypilot_tpu_torch.observability import instruments as obs
from skypilot_tpu_torch.observability import timeseries as timeseries_lib
from skypilot_tpu_torch.observability import watchdog as watchdog_lib
from skypilot_tpu_torch.resilience import faults
from skypilot_tpu_torch.serve import autoscalers as autoscalers_lib
from skypilot_tpu_torch.serve import controller as controller_lib
from skypilot_tpu_torch.serve import load_balancer as lb_lib
from skypilot_tpu_torch.serve import serve_state


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One declarative soak: fleet shape, traffic, chaos, SLOs.

    `replicas` and any `max_replicas` in `policy` scale with
    SKYTPU_FLEETSIM_SCALE; per-replica knobs do not. `chaos` uses the
    event dicts documented in chaos.py; `slos` are slo.py assertion
    objects."""
    name: str
    description: str
    replicas: int
    duration_s: float
    tick_s: float
    warmup_s: float
    traffic: Any                       # traffic_lib.parse() input
    profile: replicas_lib.ReplicaProfile
    zones: Tuple[str, ...] = ('zone-a', 'zone-b', 'zone-c')
    policy: Dict[str, Any] = dataclasses.field(default_factory=dict)
    lb_policy: str = 'round_robin'
    chaos: Tuple[Dict[str, Any], ...] = ()
    slos: Tuple[Any, ...] = ()
    # Fraction of the pre-event READY count at which a chaos event
    # (zone loss, preemption wave) counts as recovered.
    recovery_threshold: float = 0.95
    # Disaggregated replica pools: name -> PoolSpec config dict (the
    # service-spec 'pools' section; min/max_replicas scale with
    # SKYTPU_FLEETSIM_SCALE). With pools set, `replicas`/`policy` are
    # ignored — the pools ARE the scaling envelope — and
    # `pool_profiles` shapes each pool's replicas.
    pools: Optional[Dict[str, Dict[str, Any]]] = None
    pool_profiles: Optional[
        Dict[str, replicas_lib.ReplicaProfile]] = None
    # Shared-prefix request mix driven through the LB's content
    # seam: every arrival carries a routing context (prompt tokens,
    # max_new_tokens, prefix key) the real policy routes on. See
    # _PrefixWorkload for the knobs.
    workload: Optional[Dict[str, Any]] = None
    # A/B comparison: run the scenario a second time under this LB
    # policy (fresh fleet, same seed/traffic), evaluate
    # `baseline_slos` over that pass, and gate the primary pass's
    # cache-hit ratio at >= min_hit_ratio_improvement x the
    # baseline's — one report carries both sides.
    compare_lb_policy: Optional[str] = None
    baseline_slos: Tuple[Any, ...] = ()
    min_hit_ratio_improvement: float = 2.0
    # Disaggregation A/B: run a second pass with planned prefill->
    # decode handoff DISABLED (same LB policy, same seed/traffic,
    # fresh fleet) and evaluate `baseline_slos` over it — the
    # co-located baseline the disaggregation scenario's decode-pool
    # TTFT is read against, in the same report. Mutually exclusive
    # with compare_lb_policy.
    compare_handoff_off: bool = False
    # LIVE watchdog rules (observability/watchdog.py objects) run
    # against the virtual clock every sim tick once warmup ends: a
    # private time-series store samples the rules' metrics per tick
    # and the engine's fire/clear transitions land in the REAL
    # skytpu_watchdog_alerts_total — which `slos` can then gate with
    # CounterDeltaWithin (e.g. "fired during the outage, cleared
    # after, silent before"). Keep these rules stateless (GaugeWithin
    # etc.): the catalog entry is reused across passes.
    watchdog: Tuple[Any, ...] = ()


class _PrefixWorkload:
    """Shared-prefix traffic: `families` prompt families, each a
    page-aligned common prefix plus a per-request random tail (the
    shared-system-prompt shape of production traffic), mixed with a
    `long_prompt` fraction of unique long-prompt/short-gen requests
    (the prefill-pool shape). Deterministic per seed."""

    def __init__(self, cfg: Dict[str, Any], seed: int) -> None:
        rng = random.Random(seed)
        self.families = int(cfg.get('families', 48))
        self.prefix_tokens = int(cfg.get('prefix_tokens', 512))
        self.tail_tokens = int(cfg.get('tail_tokens', 16))
        self.max_new_tokens = int(cfg.get('max_new_tokens', 48))
        long_cfg = cfg.get('long_prompt') or {}
        self.long_fraction = float(long_cfg.get('fraction', 0.0))
        self.long_tokens = int(long_cfg.get('prompt_tokens', 2048))
        self.long_max_new = int(long_cfg.get('max_new_tokens', 16))
        # stream: True marks the long class as SSE clients — the
        # shape lb.handoff_eligible() admits to the two-leg route.
        self.long_stream = bool(long_cfg.get('stream', False))
        self._prefixes = [
            [rng.randint(1, 30000)
             for _ in range(self.prefix_tokens)]
            for _ in range(self.families)]
        self._rng = random.Random(seed + 7)

    def next_context(self) -> Dict[str, Any]:
        rng = self._rng
        if self.long_fraction and rng.random() < self.long_fraction:
            ctx = {
                'prompt_tokens': [rng.randint(1, 30000)
                                  for _ in range(self.long_tokens)],
                'max_new_tokens': self.long_max_new,
            }
            if self.long_stream:
                ctx['stream'] = True
            return ctx
        f = rng.randrange(self.families)
        return {
            'prompt_tokens': self._prefixes[f]
            + [rng.randint(1, 30000)
               for _ in range(self.tail_tokens)],
            'max_new_tokens': self.max_new_tokens,
            'prefix_key': ('family', f),
            'prefix_tokens': self.prefix_tokens,
        }


class FleetSim:

    def __init__(self, scenario: Scenario,
                 seed: Optional[int] = None,
                 out_dir: Optional[str] = None) -> None:
        self.scenario = scenario
        self.seed = envs.SKYTPU_FLEETSIM_SEED.get() if seed is None \
            else seed
        self.out_dir = out_dir or \
            envs.SKYTPU_FLEETSIM_OUT_DIR.get() or '.'
        self.scale = max(1e-3, envs.SKYTPU_FLEETSIM_SCALE.get())
        self.tick_s = envs.SKYTPU_FLEETSIM_TICK_SECONDS.get() or \
            scenario.tick_s
        self.service_name = f'fleetsim-{scenario.name}'

    # -- setup ---------------------------------------------------------------

    def _scaled_pools(self) -> Dict[str, Dict[str, Any]]:
        pools: Dict[str, Dict[str, Any]] = {}
        for name, cfg in (self.scenario.pools or {}).items():
            pool = dict(cfg)
            pool['min_replicas'] = max(1, int(round(
                cfg.get('min_replicas', 1) * self.scale)))
            if cfg.get('max_replicas'):
                pool['max_replicas'] = max(
                    pool['min_replicas'],
                    int(round(cfg['max_replicas'] * self.scale)))
            pools[name] = pool
        return pools

    def _service_config(self, n_replicas: int,
                        lb_policy: str) -> Dict[str, Any]:
        probe = {'path': '/health', 'initial_delay_seconds': 1200,
                 'timeout_seconds': 5}
        if self.scenario.pools:
            return {
                'readiness_probe': probe,
                'pools': self._scaled_pools(),
                'load_balancing_policy': lb_policy,
            }
        policy: Dict[str, Any] = {'min_replicas': n_replicas}
        for key, value in self.scenario.policy.items():
            if key == 'max_replicas':
                value = max(n_replicas, int(round(value * self.scale)))
            policy[key] = value
        return {
            'readiness_probe': probe,
            'replica_policy': policy,
            'load_balancing_policy': lb_policy,
        }

    # -- the run -------------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        """One scenario run: the primary pass under `lb_policy`, and
        — when `compare_lb_policy` is set — a second pass under the
        comparison policy (fresh fleet, identical seeds/traffic) so
        one report carries the A/B (plus the hit-ratio-improvement
        gate) instead of two reports an operator has to line up."""
        sc = self.scenario
        wall_start = time.monotonic()
        primary = self._run_pass(sc.lb_policy, sc.slos, wall_start)
        baseline = None
        if primary['crash'] is None and not primary['aborted']:
            if sc.compare_lb_policy:
                baseline = self._run_pass(sc.compare_lb_policy,
                                          sc.baseline_slos,
                                          wall_start)
            elif sc.compare_handoff_off:
                # The co-located baseline: identical fleet/policy/
                # seed, planned handoff off — decode legs stay where
                # they prefilled.
                baseline = self._run_pass(sc.lb_policy,
                                          sc.baseline_slos,
                                          wall_start,
                                          handoff_enabled=False)
        results = list(primary['results'])
        extra = dict(primary['extra'])
        aborted = primary['aborted']
        crash = primary['crash']
        if baseline is not None:
            results += baseline['results']
            extra['baseline'] = baseline['extra']
            aborted = aborted or baseline['aborted']
            crash = crash or baseline['crash']
            if crash is None and not aborted and sc.compare_lb_policy:
                results.append(self._improvement_assert(results))
        path, rc = slo_lib.write_report(
            self.out_dir, sc.name, results, extra=extra,
            rc_override=1 if (aborted or crash is not None) else None)
        if crash is not None:
            # The failing SLO_*.json is on disk and state is clean;
            # now fail loudly with the original traceback.
            raise crash
        return {'rc': rc, 'report_path': path, 'asserts': results,
                'extra': extra}

    def _improvement_assert(self, results) -> Dict[str, Any]:
        """The A/B gate: primary cache-hit ratio must beat the
        baseline's by min_hit_ratio_improvement x. Synthesized from
        the two passes' evaluated ratios (both resolved from live
        counter deltas), reported in the same assert schema."""
        by_name = {r['name']: r for r in results}
        sc = self.scenario
        a = by_name.get('cache_hit_ratio', {}).get('value')
        b = by_name.get('baseline_cache_hit_ratio', {}).get('value')
        if a is None or b is None:
            return {'name': 'hit_ratio_improvement',
                    'metric': 'skytpu_prefix_cache_hits_total',
                    'ok': False, 'value': None,
                    'threshold': sc.min_hit_ratio_improvement,
                    'detail': 'hit-ratio asserts missing from one '
                              'pass'}
        improvement = a / max(b, 1e-9)
        return {'name': 'hit_ratio_improvement',
                'metric': 'skytpu_prefix_cache_hits_total',
                'ok': improvement >= sc.min_hit_ratio_improvement,
                'value': round(improvement, 3),
                'threshold': sc.min_hit_ratio_improvement,
                'detail': f'{sc.lb_policy} {a:.3f} vs '
                          f'{sc.compare_lb_policy} {b:.3f}'}

    def _run_pass(self, lb_policy: str, slos, wall_start: float,
                  handoff_enabled: bool = True) -> Dict[str, Any]:
        sc = self.scenario
        wall_budget = envs.SKYTPU_FLEETSIM_MAX_WALL_SECONDS.get()
        pools = self._scaled_pools() if sc.pools else None
        if pools:
            n_replicas = sum(p['min_replicas']
                             for p in pools.values())
        else:
            n_replicas = max(1, int(round(sc.replicas * self.scale)))

        service_cfg = self._service_config(n_replicas, lb_policy)
        serve_state.remove_service(self.service_name)  # stale runs
        serve_state.add_service(
            self.service_name,
            {'run': 'true', 'service': service_cfg},
            lb_port=0, controller_port=0)

        vclock = clock_lib.VirtualClock()
        fleet_rng = random.Random(self.seed)
        traffic_rng = random.Random(self.seed + 1)
        fleet = replicas_lib.SimFleet(
            self.service_name, vclock, fleet_rng, sc.profile,
            zones=list(sc.zones),
            default_use_spot=bool(not pools and service_cfg[
                'replica_policy'].get('use_spot')),
            pool_profiles=sc.pool_profiles,
            handoff_enabled=handoff_enabled)
        lb = lb_lib.LoadBalancer(lb_policy, now_fn=vclock.now,
                                 honor_env_policy=False)
        ctl = controller_lib.ServeController(
            self.service_name, manager=fleet, lb=lb,
            now_fn=vclock.now, sleep_fn=vclock.sleep,
            signal_source=autoscalers_lib.MetricsSignalSource(
                ttft_metric='skytpu_fleetsim_ttft_seconds'))
        serve_state.set_service_status(
            self.service_name, serve_state.ServiceStatus.REPLICA_INIT)
        if pools:
            for pool_name, pool_cfg in pools.items():
                fleet.scale_up(pool_cfg['min_replicas'],
                               pool=pool_name)
        else:
            fleet.scale_up(n_replicas)
        workload = _PrefixWorkload(sc.workload, self.seed + 2) \
            if sc.workload else None

        curve = traffic_lib.parse(sc.traffic)
        if self.scale != 1.0:
            curve = traffic_lib.scaled(curve, self.scale)
        evaluator = slo_lib.SLOEvaluator(slos)
        # Recovery series persist across scenarios in one process: a
        # previous run's "recovered in 12s" must not satisfy THIS
        # run's GaugeWithin if its chaos event never fires. -1 is the
        # documented "no recovery happened" value, which fails lo=0.
        for _series, labels, _value in \
                obs.FLEETSIM_RECOVERY_SECONDS.samples():
            obs.FLEETSIM_RECOVERY_SECONDS.labels(
                **dict(labels)).set(-1.0)
        evaluator.mark('start')
        schedule = chaos_lib.ChaosSchedule.from_config(sc.chaos)

        # Live watchdog on the virtual clock: private store (one
        # scenario's windows must not see another's samples), now_fn
        # from the sim, ticked once per sim tick after warmup — the
        # startup ramp (0 READY replicas) is not an outage.
        wd = None
        wd_store = None
        wd_names = None
        if sc.watchdog:
            wd_store = timeseries_lib.TimeSeriesStore()
            wd = watchdog_lib.Watchdog(rules=list(sc.watchdog),
                                       store=wd_store,
                                       now_fn=vclock.now)
            wd_names = tuple({r.metric for r in sc.watchdog
                              if getattr(r, 'metric', None)}) or None

        recovery_pending: Dict[str, Dict[str, float]] = {}
        outcomes: Dict[str, int] = {}
        controller_crashes = 0
        requests = 0
        warmup_marked = False
        aborted: Optional[str] = None
        ticks = 0

        def send(url: str, context=None) -> bool:
            result = fleet.handle_request(url, context=context)
            if result is None:
                return False
            ttft, total = result
            obs.FLEETSIM_TTFT_SECONDS.observe(ttft)
            obs.FLEETSIM_REQUEST_SECONDS.observe(total)
            return True

        crash: Optional[BaseException] = None
        t = 0.0
        try:
            while t < sc.duration_s - 1e-9:
                if time.monotonic() - wall_start > wall_budget:
                    aborted = (f'wall budget {wall_budget:.0f}s '
                               f'exceeded at simulated t={t:.0f}s')
                    break
                injected_before = obs.FAULTS_INJECTED.value(
                    point='controller.step')
                try:
                    ctl._step()  # noqa: SLF001 — the sim drives the loop
                except (faults.FaultInjected, RuntimeError):
                    # Count as a chaos-induced crash ONLY when the
                    # controller.step point actually fired this tick
                    # (RuntimeError is its declared env_exc, so
                    # SKYTPU_FAULTS-armed drills land here too); a
                    # RuntimeError from a real controller bug must
                    # stay loud — this harness exists to CATCH
                    # controller regressions, not absorb them.
                    if obs.FAULTS_INJECTED.value(
                            point='controller.step') == injected_before:
                        raise
                    controller_crashes += 1
                # One timeline: latency faults advance the virtual
                # clock inside _step (a stalled controller), and the
                # chaos/traffic/recovery bookkeeping must not lag it.
                t = vclock.now()
                ticks += 1
                ready = obs.SERVE_REPLICAS.value(
                    service=self.service_name, state='READY')
                # Recovery checks BEFORE new events: a fresh event's
                # target must never be satisfied by the pre-kill
                # gauge.
                for event_name, info in list(recovery_pending.items()):
                    if ready >= info['target']:
                        obs.FLEETSIM_RECOVERY_SECONDS.labels(
                            event=event_name).set(t - info['t'])
                        del recovery_pending[event_name]
                for ev in schedule.pop_due(t):
                    self._apply_event(ev, fleet, evaluator,
                                      recovery_pending, ready, t)
                fleet.begin_tick(self.tick_s)
                for _ in range(curve.arrivals(traffic_rng, t,
                                              t + self.tick_s)):
                    ctx = workload.next_context() \
                        if workload is not None else None
                    outcome = lb.dispatch(
                        lambda url, _ctx=ctx: send(url, _ctx),
                        context=ctx)
                    outcomes[outcome] = outcomes.get(outcome, 0) + 1
                    obs.FLEETSIM_REQUESTS.labels(
                        outcome=outcome).inc()
                    requests += 1
                fleet.end_tick()
                t = vclock.advance(self.tick_s)
                if not warmup_marked and t >= sc.warmup_s:
                    evaluator.mark('warmup_end')
                    warmup_marked = True
                if wd is not None and t >= sc.warmup_s:
                    wd_store.sample_now(now=t, names=wd_names)
                    wd.tick()
        except Exception as e:  # noqa: BLE001 — reported + re-raised
            crash = e

        evaluator.mark('end')
        replicas_driven = serve_state.next_replica_id(
            self.service_name) - 1
        # Cleanup BEFORE evaluation/reporting — even a crash (or a
        # bug in the evaluator) must not leak armed faults, service
        # rows, or pressure gauges into the next scenario (or the
        # comparison pass) of this session.
        faults.reset()
        fleet.terminate_all()
        serve_state.remove_service(self.service_name)
        obs.QUEUE_DEPTH.set(0)
        obs.KV_CACHE_UTILIZATION.set(0)
        for gauge in (obs.POOL_QUEUE_DEPTH, obs.POOL_KV_UTILIZATION):
            for _series, labels, _value in gauge.samples():
                gauge.labels(**dict(labels)).set(0)

        results = evaluator.evaluate()
        extra = {
            'description': sc.description,
            'lb_policy': lb_policy,
            'seed': self.seed,
            'scale': self.scale,
            'replicas_configured': n_replicas,
            'replicas_driven': replicas_driven,
            'pools': sorted(pools) if pools else None,
            'handoff_enabled': handoff_enabled,
            'simulated_seconds': round(t, 3),
            'ticks': ticks,
            'tick_seconds': self.tick_s,
            'wall_seconds': round(time.monotonic() - wall_start, 3),
            'requests': requests,
            'outcomes': outcomes,
            'controller_crashes': controller_crashes,
            'unrecovered_events': sorted(recovery_pending),
            'aborted': aborted,
            'error': (f'{type(crash).__name__}: {crash}'
                      if crash is not None else None),
            'watchdog': wd.snapshot() if wd is not None else None,
        }
        return {'results': results, 'extra': extra, 'crash': crash,
                'aborted': aborted}

    # -- chaos actions -------------------------------------------------------

    def _apply_event(self, ev: chaos_lib.ChaosEvent, fleet, evaluator,
                     recovery_pending: Dict[str, Dict[str, float]],
                     ready: float, t: float) -> None:
        kw = ev.kwargs
        sc = self.scenario
        if ev.action == 'zone_loss':
            faults.arm('fleet.zone_loss', times=None)
            fleet.mark_zone_lost(kw['zone'])
            obs.FLEETSIM_RECOVERY_SECONDS.labels(
                event='zone_loss').set(-1.0)
            recovery_pending['zone_loss'] = {
                't': t, 'target': ready * sc.recovery_threshold}
        elif ev.action == 'zone_restore':
            fleet.restore_zone(kw['zone'])
            if not fleet._lost_zones:  # noqa: SLF001 — sim-internal
                faults.disarm('fleet.zone_loss')
        elif ev.action == 'preemption_wave':
            count = max(1, int(round(kw['count'] * self.scale)))
            faults.arm('fleet.preemption_wave', times=count)
            fleet.begin_preemption_wave()
            obs.FLEETSIM_RECOVERY_SECONDS.labels(
                event='preemption_wave').set(-1.0)
            recovery_pending['preemption_wave'] = {
                't': t, 'target': ready * sc.recovery_threshold}
        elif ev.action == 'preempt_replicas':
            count = max(1, int(round(kw['count'] * self.scale)))
            faults.arm('replica.preempt', times=count)
            fleet.begin_preempt(count, pool=kw.get('pool'))
        elif ev.action == 'rolling_update':
            service = serve_state.get_service(self.service_name)
            serve_state.set_service_version(
                self.service_name, service['version'] + 1,
                service['task_yaml'])
            evaluator.mark('update_start')
        elif ev.action == 'arm_fault':
            times = kw.get('times', 1)
            arm_kwargs = {
                'times': None if times == 'forever' else times,
                'latency': kw.get('latency', 0.0),
            }
            if kw.get('latency_only'):
                # exc=None arms a pure slowdown — e.g. a STALLED
                # controller tick, as opposed to a crashed one.
                arm_kwargs['exc'] = None
            faults.arm(kw['point'], **arm_kwargs)
        elif ev.action == 'disarm_fault':
            faults.disarm(kw['point'])
        elif ev.action == 'mark':
            evaluator.mark(kw['name'])


# -- the scenario catalog -----------------------------------------------------

_SMOKE_PROFILE = replicas_lib.ReplicaProfile(
    startup_median_s=6.0, startup_sigma=0.3,
    ttft_median_s=0.3, ttft_sigma=0.4,
    decode_per_token_s=0.02, tokens_median=32, concurrency=8)

_FLEET_PROFILE = replicas_lib.ReplicaProfile(
    startup_median_s=60.0, startup_sigma=0.35,
    ttft_median_s=0.35, ttft_sigma=0.45,
    decode_per_token_s=0.03, tokens_median=64, concurrency=8)


SCENARIOS: Dict[str, Scenario] = {}


def register(scenario: Scenario) -> Scenario:
    if scenario.name in SCENARIOS:
        raise ValueError(f'duplicate scenario {scenario.name!r}')
    SCENARIOS[scenario.name] = scenario
    return scenario


register(Scenario(
    name='smoke',
    description=('Tier-1 gate: ~50 replicas, 90 simulated seconds, '
                 'one zone loss + one rolling update; asserts TTFT '
                 'p95, update error rate, and time-to-ready.'),
    replicas=48,
    duration_s=90.0, tick_s=2.0, warmup_s=24.0,
    traffic={'kind': 'constant', 'qps': 120.0},
    profile=_SMOKE_PROFILE,
    policy={'max_replicas': 60, 'target_qps_per_replica': 3.0,
            'target_queue_per_replica': 4.0,
            'upscale_delay_seconds': 10,
            'downscale_delay_seconds': 120},
    # round_robin: requests inside one tick dispatch with zero
    # simulated overlap, so least_load would see in_flight == 0
    # everywhere and degenerate to hammering the first replica.
    lb_policy='round_robin',
    chaos=(
        {'at': 40.0, 'action': 'zone_loss', 'zone': 'zone-a'},
        {'at': 46.0, 'action': 'zone_restore', 'zone': 'zone-a'},
        {'at': 60.0, 'action': 'rolling_update'},
    ),
    slos=(
        slo_lib.HistQuantileBelow('ttft_p95', threshold=2.0),
        slo_lib.RatioBelow('error_rate', threshold=0.005),
        slo_lib.RatioBelow('update_error_rate', threshold=0.005,
                           window=('update_start', 'end')),
        slo_lib.GaugeWithin('zone_loss_recovery', threshold=40.0,
                            labels=(('event', 'zone_loss'),)),
    ),
))

register(Scenario(
    name='fused_decode',
    description=('Device-resident decode gate: '
                 'replica latency parameterized by FUSED-LOOP host-'
                 'step time (each request = ceil(tokens/8) host '
                 'rounds observed into skytpu_decode_step_seconds); '
                 'SLOs assert the decode-step p95 and TTFT p95 the '
                 'fused engine must hold, from the same registry '
                 'series production scrapes. A mid-run slowdown '
                 'burst must not break the budget.'),
    replicas=60,
    duration_s=120.0, tick_s=2.0, warmup_s=30.0,
    traffic={'kind': 'burst',
             'inner': {'kind': 'constant', 'qps': 120.0},
             'burst_qps': 60.0, 'at': 70.0, 'duration_s': 30.0},
    profile=replicas_lib.ReplicaProfile(
        startup_median_s=6.0, startup_sigma=0.3,
        ttft_median_s=0.3, ttft_sigma=0.4,
        tokens_median=48, concurrency=8,
        # The reference's fused-round anchor for its own engine: one
        # 8-token fused round per slot.
        decode_step_s=0.12, decode_step_sigma=0.3, fused_steps=8),
    policy={'max_replicas': 80, 'target_qps_per_replica': 3.0,
            'target_queue_per_replica': 4.0,
            'upscale_delay_seconds': 10,
            'downscale_delay_seconds': 120},
    lb_policy='round_robin',
    slos=(
        # The new decode-step-latency signal (the fused engine's own
        # histogram), p95 resolved from bucket deltas: one fused
        # round must stay within the interactive budget.
        slo_lib.HistQuantileBelow(
            'decode_step_p95', threshold=0.25,
            metric='skytpu_decode_step_seconds'),
        slo_lib.HistQuantileBelow('ttft_p95', threshold=2.0),
        slo_lib.RatioBelow('error_rate', threshold=0.005),
    ),
))

register(Scenario(
    name='spec_decode',
    description=('Fused speculative decode gate: replicas '
                 'model device-resident draft/verify rounds (spec_k '
                 'drafts per round, a leading Bernoulli run '
                 'accepted, spec_fuse_rounds rounds per host '
                 'dispatch). SLOs gate the decode-step p95 AND the '
                 'draft acceptance ratio from deltas of the REAL '
                 'skytpu_spec_* counters — the same series the '
                 'engine exports. A mid-run burst must not break '
                 'either.'),
    replicas=60,
    duration_s=120.0, tick_s=2.0, warmup_s=30.0,
    traffic={'kind': 'burst',
             'inner': {'kind': 'constant', 'qps': 120.0},
             'burst_qps': 60.0, 'at': 70.0, 'duration_s': 30.0},
    profile=replicas_lib.ReplicaProfile(
        startup_median_s=6.0, startup_sigma=0.3,
        ttft_median_s=0.3, ttft_sigma=0.4,
        tokens_median=48, concurrency=8,
        # One host dispatch = up to 8 fused spec rounds; the
        # reference's fused-round anchor, for the deeper loop.
        decode_step_s=0.12, decode_step_sigma=0.3,
        spec_k=4, spec_accept_prob=0.8, spec_fuse_rounds=8),
    policy={'max_replicas': 80, 'target_qps_per_replica': 3.0,
            'target_queue_per_replica': 4.0,
            'upscale_delay_seconds': 10,
            'downscale_delay_seconds': 120},
    lb_policy='round_robin',
    slos=(
        slo_lib.HistQuantileBelow(
            'decode_step_p95', threshold=0.25,
            metric='skytpu_decode_step_seconds'),
        # The acceptance-ratio gate, from counter DELTAS of the same
        # skytpu_spec_* series a production spec engine exports:
        # E[leading 0.8-run capped at 4] / 4 ~= 0.59 steady-state.
        slo_lib.CounterRatioAbove(
            'spec_acceptance', threshold=0.45,
            num_metric='skytpu_spec_accepted_tokens_total',
            den_metrics=('skytpu_spec_proposed_tokens_total',)),
        slo_lib.HistQuantileBelow('ttft_p95', threshold=2.0),
        slo_lib.RatioBelow('error_rate', threshold=0.005),
    ),
))

register(Scenario(
    name='shared_prefix',
    description=('Prefix-cache gate: '
                 'traffic dominated by shared system-prompt prefixes '
                 'against replicas with a radix prefix cache. Hits '
                 'skip the matched span\'s prefill (warm TTFT ~ '
                 '0.1x cold) and land in the REAL '
                 'skytpu_prefix_cache_* counters; the SLO gates the '
                 'hit RATIO from counter deltas plus the warm-'
                 'traffic TTFT p95 the cache must buy. A mid-run '
                 'burst (new tenants = cold prefixes) must not break '
                 'either.'),
    replicas=48,
    duration_s=120.0, tick_s=2.0, warmup_s=30.0,
    traffic={'kind': 'burst',
             'inner': {'kind': 'constant', 'qps': 120.0},
             'burst_qps': 40.0, 'at': 70.0, 'duration_s': 20.0},
    profile=replicas_lib.ReplicaProfile(
        startup_median_s=6.0, startup_sigma=0.3,
        ttft_median_s=0.45, ttft_sigma=0.4,
        tokens_median=48, concurrency=8,
        decode_step_s=0.12, decode_step_sigma=0.3, fused_steps=8,
        # ~87% of steady traffic shares a warm 512-token prefix;
        # warm TTFT is ~a tenth of cold (the loadgen-measured shape).
        prefix_hit_ratio=0.87, warm_ttft_factor=0.1,
        shared_prefix_tokens=512),
    policy={'max_replicas': 64, 'target_qps_per_replica': 3.0,
            'target_queue_per_replica': 4.0,
            'upscale_delay_seconds': 10,
            'downscale_delay_seconds': 120},
    lb_policy='round_robin',
    slos=(
        # The cache-hit-ratio gate, from counter DELTAS of the same
        # skytpu_prefix_cache_* series a production engine exports.
        slo_lib.CounterRatioAbove(
            'cache_hit_ratio', threshold=0.75,
            num_metric='skytpu_prefix_cache_hits_total',
            den_metrics=('skytpu_prefix_cache_hits_total',
                         'skytpu_prefix_cache_misses_total')),
        # Warm-dominated traffic must beat the cold-engine budget.
        slo_lib.HistQuantileBelow('ttft_p95', threshold=1.0),
        slo_lib.RatioBelow('error_rate', threshold=0.005),
    ),
))

register(Scenario(
    name='sharded_serve',
    description=('Sharded fast path gate: every replica '
                 'is one tensor=4-sharded engine running the paged '
                 'KV pool (KV heads sharded, tables replicated) '
                 'with the radix prefix cache ON. decode_step_s is '
                 'the per-dispatch '
                 'fused-round latency measured on that topology '
                 '(its all-reduces included); SLOs gate the '
                 'decode-step p95 AND the prefix hit ratio from the '
                 'live skytpu_* registry, the same series a sharded '
                 'production engine exports. A mid-run burst (new '
                 'tenants = cold prefixes) must not break either.'),
    replicas=48,
    duration_s=120.0, tick_s=2.0, warmup_s=30.0,
    traffic={'kind': 'burst',
             'inner': {'kind': 'constant', 'qps': 120.0},
             'burst_qps': 40.0, 'at': 70.0, 'duration_s': 20.0},
    profile=replicas_lib.ReplicaProfile(
        startup_median_s=6.0, startup_sigma=0.3,
        ttft_median_s=0.45, ttft_sigma=0.4,
        tokens_median=48, concurrency=8,
        # Fused-round dispatch on the 4-way tensor split: the
        # reference's fused anchor plus its per-layer all-reduce tax.
        decode_step_s=0.15, decode_step_sigma=0.3, fused_steps=8,
        prefix_hit_ratio=0.8, warm_ttft_factor=0.12,
        shared_prefix_tokens=512,
        mesh_shape=(('tensor', 4),)),
    policy={'max_replicas': 64, 'target_qps_per_replica': 3.0,
            'target_queue_per_replica': 4.0,
            'upscale_delay_seconds': 10,
            'downscale_delay_seconds': 120},
    lb_policy='round_robin',
    slos=(
        slo_lib.HistQuantileBelow(
            'decode_step_p95', threshold=0.3,
            metric='skytpu_decode_step_seconds'),
        slo_lib.CounterRatioAbove(
            'prefix_hit_ratio', threshold=0.7,
            num_metric='skytpu_prefix_cache_hits_total',
            den_metrics=('skytpu_prefix_cache_hits_total',
                         'skytpu_prefix_cache_misses_total')),
        slo_lib.HistQuantileBelow('ttft_p95', threshold=1.5),
        slo_lib.RatioBelow('error_rate', threshold=0.005),
    ),
))

register(Scenario(
    name='prefix_affinity',
    description=('Content-aware serve plane gate: a '
                 'multi-pool fleet (prefill-role + decode-role '
                 'replicas, each pool scaled by its own signal-'
                 'driven autoscaler) serving shared-prefix traffic '
                 'through the REAL LB dispatch + PrefixAffinityPolicy'
                 '. Replicas model CONTENT-aware radix caches (LRU '
                 'over served prefix families), so the fleet hit '
                 'ratio is a routing outcome: affinity keeps '
                 'families pinned to warm replicas, the least_load '
                 'baseline pass (same seed, fresh fleet) scatters '
                 'them. One report gates the affinity hit ratio, '
                 'warm TTFT p95, decode-step p95 AND the >= 2x '
                 'hit-ratio improvement over the baseline.'),
    replicas=30,                       # informational; pools govern
    duration_s=90.0, tick_s=2.0, warmup_s=24.0,
    traffic={'kind': 'constant', 'qps': 120.0},
    profile=_SMOKE_PROFILE,            # fallback only; pools below
    pools={
        'prefill': {'role': 'prefill', 'min_replicas': 6,
                    'max_replicas': 10,
                    'target_queue_per_replica': 4.0,
                    'ttft_p95_upscale_threshold': 3.0,
                    'upscale_delay_seconds': 10,
                    'downscale_delay_seconds': 120},
        'decode': {'role': 'decode', 'min_replicas': 24,
                   'max_replicas': 32,
                   'target_queue_per_replica': 4.0,
                   'kv_util_upscale_threshold': 0.85,
                   'decode_step_p95_upscale_threshold': 0.35,
                   'upscale_delay_seconds': 10,
                   'downscale_delay_seconds': 120},
    },
    pool_profiles={
        # Prefill-heavy hardware: absorbs unique 2048-token prompts;
        # no prefix-cache term (unique prompts never re-match).
        'prefill': replicas_lib.ReplicaProfile(
            startup_median_s=6.0, startup_sigma=0.3,
            ttft_median_s=0.7, ttft_sigma=0.4,
            tokens_median=16, concurrency=8,
            decode_step_s=0.12, decode_step_sigma=0.3,
            fused_steps=8),
        # Decode-heavy hardware with a content-aware radix cache: 8
        # prefix families per replica — fleet capacity 8 x 24 = 192
        # family-slots for 48 families, so ROUTING decides whether a
        # family's requests find their warm replica.
        'decode': replicas_lib.ReplicaProfile(
            startup_median_s=6.0, startup_sigma=0.3,
            ttft_median_s=0.45, ttft_sigma=0.4,
            tokens_median=48, concurrency=8,
            decode_step_s=0.12, decode_step_sigma=0.3,
            fused_steps=8,
            prefix_cache_capacity=8, warm_ttft_factor=0.1,
            shared_prefix_tokens=512),
    },
    workload={'families': 48, 'prefix_tokens': 512, 'tail_tokens': 16,
              'max_new_tokens': 48,
              'long_prompt': {'fraction': 0.15,
                              'prompt_tokens': 2048,
                              'max_new_tokens': 16}},
    lb_policy='prefix_affinity',
    compare_lb_policy='least_load',
    min_hit_ratio_improvement=2.0,
    slos=(
        # The fleet-wide cache-hit-ratio gate, from deltas of the
        # REAL skytpu_prefix_cache_* counters the decode replicas
        # increment — >= 0.6 is the scenario's acceptance bar.
        slo_lib.CounterRatioAbove(
            'cache_hit_ratio', threshold=0.6,
            num_metric='skytpu_prefix_cache_hits_total',
            den_metrics=('skytpu_prefix_cache_hits_total',
                         'skytpu_prefix_cache_misses_total')),
        # The median proves warm domination (warm chat TTFT ~0.045s;
        # a scattered fleet's p50 sits at COLD ~0.45s): affinity has
        # to buy an order of magnitude here or the ratio above is
        # hollow.
        slo_lib.HistQuantileBelow('ttft_p50', threshold=0.35, q=0.5),
        # The tail carries the 15% unique long-prompt class (cold by
        # construction) — the budget is the mixed-workload one, not
        # the warm one.
        slo_lib.HistQuantileBelow('ttft_p95', threshold=2.0),
        slo_lib.HistQuantileBelow(
            'decode_step_p95', threshold=0.35,
            metric='skytpu_decode_step_seconds'),
        slo_lib.RatioBelow('error_rate', threshold=0.005),
    ),
    # The baseline pass RESOLVES its ratio/latency values without
    # gating them (threshold 0 / huge): a deliberately-bad baseline
    # failing its own SLOs must not fail the report — the comparison
    # assert is the gate.
    baseline_slos=(
        slo_lib.CounterRatioAbove(
            'baseline_cache_hit_ratio', threshold=0.0,
            num_metric='skytpu_prefix_cache_hits_total',
            den_metrics=('skytpu_prefix_cache_hits_total',
                         'skytpu_prefix_cache_misses_total')),
        slo_lib.HistQuantileBelow('baseline_ttft_p95',
                                  threshold=1e9),
    ),
))

register(Scenario(
    name='watchdog',
    description=('Live-watchdog gate: a two-zone fleet '
                 'loses zone-a under sustained traffic; the LIVE '
                 'watchdog (ticked on the virtual clock) watches '
                 'READY replica count and must FIRE during the '
                 'outage, stay silent before it, and CLEAR once '
                 'replacement capacity lands in the surviving zone '
                 '— all three transitions gated from deltas of the '
                 'REAL skytpu_watchdog_alerts_total counter the '
                 'engine increments.'),
    replicas=40,
    duration_s=220.0, tick_s=2.0, warmup_s=30.0,
    traffic={'kind': 'constant', 'qps': 100.0},
    profile=_SMOKE_PROFILE,
    zones=('zone-a', 'zone-b'),
    # Empty policy = FixedReplicaAutoscaler holding 40: the
    # controller replaces the lost zone's replicas (SimFleet places
    # new capacity only in surviving zones), which is exactly what
    # clears the alert mid-outage.
    lb_policy='round_robin',
    chaos=(
        {'at': 56.0, 'action': 'mark', 'name': 'pre_outage'},
        {'at': 60.0, 'action': 'zone_loss', 'zone': 'zone-a'},
        {'at': 160.0, 'action': 'zone_restore', 'zone': 'zone-a'},
    ),
    watchdog=(
        # With 40 replicas over two zones, losing zone-a halves
        # READY (~20 < 32); replacements restore it past the floor.
        watchdog_lib.GaugeWithin(
            'ready_replicas', 'skytpu_serve_replicas',
            lo=32.0, hi=float('inf'),
            labels={'service': 'fleetsim-watchdog',
                    'state': 'READY'},
            window=12.0),
    ),
    slos=(
        # The three watchdog-transition gates, from counter deltas:
        # silent before the outage...
        slo_lib.CounterDeltaWithin(
            'watchdog_silent_before_outage',
            metric='skytpu_watchdog_alerts_total',
            labels=(('rule', 'ready_replicas'), ('state', 'fire')),
            min_delta=0.0, max_delta=0.0,
            window=('start', 'pre_outage')),
        # ...fired during it...
        slo_lib.CounterDeltaWithin(
            'watchdog_fired_on_outage',
            metric='skytpu_watchdog_alerts_total',
            labels=(('rule', 'ready_replicas'), ('state', 'fire')),
            min_delta=1.0,
            window=('pre_outage', 'end')),
        # ...and cleared once replacements restored capacity.
        slo_lib.CounterDeltaWithin(
            'watchdog_cleared_on_recovery',
            metric='skytpu_watchdog_alerts_total',
            labels=(('rule', 'ready_replicas'), ('state', 'clear')),
            min_delta=1.0,
            window=('pre_outage', 'end')),
        slo_lib.GaugeWithin('zone_loss_recovery', threshold=90.0,
                            labels=(('event', 'zone_loss'),)),
        slo_lib.HistQuantileBelow('ttft_p95', threshold=2.0),
        slo_lib.RatioBelow('error_rate', threshold=0.01),
    ),
))

register(Scenario(
    name='zone_loss',
    description=('The acceptance soak: 1000+ replicas across three '
                 'zones, a full zone killed and later restored, '
                 'recovery on the virtual clock.'),
    replicas=1002,
    duration_s=900.0, tick_s=5.0, warmup_s=220.0,
    traffic={'kind': 'diurnal', 'base_qps': 700.0, 'peak_qps': 1000.0,
             'period_s': 1800.0, 'phase_s': 450.0},
    profile=_FLEET_PROFILE,
    policy={'max_replicas': 1100, 'target_qps_per_replica': 1.2,
            'target_queue_per_replica': 4.0,
            'upscale_delay_seconds': 30,
            'downscale_delay_seconds': 600},
    chaos=(
        {'at': 300.0, 'action': 'zone_loss', 'zone': 'zone-a'},
        {'at': 600.0, 'action': 'zone_restore', 'zone': 'zone-a'},
    ),
    slos=(
        slo_lib.HistQuantileBelow('ttft_p95', threshold=3.0),
        slo_lib.RatioBelow('error_rate', threshold=0.005),
        slo_lib.RatioBelow(
            'unavailable_rate', threshold=0.002,
            num_values=('no_replica', 'all_open')),
        slo_lib.GaugeWithin('zone_loss_recovery', threshold=300.0,
                            labels=(('event', 'zone_loss'),)),
    ),
))

register(Scenario(
    name='rolling_update',
    description=('200 replicas under sustained traffic through a '
                 'rolling update: the surge/retire pacing must hold '
                 'error rate and TTFT.'),
    replicas=200,
    duration_s=600.0, tick_s=5.0, warmup_s=180.0,
    traffic={'kind': 'burst',
             'inner': {'kind': 'constant', 'qps': 260.0},
             'burst_qps': 120.0, 'at': 420.0, 'duration_s': 90.0},
    profile=_FLEET_PROFILE,
    policy={'max_replicas': 260, 'target_qps_per_replica': 1.6,
            'target_queue_per_replica': 4.0,
            'upscale_delay_seconds': 30,
            'downscale_delay_seconds': 600},
    chaos=(
        {'at': 200.0, 'action': 'rolling_update'},
    ),
    slos=(
        slo_lib.HistQuantileBelow('ttft_p95', threshold=3.0),
        slo_lib.RatioBelow('update_error_rate', threshold=0.005,
                           window=('update_start', 'end')),
        slo_lib.RatioBelow('error_rate', threshold=0.005),
    ),
))

register(Scenario(
    name='trace_breach',
    description=('DELIBERATELY-FAILING flight-recorder drill (not in '
                 'the tier-1/run_full pass set): a small fleet loses '
                 'a zone with no restore, and an unmeetable TTFT '
                 'target forces rc=1 — the point is the failing '
                 'report itself, which must carry the span flight '
                 'recorder (lb.proxy/lb.upstream trees including the '
                 'error-marked failovers the zone loss caused).'),
    replicas=12,
    duration_s=40.0, tick_s=2.0, warmup_s=10.0,
    traffic={'kind': 'constant', 'qps': 30.0},
    profile=_SMOKE_PROFILE,
    policy={'max_replicas': 16, 'target_qps_per_replica': 3.0,
            'target_queue_per_replica': 4.0,
            'upscale_delay_seconds': 10,
            'downscale_delay_seconds': 120},
    lb_policy='round_robin',
    chaos=(
        {'at': 20.0, 'action': 'zone_loss', 'zone': 'zone-a'},
    ),
    slos=(
        # Unmeetable on purpose: no simulated fleet serves sub-0.1ms
        # TTFT, so this report always lands with rc=1 and therefore
        # always exercises the flight-recorder path.
        slo_lib.HistQuantileBelow('ttft_p95_unmeetable',
                                  threshold=0.0001),
        slo_lib.RatioBelow('error_rate', threshold=0.005),
    ),
))

register(Scenario(
    name='preemption_wave',
    description=('A spot fleet with dynamic on-demand fallback loses '
                 'half its replicas in one preemption wave; the '
                 'fallback autoscaler must cover the gap.'),
    replicas=300,
    duration_s=720.0, tick_s=5.0, warmup_s=260.0,
    traffic={'kind': 'constant', 'qps': 320.0},
    profile=_FLEET_PROFILE,
    policy={'max_replicas': 400, 'target_qps_per_replica': 1.2,
            'use_spot': True,
            'base_ondemand_fallback_replicas': 10,
            'dynamic_ondemand_fallback': True,
            'upscale_delay_seconds': 30,
            'downscale_delay_seconds': 600},
    chaos=(
        {'at': 320.0, 'action': 'preemption_wave', 'count': 150},
    ),
    slos=(
        slo_lib.HistQuantileBelow('ttft_p95', threshold=4.5),
        slo_lib.RatioBelow('error_rate', threshold=0.01),
        slo_lib.GaugeWithin('preemption_recovery', threshold=300.0,
                            labels=(('event', 'preemption_wave'),)),
    ),
))

register(Scenario(
    name='preemption_migration',
    description=('Preemption-safe serving gate: bursts of '
                 'preemption notices land on the busiest replicas '
                 'mid-decode; every interrupted request must snapshot '
                 'its KV state and restore onto a survivor. Gates the '
                 'migration success RATIO (successes / attempts, '
                 'counter deltas) and the client-visible interruption '
                 'gap p95 (bucket deltas) from the REAL '
                 'skytpu_migration_* series the production LB emits. '
                 'A mid-run armed lb.migrate fault forces a couple of '
                 'honest terminations so the failure rung is '
                 'exercised without breaching the 0.9 floor.'),
    replicas=24,
    duration_s=240.0, tick_s=2.0, warmup_s=60.0,
    traffic={'kind': 'constant', 'qps': 60.0},
    profile=replicas_lib.ReplicaProfile(
        startup_median_s=6.0, startup_sigma=0.3,
        ttft_median_s=0.3, ttft_sigma=0.4,
        decode_per_token_s=0.02, tokens_median=32, concurrency=8,
        # Snapshot+restore ladder: ~0.6 s median client-visible gap
        # (drain notice -> snapshot -> re-route -> restore splice),
        # the envelope the two-server drain smoke measures on CPU.
        migration_latency_s=0.6, migration_latency_sigma=0.4),
    policy={'max_replicas': 32, 'target_qps_per_replica': 3.0,
            'target_queue_per_replica': 4.0,
            'upscale_delay_seconds': 10,
            'downscale_delay_seconds': 120},
    lb_policy='round_robin',
    chaos=(
        {'at': 90.0, 'action': 'preempt_replicas', 'count': 3},
        # Two forced ladder failures: the failure rung must be
        # exercised (and counted separately) without breaching 0.9.
        {'at': 138.0, 'action': 'arm_fault', 'point': 'lb.migrate',
         'times': 2},
        {'at': 140.0, 'action': 'preempt_replicas', 'count': 3},
        {'at': 190.0, 'action': 'preempt_replicas', 'count': 3},
    ),
    slos=(
        slo_lib.CounterRatioAbove(
            'migration_success', threshold=0.9,
            num_metric='skytpu_migration_successes_total',
            den_metrics=('skytpu_migration_attempts_total',)),
        slo_lib.HistQuantileBelow(
            'migration_interruption_p95', threshold=2.0,
            metric='skytpu_migration_interruption_seconds'),
        slo_lib.HistQuantileBelow('ttft_p95', threshold=2.0),
        slo_lib.RatioBelow('error_rate', threshold=0.01),
    ),
))

register(Scenario(
    name='disaggregation',
    description=('Disaggregated prefill/decode gate: a '
                 'skewed prompt/gen mix (35% streamed 2k-token/'
                 '16-gen requests, the rest short interactive chat) '
                 'through prefill + decode pools with PLANNED KV '
                 'handoff: eligible requests prefill in the prefill '
                 'pool, then their decode leg moves to a decode-pool '
                 'replica (transfer gap -> the real '
                 'skytpu_handoff_transfer_seconds). Chaos kills the '
                 'busiest DECODE replicas mid-wave and an armed '
                 'lb.handoff fault forces co-located fallbacks — '
                 'both are COUNTED degradations, never failed '
                 'requests. Gates the handoff success ratio, zero '
                 'hard failures, transfer p95, and the decode-pool '
                 'TTFT p95 with the co-located baseline pass (same '
                 'seed, handoff off) in the same report.'),
    replicas=18,                       # informational; pools govern
    duration_s=240.0, tick_s=2.0, warmup_s=60.0,
    traffic={'kind': 'constant', 'qps': 40.0},
    profile=_SMOKE_PROFILE,            # fallback only; pools below
    pools={
        'prefill': {'role': 'prefill', 'min_replicas': 6,
                    'max_replicas': 10,
                    'target_queue_per_replica': 4.0,
                    'ttft_p95_upscale_threshold': 3.0,
                    'upscale_delay_seconds': 10,
                    'downscale_delay_seconds': 120},
        'decode': {'role': 'decode', 'min_replicas': 12,
                   'max_replicas': 18,
                   'target_queue_per_replica': 4.0,
                   'kv_util_upscale_threshold': 0.85,
                   'upscale_delay_seconds': 10,
                   'downscale_delay_seconds': 120},
    },
    pool_profiles={
        # Prefill-heavy hardware: absorbs the 2k-token prompts, then
        # hands the decode remainder off (~0.3 s KV transfer, the
        # paged-pool gather/splice envelope) — the slot stays live
        # under the lease for the transfer window.
        'prefill': replicas_lib.ReplicaProfile(
            startup_median_s=6.0, startup_sigma=0.3,
            ttft_median_s=0.7, ttft_sigma=0.4,
            tokens_median=16, concurrency=8,
            decode_step_s=0.12, decode_step_sigma=0.3,
            fused_steps=8,
            migration_latency_s=0.5,
            handoff_transfer_s=0.3, handoff_transfer_sigma=0.4),
        # Decode-heavy hardware: short interactive traffic plus the
        # handed-off decode legs; killed replicas rescue their
        # in-flight work through the migration backstop.
        'decode': replicas_lib.ReplicaProfile(
            startup_median_s=6.0, startup_sigma=0.3,
            ttft_median_s=0.35, ttft_sigma=0.4,
            tokens_median=48, concurrency=8,
            decode_step_s=0.12, decode_step_sigma=0.3,
            fused_steps=8,
            migration_latency_s=0.5),
    },
    workload={'families': 32, 'prefix_tokens': 256, 'tail_tokens': 16,
              'max_new_tokens': 48,
              'long_prompt': {'fraction': 0.35,
                              'prompt_tokens': 2048,
                              'max_new_tokens': 16,
                              'stream': True}},
    lb_policy='round_robin',
    compare_handoff_off=True,
    chaos=(
        # Preemption notices land on the BUSIEST decode replicas —
        # the ones holding handed-off legs — twice, mid-traffic.
        {'at': 90.0, 'action': 'preempt_replicas', 'count': 2,
         'pool': 'decode'},
        # A few forced co-located fallbacks: the degradation rung
        # must be exercised (and counted) without breaching 0.85.
        {'at': 130.0, 'action': 'arm_fault', 'point': 'lb.handoff',
         'times': 3},
        {'at': 170.0, 'action': 'preempt_replicas', 'count': 2,
         'pool': 'decode'},
    ),
    slos=(
        slo_lib.CounterRatioAbove(
            'handoff_success', threshold=0.85,
            num_metric='skytpu_handoff_successes_total',
            den_metrics=('skytpu_handoff_attempts_total',)),
        # Zero hard failures: every degraded handoff must complete
        # co-located, never 502.
        slo_lib.RatioBelow('failed_requests', threshold=0.0),
        slo_lib.HistQuantileBelow(
            'handoff_transfer_p95', threshold=1.5,
            metric='skytpu_handoff_transfer_seconds'),
        slo_lib.HistQuantileBelow(
            'decode_pool_ttft_p95', threshold=1.5,
            metric='skytpu_fleetsim_decode_ttft_seconds'),
        slo_lib.HistQuantileBelow('ttft_p95', threshold=3.0),
    ),
    # The co-located pass resolves the same series ungated: the
    # report carries decode-pool TTFT with and without handoff side
    # by side.
    baseline_slos=(
        slo_lib.HistQuantileBelow(
            'baseline_decode_pool_ttft_p95', threshold=1e9,
            metric='skytpu_fleetsim_decode_ttft_seconds'),
        slo_lib.HistQuantileBelow('baseline_ttft_p95',
                                  threshold=1e9),
        slo_lib.RatioBelow('baseline_failed_requests',
                           threshold=0.0),
    ),
))
