"""Service controller: probe -> autoscale -> sync LB, in one loop.

The port of `skypilot_tpu/serve/controller.py`: `_pick_victims` and
`ServeController` with the reference's injection seams (`manager`,
`lb`, `now_fn`, `sleep_fn`, `signal_source`; the port's fleet simulator
drives this class as the reference's drives its own), `run`, `_step`
(:106-166: the `controller.step` fault, spec reload, probe round,
LB sync, rolling update, LB sync, then the fleet-wide autoscaler with the
rolling update's surge protected, the spot / on-demand mixed pools, or
the per-pool reconcile with role-aware `set_replicas`), `_pool_name_of`,
`_pool_role_map`, `_scale_pools`, `_export_metrics` (SERVE_REPLICAS,
AUTOSCALER_TARGET_REPLICAS / AUTOSCALER_ACTUAL_REPLICAS),
`_set_health_status`, `_scale_mixed`, `_maybe_reload_spec`,
`_rolling_update` / `_rolling_update_pool` (one surge replica at a time,
READY capacity kept above min_replicas; an old replica leaves the LB
before it is torn down, `_retire`) and `_shutdown`; `start` and
`python -m skypilot_tpu_torch.serve.controller --service-name NAME`.

One controller process per service runs the replica manager loop and
hosts the port's load balancer (`serve/load_balancer.py`, on the
standard library) on its own threads. The task is the port's `task.py`
subset. The process imports no torch: it never touches the card.
"""
import argparse
import logging
import os
import time
import traceback
from typing import Callable, Optional

from skypilot_tpu_torch import envs
from skypilot_tpu_torch.observability import instruments as obs
from skypilot_tpu_torch.resilience import faults
from skypilot_tpu_torch.serve import autoscalers
from skypilot_tpu_torch.serve import load_balancer as lb_lib
from skypilot_tpu_torch.serve import replica_managers
from skypilot_tpu_torch.serve import serve_state
from skypilot_tpu_torch.serve import service_spec as spec_lib

logger = logging.getLogger(__name__)


def _loop_interval_seconds() -> float:
    """Read at call time: controllers are spawned as fresh processes
    and tests tune the cadence after import."""
    return envs.SKYTPU_SERVE_LOOP_INTERVAL.get()


def _pick_victims(pool, n, protected=frozenset()):
    """Replica ids to retire: not-ready first, then newest (highest
    id, least-warm); never a protected (rolling-update surge) one."""
    candidates = sorted(
        (r for r in pool if r['replica_id'] not in protected),
        key=lambda r: (r['status'] == serve_state.ReplicaStatus.READY,
                       -r['replica_id']))
    return [r['replica_id'] for r in candidates[:n]]


class ServeController:
    """One service's reconcile loop.

    `manager`, `lb`, `now_fn` and `sleep_fn` are injection seams: the
    fleet simulator (skypilot_tpu_torch/fleetsim) drives this EXACT class
    against thousands of mock replicas on a virtual clock, so the
    reconcile logic soak-tested in CI is the code production runs —
    the same discipline resilience/retries.py uses for its clocks.
    """

    def __init__(self, service_name: str,
                 manager=None, lb=None,
                 now_fn: Callable[[], float] = time.time,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 signal_source: Optional[
                     autoscalers.MetricsSignalSource] = None) -> None:
        self.service_name = service_name
        service = serve_state.get_service(service_name)
        assert service is not None, service_name
        from skypilot_tpu_torch import task as task_lib
        self.task = task_lib.Task.from_yaml_config(service['task_yaml'])
        assert self.task.service is not None
        self.spec: spec_lib.ServiceSpec = self.task.service
        self.manager = manager if manager is not None else \
            replica_managers.ReplicaManager(
                service_name, self.task, self.spec)
        self.autoscaler = autoscalers.make_autoscaler(self.spec,
                                                      now_fn=now_fn)
        # Disaggregated pools: one signal-driven autoscaler per named
        # pool; empty for legacy poolless specs (the fleet-wide
        # autoscaler above governs those).
        self.pool_autoscalers = autoscalers.make_pool_autoscalers(
            self.spec, now_fn=now_fn)
        self.lb = lb if lb is not None else lb_lib.LoadBalancer(
            self.spec.load_balancing_policy, port=service['lb_port'],
            now_fn=now_fn)
        self.signals = signal_source if signal_source is not None \
            else autoscalers.MetricsSignalSource()
        self._now = now_fn
        self._sleep = sleep_fn
        self._stop = False

    def run(self) -> None:
        try:
            serve_state.set_service_controller(self.service_name,
                                               os.getpid())
            self.lb.start()
            serve_state.set_service_status(
                self.service_name, serve_state.ServiceStatus.REPLICA_INIT)
            if self.spec.pools:
                for name, pool in self.spec.pools.items():
                    self.manager.scale_up(pool.min_replicas, pool=name)
            else:
                self.manager.scale_up(self.spec.min_replicas)
            while not self._stop:
                self._step()
                self._sleep(_loop_interval_seconds())
        except BaseException:  # noqa: BLE001
            traceback.print_exc()
            serve_state.set_service_status(
                self.service_name, serve_state.ServiceStatus.FAILED)
            raise

    def _step(self) -> None:
        # Armed with latency this models a stalled controller, with an
        # exception a crashed tick — chaos schedules exercise both.
        faults.inject('controller.step', sleep_fn=self._sleep,
                      env_exc=RuntimeError)
        service = serve_state.get_service(self.service_name)
        if service is None or \
                service['status'] == serve_state.ServiceStatus.SHUTTING_DOWN:
            self._shutdown()
            return
        self._maybe_reload_spec(service)
        self.manager.probe_all()
        # The LB learns this round's READY replicas before the rolling
        # update may retire one. The reference syncs only after it: a
        # retired replica stayed the LB's only target while it was torn
        # down, and the surge replica that had just turned READY was not
        # routed to until the next tick (ROADMAP Queue 3).
        self._sync_lb(serve_state.get_replicas(self.service_name))
        updating = self._rolling_update(service)
        replicas = serve_state.get_replicas(self.service_name)
        ready = self.manager.ready_endpoints()

        live = [r for r in replicas
                if r['status'] not in (
                    serve_state.ReplicaStatus.SHUTTING_DOWN,
                    serve_state.ReplicaStatus.FAILED)]
        self._sync_lb(replicas)
        if self.spec.pools:
            target = self._scale_pools(service, live, ready, updating)
            self._export_metrics(replicas, live, target)
            self._set_health_status(live, ready)
            return
        # During a rolling update the ROLLOUT owns replacing old
        # replicas; the autoscaler must neither kill the new-version
        # surge replicas nor treat them as excess. Protection is
        # CAPPED at the rollout's own entitlement (min_replicas + 1
        # newest new-version replicas): autoscaler-spawned spike
        # replicas also carry the new version, and blanket-protecting
        # them would let a stalled update pin a scaled-up fleet at
        # peak cost — the failure mode this gate exists to avoid.
        surge = sorted(
            (r for r in live
             if updating and r['version'] >= service['version']),
            key=lambda r: -r['replica_id'])
        protected = frozenset(
            r['replica_id']
            for r in surge[:self.spec.min_replicas + 1])
        if isinstance(self.autoscaler,
                      autoscalers.FallbackRequestRateAutoscaler):
            target = self._scale_mixed(live, protected)
        else:
            decision = self.autoscaler.decide(
                len(ready), len(live), self.lb.tracker.qps(),
                self.signals.read())
            target = decision.target_replicas
            if decision.target_replicas > len(live):
                self.manager.scale_up(
                    decision.target_replicas - len(live))
            else:
                n = len(live) - decision.target_replicas - len(protected)
                if n > 0:
                    self.manager.scale_down(
                        _pick_victims(live, n, protected))

        self._export_metrics(replicas, live, target)
        self._set_health_status(live, ready)

    def _sync_lb(self, replicas) -> None:
        ready = self.manager.ready_endpoints()
        if self.spec.pools:
            # Pool-aware LB sync: the routing layer needs each ready
            # endpoint's pool ROLE to steer request shapes.
            self.lb.set_replicas(
                ready, pools=self._pool_role_map(replicas))
        else:
            self.lb.set_replicas(ready)

    # -- replica pools --------------------------------------------------------

    def _pool_name_of(self, replica) -> str:
        """A row's pool, defaulting unpooled strays (pre-migration
        rows) into the first declared pool so they stay governed."""
        pool = replica.get('pool')
        if pool in self.spec.pools:
            return pool
        return next(iter(self.spec.pools))

    def _pool_role_map(self, replicas) -> dict:
        return {
            r['endpoint']: self.spec.pools[self._pool_name_of(r)].role
            for r in replicas
            if r['endpoint'] and
            r['status'] == serve_state.ReplicaStatus.READY}

    def _scale_pools(self, service, live, ready, updating) -> int:
        """Per-pool reconcile: each pool's signal-driven autoscaler
        sees only its own replicas and its own pressure signals (one
        shared snapshot per tick so pools never race each other for
        the histogram windows). Returns the combined target."""
        names = list(self.spec.pools)
        reader = getattr(self.signals, 'read_pools', None)
        signals = reader(names) if reader is not None else \
            {name: self.signals.read() for name in names}
        qps = self.lb.tracker.qps()
        ready_set = set(ready)
        total_target = 0
        for name, pool in self.spec.pools.items():
            pool_live = [r for r in live
                         if self._pool_name_of(r) == name]
            pool_ready = [r for r in pool_live
                          if r['endpoint'] in ready_set]
            # Same surge-protection rule as the fleet-wide path,
            # scoped to this pool's rollout entitlement.
            surge = sorted(
                (r for r in pool_live
                 if updating and r['version'] >= service['version']),
                key=lambda r: -r['replica_id'])
            protected = frozenset(
                r['replica_id']
                for r in surge[:pool.min_replicas + 1])
            decision = self.pool_autoscalers[name].decide(
                len(pool_ready), len(pool_live), qps,
                signals.get(name))
            target = decision.target_replicas
            total_target += target
            if target > len(pool_live):
                self.manager.scale_up(target - len(pool_live),
                                      pool=name)
            else:
                n = len(pool_live) - target - len(protected)
                if n > 0:
                    self.manager.scale_down(
                        _pick_victims(pool_live, n, protected))
            obs.POOL_TARGET_REPLICAS.labels(
                service=self.service_name, pool=name).set(target)
            obs.POOL_READY_REPLICAS.labels(
                service=self.service_name, pool=name).set(
                    len(pool_ready))
        return total_target

    def _export_metrics(self, replicas, live, target) -> None:
        """Serve-plane gauges: replica counts per lifecycle state plus
        autoscaler target vs. actual — the launch→ready gap and
        scaling lag become scrapes instead of log archaeology. Every
        state is set each tick (including to 0) so a drained state's
        stale gauge can't linger."""
        counts = {state: 0 for state in serve_state.ReplicaStatus}
        for r in replicas:
            counts[r['status']] = counts.get(r['status'], 0) + 1
        for state, n in counts.items():
            obs.SERVE_REPLICAS.labels(service=self.service_name,
                                      state=state.value).set(n)
        obs.AUTOSCALER_TARGET_REPLICAS.labels(
            service=self.service_name).set(target)
        obs.AUTOSCALER_ACTUAL_REPLICAS.labels(
            service=self.service_name).set(len(live))

    def _set_health_status(self, live, ready) -> None:
        status = (serve_state.ServiceStatus.READY if ready else
                  (serve_state.ServiceStatus.NO_REPLICA if not live else
                   serve_state.ServiceStatus.REPLICA_INIT))
        serve_state.set_service_status(self.service_name, status)

    def _scale_mixed(self, live, protected=frozenset()) -> int:
        """Spot fleet with on-demand fallback: reconcile the two pools
        separately toward the mixed decision. `protected` replicas
        (rolling-update surge) are never victims and grant their pool
        an equal headroom allowance. Returns the combined target."""
        spot = [r for r in live if r.get('use_spot')]
        ondemand = [r for r in live if not r.get('use_spot')]
        ready_spot = [r for r in spot
                      if r['status'] == serve_state.ReplicaStatus.READY]
        decision = self.autoscaler.decide_mixed(
            len(ready_spot), len(spot), len(ondemand),
            self.lb.tracker.qps(), self.signals.read())

        def reconcile(pool, target, use_spot):
            if target > len(pool):
                self.manager.scale_up(target - len(pool),
                                      use_spot=use_spot)
            else:
                shielded = sum(1 for r in pool
                               if r['replica_id'] in protected)
                n = len(pool) - target - shielded
                if n > 0:
                    self.manager.scale_down(
                        _pick_victims(pool, n, protected))

        reconcile(spot, decision.target_spot, True)
        reconcile(ondemand, decision.target_ondemand, False)
        return decision.target_spot + decision.target_ondemand

    def _maybe_reload_spec(self, service) -> None:
        """Pick up a version bump from `serve update` (new task YAML)."""
        if service['version'] == getattr(self, '_loaded_version', 1):
            return
        from skypilot_tpu_torch import task as task_lib
        self.task = task_lib.Task.from_yaml_config(service['task_yaml'])
        self.spec = self.task.service
        self.manager.task = self.task
        self.manager.spec = self.spec
        self.autoscaler.update_spec(self.spec)
        # Pool membership may have changed shape entirely (pools
        # added/dropped): rebuild rather than patch, but preserve
        # each surviving pool's hysteresis clock state.
        fresh = autoscalers.make_pool_autoscalers(self.spec,
                                                  now_fn=self._now)
        for name, scaler in fresh.items():
            old = self.pool_autoscalers.get(name)
            if old is not None:
                old.update_spec(scaler.spec)
                fresh[name] = old
        self.pool_autoscalers = fresh
        self._loaded_version = service['version']

    def _rolling_update(self, service) -> bool:
        """Replace old-version replicas one at a time, never dropping
        below the ready set (reference rolling update,
        replica_managers.py version tracking). With pools, each pool
        rolls independently (its own surge, its own min_replicas
        floor) — a slow prefill-pool rollout must not stall decode's.
        Returns True while an update is in progress (old-version
        replicas still live)."""
        replicas = serve_state.get_replicas(self.service_name)
        if self.spec.pools:
            updating = False
            for name, pool in self.spec.pools.items():
                rows = [r for r in replicas
                        if self._pool_name_of(r) == name]
                updating |= self._rolling_update_pool(
                    service, rows, pool.min_replicas, pool=name)
            return updating
        return self._rolling_update_pool(
            service, replicas, self.spec.min_replicas, pool=None)

    def _rolling_update_pool(self, service, replicas,
                             min_replicas: int,
                             pool: Optional[str]) -> bool:
        version = service['version']
        old = [r for r in replicas if r['version'] < version and
               r['status'] not in (serve_state.ReplicaStatus.SHUTTING_DOWN,
                                   serve_state.ReplicaStatus.FAILED)]
        if not old:
            return False
        new_live = [r for r in replicas if r['version'] >= version and
                    r['status'] not in (
                        serve_state.ReplicaStatus.SHUTTING_DOWN,
                        serve_state.ReplicaStatus.FAILED)]
        new_ready = [r for r in new_live
                     if r['status'] == serve_state.ReplicaStatus.READY]
        # One surge replica at a time: launch a new-version replica if
        # none is in flight. Retirement pacing counts only READY old
        # replicas as capacity: retire dead weight (not-ready old)
        # freely once replacements appear, but retire a READY old one
        # only while (old_ready + new_ready) stays above min_replicas —
        # retiring per tick merely because SOME new replica is ready
        # would collapse serving capacity while later surges boot.
        if len(new_live) < min_replicas + 1 and \
                len(new_live) == len(new_ready):
            if pool is None:
                self.manager.scale_up(1)
            else:
                self.manager.scale_up(1, pool=pool)
        if new_ready:
            old_ready = [r for r in old if r['status'] ==
                         serve_state.ReplicaStatus.READY]
            old_not_ready = [r for r in old if r['status'] !=
                             serve_state.ReplicaStatus.READY]
            if old_not_ready:
                victim = min(old_not_ready,
                             key=lambda r: r['replica_id'])
                self._retire([victim['replica_id']])
            elif old_ready and len(old_ready) + len(new_ready) > \
                    min_replicas:
                victim = min(old_ready, key=lambda r: r['replica_id'])
                self._retire([victim['replica_id']])
        return True

    def _retire(self, replica_ids) -> None:
        """An update's old replicas: out of the LB, then torn down. The
        reference tears them down while the LB still routes to them
        (ROADMAP Queue 3); the LB holds what this tick's sync would
        give it either way."""
        for replica_id in replica_ids:
            serve_state.set_replica_status(
                self.service_name, replica_id,
                serve_state.ReplicaStatus.SHUTTING_DOWN)
        self._sync_lb(serve_state.get_replicas(self.service_name))
        self.manager.scale_down(replica_ids)

    def _shutdown(self) -> None:
        self.manager.terminate_all()
        self.lb.stop()
        serve_state.remove_service(self.service_name)
        self._stop = True


def start(service_name: str) -> None:
    ServeController(service_name).run()


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--service-name', required=True)
    args = parser.parse_args()
    # The reference's sky_logging handler, on the standard library: the
    # controller's log file (`serve/core.py` tail_logs) carries each
    # module's INFO lines.
    logging.basicConfig(
        level=logging.INFO,
        format='%(levelname).1s %(asctime)s %(name)s] %(message)s')
    start(args.service_name)
