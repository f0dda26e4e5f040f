"""The port's serve controller, serve state, spot placer and task subset
against the reference's, on the CPU.

- Controller: the port's `ServeController` and the reference's, each
  built by its own `__init__` over its own package's serve state (one
  database, a service name each), driven tick for tick by the same
  script under fake managers, LBs, signal sources and one fake clock:
  every tick's `scale_up` / `scale_down` calls, the LB's replica list and
  pool roles, the replica rows, the service status and the gauges
  (SERVE_REPLICAS, AUTOSCALER_*, POOL_*) are equal. The scenarios are
  those of the reference's `tests/unit/test_serve_controller_ticks.py`
  and `test_serve_pools.py` (steady state, update pacing, the surge
  kept from the autoscaler, a stalled update, not-ready victims first,
  a spike in a stalled update, mixed spot pools, per-pool scaling and
  its release, per-pool rolling updates and respawn), plus a spec
  reload through the stored task. An update's old replica leaves the
  port's LB, the READY surge replica in it, before it is torn down; the
  reference tears it down while its LB still routes to it alone
  (ROADMAP Queue 3).
- Serve state: a database written by one package reads the same in the
  other, an old (pre-spot, pre-pool) database is migrated alike; reads
  beside writes from other threads never fail, and a `down` landing in
  a controller tick is not overwritten (ROADMAP Queue 3).
- Spot placer: seeded sequences of select / handle_preemption /
  handle_active give the same zones and zone sets.
- Task: every service task of `examples/` and `llm/` (read with PyYAML
  here only) gives the same name, run, setup, envs, num_nodes and
  `service.to_yaml_config()` (without the poolless delays the reference
  drops, ROADMAP Queue 3), the same round trip, and the same errors.
Each test runs in its own SKYTPU_STATE_DIR (tests/conftest.py).
"""
import copy
import glob
import os
import sqlite3
import subprocess
import sys

import numpy as np
import pytest
import yaml

from skypilot_tpu import task as ref_task
from skypilot_tpu.observability import instruments as ref_obs
from skypilot_tpu.serve import autoscalers as ref_autoscalers
from skypilot_tpu.serve import controller as ref_controller
from skypilot_tpu.serve import serve_state as ref_state
from skypilot_tpu.serve import spot_placer as ref_placer
from skypilot_tpu_torch import task as port_task
from skypilot_tpu_torch.observability import instruments as port_obs
from skypilot_tpu_torch.serve import autoscalers as port_autoscalers
from skypilot_tpu_torch.serve import controller as port_controller
from skypilot_tpu_torch.serve import serve_state as port_state
from skypilot_tpu_torch.serve import spot_placer as port_placer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    'ref': (ref_controller, ref_state, ref_autoscalers, ref_obs),
    'port': (port_controller, port_state, port_autoscalers, port_obs),
}


# -- the controller, tick for tick ---------------------------------------------

class FakeManager:
    """Replica bookkeeping straight into serve state (the reference's
    tests' fake): probes are the script's job; use_spot=None means the
    spec's default, as the real manager's; every call is logged."""

    def __init__(self, state, service_name, spec_use_spot):
        self.state = state
        self.service_name = service_name
        self.version = 1
        self.spec_use_spot = spec_use_spot
        self.calls = []

    def probe_all(self):
        pass

    def scale_up(self, n=1, use_spot=None, pool=None):
        self.calls.append(('scale_up', n, use_spot, pool))
        if use_spot is None:
            use_spot = self.spec_use_spot
        for _ in range(n):
            rid = self.state.next_replica_id(self.service_name)
            self.state.add_replica(self.service_name, rid, f'c-{rid}',
                                   self.version, use_spot=use_spot,
                                   pool=pool)

    def scale_down(self, replica_ids):
        self.calls.append(('scale_down', list(replica_ids)))
        for rid in replica_ids:
            self.state.set_replica_status(
                self.service_name, rid,
                self.state.ReplicaStatus.SHUTTING_DOWN)

    def ready_endpoints(self):
        return [r['endpoint'] for r in
                self.state.get_replicas(self.service_name)
                if r['status'] == self.state.ReplicaStatus.READY]

    def terminate_all(self):
        self.calls.append(('terminate_all',))


class FakeTracker:
    def __init__(self):
        self.qps_value = 0.0

    def qps(self):
        return self.qps_value


class FakeLB:
    def __init__(self):
        self.tracker = FakeTracker()
        self.replicas = []
        self.pools = None

    def set_replicas(self, endpoints, pools=None):
        self.replicas = list(endpoints)
        self.pools = dict(pools) if pools is not None else None

    def start(self):
        return 0

    def stop(self):
        pass


class FakeSignals:
    """Scripted signals for `read` and `read_pools`, in each package's
    LoadSignals."""

    def __init__(self, autoscalers):
        self.autoscalers = autoscalers
        self.fleet = {}
        self.by_pool = {}

    def read(self):
        return self.autoscalers.LoadSignals(**self.fleet)

    def read_pools(self, pools):
        return {p: self.autoscalers.LoadSignals(**self.by_pool.get(p, {}))
                for p in pools}


class World:
    """One package's controller over its own service row."""

    def __init__(self, pkg, service, clock):
        controller, state, autoscalers, obs = PKGS[pkg]
        self.state, self.obs = state, obs
        self.name = f'ticksvc-{pkg}'
        state.add_service(self.name, {'run': 'true', 'service': service},
                          lb_port=0, controller_port=0)
        self.manager = FakeManager(state, self.name, bool(
            service.get('replica_policy', {}).get('use_spot')))
        self.lb = FakeLB()
        self.signals = FakeSignals(autoscalers)
        self.ctl = controller.ServeController(
            self.name, manager=self.manager, lb=self.lb, now_fn=clock,
            sleep_fn=lambda dt: None, signal_source=self.signals)
        self.pools = sorted(service.get('pools') or {})

    def ready(self, *rids):
        for rid in rids:
            self.state.set_replica_status(self.name, rid,
                                          self.state.ReplicaStatus.READY,
                                          endpoint=f'http://r{rid}')

    def fail(self, rid):
        self.state.set_replica_status(self.name, rid,
                                      self.state.ReplicaStatus.FAILED)

    def bump(self, service=None):
        row = self.state.get_service(self.name)
        task_yaml = copy.deepcopy(row['task_yaml'])
        if service is not None:
            task_yaml['service'] = service
        self.state.set_service_version(self.name, row['version'] + 1,
                                       task_yaml)
        self.manager.version = row['version'] + 1

    def ready_provisioning(self, version):
        for r in self.state.get_replicas(self.name):
            if r['version'] == version and \
                    r['status'] == self.state.ReplicaStatus.PROVISIONING:
                self.ready(r['replica_id'])

    def snapshot(self):
        calls, self.manager.calls = self.manager.calls, []
        service = self.state.get_service(self.name)
        gauge = self.obs.SERVE_REPLICAS
        return {
            'calls': calls,
            'lb': (sorted(self.lb.replicas), self.lb.pools),
            'status': service['status'].value if service else None,
            'rows': [(r['replica_id'], r['status'].value, r['version'],
                      r['use_spot'], r['pool'])
                     for r in self.state.get_replicas(self.name)],
            'serve_replicas': {
                s.value: gauge.value(service=self.name, state=s.value)
                for s in self.state.ReplicaStatus},
            'target': self.obs.AUTOSCALER_TARGET_REPLICAS.value(
                service=self.name),
            'actual': self.obs.AUTOSCALER_ACTUAL_REPLICAS.value(
                service=self.name),
            'pools': {p: (self.obs.POOL_TARGET_REPLICAS.value(
                service=self.name, pool=p),
                self.obs.POOL_READY_REPLICAS.value(service=self.name,
                                                   pool=p))
                for p in self.pools},
        }

    def live(self):
        dead = ('SHUTTING_DOWN', 'FAILED')
        return sorted(rid for rid, status, *_ in self.snapshot()['rows']
                      if status not in dead)


def _policy_spec(min_replicas=3, **policy):
    return {'readiness_probe': '/',
            'replica_policy': {
                'min_replicas': min_replicas, 'max_replicas': 10,
                'target_qps_per_replica': 10,
                'upscale_delay_seconds': 0, 'downscale_delay_seconds': 0,
                **policy}}


POOLED = {
    'readiness_probe': '/health',
    'load_balancing_policy': 'prefix_affinity',
    'pools': {
        'prefill': {'role': 'prefill', 'min_replicas': 2,
                    'max_replicas': 4, 'target_queue_per_replica': 4.0,
                    'ttft_p95_upscale_threshold': 2.0,
                    'upscale_delay_seconds': 0,
                    'downscale_delay_seconds': 0},
        'decode': {'role': 'decode', 'min_replicas': 3,
                   'max_replicas': 6, 'target_queue_per_replica': 4.0,
                   'kv_util_upscale_threshold': 0.85,
                   'decode_step_p95_upscale_threshold': 0.3,
                   'upscale_delay_seconds': 0,
                   'downscale_delay_seconds': 0},
    },
}


# Each scenario: (service spec, script). A script is a list of ops, each
# applied to both worlds; 'step' runs one controller tick.
def _steady():
    return _policy_spec(), (
        [('up', 3), ('ready', 1, 2, 3)] + [('step',)] * 3)


def _update_pacing():
    return _policy_spec(), (
        [('up', 3), ('ready', 1, 2, 3), ('step',), ('bump',), ('step',),
         ('ready', 4), ('step',)] + [('step',)] * 3 +
        [('ready', 5), ('step',)] +
        [('step',), ('ready_v', 2)] * 2 + [('step',)] * 2)


def _surge_survives():
    return _policy_spec(), (
        [('up', 3), ('ready', 1, 2, 3), ('bump',)] + [('step',)] * 4)


def _stalled_update():
    return _policy_spec(), (
        [('up', 3), ('ready', 1, 2, 3), ('qps', 80.0), ('step',),
         ('ready', 4, 5, 6, 7, 8), ('bump',), ('step',), ('qps', 0.0)] +
        [('step',)] * 8)


def _not_ready_victims():
    return _policy_spec(), (
        [('up', 3), ('ready', 1, 3), ('bump',), ('step',), ('ready', 4),
         ('step',)] + [('step',)] * 2)


def _spike_in_stalled_update():
    return _policy_spec(), (
        [('up', 3), ('ready', 1, 2, 3), ('bump',), ('step',),
         ('qps', 80.0), ('step',), ('qps', 0.0)] + [('step',)] * 10)


def _mixed_spot():
    spec = _policy_spec(use_spot=True, base_ondemand_fallback_replicas=1,
                        dynamic_ondemand_fallback=True)
    return spec, (
        [('up', 3, {'use_spot': True}), ('up', 1, {'use_spot': False}),
         ('ready', 1, 2, 3, 4), ('step',), ('bump',)] + [('step',)] * 4 +
        [('fail', 2), ('qps', 45.0)] + [('step',)] * 3 +
        [('ready_v', 2), ('qps', 0.0)] + [('step',)] * 3)


def _pools_steady():
    return POOLED, (
        [('up', 2, {'pool': 'prefill'}), ('up', 3, {'pool': 'decode'}),
         ('ready', 1, 2, 3, 4, 5)] + [('step',)] * 3)


def _pools_scale_and_release():
    return POOLED, (
        [('up', 2, {'pool': 'prefill'}), ('up', 3, {'pool': 'decode'}),
         ('ready', 1, 2, 3, 4, 5),
         ('pool_signals', 'decode', {'queue_depth': 20.0}), ('step',),
         ('pool_signals', 'prefill', {'ttft_p95': 3.0}), ('step',),
         ('pool_signals', 'decode', {}), ('pool_signals', 'prefill', {}),
         ('step',), ('step',)])


def _pools_rolling_update():
    return POOLED, (
        [('up', 2, {'pool': 'prefill'}), ('up', 3, {'pool': 'decode'}),
         ('ready', 1, 2, 3, 4, 5), ('step',), ('bump',), ('step',),
         ('ready_v', 2), ('step',), ('step',), ('ready_v', 2)] +
        [('step',)] * 4)


def _pools_respawn():
    return POOLED, (
        [('up', 2, {'pool': 'prefill'}), ('up', 3, {'pool': 'decode'}),
         ('ready', 1, 2, 3, 4, 5), ('step',), ('fail', 1), ('step',),
         ('fail', 4), ('step',), ('step',)])


def _spec_reload():
    grown = _policy_spec(min_replicas=4)
    return _policy_spec(), (
        [('up', 3), ('ready', 1, 2, 3), ('step',), ('bump', grown)] +
        [('step',), ('ready_v', 2)] * 6 + [('step',)] * 2)


SCENARIOS = {
    'steady_state': _steady, 'update_pacing': _update_pacing,
    'surge_survives_autoscaler': _surge_survives,
    'stalled_update': _stalled_update,
    'not_ready_victims_first': _not_ready_victims,
    'spike_in_stalled_update': _spike_in_stalled_update,
    'mixed_spot_pools': _mixed_spot, 'pools_steady': _pools_steady,
    'pools_scale_and_release': _pools_scale_and_release,
    'pools_rolling_update': _pools_rolling_update,
    'pools_respawn': _pools_respawn, 'spec_reload': _spec_reload,
}


def _apply(world, op):
    kind, *args = op
    if kind == 'up':
        world.manager.scale_up(args[0], **(args[1] if len(args) > 1
                                           else {}))
    elif kind == 'ready':
        world.ready(*args)
    elif kind == 'ready_v':
        world.ready_provisioning(args[0])
    elif kind == 'fail':
        world.fail(args[0])
    elif kind == 'bump':
        world.bump(*args)
    elif kind == 'qps':
        world.lb.tracker.qps_value = args[0]
    elif kind == 'pool_signals':
        world.signals.by_pool[args[0]] = args[1]
    elif kind == 'step':
        world.ctl._step()
    else:
        raise ValueError(kind)


def _run_scenario(name):
    service, script = SCENARIOS[name]()
    clock = [1000.0]
    worlds = {pkg: World(pkg, copy.deepcopy(service), lambda: clock[0])
              for pkg in PKGS}
    trace = []
    for i, op in enumerate(script):
        snaps = {}
        for pkg, world in worlds.items():
            _apply(world, op)
            snaps[pkg] = world.snapshot()
        assert snaps['port'] == snaps['ref'], (name, i, op)
        trace.append((op, snaps['port']))
        if op[0] == 'step':
            clock[0] += 10.0
    return worlds['port'], trace


@pytest.mark.parametrize('name', sorted(SCENARIOS))
def test_controller_ticks_match_reference(name):
    world, trace = _run_scenario(name)
    steps = [snap for op, snap in trace if op[0] == 'step']
    assert steps and all(s['status'] for s in steps)
    # The reference tests' own claims, on the port's run.
    live = world.live()
    if name == 'steady_state':
        assert live == [1, 2, 3] and not any(s['calls'] for s in steps)
    elif name == 'update_pacing':
        rows = {r[0]: r for r in steps[-1]['rows']}
        assert all(rows[rid][2] == 2 for rid in live)
        assert sum(rows[rid][1] == 'READY' for rid in live) == 3
    elif name == 'surge_survives_autoscaler':
        assert all(4 in [r[0] for r in s['rows'] if r[1] not in (
            'SHUTTING_DOWN', 'FAILED')] for s in steps)
    elif name == 'stalled_update':
        assert len(live) == 3 + 1
    elif name == 'spike_in_stalled_update':
        assert len(live) <= 2 * 3 + 1
    elif name == 'pools_scale_and_release':
        assert ('scale_up', 2, None, 'decode') in steps[0]['calls']
        assert steps[0]['pools']['decode'] == (5, 3)
    elif name == 'pools_respawn':
        pools = {}
        for rid, status, _v, _spot, pool in steps[-1]['rows']:
            if status not in ('SHUTTING_DOWN', 'FAILED'):
                pools[pool] = pools.get(pool, 0) + 1
        assert pools == {'prefill': 2, 'decode': 3}
    elif name == 'spec_reload':
        # The reloaded spec's floor (4), all of it on the new version.
        rows = {r[0]: r for r in steps[-1]['rows']}
        assert len(live) == 4 and all(rows[rid][2] == 2 for rid in live)


def test_an_update_tears_down_a_replica_the_lb_no_longer_routes_to():
    """ROADMAP Queue 3: the reference syncs the LB only after the
    rolling update, so when the surge replica turns READY the old one is
    torn down while it is still the LB's only target. The port's LB
    routes to the surge replica, and no longer to the old one, when the
    old one goes."""
    clock = [0.0]
    seen = {}
    for pkg in PKGS:
        world = World(pkg, _policy_spec(min_replicas=1), lambda: clock[0])
        down = world.manager.scale_down
        world.manager.scale_down = lambda ids, w=world, d=down, p=pkg: (
            seen.setdefault(p, []).append((list(ids),
                                           sorted(w.lb.replicas))), d(ids))
        for op in [('up', 1), ('ready', 1), ('step',), ('bump',), ('step',),
                   ('ready', 2), ('step',)]:
            _apply(world, op)
    assert seen['ref'] == [([1], ['http://r1'])]
    assert seen['port'] == [([1], ['http://r2'])]


# -- serve state across packages -------------------------------------------------

def _write(state, name):
    state.add_service(name, {'name': 'x', 'run': 'true',
                             'service': {'readiness_probe': '/'}},
                      lb_port=1234, controller_port=0)
    state.set_service_controller(name, 4321)
    state.set_service_status(name, state.ServiceStatus.READY)
    state.set_service_version(name, 2, {'run': 'v2'})
    state.add_replica(name, 1, 'c-1', 1)
    state.add_replica(name, 2, 'c-2', 2, use_spot=True, zone='us-b',
                      pool='decode')
    state.set_replica_status(name, 2, state.ReplicaStatus.READY,
                             endpoint='http://127.0.0.1:1')
    state.set_replica_launched_at(name, 1, 123.5)
    state.bump_replica_failures(name, 1)
    state.bump_replica_failures(name, 1)
    state.add_replica(name, 3, 'c-3', 2)
    state.remove_replica(name, 3)


def _read(state, name):
    service = state.get_service(name)
    return ({**service, 'status': service['status'].value},
            [{**r, 'status': r['status'].value}
             for r in state.get_replicas(name)],
            state.next_replica_id(name),
            [s['name'] for s in state.get_services()])


@pytest.mark.parametrize('writer', ['ref', 'port'])
def test_a_database_written_by_one_package_reads_the_same_in_the_other(
        writer):
    reader = 'port' if writer == 'ref' else 'ref'
    wstate, rstate = PKGS[writer][1], PKGS[reader][1]
    assert wstate.serve_db_path() == rstate.serve_db_path()
    _write(wstate, 'dbsvc')
    got, want = _read(rstate, 'dbsvc'), _read(wstate, 'dbsvc')
    assert got == want
    assert got[1][0]['consecutive_failures'] == 2
    assert got[1][0]['launched_at'] == 123.5
    assert (got[1][1]['use_spot'], got[1][1]['zone'],
            got[1][1]['pool']) == (True, 'us-b', 'decode')
    rstate.remove_service('dbsvc')
    assert wstate.get_service('dbsvc') is None
    assert wstate.get_replicas('dbsvc') == []


def test_a_down_during_a_tick_is_not_overwritten():
    """ROADMAP Queue 3: `serve down` marks the service SHUTTING_DOWN; a
    controller tick that read the service before the mark writes its
    health over it at its end, in the reference, and the controller
    never shuts down (`down` waits out its 120 s). The port keeps the
    mark, and the next tick shuts the service down."""
    clock = [0.0]
    got = {}
    for pkg in PKGS:
        world = World(pkg, _policy_spec(min_replicas=1), lambda: clock[0])
        world.manager.scale_up(1)
        world.ready(1)
        world.ctl._step()
        state = world.state
        world.manager.probe_all = lambda w=world: w.state.set_service_status(
            w.name, w.state.ServiceStatus.SHUTTING_DOWN)
        world.ctl._step()   # `down` lands inside this tick
        status = state.get_service(world.name)['status'].value
        world.ctl._step()
        got[pkg] = (status, state.get_service(world.name),
                    world.ctl._stop)
    assert got['ref'] == ('READY', got['ref'][1], False)
    assert got['port'] == ('SHUTTING_DOWN', None, True)


def test_serve_state_reads_beside_writes_from_other_threads():
    """ROADMAP Queue 3: the reference reads its shared connection
    without the lock its writers hold, and a read racing a write from
    another thread (the controller's launch threads beside its loop)
    raises sqlite3.InterfaceError or reads a torn row; the port's reads
    take the lock."""
    import threading
    port_state.add_service('race', {'run': 'true'}, 0, 0)
    for rid in range(1, 6):
        port_state.add_replica('race', rid, f'c-{rid}', 1)
    errors = []

    def run(fn):
        try:
            for k in range(2000):
                fn(k)
        except Exception as e:  # noqa: BLE001 — the pin
            errors.append(repr(e))

    statuses = (port_state.ReplicaStatus.READY,
                port_state.ReplicaStatus.STARTING)
    threads = [threading.Thread(target=run, args=(lambda k: (
        port_state.get_replicas('race'), port_state.get_service('race')),))
        for _ in range(3)]
    threads.append(threading.Thread(target=run, args=(
        lambda k: port_state.set_replica_status(
            'race', 1 + k % 5, statuses[k % 2]),)))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []


def test_an_old_database_migrates_alike():
    """A replicas table from before the spot and pool columns gains them
    in either package, the same columns in the same order."""
    def old_db(path):
        conn = sqlite3.connect(path)
        conn.execute('CREATE TABLE replicas (service_name TEXT, replica_id '
                     'INTEGER, cluster_name TEXT, status TEXT, version '
                     'INTEGER, endpoint TEXT, launched_at REAL, '
                     'consecutive_failures INTEGER DEFAULT 0, PRIMARY KEY '
                     '(service_name, replica_id))')
        conn.execute("INSERT INTO replicas VALUES ('s', 1, 'c-1', "
                     "'READY', 1, 'http://e', 1.0, 0)")
        conn.commit()
        conn.close()

    columns = {}
    for pkg in ('ref', 'port'):
        state = PKGS[pkg][1]
        state.reset_for_tests()
        os.environ['SKYTPU_STATE_DIR'] = os.path.join(
            os.environ['SKYTPU_STATE_DIR'], pkg)
        os.makedirs(os.environ['SKYTPU_STATE_DIR'])
        old_db(state.serve_db_path())
        rows = state.get_replicas('s')
        columns[pkg] = ([r[1] for r in sqlite3.connect(
            state.serve_db_path()).execute('PRAGMA table_info(replicas)')],
            [{**r, 'status': r['status'].value} for r in rows])
        state.reset_for_tests()
        os.environ['SKYTPU_STATE_DIR'] = os.path.dirname(
            os.environ['SKYTPU_STATE_DIR'])
    assert columns['port'] == columns['ref']
    assert columns['port'][0][-3:] == ['use_spot', 'zone', 'pool']
    assert columns['port'][1][0]['use_spot'] is False


# -- the spot placer ---------------------------------------------------------------

@pytest.mark.parametrize('seed', [0, 1, 2])
def test_spot_placer_matches_reference_on_seeded_sequences(seed):
    rng = np.random.default_rng(seed)
    zones = ['us-a', 'us-b', 'us-c', 'us-d'][:2 + seed]
    placers = {'ref': ref_placer.SpotPlacer(zones),
               'port': port_placer.SpotPlacer(zones)}
    counts = {}
    for _ in range(200):
        op = rng.integers(3)
        zone = [None, 'eu-x', *zones][rng.integers(len(zones) + 2)]
        out = {}
        for pkg, placer in placers.items():
            if op == 0:
                out[pkg] = placer.select(dict(counts))
            elif op == 1:
                out[pkg] = placer.handle_preemption(zone)
            else:
                out[pkg] = placer.handle_active(zone)
            out[pkg] = (out[pkg], placer.active_zones,
                        placer.preemptive_zones)
        assert out['port'] == out['ref']
        if op == 0:
            counts[out['port'][0]] = counts.get(out['port'][0], 0) + 1
    with pytest.raises(ValueError):
        port_placer.SpotPlacer([])


# -- the task subset ----------------------------------------------------------------

def _service_tasks():
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, 'examples', '*.yaml')) +
                       glob.glob(os.path.join(REPO, 'llm', '*.yaml'))):
        with open(path) as f:
            for doc in yaml.safe_load_all(f):
                if isinstance(doc, dict) and 'service' in doc:
                    out.append((os.path.relpath(path, REPO), doc))
    return out


SERVICE_TASKS = _service_tasks()


def _without_delays(cfg):
    """A poolless spec's to_yaml_config without the delays the port
    writes and the reference drops (ROADMAP Queue 3)."""
    cfg = copy.deepcopy(cfg)
    for key in ('upscale_delay_seconds', 'downscale_delay_seconds'):
        cfg.get('replica_policy', {}).pop(key, None)
    return cfg


def _task_fields(task):
    return (task.name, task.run, task.setup, task.envs, task.num_nodes,
            _without_delays(task.service.to_yaml_config()))


def test_every_service_task_is_found():
    assert len(SERVICE_TASKS) == 20
    assert {'examples/serve_llama.yaml', 'examples/spot_serve.yaml',
            'llm/serve.yaml'} <= {p for p, _ in SERVICE_TASKS}


@pytest.mark.parametrize('path,doc', SERVICE_TASKS,
                         ids=[p for p, _ in SERVICE_TASKS])
def test_task_subset_matches_reference(path, doc):
    ref = ref_task.Task.from_yaml_config(copy.deepcopy(doc))
    port = port_task.Task.from_yaml_config(copy.deepcopy(doc))
    assert _task_fields(port) == _task_fields(ref)
    again = port_task.Task.from_yaml_config(port.to_yaml_config())
    assert _task_fields(again) == _task_fields(port)
    assert again.to_yaml_config() == port.to_yaml_config()
    assert port.to_yaml_config()['resources'] == doc['resources']
    assert port.to_yaml_config().get('file_mounts') == \
        doc.get('file_mounts')


BAD_TASKS = {
    'name': {'name': 'bad name!', 'run': 'true'},
    'num_nodes': {'run': 'true', 'num_nodes': 0},
    'env_name': {'run': 'true', 'envs': {'1BAD': 'x'}},
    'env_none': {'run': 'true', 'envs': {'TOKEN': None}},
    'unknown_key': {'run': 'true', 'nme': 'x'},
    'workdir': {'run': 'true', 'workdir': '/nonexistent/dir'},
    'not_a_mapping': ['run'],
    'bad_service': {'run': 'true', 'service': {'replicas': 1}},
}


@pytest.mark.parametrize('name', sorted(BAD_TASKS))
def test_invalid_task_raises_as_reference(name):
    got = {}
    for pkg, mod in (('ref', ref_task), ('port', port_task)):
        with pytest.raises(Exception) as info:
            mod.Task.from_yaml_config(copy.deepcopy(BAD_TASKS[name]))
        got[pkg] = (type(info.value).__name__, str(info.value))
    assert got['port'] == got['ref']


def test_controller_process_imports_no_torch():
    """The controller never takes a CUDA context: its module, with the
    load balancer, the replica manager and the task, imports no torch."""
    probe = ('import sys; import skypilot_tpu_torch.serve.controller, '
             'skypilot_tpu_torch.serve.core, skypilot_tpu_torch.fleetsim; '
             'print(sorted(m for m in ("torch", "numpy", "jax") '
             'if m in sys.modules))')
    out = subprocess.run([sys.executable, '-c', probe], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'
