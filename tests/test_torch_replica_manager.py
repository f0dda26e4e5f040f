"""The port's replica manager and its launch seam, on the CPU.

- Probes against the reference's `_probe_replica` on the same replica:
  a live /health, a refusing port, a 5xx server, a server slower than
  the probe's timeout, an armed `probe.http` and no endpoint give the
  same details; READY replicas open the probe breaker after 2 failures
  and short-circuit (`circuit_open`), STARTING ones bypass it, in both.
- `probe_all` against the reference's: a STARTING replica with a `None`
  `launched_at` is granted the grace window from now, one past it is
  replaced, a READY one replaced after 3 failures; a preempted spot
  replica is PREEMPTED and replaced in another zone by the spot placer.
  The reference's cluster lookup and launches are stubbed; the port's
  go through a fake launcher. A replacement of the highest-numbered
  replica takes its id in the reference, a new one in the port (ROADMAP
  Queue 3).
- `provision.launch` armed from SKYTPU_FAULTS: three attempts, then
  FAILED, in both. Armed from code (FaultInjected, not a SkyTpuError)
  the reference's launch thread dies and leaves the replica
  PROVISIONING; the port's fails it (ROADMAP Queue 3).
- The launch seam (`LocalLauncher`): setup then run under bash with the
  task's envs, in a new session; the replica's endpoint; `down` from a
  second process ends the group (SIGTERM, then SIGKILL for a group that
  ignores it) and removes the directory; a run that exits, or a group
  killed from outside, is lost (head_ip None).
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from skypilot_tpu import task as ref_task
from skypilot_tpu.observability import instruments as ref_obs
from skypilot_tpu.resilience import faults as ref_faults
from skypilot_tpu.serve import replica_managers as ref_rm
from skypilot_tpu.serve import serve_state as ref_state
from skypilot_tpu_torch import exceptions as port_exceptions
from skypilot_tpu_torch import task as port_task
from skypilot_tpu_torch.observability import instruments as port_obs
from skypilot_tpu_torch.resilience import faults as port_faults
from skypilot_tpu_torch.serve import replica_managers as port_rm
from skypilot_tpu_torch.serve import serve_state as port_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {'ref': (ref_task, ref_rm, ref_state, ref_faults, ref_obs),
        'port': (port_task, port_rm, port_state, port_faults, port_obs)}


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def do_GET(self):
        if self.path == '/slow':
            time.sleep(5)
        status = 503 if self.path == '/err' else 200
        self.send_response(status)
        self.send_header('Content-Length', '2')
        self.end_headers()
        self.wfile.write(b'ok')


@pytest.fixture
def http_server():
    srv = ThreadingHTTPServer(('127.0.0.1', 0), _Handler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f'http://127.0.0.1:{srv.server_address[1]}'
    srv.shutdown()
    srv.server_close()


def _closed_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    ref_faults.reset()
    port_faults.reset()


class FakeLauncher:
    """The seam's three methods over a dict: cluster -> head IP."""

    def __init__(self):
        self.ips = {}
        self.calls = []

    def launch(self, task, cluster_name):
        self.calls.append(('launch', cluster_name, task.resources))
        self.ips[cluster_name] = '127.0.0.1'

    def head_ip(self, cluster_name):
        return self.ips.get(cluster_name)

    def down(self, cluster_name):
        self.calls.append(('down', cluster_name))
        if self.ips.pop(cluster_name, None) is None:
            raise port_exceptions.ClusterDoesNotExist(cluster_name)


def _manager(pkg, service, name='rmsvc', port=None, stub_launch=True):
    """A manager of `pkg` over a fresh service row; the reference's
    cluster lookup and launches stubbed, the port's on a FakeLauncher."""
    task_mod, rm, state, _, _ = PKGS[pkg]
    cfg = {'run': 'true', 'service': dict(service)}
    if port is not None:
        cfg['service']['replica_port'] = port
    task = task_mod.Task.from_yaml_config(cfg)
    name = f'{name}-{pkg}'  # one database, a row each
    state.add_service(name, task.to_yaml_config(), 0, 0)
    if pkg == 'port':
        m = rm.ReplicaManager(name, task, task.service,
                              launcher=FakeLauncher())
    else:
        m = rm.ReplicaManager(name, task, task.service)
        m.lost = set()
        m._cluster_lost = lambda r: r['cluster_name'] in m.lost
        m._endpoint_for = lambda c: f'http://127.0.0.1:{m.spec.replica_port}'
    if stub_launch:
        m._launch_replica = lambda *a, **k: None
    return m


def _replica(endpoint, status):
    return {'replica_id': 1, 'endpoint': endpoint, 'status': status}


PROBE_SPEC = {'readiness_probe': {'path': '/health', 'timeout_seconds': 2}}


def test_probe_details_match_reference(http_server):
    closed = f'http://127.0.0.1:{_closed_port()}'
    got = {}
    for pkg in PKGS:
        _, _, state, faults, _ = PKGS[pkg]
        out = []
        for path, endpoint, arm in (
                ('/health', http_server, False), ('/health', closed, False),
                ('/err', http_server, False), ('/slow', http_server, False),
                ('/health', http_server, True), ('/health', None, False)):
            m = _manager(pkg, {'readiness_probe': {
                'path': path, 'timeout_seconds': 2}}, name=f'p{len(out)}')
            if arm:
                faults.arm('probe.http', times=1)
            out.append(tuple(m._probe_replica(_replica(
                endpoint, state.ReplicaStatus.STARTING))))
        got[pkg] = out
    assert got['port'] == got['ref']
    assert [d for _, d in got['port']] == [
        'ok', 'refused', 'http_503', 'timeout', 'injected', 'no_endpoint']


def test_a_fractional_probe_timeout_is_kept(http_server):
    """ROADMAP Queue 3: the reference's spec reads `timeout_seconds:
    0.9` as int 0, a non-blocking socket, so every probe of a live
    replica fails; the port keeps 0.9."""
    got = {}
    for pkg in PKGS:
        state = PKGS[pkg][2]
        m = _manager(pkg, {'readiness_probe': {
            'path': '/health', 'timeout_seconds': 0.9}})
        got[pkg] = (m.spec.readiness_probe.timeout_seconds,
                    m._probe_replica(_replica(
                        http_server, state.ReplicaStatus.READY)).detail)
    assert got == {'ref': (0, 'error:BlockingIOError'), 'port': (0.9, 'ok')}


def _open_count(obs):
    return sum(v for _, labels, v in obs.CIRCUIT_OPEN.samples()
               if dict(labels).get('breaker') == 'probe')


def test_probe_breaker_opens_for_ready_and_is_bypassed_while_starting():
    closed = f'http://127.0.0.1:{_closed_port()}'
    got = {}
    for pkg in PKGS:
        _, _, state, _, obs = PKGS[pkg]
        before = _open_count(obs)
        m = _manager(pkg, PROBE_SPEC)
        starting = [m._probe_replica(_replica(
            closed, state.ReplicaStatus.STARTING)).detail for _ in range(4)]
        ready = [m._probe_replica(_replica(
            closed, state.ReplicaStatus.READY)).detail for _ in range(4)]
        # A STARTING probe still reaches the endpoint with the circuit
        # open.
        again = m._probe_replica(_replica(
            closed, state.ReplicaStatus.STARTING)).detail
        got[pkg] = (starting, ready, again, _open_count(obs) - before)
    assert got['port'] == got['ref']
    assert got['port'] == (['refused'] * 4,
                           ['refused', 'refused', 'circuit_open',
                            'circuit_open'], 'refused', 1)


def _rows(state, name):
    return [(r['replica_id'], r['status'].value, r['version'],
             r['use_spot'], r['zone'], r['pool'],
             r['consecutive_failures'])
            for r in state.get_replicas(name)]


def test_grace_window_and_replacement_match_reference():
    closed = f'http://127.0.0.1:{_closed_port()}'
    spec = {'readiness_probe': {'path': '/health', 'timeout_seconds': 1,
                                'initial_delay_seconds': 60}}
    got = {}
    for pkg in PKGS:
        _, _, state, _, _ = PKGS[pkg]
        m = _manager(pkg, spec)
        calls = []
        real_down = m.scale_down
        m.scale_up = lambda n=1, use_spot=None, pool=None: calls.append(
            ('up', n, pool))
        m.scale_down = lambda ids: (calls.append(('down', list(ids))),
                                    real_down(ids))
        name = m.service_name
        for rid in (1, 2, 3):
            state.add_replica(name, rid, f'c-{rid}', 1)
            if pkg == 'port':
                m.launcher.ips[f'c-{rid}'] = '127.0.0.1'
        # 1: STARTING with no launched_at; 2: STARTING past the window;
        # 3: READY and failing.
        state.set_replica_status(name, 1, state.ReplicaStatus.STARTING,
                                 endpoint=closed)
        state.set_replica_launched_at(name, 1, None)
        state.set_replica_status(name, 2, state.ReplicaStatus.STARTING,
                                 endpoint=closed)
        state.set_replica_launched_at(name, 2, time.time() - 120)
        state.set_replica_status(name, 3, state.ReplicaStatus.READY,
                                 endpoint=closed)
        t0 = time.time()
        trace = []
        for _ in range(3):
            m.probe_all()
            trace.append(_rows(state, name))
        granted = {r['replica_id']: r['launched_at']
                   for r in state.get_replicas(name)}[1]
        assert t0 <= granted <= time.time()
        got[pkg] = (trace, calls)
    assert got['port'] == got['ref']
    trace, calls = got['port']
    assert calls == [('down', [2]), ('up', 1, None), ('down', [3]),
                     ('up', 1, None)]
    assert [r[:2] for r in trace[-1]] == [(1, 'STARTING')]


def test_preempted_spot_replica_is_replaced_in_another_zone(http_server):
    spec = {'readiness_probe': {'path': '/health', 'timeout_seconds': 2},
            'replica_policy': {'min_replicas': 2, 'use_spot': True,
                               'spot_zones': ['za', 'zb', 'zc']}}
    got = {}
    for pkg in PKGS:
        _, _, state, _, _ = PKGS[pkg]
        m = _manager(pkg, spec)
        name = m.service_name
        m.scale_up(2)
        for rid in (1, 2):
            state.set_replica_status(name, rid, state.ReplicaStatus.STARTING,
                                     endpoint=http_server)
            if pkg == 'port':
                m.launcher.ips[f'tsky-serve-{name}-{rid}'] = '127.0.0.1'
        m.probe_all()
        ready = _rows(state, name)
        # Replica 1's cluster (zone za) is lost.
        if pkg == 'port':
            m.launcher.ips.pop(f'tsky-serve-{name}-1')
        else:
            m.lost.add(f'tsky-serve-{name}-1')
        m.probe_all()
        got[pkg] = (ready, _rows(state, name), m.spot_placer.active_zones,
                    m.spot_placer.preemptive_zones)
    assert got['port'] == got['ref']
    ready, after, active, preemptive = got['port']
    assert [(r[1], r[4]) for r in ready] == [('READY', 'za'),
                                            ('READY', 'zb')]
    assert [(r[0], r[1], r[3], r[4]) for r in after] == [
        (2, 'READY', True, 'zb'), (3, 'PROVISIONING', True, 'zc')]
    assert preemptive == ['za'] and 'za' not in active


def test_a_replacement_never_takes_a_torn_down_replicas_id(http_server):
    """ROADMAP Queue 3: the reference numbers a replica MAX(id) + 1 over
    the rows left, so replacing the highest-numbered replica hands the
    replacement the id and cluster name of the one just torn down; the
    port's manager never hands out an id twice."""
    got = {}
    for pkg in PKGS:
        _, _, state, _, _ = PKGS[pkg]
        m = _manager(pkg, PROBE_SPEC)
        name = m.service_name
        m.scale_up(1)
        state.set_replica_status(name, 1, state.ReplicaStatus.STARTING,
                                 endpoint=http_server)
        cluster = f'tsky-serve-{name}-1'
        if pkg == 'port':
            m.launcher.ips[cluster] = '127.0.0.1'
        m.probe_all()
        if pkg == 'port':
            m.launcher.ips.pop(cluster)
        else:
            m.lost.add(cluster)
        m.probe_all()
        got[pkg] = [(r[0], r[1]) for r in _rows(state, name)]
    assert got == {'ref': [(1, 'PROVISIONING')],
                   'port': [(2, 'PROVISIONING')]}


def _wait_status(state, name, rid, statuses, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rows = {r['replica_id']: r for r in state.get_replicas(name)}
        if rid in rows and rows[rid]['status'].value in statuses:
            return rows[rid]
        time.sleep(0.02)
    return {r['replica_id']: r for r in state.get_replicas(name)}.get(rid)


def test_provision_launch_is_retried_then_the_replica_fails(monkeypatch):
    monkeypatch.setenv('SKYTPU_SERVE_LAUNCH_RETRY_GAP', '0.01')
    got = {}
    for times, pkg in ((3, 'ref'), (3, 'port'), (2, 'port')):
        _, _, state, faults, obs = PKGS[pkg]
        monkeypatch.setenv('SKYTPU_FAULTS', f'provision.launch:{times}')
        faults.reset()
        before = obs.FAULTS_INJECTED.value(point='provision.launch')
        m = _manager(pkg, PROBE_SPEC, name=f'launch{times}', port=8123,
                     stub_launch=False)
        if pkg == 'ref':
            # A launch that got past the fault would reach the launch
            # stack; three armed hits keep it away.
            import skypilot_tpu.execution as ref_execution
            monkeypatch.setattr(ref_execution, 'launch',
                                lambda *a, **k: pytest.fail('launched'))
        m.scale_up(1)
        row = _wait_status(state, m.service_name, 1, ('FAILED', 'STARTING'))
        got[(times, pkg)] = (row['status'].value, row['endpoint'],
                             obs.FAULTS_INJECTED.value(
                                 point='provision.launch') - before)
        monkeypatch.delenv('SKYTPU_FAULTS')
        faults.reset()
    assert got[(3, 'port')] == got[(3, 'ref')] == ('FAILED', None, 3)
    assert got[(2, 'port')] == ('STARTING', 'http://127.0.0.1:8123', 2)


def test_a_launch_that_raises_any_error_fails_its_replica(monkeypatch):
    """ROADMAP Queue 3: the reference's launch thread catches only
    SkyTpuError, so a code-armed fault (FaultInjected) kills the thread
    and the replica stays PROVISIONING, never probed nor replaced; the
    port fails it, and so an OSError from the launch seam."""
    states = {}
    for pkg in PKGS:
        _, _, state, faults, _ = PKGS[pkg]
        m = _manager(pkg, PROBE_SPEC, name='raise', stub_launch=False)
        faults.arm('provision.launch', times=None)
        monkeypatch.setattr(threading, 'excepthook', lambda args: None)
        m.scale_up(1)
        states[pkg] = _wait_status(state, m.service_name, 1, ('FAILED',),
                                   timeout=2.0)['status'].value
        faults.reset()
    assert states == {'ref': 'PROVISIONING', 'port': 'FAILED'}
    m = _manager('port', PROBE_SPEC, name='oserror', stub_launch=False)

    def broken(task, cluster_name):
        raise OSError('no bash')

    m.launcher.launch = broken
    m.scale_up(1)
    assert _wait_status(port_state, m.service_name, 1,
                        ('FAILED',))['status'].value == 'FAILED'


# -- the launch seam -------------------------------------------------------------

def _seam_task(run, setup=None, envs=None):
    cfg = {'run': run, 'envs': envs or {},
           'service': {'readiness_probe': '/', 'replica_port': 0}}
    if setup:
        cfg['setup'] = setup
    return port_task.Task.from_yaml_config(cfg)


def _alive(pid):
    try:
        with open(f'/proc/{pid}/stat', 'rb') as f:
            return f.read().rsplit(b')', 1)[1].split()[0] not in (b'Z', b'X')
    except OSError:
        return False


def test_launch_seam_runs_setup_then_run_and_down_from_another_process():
    port = _closed_port()
    launcher = port_rm.LocalLauncher()
    server = (f'{sys.executable} -c "import http.server as h; '
              f'h.ThreadingHTTPServer((\'127.0.0.1\', {port}), '
              f'h.SimpleHTTPRequestHandler).serve_forever()"')
    task = _seam_task(f'cat marker; exec {server}',
                      setup='echo "$GREETING" > marker',
                      envs={'GREETING': 'hello'})
    launcher.launch(task, 'seam-1')
    d = launcher.cluster_dir('seam-1')
    with open(os.path.join(d, 'metadata.json')) as f:
        meta = json.load(f)
    assert meta['runtime_dir'] == d and os.getpgid(meta['pgid']) == \
        meta['pgid']
    assert launcher.head_ip('seam-1') == '127.0.0.1'
    spec = task.service
    spec.replica_port = port
    m = port_rm.ReplicaManager('seamsvc', task, spec, launcher=launcher)
    endpoint = m._endpoint_for('seam-1')
    assert endpoint == f'http://127.0.0.1:{port}'
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        if m._probe_replica(_replica(
                endpoint, port_state.ReplicaStatus.STARTING)).ok:
            break
        time.sleep(0.1)
    else:
        pytest.fail('the run command never served')
    with open(os.path.join(d, 'run.log')) as f:
        assert f.read().startswith('hello')
    # `down` from another process, as `serve down` is.
    out = subprocess.run(
        [sys.executable, '-c', 'from skypilot_tpu_torch.serve import '
         'replica_managers as rm; rm.LocalLauncher().down("seam-1")'],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert launcher.head_ip('seam-1') is None
    assert not os.path.exists(d) and not _alive(meta['pgid'])
    with pytest.raises(port_exceptions.ClusterDoesNotExist):
        launcher.down('seam-1')


def test_launch_seam_down_kills_a_group_that_ignores_sigterm(monkeypatch):
    monkeypatch.setattr(port_rm, '_DOWN_GRACE_SECONDS', 0.5)
    launcher = port_rm.LocalLauncher()
    launcher.launch(_seam_task("trap '' TERM; sleep 300 & wait"), 'stubborn')
    pgid = launcher._meta('stubborn')['pgid']
    time.sleep(0.2)
    t0 = time.monotonic()
    launcher.down('stubborn')
    assert 0.5 <= time.monotonic() - t0 < 10
    assert not port_rm.group_alive(pgid)
    assert launcher.head_ip('stubborn') is None


def test_launch_seam_loses_a_cluster_whose_group_ends():
    launcher = port_rm.LocalLauncher()
    launcher.launch(_seam_task('sleep 0.2'), 'ends')
    launcher.launch(_seam_task('sleep 300 & sleep 300'), 'killed')
    assert launcher.head_ip('killed') == '127.0.0.1'
    pgid = launcher._meta('killed')['pgid']
    os.killpg(pgid, signal.SIGKILL)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and (
            launcher.head_ip('ends') or launcher.head_ip('killed')):
        time.sleep(0.05)
    assert launcher.head_ip('ends') is None
    assert launcher.head_ip('killed') is None
    m = port_rm.ReplicaManager('lostsvc', _seam_task('true'),
                               _seam_task('true').service,
                               launcher=launcher)
    assert m._cluster_lost({'cluster_name': 'killed'})
    with pytest.raises(port_exceptions.ClusterSetUpError):
        launcher.launch(_seam_task('true', setup='exit 3'), 'bad-setup')
    for name in ('ends', 'killed', 'bad-setup'):
        launcher.down(name)
