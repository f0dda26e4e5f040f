"""Replica manager: replica cluster lifecycle + readiness probes.

The port of `skypilot_tpu/serve/replica_managers.py`: `ProbeResult`,
`replica_cluster_name` and `ReplicaManager` (:66-346) with `scale_up`
(launches in background threads, the spot placer's zone for spot
replicas, no id handed out twice), `_launch_replica` (under
`retries.call` and the `provision.launch` fault: three attempts on
ResourcesUnavailableError / ClusterSetUpError; then, or on any other
error, FAILED), `_replica_task` (the pool's resource overrides and the
spot / zone choice merged into each resource option), `_endpoint_for`,
`scale_down`, `terminate_all`, `_probe_replica` (details `ok`,
`no_endpoint`, `refused`, `timeout`, `http_NNN`, `circuit_open`,
`injected`, `error:<type>`; STARTING replicas bypass the breaker),
`_cluster_lost`, `probe_all` (the grace window, with a `None`
`launched_at` granted the window from now; replacement after 3
consecutive failures; a lost cluster PREEMPTED and replaced through the
spot placer) and `ready_endpoints`.

Where the reference reaches the launch stack, the port goes through one
seam object, `launcher`, with three methods:
- `launch(task, cluster_name)` for `execution.launch(task,
  cluster_name=..., stream_logs=False, detach_run=True)` (:109-119);
- `head_ip(cluster_name)` for `state.get_cluster_from_name(...)
  .handle.head_ip()` (:167-175, :258-261), None once the cluster is
  gone;
- `down(cluster_name)` for `core.down(cluster, purge=True)` (:177-194),
  raising ClusterDoesNotExist for a cluster it never had; it returns
  once the cluster's processes are gone (SIGTERM, a grace period, then
  SIGKILL, as a VM's shutdown; the reference's local cloud SIGKILLs).
Its one implementation, `LocalLauncher`, runs a replica the way the
reference's local cloud runs a one-node task on this host
(`skypilot_tpu/provision/local/__init__.py`): the task's `setup`, then
its `run`, under bash with the task's envs, in a new session, in the
cluster's runtime directory under `paths.local_clusters_dir()` (its
`workdir` when it has one). The session's process group and the
cluster's state live in that directory, so another process (`serve
down`, a test) finds and ends them. The port's launch stack (ROADMAP
Queue 1 item 3) replaces `LocalLauncher` behind the same three methods.
"""
import json
import logging
import os
import shutil
import signal
import subprocess
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, NamedTuple, Optional

from skypilot_tpu_torch import envs
from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.resilience import circuit
from skypilot_tpu_torch.resilience import faults
from skypilot_tpu_torch.resilience import retries
from skypilot_tpu_torch.serve import serve_state
from skypilot_tpu_torch.serve import service_spec as spec_lib
from skypilot_tpu_torch.utils import paths

logger = logging.getLogger(__name__)

_MAX_CONSECUTIVE_FAILURES = 3
# Seconds `LocalLauncher.down` gives a group after SIGTERM (a VM's
# shutdown grace), then after SIGKILL, to leave.
_DOWN_GRACE_SECONDS = 30.0
_DOWN_WAIT_SECONDS = 30.0


class ProbeResult(NamedTuple):
    """One probe outcome, with the failure mode preserved — refused
    (app not listening yet) vs timeout (wedged) vs HTTP 5xx (up but
    erroring) drive different operator diagnoses, so they must not
    collapse into one boolean at the source."""
    ok: bool
    detail: str


def replica_cluster_name(service_name: str, replica_id: int) -> str:
    return f'tsky-serve-{service_name}-{replica_id}'


# -- the launch seam ----------------------------------------------------------

def _runs_in(pid: int, pgid: int) -> bool:
    """Whether process `pid` runs in group `pgid`: a zombie, dead but
    not yet reaped by its parent, does not count."""
    try:
        with open(f'/proc/{pid}/stat', 'rb') as f:
            stat = f.read()
    except OSError:
        return False
    # pid (comm) state ppid pgrp ...; comm may hold spaces.
    fields = stat[stat.rfind(b')') + 2:].split()
    return len(fields) > 2 and int(fields[2]) == pgid and \
        fields[0] not in (b'Z', b'X')


def _group_members(pgid: int) -> List[int]:
    """The processes of group `pgid` that still run, from one read of
    /proc. A group with no process at all fails signal 0 and needs no
    read."""
    try:
        os.killpg(pgid, 0)
    except ProcessLookupError:
        return []
    except PermissionError:
        pass
    return [int(name) for name in os.listdir('/proc')
            if name.isdigit() and _runs_in(int(name), pgid)]


def group_alive(pgid: int) -> bool:
    """Whether any process of group `pgid` still runs."""
    return bool(_group_members(pgid))


def wait_group(pgid: int, timeout: float, poll: float,
               until: Optional[Callable[[], bool]] = None) -> bool:
    """Wait up to `timeout` s, polling every `poll` s, for group `pgid`
    to end, or for `until()` to hold; whether the group ended. /proc is
    read whole once; then only the members found are polled, and it is
    read whole again only once they are gone (one may have forked)."""
    deadline = time.monotonic() + timeout
    members = _group_members(pgid)
    while members:
        if time.monotonic() >= deadline or (until is not None and until()):
            return False
        time.sleep(poll)
        members = [pid for pid in members if _runs_in(pid, pgid)] or \
            _group_members(pgid)
    return True


class LocalLauncher:
    """Replica clusters as process groups on this host, one runtime
    directory each (`metadata.json` with the group, `setup.log`,
    `run.log`)."""

    @staticmethod
    def cluster_dir(cluster_name: str) -> str:
        return os.path.join(paths.local_clusters_dir(), cluster_name)

    def _meta(self, cluster_name: str) -> Optional[Dict]:
        try:
            with open(os.path.join(self.cluster_dir(cluster_name),
                                   'metadata.json'), encoding='utf-8') as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def launch(self, task, cluster_name: str) -> None:
        """Run the task's setup to its end, then start its run in a new
        session and return (the reference's `detach_run=True`). A setup
        that exits non-zero raises ClusterSetUpError."""
        d = self.cluster_dir(cluster_name)
        os.makedirs(d, exist_ok=True)
        cwd = (os.path.abspath(os.path.expanduser(task.workdir))
               if task.workdir else d)
        env = dict(os.environ, **task.envs_and_secrets)
        if task.setup:
            with open(os.path.join(d, 'setup.log'), 'ab') as log:
                rc = subprocess.run(['bash', '-c', task.setup], cwd=cwd,
                                    env=env, stdout=log,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True).returncode
            if rc != 0:
                raise exceptions.ClusterSetUpError(
                    f'setup of {cluster_name} exited {rc} '
                    f'(see {d}/setup.log)')
        pid = None
        if isinstance(task.run, str) and task.run:
            with open(os.path.join(d, 'run.log'), 'ab') as log:
                proc = subprocess.Popen(['bash', '-c', task.run], cwd=cwd,
                                        env=env, stdout=log,
                                        stderr=subprocess.STDOUT,
                                        start_new_session=True)
            # Reaped as soon as it ends, so a dead group never lingers
            # as this process's zombie.
            threading.Thread(target=proc.wait, daemon=True,
                             name=f'skytpu-reap-{cluster_name}').start()
            pid = proc.pid
        meta = {'state': 'running', 'pgid': pid, 'runtime_dir': d,
                'launched_at': time.time()}
        tmp = os.path.join(d, 'metadata.json.tmp')
        try:
            with open(tmp, 'w', encoding='utf-8') as f:
                json.dump(meta, f)
            os.replace(tmp, os.path.join(d, 'metadata.json'))
        except OSError:
            # Taken down while it launched: nothing may outlive it.
            if pid is not None:
                os.killpg(pid, signal.SIGKILL)
            raise

    def head_ip(self, cluster_name: str) -> Optional[str]:
        """127.0.0.1 while the cluster's process group lives, else
        None (a cluster with no run command lives while its directory
        does)."""
        meta = self._meta(cluster_name)
        if meta is None:
            return None
        pgid = meta.get('pgid')
        if pgid is not None and not group_alive(pgid):
            return None
        return '127.0.0.1'

    def down(self, cluster_name: str) -> None:
        """End the cluster's process group as a VM's shutdown does:
        SIGTERM, a grace period to leave (the port's server drains its
        in-flight requests on it), then SIGKILL; then remove its
        runtime directory."""
        d = self.cluster_dir(cluster_name)
        if not os.path.isdir(d):
            raise exceptions.ClusterDoesNotExist(cluster_name)
        pgid = (self._meta(cluster_name) or {}).get('pgid')
        if pgid is not None:
            for sig, wait_s in ((signal.SIGTERM, _DOWN_GRACE_SECONDS),
                                (signal.SIGKILL, _DOWN_WAIT_SECONDS)):
                try:
                    os.killpg(pgid, sig)
                except ProcessLookupError:
                    break
                if wait_group(pgid, wait_s, 0.05):
                    break
        shutil.rmtree(d, ignore_errors=True)


# -- the manager --------------------------------------------------------------

class ReplicaManager:

    def __init__(self, service_name: str, task,
                 spec: spec_lib.ServiceSpec, launcher=None) -> None:
        self.service_name = service_name
        self.task = task
        self.spec = spec
        self.launcher = launcher if launcher is not None \
            else LocalLauncher()
        # The last replica id this manager handed out: a replacement
        # never takes a torn-down replica's id and cluster name (the
        # reference's MAX+1 over the rows left reuses them; ROADMAP
        # Queue 3).
        self._last_replica_id = 0
        self.spot_placer = None
        if spec.use_spot and spec.spot_zones:
            from skypilot_tpu_torch.serve import spot_placer as placer_lib
            self.spot_placer = placer_lib.SpotPlacer(list(spec.spot_zones))
        # A flapping endpoint must not eat a full probe timeout every
        # round: past the failure threshold its circuit opens and
        # probes short-circuit until the recovery window passes. The
        # threshold sits BELOW the replacement threshold so the final
        # pre-replacement round fast-fails instead of burning another
        # full probe timeout (equal thresholds would open the circuit
        # on the same round that forgets the endpoint).
        self._probe_breaker = circuit.CircuitBreaker(
            'probe',
            failure_threshold=max(1, _MAX_CONSECUTIVE_FAILURES - 1),
            recovery_timeout=envs.SKYTPU_PROBE_BREAKER_RECOVERY.get())

    # -- lifecycle -----------------------------------------------------------

    def scale_up(self, n: int = 1,
                 use_spot: Optional[bool] = None,
                 pool: Optional[str] = None) -> List[int]:
        """Launch n new replica clusters in BACKGROUND threads so the
        control loop keeps probing healthy replicas while others boot.

        use_spot overrides the spec default (the fallback autoscaler
        launches on-demand replicas into a spot service); `pool`
        names the replica pool the new replicas belong to — its
        PoolSpec resource overrides shape the launched cluster.
        """
        launched = []
        service = serve_state.get_service(self.service_name)
        version = service['version'] if service else 1
        spot = self.spec.use_spot if use_spot is None else use_spot
        for _ in range(n):
            replica_id = max(serve_state.next_replica_id(self.service_name),
                             self._last_replica_id + 1)
            self._last_replica_id = replica_id
            cluster = replica_cluster_name(self.service_name, replica_id)
            zone = None
            if spot and self.spot_placer is not None:
                counts: Dict[str, int] = {}
                for r in serve_state.get_replicas(self.service_name):
                    if r.get('zone'):
                        counts[r['zone']] = counts.get(r['zone'], 0) + 1
                zone = self.spot_placer.select(counts)
            serve_state.add_replica(self.service_name, replica_id, cluster,
                                    version, use_spot=spot, zone=zone,
                                    pool=pool)
            thread = threading.Thread(
                target=self._launch_replica,
                args=(replica_id, cluster, spot, zone, pool),
                daemon=True)
            thread.start()
            launched.append(replica_id)
        return launched

    def _launch_replica(self, replica_id: int, cluster: str,
                        use_spot: bool, zone: Optional[str],
                        pool: Optional[str] = None) -> None:
        try:
            def _launch_once() -> None:
                faults.inject(
                    'provision.launch',
                    env_exc=exceptions.ResourcesUnavailableError)
                self.launcher.launch(
                    self._replica_task(use_spot, zone, pool=pool), cluster)

            # Transient capacity/setup errors retry under the shared
            # policy; anything else fails the replica immediately.
            gap = envs.SKYTPU_SERVE_LAUNCH_RETRY_GAP.get()
            retries.call(
                _launch_once,
                policy=retries.RetryPolicy(max_attempts=3,
                                           base_delay=gap,
                                           max_delay=gap * 8),
                retry_on=(exceptions.ResourcesUnavailableError,
                          exceptions.ClusterSetUpError),
                describe=f'launch replica {replica_id}')
            serve_state.set_replica_status(
                self.service_name, replica_id,
                serve_state.ReplicaStatus.STARTING,
                endpoint=self._endpoint_for(cluster))
        except Exception as e:  # noqa: BLE001 — any failure fails it
            # The reference catches SkyTpuError alone: anything else (a
            # code-armed fault, an OSError from the launch) ended the
            # thread and left the row PROVISIONING, which probe_all
            # skips, so it was never replaced (ROADMAP Queue 3).
            logger.warning('Replica %s launch failed: %s', replica_id, e)
            serve_state.set_replica_status(
                self.service_name, replica_id,
                serve_state.ReplicaStatus.FAILED)

    def _replica_task(self, use_spot: bool = False,
                      zone: Optional[str] = None,
                      pool: Optional[str] = None):
        """A fresh Task per replica, with the placer's spot/zone
        decision applied to every resource option and the pool's
        resource overrides (distinct hardware per pool role) merged over
        the task's own `resources:`."""
        from skypilot_tpu_torch import task as task_lib
        cfg = self.task.to_yaml_config()
        pool_spec = (self.spec.pools or {}).get(pool) \
            if pool is not None else None
        if pool_spec is not None and pool_spec.resources:
            resources = dict(cfg.get('resources') or {})
            resources.update(pool_spec.resources)
            cfg['resources'] = resources
        task = task_lib.Task.from_yaml_config(cfg)
        # Apply whenever the service runs mixed spot pools: an
        # on-demand fallback replica must override a task-level
        # use_spot: true.
        if self.spec.use_spot or use_spot or zone is not None:
            task.set_resources([
                dict(r, use_spot=use_spot, **({'zone': zone} if zone else {}))
                for r in task.resources])
        return task

    def _endpoint_for(self, cluster_name: str) -> Optional[str]:
        ip = self.launcher.head_ip(cluster_name)
        if ip is None:
            return None
        return f'http://{ip}:{self.spec.replica_port}'

    def scale_down(self, replica_ids: List[int]) -> None:
        by_id = {r['replica_id']: r
                 for r in serve_state.get_replicas(self.service_name)}
        for replica_id in replica_ids:
            gone = by_id.get(replica_id)
            if gone is not None and gone.get('endpoint'):
                # Dead endpoints must not linger as open circuits.
                self._probe_breaker.forget(gone['endpoint'])
            serve_state.set_replica_status(
                self.service_name, replica_id,
                serve_state.ReplicaStatus.SHUTTING_DOWN)
            cluster = replica_cluster_name(self.service_name, replica_id)
            try:
                self.launcher.down(cluster)
            except exceptions.ClusterDoesNotExist:
                pass
            serve_state.remove_replica(self.service_name, replica_id)

    def terminate_all(self) -> None:
        self.scale_down([r['replica_id']
                         for r in serve_state.get_replicas(
                             self.service_name)])

    # -- probing -------------------------------------------------------------

    def _probe_replica(self, replica: Dict) -> ProbeResult:
        endpoint = replica['endpoint']
        if not endpoint:
            return ProbeResult(False, 'no_endpoint')
        url = endpoint.rstrip('/') + self.spec.readiness_probe.path
        # STARTING replicas bypass the breaker: refusals while the app
        # boots are EXPECTED, and an open circuit here would suppress
        # the very probe that detects the app coming up — the replica
        # would blow its grace window unprobed and crash-loop.
        starting = (replica.get('status') ==
                    serve_state.ReplicaStatus.STARTING)
        if not starting and not self._probe_breaker.allow(endpoint):
            # Open circuit: fail fast instead of burning a full probe
            # timeout on an endpoint that just failed repeatedly.
            return ProbeResult(False, 'circuit_open')
        detail = 'error'
        try:
            faults.inject('probe.http', env_exc=ConnectionRefusedError)
            req = urllib.request.Request(url)
            post = self.spec.readiness_probe.post_data
            if post is not None:
                req = urllib.request.Request(
                    url, data=json.dumps(post).encode(),
                    headers={'Content-Type': 'application/json'})
            with urllib.request.urlopen(
                    req,
                    timeout=self.spec.readiness_probe.timeout_seconds):
                self._probe_breaker.record_success(endpoint)
                return ProbeResult(True, 'ok')
        except urllib.error.HTTPError as e:
            detail = f'http_{e.code}'
        except urllib.error.URLError as e:
            detail = self._classify_probe_error(e.reason)
        except (TimeoutError, OSError, ValueError) as e:
            detail = self._classify_probe_error(e)
        except faults.FaultInjected:
            detail = 'injected'
        if not starting:
            # Boot-time refusals are expected and must not raise the
            # circuit-open alarm on every normal scale-up.
            self._probe_breaker.record_failure(endpoint)
        logger.debug('Probe of replica %s failed: %s (%s)',
                     replica['replica_id'], detail, url)
        return ProbeResult(False, detail)

    @staticmethod
    def _classify_probe_error(reason) -> str:
        if isinstance(reason, ConnectionRefusedError):
            return 'refused'
        if isinstance(reason, (TimeoutError, )) or \
                'timed out' in str(reason):
            return 'timeout'
        return f'error:{type(reason).__name__}'

    def _cluster_lost(self, replica: Dict) -> bool:
        return self.launcher.head_ip(replica['cluster_name']) is None

    def probe_all(self) -> None:
        """One probe round: update replica statuses, replace dead ones."""
        for replica in serve_state.get_replicas(self.service_name):
            status = replica['status']
            if status in (serve_state.ReplicaStatus.SHUTTING_DOWN,
                          serve_state.ReplicaStatus.FAILED,
                          serve_state.ReplicaStatus.PROVISIONING):
                # PROVISIONING: a background launch thread owns it.
                continue
            if self._cluster_lost(replica):
                # Preempted / externally deleted: replace (same
                # spot-ness; the placer steers the new replica away
                # from the preempted zone).
                serve_state.set_replica_status(
                    self.service_name, replica['replica_id'],
                    serve_state.ReplicaStatus.PREEMPTED)
                if replica.get('use_spot') and self.spot_placer:
                    self.spot_placer.handle_preemption(replica.get('zone'))
                self.scale_down([replica['replica_id']])
                # Replacement keeps the dead replica's pool: a lost
                # decode replica must not come back on base-task
                # hardware outside its pool's scaling envelope.
                self.scale_up(1, use_spot=replica.get('use_spot'),
                              pool=replica.get('pool'))
                continue
            if replica['endpoint'] is None:
                endpoint = self._endpoint_for(replica['cluster_name'])
                if endpoint:
                    serve_state.set_replica_status(
                        self.service_name, replica['replica_id'],
                        status, endpoint=endpoint)
                    replica = dict(replica, endpoint=endpoint)
            probe = self._probe_replica(replica)
            if probe.ok:
                serve_state.clear_replica_failures(
                    self.service_name, replica['replica_id'])
                if status != serve_state.ReplicaStatus.READY:
                    serve_state.set_replica_status(
                        self.service_name, replica['replica_id'],
                        serve_state.ReplicaStatus.READY)
                    if replica.get('use_spot') and self.spot_placer:
                        self.spot_placer.handle_active(replica.get('zone'))
            else:
                failures = serve_state.bump_replica_failures(
                    self.service_name, replica['replica_id'])
                logger.info('Replica %s probe failed (%s), %d '
                            'consecutive', replica['replica_id'],
                            probe.detail, failures)
                if status == serve_state.ReplicaStatus.READY:
                    serve_state.set_replica_status(
                        self.service_name, replica['replica_id'],
                        serve_state.ReplicaStatus.NOT_READY)
                if status == serve_state.ReplicaStatus.STARTING:
                    # Probe failures during startup are expected until
                    # initial_delay_seconds; past it, the app is deemed
                    # crashed and the replica is replaced.
                    launched_at = replica['launched_at']
                    if launched_at is None:
                        # A None launched_at must not compute an age
                        # of ~Unix-epoch and instantly blow the grace
                        # window: grant the full window from now.
                        launched_at = time.time()
                        logger.warning(
                            'Replica %s is STARTING with no '
                            'launched_at; granting grace from now',
                            replica['replica_id'])
                        serve_state.set_replica_launched_at(
                            self.service_name, replica['replica_id'],
                            launched_at)
                    age = time.time() - launched_at
                    if age > self.spec.readiness_probe. \
                            initial_delay_seconds:
                        self.scale_down([replica['replica_id']])
                        self.scale_up(1, pool=replica.get('pool'))
                elif failures >= _MAX_CONSECUTIVE_FAILURES:
                    # Persistent failure: replace the replica.
                    self.scale_down([replica['replica_id']])
                    self.scale_up(1, pool=replica.get('pool'))

    def ready_endpoints(self) -> List[str]:
        return [r['endpoint']
                for r in serve_state.get_replicas(self.service_name)
                if r['status'] == serve_state.ReplicaStatus.READY and
                r['endpoint']]
