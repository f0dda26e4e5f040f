"""Service/replica state DB (SQLite).

The port's copy of `skypilot_tpu/serve/serve_state.py`: the two tables
`services` and `replicas`, column for column (:67-93), with the
pre-spot (`use_spot`, `zone`) and pre-pool (`pool`) migrations (:94-103),
so a database written by either package reads the same in the other;
the status enums `ServiceStatus` / `ReplicaStatus` with the reference's
values; `serve_db_path`, `controller_log_path`, `reset_for_tests`; the
service rows (`add_service`, `set_service_status`,
`set_service_controller`, `set_service_version`, `remove_service`,
`get_service`, `get_services`) and the replica rows (`add_replica`,
`set_replica_status`, `set_replica_launched_at`,
`bump_replica_failures`, `clear_replica_failures`, `remove_replica`,
`get_replicas`, `next_replica_id`). One connection per process and
path, a fresh one (and a fresh lock) in a forked child. A service's
SHUTTING_DOWN status is not overwritten. Reads take the
lock as writes do: the reference reads the shared connection without
it, and a read racing a write from another thread (a launch thread, a
status watcher) raised sqlite3.InterfaceError (ROADMAP Queue 3).
"""
import enum
import json
import os
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch.utils import paths

_lock = threading.Lock()


def _after_fork_in_child() -> None:
    """Fresh lock + connection in forked children: the parent process
    is multi-threaded (API server), so the inherited lock may be held
    by a thread that does not exist in the child."""
    global _lock, _conn, _conn_path
    _lock = threading.Lock()
    _conn = None
    _conn_path = None


os.register_at_fork(after_in_child=_after_fork_in_child)
_conn: Optional[sqlite3.Connection] = None
_conn_path: Optional[str] = None


class ServiceStatus(enum.Enum):
    CONTROLLER_INIT = 'CONTROLLER_INIT'
    REPLICA_INIT = 'REPLICA_INIT'      # no ready replicas yet
    READY = 'READY'
    SHUTTING_DOWN = 'SHUTTING_DOWN'
    FAILED = 'FAILED'
    NO_REPLICA = 'NO_REPLICA'          # scaled to zero / all failed


class ReplicaStatus(enum.Enum):
    PROVISIONING = 'PROVISIONING'
    STARTING = 'STARTING'              # cluster up; app not ready
    READY = 'READY'
    NOT_READY = 'NOT_READY'            # probe failing; grace period
    SHUTTING_DOWN = 'SHUTTING_DOWN'
    FAILED = 'FAILED'
    PREEMPTED = 'PREEMPTED'

    @property
    def is_terminal(self) -> bool:
        return self in (ReplicaStatus.FAILED,)


def serve_db_path() -> str:
    return os.path.join(paths.state_dir(), 'serve.db')


def controller_log_path(service_name: str) -> str:
    d = os.path.join(paths.state_dir(), 'serve_logs')
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f'{service_name}.controller.log')


def _get_conn() -> sqlite3.Connection:
    global _conn, _conn_path
    path = serve_db_path()
    with _lock:
        if _conn is None or _conn_path != path:
            _conn = sqlite3.connect(path, check_same_thread=False,
                                    timeout=30.0)
            _conn.execute('PRAGMA journal_mode=WAL')
            _conn.execute("""
                CREATE TABLE IF NOT EXISTS services (
                    name TEXT PRIMARY KEY,
                    task_yaml TEXT,
                    status TEXT,
                    created_at REAL,
                    controller_pid INTEGER,
                    lb_port INTEGER,
                    controller_port INTEGER,
                    version INTEGER DEFAULT 1
                )""")
            _conn.execute("""
                CREATE TABLE IF NOT EXISTS replicas (
                    service_name TEXT,
                    replica_id INTEGER,
                    cluster_name TEXT,
                    status TEXT,
                    version INTEGER,
                    endpoint TEXT,
                    launched_at REAL,
                    consecutive_failures INTEGER DEFAULT 0,
                    use_spot INTEGER DEFAULT 0,
                    zone TEXT,
                    pool TEXT,
                    PRIMARY KEY (service_name, replica_id)
                )""")
            cols = [r[1] for r in _conn.execute(
                'PRAGMA table_info(replicas)')]
            if 'use_spot' not in cols:  # pre-spot DBs
                _conn.execute('ALTER TABLE replicas ADD COLUMN '
                              'use_spot INTEGER DEFAULT 0')
                _conn.execute('ALTER TABLE replicas ADD COLUMN zone TEXT')
            if 'pool' not in cols:  # pre-pool DBs
                _conn.execute('ALTER TABLE replicas ADD COLUMN '
                              'pool TEXT')
            _conn.commit()
            _conn_path = path
        return _conn


def reset_for_tests() -> None:
    global _conn, _conn_path
    with _lock:
        if _conn is not None:
            _conn.close()
        _conn = None
        _conn_path = None


# --- services ---------------------------------------------------------------

def add_service(name: str, task_yaml: Dict[str, Any], lb_port: int,
                controller_port: int) -> None:
    conn = _get_conn()
    with _lock:
        conn.execute(
            'INSERT INTO services (name, task_yaml, status, created_at, '
            'lb_port, controller_port) VALUES (?,?,?,?,?,?)',
            (name, json.dumps(task_yaml),
             ServiceStatus.CONTROLLER_INIT.value, time.time(), lb_port,
             controller_port))
        conn.commit()


def set_service_status(name: str, status: ServiceStatus) -> None:
    """SHUTTING_DOWN is final: a controller tick that read the service
    before `serve down` marked it must not write its health back over
    the mark (the reference's does, and its controller then never shuts
    down; ROADMAP Queue 3)."""
    conn = _get_conn()
    with _lock:
        conn.execute('UPDATE services SET status=? WHERE name=? AND '
                     'status!=?', (status.value, name,
                                   ServiceStatus.SHUTTING_DOWN.value))
        conn.commit()


def set_service_controller(name: str, pid: int) -> None:
    conn = _get_conn()
    with _lock:
        conn.execute('UPDATE services SET controller_pid=? WHERE name=?',
                     (pid, name))
        conn.commit()


def set_service_version(name: str, version: int,
                        task_yaml: Dict[str, Any]) -> None:
    conn = _get_conn()
    with _lock:
        conn.execute(
            'UPDATE services SET version=?, task_yaml=? WHERE name=?',
            (version, json.dumps(task_yaml), name))
        conn.commit()


def remove_service(name: str) -> None:
    conn = _get_conn()
    with _lock:
        conn.execute('DELETE FROM services WHERE name=?', (name,))
        conn.execute('DELETE FROM replicas WHERE service_name=?', (name,))
        conn.commit()


def get_service(name: str) -> Optional[Dict[str, Any]]:
    conn = _get_conn()
    with _lock:
        row = conn.execute(
            'SELECT name, task_yaml, status, created_at, controller_pid, '
            'lb_port, controller_port, version FROM services WHERE name=?',
            (name,)).fetchone()
    return _service_row(row) if row else None


def get_services() -> List[Dict[str, Any]]:
    conn = _get_conn()
    with _lock:
        rows = conn.execute(
            'SELECT name, task_yaml, status, created_at, controller_pid, '
            'lb_port, controller_port, version FROM services '
            'ORDER BY created_at').fetchall()
    return [_service_row(r) for r in rows]


def _service_row(row) -> Dict[str, Any]:
    (name, task_yaml, status, created_at, controller_pid, lb_port,
     controller_port, version) = row
    return {
        'name': name,
        'task_yaml': json.loads(task_yaml) if task_yaml else None,
        'status': ServiceStatus(status),
        'created_at': created_at,
        'controller_pid': controller_pid,
        'lb_port': lb_port,
        'controller_port': controller_port,
        'version': version,
    }


# --- replicas ---------------------------------------------------------------

def add_replica(service_name: str, replica_id: int, cluster_name: str,
                version: int, use_spot: bool = False,
                zone: Optional[str] = None,
                pool: Optional[str] = None) -> None:
    conn = _get_conn()
    with _lock:
        conn.execute(
            'INSERT OR REPLACE INTO replicas (service_name, replica_id, '
            'cluster_name, status, version, launched_at, use_spot, '
            'zone, pool) VALUES (?,?,?,?,?,?,?,?,?)',
            (service_name, replica_id, cluster_name,
             ReplicaStatus.PROVISIONING.value, version, time.time(),
             int(use_spot), zone, pool))
        conn.commit()


def set_replica_status(service_name: str, replica_id: int,
                       status: ReplicaStatus,
                       endpoint: Optional[str] = None) -> None:
    conn = _get_conn()
    with _lock:
        if endpoint is not None:
            conn.execute(
                'UPDATE replicas SET status=?, endpoint=? '
                'WHERE service_name=? AND replica_id=?',
                (status.value, endpoint, service_name, replica_id))
        else:
            conn.execute(
                'UPDATE replicas SET status=? '
                'WHERE service_name=? AND replica_id=?',
                (status.value, service_name, replica_id))
        conn.commit()


def set_replica_launched_at(service_name: str, replica_id: int,
                            launched_at: float) -> None:
    """Repair a missing launch timestamp (probe grace-window anchor)."""
    conn = _get_conn()
    with _lock:
        conn.execute(
            'UPDATE replicas SET launched_at=? '
            'WHERE service_name=? AND replica_id=?',
            (launched_at, service_name, replica_id))
        conn.commit()


def bump_replica_failures(service_name: str, replica_id: int) -> int:
    conn = _get_conn()
    with _lock:
        conn.execute(
            'UPDATE replicas SET consecutive_failures='
            'consecutive_failures+1 WHERE service_name=? AND replica_id=?',
            (service_name, replica_id))
        conn.commit()
        row = conn.execute(
            'SELECT consecutive_failures FROM replicas '
            'WHERE service_name=? AND replica_id=?',
            (service_name, replica_id)).fetchone()
    return int(row[0]) if row else 0


def clear_replica_failures(service_name: str, replica_id: int) -> None:
    conn = _get_conn()
    with _lock:
        conn.execute(
            'UPDATE replicas SET consecutive_failures=0 '
            'WHERE service_name=? AND replica_id=?',
            (service_name, replica_id))
        conn.commit()


def remove_replica(service_name: str, replica_id: int) -> None:
    conn = _get_conn()
    with _lock:
        conn.execute(
            'DELETE FROM replicas WHERE service_name=? AND replica_id=?',
            (service_name, replica_id))
        conn.commit()


def get_replicas(service_name: str) -> List[Dict[str, Any]]:
    conn = _get_conn()
    with _lock:
        rows = conn.execute(
            'SELECT service_name, replica_id, cluster_name, status, '
            'version, endpoint, launched_at, consecutive_failures, '
            'use_spot, zone, pool FROM replicas WHERE service_name=? '
            'ORDER BY replica_id', (service_name,)).fetchall()
    return [{
        'service_name': r[0], 'replica_id': r[1], 'cluster_name': r[2],
        'status': ReplicaStatus(r[3]), 'version': r[4], 'endpoint': r[5],
        'launched_at': r[6], 'consecutive_failures': r[7],
        'use_spot': bool(r[8]), 'zone': r[9], 'pool': r[10],
    } for r in rows]


def next_replica_id(service_name: str) -> int:
    conn = _get_conn()
    with _lock:
        row = conn.execute(
            'SELECT COALESCE(MAX(replica_id), 0) FROM replicas '
            'WHERE service_name=?', (service_name,)).fetchone()
    return int(row[0]) + 1
