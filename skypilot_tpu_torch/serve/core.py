"""Serve public API: up / update / down / status / tail_logs.

The port of `skypilot_tpu/serve/core.py` (:23-172) in its consolidated
mode: the controller, with its load balancer, is a local process of
this host (`python -m skypilot_tpu_torch.serve.controller`), spawned by
`up` in a new session with its output in
`serve_state.controller_log_path`, and reaped by a thread of the
spawning process once it exits. The controller imports no torch, so it
takes no CUDA context on a card its replicas share (the reference
spawns its own with JAX_PLATFORMS=cpu, :54-59).

`controller_mode` reads `serve.controller.mode` from the reference's
config layers (~/.skytpu/config.yaml, ./.skytpu.yaml, $SKYTPU_CONFIG) as
`controller_utils.controller_mode` does; with no YAML parser on the
card, it reads block mappings of plain scalars, the form that setting
takes. A `dedicated` controller runs on a controller cluster through the
launch stack, which the port takes up next (ROADMAP Queue 1 item 3):
`up` and `down` raise NotImplementedError for it. `tail_logs` has no
API-server cancellation (ROADMAP Queue 1 item 5).
"""
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from skypilot_tpu_torch import envs
from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.serve import serve_state

_CONFIG_LAYERS = ('~/.skytpu/config.yaml', '.skytpu.yaml')
_DEDICATED = ('serve.controller.mode is dedicated: a dedicated controller '
              'runs on a controller cluster through the launch stack, '
              'which the port has not taken up yet (ROADMAP Queue 1 item '
              '3); use the consolidated mode')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _block_yaml_scalar(path: str, keys: Sequence[str]) -> Optional[str]:
    """The plain scalar at `keys` in a YAML file of block mappings, or
    None (no file, no such key, or a form this reader does not take)."""
    try:
        with open(os.path.expanduser(path), encoding='utf-8') as f:
            lines = f.read().splitlines()
    except OSError:
        return None
    stack: List[tuple] = []  # (indent, key) of the open mappings
    for line in lines:
        text = line.split(' #', 1)[0].rstrip()
        if not text.strip() or text.lstrip().startswith('#'):
            continue
        indent = len(text) - len(text.lstrip())
        key, sep, value = text.strip().partition(':')
        if not sep:
            continue
        while stack and stack[-1][0] >= indent:
            stack.pop()
        at = tuple(k for _, k in stack) + (key.strip().strip('\'"'),)
        value = value.strip()
        if not value:
            stack.append((indent, at[-1]))
        elif at == tuple(keys):
            return value.strip('\'"')
    return None


def controller_mode(kind: str = 'serve') -> str:
    mode = 'consolidated'
    layers = list(_CONFIG_LAYERS)
    if envs.SKYTPU_CONFIG.get():
        layers.append(envs.SKYTPU_CONFIG.get())
    for path in layers:
        found = _block_yaml_scalar(path, (kind, 'controller', 'mode'))
        if found is not None:
            mode = found
    if mode not in ('consolidated', 'dedicated'):
        raise exceptions.InvalidTaskError(
            f'{kind}.controller.mode must be consolidated|dedicated, '
            f'got {mode!r}')
    return mode


def _controller_env() -> Dict[str, str]:
    """This environment, with the port's package importable from the
    controller process wherever it starts."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get('PYTHONPATH')
    return dict(os.environ,
                PYTHONPATH=root + (os.pathsep + path if path else ''))


def up(task, service_name: str, wait_seconds: float = 0.0
       ) -> Dict[str, Any]:
    """Create a service from a task with a `service:` section."""
    if task.service is None:
        raise exceptions.InvalidTaskError(
            'Task has no service: section; cannot `serve up`.')
    if serve_state.get_service(service_name) is not None:
        raise exceptions.ServeError(
            f'Service {service_name!r} already exists.')
    if controller_mode('serve') == 'dedicated':
        raise NotImplementedError(_DEDICATED)
    lb_port = _free_port()
    serve_state.add_service(service_name, task.to_yaml_config(), lb_port,
                            controller_port=0)
    log_path = serve_state.controller_log_path(service_name)
    with open(log_path, 'ab') as log_f:
        proc = subprocess.Popen(
            [sys.executable, '-m', 'skypilot_tpu_torch.serve.controller',
             '--service-name', service_name],
            stdout=log_f, stderr=log_f, start_new_session=True,
            env=_controller_env())
    # Reaped when it exits: a finished controller must not linger as
    # this process's zombie (`down` probes its pid).
    threading.Thread(target=proc.wait, daemon=True,
                     name=f'skytpu-reap-controller-{service_name}').start()
    serve_state.set_service_controller(service_name, proc.pid)
    if wait_seconds:
        deadline = time.time() + wait_seconds
        while time.time() < deadline:
            service = serve_state.get_service(service_name)
            if service and service['status'] == \
                    serve_state.ServiceStatus.READY:
                break
            time.sleep(0.5)
    return {'service_name': service_name,
            'endpoint': f'http://127.0.0.1:{lb_port}'}


def update(task, service_name: str) -> Dict[str, Any]:
    """Rolling update: bump the service version with a new task; the
    controller replaces replicas one at a time, keeping capacity up."""
    service = serve_state.get_service(service_name)
    if service is None:
        raise exceptions.ServeError(
            f'Service {service_name!r} does not exist.')
    if task.service is None:
        raise exceptions.InvalidTaskError(
            'Updated task has no service: section.')
    new_version = service['version'] + 1
    serve_state.set_service_version(service_name, new_version,
                                    task.to_yaml_config())
    return {'service_name': service_name, 'version': new_version}


def down(service_name: str, purge: bool = False) -> None:
    service = serve_state.get_service(service_name)
    if service is None:
        if purge:
            return
        raise exceptions.ServeError(
            f'Service {service_name!r} does not exist.')
    if controller_mode('serve') == 'dedicated':
        raise NotImplementedError(_DEDICATED)
    serve_state.set_service_status(service_name,
                                   serve_state.ServiceStatus.SHUTTING_DOWN)
    # Controller notices and cleans up — but only wait for it while its
    # process is alive (it may have crashed FAILED earlier, or during
    # the wait). The controller leads its own session, so its process
    # group is the controller alone; a zombie counts as dead, which the
    # reference's signal 0 does not.
    from skypilot_tpu_torch import task as task_lib
    from skypilot_tpu_torch.serve import replica_managers
    pid = service['controller_pid']
    if pid and replica_managers.group_alive(pid):
        replica_managers.wait_group(
            pid, 120, 0.5,
            until=lambda: serve_state.get_service(service_name) is None)
        if serve_state.get_service(service_name) is None:
            return
        try:
            os.kill(pid, 15)
        except ProcessLookupError:
            pass
    task = task_lib.Task.from_yaml_config(service['task_yaml'])
    replica_managers.ReplicaManager(
        service_name, task, task.service).terminate_all()
    serve_state.remove_service(service_name)


def status(service_names: Optional[List[str]] = None
           ) -> List[Dict[str, Any]]:
    out = []
    for service in serve_state.get_services():
        if service_names and service['name'] not in service_names:
            continue
        replicas = serve_state.get_replicas(service['name'])
        out.append({
            'name': service['name'],
            'status': service['status'].value,
            'endpoint': f'http://127.0.0.1:{service["lb_port"]}',
            'version': service['version'],
            'replicas': [{
                'replica_id': r['replica_id'],
                'status': r['status'].value,
                'cluster_name': r['cluster_name'],
                'endpoint': r['endpoint'],
            } for r in replicas],
        })
    return out


def tail_logs(service_name: str, follow: bool = True,
              poll_interval: float = 1.0) -> int:
    service = serve_state.get_service(service_name)
    if service is None:
        raise exceptions.ServeError(
            f'Service {service_name!r} does not exist.')
    path = serve_state.controller_log_path(service_name)
    pos = 0
    while True:
        try:
            with open(path, 'r', encoding='utf-8') as f:
                f.seek(pos)
                chunk = f.read()
        except FileNotFoundError:
            chunk = ''
        if chunk:
            print(chunk, end='', flush=True)
            pos += len(chunk.encode())
        if not follow or serve_state.get_service(service_name) is None:
            return 0
        time.sleep(poll_interval)
