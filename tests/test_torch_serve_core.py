"""The port's `serve/core.py` end to end on the CPU.

A tiny port server (`python -m skypilot_tpu_torch.inference.server
--model tiny --device cpu`) is the replica, launched through the launch
seam by the port's controller, which `up` spawns as a process with
SKYTPU_SERVE_LOOP_INTERVAL at 0.2 s: the service goes READY, a greedy
request through its endpoint (the LB on the controller's thread) equals
the replica's direct answer, `status` and `tail_logs(follow=False)` are
well formed, `update` to a v2 task on a second port rolls to a READY v2
replica with the v1 group gone, and `down(purge=True)` leaves no
replica process, no service row, no controller and a closed LB port.
The test holds its own time limit (SERVE_LIMIT_S). Beside it: a
controller killed under a live service does not hold `down` for the
reference's 120 s wait (ROADMAP Queue 3), and `serve.controller.mode:
dedicated` raises NotImplementedError as the reference's config reads
it.
"""
import contextlib
import io
import json
import os
import signal
import socket
import sys
import time
import urllib.request

import pytest

from skypilot_tpu_torch import task as task_lib
from skypilot_tpu_torch.serve import core
from skypilot_tpu_torch.serve import replica_managers
from skypilot_tpu_torch.serve import serve_state
from skypilot_tpu_torch.utils import paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_LIMIT_S = 150.0


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _task(port, run=None):
    run = run or (f'exec {sys.executable} -m '
                  f'skypilot_tpu_torch.inference.server --model tiny '
                  f'--device cpu --port {port} --batch-size 2 '
                  f'--max-seq-len 128 --seed 0')
    return task_lib.Task.from_yaml_config({
        'name': 'tiny-service', 'run': run,
        'envs': {'PYTHONPATH': REPO, 'OMP_NUM_THREADS': '1'},
        'service': {'readiness_probe': {'path': '/health',
                                        'initial_delay_seconds': 120,
                                        'timeout_seconds': 5},
                    'replica_port': port, 'replicas': 1}})


def _generate(url):
    body = json.dumps({'prompt_tokens': [3, 1, 4, 1, 5, 9, 2, 6],
                       'max_new_tokens': 6, 'temperature': 0.0}).encode()
    req = urllib.request.Request(url + '/generate', data=body,
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())['tokens']


def _wait(pred, deadline, what):
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.1)
    raise AssertionError(f'{what}: not within the limit; '
                         f'{core.status()}')


def _alive(pid):
    try:
        with open(f'/proc/{pid}/stat', 'rb') as f:
            return f.read().rsplit(b')', 1)[1].split()[0] not in (b'Z', b'X')
    except OSError:
        return False


def _groups(name):
    """Process group of each of the service's replica clusters."""
    launcher = replica_managers.LocalLauncher()
    out = {}
    for r in serve_state.get_replicas(name):
        meta = launcher._meta(r['cluster_name'])  # noqa: SLF001
        if meta:
            out[r['replica_id']] = meta['pgid']
    return out


@pytest.fixture
def serve_env(monkeypatch):
    monkeypatch.setenv('SKYTPU_SERVE_LOOP_INTERVAL', '0.2')
    serve_state.reset_for_tests()
    yield
    for service in serve_state.get_services():
        core.down(service['name'], purge=True)
    serve_state.reset_for_tests()


def test_up_update_down_end_to_end(serve_env):
    deadline = time.monotonic() + SERVE_LIMIT_S
    p1, p2 = _free_port(), _free_port()
    result = core.up(_task(p1), 'tinysvc')
    endpoint = result['endpoint']
    lb_port = int(endpoint.rsplit(':', 1)[1])
    rows = _wait(lambda: [s for s in core.status(['tinysvc'])
                          if s['status'] == 'READY'], deadline, 'READY')
    (replica,) = rows[0]['replicas']
    assert replica['endpoint'] == f'http://127.0.0.1:{p1}'
    controller = serve_state.get_service('tinysvc')['controller_pid']
    assert _alive(controller)
    # The LB's answer is the replica's own, token for token.
    via_lb = _generate(endpoint)
    assert via_lb == _generate(replica['endpoint']) and len(via_lb) == 6
    with urllib.request.urlopen(endpoint + '/internal/stats',
                                timeout=10) as resp:
        assert json.loads(resp.read())['replicas'] == [replica['endpoint']]
    row = core.status(['tinysvc'])[0]
    assert set(row) == {'name', 'status', 'endpoint', 'version', 'replicas'}
    assert (row['name'], row['endpoint'], row['version']) == (
        'tinysvc', endpoint, 1)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert core.tail_logs('tinysvc', follow=False) == 0
    assert 'skypilot_tpu_torch.serve.replica_managers]' in out.getvalue()

    v1_groups = _groups('tinysvc')
    assert core.update(_task(p2), 'tinysvc') == {'service_name': 'tinysvc',
                                                'version': 2}

    def rolled():
        reps = serve_state.get_replicas('tinysvc')
        return reps and all(
            r['version'] == 2 and
            r['status'] == serve_state.ReplicaStatus.READY for r in reps)

    _wait(rolled, deadline, 'v2 READY')
    (v2,) = serve_state.get_replicas('tinysvc')
    assert v2['endpoint'] == f'http://127.0.0.1:{p2}'
    _wait(lambda: not any(_alive(g) for g in v1_groups.values()),
          deadline, 'v1 gone')
    assert _generate(endpoint) == via_lb
    v2_groups = _groups('tinysvc')

    core.down('tinysvc', purge=True)
    assert time.monotonic() < deadline
    assert serve_state.get_service('tinysvc') is None
    assert core.status() == []
    _wait(lambda: not _alive(controller), deadline, 'controller exit')
    assert not any(_alive(g) for g in v2_groups.values())
    assert os.listdir(paths.local_clusters_dir()) == []
    with socket.socket() as s:
        assert s.connect_ex(('127.0.0.1', lb_port)) != 0


def test_down_does_not_wait_on_a_killed_controller(serve_env):
    """ROADMAP Queue 3: the reference's `up` never reaps its controller,
    so a controller that died stays a zombie that `down`'s liveness
    probe takes for alive, and `down` waits 120 s; the port reaps it and
    tears the service down at once."""
    port = _free_port()
    core.up(_task(port, run='exec sleep 300'), 'killsvc')
    deadline = time.monotonic() + 30
    groups = _wait(lambda: _groups('killsvc'), deadline, 'replica group')
    pid = serve_state.get_service('killsvc')['controller_pid']
    os.kill(pid, signal.SIGKILL)
    _wait(lambda: not _alive(pid), deadline, 'controller death')
    t0 = time.monotonic()
    core.down('killsvc', purge=True)
    assert time.monotonic() - t0 < 10
    assert serve_state.get_service('killsvc') is None
    assert not any(_alive(g) for g in groups.values())


def test_dedicated_controller_mode_is_refused(serve_env, tmp_path,
                                              monkeypatch):
    cfg = tmp_path / 'config.yaml'
    cfg.write_text('# layered config\nserve:\n  controller:\n'
                   '    mode: dedicated   # a controller cluster\n'
                   'jobs:\n  controller:\n    mode: consolidated\n')
    monkeypatch.setenv('SKYTPU_CONFIG', str(cfg))
    from skypilot_tpu import config as ref_config
    from skypilot_tpu.utils import controller_utils
    ref_config.reload()
    for kind in ('serve', 'jobs'):
        assert core.controller_mode(kind) == \
            controller_utils.controller_mode(kind)
    with pytest.raises(NotImplementedError, match='Queue 1 item 3'):
        core.up(_task(_free_port()), 'dedsvc')
    assert serve_state.get_service('dedsvc') is None
    cfg.write_text('serve:\n  controller:\n    mode: "consolidated"\n')
    ref_config.reload()
    assert core.controller_mode('serve') == 'consolidated' == \
        controller_utils.controller_mode('serve')
