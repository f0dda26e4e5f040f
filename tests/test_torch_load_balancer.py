"""The port's stdlib load balancer against the reference's aiohttp one.

- Helpers: `request_context`, `classify_pool_role`, `handoff_eligible`
  and `_sse_frame_doc` give the reference's answers over one table of
  bodies (tokenized, string, oversized, non-JSON, `stream` unset,
  decode-shaped).
- `dispatch`, the non-HTTP seam: the same results, breaker states,
  in-flight counts and counter deltas over one script of failing
  upstreams, and no in-flight leak when a send fails or raises.
- End to end: the port's LB in front of tiny port servers, against the
  reference's LB in front of tiny reference `EngineLoop`s served by its
  aiohttp app, on the same weights (`weights.from_jax_params`): a
  planned handoff, the `lb.handoff`-armed fallback, a drain through the
  LB, and a dead replica. The client's token streams equal each other
  and the reference's greedy run, the counter deltas are equal, the
  `/internal/stats` documents have the same keys, and no internal frame
  reaches the client.
- Concurrency: eight streamed clients through the port's LB, three
  leaving mid-stream: every policy's in-flight count returns to 0 and
  `stop()` leaves no thread behind.
"""
import asyncio
import base64
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from skypilot_tpu import inference as ref_inference
from skypilot_tpu.inference import server as ref_server
from skypilot_tpu.models import llama as ref_llama
from skypilot_tpu.observability import instruments as ref_obs
from skypilot_tpu.resilience import faults as ref_faults
from skypilot_tpu.serve import load_balancer as ref_lb
from skypilot_tpu_torch import inference
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.inference import server as port_server
from skypilot_tpu_torch.observability import instruments as port_obs
from skypilot_tpu_torch.resilience import faults as port_faults
from skypilot_tpu_torch.serve import load_balancer as port_lb

PROMPT = list(range(7, 19))
STEPS = 24
ENGINE_KW = dict(batch_size=2, max_seq_len=128, prefill_chunk=16,
                 kv_quant='none', decode_fuse_steps=2, prefix_cache=False)


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    # A 12-token tokenized prompt is prefill-shaped; only the abandon
    # (or a fallback resume) may free a prefill slot in a test's time.
    monkeypatch.setenv('SKYTPU_LB_POOL_PROMPT_THRESHOLD', '8')
    monkeypatch.setenv('SKYTPU_HANDOFF_LEASE_SECONDS', '30')
    # No background scrapes of the replicas while a test counts, and no
    # sampler thread (the reference's LB never stops the one it starts).
    monkeypatch.setenv('SKYTPU_WATCHDOG_TICK_SECONDS', '0')
    monkeypatch.setenv('SKYTPU_TS_SAMPLE_SECONDS', '0')
    yield
    ref_faults.reset()
    port_faults.reset()


# -- helpers -------------------------------------------------------------------

BODIES = {
    'tokenized': (json.dumps({'prompt_tokens': list(range(20)),
                              'max_new_tokens': 8}), 'application/json'),
    'tokenized_stream': (json.dumps({'prompt_tokens': list(range(20)),
                                     'max_new_tokens': 8,
                                     'stream': True}), 'application/json'),
    'stream_unset_long': (json.dumps({'prompt_tokens': list(range(40)),
                                      'max_new_tokens': 4}),
                          'application/json'),
    'decode_shaped': (json.dumps({'prompt_tokens': [1, 2, 3],
                                  'max_new_tokens': 200, 'stream': True}),
                      'application/json'),
    'openai_ids': (json.dumps({'prompt': list(range(30)), 'max_tokens': 8,
                               'stream': True}), 'application/json'),
    'string': (json.dumps({'prompt': 'hello world ' * 20,
                           'max_new_tokens': 4, 'stream': True}),
               'application/json'),
    'short_string': (json.dumps({'prompt': 'hi'}), 'application/json'),
    'mixed_tokens': (json.dumps({'prompt_tokens': [1, 'a'],
                                 'prompt': 'x'}), 'application/json'),
    'bool_stream': (json.dumps({'prompt_tokens': [1] * 12,
                                'stream': 1}), 'application/json'),
    'no_prompt': (json.dumps({'max_new_tokens': 4}), 'application/json'),
    'list_body': (json.dumps([1, 2, 3]), 'application/json'),
    'non_json': ('{"prompt_tokens": [1, 2', 'application/json'),
    'not_utf8': (b'\xff\xfe', 'application/json'),
    'text_type': (json.dumps({'prompt_tokens': [1] * 12}), 'text/plain'),
    'oversized': (json.dumps({'prompt_tokens': [1] * 12,
                              'pad': 'x' * (4 * 1024 * 1024)}),
                  'application/json'),
    'empty': ('', 'application/json'),
}


@pytest.mark.parametrize('name', sorted(BODIES))
@pytest.mark.parametrize('declared', [True, False])
def test_request_helpers_match_reference(name, declared):
    body, content_type = BODIES[name]
    body = body if isinstance(body, bytes) else body.encode()
    length = len(body) if declared else None
    got = {}
    for key, lb_mod in (('ref', ref_lb), ('port', port_lb)):
        ctx = lb_mod.request_context(body, content_type, length)
        got[key] = (ctx, lb_mod.classify_pool_role(ctx),
                    lb_mod.handoff_eligible(ctx))
    assert got['port'] == got['ref']


FRAMES = (b'data: {"token": 5}', b': keep-alive',
          b'event: x\ndata: {"done": true, "tokens": [1]}',
          b'data: [DONE]', b'data: 7', b'data: {"migrate": {}}',
          b'data: \xff', b'')


def test_sse_frame_doc_matches_reference():
    for frame in FRAMES:
        assert port_lb._sse_frame_doc(frame) == \
            ref_lb._sse_frame_doc(frame), frame


# -- dispatch, the non-HTTP seam ---------------------------------------------

_COUNTERS = ('LB_NO_REPLICA', 'LB_PROXY_ERRORS', 'LB_UPSTREAM_RETRIES',
             'HANDOFF_ATTEMPTS', 'HANDOFF_SUCCESSES', 'HANDOFF_FALLBACKS',
             'MIGRATION_ATTEMPTS', 'MIGRATION_SUCCESSES',
             'MIGRATION_FAILURES', 'LB_MIDSTREAM_FAILURES')
_LABELED = ('LB_REPLICA_REQUESTS', 'LB_POOL_REQUESTS', 'CIRCUIT_OPEN')


def _counters(obs):
    """Scalar LB counters, and labeled ones summed per label set with
    the replica URLs left out (they differ between the fleets)."""
    out = {name: getattr(obs, name).value() for name in _COUNTERS}
    for name in _LABELED:
        for _, labels, value in getattr(obs, name).samples():
            labels = dict(labels)
            key = (name, labels.get('pool'), labels.get('breaker'))
            out[key] = out.get(key, 0.0) + value
    return out


def _deltas(before, after):
    return {k: after.get(k, 0.0) - before.get(k, 0.0) for k in after
            if after.get(k, 0.0) != before.get(k, 0.0)}


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _dispatch_script(lb_mod, obs, policy):
    clock = _Clock()
    lb = lb_mod.LoadBalancer(policy, now_fn=clock, honor_env_policy=False)
    before = _counters(obs)
    trace = []
    lb.set_replicas(['a', 'b', 'c', 'p'], pools={
        'a': 'decode', 'b': 'decode', 'c': 'general', 'p': 'prefill'})
    down = {'a'}

    def send(url):
        return url not in down

    rng = np.random.default_rng(4)
    for step in range(60):
        clock.t += float(rng.choice([0.0, 2.0, 9.0]))
        if step == 30:
            down = {'a', 'b', 'c', 'p'}
        if step == 45:
            down = set()
            lb.set_replicas(['b', 'c'])
        ctx = [None, {'prompt_tokens': [1] * 20, 'max_new_tokens': 4},
               {'prompt_tokens': [2] * 3, 'max_new_tokens': 64}][
                   rng.integers(3)]
        trace.append((lb.dispatch(send, context=ctx),
                      {u: int(s) for u, s in lb.breaker.snapshot().items()},
                      lb.policy.stats().get('in_flight')))
    assert not lb_mod.LoadBalancer('least_load', honor_env_policy=False
                                   ).dispatch(send) == 'ok'  # empty
    return trace, _deltas(before, _counters(obs))


@pytest.mark.parametrize('policy', ['round_robin', 'least_load',
                                    'prefix_affinity'])
def test_dispatch_matches_reference(policy):
    ref = _dispatch_script(ref_lb, ref_obs, policy)
    port = _dispatch_script(port_lb, port_obs, policy)
    assert port == ref
    results = {r for r, _, _ in port[0]}
    assert {'ok', 'error', 'all_open'} <= results


def test_dispatch_balances_in_flight_when_send_raises():
    lb = port_lb.LoadBalancer('least_load')
    lb.set_replicas(['a'])

    def boom(url):
        raise RuntimeError('client died')

    with pytest.raises(RuntimeError):
        lb.dispatch(boom)
    assert lb.policy.stats()['in_flight'] == {'a': 0}
    assert lb.dispatch(lambda url: False) == 'error'
    assert lb.policy.stats()['in_flight'] == {'a': 0}


def test_env_policy_override(monkeypatch):
    monkeypatch.setenv('SKYTPU_LB_POLICY', 'prefix_affinity')
    assert port_lb.LoadBalancer('least_load').policy_name == \
        ref_lb.LoadBalancer('least_load').policy_name == 'prefix_affinity'
    assert port_lb.LoadBalancer(
        'least_load', honor_env_policy=False).policy_name == 'least_load'


# -- end to end: replicas behind each package's LB ---------------------------

@pytest.fixture(scope='module')
def tiny():
    ref_config = ref_llama.CONFIGS['tiny']
    params = ref_llama.init_params(ref_config, jax.random.key(7))
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    tparams = weights.from_jax_params(jax.tree.map(np.asarray, params),
                                      config)
    ref_eng = ref_inference.InferenceEngine(params, ref_config, **ENGINE_KW)
    rid = ref_eng.submit(list(PROMPT), ref_inference.SamplingParams(
        temperature=0.0, max_new_tokens=64))
    greedy = ref_eng.run_to_completion()[rid]
    return ref_config, params, config, tparams, greedy


class _AioServer:
    """The reference's aiohttp app on an event loop of its own thread."""

    def __init__(self, app):
        from aiohttp import web
        self.loop = asyncio.new_event_loop()
        self.runner = web.AppRunner(app)
        self.loop.run_until_complete(self.runner.setup())
        site = web.TCPSite(self.runner, '127.0.0.1', 0)
        self.loop.run_until_complete(site.start())
        self.port = site._server.sockets[0].getsockname()[1]  # noqa: SLF001
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(),
                                         self.loop).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


class _StdServer:
    def __init__(self, holder):
        self.srv = port_server.create_server(holder, host='127.0.0.1',
                                             port=0)
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       kwargs={'poll_interval': 0.05},
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(10)


class _Engines:
    """Three engines of one package on the tiny weights, built once per
    module and lent to each scenario's fleet; a lent engine may have
    its steps slowed (so a drain lands mid-stream)."""

    def __init__(self, package, tiny):
        ref_config, params, config, tparams, _ = tiny
        self.package = package
        self.slow = set()
        self.engines = []
        for i in range(3):
            if package == 'ref':
                eng = ref_inference.InferenceEngine(params, ref_config,
                                                    **ENGINE_KW)
            else:
                eng = inference.InferenceEngine(tparams, config,
                                                device='cpu', **ENGINE_KW)
            step = eng.step

            def paced_step(step=step, i=i):
                if i in self.slow:
                    time.sleep(0.05)
                step()
            eng.step = paced_step
            self.engines.append(eng)

    def lend(self, names, slow=()):
        """{name: engine} for `names`, each engine idle; those in `slow`
        paced."""
        self.slow = {i for i, name in enumerate(names) if name in slow}
        for eng in self.engines:
            eng.abort_all()
        return dict(zip(names, self.engines))


@pytest.fixture(scope='module')
def engines(tiny):
    return {package: _Engines(package, tiny) for package in ('ref', 'port')}


class _Fleet:
    """Named replicas (lent engines behind servers) and one LB, of one
    package."""

    def __init__(self, engines, names, slow=(), policy='round_robin'):
        package = engines.package
        self.package = package
        self.engines = engines.lend(names, slow)
        self.holders, self.servers = {}, {}
        for name, eng in self.engines.items():
            if package == 'ref':
                self.holders[name] = {'loop': ref_server.EngineLoop(eng)}
                self.servers[name] = _AioServer(
                    ref_server.create_app(self.holders[name]))
            else:
                self.holders[name] = {'loop': port_server.EngineLoop(eng)}
                self.servers[name] = _StdServer(self.holders[name])
        self.urls = {n: f'http://127.0.0.1:{s.port}'
                     for n, s in self.servers.items()}
        lb_mod = ref_lb if package == 'ref' else port_lb
        self.obs = ref_obs if package == 'ref' else port_obs
        self.faults = ref_faults if package == 'ref' else port_faults
        self.lb = lb_mod.LoadBalancer(policy, honor_env_policy=False)
        self.lb_port = None

    def start(self, urls, pools=None):
        self.lb.set_replicas(urls, pools=pools)
        self.lb_port = self.lb.start()
        return f'http://127.0.0.1:{self.lb_port}'

    def close(self):
        if self.lb_port is not None:
            self.lb.stop()
        for server in self.servers.values():
            server.close()
        for holder in self.holders.values():
            holder['loop'].stop()


def _stream(base, prompt, max_new, on_token=None):
    """A streamed greedy /generate through `base`: (tokens, done tokens,
    the kinds of frame seen)."""
    req = urllib.request.Request(
        base + '/generate', headers={'Content-Type': 'application/json'},
        data=json.dumps({'prompt_tokens': prompt, 'max_new_tokens': max_new,
                         'temperature': 0.0, 'stream': True}).encode())
    got, done, kinds = [], None, set()
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200
        for line in resp:
            line = line.strip()
            if not line.startswith(b'data: '):
                continue
            doc = json.loads(line[6:])
            kinds.update(doc)
            if 'token' in doc:
                got.append(doc['token'])
                if on_token is not None:
                    on_token(len(got))
            elif 'done' in doc:
                done = doc['tokens']
    return got, done, kinds


def _generate(base, prompt, max_new):
    req = urllib.request.Request(
        base + '/generate', headers={'Content-Type': 'application/json'},
        data=json.dumps({'prompt_tokens': prompt, 'max_new_tokens': max_new,
                         'temperature': 0.0}).encode())
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())['tokens']


def _drain(url):
    req = urllib.request.Request(url + '/internal/drain?deadline=0',
                                 data=b'{}', method='POST')
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _stats_keys(base):
    with urllib.request.urlopen(base + '/internal/stats', timeout=30) as r:
        doc = json.loads(r.read())
    return {'top': sorted(doc), 'routing': sorted(doc['routing']),
            'affinity': sorted(doc['routing']['affinity']),
            'engine': sorted(doc['engine']),
            'breakers': sorted(doc['breakers'].values()),
            'candidates': doc['candidates']}


def _scenario(engines, case):
    """One case through one package's fleet: (client results, counter
    deltas, /internal/stats keys, per-replica admissions)."""
    slow = ('general',) if case == 'drain' else ()
    names = {'handoff': ('prefill', 'decode', 'general'),
             'fallback': ('prefill', 'decode'),
             'drain': ('general', 'spare'),
             'dead': ('general',)}[case]
    fleet = _Fleet(engines, names, slow)
    admitted0 = {n: e._next_id for n, e in fleet.engines.items()}
    try:
        urls = fleet.urls
        if case in ('handoff', 'fallback'):
            base = fleet.start(list(urls.values()),
                               pools={u: n for n, u in urls.items()})
        elif case == 'drain':
            base = fleet.start([urls['general'], urls['spare']])
        else:
            dead = 'http://127.0.0.1:9'   # nothing listens there
            base = fleet.start([dead, urls['general']])
        if case == 'fallback':
            fleet.faults.arm('lb.handoff', times=1, exc=OSError('chaos'))
        before = _counters(fleet.obs)
        if case == 'dead':
            # Round robin puts the dead replica first on every other
            # request: the third such request opens its circuit.
            results = [_generate(base, PROMPT, 6) for _ in range(6)]
        elif case == 'drain':
            drained = {}
            drainer = []

            def on_token(n):
                if n == 2:
                    drainer.append(threading.Thread(
                        target=lambda: drained.update(
                            _drain(urls['general']))))
                    drainer[0].start()
            results = _stream(base, PROMPT, 64, on_token)
            # The stream can end (migrated) before the drain's own
            # answer reaches its caller.
            drainer[0].join(30)
            assert drained.get('status') == 'drained', drained
        else:
            results = _stream(base, PROMPT, STEPS)
        # The abandon (a background call) lands before the counts.
        deadline = time.time() + 5
        while time.time() < deadline and any(
                e.has_work for e in fleet.engines.values()):
            time.sleep(0.05)
        deltas = _deltas(before, _counters(fleet.obs))
        admitted = {n: e._next_id - admitted0[n]
                    for n, e in fleet.engines.items()}
        busy = {n: e.has_work for n, e in fleet.engines.items()}
        return results, deltas, _stats_keys(base), admitted, busy
    finally:
        fleet.close()


@pytest.mark.parametrize('case', ['handoff', 'fallback', 'drain', 'dead'])
def test_lb_end_to_end_matches_reference(tiny, engines, case):
    greedy = tiny[-1]
    ref = _scenario(engines['ref'], case)
    port = _scenario(engines['port'], case)
    assert port[0] == ref[0]
    assert port[1] == ref[1], (port[1], ref[1])
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    assert not any(port[4].values()), port[4]
    if case == 'dead':
        assert port[0] == [greedy[:6]] * 6
        assert port[1][('CIRCUIT_OPEN', None, 'lb')] == 1
        assert 'LB_NO_REPLICA' not in port[1]
        return
    got, done, kinds = port[0]
    want = greedy[:len(got)]
    assert got == done == want and len(got) == (64 if case == 'drain'
                                                else STEPS)
    assert kinds <= {'token', 'done', 'tokens'}, kinds
    counts = port[1]
    if case == 'handoff':
        assert counts['HANDOFF_ATTEMPTS'] == counts['HANDOFF_SUCCESSES'] == 1
        # The decode replica took the leg; the general one never saw it.
        assert port[3] == {'prefill': 1, 'decode': 1, 'general': 0}
    elif case == 'fallback':
        assert counts['HANDOFF_FALLBACKS'] == 1
        assert 'HANDOFF_SUCCESSES' not in counts
        assert port[3] == {'prefill': 1, 'decode': 0}
    else:
        assert counts['MIGRATION_SUCCESSES'] == 1
        assert 'LB_MIDSTREAM_FAILURES' not in counts


def test_no_ready_replica_is_503_with_retry_after():
    lb = port_lb.LoadBalancer('least_load')
    port = lb.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f'http://127.0.0.1:{port}/generate',
                                   data=b'{}', timeout=30)
        assert err.value.code == 503
        assert err.value.headers['Retry-After'] == '1'
        assert err.value.headers['X-Trace-ID']
    finally:
        lb.stop()


def test_handoff_header_and_traceparent_are_lb_owned():
    """An inbound X-SkyTPU-Handoff and traceparent never reach the
    replica: the LB strips both and sets its own traceparent, the
    leg's."""
    import http.server
    seen = []

    class Echo(http.server.BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            seen.append(dict(self.headers))
            self.rfile.read(int(self.headers['Content-Length']))
            body = b'{}'
            self.send_response(200)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    upstream = http.server.HTTPServer(('127.0.0.1', 0), Echo)
    thread = threading.Thread(target=upstream.serve_forever, daemon=True)
    thread.start()
    lb = port_lb.LoadBalancer('least_load')
    lb.set_replicas([f'http://127.0.0.1:{upstream.server_address[1]}'])
    port = lb.start()
    try:
        inbound = '00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01'
        req = urllib.request.Request(
            f'http://127.0.0.1:{port}/generate', data=b'{"x": 1}',
            headers={'X-SkyTPU-Handoff': '1', 'traceparent': inbound,
                     'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.read() == b'{}'
            trace_id = resp.headers['X-Trace-ID']
    finally:
        lb.stop()
        upstream.shutdown()
        upstream.server_close()
    headers = {k.lower(): v for k, v in seen[0].items()}
    assert 'x-skytpu-handoff' not in headers
    # The caller's trace is joined; the replica parents on the leg.
    assert headers['traceparent'].split('-')[1] == inbound.split('-')[1]
    assert headers['traceparent'].split('-')[2] != inbound.split('-')[2]
    assert trace_id == inbound.split('-')[1]


# -- concurrency ---------------------------------------------------------------

@pytest.mark.parametrize('policy', ['round_robin', 'least_load',
                                    'prefix_affinity'])
def test_concurrent_streams_and_clients_leaving(tiny, engines, policy,
                                                monkeypatch):
    """Eight streamed clients at once through the port's LB in front of
    two replicas, three of them closing after their second token: every
    stream that stays is whole, every leg's in-flight count returns to
    0, and stop() leaves no thread of the LB behind (its sampler's
    among them)."""
    monkeypatch.setenv('SKYTPU_TS_SAMPLE_SECONDS', '0.5')
    _, _, config, tparams, greedy = tiny
    before = set(threading.enumerate())
    fleet = _Fleet(engines['port'], ('r0', 'r1'), policy=policy)
    base = fleet.start(list(fleet.urls.values()))
    results, errors = {}, []

    def client(i):
        try:
            req = urllib.request.Request(
                base + '/generate',
                headers={'Content-Type': 'application/json'},
                data=json.dumps({'prompt_tokens': PROMPT,
                                 'max_new_tokens': 40, 'temperature': 0.0,
                                 'stream': True}).encode())
            got = []
            with urllib.request.urlopen(req, timeout=120) as resp:
                for line in resp:
                    line = line.strip()
                    if line.startswith(b'data: '):
                        doc = json.loads(line[6:])
                        if 'token' in doc:
                            got.append(doc['token'])
                            if i < 3 and len(got) == 2:
                                break  # the client leaves mid-stream
            results[i] = got
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert not errors, errors
    for i, got in results.items():
        assert got == greedy[:2 if i < 3 else 40], i
    deadline = time.time() + 10
    while time.time() < deadline and any(
            fleet.lb.policy.stats().get('in_flight', {}).values()):
        time.sleep(0.05)
    assert not any(fleet.lb.policy.stats().get('in_flight', {}).values())
    fleet.lb.stop()
    fleet.lb_port = None
    lb_threads = [t for t in set(threading.enumerate()) - before
                  if t.name.startswith(('skytpu-lb', 'skytpu-ts',
                                        'skytpu-watchdog'))
                  or 'process_request_thread' in t.name]
    assert not lb_threads, lb_threads
    # The replicas freed every slot, the abandoned ones too.
    deadline = time.time() + 10
    while time.time() < deadline and any(
            e.has_work for e in fleet.engines.values()):
        time.sleep(0.05)
    assert not any(e.has_work for e in fleet.engines.values())
    fleet.close()


def test_stop_cuts_a_wedged_stream_without_migrating():
    """A stream whose upstream sends headers and then nothing: stop()
    ends the leg (no migration is attempted) and joins the connection
    thread."""
    import http.server
    release = threading.Event()

    class Wedged(http.server.BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            self.rfile.read(int(self.headers['Content-Length']))
            self.send_response(200)
            self.send_header('Content-Type', 'text/event-stream')
            self.send_header('X-SkyTPU-Migration-Key', 'k')
            self.end_headers()
            self.wfile.write(b'data: {"token": 1}\n\n')
            self.wfile.flush()
            release.wait(30)

        def log_message(self, *args):
            pass

    upstream = http.server.ThreadingHTTPServer(('127.0.0.1', 0), Wedged)
    upstream.daemon_threads = True
    threading.Thread(target=upstream.serve_forever, daemon=True).start()
    lb = port_lb.LoadBalancer('least_load')
    lb.set_replicas([f'http://127.0.0.1:{upstream.server_address[1]}'])
    port = lb.start()
    attempts = port_obs.MIGRATION_ATTEMPTS.value()
    first = threading.Event()

    def client():
        req = urllib.request.Request(
            f'http://127.0.0.1:{port}/generate',
            headers={'Content-Type': 'application/json'},
            data=json.dumps({'prompt_tokens': [1, 2], 'stream': True,
                             'max_new_tokens': 9}).encode())
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                resp.readline()
                first.set()
                resp.read()
        except Exception:  # noqa: BLE001 — the cut is the point
            pass

    thread = threading.Thread(target=client)
    thread.start()
    assert first.wait(30)
    t0 = time.monotonic()
    lb.stop()
    assert time.monotonic() - t0 < 5
    thread.join(10)
    assert not thread.is_alive()
    release.set()
    upstream.shutdown()
    upstream.server_close()
    assert port_obs.MIGRATION_ATTEMPTS.value() == attempts


@pytest.mark.parametrize('payload', [
    {'handoff': {'snapshot': base64.b64encode(bytes(range(256)) * 3
                                              ).decode(), 'sent': 3}},
    {'migrate': {'snapshot': '', 'sent': 0}},
    {'handoff': {'sent': 1, 'snapshot': 'QQ=='}},
    {'migrate': {'snapshot': 'QQ==', 'sent': 2, 'extra': 1}},
    {'token': 5}, {'done': True, 'tokens': [1, 2]}, {'error': 'x'}])
def test_server_frames_are_json_dumps_byte_for_byte(payload):
    """The server's frames, snapshot frames among them, are json.dumps's
    byte for byte, so either package's LB reads the frame it always
    read."""
    frame = port_server._sse(payload)
    assert frame == f'data: {json.dumps(payload)}\n\n'.encode()
    assert port_lb._sse_frame_doc(frame[:-2]) == \
        ref_lb._sse_frame_doc(frame[:-2]) == payload
