"""The port's `service:` spec, autoscalers, circuit breaker and routing
policies against the reference's, on the CPU.

- Spec: every `service:` section in the repo (`examples/` and `llm/`,
  read with PyYAML here only), the pooled spec of the reference's pool
  tests and a table of invalid sections parse, round-trip and fail the
  same way in both packages: the same fields, the same
  `to_yaml_config`, the same exception class and message.
- Autoscalers: the same decisions over grids of (qps, ready, total,
  signals) on a fake clock (hysteresis delays, the spot / on-demand
  fallback mix, each pool's signals) and the same `MetricsSignalSource`
  readings from histogram deltas (a p95 past the top bucket included)
  and pool gauges before the fleet-wide ones.
- Breaker: one seeded sequence of allow / record_success /
  record_failure / forget on a fake clock gives the same answers,
  states, on_open calls and CIRCUIT_* readings.
- Policies: for each policy one seeded sequence of set_replicas,
  select, on_request_start and on_request_end on a fake clock gives the
  same choices, the same stats() and the same LB_AFFINITY_* deltas,
  the hot-family bound and the LRU cap among them.
"""
import copy
import dataclasses
import glob
import os

import numpy as np
import pytest
import yaml

from skypilot_tpu.observability import instruments as ref_obs
from skypilot_tpu.observability import timeseries as ref_ts
from skypilot_tpu.resilience import circuit as ref_circuit
from skypilot_tpu.serve import autoscalers as ref_autoscalers
from skypilot_tpu.serve import load_balancing_policies as ref_policies
from skypilot_tpu.serve import service_spec as ref_spec
from skypilot_tpu_torch.observability import instruments as port_obs
from skypilot_tpu_torch.observability import timeseries as port_ts
from skypilot_tpu_torch.resilience import circuit as port_circuit
from skypilot_tpu_torch.serve import autoscalers as port_autoscalers
from skypilot_tpu_torch.serve import load_balancing_policies as port_policies
from skypilot_tpu_torch.serve import service_spec as port_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _service_section(path):
    """The `service:` section of a task YAML (any document of it), or
    None."""
    with open(os.path.join(REPO, path)) as f:
        for doc in yaml.safe_load_all(f):
            if isinstance(doc, dict) and 'service' in doc:
                return doc['service']
    return None


SERVICE_FILES = sorted(
    os.path.relpath(p, REPO)
    for pattern in ('examples/*.yaml', 'llm/*.yaml')
    for p in glob.glob(os.path.join(REPO, pattern))
    if _service_section(os.path.relpath(p, REPO)) is not None)

# The reference's pooled spec (tests/unit/test_serve_pools.py:19).
POOLED = {
    'readiness_probe': '/health',
    'load_balancing_policy': 'prefix_affinity',
    'pools': {
        'prefill': {'role': 'prefill', 'min_replicas': 2,
                    'max_replicas': 4,
                    'target_queue_per_replica': 4.0,
                    'ttft_p95_upscale_threshold': 2.0,
                    'upscale_delay_seconds': 0,
                    'downscale_delay_seconds': 0},
        'decode': {'role': 'decode', 'min_replicas': 3,
                   'max_replicas': 6,
                   'target_queue_per_replica': 4.0,
                   'kv_util_upscale_threshold': 0.85,
                   'decode_step_p95_upscale_threshold': 0.3,
                   'upscale_delay_seconds': 0,
                   'downscale_delay_seconds': 0},
    },
}


def _parse(pkg, cfg):
    """(spec or None, (exception class name, message) or None)."""
    try:
        return pkg.ServiceSpec.from_yaml_config(copy.deepcopy(cfg)), None
    except Exception as e:  # noqa: BLE001 — compared across packages
        return None, (type(e).__name__, str(e))


def _fields(spec):
    return dataclasses.asdict(spec)


def _without_delays(cfg):
    """A poolless spec's to_yaml_config without the delays the port
    writes and the reference drops (ROADMAP Queue 3)."""
    cfg = copy.deepcopy(cfg)
    for key in ('upscale_delay_seconds', 'downscale_delay_seconds'):
        cfg.get('replica_policy', {}).pop(key, None)
    return cfg


# -- the spec ----------------------------------------------------------------

def test_every_service_section_in_the_repo_is_found():
    assert len(SERVICE_FILES) == 20, SERVICE_FILES
    assert {'examples/serve_llama.yaml',
            'examples/spot_serve.yaml'} <= set(SERVICE_FILES)


@pytest.mark.parametrize('path', SERVICE_FILES + ['pooled'])
def test_spec_parses_and_round_trips_as_reference(path):
    cfg = POOLED if path == 'pooled' else _service_section(path)
    ref, ref_err = _parse(ref_spec, cfg)
    port, port_err = _parse(port_spec, cfg)
    assert ref_err is None and port_err is None, (ref_err, port_err)
    assert _fields(port) == _fields(ref)
    assert _without_delays(port.to_yaml_config()) == ref.to_yaml_config()
    again, _ = _parse(port_spec, port.to_yaml_config())
    assert _fields(again) == _fields(port)
    assert type(port_autoscalers.make_autoscaler(port)).__name__ == \
        type(ref_autoscalers.make_autoscaler(ref)).__name__


INVALID = {
    # tests/unit/test_serve_pools.py:64-80
    'pools_and_replica_policy': {**POOLED,
                                 'replica_policy': {'min_replicas': 1}},
    'bad_role': {'readiness_probe': '/',
                 'pools': {'x': {'role': 'training'}}},
    'pool_max_below_min': {'readiness_probe': '/',
                           'pools': {'x': {'min_replicas': 3,
                                           'max_replicas': 1}}},
    # the schema's other shapes
    'no_probe': {},
    'probe_not_str_or_dict': {'readiness_probe': 5},
    'probe_unknown_key': {'readiness_probe': {'foo': 1}},
    'probe_bad_types': {'readiness_probe': {'path': 5,
                                            'timeout_seconds': 'x'}},
    'unknown_keys_and_bool_int': {'readiness_probe': '/', 'replicas': True,
                                  'bogus': 1, 'zzz': 2},
    'policy_types': {'readiness_probe': '/', 'replica_policy': {
        'min_replicas': 1.5, 'spot_zones': ['a', 3], 'use_spot': 1}},
    'unknown_lb_policy': {'readiness_probe': '/',
                          'load_balancing_policy': 'random'},
    'pools_mixed_errors': {'readiness_probe': '/', 'pools': {
        'a': {'role': 'x', 'foo': 1}, 'b': 3}},
    'pools_not_dict': {'readiness_probe': '/', 'pools': 'x'},
    'post_data_type': {'readiness_probe': {'path': '/', 'post_data': 5}},
    'not_a_dict': [1],
    # ServiceSpec's own checks
    'max_below_min': {'readiness_probe': '/', 'replica_policy': {
        'min_replicas': 2, 'max_replicas': 1}},
    'autoscale_without_qps': {'readiness_probe': '/', 'replica_policy': {
        'min_replicas': 1, 'max_replicas': 3}},
    'fallback_without_spot': {'readiness_probe': '/', 'replica_policy': {
        'base_ondemand_fallback_replicas': 1}},
    'no_pools': {'readiness_probe': '/', 'pools': {}},
    'pool_mins_zero': {'readiness_probe': '/',
                       'pools': {'a': {'min_replicas': 0}}},
    'pool_min_negative': {'readiness_probe': '/',
                          'pools': {'a': {'min_replicas': -1}}},
    'pools_and_replicas': {'readiness_probe': '/', 'pools': {'a': {}},
                           'replicas': 2},
}


@pytest.mark.parametrize('name', sorted(INVALID))
def test_invalid_section_raises_as_reference(name):
    _, ref_err = _parse(ref_spec, INVALID[name])
    _, port_err = _parse(port_spec, INVALID[name])
    assert ref_err is not None
    assert port_err == ref_err


def test_poolless_round_trip_keeps_the_delays():
    """The reference's poolless to_yaml_config drops the hysteresis
    delays, so its round trip resets them to the defaults; the port's
    keeps them (ROADMAP Queue 3)."""
    cfg = {'readiness_probe': '/', 'replica_policy': {
        'min_replicas': 1, 'max_replicas': 3, 'target_qps_per_replica': 2,
        'upscale_delay_seconds': 120, 'downscale_delay_seconds': 600}}
    ref, _ = _parse(ref_spec, cfg)
    ref_again, _ = _parse(ref_spec, ref.to_yaml_config())
    assert (ref_again.upscale_delay_seconds,
            ref_again.downscale_delay_seconds) == (300, 1200)
    port, _ = _parse(port_spec, cfg)
    again, _ = _parse(port_spec, port.to_yaml_config())
    assert (again.upscale_delay_seconds,
            again.downscale_delay_seconds) == (120, 600)
    assert _fields(again) == _fields(port)


def test_integral_float_is_an_integer_in_both():
    cfg = {'readiness_probe': '/', 'replica_port': 8080.0}
    ref, _ = _parse(ref_spec, cfg)
    port, _ = _parse(port_spec, cfg)
    assert ref is not None and _fields(port) == _fields(ref)


# -- autoscalers ---------------------------------------------------------------

class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _signals(pkg, rng):
    if rng.random() < 0.2:
        return None
    pick = lambda values: values[rng.integers(len(values))]  # noqa: E731
    return pkg.LoadSignals(
        queue_depth=pick([None, 0.0, 3.0, 9.0, 40.0]),
        kv_util=pick([None, 0.1, 0.84, 0.86, 0.99]),
        ttft_p95=pick([None, 0.5, 2.0, 3.0]),
        decode_step_p95=pick([None, 0.05, 0.3, 0.5]))


def _decision(d):
    return dataclasses.asdict(d)


SCALING_SPECS = {
    'request_rate': {'readiness_probe': '/', 'replica_policy': {
        'min_replicas': 1, 'max_replicas': 5, 'target_qps_per_replica': 2,
        'upscale_delay_seconds': 10, 'downscale_delay_seconds': 20,
        'target_queue_per_replica': 4, 'kv_util_upscale_threshold': 0.85}},
    'request_rate_unbounded': {'readiness_probe': '/', 'replica_policy': {
        'min_replicas': 2, 'target_qps_per_replica': 1.5}},
    'fixed': {'readiness_probe': '/', 'replicas': 3},
    'fallback': {'readiness_probe': '/', 'replica_policy': {
        'min_replicas': 2, 'max_replicas': 6, 'target_qps_per_replica': 1,
        'use_spot': True, 'base_ondemand_fallback_replicas': 1,
        'dynamic_ondemand_fallback': True, 'upscale_delay_seconds': 5,
        'downscale_delay_seconds': 15}},
    'fallback_static': {'readiness_probe': '/', 'replica_policy': {
        'min_replicas': 1, 'max_replicas': 4, 'target_qps_per_replica': 2,
        'use_spot': True, 'base_ondemand_fallback_replicas': 2,
        'upscale_delay_seconds': 0, 'downscale_delay_seconds': 0}},
}


@pytest.mark.parametrize('name', sorted(SCALING_SPECS))
def test_autoscaler_decisions_match_reference(name):
    clocks = {'ref': _Clock(), 'port': _Clock()}
    scalers = {}
    for key, spec_mod, mod in (('ref', ref_spec, ref_autoscalers),
                               ('port', port_spec, port_autoscalers)):
        spec = spec_mod.ServiceSpec.from_yaml_config(
            copy.deepcopy(SCALING_SPECS[name]))
        scalers[key] = (mod, mod.make_autoscaler(spec, now_fn=clocks[key]))
    assert type(scalers['port'][1]).__name__ == \
        type(scalers['ref'][1]).__name__
    rng = {key: np.random.default_rng(17) for key in scalers}
    for _ in range(200):
        out = {}
        for key, (mod, scaler) in scalers.items():
            r = rng[key]
            clocks[key].t += float(r.choice([0.0, 3.0, 6.0, 11.0]))
            qps = [None, 0.0, 1.5, 4.0, 9.0, 30.0][r.integers(6)]
            total = int(r.integers(0, 8))
            ready = int(r.integers(0, total + 1))
            signals = _signals(mod, r)
            if hasattr(scaler, 'decide_mixed'):
                ondemand = int(r.integers(0, 4))
                out[key] = _decision(scaler.decide_mixed(
                    ready, total, ondemand, qps, signals))
            else:
                out[key] = _decision(scaler.decide(ready, total, qps,
                                                   signals))
        assert out['port'] == out['ref']


def test_pool_autoscalers_match_reference():
    clocks = {'ref': _Clock(), 'port': _Clock()}
    pools = {}
    for key, spec_mod, mod in (('ref', ref_spec, ref_autoscalers),
                               ('port', port_spec, port_autoscalers)):
        spec = spec_mod.ServiceSpec.from_yaml_config(copy.deepcopy(POOLED))
        pools[key] = (mod, mod.make_pool_autoscalers(spec,
                                                     now_fn=clocks[key]))
    assert sorted(pools['port'][1]) == sorted(pools['ref'][1]) == [
        'decode', 'prefill']
    rng = {key: np.random.default_rng(5) for key in pools}
    for _ in range(150):
        out = {}
        for key, (mod, scalers) in pools.items():
            r = rng[key]
            clocks[key].t += float(r.choice([0.0, 1.0, 4.0]))
            qps = [None, 0.0, 2.0, 12.0][r.integers(4)]
            signals = _signals(mod, r)
            out[key] = {name: _decision(scalers[name].decide(
                int(r.integers(0, 4)), int(r.integers(2, 7)), qps,
                signals)) for name in sorted(scalers)}
        assert out['port'] == out['ref']
    # The reference's own pool cases (test_serve_pools.py:123-194).
    port = pools['port'][1]
    assert port['decode'].decide(3, 3, 0.0, port_autoscalers.LoadSignals(
        queue_depth=20.0)).target_replicas == 5
    assert port['decode'].decide(3, 3, 0.0, port_autoscalers.LoadSignals(
        decode_step_p95=0.5, kv_util=0.9)).target_replicas == 5
    assert port['decode'].decide(3, 3, 0.0, port_autoscalers.LoadSignals(
        queue_depth=1000.0)).target_replicas == 6
    assert port['prefill'].decide(2, 2, 0.0, port_autoscalers.LoadSignals(
        ttft_p95=3.0)).target_replicas == 3


def _source_readings(obs, ts, autoscalers, observations, pool_gauge):
    """Two read_pools() calls around `observations` (seconds observed
    into skytpu_prefill_seconds and skytpu_decode_step_seconds), on a
    store of its own and a fake clock; then a third with none."""
    clock = _Clock(500.0)
    src = autoscalers.MetricsSignalSource(store=ts.TimeSeriesStore(),
                                          now_fn=clock)
    src.read_pools(['prefill', 'decode'])  # baseline
    for ttft, step in observations:
        obs.PREFILL_SECONDS.observe(ttft)
        obs.DECODE_STEP_SECONDS.observe(step)
    obs.QUEUE_DEPTH.set(7.0)
    obs.KV_CACHE_UTILIZATION.set(0.4)
    obs.POOL_QUEUE_DEPTH.labels(pool=pool_gauge).set(3.0)
    obs.POOL_KV_UTILIZATION.labels(pool=pool_gauge).set(0.9)
    clock.t += 10.0
    second = src.read_pools(['prefill', 'decode', 'never_written'])
    clock.t += 10.0
    third = src.read_pools(['decode'])
    return ({k: dataclasses.asdict(v) for k, v in second.items()},
            {k: dataclasses.asdict(v) for k, v in third.items()})


@pytest.mark.parametrize('case', ['spread', 'past_top_bucket', 'too_few'])
def test_metrics_signal_source_matches_reference(case):
    rng = np.random.default_rng(3)
    observations = {
        'spread': [(float(t), float(s)) for t, s in zip(
            rng.exponential(0.3, 100), rng.exponential(0.02, 100))],
        # Past the top finite bucket: the top bound, never None.
        'past_top_bucket': [(500.0, 90.0)] * 20,
        # Under the 5-sample floor: no p95 at all.
        'too_few': [(0.2, 0.01)] * 4,
    }[case]
    pool = f'prefill_{case}'
    ref = _source_readings(ref_obs, ref_ts, ref_autoscalers, observations,
                           pool)
    port = _source_readings(port_obs, port_ts, port_autoscalers,
                            observations, pool)
    assert port == ref
    second, third = port
    if case == 'past_top_bucket':
        assert second['decode']['ttft_p95'] is not None
    # Pool gauges win where written; the fleet-wide ones elsewhere.
    assert third['decode']['ttft_p95'] is None


# -- the circuit breaker -----------------------------------------------------

def _breaker_run(circuit_mod, obs, name, seed):
    clock = _Clock(0.0)
    opened = []
    breaker = circuit_mod.CircuitBreaker(
        name, failure_threshold=3, recovery_timeout=15.0,
        half_open_max_calls=1, now_fn=clock, on_open=opened.append)
    targets = ['a', 'b', 'c']
    before = {t: obs.CIRCUIT_OPEN.labels(breaker=name, target=t).value()
              for t in targets}
    rng = np.random.default_rng(seed)
    trace = []
    for _ in range(400):
        clock.t += float(rng.choice([0.0, 1.0, 4.0, 16.0]))
        target = targets[rng.integers(3)]
        op = ['allow', 'allow', 'success', 'failure', 'failure',
              'failure', 'forget', 'snapshot'][rng.integers(8)]
        if op == 'allow':
            got = breaker.allow(target)
        elif op == 'success':
            got = breaker.record_success(target)
        elif op == 'failure':
            got = breaker.record_failure(target)
        elif op == 'forget':
            got = breaker.forget(target)
        else:
            got = {k: int(v) for k, v in breaker.snapshot().items()}
        trace.append((op, target, got, int(breaker.state(target)),
                      obs.CIRCUIT_STATE.labels(breaker=name,
                                               target=target).value()))
    deltas = {t: obs.CIRCUIT_OPEN.labels(breaker=name, target=t).value()
              - before[t] for t in targets}
    return trace, opened, deltas


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_circuit_breaker_matches_reference(seed):
    ref = _breaker_run(ref_circuit, ref_obs, f'parity{seed}', seed)
    port = _breaker_run(port_circuit, port_obs, f'parity{seed}', seed)
    assert port == ref
    trace, opened, deltas = port
    assert opened and sum(deltas.values()) == len(opened)
    assert {op for op, _, got, _, _ in trace if op == 'allow' and
            got is False}  # some calls were refused while open


def test_circuit_breaker_argument_checks_match_reference():
    for kw in ({'failure_threshold': 0}, {'recovery_timeout': -1}):
        with pytest.raises(ValueError) as ref_err:
            ref_circuit.CircuitBreaker('x', **kw)
        with pytest.raises(ValueError) as port_err:
            port_circuit.CircuitBreaker('x', **kw)
        assert str(port_err.value) == str(ref_err.value)


# -- routing policies ----------------------------------------------------------

URLS = ['http://r0', 'http://r1', 'http://r2', 'http://r3']


def _family(fid, length):
    return [fid * 1000 + (i % 97) for i in range(length)]


def _policy_run(policies_mod, obs, name, seed):
    clock = _Clock(0.0)
    policy = policies_mod.make_policy(name, now_fn=clock)
    counters = ('LB_AFFINITY_HITS', 'LB_AFFINITY_MISSES',
                'LB_AFFINITY_FALLBACKS')
    before = {c: getattr(obs, c).value() for c in counters}
    rng = np.random.default_rng(seed)
    policy.set_replicas(URLS[:3])
    live = []  # started, not ended
    trace = []
    for step in range(300):
        clock.t += float(rng.choice([0.0, 0.2, 0.7, 1.5]))
        op = rng.integers(10)
        if op == 0:
            urls = [u for u in URLS if rng.random() < 0.8] or URLS[:1]
            policy.set_replicas(urls)
            trace.append(('set', urls))
            continue
        if op <= 2 and live:
            url = live.pop(int(rng.integers(len(live))))
            policy.on_request_end(url)
            trace.append(('end', url))
            continue
        # A hot family (0) most of the time, so the bound fires; many
        # cold ones so the LRU cap evicts; some string prompts and some
        # with no routable content.
        kind = rng.integers(10)
        if kind < 5:
            ctx = {'prompt_tokens': _family(0, 192) + [int(step)],
                   'max_new_tokens': 8}
        elif kind < 8:
            ctx = {'prompt_tokens': _family(int(rng.integers(1, 40)),
                                            int(rng.integers(40, 260))),
                   'max_new_tokens': 8}
        elif kind == 8:
            ctx = {'prompt': 'You are a helpful assistant. ' *
                   int(rng.integers(1, 8))}
        else:
            ctx = None
        candidates = None
        if rng.random() < 0.3:
            candidates = [u for u in policy.replicas
                          if rng.random() < 0.6] or None
        url = policy.select(context=ctx, candidates=candidates)
        trace.append(('select', url))
        if url is not None and rng.random() < 0.9:
            policy.on_request_start(url, context=ctx)
            live.append(url)
        trace.append(('stats', policy.stats()))
    deltas = {c: getattr(obs, c).value() - before[c] for c in counters}
    return trace, deltas


@pytest.mark.parametrize('name', ['round_robin', 'least_load',
                                  'prefix_affinity'])
@pytest.mark.parametrize('window', ['0', '1.0'])
def test_policy_choices_and_stats_match_reference(monkeypatch, name,
                                                  window):
    monkeypatch.setenv('SKYTPU_LB_AFFINITY_MAX_ENTRIES', '24')
    monkeypatch.setenv('SKYTPU_LB_AFFINITY_LOAD_WINDOW', window)
    # A tight bound, so a hot family outgrows its affine replica.
    monkeypatch.setenv('SKYTPU_LB_AFFINITY_BOUND', '1.0')
    ref = _policy_run(ref_policies, ref_obs, name, 11)
    port = _policy_run(port_policies, port_obs, name, 11)
    assert port == ref
    if name == 'prefix_affinity':
        trace, deltas = port
        assert deltas['LB_AFFINITY_HITS'] > 0
        assert deltas['LB_AFFINITY_FALLBACKS'] > 0  # the hot-family bound
        assert max(s['entries'] for op, s in trace if op == 'stats') == 24


def test_make_policy_errors_match_reference():
    with pytest.raises(ValueError) as ref_err:
        ref_policies.make_policy('power_of_two')
    with pytest.raises(ValueError) as port_err:
        port_policies.make_policy('power_of_two')
    assert str(port_err.value) == str(ref_err.value)
