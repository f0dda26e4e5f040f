"""Port parity: the observability plane (skypilot_tpu_torch.observability,
resilience.faults) against the reference's, and its wiring.

The pure modules run the same scripts through both packages' copies:
  - metrics: byte-identical `generate_text()` on fresh registries;
  - the catalog: names, types, label names and buckets;
  - spans: traceparent, `tree_view`, `to_chrome_trace`, the collector;
  - timeseries and watchdog: the same answers at the same virtual `now=`;
  - faults: the SKYTPU_FAULTS grammar, arm/hits/inject and their counter.
The engines (`tiny` in f32 on the CPU, the reference's weights through
`weights.from_jax_params`, one JAX engine geometry for the whole module
so its compiles are shared) run one request script: a cold request, a
warm prefix hit, a full-prompt match (a page copied on write), an
interleaved prompt and an abort, then a speculative pair. Every counter
delta and histogram count, the final gauges, and each request's engine
spans (names, parentage and attributes) are equal. The registries and
collectors are process-global, so everything is read as a delta or on a
fresh instance. The embedded server, `fit` and `load_params` are read
through the port alone.
"""
import dataclasses
import json
import math
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from skypilot_tpu import inference as ref_inference
from skypilot_tpu.checkpoints import hf_export as ref_hf_export
from skypilot_tpu.models import llama as ref_llama
from skypilot_tpu.observability import instruments as ref_obs
from skypilot_tpu.observability import metrics as ref_metrics
from skypilot_tpu.observability import spans as ref_spans
from skypilot_tpu.observability import timeseries as ref_ts
from skypilot_tpu.observability import watchdog as ref_wd
from skypilot_tpu.resilience import faults as ref_faults
from skypilot_tpu_torch import inference
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.checkpoints import hf_import
from skypilot_tpu_torch.inference import server as server_lib
from skypilot_tpu_torch.observability import instruments as port_obs
from skypilot_tpu_torch.observability import metrics as port_metrics
from skypilot_tpu_torch.observability import spans as port_spans
from skypilot_tpu_torch.observability import timeseries as port_ts
from skypilot_tpu_torch.observability import tracing as port_tracing
from skypilot_tpu_torch.observability import watchdog as port_wd
from skypilot_tpu_torch.resilience import faults as port_faults
from skypilot_tpu_torch.train import loop as train_loop
from skypilot_tpu_torch.train import trainer

PACKAGES = {'ref': (ref_metrics, ref_obs, ref_spans, ref_ts, ref_wd,
                    ref_faults),
            'port': (port_metrics, port_obs, port_spans, port_ts, port_wd,
                     port_faults)}


# -- metrics -----------------------------------------------------------------


def _metrics_script(metrics_mod, seed):
    """Seeded inc/set/observe calls with labels, exemplars and bulk
    observes on a fresh registry; returns its text exposition."""
    rng = np.random.default_rng(seed)
    reg = metrics_mod.Registry()
    c = metrics_mod.Counter('skytpu_t_total', 'A counter.',
                            labelnames=('plane', 'code'), registry=reg)
    c0 = metrics_mod.Counter('skytpu_t0_total', 'Labelless.', registry=reg)
    g = metrics_mod.Gauge('skytpu_t_gauge', 'A "gauge"\nwith escapes.',
                          labelnames=('pool',), registry=reg)
    h = metrics_mod.Histogram('skytpu_t_seconds', 'A histogram.',
                              labelnames=('plane',), registry=reg)
    hv = metrics_mod.Histogram('skytpu_t_tokens', 'Value buckets.',
                               buckets=(0.0, 1.0, 2.0, 4.0), registry=reg)
    for i in range(200):
        op = int(rng.integers(6))
        if op == 0:
            c.labels(plane=str(rng.choice(['a', 'b"q'])),
                     code=str(int(rng.integers(200, 205)))).inc(
                float(rng.integers(1, 4)))
        elif op == 1:
            c0.inc(float(rng.random()))
        elif op == 2:
            g.labels(pool=str(rng.choice(['x', 'y\\z']))).set(
                float(rng.normal()))
        elif op == 3:
            h.labels(plane='inference').observe(
                float(rng.exponential(0.05)),
                trace_id=f'{i:032x}' if rng.random() < 0.5 else None)
        elif op == 4:
            hv.observe_count(float(rng.integers(0, 6)),
                             int(rng.integers(0, 4)))
        else:
            g.labels(pool='x').inc(1.5)
    return reg, reg.generate_text()


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_generate_text_is_byte_identical(seed):
    ref_reg, ref_text = _metrics_script(ref_metrics, seed)
    port_reg, port_text = _metrics_script(port_metrics, seed)
    assert port_text == ref_text
    assert 'trace_id=' in port_text
    assert (port_metrics.exemplars_snapshot(port_reg)
            == ref_metrics.exemplars_snapshot(ref_reg))


def test_label_overflow_collapses_identically():
    texts = []
    for mod in (ref_metrics, port_metrics):
        reg = mod.Registry()
        c = mod.Counter('skytpu_churn_total', 'Churny labels.',
                        labelnames=('url',), registry=reg)
        for i in range(mod.MAX_LABEL_SETS + 25):
            c.labels(url=f'/u/{i}').inc()
        texts.append(reg.generate_text())
    assert port_metrics.MAX_LABEL_SETS == ref_metrics.MAX_LABEL_SETS
    assert texts[0] == texts[1]
    assert 'url="_overflow"} 25' in texts[1]


def test_metric_contract_errors_match():
    for mod in (ref_metrics, port_metrics):
        reg = mod.Registry()
        for bad in (lambda: mod.Counter('widgets_total', 'x', registry=reg),
                    lambda: mod.Counter('skytpu_a_total', ' ', registry=reg),
                    lambda: mod.Gauge('skytpu_g', 'x', labelnames=('A',),
                                      registry=reg),
                    lambda: mod.Histogram('skytpu_h', 'x',
                                          buckets=(2.0, 1.0), registry=reg)):
            with pytest.raises(ValueError):
                bad()
        c = mod.Counter('skytpu_ok_total', 'Fine.', registry=reg)
        with pytest.raises(ValueError):
            c.inc(-1)
        with pytest.raises(ValueError):
            mod.Counter('skytpu_ok_total', 'Again.', registry=reg)


def test_metrics_handler_returns_the_exposition():
    body, content_type = port_metrics.handler()
    assert content_type == ref_metrics.CONTENT_TYPE
    assert b'# TYPE skytpu_prefill_seconds histogram' in body


# -- the catalog -------------------------------------------------------------


def _instruments(obs_mod, metrics_mod):
    return {name: value for name, value in vars(obs_mod).items()
            if isinstance(value, metrics_mod.Metric)}


def test_catalog_matches_reference():
    port = _instruments(port_obs, port_metrics)
    ref = _instruments(ref_obs, ref_metrics)
    assert len(port) >= 37
    for name, m in port.items():
        want = ref[name]
        assert (m.name, m.type_name, m.labelnames, m.help) == (
            want.name, want.type_name, want.labelnames, want.help), name
        assert getattr(m, 'buckets', None) == getattr(want, 'buckets',
                                                      None), name
    assert port_obs._UNTRACED_PATHS == ref_obs._UNTRACED_PATHS


# Every instrument the reference's engine, server, train loop, hf_import,
# fault registry, watchdog, load balancer, routing policies, autoscalers
# and circuit breaker touch on the paths the port has.
REFERENCE_CALLS = (
    'PREFILL_SECONDS', 'DECODE_STEP_SECONDS', 'DECODE_HOST_STEPS',
    'DECODE_TOKENS_PER_STEP', 'SPEC_ROUNDS', 'SPEC_PROPOSED_TOKENS',
    'SPEC_ACCEPTED_TOKENS', 'SPEC_ACCEPTED_PER_ROUND', 'PROMPT_TOKENS',
    'GENERATED_TOKENS', 'BATCH_OCCUPANCY', 'BATCH_SLOTS_ACTIVE',
    'QUEUE_DEPTH', 'KV_CACHE_UTILIZATION', 'KV_PAGES_TOTAL',
    'KV_PAGES_FREE', 'KV_PAGES_PRIVATE', 'PREFIX_CACHE_HITS',
    'PREFIX_CACHE_MISSES', 'PREFIX_CACHE_REUSED_TOKENS',
    'PREFIX_CACHE_EVICTIONS', 'PREFIX_CACHE_PAGES', 'REQUESTS_FINISHED',
    'REQUESTS_ABORTED', 'HANDOFF_FALLBACKS', 'HTTP_REQUESTS',
    'HTTP_REQUEST_SECONDS', 'WATCHDOG_ALERTS', 'FAULTS_INJECTED',
    'TRAIN_STEP_SECONDS', 'TRAIN_TOKENS', 'TRAIN_STEP', 'TRAIN_MFU',
    'TRAIN_LOSS', 'CKPT_IMPORT_SECONDS', 'CKPT_IMPORT_BYTES',
    'CKPT_IMPORT_TENSORS', 'REQUESTS_SHED', 'CKPT_EXPORT_SECONDS',
    'CKPT_EXPORT_BYTES',
    # the serving data plane (serve/, resilience/circuit.py)
    'CIRCUIT_OPEN', 'CIRCUIT_STATE', 'HANDOFF_ATTEMPTS', 'HANDOFF_SUCCESSES',
    'HANDOFF_TRANSFER_SECONDS', 'LB_AFFINITY_ENTRIES',
    'LB_AFFINITY_FALLBACKS', 'LB_AFFINITY_HITS', 'LB_AFFINITY_MISSES',
    'LB_MIDSTREAM_FAILURES', 'LB_NO_REPLICA', 'LB_POOL_REQUESTS',
    'LB_PROXY_ERRORS', 'LB_REPLICA_REQUESTS', 'LB_UPSTREAM_RETRIES',
    'MIGRATION_ATTEMPTS', 'MIGRATION_FAILURES',
    'MIGRATION_INTERRUPTION_SECONDS', 'MIGRATION_SECONDS',
    'MIGRATION_SUCCESSES', 'POOL_KV_UTILIZATION', 'POOL_QUEUE_DEPTH')


def test_reference_call_sites_are_declared_in_the_port():
    port = _instruments(port_obs, port_metrics)
    assert set(REFERENCE_CALLS) <= set(port)
    # ... and the port's own modules touch nothing undeclared.
    import re
    import skypilot_tpu_torch
    root = skypilot_tpu_torch.__path__[0]
    used = set()
    for rel in ('inference/engine.py', 'inference/server.py',
                'inference/openai_api.py', 'train/loop.py',
                'checkpoints/hf_import.py', 'checkpoints/hf_export.py',
                'resilience/faults.py', 'observability/watchdog.py',
                'resilience/circuit.py', 'serve/load_balancer.py',
                'serve/load_balancing_policies.py',
                'serve/autoscalers.py'):
        used |= set(re.findall(r'\bobs\.([A-Z][A-Z_]+)\b',
                               open(f'{root}/{rel}').read()))
    assert used and used <= set(port)
    assert set(port_faults.registered_points()) == {
        'engine.snapshot', 'engine.handoff_lease', 'checkpoint.save',
        'lb.upstream', 'lb.upstream_midstream', 'lb.migrate', 'lb.handoff'}
    for point, text in port_faults.registered_points().items():
        assert point in ref_faults.registered_points()


# -- spans -------------------------------------------------------------------

TRACEPARENTS = (
    '00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01',
    '  00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-00 ',
    '00-00000000000000000000000000000000-b7ad6b7169203331-01',
    '00-0af7651916cd43dd8448eb211c80319c-0000000000000000-01',
    '00-0af7651916cd43dd8448eb211c80319c-b7ad6b716920333-01',
    'zz-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01',
    '00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331',
    '', None)


def test_traceparent_parse_and_format_match_reference():
    for value in TRACEPARENTS:
        got = port_spans.parse_traceparent(value)
        want = ref_spans.parse_traceparent(value)
        assert (got is None) == (want is None), value
        if got is not None:
            assert (got.trace_id, got.span_id) == (want.trace_id,
                                                   want.span_id)
            assert port_spans.format_traceparent(got) == \
                ref_spans.format_traceparent(want)
            assert port_spans.parse_traceparent(
                port_spans.format_traceparent(got)) == got
    ctx = port_spans.SpanContext(port_spans.new_trace_id(),
                                 port_spans.new_span_id())
    assert port_spans.parse_traceparent(
        port_spans.format_traceparent(ctx)) == ctx


def _span_records(spans_mod, seed):
    """A seeded forest of spans through a pinned collector: three
    traces, nested parents, an error, a late arrival."""
    rng = np.random.default_rng(seed)
    coll = spans_mod.SpanCollector(sample_rate=1.0, max_spans=1000,
                                   recorder_capacity=8, slow_seconds=99.0)
    for t in range(3):
        tid = f'{t + 1:032x}'
        coll.start_trace(tid)
        ids = [None]
        for k in range(int(rng.integers(2, 7))):
            sid = f'{t * 100 + k + 1:016x}'
            start = float(rng.random())
            coll.record_span(f'engine.p{k}', trace_id=tid, span_id=sid,
                             parent_id=ids[int(rng.integers(len(ids)))],
                             start=start, end=start + float(rng.random()),
                             attrs={'k': k},
                             status='error' if k == 3 else 'ok')
            ids.append(sid)
        coll.finish_trace(tid)
    coll.record_span('late', trace_id=f'{1:032x}', span_id='f' * 16,
                     parent_id=None, start=0.5, end=0.6)
    return coll


@pytest.mark.parametrize('seed', [0, 1])
def test_collector_tree_view_and_chrome_trace_match_reference(seed):
    port = _span_records(port_spans, seed)
    ref = _span_records(ref_spans, seed)
    assert port.recent_trees() == ref.recent_trees()
    assert port.span_count() == ref.span_count()
    for t in ref.recent_trees():
        recs = ref.spans_for(t['trace_id'])
        assert port.spans_for(t['trace_id']) == recs
        assert port_spans.tree_view(recs) == ref_spans.tree_view(recs)
        assert port_spans.to_chrome_trace(recs) == \
            ref_spans.to_chrome_trace(recs)


def test_sampling_eviction_and_flight_recorder_match_reference(tmp_path):
    import random
    out = []
    for mod in (ref_spans, port_spans):
        coll = mod.SpanCollector(sample_rate=0.5, max_spans=12,
                                 recorder_capacity=3, slow_seconds=0.75,
                                 rng=random.Random(4))
        for t in range(10):
            tid = f'{t + 1:032x}'
            for k in range(3):
                coll.record_span('s', trace_id=tid, span_id=f'{k + 1:016x}',
                                 start=0.0, end=0.25 * (t % 4) * (k + 1))
            coll.finish_trace(tid)
        path = mod.dump_flight_recorder(str(tmp_path / mod.__name__),
                                        'drill', collector=coll)
        doc = json.load(open(path))
        out.append(([t['trace_id'] for t in coll.recent_trees()],
                    coll.span_count(), coll.dropped_spans,
                    doc['trees'], doc['reason']))
    assert out[0] == out[1]


def test_span_scope_nests_and_marks_errors():
    coll = port_spans.SpanCollector(sample_rate=1.0, max_spans=100,
                                    recorder_capacity=4, slow_seconds=9.0)
    with port_spans.span('outer', collector=coll) as outer:
        with port_spans.span('inner', collector=coll) as inner:
            assert port_spans.current_context() == inner
        with pytest.raises(KeyError):
            with port_spans.span('fails', collector=coll):
                raise KeyError('x')
    assert port_spans.current_context() is None
    (tree,) = coll.recent_trees()
    assert tree['error'] is True and tree['trace_id'] == outer.trace_id
    by_name = {s['name']: s for s in tree['spans']}
    assert by_name['inner']['parent_id'] == outer.span_id
    assert by_name['fails']['status'] == 'error'
    assert by_name['outer']['parent_id'] is None


# -- time series and the watchdog -------------------------------------------


def _ts_script(mods, seed):
    """One registry, store and watchdog per package fed the same
    observations at the same virtual times."""
    metrics_mod, _, _, ts_mod, wd_mod, _ = mods
    rng = np.random.default_rng(seed)
    reg = metrics_mod.Registry()
    c = metrics_mod.Counter('skytpu_req_total', 'Requests.',
                            labelnames=('code',), registry=reg)
    hits = metrics_mod.Counter('skytpu_hit_total', 'Hits.', registry=reg)
    g = metrics_mod.Gauge('skytpu_free', 'Free.', registry=reg)
    h = metrics_mod.Histogram('skytpu_lat_seconds', 'Latency.',
                              registry=reg)
    store = ts_mod.TimeSeriesStore(capacity=50, max_series=16,
                                   registry=reg)
    rules = wd_mod.parse_rules(
        'p95(skytpu_lat_seconds) < 0.1 @ 20; '
        'ratio(skytpu_hit_total/skytpu_req_total) >= 0.5 @ 20; '
        'within(skytpu_free, 2, inf); anomaly(skytpu_lat_seconds)')
    clock = [1000.0]
    wd = wd_mod.Watchdog(rules=rules, store=store, now_fn=lambda: clock[0],
                         breach_ticks=2, clear_ticks=2, window=30.0,
                         dump_evidence=False)
    snaps = []
    for tick in range(40):
        clock[0] = 1000.0 + 2.0 * tick
        slow = 12 <= tick < 24         # a latency and hit-ratio incident
        for _ in range(int(rng.integers(1, 5))):
            c.labels(code=str(rng.choice(['200', '500']))).inc()
            if not slow or rng.random() < 0.2:
                hits.inc()
            h.observe(float(rng.exponential(0.3 if slow else 0.01)))
        g.set(float(rng.integers(0, 6)))
        store.sample_now(now=clock[0])
        wd.tick()
        snaps.append(wd.snapshot())
    now = clock[0]
    queries = [{'query': 'rate', 'metric': 'skytpu_req_total',
                'window': '30'},
               {'query': 'increase', 'metric': 'skytpu_req_total',
                'labels': 'code=500', 'window': '30'},
               {'query': 'gauge', 'metric': 'skytpu_free', 'window': '10'},
               {'query': 'quantile', 'metric': 'skytpu_lat_seconds',
                'q': '0.5', 'window': '60'},
               {'query': 'bogus', 'metric': 'x', 'window': '5'}]
    answers = [ts_mod.query_response(store, q) for q in queries]
    windowed = (store.counter_rate('skytpu_req_total', None, 30.0, now),
                store.hist_quantile('skytpu_lat_seconds', 0.95, None,
                                    40.0, now),
                store.hist_mean('skytpu_lat_seconds', None, 40.0, now),
                store.gauge_stats('skytpu_free', None, 10.0, now))
    dump = store.dump(since=now - 20)
    dump.pop('now')
    return answers, windowed, dump, store.stats(), snaps


@pytest.mark.parametrize('seed', [0, 1])
def test_timeseries_and_watchdog_match_reference(seed):
    ref = _ts_script(PACKAGES['ref'], seed)
    port = _ts_script(PACKAGES['port'], seed)
    assert port[:4] == ref[:4]
    assert port[4] == ref[4]
    events = port[4][-1]['events']
    assert {e['state'] for e in events} == {'fire', 'clear'}


def test_quantile_from_buckets_matches_reference():
    pairs = [(0.1, 2.0), (0.5, 7.0), (1.0, 9.0), (math.inf, 10.0)]
    for q in (0.0, 0.2, 0.7, 0.95, 1.0):
        assert port_ts.quantile_from_buckets(pairs, 10.0, q) == \
            ref_ts.quantile_from_buckets(pairs, 10.0, q)
    assert port_ts.quantile_from_buckets([], 0.0, 0.5) == math.inf


def test_series_cap_and_ingest_match_reference():
    out = []
    for mod in (ref_ts, port_ts):
        store = mod.TimeSeriesStore(capacity=3, max_series=4,
                                    registry=(ref_metrics if mod is ref_ts
                                              else port_metrics).Registry())
        for t in range(6):
            for j in range(t, t + 3):
                store.add_sample('skytpu_s', {'j': str(j)}, float(t),
                                 now=float(t))
        doc = store.dump()
        doc.pop('now')
        other = mod.TimeSeriesStore(capacity=3, max_series=8)
        other.ingest_dump(doc, extra_labels={'replica': 'r1'})
        got = other.dump()
        got.pop('now')
        out.append((doc, store.stats(), got))
    assert out[0] == out[1]


RULE_SPECS = (
    'p95(skytpu_prefill_seconds)<0.5@60; '
    'ratio(skytpu_spec_accepted_tokens_total/'
    'skytpu_spec_proposed_tokens_total)>=0.5@120; '
    'within(skytpu_kv_pages_free,1,inf); '
    'anomaly(skytpu_decode_step_seconds)',
    'p99(skytpu_decode_step_seconds) <= 0.25; '
    'ratio(skytpu_prefix_cache_hits_total/skytpu_prefix_cache_hits_total'
    '+skytpu_prefix_cache_misses_total) > 0.3 @ 30')


def _rule_view(rule):
    return (type(rule).__name__,
            {k: v for k, v in vars(rule).items() if not k.startswith('_')})


def test_parse_rules_and_default_rules_match_reference(monkeypatch):
    for spec in RULE_SPECS:
        assert [_rule_view(r) for r in port_wd.parse_rules(spec)] == \
            [_rule_view(r) for r in ref_wd.parse_rules(spec)]
    for bad in ('p95(x) > 1', 'ratio(x) >= 1', 'within(x, 1)', 'nope(x)'):
        for mod in (ref_wd, port_wd):
            with pytest.raises(ValueError):
                mod.parse_rules(bad)
    monkeypatch.setenv('SKYTPU_WATCHDOG_RULES', RULE_SPECS[1])
    assert [_rule_view(r) for r in port_wd.default_rules()] == \
        [_rule_view(r) for r in ref_wd.default_rules()]
    assert len(port_wd.default_rules()) == 4


def test_sampler_and_watchdog_threads_start_and_stop(monkeypatch):
    """The process-wide threads start only when their knob is positive
    and stop when asked (no thread is left behind in a test worker)."""
    monkeypatch.setenv('SKYTPU_TS_SAMPLE_SECONDS', '0')
    monkeypatch.setenv('SKYTPU_WATCHDOG_TICK_SECONDS', '0')
    assert port_ts.start_sampler() is False
    assert port_wd.start_watchdog() is None
    port_wd.stop_watchdog()            # drops the instance it made
    monkeypatch.setenv('SKYTPU_TS_SAMPLE_SECONDS', '0.05')
    monkeypatch.setenv('SKYTPU_WATCHDOG_TICK_SECONDS', '0.05')
    try:
        assert port_ts.start_sampler() is True
        wd = port_wd.start_watchdog(rules=[])
        assert wd is port_wd.get_watchdog() and wd is not None
        assert port_wd.handler()['rules'] == []
    finally:
        port_ts.stop_sampler()
        port_wd.stop_watchdog()
    names = {t.name for t in threading.enumerate()}
    assert not names & {'skytpu-ts-sampler', 'skytpu-watchdog'}
    assert port_wd.handler()['detail'] == 'watchdog not running'


# -- faults ------------------------------------------------------------------


def _faults_script(faults_mod, obs_mod, monkeypatch):
    faults_mod.reset()
    before = obs_mod.FAULTS_INJECTED.labels(point='engine.snapshot').value()
    out = []
    try:
        monkeypatch.setenv(
            'SKYTPU_FAULTS', 'engine.snapshot:2,engine.handoff_lease:forever'
            ':0,bogus.point:1,engine.snapshot_x:bad')
        out.append(faults_mod.armed_points())
        for _ in range(3):
            try:
                faults_mod.inject('engine.snapshot', env_exc=OSError)
                out.append('ok')
            except OSError as e:
                out.append(('OSError', str(e)))
        out.append(faults_mod.hits('engine.snapshot'))
        faults_mod.arm('engine.snapshot', times=1, exc=KeyError('k'))
        with pytest.raises(KeyError):
            faults_mod.inject('engine.snapshot')
        faults_mod.inject('engine.snapshot')
        out.append(faults_mod.hits('engine.snapshot'))
        monkeypatch.setenv('SKYTPU_FAULTS', '')
        out.append(faults_mod.armed_points())
        faults_mod.arm('checkpoint.save', times=None, exc=None,
                       latency=0.5)
        slept = []
        for _ in range(3):
            faults_mod.inject('checkpoint.save', sleep_fn=slept.append)
        out.append((slept, faults_mod.hits('checkpoint.save')))
        faults_mod.disarm('checkpoint.save')
        out.append(faults_mod.armed_points())
        with pytest.raises(ValueError):
            faults_mod.arm('nope.point')
        with pytest.raises(ValueError):
            faults_mod.arm('engine.snapshot', times=0)
    finally:
        faults_mod.reset()
        monkeypatch.delenv('SKYTPU_FAULTS', raising=False)
    after = obs_mod.FAULTS_INJECTED.labels(point='engine.snapshot').value()
    return out, after - before


def test_faults_grammar_arming_and_counter_match_reference(monkeypatch):
    ref = _faults_script(ref_faults, ref_obs, monkeypatch)
    port = _faults_script(port_faults, port_obs, monkeypatch)
    assert port == ref
    assert port[1] == 3 and port[0][0] == ['engine.handoff_lease',
                                           'engine.snapshot']


# -- the engines -------------------------------------------------------------

ENGINE_KW = dict(batch_size=2, max_seq_len=64, prefill_chunk=16,
                 kv_page_size=8, kv_quant='none', decode_fuse_steps=2,
                 prefix_cache=True, prefill_interleave=24)
SPEC_KW = dict(batch_size=2, max_seq_len=64, prefill_chunk=16,
               kv_page_size=8, kv_quant='none', spec_k=3,
               spec_fuse_rounds=2)
NOISE = 0.05
# Counters and histograms whose every bucket is a count (not a time).
VALUE_HISTOGRAMS = ('skytpu_decode_host_step_tokens',
                    'skytpu_spec_accepted_per_round')
ENGINE_GAUGES = ('BATCH_OCCUPANCY', 'BATCH_SLOTS_ACTIVE', 'QUEUE_DEPTH',
                 'KV_CACHE_UTILIZATION', 'KV_PAGES_TOTAL', 'KV_PAGES_FREE',
                 'KV_PAGES_PRIVATE', 'PREFIX_CACHE_PAGES')


@pytest.fixture(scope='module')
def models():
    ref_config = ref_llama.CONFIGS['tiny']
    target = jax.tree.map(np.asarray, ref_llama.init_params(
        ref_config, jax.random.key(7)))
    # The draft: the target with noise on every weight, so it agrees
    # with the target on some proposals and not on others.
    rng = np.random.default_rng(5)
    draft = jax.tree.map(
        lambda a: (a + NOISE * a.std() * rng.standard_normal(a.shape)
                   ).astype(a.dtype), target)
    out = {name: (jax.tree.map(jax.numpy.asarray, p),
                  weights.from_jax_params(p))
           for name, p in (('target', target), ('draft', draft))}
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    return ref_config, config, out


def _engines(models, spec=False, **kw):
    ref_config, config, m = models
    (params, tparams), (dparams, dtparams) = m['target'], m['draft']
    kw = {**(SPEC_KW if spec else ENGINE_KW), **kw}
    if spec:
        kw['draft'] = (dparams, ref_config)
    ref = ref_inference.InferenceEngine(params, ref_config, **kw)
    if spec:
        kw['draft'] = (dtparams, config)
    port = inference.InferenceEngine(tparams, config, device='cpu', **kw)
    return {'ref': ref, 'port': port}


def _reading(metrics_mod):
    """Every series of the process registry: scalars by value,
    histograms by count, buckets and sum."""
    out = {}
    for fam in metrics_mod.REGISTRY.collect():
        if fam.buckets is None:
            for series, labels, value in fam.scalars:
                out[(series, labels)] = value
            continue
        for p in fam.histograms:
            key = tuple(zip(fam.labelnames, p.labelvalues))
            out[(fam.name + '_count', key)] = p.count
            if fam.name in VALUE_HISTOGRAMS:
                out[(fam.name + '_sum', key)] = p.sum
                for bound, cum in zip(fam.buckets, p.cumulative):
                    out[(fam.name + '_bucket', key + (('le', bound),))] = cum
    return out


def _delta(before, after, kinds):
    """Counter and histogram deltas of the engine's families (gauges
    are compared absolutely)."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if any(k[0].startswith(n) for n in kinds)
            and v != before.get(k, 0)}


ENGINE_FAMILIES = ('skytpu_prefill_seconds', 'skytpu_decode_',
                   'skytpu_spec_', 'skytpu_prompt_tokens',
                   'skytpu_generated_tokens', 'skytpu_prefix_cache_hits',
                   'skytpu_prefix_cache_misses',
                   'skytpu_prefix_cache_reused', 'skytpu_prefix_cache_evic',
                   'skytpu_requests_', 'skytpu_handoff_fallbacks',
                   'skytpu_faults_injected')


def _run_script(engine, sampling_cls, spec):
    """The request script; returns ({rid: tokens}, {rid: span ctx})."""
    g = lambda n: sampling_cls(temperature=0.0, max_new_tokens=n)  # noqa
    base = list(range(3, 23))                    # 20 tokens
    traces, results = {}, {}

    def submit(prompt, n):
        rid = engine.submit(prompt, g(n))
        traces[rid] = engine._req_trace.get(rid)
        return rid

    def drain():
        results.update(engine.run_to_completion())

    if spec:
        submit(base, 9)
        submit(list(range(40, 52)), 7)
        drain()
        return results, traces
    submit(base, 6)                                       # cold
    drain()
    submit(base[:16] + [60, 61, 62, 63, 64], 5)           # warm: 2 pages
    drain()
    submit(base[:16], 4)                                  # full match: COW
    drain()
    submit(list(range(30, 70)), 5)                        # interleaved
    doomed = submit(list(range(25, 45)), 8)      # cold's bucket: no compile
    engine.step()
    engine.step()
    engine.abort(doomed)
    drain()
    queued = submit([9, 8, 7], 3)
    engine.abort(queued)
    return results, traces


@pytest.fixture(scope='module')
def engine_runs(models):
    """Both engines through the plain and the speculative script with
    every trace kept; per package: the results, counter deltas, final
    gauges and each request's engine spans."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('SKYTPU_TRACE_SAMPLE', '1.0')
        for spec in (False, True):
            engines = _engines(models, spec=spec)
            for pkg, engine in engines.items():
                metrics_mod, obs_mod, spans_mod = PACKAGES[pkg][:3]
                sampling_cls = (ref_inference if pkg == 'ref'
                                else inference).SamplingParams
                before = _reading(metrics_mod)
                results, traces = _run_script(engine, sampling_cls, spec)
                after = _reading(metrics_mod)
                gauges = {name: getattr(obs_mod, name).value()
                          for name in ENGINE_GAUGES}
                span_view = {}
                for rid, ctx in traces.items():
                    recs = spans_mod.COLLECTOR.spans_for(ctx.trace_id)
                    span_view[rid] = sorted(
                        (r['name'], r['parent_id'] == ctx.span_id,
                         sorted(r['attrs'].items())) for r in recs)
                out[(pkg, spec)] = dict(
                    results=results, delta=_delta(before, after,
                                                  ENGINE_FAMILIES),
                    gauges=gauges, spans=span_view,
                    stats=getattr(engine, 'stats', None))
    return out


@pytest.mark.parametrize('spec', [False, True])
def test_engine_counter_deltas_match_reference(engine_runs, spec):
    ref, port = engine_runs[('ref', spec)], engine_runs[('port', spec)]
    assert port['results'] == ref['results']
    assert port['delta'] == ref['delta']
    d = port['delta']
    assert d[('skytpu_prompt_tokens_total', ())] == \
        port['stats']['prompt_tokens']
    assert d[('skytpu_generated_tokens_total', ())] == \
        port['stats']['generated_tokens']
    assert d[('skytpu_decode_host_steps_total', ())] == \
        port['stats']['decode_dispatches']
    assert d[('skytpu_prefill_seconds_count', ())] > 0
    if spec:
        assert d[('skytpu_spec_rounds_total', ())] == \
            port['stats']['spec_rounds'] > 0
        assert 0 < d[('skytpu_spec_accepted_tokens_total', ())] < \
            d[('skytpu_spec_proposed_tokens_total', ())]
    else:
        assert d[('skytpu_prefix_cache_hits_total', ())] == 2
        # The full-prompt match copied its last page at admission (the
        # slot is not yet filled there, so neither engine spans it).
        assert port['stats']['cow_copies'] == 1
        assert d[('skytpu_requests_aborted_total', ())] == 2
        assert d[('skytpu_requests_finished_total', ())] == 4


@pytest.mark.parametrize('spec', [False, True])
def test_engine_final_gauges_match_reference(engine_runs, spec):
    ref, port = engine_runs[('ref', spec)], engine_runs[('port', spec)]
    assert port['gauges'] == pytest.approx(ref['gauges'], abs=1e-12)
    assert port['gauges']['KV_PAGES_TOTAL'] > 0


@pytest.mark.parametrize('spec', [False, True])
def test_engine_spans_match_reference(engine_runs, spec):
    """Per request: the multiset of engine span names, each parented on
    the request's context, with equal attributes."""
    ref, port = engine_runs[('ref', spec)], engine_runs[('port', spec)]
    assert port['spans'] == ref['spans']
    names = {n for view in port['spans'].values() for n, _, _ in view}
    want = ({'engine.admission_wait', 'engine.prefill', 'engine.spec_decode'}
            if spec else
            {'engine.admission_wait', 'engine.prefix_match',
             'engine.prefill', 'engine.prefill_chunk', 'engine.decode'})
    assert want <= names, want - names
    assert all(parented for view in port['spans'].values()
               for _, parented, _ in view)


def test_trace_max_spans_zero_switches_phase_tracing_off(models,
                                                         monkeypatch):
    monkeypatch.setenv('SKYTPU_TRACE_MAX_SPANS', '0')
    engine = _engines(models)['port']
    before = port_spans.COLLECTOR.span_count()
    rid = engine.submit([4, 5, 6], inference.SamplingParams(
        max_new_tokens=3))
    assert rid not in engine._req_trace
    engine.run_to_completion()
    assert port_spans.COLLECTOR.span_count() == before


def _decode_one(engine, sampling_cls, handoff=False):
    rid = engine.submit(list(range(3, 20)), sampling_cls(
        temperature=0.0, max_new_tokens=6), handoff=handoff)
    engine.step()
    return rid


def test_snapshot_seam_raises_in_both_engines(models):
    engines = _engines(models)
    for pkg, engine in engines.items():
        faults_mod, obs_mod = PACKAGES[pkg][5], PACKAGES[pkg][1]
        sampling_cls = (ref_inference if pkg == 'ref'
                        else inference).SamplingParams
        rid = _decode_one(engine, sampling_cls)
        counter = obs_mod.FAULTS_INJECTED.labels(point='engine.snapshot')
        before = counter.value()
        faults_mod.arm('engine.snapshot', times=1)
        try:
            with pytest.raises(faults_mod.FaultInjected):
                engine.snapshot_request(rid)
            blob = engine.snapshot_request(rid)
        finally:
            faults_mod.reset()
        assert counter.value() - before == 1 and blob
        engine.abort(rid)
        assert not engine.has_work


@pytest.mark.parametrize('expire', [False, True])
def test_handoff_lease_seam_and_expiry_match_reference(models, monkeypatch,
                                                       expire):
    """Armed `engine.handoff_lease` refuses the lease in both engines:
    the request decodes co-located with no lease (the reference's engine
    counts no fallback for it). A lease that expires resumes decode and
    counts one HANDOFF_FALLBACKS in both."""
    monkeypatch.setenv('SKYTPU_HANDOFF_LEASE_SECONDS', '0')
    got = {}
    for pkg, engine in _engines(models).items():
        faults_mod, obs_mod = PACKAGES[pkg][5], PACKAGES[pkg][1]
        sampling_cls = (ref_inference if pkg == 'ref'
                        else inference).SamplingParams
        lease = obs_mod.FAULTS_INJECTED.labels(point='engine.handoff_lease')
        before = (lease.value(), obs_mod.HANDOFF_FALLBACKS.value())
        if not expire:
            faults_mod.arm('engine.handoff_lease', times=1)
        try:
            rid = _decode_one(engine, sampling_cls, handoff=True)
            paused = engine.handoff_pending()
            tokens = engine.run_to_completion()[rid]
        finally:
            faults_mod.reset()
        got[pkg] = (paused, tokens, lease.value() - before[0],
                    obs_mod.HANDOFF_FALLBACKS.value() - before[1])
    assert got['port'] == got['ref']
    paused, tokens, fired, fallbacks = got['port']
    assert len(tokens) == 6
    assert (paused, fired, fallbacks) == (
        ([0], 0, 1) if expire else ([], 1, 0))


# -- the embedded server -----------------------------------------------------

SERVER_KW = dict(batch_size=2, max_seq_len=64, prefill_chunk=16,
                 kv_page_size=8, device='cpu', seed=1)


@pytest.fixture(scope='module')
def served():
    engine = inference.build_engine('tiny', **SERVER_KW)
    holder = {'loop': server_lib.EngineLoop(engine)}
    srv = server_lib.create_server(holder, host='127.0.0.1', port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f'http://127.0.0.1:{srv.server_address[1]}', engine
    finally:
        srv.shutdown()
        srv.server_close()
        holder['loop'].stop()
        thread.join(10)


def _call(url, body=None, headers=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        'Content-Type': 'application/json', **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _eventually(fn, ok, timeout=30.0):
    """fn(), polled until ok(value) holds or `timeout` s pass: the
    middleware closes a request's counter and span after its response
    has left."""
    deadline = time.monotonic() + timeout
    while True:
        value = fn()
        if ok(value) or time.monotonic() > deadline:
            return value
        time.sleep(0.01)


def _http_count(method, code):
    return port_obs.HTTP_REQUESTS.labels(plane='inference', method=method,
                                         code=code).value()


def test_metrics_endpoint_serves_the_registry(served):
    base, _ = served
    before = _http_count('GET', '200')
    status, headers, body = _call(base + '/metrics')
    assert status == 200
    assert headers['Content-Type'] == port_metrics.CONTENT_TYPE
    text = body.decode()
    assert '# TYPE skytpu_http_requests_total counter' in text
    assert 'X-Trace-ID' not in headers            # untraced path
    assert _eventually(lambda: _http_count('GET', '200'),
                       lambda n: n > before) == before + 1
    assert _call(base + '/nowhere')[0] == 404
    assert _eventually(lambda: _http_count('GET', '404'),
                       lambda n: n >= 1) >= 1


def test_generate_honours_request_id_and_grafts_traceparent(monkeypatch,
                                                            served):
    monkeypatch.setenv('SKYTPU_TRACE_SAMPLE', '1.0')
    base, _ = served
    parent = port_spans.SpanContext('ab' * 16, 'cd' * 8)
    status, headers, body = _call(
        base + '/generate', {'prompt_tokens': [5, 9, 14], 'max_new_tokens':
                             4},
        headers={'X-Request-ID': 'req-from-upstream',
                 'traceparent': port_spans.format_traceparent(parent)})
    assert status == 200 and len(json.loads(body)['tokens']) == 4
    assert headers['X-Trace-ID'] == parent.trace_id
    status, _, body = _eventually(
        lambda: _call(base + '/internal/trace?trace_id=' + parent.trace_id),
        lambda r: r[0] == 200 and any(
            s['name'] == 'inference.request'
            for s in json.loads(r[2])['spans']))
    doc = json.loads(body)
    assert status == 200
    assert set(doc) == {'trace_id', 'spans', 'tree', 'traceEvents'}
    (root,) = doc['tree']                      # the remote parent's child
    assert root['name'] == 'inference.request'
    assert root['parent_id'] == parent.span_id
    assert root['attrs']['rid'] == 'req-from-upstream'
    assert root['attrs']['status'] == 200
    children = {c['name'] for c in root['children']}
    assert {'engine.admission_wait', 'engine.prefill',
            'engine.decode'} <= children
    for child in root['children']:
        assert root['start'] <= child['start'] <= child['end'] <= root['end']


def test_generate_without_traceparent_starts_a_trace(monkeypatch, served):
    monkeypatch.setenv('SKYTPU_TRACE_SAMPLE', '1.0')
    base, _ = served
    status, headers, _ = _call(base + '/generate', {
        'prompt_tokens': [7, 8], 'max_new_tokens': 2, 'stream': True})
    assert status == 200
    trace_id = headers['X-Trace-ID']
    index = _eventually(
        lambda: json.loads(_call(base + '/internal/trace')[2]),
        lambda d: trace_id in {t['trace_id'] for t in d['traces']})
    assert trace_id in {t['trace_id'] for t in index['traces']}
    assert set(index['traces'][0]) == {'trace_id', 'error', 'duration',
                                       'spans'}
    assert _call(base + '/internal/trace?trace_id=' + 'e' * 32)[0] == 404


def test_timeseries_and_alerts_endpoints(served):
    base, _ = served
    port_ts.STORE.sample_now()
    status, _, body = _call(base + '/internal/timeseries')
    doc = json.loads(body)
    assert status == 200 and set(doc) == {'now', 'series', 'stats'}
    assert any(row['name'] == 'skytpu_http_requests_total'
               for row in doc['series'])
    status, _, body = _call(
        base + '/internal/timeseries?query=rate&metric='
        'skytpu_generated_tokens_total&window=60')
    assert status == 200
    assert set(json.loads(body)) == {'query', 'metric', 'window_s',
                                     'labels', 'value'}
    status, _, body = _call(base + '/internal/alerts')
    assert status == 200 and set(json.loads(body)) == {
        'now', 'rules', 'events', 'detail'}
    wd = port_wd.Watchdog(rules=port_wd.parse_rules(RULE_SPECS[0]),
                          dump_evidence=False)
    port_wd._WATCHDOG = wd
    try:
        doc = json.loads(_call(base + '/internal/alerts')[2])
    finally:
        port_wd._WATCHDOG = None
    assert set(doc) == {'now', 'rules', 'events'}
    assert len(doc['rules']) == 4 and set(doc['rules'][0]) == {
        'name', 'firing', 'breach_streak', 'clear_streak', 'fired',
        'cleared', 'last_value', 'detail'}


def test_health_engine_block_is_the_reference_shape(served):
    base, engine = served
    before = port_spans.COLLECTOR.span_count()
    status, headers, body = _call(base + '/health')
    doc = json.loads(body)['engine']
    # Reference server :455-495, key for key.
    assert set(doc) == {'queue_depth', 'in_flight', 'batch_occupancy',
                        'kv_cache_utilization', 'kv_pages', 'prefix_cache',
                        'spec'}
    assert set(doc['kv_pages']) == {'total', 'free', 'cached', 'private'}
    assert set(doc['prefix_cache']) == {'hits', 'misses', 'reused_tokens',
                                        'evictions'}
    assert set(doc['spec']) == {'rounds', 'proposed_tokens',
                                'accepted_tokens'}
    assert doc['kv_pages']['total'] == port_obs.KV_PAGES_TOTAL.value()
    assert doc['prefix_cache']['hits'] == \
        port_obs.PREFIX_CACHE_HITS.value()
    # A probe makes no span tree (_UNTRACED_PATHS) and no X-Trace-ID.
    assert 'X-Trace-ID' not in headers
    assert port_spans.COLLECTOR.span_count() == before


def test_engine_loop_carries_the_handler_context_to_the_engine(monkeypatch):
    monkeypatch.setenv('SKYTPU_TRACE_SAMPLE', '1.0')
    # An engine of its own: a second loop over the served engine would
    # step it from two threads.
    engine = inference.build_engine('tiny', **SERVER_KW)
    holder_loop = server_lib.EngineLoop(engine)
    try:
        ctx = port_spans.SpanContext('12' * 16, '34' * 8)
        with port_tracing.request_scope('req-hop'):
            token = port_spans.bind_context(ctx)
            try:
                watcher = holder_loop.submit([3, 4], inference.SamplingParams(
                    max_new_tokens=2))
            finally:
                port_spans.unbind_context(token)
        kind, _ = watcher.q.get(timeout=60)
        while kind == 'token':
            kind, _ = watcher.q.get(timeout=60)
        assert kind == 'done'
        names = {s['name'] for s in port_spans.COLLECTOR.spans_for(
            ctx.trace_id)}
        assert 'engine.admission_wait' in names
        assert all(s['parent_id'] == ctx.span_id
                   for s in port_spans.COLLECTOR.spans_for(ctx.trace_id))
    finally:
        holder_loop.stop()


# -- train and import --------------------------------------------------------


def test_fit_sets_train_instruments_to_its_logged_values(monkeypatch):
    monkeypatch.setitem(trainer.PEAK_FLOPS, 'cpu', 1e12)
    cfg = trainer.TrainerConfig(model='tiny', batch_size=2, seq_len=16,
                                max_steps=2)
    tokens = port_obs.TRAIN_TOKENS.value()
    steps = port_obs.TRAIN_STEP_SECONDS.child_snapshot()[2]
    res = train_loop.fit(cfg, 'cpu', log_every=1, log_fn=lambda _: None)
    last = res['history'][-1]
    assert port_obs.TRAIN_STEP.value() == 2
    assert port_obs.TRAIN_TOKENS.value() - tokens == 2 * 2 * 16
    assert port_obs.TRAIN_STEP_SECONDS.child_snapshot()[2] - steps == 2
    assert port_obs.TRAIN_LOSS.value() == last['loss']
    assert port_obs.TRAIN_MFU.value() == last['mfu'] > 0


def test_import_counters_equal_import_stats(tmp_path):
    ref_config = ref_llama.CONFIGS['tiny']
    params = jax.tree.map(np.asarray, ref_llama.init_params(
        ref_config, jax.random.key(3)))
    out = str(tmp_path / 'hf')
    ref_hf_export.export_params(params, ref_config, out,
                                max_shard_bytes=40_000)
    before = (port_obs.CKPT_IMPORT_BYTES.value(),
              port_obs.CKPT_IMPORT_TENSORS.value(),
              port_obs.CKPT_IMPORT_SECONDS.child_snapshot())
    _, _, stats = hf_import.load_params(out, device='cpu')
    cum, total, count = port_obs.CKPT_IMPORT_SECONDS.child_snapshot()
    assert port_obs.CKPT_IMPORT_BYTES.value() - before[0] == \
        stats.bytes_read > 0
    assert port_obs.CKPT_IMPORT_TENSORS.value() - before[1] == \
        stats.tensors > 0
    assert count - before[2][2] == 1
    assert total - before[2][1] == pytest.approx(stats.seconds)
