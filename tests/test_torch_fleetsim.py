"""The port's fleet simulator against the reference's, on the CPU.

- Units: `VirtualClock`, the traffic curves and `poisson` on seeded
  generators, chaos schedules, and the SLO evaluator (every assertion
  kind over the same observations in each package's registry, window
  marks, a never-written gauge, `write_report`) give the same values,
  events, results and errors.
- Scenarios: the port's `FleetSim` and the reference's at seed 0 on
  `smoke`, `prefix_affinity` (the prefix-affinity policy against the
  least-load baseline, pools) and `disaggregation` (planned handoff and
  its co-located baseline, preemption notices, an armed `lb.handoff`),
  the last two at SKYTPU_FLEETSIM_SCALE 0.5: the reports are equal
  assert for assert (name, ok, value), with the same `requests` and
  `replicas_driven`.
- The catalog holds the reference's scenarios, field for field but the
  descriptions. The CLI (`python -m skypilot_tpu_torch.fleetsim`):
  `--list` prints the reference's names, sizes and durations;
  `--scenario smoke` writes SLO_smoke.json under `--out` with the
  in-process run's asserts and exits with its rc.
The fleet simulator runs no kernel and touches no tensor (its replicas
are latency distributions), so it is held to the reference here only.
"""
import contextlib
import io
import json
import logging
import math
import os
import random
import subprocess
import sys

import pytest

from skypilot_tpu.fleetsim import __main__ as ref_cli
from skypilot_tpu.fleetsim import chaos as ref_chaos
from skypilot_tpu.fleetsim import clock as ref_clock
from skypilot_tpu.fleetsim import runner as ref_runner
from skypilot_tpu.fleetsim import slo as ref_slo
from skypilot_tpu.fleetsim import traffic as ref_traffic
from skypilot_tpu.observability import instruments as ref_obs
from skypilot_tpu_torch.fleetsim import __main__ as port_cli
from skypilot_tpu_torch.fleetsim import chaos as port_chaos
from skypilot_tpu_torch.fleetsim import clock as port_clock
from skypilot_tpu_torch.fleetsim import runner as port_runner
from skypilot_tpu_torch.fleetsim import slo as port_slo
from skypilot_tpu_torch.fleetsim import traffic as port_traffic
from skypilot_tpu_torch.observability import instruments as port_obs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _outcome(fn):
    try:
        return ('ok', fn())
    except Exception as e:  # noqa: BLE001 — compared across packages
        return (type(e).__name__, str(e))


# -- units ---------------------------------------------------------------------

def test_virtual_clock_matches_reference():
    got = {}
    for name, mod in (('ref', ref_clock), ('port', port_clock)):
        c = mod.VirtualClock(start=5.0)
        got[name] = [c.now(), c.advance(2.5), c.sleep(1.25), c.now(),
                     _outcome(lambda: c.advance(-1.0)), c.now()]
    assert got['port'] == got['ref']
    assert got['port'][:4] == [5.0, 7.5, None, 8.75]


TRAFFIC_CFGS = (
    None, 7, 12.5, {'kind': 'constant', 'qps': 3.0},
    {'kind': 'diurnal', 'base_qps': 10.0, 'peak_qps': 50.0,
     'period_s': 600.0, 'phase_s': 30.0},
    {'kind': 'burst', 'inner': {'kind': 'constant', 'qps': 20.0},
     'burst_qps': 40.0, 'at': 100.0, 'duration_s': 50.0},
    {'kind': 'trace', 'points': [[0, 5.0], [60, 40.0], [30, 10.0]]},
)


@pytest.mark.parametrize('i', range(len(TRAFFIC_CFGS)))
def test_traffic_curves_match_reference(i):
    got = {}
    for name, mod in (('ref', ref_traffic), ('port', port_traffic)):
        curve = mod.parse(TRAFFIC_CFGS[i], default_qps=9.0)
        rng = random.Random(i)
        rates = [curve.rate(t) for t in range(0, 400, 7)]
        arrivals = [curve.arrivals(rng, t, t + 2.0)
                    for t in range(0, 400, 2)]
        scaled = mod.scaled(curve, 0.37)
        got[name] = (rates, arrivals,
                     [scaled.rate(t) for t in range(0, 400, 13)],
                     [scaled.arrivals(rng, t, t + 5.0)
                      for t in range(0, 400, 5)])
    assert got['port'] == got['ref']


def test_poisson_and_traffic_errors_match_reference(tmp_path):
    trace = tmp_path / 'trace.json'
    trace.write_text(json.dumps([[0, 2.0], [10, 8.0]]))
    got = {}
    for name, mod in (('ref', ref_traffic), ('port', port_traffic)):
        rng = random.Random(3)
        got[name] = (
            [mod.poisson(rng, lam) for lam in
             (0.0, -1.0, 0.3, 4.0, 29.9, 30.0, 30.5, 250.0, 5000.0)
             for _ in range(5)],
            [mod.TraceTraffic(str(trace)).rate(t) for t in (0, 9, 10, 99)],
            _outcome(lambda: mod.DiurnalTraffic(5.0, 1.0)),
            _outcome(lambda: mod.TraceTraffic([])),
            _outcome(lambda: mod.parse({'kind': 'sawtooth'})))
    assert got['port'] == got['ref']


CHAOS = [{'at': 40.0, 'action': 'zone_loss', 'zone': 'zone-a'},
         {'at': 10.0, 'action': 'mark', 'name': 'early'},
         {'at': 46.0, 'action': 'zone_restore', 'zone': 'zone-a'},
         {'at': 40.0, 'action': 'arm_fault', 'point': 'lb.migrate',
          'times': 2},
         {'at': 90.0, 'action': 'preempt_replicas', 'count': 3,
          'pool': 'decode'}]


def test_chaos_schedules_match_reference():
    got = {}
    for name, mod in (('ref', ref_chaos), ('port', port_chaos)):
        sched = mod.ChaosSchedule.from_config(CHAOS)
        fired = []
        for t in (0.0, 10.0, 39.9, 40.0, 60.0, 200.0):
            fired.append([(e.at, e.action, e.kwargs)
                          for e in sched.pop_due(t)])
            fired.append(sched.remaining())
        got[name] = (fired, [(e.at, e.action) for e in sched.fired],
                     _outcome(lambda: mod.ChaosEvent(1.0, 'meteor')),
                     _outcome(lambda: mod.ChaosEvent(-1.0, 'mark')))
    assert got['port'] == got['ref']


def _observe(obs, seed):
    """One seeded run of observations into a package's registry."""
    rng = random.Random(seed)
    for _ in range(200):
        obs.FLEETSIM_TTFT_SECONDS.observe(rng.lognormvariate(-1.0, 0.8))
        obs.FLEETSIM_REQUESTS.labels(outcome=rng.choice(
            ['ok'] * 30 + ['error', 'no_replica', 'all_open'])).inc()
        if rng.random() < 0.7:
            obs.PREFIX_CACHE_HITS.inc()
        else:
            obs.PREFIX_CACHE_MISSES.inc()
        obs.WATCHDOG_ALERTS.labels(rule='ready',
                                   state=rng.choice(['fire', 'clear'])).inc(
            rng.random() < 0.05)


def _asserts(slo):
    return [
        slo.HistQuantileBelow('ttft_p95', threshold=2.0),
        slo.HistQuantileBelow('ttft_p50', threshold=0.2, q=0.5),
        slo.HistQuantileBelow('ttft_mid', threshold=9.0,
                              window=('mid', 'end')),
        slo.HistQuantileBelow('ttft_empty', threshold=9.0,
                              window=('end', 'end')),
        slo.HistQuantileBelow('ttft_unmarked', threshold=9.0,
                              window=('start', 'never')),
        slo.RatioBelow('error_rate', threshold=0.05),
        slo.RatioBelow('unavailable', threshold=0.05,
                       num_values=('no_replica', 'all_open')),
        slo.CounterRatioAbove(
            'hit_ratio', threshold=0.6,
            num_metric='skytpu_prefix_cache_hits_total',
            den_metrics=('skytpu_prefix_cache_hits_total',
                         'skytpu_prefix_cache_misses_total')),
        slo.GaugeWithin('recovery', threshold=40.0,
                        labels=(('event', 'unit_test_loss'),)),
        slo.GaugeWithin('recovery_never', threshold=40.0,
                        labels=(('event', 'unit_test_never'),)),
        slo.CounterDeltaWithin(
            'fired', metric='skytpu_watchdog_alerts_total',
            labels=(('rule', 'ready'), ('state', 'fire')), min_delta=1.0),
        slo.CounterDeltaWithin(
            'quiet', metric='skytpu_watchdog_alerts_total',
            labels=(('rule', 'ready'),), max_delta=0.0,
            window=('start', 'mid')),
    ]


def test_slo_evaluator_and_report_match_reference(tmp_path):
    got = {}
    for name, slo, obs in (('ref', ref_slo, ref_obs),
                           ('port', port_slo, port_obs)):
        evaluator = slo.SLOEvaluator(_asserts(slo))
        evaluator.mark('start')
        _observe(obs, 1)
        evaluator.mark('mid')
        _observe(obs, 2)
        obs.FLEETSIM_RECOVERY_SECONDS.labels(event='unit_test_loss').set(
            12.0)
        evaluator.mark('warmup_end')
        _observe(obs, 3)
        evaluator.mark('end')
        results = evaluator.evaluate()
        out = tmp_path / name
        out.mkdir()
        path, rc = slo.write_report(str(out), 'unit', results,
                                    extra={'seed': 0})
        with open(path) as f:
            report = json.load(f)
        got[name] = (results, rc, report['rc'], report['asserts'],
                     report['extra'], 'flight_recorder' in report,
                     slo.write_report(str(out), 'clean', results[:1],
                                      rc_override=None)[1],
                     _outcome(lambda: slo.SLOEvaluator(['bogus'])
                              .evaluate()))
    assert got['port'] == got['ref']
    results = {r['name']: r for r in got['port'][0]}
    assert results['recovery_never']['ok'] is False
    assert results['ttft_unmarked']['value'] is None


# -- scenarios, seed for seed ------------------------------------------------------

def _summary(report):
    return ([(a['name'], a['ok'], a['value']) for a in report['asserts']],
            report['rc'], report['extra']['requests'],
            report['extra']['replicas_driven'],
            report['extra'].get('baseline', {}).get('requests'))


@pytest.mark.parametrize('scenario,scale', [('smoke', '1.0'),
                                            ('prefix_affinity', '0.5'),
                                            ('disaggregation', '0.5')])
def test_fleetsim_reports_match_reference(scenario, scale, tmp_path,
                                          monkeypatch):
    monkeypatch.setenv('SKYTPU_FLEETSIM_SCALE', scale)
    logging.disable(logging.WARNING)  # one line per injected fault
    try:
        got = {}
        for name, runner in (('ref', ref_runner), ('port', port_runner)):
            out = tmp_path / name
            out.mkdir()
            report = runner.FleetSim(runner.SCENARIOS[scenario], seed=0,
                                     out_dir=str(out)).run()
            with open(report['report_path']) as f:
                assert json.load(f)['asserts'] == report['asserts']
            got[name] = _summary(report)
    finally:
        logging.disable(logging.NOTSET)
    assert got['port'] == got['ref']
    asserts, rc, requests, driven, _ = got['port']
    assert rc == 0 and requests > 1000 and driven > 0
    assert all(ok for _, ok, _ in asserts)


def test_fleetsim_catalog_and_cli_match_reference(tmp_path):
    assert set(port_runner.SCENARIOS) == set(ref_runner.SCENARIOS)
    for name, sc in ref_runner.SCENARIOS.items():
        mine = port_runner.SCENARIOS[name]
        assert (mine.replicas, mine.duration_s, mine.tick_s, mine.warmup_s,
                mine.traffic, mine.zones, mine.policy, mine.lb_policy,
                mine.chaos, mine.pools, mine.workload,
                mine.compare_lb_policy, mine.compare_handoff_off,
                [(type(a).__name__, a.name, a.threshold)
                 for a in mine.slos + mine.baseline_slos]) == (
            sc.replicas, sc.duration_s, sc.tick_s, sc.warmup_s, sc.traffic,
            sc.zones, sc.policy, sc.lb_policy, sc.chaos, sc.pools,
            sc.workload, sc.compare_lb_policy, sc.compare_handoff_off,
            [(type(a).__name__, a.name, a.threshold)
             for a in sc.slos + sc.baseline_slos])
        assert (mine.profile, mine.pool_profiles) == (
            type(mine.profile)(**vars(sc.profile)),
            {k: type(mine.profile)(**vars(v))
             for k, v in (sc.pool_profiles or {}).items()} or None)
    listed = {}
    for name, cli in (('ref', ref_cli), ('port', port_cli)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(['--list']) == 0
        # Name, replicas and simulated seconds: the port words its
        # scenarios' descriptions apart from the reference's.
        listed[name] = [line.split('s  ', 1)[0]
                        for line in buf.getvalue().splitlines()]
    assert listed['port'] == listed['ref'] and len(listed['port']) == 13
    out = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.fleetsim', '--scenario',
         'smoke', '--out', str(tmp_path)], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, 'SKYTPU_STATE_DIR': str(tmp_path / 'state')})
    assert out.returncode == 0, out.stderr[-2000:]
    assert 'fleetsim smoke: 69 replicas driven, 10913 requests' in out.stdout
    with open(tmp_path / 'SLO_smoke.json') as f:
        report = json.load(f)
    assert report['rc'] == 0 and [a['name'] for a in report['asserts']] == [
        'ttft_p95', 'error_rate', 'update_error_rate', 'zone_loss_recovery']
    assert not math.isnan(report['extra']['wall_seconds'])
