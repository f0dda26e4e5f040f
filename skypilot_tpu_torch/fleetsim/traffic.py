"""Open-loop traffic for the fleet simulator.

The port of `skypilot_tpu/fleetsim/traffic.py`: `poisson`, `Traffic`,
`ConstantTraffic`, `DiurnalTraffic`, `BurstTraffic`, `TraceTraffic`,
`scaled` and `parse`. Open-loop means arrivals are driven by the
clock, not by completions, so overload shows (a closed-loop generator
slows down with the system under test and hides saturation).

Generators are seeded (`random.Random`) so one seed reproduces one
soak run. Arrival counts per window are Poisson around rate * dt:
Knuth sampling for small means, a normal approximation beyond (exact
enough at fleet scale, and O(1) instead of O(lambda)).
"""
import json
import math
from typing import List, Tuple


def poisson(rng, lam: float) -> int:
    if lam <= 0:
        return 0
    if lam > 30.0:
        # Normal approximation with continuity correction.
        return max(0, int(round(rng.gauss(lam, math.sqrt(lam)))))
    l_exp = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= l_exp:
            return k
        k += 1


class Traffic:
    """rate(t) in requests/second; arrivals() samples one window."""

    def rate(self, t: float) -> float:
        raise NotImplementedError

    def arrivals(self, rng, t0: float, t1: float) -> int:
        # Trapezoid over the window: smooth ramps don't alias on the
        # tick grid.
        mean = 0.5 * (self.rate(t0) + self.rate(t1)) * (t1 - t0)
        return poisson(rng, mean)


class ConstantTraffic(Traffic):
    def __init__(self, qps: float) -> None:
        self.qps = float(qps)

    def rate(self, t: float) -> float:
        return self.qps


class DiurnalTraffic(Traffic):
    """Sinusoidal day curve: base at the trough, peak at the crest —
    the shape 'millions of users' actually send."""

    def __init__(self, base_qps: float, peak_qps: float,
                 period_s: float = 86400.0, phase_s: float = 0.0) -> None:
        if peak_qps < base_qps:
            raise ValueError('peak_qps < base_qps')
        self.base = float(base_qps)
        self.peak = float(peak_qps)
        self.period = float(period_s)
        self.phase = float(phase_s)

    def rate(self, t: float) -> float:
        mid = 0.5 * (self.base + self.peak)
        amp = 0.5 * (self.peak - self.base)
        return mid + amp * math.sin(
            2.0 * math.pi * (t + self.phase) / self.period)


class BurstTraffic(Traffic):
    """A flash crowd on top of an inner curve: +burst_qps over
    [at, at+duration) — the retry-storm / launch-day shape."""

    def __init__(self, inner: Traffic, burst_qps: float, at: float,
                 duration_s: float) -> None:
        self.inner = inner
        self.burst = float(burst_qps)
        self.at = float(at)
        self.until = float(at + duration_s)

    def rate(self, t: float) -> float:
        extra = self.burst if self.at <= t < self.until else 0.0
        return self.inner.rate(t) + extra


class TraceTraffic(Traffic):
    """Replay a recorded rate trace: a JSON list of [t_seconds, qps]
    breakpoints forming a step function (the last segment holds).
    Accepts a parsed list or a path to a JSON file."""

    def __init__(self, trace) -> None:
        if isinstance(trace, str):
            with open(trace, encoding='utf-8') as f:
                trace = json.load(f)
        points: List[Tuple[float, float]] = [
            (float(t), float(q)) for t, q in trace]
        if not points:
            raise ValueError('empty traffic trace')
        self.points = sorted(points)

    def rate(self, t: float) -> float:
        current = 0.0
        for at, qps in self.points:
            if t < at:
                break
            current = qps
        return current


def scaled(traffic: Traffic, factor: float) -> Traffic:
    """Wrap any curve with a rate multiplier (the
    SKYTPU_FLEETSIM_SCALE knob shrinks traffic alongside replicas so
    per-replica load stays comparable across CI tiers)."""
    class _Scaled(Traffic):
        def rate(self, t: float) -> float:
            return traffic.rate(t) * factor
    return _Scaled()


def parse(cfg, default_qps: float = 10.0) -> Traffic:
    """Declarative traffic config -> generator. Accepts a bare number
    (constant qps) or {'kind': 'constant'|'diurnal'|'burst'|'trace',
    ...kwargs} as chaos.py lists its actions."""
    if cfg is None:
        return ConstantTraffic(default_qps)
    if isinstance(cfg, (int, float)):
        return ConstantTraffic(float(cfg))
    kind = cfg.get('kind', 'constant')
    if kind == 'constant':
        return ConstantTraffic(cfg['qps'])
    if kind == 'diurnal':
        return DiurnalTraffic(cfg['base_qps'], cfg['peak_qps'],
                              cfg.get('period_s', 86400.0),
                              cfg.get('phase_s', 0.0))
    if kind == 'burst':
        return BurstTraffic(parse(cfg['inner'], default_qps),
                            cfg['burst_qps'], cfg['at'],
                            cfg['duration_s'])
    if kind == 'trace':
        return TraceTraffic(cfg.get('path') or cfg['points'])
    raise ValueError(f'unknown traffic kind {kind!r}')
