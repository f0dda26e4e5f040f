"""`python -m skypilot_tpu_torch.observability.top` — terminal sparklines
over the live time-series plane (or a dumped window).

The port's copy of `skypilot_tpu/observability/top.py`, pointed at the
port's server: `sparkline`, `render` and `main`.

Reads the same JSON `/internal/timeseries` serves (so it renders a
replica, the LB's fleet-merged store, the API server, or a
WATCHDOG_*.json evidence dump identically) and draws one sparkline
row per series: counters as reset-clamped per-second rates, gauges
as raw values, histograms as per-interval mean latency. Stdlib only,
like everything else in this plane.

    python -m skypilot_tpu_torch.observability.top --url http://lb:8080
    python -m skypilot_tpu_torch.observability.top --url ... --watch 5
    python -m skypilot_tpu_torch.observability.top --file WATCHDOG_x.json
"""
import argparse
import json
import sys
import time
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

_BLOCKS = '▁▂▃▄▅▆▇█'


def sparkline(values: List[float], width: int = 32) -> str:
    """Render the last `width` values as unicode blocks, scaled to
    the window's own min..max (a flat series renders flat-low)."""
    if not values:
        return ''
    tail = values[-width:]
    lo, hi = min(tail), max(tail)
    span = hi - lo
    if span <= 0:
        return _BLOCKS[0] * len(tail)
    return ''.join(
        _BLOCKS[min(len(_BLOCKS) - 1,
                    int((v - lo) / span * (len(_BLOCKS) - 1)))]
        for v in tail)


def _display_series(row: Dict[str, Any]
                    ) -> Tuple[List[float], str]:
    """Per-sample display values + a unit tag for one dumped series."""
    kind = row.get('kind', 'gauge')
    samples = row.get('samples') or []
    if kind == 'histogram':
        out = []
        prev = None
        for ts, _cum, total, count in samples:
            if prev is None:
                if count > 0:   # young series: everything so far
                    out.append(total / count)
            elif count > prev[1]:
                out.append((total - prev[0]) / (count - prev[1]))
            elif count < prev[1] and count > 0:
                out.append(total / count)   # restart: absolute mean
            prev = (total, count)
        return out, 'mean s'
    if kind == 'counter':
        out = []
        prev = None
        for ts, value in samples:
            if prev is not None:
                dt = max(1e-9, ts - prev[0])
                dv = value - prev[1] if value >= prev[1] else value
                out.append(dv / dt)
            prev = (ts, value)
        return out, '/s'
    return [v for _ts, v in samples], ''


def _label_tag(labels: Dict[str, str]) -> str:
    if not labels:
        return ''
    return '{' + ','.join(f'{k}={v}'
                          for k, v in sorted(labels.items())) + '}'


def render(doc: Dict[str, Any], metrics: Optional[List[str]] = None,
           width: int = 32, limit: int = 40) -> str:
    """One frame: `limit` busiest series (most retained samples
    first), filtered to name substrings in `metrics` when given."""
    rows = []
    for row in doc.get('series', ()):
        name = row.get('name', '')
        if metrics and not any(m in name for m in metrics):
            continue
        values, unit = _display_series(row)
        if not values:
            continue
        rows.append((len(row.get('samples') or ()), name,
                     _label_tag(row.get('labels') or {}),
                     values, unit))
    rows.sort(key=lambda r: (-r[0], r[1], r[2]))
    out = []
    name_w = max([len(r[1] + r[2]) for r in rows[:limit]] or [0])
    name_w = min(name_w, 64)
    for _n, name, tag, values, unit in rows[:limit]:
        last = values[-1]
        out.append(f'{(name + tag)[:name_w]:<{name_w}}  '
                   f'{sparkline(values, width)}  '
                   f'{last:>10.4g}{unit}')
    if not out:
        return '(no series retained yet)'
    return '\n'.join(out)


def _fetch(url: str) -> Dict[str, Any]:
    target = url.rstrip('/') + '/internal/timeseries'
    with urllib.request.urlopen(target, timeout=5) as r:
        return json.loads(r.read().decode('utf-8'))


def _load_file(path: str) -> Dict[str, Any]:
    with open(path, encoding='utf-8') as f:
        doc = json.load(f)
    # A WATCHDOG_*.json evidence dump nests the window under
    # 'window'; a raw /internal/timeseries dump is the window.
    if 'series' not in doc and isinstance(doc.get('window'), dict):
        return doc['window']
    return doc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.observability.top',
        description='Sparkline dashboard over skytpu_* time series.')
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument('--url', help='Server/LB base URL to poll '
                                   '(its /internal/timeseries).')
    src.add_argument('--file', help='Dumped series JSON (an '
                                    '/internal/timeseries dump or a '
                                    'WATCHDOG_*.json evidence file).')
    parser.add_argument('--metric', action='append', default=[],
                        help='Only series whose name contains this '
                             '(repeatable).')
    parser.add_argument('--watch', type=float, default=0.0,
                        metavar='SECONDS',
                        help='Redraw every SECONDS (URL mode); 0 = '
                             'render once and exit.')
    parser.add_argument('--width', type=int, default=32,
                        help='Sparkline width in samples.')
    parser.add_argument('--limit', type=int, default=40,
                        help='Max series rows per frame.')
    args = parser.parse_args(argv)

    def frame() -> str:
        doc = _load_file(args.file) if args.file \
            else _fetch(args.url)
        stamp = time.strftime('%H:%M:%S')
        src_name = args.file or args.url
        stats = doc.get('stats') or {}
        head = (f'skytpu top — {src_name} @ {stamp}  '
                f'({stats.get("series", len(doc.get("series", [])))} '
                f'series)')
        return head + '\n' + render(doc, args.metric or None,
                                    args.width, args.limit)

    if not args.watch or args.file:
        try:
            print(frame())
        except (OSError, ValueError) as e:
            print(f'error: {e}', file=sys.stderr)
            return 1
        return 0
    try:
        while True:
            try:
                body = frame()
            except (OSError, ValueError) as e:
                body = f'error: {e}'
            # ANSI clear + home: cheap full-frame redraw, no curses.
            sys.stdout.write('\x1b[2J\x1b[H' + body + '\n')
            sys.stdout.flush()
            time.sleep(args.watch)
    except KeyboardInterrupt:
        return 0


if __name__ == '__main__':
    sys.exit(main())
