"""Fetch a span tree from a running server as Chrome-trace JSON.

The port's copy of `skypilot_tpu/observability/trace_dump.py`, pointed
at the port's server (its `/internal/trace`):

    python -m skypilot_tpu_torch.observability.trace_dump \
        --url http://127.0.0.1:8080 --trace-id <32-hex> --out trace.json

Point --url at the LB to get the MERGED tree (LB legs + replica
server/engine spans); point it at a replica for that process's view
only. Without --trace-id, lists the traces the target's flight
recorder currently holds. The output opens in chrome://tracing or
https://ui.perfetto.dev.

stdlib-only (urllib): usable from any box that can reach the port,
no client deps.
"""
import argparse
import json
import sys
import urllib.error
import urllib.parse
import urllib.request


def _fetch(url: str, timeout: float):
    with urllib.request.urlopen(url, timeout=timeout) as resp:  # noqa: S310
        return json.loads(resp.read().decode('utf-8'))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='Dump a distributed trace as Chrome-trace JSON.')
    parser.add_argument('--url', required=True,
                        help='Base URL of an LB or replica '
                             '(e.g. http://127.0.0.1:8080).')
    parser.add_argument('--trace-id', default=None,
                        help='32-hex trace id (from an X-Trace-ID '
                             'response header or a metric exemplar). '
                             'Omit to list recorded traces.')
    parser.add_argument('--out', default=None,
                        help='Write Chrome-trace JSON here '
                             '(default: stdout).')
    parser.add_argument('--timeout', type=float, default=10.0)
    args = parser.parse_args(argv)

    base = args.url.rstrip('/') + '/internal/trace'
    if args.trace_id:
        base += '?' + urllib.parse.urlencode(
            {'trace_id': args.trace_id})
    try:
        doc = _fetch(base, args.timeout)
    except urllib.error.HTTPError as e:
        print(f'error: {e.code} from {base}: '
              f'{e.read().decode("utf-8", "replace").strip()}',
              file=sys.stderr)
        return 1
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f'error: cannot fetch {base}: {e}', file=sys.stderr)
        return 1

    if not args.trace_id:
        traces = doc.get('traces', [])
        if not traces:
            print('flight recorder is empty (raise '
                  'SKYTPU_TRACE_SAMPLE, or the traffic predates the '
                  'ring capacity)', file=sys.stderr)
            return 1
        for t in traces:
            flag = ' ERROR' if t.get('error') else ''
            print(f"{t['trace_id']}  {t['duration'] * 1e3:8.1f}ms  "
                  f"{t['spans']:3d} span(s){flag}")
        return 0

    payload = {'traceEvents': doc.get('traceEvents', [])}
    text = json.dumps(payload, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, 'w', encoding='utf-8') as f:
            f.write(text + '\n')
        print(f"wrote {len(payload['traceEvents'])} event(s) to "
              f'{args.out}', file=sys.stderr)
    else:
        print(text)
    return 0


if __name__ == '__main__':
    sys.exit(main())
