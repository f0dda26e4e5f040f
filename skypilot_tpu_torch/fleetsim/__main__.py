"""CLI: python -m skypilot_tpu_torch.fleetsim --scenario zone_loss

The port of `skypilot_tpu/fleetsim/__main__.py` (`main`): runs one soak
scenario against an isolated state dir (a fresh temporary directory
unless SKYTPU_STATE_DIR is set) and writes SLO_<scenario>.json
(schema: {rc, scenario, asserts, extra}) to --out /
SKYTPU_FLEETSIM_OUT_DIR / the current directory. Exit code is the
report's rc, so CI can gate on the process exit alone.
"""
import argparse
import os
import sys
import tempfile


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.fleetsim',
        description='Fleet-scale soak harness (simulated replicas, '
                    'virtual clock, SLO gates).')
    parser.add_argument('--scenario',
                        help='scenario name (see --list)')
    parser.add_argument('--list', action='store_true',
                        help='list scenarios and exit')
    parser.add_argument('--seed', type=int, default=None,
                        help='RNG seed (default: '
                             'SKYTPU_FLEETSIM_SEED or 0)')
    parser.add_argument('--out', default=None,
                        help='directory for SLO_<scenario>.json')
    args = parser.parse_args(argv)

    # Isolate simulated serve state from any real ~/.skytpu on this
    # machine — a soak must never touch a live deployment's DB.
    from skypilot_tpu_torch import envs
    if not envs.SKYTPU_STATE_DIR.is_set():
        os.environ[envs.SKYTPU_STATE_DIR.name] = tempfile.mkdtemp(
            prefix='skytpu-fleetsim-')

    from skypilot_tpu_torch.fleetsim import runner

    if args.list:
        for name, sc in sorted(runner.SCENARIOS.items()):
            print(f'{name:18s} replicas={sc.replicas:<5d} '
                  f'sim={sc.duration_s:.0f}s  {sc.description}')
        return 0
    if not args.scenario:
        parser.error('--scenario is required (or --list)')
    if args.scenario not in runner.SCENARIOS:
        parser.error(f'unknown scenario {args.scenario!r}; '
                     f'choose from {sorted(runner.SCENARIOS)}')

    sim = runner.FleetSim(runner.SCENARIOS[args.scenario],
                          seed=args.seed, out_dir=args.out)
    report = sim.run()
    extra = report['extra']
    print(f"fleetsim {args.scenario}: {extra['replicas_driven']} "
          f"replicas driven, {extra['requests']} requests over "
          f"{extra['simulated_seconds']:.0f} simulated s in "
          f"{extra['wall_seconds']:.1f}s wall")
    for result in report['asserts']:
        status = 'PASS' if result['ok'] else 'FAIL'
        print(f"  [{status}] {result['name']}: value="
              f"{result['value']} threshold={result['threshold']} "
              f"({result['detail']})")
    print(f"report: {report['report_path']} (rc={report['rc']})")
    return report['rc']


if __name__ == '__main__':
    sys.exit(main())
