"""`python -m skypilot_tpu_torch.checkpoints`: inspect / import / verify /
export HF safetensors checkpoints from the shell.

Ports `skypilot_tpu/checkpoints/__main__.py` (:36-283): `_cmd_inspect`,
`_cmd_import`, `_finite_violations`, `_diff_one`, `_verify_against`,
`_cmd_verify`, `_cmd_export` and `main`, with the same output and exit
codes:

  inspect <dir>              family, geometry, shard/tensor inventory
  import <dir> [--device D] [--mesh SPEC]
                             stream onto a device (CUDA unless named),
                             or each rank's cut under a mesh; prints a
                             stats JSON line
  verify <dir>               structural + mapping + finite-value
                             checks; `--against <dir>` adds a
                             per-tensor numeric diff. Exit 0 = clean;
                             1 prints a per-tensor report.
  export --orbax <dir> --model <name> --out <dir>
                             train checkpoint -> HF layout (the
                             fine-tune round trip)

`export` keeps the reference's flag name `--orbax` so that scripts carry
over; in the port its directory is a train checkpoint written by the
port's `fit` (`train/checkpoints.py`). As in the reference, `--model`
gives the export geometry; params that do not fit it raise. `import
--mesh` imports under `mesh_from_env` as the reference's does (:66-74),
one process per device: each process of the gang runs the same command
with the gang variables set, and places its cut of every tensor
(`hf_import.load_params(mesh=)`); one process asking for several
devices raises, naming those variables.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np

from skypilot_tpu_torch.checkpoints import hf_export
from skypilot_tpu_torch.checkpoints import hf_import
from skypilot_tpu_torch.checkpoints import safetensors_io

# Finite-scan window: elements per chunk cast to f32, which bounds the
# scan's host memory at ~16 MiB whatever the tensor's size.
_SCAN_CHUNK = 1 << 22


def _cmd_inspect(args) -> int:
    family, config = hf_import.detect_config(args.checkpoint)
    with safetensors_io.CheckpointReader(args.checkpoint) as reader:
        doc = {
            'family': family,
            'config': {
                'vocab_size': config.vocab_size,
                'hidden_size': config.hidden_size,
                'intermediate_size': config.intermediate_size,
                'num_layers': config.num_layers,
                'num_heads': config.num_heads,
                'num_kv_heads': config.num_kv_heads,
                'head_dim': config.head_dim,
                'max_seq_len': config.max_seq_len,
                'tied_embeddings': config.tied_embeddings,
            },
            'shards': reader.num_shards,
            'tensors': len(reader.tensors),
            'total_bytes': reader.total_bytes,
            'params': config.num_params(),
        }
        if args.tensors:
            doc['tensor_list'] = [
                {'name': name, 'dtype': _dtype_name(t),
                 'shape': list(t.shape), 'shard': t.shard}
                for name, t in sorted(reader.tensors.items())]
    print(json.dumps(doc, indent=2))
    return 0


def _cmd_import(args) -> int:
    mesh = None
    if args.mesh:
        # One process per device, as serving and training run a mesh:
        # each rank imports its cut of every tensor.
        from skypilot_tpu_torch.parallel import mesh as mesh_lib
        mesh = mesh_lib.mesh_from_env(mesh_lib.MeshSpec.parse(args.mesh),
                                      args.device)
    try:
        params, config, stats = hf_import.load_params(
            args.checkpoint, device=None if mesh else args.device,
            mesh=mesh, strict=args.strict, concurrency=args.concurrency)
        del params  # the point was proving the load; free the device
    finally:
        if mesh is not None:
            mesh_lib.shutdown()
    print(json.dumps({
        'rc': 0,
        'family': hf_import.infer_family(config),
        'num_layers': config.num_layers,
        'seconds': round(stats.seconds, 3),
        'bytes_read': stats.bytes_read,
        'tensors': stats.tensors,
        'shards': stats.shards,
        'peak_host_bytes': stats.peak_host_bytes,
        'largest_tensor_bytes': stats.largest_tensor_bytes,
    }))
    return 0


def _finite_violations(tensor: safetensors_io.LazyTensor) -> int:
    """Count non-finite values, streamed in bounded chunks (BF16 is read
    as its uint16 bits and widened to f32 per chunk)."""
    if not safetensors_io.is_float_dtype(tensor.tag):
        return 0
    flat = tensor.read().reshape(-1)
    bad = 0
    for start in range(0, flat.size, _SCAN_CHUNK):
        chunk = safetensors_io.to_float32(flat[start:start + _SCAN_CHUNK],
                                          tensor.tag)
        bad += int(np.size(chunk) - np.count_nonzero(np.isfinite(chunk)))
    return bad


def _diff_one(a: safetensors_io.LazyTensor,
              b: safetensors_io.LazyTensor) -> Optional[str]:
    """Per-tensor diff line, or None when identical. A separate function
    so the mmap views die with the call frame: a reader cannot close
    while views onto its mapping are live."""
    if a.shape != b.shape or a.tag != b.tag:
        return (f'{_dtype_name(a)}{list(a.shape)} vs reference '
                f'{_dtype_name(b)}{list(b.shape)}')
    av, bv = a.read(), b.read()
    # Bytewise first (exact, dtype-agnostic, zero-copy over the views);
    # only on a mismatch pay for the numeric detail.
    if np.array_equal(av.view(np.uint8), bv.view(np.uint8)):
        return None
    is_float = safetensors_io.is_float_dtype(a.tag)
    af = safetensors_io.to_float32(av, a.tag) if is_float else av
    bf = safetensors_io.to_float32(bv, b.tag) if is_float else bv
    with np.errstate(invalid='ignore'):
        delta = np.abs(af - bf)
        mismatched = int(np.sum(af != bf))
        max_abs = float(np.nanmax(delta)) if delta.size else 0.0
    return (f'{mismatched}/{av.size} values differ '
            f'(max abs diff {max_abs:.6g})')


def _dtype_name(t: safetensors_io.LazyTensor) -> str:
    """The numpy name the reference prints (BF16 is 'bfloat16' there)."""
    return 'bfloat16' if t.tag == 'BF16' else str(t.dtype)


def _verify_against(reader: safetensors_io.CheckpointReader,
                    against_dir: str, findings: List[str]) -> None:
    with safetensors_io.CheckpointReader(against_dir) as ref:
        ours, theirs = set(reader.names()), set(ref.names())
        for name in sorted(theirs - ours):
            findings.append(f'{name}: missing (present in reference)')
        for name in sorted(ours - theirs):
            findings.append(f'{name}: unexpected (absent from '
                            'reference)')
        for name in sorted(ours & theirs):
            line = _diff_one(reader.tensor(name), ref.tensor(name))
            if line is not None:
                findings.append(f'{name}: {line}')


def _cmd_verify(args) -> int:
    findings: List[str] = []
    try:
        family, config = hf_import.detect_config(args.checkpoint)
    except (hf_import.HFImportError,
            safetensors_io.CheckpointFormatError) as e:
        print(f'VERIFY FAILED: {e}')
        return 1
    try:
        reader = safetensors_io.CheckpointReader(args.checkpoint)
    except safetensors_io.CheckpointFormatError as e:
        print(f'VERIFY FAILED (structural): {e}')
        return 1
    with reader:
        present = set(reader.names())
        expected = set(hf_import.expected_hf_names(config))
        for name in sorted(expected - present):
            findings.append(f'{name}: missing from checkpoint')
        for name in sorted(present - expected):
            if hf_import.is_ignorable(name, config):
                continue
            findings.append(f'{name}: not an engine-mappable tensor '
                            f'for family {family!r}')
        for spec in hf_import.param_specs(config):
            names = ([spec.hf.format(i=i)
                      for i in range(config.num_layers)]
                     if spec.stacked else [spec.hf])
            want = hf_import._hf_shape(spec, config)
            for name in names:
                tensor = reader.tensors.get(name)
                if tensor is None:
                    continue  # already reported as missing
                if tensor.shape != want:
                    findings.append(
                        f'{name}: shape {list(tensor.shape)} != '
                        f'config geometry {list(want)}')
                    continue
                bad = _finite_violations(tensor)
                if bad:
                    findings.append(
                        f'{name}: {bad} non-finite value(s)')
        if args.against:
            try:
                _verify_against(reader, args.against, findings)
            except safetensors_io.CheckpointFormatError as e:
                findings.append(f'reference checkpoint unreadable: {e}')
    if findings:
        print(f'VERIFY FAILED ({len(findings)} finding(s), '
              f'family={family}):')
        for line in findings:
            print(f'  {line}')
        return 1
    print(f'VERIFY OK: family={family}, '
          f'{len(present)} tensors, {reader.num_shards} shard(s)')
    return 0


def _cmd_export(args) -> int:
    from skypilot_tpu_torch import models as models_lib
    from skypilot_tpu_torch.train import checkpoints as train_ckpts

    _family, config = models_lib.resolve(args.model)
    params = train_ckpts.restore_params(args.orbax, config,
                                        device=args.device)
    stats = hf_export.export_params(
        params, config, args.out,
        max_shard_bytes=args.max_shard_bytes)
    print(json.dumps({
        'rc': 0, 'out': args.out, 'tensors': stats.tensors,
        'bytes_written': stats.bytes_written, 'shards': stats.shards,
        'seconds': round(stats.seconds, 3),
    }))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.checkpoints')
    sub = parser.add_subparsers(dest='cmd', required=True)

    p = sub.add_parser('inspect', help='family/geometry/shard summary')
    p.add_argument('checkpoint')
    p.add_argument('--tensors', action='store_true',
                   help='include the full tensor inventory')
    p.set_defaults(fn=_cmd_inspect)

    p = sub.add_parser('import',
                       help='stream the checkpoint onto a device and '
                            'print import stats')
    p.add_argument('checkpoint')
    p.add_argument('--device', default=None,
                   help="Target device (default CUDA; 'cpu' for the "
                        'CPU).')
    p.add_argument('--mesh', default=None,
                   help='Import under a device mesh, e.g. fsdp=2 or '
                        'tensor=2: one process per device, each started '
                        'with the same flags and the gang variables '
                        '(SKYTPU_COORDINATOR_ADDR, SKYTPU_NUM_PROCESSES, '
                        'SKYTPU_PROCESS_ID); each rank places its cut of '
                        'every tensor and prints its own stats.')
    p.add_argument('--strict', default=None,
                   action=argparse.BooleanOptionalAction,
                   help='Fail on unexpected tensors (default: '
                        'SKYTPU_HF_IMPORT_STRICT).')
    p.add_argument('--concurrency', type=int, default=None,
                   help='Read/transform threads ahead of device '
                        'placement (default: '
                        'SKYTPU_HF_IMPORT_CONCURRENCY).')
    p.set_defaults(fn=_cmd_import)

    p = sub.add_parser('verify',
                       help='structural + mapping + finite checks; '
                            'nonzero exit with a per-tensor report '
                            'on any finding')
    p.add_argument('checkpoint')
    p.add_argument('--against', default=None,
                   help='Reference checkpoint dir: adds a per-tensor '
                        'numeric diff (round-trip audits).')
    p.set_defaults(fn=_cmd_verify)

    p = sub.add_parser('export',
                       help='train checkpoint -> HF safetensors dir '
                            '(fine-tune round trip)')
    p.add_argument('--orbax', required=True,
                   help='Train checkpoint dir, as written by the port\'s '
                        'train/loop.py --checkpoint-dir (the flag keeps '
                        'the reference\'s name; the port does not read '
                        'Orbax).')
    p.add_argument('--model', required=True,
                   help='Config name resolvable by models.resolve (the '
                        'export geometry).')
    p.add_argument('--out', required=True)
    p.add_argument('--max-shard-bytes', type=int, default=5 * 2**30)
    p.add_argument('--device', default=None,
                   help="Device the params pass through (default CUDA; "
                        "'cpu' for the CPU).")
    p.set_defaults(fn=_cmd_export)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except (hf_import.HFImportError,
            safetensors_io.CheckpointFormatError,
            FileNotFoundError) as e:
        print(f'error: {e}', file=sys.stderr)
        return 1


if __name__ == '__main__':
    sys.exit(main())
