"""Offline batch inference for the port: JSONL in, JSONL out, no HTTP.

Ports `skypilot_tpu/inference/batch.py`: `run_batch` (:31-80) and
`main` (:83-175), with every flag, plus `--device` as the server has it
(default CUDA; `--device cpu` runs the plain paths). It rides the same
`InferenceEngine` as the server, so continuous batching packs the
request list into the fixed decode batch and slots recycle as sequences
finish. Prefill is not interleaved (`prefill_interleave=0`): offline
there are no streams to protect, and the batched chunk scan admits
every free slot at once.

    python3 -m skypilot_tpu_torch.inference.batch \\
        --model llama3-8b --checkpoint /ckpts/llama3-8b \\
        --input prompts.jsonl --output completions.jsonl \\
        --batch-size 32 --max-new-tokens 256

`--checkpoint` takes an HF safetensors dir or a port train checkpoint
(`train/checkpoints.py`), layout auto-detected; an HF dir's geometry
wins over `--model`, a train checkpoint must fit it. `--mesh` (any
axis the server's takes: `tensor=N`, `expert=N` for an MoE `--model`,
`fsdp=N`, `context=N`, ...; with `--draft-model` too) runs one process
per rank, each started with the same flags and the gang
variables (SKYTPU_COORDINATOR_ADDR, SKYTPU_NUM_PROCESSES,
SKYTPU_PROCESS_ID), as the server's: rank 0 reads the input and writes
the output, the others follow its engine until it is done.

Input lines: {"prompt_tokens": [...]} (+ optional per-line
"max_new_tokens", "temperature", "top_k", "eos_token_id", "id"). Output
lines carry the input id (or the line index) and the generated tokens,
in input order; a request that never finished raises instead of
writing a null line. Token-id interface like the server: tokenization
is the caller's.
"""
import argparse
import json
import sys
import time
from typing import Any, Dict, List


def run_batch(engine, requests: List[Dict[str, Any]],
              default_sampling) -> List[Dict[str, Any]]:
    """Submit every request, drain to completion, preserve order."""
    from skypilot_tpu_torch import inference as inf

    rid_to_idx = {}
    for idx, req in enumerate(requests):
        sampling = inf.SamplingParams(
            temperature=float(req.get('temperature',
                                      default_sampling.temperature)),
            top_k=int(req.get('top_k', default_sampling.top_k)),
            max_new_tokens=int(req.get('max_new_tokens',
                                       default_sampling.max_new_tokens)),
            eos_token_id=req.get('eos_token_id',
                                 default_sampling.eos_token_id))
        rid = engine.submit(req['prompt_tokens'], sampling)
        rid_to_idx[rid] = idx

    t0 = time.perf_counter()
    # run_to_completion caps its steps per call: drain until the engine
    # is truly idle rather than truncating a large batch.
    finished: Dict[int, List[int]] = {}
    while engine.has_work:
        finished.update(engine.run_to_completion())
    elapsed = time.perf_counter() - t0
    total_tokens = sum(len(t) for t in finished.values())
    out: List[Any] = [None] * len(requests)
    for rid, tokens in finished.items():
        idx = rid_to_idx[rid]
        out[idx] = {
            'id': requests[idx].get('id', idx),
            'tokens': tokens,
            'num_tokens': len(tokens),
        }
    missing = [requests[i].get('id', i)
               for i, rec in enumerate(out) if rec is None]
    if missing:
        # A null line in the output JSONL looks like success downstream;
        # fail the job instead.
        raise RuntimeError(
            f'{len(missing)} requests never finished '
            f'(first few ids: {missing[:5]})')
    sys.stderr.write(
        f'[batch] {len(requests)} requests, {total_tokens} tokens in '
        f'{elapsed:.1f}s ({total_tokens / max(elapsed, 1e-9):.0f} tok/s)\n')
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='tiny')
    parser.add_argument('--checkpoint', default=None,
                        help='HF safetensors dir or port train checkpoint '
                             'dir (layout auto-detected).')
    parser.add_argument('--input', required=True,
                        help='JSONL with {"prompt_tokens": [...]} lines')
    parser.add_argument('--output', required=True)
    parser.add_argument('--device', default='cuda',
                        help="Torch device ('cuda' by default; 'cpu' runs "
                             'the plain PyTorch paths).')
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--max-seq-len', type=int, default=None)
    parser.add_argument('--max-new-tokens', type=int, default=64)
    parser.add_argument('--temperature', type=float, default=0.0)
    parser.add_argument('--top-k', type=int, default=0)
    parser.add_argument('--mesh', default=None,
                        help='Shard over a device mesh, e.g. tensor=2, '
                             'expert=2 (an MoE), fsdp=2 or context=2: one '
                             'process per rank (see inference.server '
                             '--help); rank 0 reads --input and writes '
                             '--output.')
    parser.add_argument('--draft-model', default=None,
                        help='Speculative decoding: a small same-vocab '
                             'draft model proposes spec-k tokens per '
                             'verify pass (greedy requests; lossless). '
                             'See inference.server --help.')
    parser.add_argument('--draft-checkpoint', default=None)
    parser.add_argument('--spec-k', type=int, default=None,
                        help='Draft tokens per speculative round '
                             '(default: SKYTPU_SPEC_K).')
    parser.add_argument('--spec-fuse-rounds', type=int, default=None,
                        help='Speculative rounds per host dispatch '
                             '(default: SKYTPU_SPEC_FUSE_ROUNDS; 1 = one '
                             'dispatch per round).')
    parser.add_argument('--kv-quant', default='auto',
                        choices=['auto', 'none', 'int8'],
                        help='int8 KV cache (see inference.server --help).')
    parser.add_argument('--decode-fuse-steps', type=int, default=None,
                        help='Decode steps per host dispatch (default: '
                             'SKYTPU_DECODE_FUSE_STEPS; 1 = host-stepped).')
    parser.add_argument('--kv-page-size', type=int, default=None,
                        help='Positions per KV page (default: '
                             'SKYTPU_KV_PAGE_SIZE; 0 = dense cache).')
    parser.add_argument('--kv-pages', type=int, default=None,
                        help='Paged KV pool size in pages (0/default = '
                             'dense-equivalent).')
    parser.add_argument('--prefix-cache', default='auto',
                        choices=['auto', 'on', 'off'],
                        help='Cross-request prefix KV reuse: batches whose '
                             'prompts share long prefixes prefill only the '
                             'unmatched tails. auto = SKYTPU_PREFIX_CACHE '
                             '(on).')
    parser.add_argument('--prefix-cache-max-pages', type=int, default=None,
                        help='Cap on pages the prefix cache retains '
                             '(default: SKYTPU_PREFIX_CACHE_MAX_PAGES; 0 = '
                             'pool-bounded).')
    return parser


def engine_kwargs(args) -> Dict[str, Any]:
    """build_engine's arguments for parsed flags: what `main` builds, so
    a caller can build the same engine in its own process."""
    from skypilot_tpu_torch.inference import server
    return dict(
        device=args.device, checkpoint=args.checkpoint, mesh_arg=args.mesh,
        batch_size=args.batch_size, max_seq_len=args.max_seq_len,
        kv_quant=args.kv_quant, draft_model=args.draft_model,
        draft_checkpoint=args.draft_checkpoint, spec_k=args.spec_k,
        spec_fuse_rounds=args.spec_fuse_rounds,
        decode_fuse_steps=args.decode_fuse_steps,
        kv_page_size=args.kv_page_size, kv_pages=args.kv_pages,
        prefix_cache=server.prefix_cache_arg(args.prefix_cache),
        prefix_cache_max_pages=args.prefix_cache_max_pages,
        # Offline: no in-flight streams to protect, and interleaving
        # would serialize long-prompt prefill one slot at a time: keep
        # the batched chunk scan.
        prefill_interleave=0)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    try:
        _main(args)
    finally:
        mesh_lib.shutdown()


def _main(args) -> None:
    from skypilot_tpu_torch import envs
    from skypilot_tpu_torch import inference as inf

    if args.mesh and envs.SKYTPU_PROCESS_ID.get(strict=True) > 0:
        inf.build_engine(args.model, **engine_kwargs(args)).follow()
        return
    with open(args.input, encoding='utf-8') as f:
        requests = [json.loads(line) for line in f if line.strip()]
    if not requests:
        raise SystemExit(f'No requests in {args.input}')

    engine = inf.build_engine(args.model, **engine_kwargs(args))
    default_sampling = inf.SamplingParams(
        temperature=args.temperature, top_k=args.top_k,
        max_new_tokens=args.max_new_tokens)
    try:
        results = run_batch(engine, requests, default_sampling)
    finally:
        engine.stop_followers()
    with open(args.output, 'w', encoding='utf-8') as f:
        for rec in results:
            f.write(json.dumps(rec) + '\n')


if __name__ == '__main__':
    main()
