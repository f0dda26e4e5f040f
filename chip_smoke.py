#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (skypilot_tpu_torch) end to end on one GPU.

    python3 chip_smoke.py            # every phase, one CUDA device

Phases, each printing one JSON line:
  1. toolchain  - torch/CUDA/nvcc versions, the card's name and power
                  limit, and the build of the hand-written kernels
                  (ops/csrc/flash_fwd.cu and flash_bwd.cu, one nvcc for
                  sm_90a per source, started together) with its time;
                  ptxas' registers, spills and wgmma serialisation of
                  every forward and backward kernel instance (`ptxas`),
                  the head_dim 256 instances of K1/K2 among them.
                  An instance that spills or has its wgmmas serialised
                  fails.
  2. check_bf16 - K1 (flash_attention) against its plain PyTorch version
                  on the card: cached-prefill offset, window + softcap,
                  fully-masked rows, the engine's prefill shape, head_dim
                  64, ragged q/kv tiles at an unaligned offset, four
                  warm tails of a prefix-cache hit (16 to 512 rows at
                  page-aligned offsets, and the repeat's 16 rows at
                  1215), gemma2-9b heads at head_dim 256 with softcap 50
                  (a local layer past its 4096 window, a global layer,
                  masked rows, ragged tiles, a 16-row warm tail),
                  gemma2-2b heads at the engine's chunk, qwen2.5-1.5b's
                  GQA group of 6 and mistral-7b's all-local window,
                  within TOL_O on O and TOL_LSE on lse.
  3. check_int8 - K2 (flash_attention_quant) the same way.
  4. timing     - per kernel at the engine's prefill shape (K1 also at
                  the training shape, TRAIN_TIMING_SHAPE, and at gemma2-2b's,
                  GEMMA_TRAIN_TIMING_SHAPE; both kernels
                  at gemma2-9b's heaviest chunk, GEMMA_TIMING_SHAPE, for
                  a local and a global layer at softcap 50, and at the
                  prefix phase's shapes after it): kernel, plain
                  version, scaled_dot_product_attention as a yardstick
                  (timed only, never used by the port; it has no
                  softcap, so it runs the function without one, and so
                  does `ms_softcap_off`), and the bound.
  5. engine_bf16 - build_engine('llama3-8b') at full width and depth with
                  random weights: prefill logits through the kernel
                  against the plain version and against the dense
                  forward, prefill and decode throughput, then the main
                  path: 9 requests (one interleaved) run to completion
                  with the K1 launch count read around it.
  6. engine_int8 - the same engine over an int8 KV cache (K2).
  7. server     - the port's HTTP server in-process: /health and three
                  /generate requests, one streaming. The phase runs the
                  telemetry plane (every trace kept, the sampler at
                  0.2 s, the watchdog at 0.5 s) and prints an
                  `observability` line: /metrics scraped before and
                  after, its counter deltas held exactly to the prompt
                  and generated tokens, the finished requests, the
                  POST 200s, and the host steps that decode and the
                  prefills, counted outside the engine's books
                  (`engine_calls`); each response's X-Trace-ID pulled from
                  /internal/trace, a tree rooted at `inference.request`
                  with the engine's admission, prefill and decode spans
                  inside it; a windowed rate from /internal/timeseries
                  and the default rules from /internal/alerts.
 7b. overhead   - decode host-step time on three engines of the main
                  path's shape (ENGINE_KW: 8 slots, fused decode, here
                  OVERHEAD_FUSE steps a host step) over the same 8
                  prompts, one step each a round in a rotating order,
                  the sampler and the watchdog running through all the
                  rounds (their passes counted): two engines with
                  tracing off, one with every trace kept. The median
                  per-round ratio of the traced to the untraced, minus
                  1, plus the threads' own host time at their cadence,
                  must stay within TOL_OBS_OVERHEAD, beside the
                  reference's 2% and 1% targets and the two untraced
                  engines' reading (the noise floor).
 12. prefix_bf16 - the prefix cache (on by default) on the llama3-8b
                  engine: a cold request (1024-token prefix + 192), 8 warm
                  ones (the prefix + 64-448 tokens), the cold prompt again
                  (a full-prompt match, one page copied on write). Every
                  warm request must match 1024 tokens and run its tail
                  through K1 at q_offset 1024; warm first-token logits
                  within TOL_LOGITS_REL of an engine with the cache off;
                  time to first token, chunk widths, page accounting.
                  Then K1 against its plain version, and timed, at every
                  (B, rows, Skv, q_offset) a cache hit launched, each
                  beside its launch count in the phase (`hit_checks`,
                  the `warm_tail` entries of `shapes`).
 13. prefix_int8 - the same on the int8 engine (K2).
 14. migration  - engine to engine: two requests (600, 1500 tokens)
                  snapshotted after 16 tokens, aborted, restored into a
                  second engine, token for token equal to an uninterrupted
                  run, after a first snapshot refused by the armed
                  `engine.snapshot` fault seam (FaultInjected, one
                  FAULTS_INJECTED); blob bytes, snapshot and restore ms.
                  Server to
                  server: a stream drained by /internal/drain into a
                  migrate frame continues through /internal/restore on a
                  second server with no token lost or repeated; a
                  corrupted blob gets 400.
 15. spec       - speculative decode on llama3-8b (no interleave, SPEC_KW):
                  8 greedy prompts of 100-1500 tokens, 32 new each, with
                  the llama3-1b draft (spec_k 4, 8 rounds a dispatch),
                  bf16 then int8 target KV, token for token against the
                  same engine without a draft; a divergence passes only
                  as a near-tie: both tokens within TOL_SPEC_GAP of the
                  target's top logit there.
                  A draft that is the target itself (one params object)
                  must accept at least TOL_SPEC_ACCEPT of its proposals.
                  Round costs against plain fused decode; K1 (K2) must
                  launch on the spec engines' prefill. Then the port's
                  server as a process with --draft-model llama3-1b:
                  greedy /generate against the draft-free server, and
                  /health's spec.rounds > 0.
 16. gemma_bf16 - build_engine('gemma2-9b') at full width and depth (42
                  layers, d 256, vocab 256128, random weights, seed 0;
                  GEMMA_KW: 8 slots, max_seq_len 8192, chunk 512, page
                  64, batched prefill): prefill logits through K1 against
                  the plain version and the dense forward (a 5000-token
                  prompt, past the window), then 8 greedy prompts of
                  1000-7000 tokens (two past 4608), 32 new each, with K1's
                  launches read around them and held to the count the
                  batched prefill must make (every chunk of every layer:
                  42 x 16); prefill and decode tok/s, a profiled batch,
                  peak memory.
 17. gemma_int8 - the same engine over an int8 KV cache (K2).
 18. checkpoint - a synthetic HF gemma2 checkpoint (gemma2-2b widths,
                  depth cut to 2 layers) written by the port's writer
                  over two shards with an index, imported (every tensor
                  equal; seconds and peak host bytes), then served by
                  build_engine(checkpoint=) and by the server as a process
                  with --checkpoint: greedy /generate token for token
                  equal; the import's CKPT_IMPORT_* deltas equal its
                  ImportStats. (12-18 run after phase 7.)
  8. check_bwd  - K3 (flash_attention_dq) and K4 (flash_attention_dkv,
                  ops/csrc/flash_bwd.cu) against flash_attention_bwd_plain
                  on the same bf16 inputs: the training shape, rows with
                  no visible key (dQ must be 0 there), ragged tiles,
                  window + softcap, non-causal ragged, q_offset and
                  head_dim 64 MHA; at head_dim 256, gemma2-2b's local and
                  global layers at seq 8192 (softcap 50), rows with no
                  visible key, ragged tiles, non-causal, and softcap 2
                  (its Jacobian far from 1); max|a-b| / max|b| of dQ, dK
                  and dV within TOL_BWD_REL; and K1's O and lse, which both
                  take, against flash_attention_plain at each of these
                  cases within TOL_O and TOL_LSE.
  9. timing_bwd - K3 and K4 at the training shape and (d 256) at gemma2-2b's
                  local and global layers: kernel (and, at softcap 50, the
                  kernel with the softcap off), plain version, the
                  backward of scaled_dot_product_attention over the same
                  mask without the softcap as a yardstick for both
                  together (never used by the port), and each kernel's
                  bound.
 10. train_parity - one loss_fn + backward at bench-8b widths (2 layers,
                  S2048) through attention_impl 'flash' and 'dense': loss
                  and grad norm within TOL_TRAIN_LOSS / TOL_TRAIN_GRAD_REL,
                  the wq (K3), wk and wv (K4) grads within
                  TOL_TRAIN_PROJ_REL.
 11. train      - the training main path: skypilot_tpu_torch.train.loop.fit
                  on bench-8b (5 layers at llama3-8b width, vocab 32768),
                  batch 1 x 4096, random weights and a fixed synthetic
                  batch, with the K1/K3/K4 launch counts read around it;
                  the loss must be finite and fall; TRAIN_STEP, the
                  TRAIN_TOKENS and TRAIN_STEP_SECONDS deltas, TRAIN_LOSS
                  and TRAIN_MFU must equal the loop's own steps and last
                  logged values; step time, tok/s, MFU,
                  peak memory, and one step under the profiler.
 19. train_parity_gemma - train_parity at gemma2-2b widths (d 256), 2
                  layers (one local, one global), seq 8192, the same
                  limits.
 20. train_gemma - the training main path on gemma2-2b at full width and
                  depth (26 layers), batch 1 x 8192, 10 steps: K3 and K4
                  must launch exactly 26 x 10 times, K1 2 x 26 x 10, K2
                  never; the loss must be finite and fall; the TRAIN_*
                  instruments as in phase 11; step time,
                  tok/s, MFU, peak memory, the optimizer's ms and one step
                  under the profiler. (19-20 run after phase 11.)
Then a `kernels` line and, last, {"ok": true, "device": {...}}.
Any failure raises (non-zero exit). Without CUDA it exits non-zero
before printing any result.
"""
import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak, H100 SXM
H100_HBM_BYTES = 3.35e12   # HBM3 bytes/s, H100 SXM
# Limits of the kernel checks, kernel against plain version on the same
# inputs. Sound kernels read max |dO| 0.0039 at the serving shapes and
# 0.0078 at the training shape (one bf16 step at |O| in [0.5, 1) and
# [1, 2)) and max |dlse| 2e-6; kernel_fault_check.py shows that planted
# faults (a dropped kv tile, a dropped diagonal, a stale ring stage, an
# unmasked frontier tile) break them.
TOL_O = 0.01               # max |O_kernel - O_plain|, bf16 output
TOL_LSE = 1e-3             # max |lse_kernel - lse_plain| on finite rows
TOL_LOGITS_REL = 0.05      # prefill logits, max|a-b| / max|b|
# Limits of the backward checks, kernel against plain version on the same
# inputs, max|a-b| / max|b| of each of dQ, dK, dV. Both are bf16, so a
# sound reading is whole bf16 steps over max|b|: one step at the largest
# element reads 2^-8 to 2^-7, and the limit admits two. Sound kernels
# read at most 0.0061 (one step; bwd_accuracy.py over three seeds), at
# head_dim 256 at most 0.0043; kernel_fault_check.py's d 64/128 backward
# faults read 0.073 and more, its d 256 ones 0.339 and more on their
# strongest case (the unmasked window edge 0.0205 on gemma2b_local). Rows
# with no visible key must give dQ = 0 exactly.
TOL_BWD_REL = 0.02
# flash against dense training at bench-8b widths (bf16 through 2
# layers): |loss_f - loss_d|, |gnorm_f - gnorm_d| / gnorm_d, and
# max|a-b| / max|b| of the stacked wq, wk and wv grads. Sound readings
# on the H100: 3.1e-4, 2.8e-5 and at most 0.0136; kernel_fault_check.py's
# K3/K4 faults read a grad-norm difference of 0.0050 and more, and 0.20
# and more on the grads of the projection each breaks. The loss limit
# holds only the forward (K1), which check_bwd also holds at the training
# shape.
TOL_TRAIN_LOSS = 0.005
TOL_TRAIN_GRAD_REL = 1e-3
TOL_TRAIN_PROJ_REL = 0.05
PARITY_PROJ = ('wq', 'wk', 'wv')
# Speculative decode against plain greedy on the card. The spec path
# verifies k tokens in one [B, k] forward where plain decode runs [B, 1]
# ones: other GEMM kernels, other bf16 rounding. The logits are bf16
# values (steps of 0.03125 at the random-weight llama3-8b's top logits),
# so exact ties and near-ties at the top are common and a path may flip
# one. At the first divergence, a dense forward over the prompt and the
# draft-free tokens before it gives each path's token a deficit, the top
# logit minus its own; the divergence passes only where both are below
# TOL_SPEC_GAP. Sound readings (this script and spec_fault_check.py on
# an H100 at 700 W): 9 of 16 bf16 and int8 requests diverge here, with
# deficits 0 to 0.0625; spec_fault_check.py's wrong rounds emit tokens
# 0.25 to 7.7 below the top. The target as its own draft accepts at
# most 31 of every 32 proposals (the last round's budget), and its
# [B, 1] draft decodes flip near-ties against the [B, k] verify: sound
# 0.8676 and 0.8696; the planted pairing and length faults read 0.0 to
# 0.48.
TOL_SPEC_GAP = 0.25
TOL_SPEC_ACCEPT = 0.75
KERNEL_SOURCE = 'skypilot_tpu_torch/ops/csrc/flash_fwd.cu'
BWD_SOURCE = 'skypilot_tpu_torch/ops/csrc/flash_bwd.cu'
# The train phase: steps, peak learning rate and warmup on the fixed batch.
TRAIN_STEPS = 20
TRAIN_LR = 1e-3
TRAIN_WARMUP = 3
DEV = 'cuda'
# About 20 ms of device spin at the H100's 1.98 GHz boost clock: far
# longer than the host takes to queue ten timed calls.
QUEUE_AHEAD_CYCLES = 40_000_000
# The main path's engine: llama3-8b slots, cache and chunking.
ENGINE_KW = dict(batch_size=8, max_seq_len=2048, prefill_chunk=512,
                 kv_page_size=64, prefill_interleave=1536)
# The spec phase: the same engine without interleave (a draft forbids
# it), its target and draft presets, draft length and rounds a dispatch.
SPEC_KW = dict(batch_size=8, max_seq_len=2048, prefill_chunk=512,
               kv_page_size=64)
SPEC_MODEL = 'llama3-8b'
SPEC_DRAFT = 'llama3-1b'
SPEC_K = 4
SPEC_ROUNDS = 8
SPEC_NEW = 32
SPEC_PROMPT_LENGTHS = (100, 1500)    # 8 prompts drawn in this range
SPEC_SERVER_PROMPT = 300
# The telemetry plane's cost on a decode host step (see overhead_phase):
# a traced engine's steps against an untraced one's, read within rounds
# with the sampler and the watchdog running through them, plus the two
# threads' own host time at their cadence. The limit sits above the
# noise two untraced engines read against each other (`aa_frac`) and
# below a render of the registry four times a generated token
# (obs_overhead_check.py plants it). The reference's targets (met on a
# CPU with the tiny model: tracing 2%, sampler and watchdog 1%) stand
# beside the reading.
TOL_OBS_OVERHEAD = 0.10
OBS_TARGETS = {'trace': 0.02, 'sampler_and_watchdog': 0.01}
OVERHEAD_ROUNDS = 60
OVERHEAD_PROMPT = 128
# Decode steps a host step in the overhead phase: a quarter of the
# default 8, so a cost paid once a host step reads four times as large
# against it (the stricter reading).
OVERHEAD_FUSE = 2
# The knobs of each telemetry mode (every other one of them unset). A
# mode that sets the sampler's interval runs the sampler and the
# watchdog threads.
OBS_ENV = {'off': {'SKYTPU_TRACE_MAX_SPANS': '0'},
           'threads': {'SKYTPU_TRACE_MAX_SPANS': '0',
                       'SKYTPU_TS_SAMPLE_SECONDS': '0.2',
                       'SKYTPU_WATCHDOG_TICK_SECONDS': '0.5'},
           'on': {'SKYTPU_TRACE_SAMPLE': '1.0',
                  'SKYTPU_TS_SAMPLE_SECONDS': '0.2',
                  'SKYTPU_WATCHDOG_TICK_SECONDS': '0.5'}}
# The overhead phase's engines and the mode each admits its prompts in
# (tracing is decided at admission).
OVERHEAD_ENGINES = (('off', 'off'), ('off2', 'off'), ('on', 'on'))
OBS_ROOT = 'inference.request'
# The server phase: its engine, and its three requests (prompt tokens 1..n,
# new tokens, streamed).
SERVER_KW = dict(batch_size=4, max_seq_len=2048, prefill_chunk=512,
                 kv_page_size=64)
SERVER_REQUESTS = ((300, 8, False), (900, 12, False), (600, 16, True))


def emit(phase, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def ptxas_entries(log, prefix):
    """Per kernel instance whose name starts with `prefix`, from nvcc's
    -Xptxas=-v log: registers at entry, spill stores and loads (bytes),
    and whether ptxas serialised its wgmmas (C7512)."""
    import re
    out, cur = [], None
    serialized = set(re.findall(r"serialized due to insufficient register "
                                r"resources for the function '(\w+)'", log))
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {'kernel': m.group(1), 'registers': None,
                   'spill_stores': None, 'spill_loads': None,
                   'serialized': m.group(1) in serialized}
            if prefix in m.group(1):
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            cur['spill_stores'], cur['spill_loads'] = map(int, m.groups())
        m = re.search(r'Used (\d+) registers', line)
        if m:
            cur['registers'] = int(m.group(1))
    return out


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def time_ms(torch, fn, iters=10, warmup=2, queue_ahead=False):
    """Mean device time of fn() in ms, by CUDA events over `iters`
    back-to-back calls after `warmup` calls. With `queue_ahead` the
    stream first spins on the device (QUEUE_AHEAD_CYCLES) while the host
    queues the calls, so a call whose host side outlasts its kernels
    reads their time, not the host's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attn_inputs(torch, gen, b, t, s, h, kv, d, quant):
    dev = DEV
    q = torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, s, kv, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, s, kv, d, generator=gen, device=dev).bfloat16()
    if not quant:
        return q, k, v, None, None
    from skypilot_tpu_torch.inference.engine import quantize_kv
    kq, vq = quantize_kv(k), quantize_kv(v)
    return q, kq['q'], vq['q'], kq['s'], vq['s']


def visible_span(t, s, off, window):
    """(query-key pairs visible under the causal/window mask, number of
    kv positions any query needs) for one (batch, head)."""
    pairs, lo_min, hi_max = 0, s, 0
    for row in range(t):
        qp = off + row
        hi = min(s, qp + 1)
        lo = max(0, qp - window + 1) if window is not None else 0
        if hi > lo:
            pairs += hi - lo
            lo_min, hi_max = min(lo_min, lo), max(hi_max, hi)
    return pairs, max(0, hi_max - lo_min)


def bound_ms(b, t, s, h, kv, d, off, window, quant):
    pairs, kv_rows = visible_span(t, s, off, window)
    flops = 4.0 * b * h * d * pairs
    esz = 1 if quant else 2
    nbytes = (b * t * h * d * 2                       # q
              + 2 * b * kv_rows * kv * d * esz       # k, v (needed rows)
              + (2 * b * kv_rows * kv * 4 if quant else 0)  # scales
              + b * t * h * d * 2 + b * h * t * 4)   # o, lse
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes', flops)


def kernel_reading(torch, fa, gen, quant, b, t, s, h, kv, d, off, window,
                   softcap):
    """K1 (K2 with `quant`) vs plain version on the same inputs, as
    `fwd_compare` reads them."""
    q, k, v, ks, vs = attn_inputs(torch, gen, b, t, s, h, kv, d, quant)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=off)
    o_k, lse_k = fa.flash_fwd(q, k, v, k_scale=ks, v_scale=vs, **kw)
    if quant:
        o_p, lse_p = fa.flash_attention_quant_plain(q, k, ks, v, vs, **kw)
    else:
        o_p, lse_p = fa.flash_attention_plain(q, k, v, **kw)
    return {'shape': [b, t, s, h, kv, d], 'q_offset': off,
            'window': window, 'softcap': softcap,
            **fwd_compare(torch, o_k, lse_k, o_p, lse_p)}


def fwd_compare(torch, o_k, lse_k, o_p, lse_p):
    """Kernel (O, lse) vs plain (O, lse): max |dO|, max |dlse| over rows
    finite on both, whether the lse = +inf rows agree, and the largest
    |O| the kernel gives on the plain version's masked rows."""
    torch.cuda.synchronize()
    finite = torch.isfinite(lse_p)
    both = finite & torch.isfinite(lse_k)
    masked = ~finite[..., 0]                          # [B,H,T]
    n_masked = int(masked.sum())
    return {'max_abs_err': float((o_k.float() - o_p.float()).abs().max()),
            'lse_max_abs_err': (float((lse_k - lse_p)[both].abs().max())
                                if bool(both.any()) else 0.0),
            'inf_rows_agree': bool(torch.equal(torch.isfinite(lse_k),
                                               finite)),
            'masked_rows': n_masked,
            'masked_rows_max_abs_o': (float(o_k.permute(0, 2, 1, 3)[masked]
                                            .float().abs().max())
                                      if n_masked else 0.0)}


def kernel_faults(c):
    """The limits a kernel reading breaks; empty when it passes."""
    faults = []
    if not c['inf_rows_agree']:
        faults.append('lse = +inf rows differ from the plain version')
    if c['masked_rows_max_abs_o'] != 0:
        faults.append('fully-masked rows must give O = 0')
    if not c['max_abs_err'] < TOL_O:
        faults.append(f"max|dO| {c['max_abs_err']} >= {TOL_O}")
    if not c['lse_max_abs_err'] < TOL_LSE:
        faults.append(f"max|dlse| {c['lse_max_abs_err']} >= {TOL_LSE}")
    return faults


CHECK_CASES = (
    # (name, B, T, Skv, H, KV, D, q_offset, window, softcap)
    ('prefill_offset', 2, 1024, 4096, 32, 8, 128, 1024, None, None),
    ('window_softcap', 2, 1024, 4096, 32, 8, 128, 1024, 600, 50.0),
    ('masked_rows', 2, 128, 1024, 32, 8, 128, 1000, 64, None),
    ('engine_chunk', 8, 512, 2048, 32, 8, 128, 1536, None, None),
    ('head_dim_64', 2, 256, 1024, 32, 8, 64, 512, None, None),
    # A ragged last q tile (200 = 128 + 72 rows) at an offset that is no
    # multiple of the 128-row kv tile, against a ragged kv length.
    ('ragged_tiles', 3, 200, 1500, 32, 8, 128, 1299, None, None),
    # Warm-tail prefill after a prefix-cache hit: a 16- or 64-row chunk at
    # a page-aligned offset (17 and 16 pages of 64) against the 2048-row
    # paged view, so one 128-row q tile is mostly padding and the causal
    # frontier falls inside a kv tile.
    ('warm_tail', 1, 16, 2048, 32, 8, 128, 1088, None, None),
    ('warm_tail_64', 4, 64, 2048, 32, 8, 128, 1024, None, None),
    # Two shapes the prefix phase launches: its widest warm chunk, and the
    # repeated prompt's last token re-run at 1215 (a 16-row bucket).
    ('warm_tail_512', 1, 512, 2048, 32, 8, 128, 1024, None, None),
    ('warm_repeat', 1, 16, 2048, 32, 8, 128, 1215, None, None),
    # gemma2-9b heads (16 q / 8 kv, d 256: 64-row q CTAs, 64-row kv
    # tiles), softcap 50: a local layer's cached prefill past its 4096
    # window (keys below it masked), a global layer (window 2**30, as
    # models/llama.layer_windows gives it), rows with no visible key, a
    # ragged q tile at an offset off the tile grid, and a 16-row warm tail.
    ('gemma9b_past_window', 2, 512, 8192, 16, 8, 256, 5120, 4096, 50.0),
    ('gemma9b_global', 2, 512, 8192, 16, 8, 256, 5120, 2 ** 30, 50.0),
    ('gemma9b_masked_rows', 2, 128, 1024, 16, 8, 256, 1000, 64, 50.0),
    ('gemma9b_ragged_tiles', 3, 200, 1500, 16, 8, 256, 1299, 4096, 50.0),
    ('gemma9b_warm_tail', 1, 16, 8192, 16, 8, 256, 6208, 4096, 50.0),
    # gemma2-2b heads (8 / 4, d 256) at the engine's chunk.
    ('gemma2b_chunk', 8, 512, 2048, 8, 4, 256, 1536, 4096, 50.0),
    # qwen2.5-1.5b heads: a GQA group of 6 (12 q / 2 kv), d 128.
    ('qwen_gqa6', 2, 512, 4096, 12, 2, 128, 2048, None, None),
    # mistral-7b: every layer local (window 4096), past the window.
    ('mistral_window', 2, 512, 8192, 32, 8, 128, 6144, 4096, None),
)
# The main path's heaviest prefill chunk: batch 8, chunk 512 at cache
# position 1536 of a 2048-position paged view (llama3-8b heads).
TIMING_SHAPE = (8, 512, 2048, 32, 8, 128, 1536)
# The train phase's attention (K1, forward and remat recompute): bench-8b
# heads at batch 1, seq 4096, causal, no offset.
TRAIN_TIMING_SHAPE = (1, 4096, 4096, 32, 8, 128, 0)
# gemma2-9b's heaviest serving chunk (the gemma phases' last prefill
# chunk): batch 8, chunk 512 at q_offset 7680 of 8192, d 256, timed for
# a local layer (window 4096) and a global one, both at softcap 50.
GEMMA_TIMING_SHAPE = (8, 512, 8192, 16, 8, 256, 7680)
GEMMA_TIMING_LAYERS = (('local', 4096), ('global', 2 ** 30))
GEMMA_SOFTCAP = 50.0
# The gemma train phase's attention (K1, forward and remat recompute):
# gemma2-2b heads at batch 1, seq 8192, causal, no offset.
GEMMA_TRAIN_TIMING_SHAPE = (1, 8192, 8192, 8, 4, 256, 0)


def kernel_readings(torch, fa, quant):
    """A reading of every CHECK_CASES case, by case name."""
    gen = torch.Generator(device=DEV).manual_seed(1 + int(quant))
    return {name: kernel_reading(torch, fa, gen, quant, *rest)
            for name, *rest in CHECK_CASES}


def kernel_timing(torch, fa, quant, shape=TIMING_SHAPE, window=None,
                  softcap=None):
    """K1 (K2 with `quant`) at `shape` (B, T, S, H, KV, D, q_offset; causal
    from q_offset, with `window` and `softcap`): kernel ms, plain ms, one
    SDPA call over the same (dequantised) inputs and mask, and the bound,
    each on a queue the host has filled ahead; and the kernel's ms when
    the host paces the calls (`host_paced_ms`: the larger of the kernel's
    and the wrapper's per-call time, as the engine sees it). SDPA has no
    softcap: with one, `library_ms` is SDPA without it, and
    `ms_softcap_off` the kernel on that same function."""
    import torch.nn.functional as F
    b, t, s, h, kv, d, off = shape
    gen = torch.Generator(device=DEV).manual_seed(7)
    q, k, v, ks, vs = attn_inputs(torch, gen, b, t, s, h, kv, d, quant)
    kw = dict(causal=True, q_offset=off, window=window, softcap=softcap)
    ms = time_ms(torch, lambda: fa.flash_fwd(q, k, v, k_scale=ks,
                                             v_scale=vs, **kw),
                 queue_ahead=True)
    host_paced_ms = time_ms(torch, lambda: fa.flash_fwd(
        q, k, v, k_scale=ks, v_scale=vs, **kw))
    if quant:
        plain_ms = time_ms(torch, lambda: fa.flash_attention_quant_plain(
            q, k, ks, v, vs, **kw), iters=3, warmup=1, queue_ahead=True)
        kd = (k.float() * ks[..., None]).bfloat16()
        vd = (v.float() * vs[..., None]).bfloat16()
    else:
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, **kw), iters=3, warmup=1, queue_ahead=True)
        kd, vd = k, v
    qt, kt, vt = q.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2)
    if off == 0 and t == s and window is None:
        sdpa_kw = dict(is_causal=True)
    else:
        q_pos = off + torch.arange(t, device=DEV)[:, None]
        k_pos = torch.arange(s, device=DEV)[None, :]
        mask = k_pos <= q_pos
        if window is not None:
            mask = mask & (q_pos - k_pos < window)
        sdpa_kw = dict(attn_mask=mask)
    try:
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **sdpa_kw), queue_ahead=True)
    except TypeError:  # a torch without enable_gqa: no one-call yardstick
        library_ms = None
    bms, bound_by, flops = bound_ms(b, t, s, h, kv, d, off, window, quant)
    out = {'shape': [b, t, s, h, kv, d], 'q_offset': off, 'window': window,
           'softcap': softcap, 'ms': ms, 'host_paced_ms': host_paced_ms,
           'plain_ms': plain_ms, 'library_ms': library_ms,
           'bound_ms': bms, 'bound_by': bound_by,
           'tflops': flops / (ms * 1e-3) / 1e12}
    if softcap is not None:
        out['ms_softcap_off'] = time_ms(torch, lambda: fa.flash_fwd(
            q, k, v, k_scale=ks, v_scale=vs, **{**kw, 'softcap': None}),
            queue_ahead=True)
    return out


def profile_breakdown(torch, fn, top=8, shares=None):
    """Run fn() once under torch.profiler: wall time, the device's busy
    time (sum of kernel self times on the one stream), its idle share,
    the kernels that take the most device time and, for each label of
    `shares` (label -> substrings of kernel names), its ms and share of
    the busy time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith('CUDA')
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    named = {}
    for label, needles in (shares or {}).items():
        hits = [e for e in kernels if any(n in e.key for n in needles)]
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        named[label] = {'ms': ms, 'calls': sum(e.count for e in hits),
                        'share_of_busy': ms / busy_ms if busy_ms else None}
    return {'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
            'named': named,
            'device_idle_share': 1.0 - busy_ms / wall_ms if busy_ms else None,
            'top_kernels': [
                {'name': e.key[:80], 'calls': e.count,
                 'ms': e.self_device_time_total / 1e3,
                 'share_of_busy': e.self_device_time_total / 1e3 / busy_ms}
                for e in kernels[:top]]}


def prompt_tokens(rng, n, vocab):
    return [int(x) for x in rng.integers(0, vocab, size=n)]


def batch_inputs(torch, eng, engine, prompts, padded_len):
    """Padded tokens, lengths and slots of `prompts`, and a fresh paged
    cache of the engine's layout whose table gives every slot its own
    pages (page 0 stays the scratch page)."""
    cfg, dev, n = engine.config, engine.device, len(prompts)
    tokens = torch.tensor([p + [0] * (padded_len - len(p))
                           for p in prompts], device=dev)
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                           device=dev)
    cache = eng.init_cache(cfg, n, engine.state.max_seq_len,
                           pad_to=engine.prefill_chunk,
                           kv_quant=engine.kv_quant,
                           page_size=engine.kv_page_size, device=dev)
    w = cache['table'].shape[1]
    cache['table'][:] = 1 + torch.arange(n * w, dtype=torch.int32,
                                         device=dev).reshape(n, w)
    return tokens, lengths, torch.arange(n, device=dev), cache


def prefill_paths(torch, eng, fa, engine, prompts):
    """Last-token prefill logits of `prompts` through the kernel and
    through the plain version (the kernel swapped out), each into a
    fresh paged cache. Returns (kernel, plain)."""
    chunk = engine.prefill_chunk
    padded_len = -(-max(map(len, prompts)) // chunk) * chunk

    def run():
        tokens, lengths, slots, cache = batch_inputs(
            torch, eng, engine, prompts, padded_len)
        logits, _ = eng.prefill_chunked(engine.params, tokens, lengths,
                                        cache, slots, engine.config, chunk,
                                        use_flash=True)
        torch.cuda.synchronize()
        return logits

    kernel_logits = run()
    launch = fa._launch

    def plain_launch(q, k, v, causal, window, softcap, q_offset,
                     k_scale=None, v_scale=None):
        return fa._plain(q, k, v, causal, 512, window, softcap, q_offset,
                         k_scale=k_scale, v_scale=v_scale)

    fa._launch = plain_launch
    try:
        plain_logits = run()
    finally:
        fa._launch = launch
    return kernel_logits, plain_logits


def rel_err(torch, a, b):
    return float((a - b).abs().max() / b.abs().max())


def throughput(torch, eng, engine, rng, n=8, lengths=None, steps=16):
    """Prefill tok/s of `n` prompts in one batched prefill (chunked,
    paged, kernel path) and decode tok/s of a fused round over them."""
    cfg, dev, chunk = engine.config, engine.device, engine.prefill_chunk
    lengths = lengths or [int(x) for x in rng.integers(100, 1501, size=n)]
    prompts = [prompt_tokens(rng, m, cfg.vocab_size) for m in lengths]
    padded_len = 2048
    tokens, lens, slots, cache = batch_inputs(torch, eng, engine, prompts,
                                              padded_len)
    for _ in range(2):                      # warm-up, then timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = eng.prefill_chunked(engine.params, tokens, lens, cache,
                                        slots, cfg, chunk, use_flash=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    last = torch.argmax(logits, dim=-1).to(torch.int32)
    zeros_f = torch.zeros(n, device=dev)
    args = dict(temperature=zeros_f,
                top_k=torch.zeros(n, dtype=torch.int32, device=dev),
                top_p=torch.ones(n, device=dev),
                eos_ids=torch.full((n,), -1, dtype=torch.int32, device=dev),
                budgets=torch.full((n,), 10 ** 6, dtype=torch.int32,
                                   device=dev),
                max_len=engine.state.max_seq_len - 2, generator=None,
                config=cfg)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    eng.fused_decode_steps(engine.params, cache, last, active, n_steps=2,
                           **args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, _, emitted, _, _ = eng.fused_decode_steps(
        engine.params, cache, last, active, n_steps=steps, **args)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if int(emitted.min()) != steps:
        raise AssertionError(f'decode emitted {emitted.tolist()}')
    # Where the time goes: one decode round and one batched prefill
    # under the profiler, and the per-layer paged gather on its own.
    decode_profile = profile_breakdown(torch, lambda: eng.fused_decode_steps(
        engine.params, cache, last, active, n_steps=8, **args))
    prefill_profile = profile_breakdown(torch, lambda: eng.prefill_chunked(
        engine.params, tokens, lens, cache, slots, cfg, chunk,
        use_flash=True))
    layer_k = eng._map_kv(lambda a: a[0], cache['k'])
    gather_ms = time_ms(torch, lambda: eng._paged_read(layer_k,
                                                        cache['table']))
    view = eng._paged_read(layer_k, cache['table'])
    gather_bytes = sum(t.numel() * t.element_size() for t in (
        view.values() if isinstance(view, dict) else [view]))
    del cache, view
    return {'prefill_batch': n, 'prefill_prompt_tokens': sum(lengths),
            'prefill_s': prefill_s,
            'prefill_tok_s': sum(lengths) / prefill_s,
            'prefill_padded_tok_s': n * padded_len / prefill_s,
            'decode_batch': n, 'decode_steps': steps, 'decode_s': decode_s,
            'decode_tok_s': n * steps / decode_s,
            'paged_read_ms_per_leaf_layer': gather_ms,
            'paged_read_mb_per_leaf_layer': gather_bytes / 1e6,
            'decode_round_profile': decode_profile,
            'prefill_profile': prefill_profile}


def run_main_path(torch, inference, engine, rng, lengths, long_len,
                  max_new):
    """The main path: requests through submit() and step() until every
    one finishes. Returns (results, wall seconds)."""
    vocab = engine.config.vocab_size
    sampling = inference.SamplingParams(max_new_tokens=max_new)
    rids = [engine.submit(prompt_tokens(rng, long_len, vocab), sampling)]
    rids += [engine.submit(prompt_tokens(rng, m, vocab), sampling)
             for m in lengths]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sorted(results) != sorted(rids):
        raise AssertionError(f'finished {sorted(results)} != {rids}')
    for rid in rids:
        toks = results[rid]
        if len(toks) != max_new or not all(0 <= x < vocab for x in toks):
            raise AssertionError(f'request {rid}: bad tokens {toks}')
    return results, wall


def logits_readings(torch, eng, fa, llama, engine, rng, lengths=(700, 1300)):
    """Last-token prefill logits of two prompts (`lengths` tokens)
    through the kernel, against the plain version and, on a bf16 cache,
    against the dense forward of the first (attention_impl 'dense'):
    max|a-b| / max|b| of each."""
    check_prompts = [prompt_tokens(rng, m, engine.config.vocab_size)
                     for m in lengths]
    k_logits, p_logits = prefill_paths(torch, eng, fa, engine,
                                       check_prompts)
    out = {'prefill_logits_finite': bool(torch.isfinite(k_logits).all()),
           'prefill_logits_rel_err_vs_plain': rel_err(torch, k_logits,
                                                      p_logits),
           'argmax_agree_vs_plain': int((k_logits.argmax(-1)
                                         == p_logits.argmax(-1)).sum())}
    if engine.kv_quant == 'none':
        dense = dataclasses.replace(engine.config, attention_impl='dense')
        with torch.inference_mode():
            ref = llama.forward(engine.params, torch.tensor(
                [check_prompts[0]], device=DEV), dense)[0, -1]
        out['prefill_logits_rel_err_vs_dense_forward'] = rel_err(
            torch, k_logits[0], ref)
    return out


def logits_faults(r):
    """The limits a logits reading breaks; empty when it passes."""
    faults = [] if r['prefill_logits_finite'] else ['non-finite logits']
    for key in ('prefill_logits_rel_err_vs_plain',
                'prefill_logits_rel_err_vs_dense_forward'):
        if key in r and not r[key] < TOL_LOGITS_REL:
            faults.append(f'{key} {r[key]} >= {TOL_LOGITS_REL}')
    return faults


def engine_phase(torch, inference, eng, fa, llama, engine, rng, quant):
    counter = fa.flash_attention_quant if quant else fa.flash_attention
    out = {'kv_quant': engine.kv_quant,
           **logits_readings(torch, eng, fa, llama, engine, rng)}
    if logits_faults(out):
        raise AssertionError(f'prefill logits: {logits_faults(out)}')
    out.update(throughput(torch, eng, engine, rng))
    torch.cuda.empty_cache()
    n_req = 4 if quant else 8
    lengths = [int(x) for x in rng.integers(100, 1501, size=n_req)]
    counter.launches = 0
    _, wall = run_main_path(torch, inference, engine, rng, lengths,
                            long_len=1900, max_new=32)
    launches = counter.launches
    if launches <= 0:
        raise AssertionError('the main path never launched the kernel')
    st = engine.stats
    out.update({'requests': n_req + 1, 'prompt_lengths': lengths,
                'interleaved_prompt': 1900, 'max_new_tokens': 32,
                'e2e_wall_s': wall, 'kernel_launches': launches,
                'engine_prompt_tokens': st['prompt_tokens'],
                'engine_generated_tokens': st['generated_tokens'],
                'engine_prefill_s': st['prefill_seconds'],
                'engine_decode_s': st['decode_seconds'],
                'engine_decode_tok_s': (
                    (st['generated_tokens'] - n_req - 1)
                    / max(st['decode_seconds'], 1e-9)),
                'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9})
    return out, launches


def http_json(url, body=None, timeout=300):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


@contextlib.contextmanager
def telemetry(mode):
    """Run the block with the telemetry plane in `mode` (OBS_ENV): the
    sampler and the watchdog threads run in the modes that set the
    sampler's interval, and stop, with every knob restored, on the way
    out."""
    from skypilot_tpu_torch.observability import timeseries, watchdog
    keys = sorted({k for env in OBS_ENV.values() for k in env})
    saved = {k: os.environ.get(k) for k in keys}
    try:
        for k in keys:
            os.environ.pop(k, None)
        os.environ.update(OBS_ENV[mode])
        if 'SKYTPU_TS_SAMPLE_SECONDS' in OBS_ENV[mode] and (
                not timeseries.start_sampler()
                or watchdog.start_watchdog() is None):
            raise AssertionError('the sampler or the watchdog did not start')
        yield
    finally:
        timeseries.stop_sampler()
        watchdog.stop_watchdog()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def parse_metrics(text):
    """Prometheus text -> {series with its labels: value} (exemplar
    suffixes dropped)."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith('#'):
            series, value = line.split(' # ')[0].rsplit(' ', 1)
            out[series] = float(value)
    return out


def counter_faults(deltas, want):
    """The counter deltas that differ from `want` ({series: expected});
    empty when every one is exact."""
    return [f'{k}: delta {deltas.get(k)} != {v}' for k, v in want.items()
            if deltas.get(k) != v]


def span_tree_faults(doc):
    """The limits one /internal/trace?trace_id= document breaks: its
    tree must be one root, the request span, whose children hold the
    admission wait, a prefill (batched or chunked) and at least one
    decode, each inside the root's interval. An engine span that lost
    its parent surfaces as a second root."""
    roots = doc.get('tree') or []
    if len(roots) != 1 or roots[0]['name'] != OBS_ROOT:
        return [f'roots {[r["name"] for r in roots]}, want one {OBS_ROOT}']
    root = roots[0]
    names = {c['name'] for c in root['children']}
    faults = [f'no {want}' for want in ('engine.admission_wait',
                                        'engine.decode')
              if want not in names]
    if not names & {'engine.prefill', 'engine.prefill_chunk'}:
        faults.append('no engine.prefill or engine.prefill_chunk')
    faults += [f'{c["name"]} outside the request span'
               for c in root['children']
               if not root['start'] <= c['start'] <= c['end'] <= root['end']]
    return faults


def overhead_faults(r):
    """The limit an overhead reading breaks; empty when it passes."""
    frac = r['overhead_frac']
    return [] if frac <= TOL_OBS_OVERHEAD else [
        f'overhead_frac {frac} > {TOL_OBS_OVERHEAD}']


def http_call(url, body=None, timeout=300):
    """(status, headers, text) of one request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), resp.read().decode()


def poll(fn, ok, timeout=10.0):
    """fn() until ok(result) or `timeout` seconds; the last result.
    (The middleware counts a request, and closes its span, after the
    response reached the client.)"""
    deadline = time.monotonic() + timeout
    while True:
        got = fn()
        if ok(got) or time.monotonic() > deadline:
            return got
        time.sleep(0.05)


@contextlib.contextmanager
def counted(obj, name, counts, key):
    """Count the calls of `obj.name` in `counts[key]` for the block,
    outside the books of the code that makes them."""
    fn = getattr(obj, name)
    own = name in vars(obj)

    def wrapper(*args, **kwargs):
        counts[key] += 1
        return fn(*args, **kwargs)

    setattr(obj, name, wrapper)
    try:
        yield counts
    finally:
        if own:
            setattr(obj, name, fn)
        else:
            delattr(obj, name)


@contextlib.contextmanager
def engine_calls(engine):
    """The host steps that decode (calls of the engine module's
    `fused_decode_steps`) and the prefills that sample a first token
    (calls of `engine._sample_host_params`, made once a prefill), counted
    around the engine for the block."""
    counts = {'decode_host_steps': 0, 'prefills': 0}
    with counted(sys.modules[type(engine).__module__], 'fused_decode_steps',
                 counts, 'decode_host_steps'), \
            counted(engine, '_sample_host_params', counts, 'prefills'):
        yield counts


def observability_readings(base, calls, before, trace_ids, n_prompt,
                           n_new, n_requests):
    """The server phase's telemetry checks (see phase 7); `calls` is
    what `engine_calls` counted over the requests. Raises on the first
    limit broken."""
    from skypilot_tpu_torch.observability import watchdog
    post_200 = ('skytpu_http_requests_total{plane="inference",'
                'method="POST",code="200"}')
    want = {'skytpu_prompt_tokens_total': n_prompt,
            'skytpu_generated_tokens_total': n_new,
            'skytpu_requests_finished_total': n_requests,
            post_200: n_requests,
            'skytpu_decode_host_steps_total': calls['decode_host_steps'],
            'skytpu_prefill_seconds_count': calls['prefills']}

    def deltas():
        after = parse_metrics(http_call(base + '/metrics')[2])
        return {k: after.get(k, 0) - before.get(k, 0) for k in want}

    got = poll(deltas, lambda d: d[post_200] >= n_requests)
    out = {'deltas': got, 'want': want, 'traces': [], 'statuses': {}}
    bad = counter_faults(got, want)
    if bad:
        raise AssertionError(f'/metrics deltas: {bad}')
    for trace_id in trace_ids:
        url = f'{base}/internal/trace?trace_id={trace_id}'
        doc = poll(lambda: json.loads(http_call(url)[2]),
                   lambda d: not span_tree_faults(d))
        bad = span_tree_faults(doc)
        if bad:
            raise AssertionError(f'trace {trace_id}: {bad}')
        root = doc['tree'][0]
        out['traces'].append({
            'trace_id': trace_id, 'spans': len(doc['spans']),
            'root_ms': (root['end'] - root['start']) * 1e3,
            'children': dict(collections.Counter(
                c['name'] for c in root['children']))})
    rate_url = (base + '/internal/timeseries?query=rate&metric='
                'skytpu_generated_tokens_total&window=60')
    rate = poll(lambda: json.loads(http_call(rate_url)[2]),
                lambda d: (d['value'] or 0) > 0)
    if not (rate['value'] or 0) > 0:
        raise AssertionError(f'/internal/timeseries rate: {rate}')
    alerts = json.loads(http_call(base + '/internal/alerts')[2])
    rules = [r['name'] for r in alerts['rules']]
    if rules != [r.name for r in watchdog.default_rules()]:
        raise AssertionError(f'/internal/alerts rules {rules}')
    out['generated_tokens_rate'] = rate['value']
    out['alert_rules'] = rules
    out['statuses'] = {path: http_call(base + path)[0] for path in (
        '/metrics', '/internal/trace', '/internal/timeseries',
        '/internal/alerts', '/health')}
    return out


def server_phase(torch, inference, fa, params, config):
    """The port's server in this process over a llama3-8b engine
    (SERVER_KW): /health before and after the load, then the
    SERVER_REQUESTS at once, one streamed, every answer with its token
    count; then the telemetry plane's checks (observability_readings),
    with the plane on for the whole phase."""
    from skypilot_tpu_torch.inference import server as server_lib
    from skypilot_tpu_torch.observability import timeseries
    engine = inference.InferenceEngine(params, config, device=DEV,
                                       **SERVER_KW)
    holder = {'loop': None}
    srv = server_lib.create_server(holder, host='127.0.0.1', port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    loop = None
    try:
        with telemetry('on'), engine_calls(engine) as calls:
            base = f'http://127.0.0.1:{srv.server_address[1]}'
            status = None
            try:
                http_json(base + '/health')
            except urllib.error.HTTPError as e:
                status = e.code
            if status != 503:
                raise AssertionError(f'/health before load: {status}')
            loop = server_lib.EngineLoop(engine)
            holder['loop'] = loop
            status, body = http_json(base + '/health')
            health = json.loads(body)
            if status != 200 or health['status'] != 'ok':
                raise AssertionError(f'/health: {status} {body}')
            results, trace_ids = {}, {}
            # A sampler pass before the requests, so the windowed rate
            # read after them has its baseline (the first pass comes one
            # interval after the sampler starts).
            samples = timeseries.STORE.stats()['samples']
            poll(lambda: timeseries.STORE.stats()['samples'],
                 lambda n: n > samples)
            before = parse_metrics(http_call(base + '/metrics')[2])
            fa.flash_attention.launches = 0
            calls.update(decode_host_steps=0, prefills=0)

            def request(i, n_prompt, max_new, stream):
                prompt = list(range(1, n_prompt + 1))
                status, headers, text = http_call(base + '/generate', {
                    'prompt_tokens': prompt, 'max_new_tokens': max_new,
                    'stream': stream})
                trace_ids[i] = headers.get('X-Trace-ID')
                if stream:
                    frames = [json.loads(line[len('data: '):])
                              for line in text.splitlines()
                              if line.startswith('data: ')]
                    toks = [f['token'] for f in frames if 'token' in f]
                    done = frames[-1]
                    if not done.get('done') or done['tokens'] != toks:
                        raise AssertionError(
                            f'bad stream frames {frames[-2:]}')
                else:
                    toks = json.loads(text)['tokens']
                results[i] = (status, len(toks), max_new)

            threads = [threading.Thread(target=request, args=(i, *case))
                       for i, case in enumerate(SERVER_REQUESTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            wall = time.perf_counter() - t0
            n = len(SERVER_REQUESTS)
            if any(t.is_alive() for t in threads) or len(results) != n:
                raise AssertionError(f'server requests incomplete: '
                                     f'{results}')
            for i, (status, got, want) in results.items():
                if status != 200 or got != want:
                    raise AssertionError(f'request {i}: {status}, {got} '
                                         f'tokens, want {want}')
            launches = fa.flash_attention.launches
            if launches <= 0:
                raise AssertionError('server path never launched the kernel')
            if sorted(trace_ids) != list(range(n)) or \
                    not all(trace_ids.values()):
                raise AssertionError(f'X-Trace-ID missing: {trace_ids}')
            obs = observability_readings(
                base, calls, before, [trace_ids[i] for i in range(n)],
                sum(p for p, _, _ in SERVER_REQUESTS),
                sum(m for _, m, _ in SERVER_REQUESTS), n)
        return {'requests': n, 'streamed': 1, 'wall_s': wall,
                'token_counts': [results[i][1] for i in sorted(results)],
                'kernel_launches': launches, 'observability': obs}
    finally:
        srv.shutdown()
        srv.server_close()
        if loop is not None:
            loop.stop()


def overhead_engines(inference, params, config,
                     engines=OVERHEAD_ENGINES):
    """{name: engine} for each (name, mode) of `engines`: an engine of the
    main path's shape (ENGINE_KW, OVERHEAD_FUSE decode steps a host
    step) that admitted the same 8 prompts of OVERHEAD_PROMPT tokens
    under its telemetry mode, with room to decode to its capacity, and
    is decoding every slot. The prompts come from a generator of their
    own, so the later phases' draws stay as they were."""
    import numpy as np
    rng = np.random.default_rng(1)
    prompts = [prompt_tokens(rng, OVERHEAD_PROMPT, config.vocab_size)
               for _ in range(ENGINE_KW['batch_size'])]
    sampling = inference.SamplingParams(
        max_new_tokens=ENGINE_KW['max_seq_len'] - OVERHEAD_PROMPT - 1)
    out = {}
    for name, mode in engines:
        engine = inference.InferenceEngine(
            params, config, device=DEV, decode_fuse_steps=OVERHEAD_FUSE,
            **ENGINE_KW)
        with telemetry(mode):
            for prompt in prompts:
                engine.submit(prompt, sampling)
            engine.step()
            engine.step()
        if not all(s is not None and s.pending is None
                   for s in engine.state.slots):
            raise AssertionError('overhead: slots not decoding after two '
                                 'steps')
        out[name] = engine
    return out


def overhead_phase(torch, inference, params, config):
    """Decode host-step time (one fused `step()` of 8 full slots,
    OVERHEAD_FUSE decode steps and their host sync) with the telemetry
    plane off and on. The OVERHEAD_ENGINES admit the same 8 prompts:
    'off' and 'off2' with tracing off (SKYTPU_TRACE_MAX_SPANS=0), 'on'
    with every trace kept. Then the sampler and the watchdog start (the
    'on' knobs) and run through OVERHEAD_ROUNDS rounds, each stepping
    the three engines in an order that rotates by one every round; their
    passes inside the rounds are counted, and the phase fails if either
    made none. A step's time on the card's host drifts by 10-15% between
    seconds, so the engines are read against each other within rounds:
    `steps_frac`, the median over rounds of on / off - 1, is what a
    traced request's phase spans and exemplars add to a step (the
    instruments count in every engine); `aa_frac`, off2 / off, the
    noise floor. The threads are process-wide, so they land on every
    engine's steps alike: their share is their own host time at their
    cadence (`telemetry_host_share`, from `host_ms`: one pass of the
    process's sampler store and one watchdog tick over it).
    `overhead_frac` = steps_frac + telemetry_host_share, held to
    TOL_OBS_OVERHEAD."""
    from skypilot_tpu_torch.observability import timeseries, watchdog
    engines = overhead_engines(inference, params, config)
    times = {name: [] for name in engines}
    order = list(engines)
    passes = {'samples': 0, 'ticks': 0}
    with counted(timeseries.STORE, 'sample_now', passes, 'samples'), \
            telemetry('on'), \
            counted(watchdog.get_watchdog(), 'tick', passes, 'ticks'):
        for r in range(OVERHEAD_ROUNDS):
            k = r % len(order)
            for name in order[k:] + order[:k]:
                t0 = time.perf_counter()
                engines[name].step()
                times[name].append(time.perf_counter() - t0)
    for engine in engines.values():
        engine.abort_all()
    del engines
    if not passes['samples'] or not passes['ticks']:
        raise AssertionError(f'overhead: the threads made no pass in the '
                             f'rounds: {passes}')
    # The host time of what the two threads do at each wake.
    dog = watchdog.Watchdog(store=timeseries.STORE, dump_evidence=False)
    host_ms = {}
    for name, fn in (('sample_ms', timeseries.STORE.sample_now),
                     ('tick_ms', dog.tick)):
        runs = []
        for _ in range(21):
            t0 = time.perf_counter()
            fn()
            runs.append((time.perf_counter() - t0) * 1e3)
        host_ms[name] = sorted(runs)[10]
    period = {'sample_ms': float(OBS_ENV['on']['SKYTPU_TS_SAMPLE_SECONDS']),
              'tick_ms': float(OBS_ENV['on']['SKYTPU_WATCHDOG_TICK_SECONDS'])}
    share = sum(host_ms[k] / 1e3 / period[k] for k in host_ms)

    def median_ratio(name, base='off'):
        ratios = sorted(a / b for a, b in zip(times[name], times[base]))
        return ratios[len(ratios) // 2] - 1

    steps_frac = median_ratio('on')
    return {'slots': ENGINE_KW['batch_size'],
            'fused_steps': OVERHEAD_FUSE, 'rounds': OVERHEAD_ROUNDS,
            'prompt': OVERHEAD_PROMPT, 'modes': OBS_ENV,
            'p50_ms': {n: sorted(t)[len(t) // 2] * 1e3
                       for n, t in times.items()},
            'p90_ms': {n: sorted(t)[int(len(t) * 0.9)] * 1e3
                       for n, t in times.items()},
            'steps_frac': steps_frac, 'aa_frac': median_ratio('off2'),
            'thread_passes': passes, 'host_ms': host_ms,
            'telemetry_host_share': share,
            'overhead_frac': steps_frac + share,
            'tol_overhead': TOL_OBS_OVERHEAD, 'targets': OBS_TARGETS}


def shape_entry(kernel, path):
    """The entry of `kernel`'s `shapes` list timed for `path`."""
    return next(e for e in kernel['shapes'] if e['path'] == path)


# Kernel-name substrings of a prefill's profile categories.
PREFILL_SHARES = {
    'K1/K2 flash_fwd': ('flash_fwd_kernel',),
    'GEMMs': ('nvjet', 'gemm', 'cutlass', 'xmma'),
    'elementwise and copies': ('elementwise_kernel', 'copy'),
    'gather/scatter (paged view)': ('index', 'gather', 'scatter'),
    'reductions': ('reduce_kernel',),
}


# The prefix phase: a 1024-token (16-page) shared prefix. The cold tail is
# 192 tokens, so the cold prompt (1216 = 19 pages) repeated is a
# full-prompt match whose last page is copied on write; the warm tails
# run the narrowest power-of-two chunks from 64 to 512 rows.
PREFIX_LEN = 1024
COLD_TAIL = 192
WARM_TAILS = (64, 112, 160, 208, 256, 320, 384, 448)
COLD_NEW = 32
WARM_NEW = 8


def first_token_s(torch, engine):
    """Time to the first token of the queued requests: the admission
    half of step() (slot, prefix match, prefill, first sample) run on its
    own, before the steps that decode; wall seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine._insert_from_queue()
    while any(s is not None and s.pending is not None
              for s in engine.state.slots):
        engine._advance_prefill()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def capture_first_logits(engine):
    """Record the logits each first-token sample of `engine` sees, in
    admission order (a list of [rows, V] f32 tensors)."""
    seen = []
    sample = engine._sample_host_params

    def recording(logits, params):
        seen.append(logits.detach().float().clone())
        return sample(logits, params)

    engine._sample_host_params = recording
    return seen


def prefix_phase(torch, inference, fa, params, config, rng, quant):
    """The prefix cache on llama3-8b at ENGINE_KW: one cold request, then
    8 warm ones sharing its 1024-token prefix, then the cold prompt again
    (a full-prompt match), one at a time through submit() and step().
    Each warm request's first-token logits are held against the same
    prompt on an engine with prefix_cache=False; K1 (K2) launches are
    counted and their chunk widths and offsets recorded."""
    kv_quant = 'int8' if quant else 'none'
    vocab = config.vocab_size
    on = inference.InferenceEngine(params, config, kv_quant=kv_quant,
                                   device=DEV, **ENGINE_KW)
    if on._prefix is None:
        raise AssertionError('the default engine has no prefix cache')
    prefix = prompt_tokens(rng, PREFIX_LEN, vocab)
    cold = prefix + prompt_tokens(rng, COLD_TAIL, vocab)
    warm = [prefix + prompt_tokens(rng, n, vocab) for n in WARM_TAILS]
    plan = ([('cold', cold, COLD_NEW)]
            + [(f'warm_{n}', p, WARM_NEW) for n, p in zip(WARM_TAILS, warm)]
            + [('repeat', cold, COLD_NEW)])
    counter = fa.flash_attention_quant if quant else fa.flash_attention
    launch = fa._launch
    shapes = []        # (B, rows, Skv, H, KV, D, q_offset) of each launch

    def recording(q, k, v, causal, window, softcap, q_offset, **kw):
        b, t, h, d = q.shape
        shapes.append((int(b), int(t), int(k.shape[1]), int(h),
                       int(k.shape[2]), int(d), int(q_offset or 0)))
        return launch(q, k, v, causal, window, softcap, q_offset, **kw)

    logits_on = capture_first_logits(on)
    rows, tokens_on = [], {}
    fa._launch = recording
    counter.launches = 0
    try:
        for name, prompt, max_new in plan:
            before = dict(on.stats)
            n_shapes = len(shapes)
            rid = on.submit(prompt, inference.SamplingParams(
                max_new_tokens=max_new))
            ttft = first_token_s(torch, on)
            prefill_shapes = shapes[n_shapes:]
            tokens_on[name] = on.run_to_completion()[rid]
            rows.append({
                'request': name, 'prompt_tokens': len(prompt),
                'matched_tokens': (on.stats['prefix_reused_tokens']
                                   - before['prefix_reused_tokens']),
                'cow_copies': on.stats['cow_copies'] - before['cow_copies'],
                'ttft_s': ttft, 'kernel_launches': len(prefill_shapes),
                'chunks': [{'b': c[0], 'rows': c[1], 'q_offset': c[-1]}
                           for c in sorted(set(prefill_shapes))],
                'launched': prefill_shapes})
    finally:
        fa._launch = launch
    launches = counter.launches
    warm_rows = [r for r in rows if r['request'].startswith('warm')]
    warm_launches = sum(r['kernel_launches'] for r in warm_rows)
    # Launches per shape over the requests that hit the cache (the warm
    # tails and the repeat).
    hits = collections.Counter()
    for r in rows:
        launched = r.pop('launched')
        if r['matched_tokens']:
            hits.update(launched)
    if any(r['matched_tokens'] != PREFIX_LEN for r in warm_rows):
        raise AssertionError(f'a warm request missed the prefix: {rows}')
    if (warm_launches <= 0 or launches != len(shapes) or any(
            c['q_offset'] != PREFIX_LEN for r in warm_rows
            for c in r['chunks'])):
        raise AssertionError(f'K1/K2 launches on warm tails: {warm_launches}'
                             f' of {launches} ({len(shapes)} recorded)')
    repeat = rows[-1]
    if repeat['matched_tokens'] != len(cold) - 1 or repeat['cow_copies'] != 1:
        raise AssertionError(f'the repeated prompt: {repeat}')
    total, free, cached = on.pages_total(), on.pages_free(), on.pages_cached()
    pinned = sum(1 for p in range(1, total + 1) if on._prefix.refcount(p))
    if free + cached != total or pinned:
        raise AssertionError(f'pages: free {free} + cached {cached} != '
                             f'{total}, {pinned} pinned')
    # Where a warm request's time to first token goes: one more warm
    # admission (a fresh 256-token tail) under the profiler.
    on.submit(prefix + prompt_tokens(rng, 256, vocab),
              inference.SamplingParams(max_new_tokens=1))
    warm_profile = profile_breakdown(
        torch, lambda: first_token_s(torch, on), shares=PREFILL_SHARES)
    on.run_to_completion()
    # The same prompts without the cache: first-token logits and tokens.
    off = inference.InferenceEngine(params, config, kv_quant=kv_quant,
                                    prefix_cache=False, device=DEV,
                                    **ENGINE_KW)
    logits_off = capture_first_logits(off)
    rids = [off.submit(p, inference.SamplingParams(max_new_tokens=max_new))
            for _, p, max_new in plan[:-1]]
    done = off.run_to_completion()
    off_rows = torch.cat(logits_off)
    on_rows = torch.cat(logits_on[:len(plan)])
    for i, r in enumerate(rows[:-1]):
        r['logits_rel_err_vs_cache_off'] = rel_err(torch, on_rows[i],
                                                   off_rows[i])
        got, want = tokens_on[r['request']], done[rids[i]]
        r['tokens_agree_vs_cache_off'] = sum(
            a == b for a, b in zip(got, want))
        r['tokens'] = len(got)
    repeat['logits_rel_err_vs_cache_off'] = rel_err(torch, on_rows[-1],
                                                    off_rows[0])
    repeat['tokens_agree_vs_cache_off'] = sum(
        a == b for a, b in zip(tokens_on['repeat'], done[rids[0]]))
    repeat['tokens'] = len(tokens_on['repeat'])
    worst = max(r['logits_rel_err_vs_cache_off'] for r in rows[1:])
    if not worst < TOL_LOGITS_REL or not bool(torch.isfinite(on_rows).all()):
        raise AssertionError(f'warm logits vs cache off: {worst} >= '
                             f'{TOL_LOGITS_REL} (or non-finite)')
    cold_ttft = rows[0]['ttft_s']
    warm_ttft = sorted(r['ttft_s'] for r in warm_rows)
    return {'kv_quant': kv_quant, 'prefix_tokens': PREFIX_LEN,
            'requests': rows, 'kernel_launches': launches,
            'warm_tail_launches': warm_launches,
            'hit_shapes': [{'shape': list(c), 'launches': n}
                           for c, n in sorted(hits.items())],
            'ttft_cold_s': cold_ttft,
            'ttft_warm_median_s': warm_ttft[len(warm_ttft) // 2],
            'ttft_repeat_s': repeat['ttft_s'],
            'warm_logits_max_rel_err': worst,
            'warm_ttft_profile': warm_profile,
            'pages': {'total': total, 'free': free, 'cached': cached,
                      'pinned': pinned},
            'engine_stats': {k: on.stats[k] for k in (
                'prefix_hits', 'prefix_misses', 'prefix_reused_tokens',
                'prefix_evictions', 'cow_copies')}}


def hit_shape_readings(torch, fa, quant, hit_shapes):
    """K1 (K2 with `quant`) against its plain version at each shape
    (B, rows, Skv, H, KV, D, q_offset) the prefix phase's cache hits
    launched, on fresh random inputs, as `kernel_reading` reads them."""
    gen = torch.Generator(device=DEV).manual_seed(11 + int(quant))
    return [kernel_reading(torch, fa, gen, quant, *hit['shape'], None, None)
            for hit in hit_shapes]


def sse_frames(resp):
    """The SSE frames of an open HTTP response, one dict at a time."""
    for line in resp:
        line = line.strip()
        if line.startswith(b'data: '):
            yield json.loads(line[len(b'data: '):])


def migration_phase(torch, inference, params, config, rng):
    """Engine to engine: two requests (600 and 1500 tokens, 64 new,
    greedy) on engine A are snapshotted after 16 tokens, aborted and
    restored into engine B; their tokens must equal an uninterrupted
    run. Server to server: a stream on server 1 drained into a migrate
    frame continues through /internal/restore on server 2 with no token
    duplicated or missing; a corrupted blob gets 400."""
    import base64

    from skypilot_tpu_torch.inference import engine as eng
    from skypilot_tpu_torch.inference import server as server_lib
    vocab = config.vocab_size
    prompts = [prompt_tokens(rng, n, vocab) for n in (600, 1500)]
    sampling = inference.SamplingParams(max_new_tokens=64)
    a = inference.InferenceEngine(params, config, device=DEV, **ENGINE_KW)
    b = inference.InferenceEngine(params, config, device=DEV, **ENGINE_KW)
    rids = [a.submit(p, sampling) for p in prompts]
    done = a.run_to_completion()
    want = [done[r] for r in rids]
    a.abort_all()                       # drops the prefix cache too
    rids = [a.submit(p, sampling) for p in prompts]
    while min(len(a.active_progress().get(r, ())) for r in rids) < 16:
        a.step()
    mid = [a.active_progress()[r] for r in rids]
    # The chaos seam: armed once, the first snapshot is refused before
    # any device read, and counted; the snapshots below then succeed.
    from skypilot_tpu_torch.observability import instruments as obs
    from skypilot_tpu_torch.resilience import faults
    injected = obs.FAULTS_INJECTED.labels(point='engine.snapshot')
    fired = injected.value()
    faults.arm('engine.snapshot', times=1)
    try:
        a.snapshot_request(rids[0])
        refused = False
    except faults.FaultInjected:
        refused = True
    finally:
        faults.reset()
    fired = injected.value() - fired
    if not refused or fired != 1:
        raise AssertionError(f'armed engine.snapshot: refused {refused}, '
                             f'FAULTS_INJECTED delta {fired}')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blobs = [a.snapshot_request(r) for r in rids]
    snapshot_s = time.perf_counter() - t0
    # Where the long request's snapshot time goes: the page gather and
    # device-to-host copy, then packing (host copies and the CRC32).
    slot = next(i for i, s in enumerate(a.state.slots)
                if s is not None and s.request_id == rids[1])
    n_pages = -(-(len(prompts[1]) + len(mid[1]) - 1) // a.kv_page_size)
    t0 = time.perf_counter()
    leaves = [eng._gather_pool_pages(a.state.cache[name],
                                     a._slot_pages[slot][:n_pages]).cpu()
              for name in ('k', 'v')]
    d2h_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng._snapshot_pack({}, [('k', leaves[0]), ('v', leaves[1])])
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng._snapshot_unpack(blobs[1])
    unpack_s = time.perf_counter() - t0
    del leaves
    for r in rids:
        a.abort(r)
    t0 = time.perf_counter()
    restored = [b.restore_request(blob) for blob in blobs]
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    done = b.run_to_completion()
    got = [done[r] for r in restored]
    if got != want or any(g[:len(m)] != m for g, m in zip(got, mid)):
        raise AssertionError('migrated tokens differ from the '
                             'uninterrupted run')
    engines = {'blob_bytes': [len(x) for x in blobs],
               'snapshot_ms': snapshot_s * 1e3 / len(blobs),
               'restore_ms': restore_s * 1e3 / len(blobs),
               'long_request_ms': {'gather_and_d2h': d2h_s * 1e3,
                                   'pack': pack_s * 1e3,
                                   'unpack': unpack_s * 1e3},
               'tokens_at_snapshot': [len(m) for m in mid],
               'tokens': [len(g) for g in got], 'equal': True,
               'armed_snapshot': {'refused': refused,
                                  'faults_injected_delta': fired}}
    del a, b, blobs
    gc.collect()
    torch.cuda.empty_cache()

    kw = dict(batch_size=4, max_seq_len=2048, prefill_chunk=512,
              kv_page_size=64, device=DEV)
    prompt = prompt_tokens(rng, 200, vocab)
    max_new = 64
    one = inference.InferenceEngine(params, config, **kw)
    two = inference.InferenceEngine(params, config, **kw)
    rid = two.submit(prompt, inference.SamplingParams(max_new_tokens=max_new))
    want = two.run_to_completion()[rid]
    two.abort_all()
    holders, servers, threads = [], [], []
    try:
        for engine in (one, two):
            holder = {'loop': server_lib.EngineLoop(engine)}
            srv = server_lib.create_server(holder, host='127.0.0.1', port=0)
            th = threading.Thread(target=srv.serve_forever, daemon=True)
            th.start()
            holders.append(holder)
            servers.append(srv)
            threads.append(th)
        base = [f'http://127.0.0.1:{srv.server_address[1]}'
                for srv in servers]
        req = urllib.request.Request(
            base[0] + '/generate', headers={'Content-Type':
                                            'application/json'},
            data=json.dumps({'prompt_tokens': prompt,
                             'max_new_tokens': max_new,
                             'stream': True}).encode())
        drained = {}

        def drain():
            drained['status'], body = http_json(
                base[0] + '/internal/drain?deadline=0', {})
            drained['body'] = json.loads(body)

        first, drainer = [], None
        with urllib.request.urlopen(req, timeout=300) as resp:
            for frame in sse_frames(resp):
                if 'token' not in frame:
                    break
                first.append(frame['token'])
                if len(first) == 2:
                    drainer = threading.Thread(target=drain)
                    drainer.start()
        if drainer is not None:
            drainer.join(300)
        if 'migrate' not in frame or drained.get('status') != 200:
            raise AssertionError(f'drain: last frame {sorted(frame)}, '
                                 f'{drained}')
        blob = base64.b64decode(frame['migrate']['snapshot'])
        sent = frame['migrate']['sent']
        bad = bytearray(blob)
        bad[len(bad) // 2] ^= 0xFF
        bad_status = None
        try:
            urllib.request.urlopen(urllib.request.Request(
                base[1] + '/internal/restore?sent=0', data=bytes(bad)),
                timeout=300)
        except urllib.error.HTTPError as e:
            bad_status = e.code
        if bad_status != 400:
            raise AssertionError(f'corrupted blob: {bad_status}, want 400')
        t0 = time.perf_counter()
        rest = []
        with urllib.request.urlopen(urllib.request.Request(
                base[1] + f'/internal/restore?sent={sent}', data=blob),
                timeout=300) as resp:
            for frame in sse_frames(resp):
                if 'token' not in frame:
                    break
                rest.append(frame['token'])
        resumed_s = time.perf_counter() - t0
        if (sent != len(first) or first + rest != want
                or frame != {'done': True, 'tokens': want}):
            raise AssertionError(f'server migration: sent {sent}, '
                                 f'{len(first)} + {len(rest)} tokens, '
                                 f'equal {first + rest == want}')
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        for holder in holders:
            holder['loop'].stop()
    return {'engine_to_engine': engines,
            'server_to_server': {
                'prompt_tokens': len(prompt), 'max_new_tokens': max_new,
                'tokens_before_drain': len(first), 'sent': sent,
                'tokens_after_restore': len(rest), 'blob_bytes': len(blob),
                'drain': drained['body'], 'corrupted_blob_status': bad_status,
                'restore_to_done_s': resumed_s, 'equal': True}}


def first_divergence(a, b):
    """Index of the first token where two outputs differ, or None."""
    for j, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return j
    return None if len(a) == len(b) else min(len(a), len(b))


def divergence_reading(torch, llama, params, config, prompt, plain, spec):
    """Where `spec` first leaves `plain` (greedy tokens of one prompt):
    the index, both tokens, the target's top two tokens and their logit
    gap, and each token's deficit (the top logit minus the token's),
    from a dense forward over the prompt and the plain tokens before
    it."""
    j = first_divergence(plain, spec)
    if j is None:
        return {'equal': True}
    out = {'equal': False, 'index': j, 'plain_token': None,
           'spec_token': None, 'top2': None, 'gap': None, 'deficits': None}
    if j < min(len(plain), len(spec)):
        with torch.inference_mode():
            logits = llama.forward(params, torch.tensor(
                [list(prompt) + list(plain[:j])], device=DEV),
                config)[0, -1].float()
        top = torch.topk(logits, 2)
        out.update(plain_token=plain[j], spec_token=spec[j],
                   top2=[int(t) for t in top.indices],
                   gap=float(top.values[0] - top.values[1]),
                   deficits=[float(top.values[0] - logits[t])
                             for t in (plain[j], spec[j])])
    return out


def divergence_faults(readings, limit=None):
    """The divergences the rule does not pass: any but a near-tie, where
    both paths' tokens lie within the limit of the target's top logit
    (a length mismatch never passes)."""
    limit = TOL_SPEC_GAP if limit is None else limit
    faults = []
    for i, r in enumerate(readings):
        if r['equal']:
            continue
        if r['deficits'] is None or not max(r['deficits']) < limit:
            faults.append(f'request {i} diverges at token {r["index"]}: '
                          f'{r["spec_token"]} for {r["plain_token"]}, '
                          f'deficits {r["deficits"]} (limit {limit}), top '
                          f'two {r["top2"]}')
    return faults


def acceptance_faults(accepted, proposed, limit=None):
    limit = TOL_SPEC_ACCEPT if limit is None else limit
    rate = accepted / proposed if proposed else 0.0
    return ([] if rate >= limit else
            [f'accepted {accepted} of {proposed} proposals ({rate}), under '
             f'{limit}'])


def run_greedy(torch, inference, engine, prompts, max_new):
    """`prompts` through submit() and step() to completion, greedy:
    (tokens per prompt, the engine's decode counters)."""
    sampling = inference.SamplingParams(max_new_tokens=max_new)
    rids = [engine.submit(p, sampling) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = [done[r] for r in rids]
    vocab = engine.config.vocab_size
    if any(len(t) != max_new or not all(0 <= x < vocab for x in t)
           for t in tokens):
        raise AssertionError(f'bad greedy tokens: {[len(t) for t in tokens]}')
    st = engine.stats
    decode_tokens = st['generated_tokens'] - len(prompts)
    dispatches = st['decode_dispatches']
    out = {'wall_s': wall, 'decode_tokens': decode_tokens,
           'decode_s': st['decode_seconds'], 'decode_dispatches': dispatches,
           'decode_tok_s': decode_tokens / max(st['decode_seconds'], 1e-9),
           'ms_per_dispatch': st['decode_seconds'] * 1e3 / max(dispatches, 1)}
    if st['spec_rounds']:
        rounds = st['spec_rounds']
        out.update({
            'spec_dispatches': st['spec_dispatches'], 'spec_rounds': rounds,
            'rounds_per_dispatch': rounds / max(st['spec_dispatches'], 1),
            'ms_per_round': st['decode_seconds'] * 1e3 / rounds,
            'tokens_per_round': decode_tokens / rounds,
            'proposed_tokens': st['spec_proposed_tokens'],
            'accepted_tokens': st['spec_accepted_tokens'],
            'acceptance': (st['spec_accepted_tokens']
                           / max(st['spec_proposed_tokens'], 1)),
            'accepted_per_round': list(st['spec_accepted_per_round'])})
    return tokens, out


def spec_engines(torch, inference, fa, llama, params, config, dparams,
                 dconfig, prompts, quant, target_as_draft):
    """One KV type of the spec phase: the engine without a draft, then
    with the draft (and, with `target_as_draft`, with the target as its
    own draft), the same greedy prompts through each. K1 (K2 with
    `quant`) launches and their shapes are read around the draft
    engines' runs only. After them, on bf16 KV, one pure spec dispatch
    (8 rounds) of the draft engine runs under the profiler. Returns the
    readings, with
    `faults`: each divergence the rule does not pass and (target as
    draft) acceptance under TOL_SPEC_ACCEPT. Raises when K1/K2 never
    launched."""
    kw = dict(kv_quant='int8' if quant else 'none', prefix_cache=False,
              device=DEV, **SPEC_KW)
    plain_engine = inference.InferenceEngine(params, config, **kw)
    plain, plain_run = run_greedy(torch, inference, plain_engine, prompts,
                                  SPEC_NEW)
    del plain_engine
    torch.cuda.empty_cache()
    counter = fa.flash_attention_quant if quant else fa.flash_attention
    launch = fa._launch
    shapes = []

    def recording(q, k, v, causal, window, softcap, q_offset, **lkw):
        b, t, h, d = q.shape
        shapes.append((int(b), int(t), int(k.shape[1]), int(h),
                       int(k.shape[2]), int(d), int(q_offset or 0)))
        return launch(q, k, v, causal, window, softcap, q_offset, **lkw)

    drafts = [('draft', (dparams, dconfig))]
    if target_as_draft:
        drafts.append(('target_as_draft', (params, config)))
    out = {'kv_quant': kw['kv_quant'], 'spec_k': SPEC_K,
           'spec_fuse_rounds': SPEC_ROUNDS, 'plain': plain_run}
    fa._launch = recording
    counter.launches = 0
    runs, profiled = {}, None
    try:
        for name, draft in drafts:
            engine = inference.InferenceEngine(
                params, config, draft=draft, spec_k=SPEC_K,
                spec_fuse_rounds=SPEC_ROUNDS, **kw)
            runs[name] = run_greedy(torch, inference, engine, prompts,
                                    SPEC_NEW)
            if name == 'draft' and not quant:
                profiled = engine
            del engine
            torch.cuda.empty_cache()
    finally:
        fa._launch = launch
    out['kernel_launches'] = counter.launches
    if profiled is not None:
        # Where a dispatch's time goes: the prompts again, the step that
        # admits them, then the next (a pure spec dispatch) under the
        # profiler.
        for p in prompts:
            profiled.submit(p, inference.SamplingParams(
                max_new_tokens=SPEC_NEW))
        profiled.step()
        out['dispatch_profile'] = profile_breakdown(
            torch, profiled.step,
            shares={k: v for k, v in PREFILL_SHARES.items()
                    if not k.startswith('K1')})
        profiled.abort_all()
        del profiled
        torch.cuda.empty_cache()
    out['launched_shapes'] = [{'shape': list(c), 'launches': n} for c, n in
                              sorted(collections.Counter(shapes).items())]
    if not 0 < out['kernel_launches'] == len(shapes):
        raise AssertionError(f'spec engines launched K1/K2 '
                             f'{out["kernel_launches"]} times ({len(shapes)} '
                             'recorded)')
    faults = []
    for name, (tokens, run) in runs.items():
        readings = [divergence_reading(torch, llama, params, config, p, a, b)
                    for p, a, b in zip(prompts, plain, tokens)]
        run['divergences'] = [dict(r, request=i)
                              for i, r in enumerate(readings)
                              if not r['equal']]
        run['tokens_equal'] = sum(r['equal'] for r in readings)
        run['decode_tok_s_vs_plain'] = (run['decode_tok_s']
                                        / plain_run['decode_tok_s'])
        faults += [f'{name}: {f}' for f in divergence_faults(readings)]
        out[name] = run
    if target_as_draft:
        run = out['target_as_draft']
        faults += [f'target_as_draft: {f}' for f in acceptance_faults(
            run['accepted_tokens'], run['proposed_tokens'])]
    out['tol_gap'], out['tol_accept'] = TOL_SPEC_GAP, TOL_SPEC_ACCEPT
    out['faults'] = faults
    return out


def spec_server(torch, inference, params, config, prompt):
    """The port's server as a process with --draft-model SPEC_DRAFT
    (weights from --seed 0, as the params in hand): one greedy
    /generate against the draft-free server in this process on the same
    params, under the divergence rule; /health must count spec
    rounds."""
    import socket
    import tempfile

    from skypilot_tpu_torch.inference import server as server_lib
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.inference.server',
           '--model', SPEC_MODEL, '--draft-model', SPEC_DRAFT, '--spec-k',
           str(SPEC_K), '--spec-fuse-rounds', str(SPEC_ROUNDS), '--device',
           DEV, '--port', str(port), '--seed', '0',
           '--batch-size', str(SPEC_KW['batch_size']),
           '--max-seq-len', str(SPEC_KW['max_seq_len']),
           '--prefill-chunk', str(SPEC_KW['prefill_chunk']),
           '--kv-page-size', str(SPEC_KW['kv_page_size'])]
    body = {'prompt_tokens': prompt, 'max_new_tokens': SPEC_NEW}
    plain_engine = inference.InferenceEngine(params, config,
                                             prefix_cache=False, device=DEV,
                                             **SPEC_KW)
    holder = {'loop': server_lib.EngineLoop(plain_engine)}
    srv = server_lib.create_server(holder, host='127.0.0.1', port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    log = tempfile.TemporaryFile()
    proc = subprocess.Popen(cmd, cwd=here, stdout=log,
                            stderr=subprocess.STDOUT)
    try:
        plain = json.loads(http_json(
            f'http://127.0.0.1:{srv.server_address[1]}/generate',
            body)[1])['tokens']
        base = f'http://127.0.0.1:{port}'
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                log.seek(0)
                raise AssertionError('spec server exited: '
                                     + log.read().decode()[-2000:])
            try:
                if http_json(base + '/health', timeout=10)[0] == 200:
                    break
            except (urllib.error.URLError, ConnectionError):
                pass
            if time.perf_counter() - t0 > 300:
                raise AssertionError('spec server never loaded')
            time.sleep(0.1)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        spec = json.loads(http_json(base + '/generate', body)[1])['tokens']
        request_s = time.perf_counter() - t0
        health = json.loads(http_json(base + '/health')[1])['engine']
    finally:
        proc.terminate()
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        srv.shutdown()
        srv.server_close()
        holder['loop'].stop()
    from skypilot_tpu_torch.models import llama
    reading = divergence_reading(torch, llama, params, config, prompt, plain,
                                 spec)
    faults = divergence_faults([reading])
    if health['spec']['rounds'] <= 0:
        faults.append(f'/health spec {health["spec"]}: no rounds')
    return {'command': ' '.join(cmd[1:]), 'load_s': load_s,
            'request_s': request_s, 'prompt_tokens': len(prompt),
            'tokens': len(spec), 'tokens_equal': reading['equal'],
            'divergence': None if reading['equal'] else reading,
            'health_spec': health['spec'], 'faults': faults}


def spec_phase(torch, inference, fa, params, config, rng):
    """Speculative decode on the target in hand: the draft's weights
    drawn as build_engine draws them (seed 1), 8 prompts of 100-1500
    tokens through spec_engines with bf16 KV (and the target as its own
    draft), then int8 KV, then the server. `faults` gathers every
    part's."""
    from skypilot_tpu_torch.models import llama
    dparams, dconfig = inference.draw_params(SPEC_DRAFT, 1, DEV)
    vocab = config.vocab_size
    lo, hi = SPEC_PROMPT_LENGTHS
    lengths = [int(x) for x in rng.integers(lo, hi + 1, size=8)]
    prompts = [prompt_tokens(rng, m, vocab) for m in lengths]
    out = {'model': SPEC_MODEL, 'draft_model': SPEC_DRAFT, **SPEC_KW,
           'prompt_lengths': lengths, 'max_new_tokens': SPEC_NEW}
    for quant in (False, True):
        out['int8' if quant else 'bf16'] = spec_engines(
            torch, inference, fa, llama, params, config, dparams, dconfig,
            prompts, quant, target_as_draft=not quant)
    del dparams
    gc.collect()
    torch.cuda.empty_cache()
    out['server'] = spec_server(torch, inference, params, config,
                                prompt_tokens(rng, SPEC_SERVER_PROMPT,
                                              vocab))
    out['faults'] = [f'{part}: {f}' for part in ('bf16', 'int8', 'server')
                     for f in out[part]['faults']]
    return out


# The gemma phases: gemma2-9b at full width and depth (42 layers,
# 3584/14336, 16 q / 8 kv heads, d 256, vocab 256128), random weights
# from seed 0. Batched prefill (no interleave): all 8 prompts in one
# admission, padded to 8192 in 16 chunks of 512, every chunk of every
# layer through K1 (K2).
GEMMA_MODEL = 'gemma2-9b'
GEMMA_KW = dict(batch_size=8, max_seq_len=8192, prefill_chunk=512,
                kv_page_size=64, prefill_interleave=0)
GEMMA_PROMPT_LENGTHS = (1000, 7000)  # 6 prompts drawn in this range,
GEMMA_LONG_LENGTHS = (4609, 7000)    # and 2 past the window + 512
GEMMA_CHECK_LENGTHS = (5000, 1300)   # logits check; the dense forward: 5000
GEMMA_NEW = 32
# The profiled batch: 8 prompts of 1000-2000 tokens (4 chunks a layer),
# 8 new each. A 16-chunk batch makes ~150,000 kernel events, whose
# post-processing took 80-120 s of the phase on the card's host.
GEMMA_PROFILE_LENGTHS = (1000, 2000)
GEMMA_PROFILE_NEW = 8
# The checkpoint phase: a synthetic HF gemma2 checkpoint at gemma2-2b's
# widths, depth cut to 2 layers, over two shards with an index.
CKPT_MODEL = 'gemma2-2b'
CKPT_LAYERS = 2
CKPT_KW = dict(batch_size=4, max_seq_len=2048, prefill_chunk=512,
               kv_page_size=64)
CKPT_PROMPT = 300
CKPT_NEW = 24
# The server and the in-process engine run the same kernels on the same
# imported tensors, so their logprobs should agree to the bit; the limit
# leaves room for a GEMM that sums in another order.
TOL_CKPT_LOGPROB = 1e-3


def expected_prefill_launches(engine, lengths):
    """K1 (K2) launches of one batched admission of prompts of
    `lengths`: the engine pads them to a power-of-two bucket in whole
    chunks (InferenceEngine._insert_from_queue), and every chunk of every
    layer launches once."""
    bucket = 16
    while bucket < max(lengths):
        bucket *= 2
    bucket = min(bucket, engine.state.max_seq_len - 1)
    chunk = engine.prefill_chunk if 0 < engine.prefill_chunk < bucket \
        else bucket
    return engine.config.num_layers * (-(-bucket // chunk))


def gemma_phase(torch, inference, eng, fa, llama, engine, rng, quant):
    """gemma2-9b on `engine` (GEMMA_KW; bf16 or int8 KV): prefill
    logits through the kernel against the plain version and the dense
    forward, then the main path (8 greedy prompts of 1000-7000 tokens, two
    past 4608, 32 new each) with the K1 (K2) launches read around it and
    held to expected_prefill_launches, then a shorter batch
    (GEMMA_PROFILE_LENGTHS) under the profiler."""
    counter = fa.flash_attention_quant if quant else fa.flash_attention
    t0 = time.perf_counter()
    out = {'kv_quant': engine.kv_quant,
           **logits_readings(torch, eng, fa, llama, engine, rng,
                             lengths=GEMMA_CHECK_LENGTHS)}
    out['logits_check_s'] = time.perf_counter() - t0
    if logits_faults(out):
        raise AssertionError(f'gemma prefill logits: {logits_faults(out)}')
    torch.cuda.empty_cache()
    cfg = engine.config
    lo, hi = GEMMA_PROMPT_LENGTHS
    lengths = ([int(x) for x in rng.integers(lo, hi + 1, size=6)]
               + [int(x) for x in rng.integers(*GEMMA_LONG_LENGTHS, size=2)])
    sampling = inference.SamplingParams(max_new_tokens=GEMMA_NEW)
    expected = expected_prefill_launches(engine, lengths)
    rids = [engine.submit(prompt_tokens(rng, m, cfg.vocab_size), sampling)
            for m in lengths]
    counter.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.launches
    if sorted(results) != sorted(rids) or any(
            len(results[r]) != GEMMA_NEW
            or not all(0 <= x < cfg.vocab_size for x in results[r])
            for r in rids):
        raise AssertionError(f'gemma requests incomplete: '
                             f'{ {r: len(t) for r, t in results.items()} }')
    if launches != expected:
        raise AssertionError(f'gemma main path launched the kernel '
                             f'{launches} times, expected {expected}')
    st = engine.stats
    out.update({'requests': len(rids), 'prompt_lengths': lengths,
                'max_new_tokens': GEMMA_NEW, 'e2e_wall_s': wall,
                'kernel_launches': launches,
                'expected_launches': expected,
                'prefill_tok_s': st['prompt_tokens'] / st['prefill_seconds'],
                'decode_tok_s': ((st['generated_tokens'] - len(rids))
                                 / max(st['decode_seconds'], 1e-9)),
                'engine_prefill_s': st['prefill_seconds'],
                'engine_decode_s': st['decode_seconds']})
    profiled = [int(x) for x in rng.integers(*GEMMA_PROFILE_LENGTHS,
                                              size=len(lengths))]
    for m in profiled:
        engine.submit(prompt_tokens(rng, m, cfg.vocab_size),
                      inference.SamplingParams(
                          max_new_tokens=GEMMA_PROFILE_NEW))
    out['profile'] = profile_breakdown(torch, engine.run_to_completion,
                                       shares=PREFILL_SHARES)
    out['profile'].update(prompt_lengths=profiled,
                          max_new_tokens=GEMMA_PROFILE_NEW)
    out['peak_mem_gb'] = torch.cuda.max_memory_allocated() / 1e9
    return out, launches


def hf_config_json(config):
    """The config.json of an HF gemma2 checkpoint of `config`."""
    return {
        'model_type': 'gemma2', 'architectures': ['Gemma2ForCausalLM'],
        'vocab_size': config.vocab_size, 'hidden_size': config.hidden_size,
        'intermediate_size': config.intermediate_size,
        'num_hidden_layers': config.num_layers,
        'num_attention_heads': config.num_heads,
        'num_key_value_heads': config.num_kv_heads,
        'head_dim': config.head_dim,
        'max_position_embeddings': config.max_seq_len,
        'rope_theta': config.rope_theta, 'rms_norm_eps': config.rms_norm_eps,
        'tie_word_embeddings': config.tied_embeddings,
        'torch_dtype': str(config.dtype).replace('torch.', ''),
        'attn_logit_softcapping': config.attn_logit_softcap,
        'final_logit_softcapping': config.final_logit_softcap,
        'sliding_window': config.sliding_window,
        'query_pre_attn_scalar': config.head_dim}


def write_hf_checkpoint(params, config, out_dir):
    """`params` as an HF checkpoint in HF's tensor order (embeddings,
    layers, final norm) through the port's ShardedWriter, the embedding
    alone in the first of two shards, then config.json. Returns the
    files written."""
    from skypilot_tpu_torch.checkpoints import hf_import
    from skypilot_tpu_torch.checkpoints import safetensors_io
    specs = {spec.key: spec for spec in hf_import.param_specs(config)}
    embed = params['embed']

    def nbytes(t):
        return t.numel() * t.element_size()

    rest = nbytes(params['final_norm']) + sum(
        nbytes(t) for t in params['layers'].values())
    writer = safetensors_io.ShardedWriter(
        out_dir, max_shard_bytes=max(nbytes(embed), rest),
        metadata={'format': 'pt'})
    writer.add(specs['embed'].hf, hf_import._to_hf(specs['embed'], embed,
                                                   config))
    for i in range(config.num_layers):
        for key, spec in specs.items():
            if spec.stacked:
                writer.add(spec.hf.format(i=i), hf_import._to_hf(
                    spec, params['layers'][key][i], config))
    writer.add(specs['final_norm'].hf, params['final_norm'])
    written = writer.close()
    with open(os.path.join(out_dir, 'config.json'), 'w') as f:
        json.dump(hf_config_json(config), f, indent=2, sort_keys=True)
    return written + ['config.json']


def greedy_tokens(inference, engine, prompt, max_new):
    """(tokens, logprobs) of one greedy request run alone."""
    rid = engine.submit(prompt, inference.SamplingParams(
        max_new_tokens=max_new))
    tokens = engine.run_to_completion()[rid]
    return tokens, engine.finished_logprobs()[rid]


def checkpoint_phase(torch, inference, rng):
    """A synthetic HF gemma2 checkpoint (gemma2-2b widths, CKPT_LAYERS
    layers, random bf16 weights from seed 2) written by the port's writer
    over two shards, imported by load_params (every tensor equal to the
    one written; import seconds and peak host bytes), served by
    build_engine(checkpoint=) in this process and by the server started
    as a process with --checkpoint: greedy /generate must equal the
    in-process engine's tokens."""
    import shutil
    import socket
    import tempfile

    from skypilot_tpu_torch import checkpoints
    from skypilot_tpu_torch import models as models_lib
    family, preset = models_lib.resolve(CKPT_MODEL)
    config = dataclasses.replace(preset, num_layers=CKPT_LAYERS)
    gen = torch.Generator(device=DEV).manual_seed(2)
    params = family.init_params(config, gen, DEV)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_ckpt_')
    out = {'model': CKPT_MODEL, 'layers': CKPT_LAYERS,
           'reduced': f'depth {preset.num_layers} -> {CKPT_LAYERS} layers',
           **CKPT_KW}
    proc = log = None
    try:
        t0 = time.perf_counter()
        out['files'] = write_hf_checkpoint(params, config, tmp)
        out['write_s'] = time.perf_counter() - t0
        out['bytes'] = sum(os.path.getsize(os.path.join(tmp, f))
                           for f in out['files'])
        from skypilot_tpu_torch.observability import instruments as obs
        before = (obs.CKPT_IMPORT_BYTES.value(),
                  obs.CKPT_IMPORT_TENSORS.value(),
                  obs.CKPT_IMPORT_SECONDS.child_snapshot()[1:])
        loaded, detected, stats = checkpoints.load_params(tmp, device=DEV)
        out['import'] = dataclasses.asdict(stats)
        seconds_sum, seconds_count = \
            obs.CKPT_IMPORT_SECONDS.child_snapshot()[1:]
        out['instruments'] = {
            'bytes': obs.CKPT_IMPORT_BYTES.value() - before[0],
            'tensors': obs.CKPT_IMPORT_TENSORS.value() - before[1],
            'seconds_count': seconds_count - before[2][1],
            'seconds_sum': seconds_sum - before[2][0]}
        bad = counter_faults(out['instruments'], {
            'bytes': stats.bytes_read, 'tensors': stats.tensors,
            'seconds_count': 1})
        if bad or not math.isclose(out['instruments']['seconds_sum'],
                                   stats.seconds, rel_tol=1e-9,
                                   abs_tol=1e-9):
            raise AssertionError(f'CKPT_IMPORT_* against ImportStats: {bad}, '
                                 f'{out["instruments"]} vs {stats}')
        if detected != dataclasses.replace(config, remat=True,
                                           attention_impl='dense'):
            raise AssertionError(f'detected config {detected} != {config}')
        leaves = [('embed', loaded['embed'], params['embed']),
                  ('final_norm', loaded['final_norm'], params['final_norm'])]
        leaves += [(k, loaded['layers'][k], v)
                   for k, v in params['layers'].items()]
        unequal = [k for k, a, b in leaves if not torch.equal(a, b)]
        if stats.shards != 2 or unequal:
            raise AssertionError(f'import: {stats.shards} shards, unequal '
                                 f'{unequal}')
        del loaded, params
        engine = inference.build_engine(CKPT_MODEL, device=DEV,
                                        checkpoint=tmp, **CKPT_KW)
        prompt = prompt_tokens(rng, CKPT_PROMPT, config.vocab_size)
        in_process, in_process_lps = greedy_tokens(inference, engine, prompt,
                                                   CKPT_NEW)
        del engine
        torch.cuda.empty_cache()
        with socket.socket() as sock:
            sock.bind(('127.0.0.1', 0))
            port = sock.getsockname()[1]
        cmd = [sys.executable, '-m', 'skypilot_tpu_torch.inference.server',
               '--model', CKPT_MODEL, '--checkpoint', tmp, '--device', DEV,
               '--port', str(port)]
        for key, value in CKPT_KW.items():
            cmd += ['--' + key.replace('_', '-'), str(value)]
        log = tempfile.TemporaryFile()
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=os.path.dirname(
            os.path.abspath(__file__)), stdout=log, stderr=subprocess.STDOUT)
        base = f'http://127.0.0.1:{port}'
        while True:
            if proc.poll() is not None:
                log.seek(0)
                raise AssertionError('checkpoint server exited: '
                                     + log.read().decode()[-2000:])
            try:
                if http_json(base + '/health', timeout=10)[0] == 200:
                    break
            except (urllib.error.URLError, ConnectionError):
                pass
            if time.perf_counter() - t0 > 300:
                raise AssertionError('checkpoint server never loaded')
            time.sleep(0.1)
        out['server_load_s'] = time.perf_counter() - t0
        doc = json.loads(http_json(base + '/generate', {
            'prompt_tokens': prompt, 'max_new_tokens': CKPT_NEW,
            'logprobs': True})[1])
        served, served_lps = doc['tokens'], doc['logprobs']
    finally:
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        if log is not None:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out.update({'command': ' '.join(cmd[1:]), 'prompt_tokens': CKPT_PROMPT,
                'tokens': len(served), 'in_process_tokens': in_process,
                'server_tokens': served,
                'tokens_equal': served == in_process,
                'logprob_max_abs_diff': max(abs(a - b) for a, b in zip(
                    served_lps, in_process_lps)),
                'tol_logprob': TOL_CKPT_LOGPROB})
    if not out['tokens_equal'] or len(served) != CKPT_NEW:
        raise AssertionError(f'--checkpoint server tokens {served} != the '
                             f'in-process engine\'s {in_process}')
    if not out['logprob_max_abs_diff'] < TOL_CKPT_LOGPROB:
        raise AssertionError(f'--checkpoint server logprobs differ from the '
                             f'in-process engine\'s by '
                             f'{out["logprob_max_abs_diff"]}')
    return out


BWD_CASES = (
    # (name, B, Sq, Skv, H, KV, D, causal, q_offset, window, softcap)
    ('training', 1, 4096, 4096, 32, 8, 128, True, None, None, None),
    # q_offset past the window: rows 87-255 see no key (lse = +inf) and
    # must give dQ = 0; keys before 937 get dK = dV = 0.
    ('masked_rows', 2, 256, 1024, 32, 8, 128, True, 1000, 64, None),
    # Ragged last tiles of both kernels (130 = 128 + 2 q rows in K3,
    # 2 x 64 + 2 kv rows in K4) under GQA.
    ('ragged_tiles', 2, 130, 130, 32, 8, 128, True, None, None, None),
    ('window_softcap', 1, 2048, 2048, 32, 8, 128, True, None, 600, 50.0),
    ('non_causal_ragged', 1, 1000, 1000, 32, 8, 128, False, None, None,
     None),
    ('q_offset', 1, 1024, 2048, 32, 8, 128, True, 1024, None, None),
    ('head_dim_64_mha', 2, 1024, 1024, 16, 16, 64, True, None, None, None),
    # head_dim 256 (64-row q CTAs in K3, no producer warpgroup in K4):
    # gemma2-2b's training attention (8 / 4 heads, batch 1, seq 8192,
    # softcap 50), a local layer (window 4096: the window masks half of
    # each late row's keys) and a global one (window 2**30, as
    # models/llama.layer_windows gives it);
    ('gemma2b_local', 1, 8192, 8192, 8, 4, 256, True, None, 4096, 50.0),
    ('gemma2b_global', 1, 8192, 8192, 8, 4, 256, True, None, 2 ** 30,
     50.0),
    # q_offset past a small window (rows 87-255 see no key), ragged tiles
    # of both kernels (130 = 2 x 64 + 2 rows), non-causal ragged;
    ('masked_rows_d256', 2, 256, 1024, 8, 4, 256, True, 1000, 64, 50.0),
    ('ragged_tiles_d256', 2, 130, 130, 8, 4, 256, True, None, None, None),
    ('non_causal_d256', 1, 1000, 1000, 8, 4, 256, False, None, None, None),
    # and a softcap of 2, which the scores (about N(0, 1)) reach, so the
    # softcap's Jacobian 1 - tanh^2 is far from 1 (at 50 it is within
    # 1e-3 of 1 and a kernel that dropped it would pass).
    ('softcap_jacobian_d256', 2, 512, 512, 8, 4, 256, True, None, 256,
     2.0),
)
# The train phase's attention: bench-8b heads at batch 1, seq 4096.
BWD_TIMING_CASE = BWD_CASES[0]
# The gemma train phase's attention at head_dim 256, softcap 50: a local
# and a global layer.
BWD_GEMMA_TIMING_CASES = tuple(c for c in BWD_CASES
                               if c[0] in ('gemma2b_local', 'gemma2b_global'))


def bwd_inputs(torch, fa, gen, b, sq, skv, h, kv, d, causal, off, window,
               softcap):
    """Random bf16 q, k, v, dO; O and lse from K1; delta from them."""
    q, k, v, _, _ = attn_inputs(torch, gen, b, sq, skv, h, kv, d, False)
    do = torch.randn(b, sq, h, d, generator=gen, device=DEV).bfloat16()
    o, lse = fa.flash_fwd(q, k, v, causal=causal, window=window,
                          softcap=softcap, q_offset=off)
    return q, k, v, do, o, lse, fa.bwd_delta(o, do)


def bwd_reading(torch, fa, gen, case):
    """K3 and K4 against flash_attention_bwd_plain on the same inputs:
    max|a-b| and max|a-b| / max|b| of dQ, dK, dV, whether the kernels'
    outputs are finite, and the largest |dQ| on rows the plain forward
    gives lse = +inf (no visible key); and under 'fwd' K1's (O, lse),
    which both backwards take, against flash_attention_plain at this
    case's shape and mask, as `fwd_compare` reads them."""
    _, b, sq, skv, h, kv, d, causal, off, window, softcap = case
    q, k, v, do, o, lse, delta = bwd_inputs(torch, fa, gen, b, sq, skv, h,
                                            kv, d, causal, off, window,
                                            softcap)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    o_p, lse_p = fa.flash_attention_plain(q, k, v, **kw)
    fwd = fwd_compare(torch, o, lse, o_p, lse_p)
    masked = ~torch.isfinite(lse_p[..., 0]).permute(0, 2, 1)   # [B,Sq,H]
    del o_p, lse_p
    got = (fa.flash_attention_dq(q, k, v, do, lse, delta, **kw),
           *fa.flash_attention_dkv(q, k, v, do, lse, delta, **kw))
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    out = {'shape': [b, sq, skv, h, kv, d], 'causal': causal,
           'q_offset': off, 'window': window, 'softcap': softcap,
           'finite': all(bool(torch.isfinite(t).all()) for t in got),
           'masked_rows': int(masked.sum()),
           'masked_rows_max_abs_dq': (float(got[0][masked].float().abs()
                                            .max())
                                      if bool(masked.any()) else 0.0),
           'fwd': fwd}
    for name, a, ref in zip(('dq', 'dk', 'dv'), got, want):
        err = float((a.float() - ref.float()).abs().max())
        out[f'{name}_max_abs_err'] = err
        out[f'{name}_rel_err'] = err / max(float(ref.float().abs().max()),
                                           1e-30)
    return out


def bwd_faults(r):
    """The limits a backward reading breaks, K1's at the same case
    first; empty when it passes."""
    faults = [f'K1 {f}' for f in kernel_faults(r['fwd'])]
    if not r['finite']:
        faults.append('non-finite gradients')
    if r['masked_rows_max_abs_dq'] != 0:
        faults.append('rows with no visible key must give dQ = 0')
    for name in ('dq', 'dk', 'dv'):
        if not r[f'{name}_rel_err'] < TOL_BWD_REL:
            faults.append(f"{name} max|a-b|/max|b| {r[f'{name}_rel_err']} "
                          f'>= {TOL_BWD_REL}')
    return faults


def bwd_readings(torch, fa):
    """A reading of every BWD_CASES case, by case name."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    return {case[0]: bwd_reading(torch, fa, gen, case) for case in BWD_CASES}


def bwd_bounds(b, sq, skv, h, kv, d, off, window):
    """(bound_ms, bound_by, flops) of K3 and K4: 6*d (K3) and 8*d (K4)
    FLOP a visible pair; each input read once, each output written once
    (q, dO, dQ [B,Sq,H,D], the kv rows any query needs, lse and delta)."""
    pairs, kv_rows = visible_span(sq, skv, off if off else 0, window)
    q_bytes = b * sq * h * d * 2
    kv_bytes = b * kv_rows * kv * d * 2
    row_bytes = 2 * b * h * sq * 4
    out = {}
    for name, per_pair, nbytes in (
            ('dq', 6, 3 * q_bytes + 2 * kv_bytes + row_bytes),
            ('dkv', 8, 2 * q_bytes + 2 * kv_bytes + row_bytes
             + 2 * b * skv * kv * d * 2)):
        flops = float(per_pair) * d * pairs * b * h
        t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     'operations' if t_ops >= t_bytes else 'bytes', flops)
    return out


def bwd_timing(torch, fa, case=BWD_TIMING_CASE):
    """K3 and K4 at a BWD_CASES case (the bench-8b training shape by
    default): kernel ms, plain ms, the bound, and the backward of
    scaled_dot_product_attention (K3 + K4's work in one call, timed
    only, over the same mask). SDPA has no softcap: with one,
    `library_ms` is SDPA's backward without it, and `ms_softcap_off`
    the kernel on that same function."""
    import torch.nn.functional as F
    _, b, sq, skv, h, kv, d, causal, off, window, softcap = case
    gen = torch.Generator(device=DEV).manual_seed(9)
    q, k, v, do, _, lse, delta = bwd_inputs(torch, fa, gen, b, sq, skv, h,
                                            kv, d, causal, off, window,
                                            softcap)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    plain_kw = dict(causal=causal, block_k=512, window=window,
                    softcap=softcap, q_offset=off)
    def kernel_ms(**over):
        k_kw = {**kw, **over}
        return {'dq': time_ms(torch, lambda: fa.flash_attention_dq(
                    q, k, v, do, lse, delta, **k_kw)),
                'dkv': time_ms(torch, lambda: fa.flash_attention_dkv(
                    q, k, v, do, lse, delta, **k_kw))}
    ms = kernel_ms()
    # Softcap off: the function SDPA computes (a window stays in the mask).
    ms_off = kernel_ms(softcap=None) if softcap is not None else None
    plain_ms = {'dq': time_ms(torch, lambda: fa._plain_bwd(
                    q, k, v, do, lse, delta, want_dkv=False, **plain_kw),
                    iters=3, warmup=1),
                'dkv': time_ms(torch, lambda: fa._plain_bwd(
                    q, k, v, do, lse, delta, want_dq=False, **plain_kw),
                    iters=3, warmup=1)}
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    if window is not None and window < skv:
        q_pos = (off or 0) + torch.arange(sq, device=DEV)[:, None]
        k_pos = torch.arange(skv, device=DEV)[None, :]
        sdpa_kw = dict(attn_mask=(k_pos <= q_pos) & (q_pos - k_pos < window))
    else:
        sdpa_kw = dict(is_causal=causal)
    try:
        out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                             **sdpa_kw)
        go = do.transpose(1, 2)
        library_ms = time_ms(torch, lambda: torch.autograd.grad(
            out, (qt, kt, vt), go, retain_graph=True))
    except TypeError:  # a torch without enable_gqa: no one-call yardstick
        library_ms = None
    bounds = bwd_bounds(b, sq, skv, h, kv, d, off, window)
    out = {}
    for name in ('dq', 'dkv'):
        out[name] = {'shape': [b, sq, skv, h, kv, d], 'causal': causal,
                     'window': window, 'softcap': softcap,
                     'ms': ms[name], 'plain_ms': plain_ms[name],
                     'library_ms': library_ms, 'bound_ms': bounds[name][0],
                     'bound_by': bounds[name][1],
                     'tflops': bounds[name][2] / (ms[name] * 1e-3) / 1e12}
        if ms_off is not None:
            out[name]['ms_softcap_off'] = ms_off[name]
    return out


def _global_norm(torch, tensors):
    return float(torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors])))


# train_parity's configurations: (model, layers, seq_len). bench-8b's
# layer widths at d 128; gemma2-2b's at d 256 with one local (window
# 4096, past which seq 8192 reaches) and one global layer, softcaps 50
# and 30, tied embeddings.
PARITY_BENCH = ('bench-8b', 2, 2048)
PARITY_GEMMA = ('gemma2-2b', 2, 8192)


def train_parity(torch, model, layers, seq_len):
    """One loss_fn + backward at `model`'s widths, depth cut to `layers`,
    through flash and dense attention on the same params and tokens."""
    import skypilot_tpu_torch.models as models
    from skypilot_tpu_torch.train import trainer
    family, config = models.resolve(model)
    base = dataclasses.replace(config, num_layers=layers)
    gen = torch.Generator(device=DEV).manual_seed(5)
    params = family.init_params(base, gen, DEV)
    params = trainer.tree_map(lambda p: p.requires_grad_(True), params)
    leaves = trainer.tree_leaves(params)
    batch = {'tokens': torch.randint(0, base.vocab_size, (1, seq_len),
                                     generator=gen, device=DEV)}
    out = {}
    grads = {}
    for impl in ('flash', 'dense'):
        config = dataclasses.replace(base, attention_impl=impl)
        loss = family.loss_fn(params, batch, config)
        grads[impl] = torch.autograd.grad(loss, leaves)
        out[f'{impl}_loss'] = float(loss.detach())
        out[f'{impl}_grad_norm'] = _global_norm(torch, grads[impl])
    out['loss_abs_diff'] = abs(out['flash_loss'] - out['dense_loss'])
    out['grad_norm_rel_diff'] = (abs(out['flash_grad_norm']
                                     - out['dense_grad_norm'])
                                 / out['dense_grad_norm'])
    # wq's grads come from K3's dQ, wk's and wv's from K4's dK and dV.
    for name in PARITY_PROJ:
        i = [j for j, t in enumerate(leaves)
             if t is params['layers'][name]][0]
        a, ref = grads['flash'][i].float(), grads['dense'][i].float()
        out[f'{name}_grad_rel_err'] = float((a - ref).abs().max()
                                            / ref.abs().max())
    return out


def train_faults(r):
    faults = []
    if not all(math.isfinite(r[k]) for k in ('flash_loss', 'dense_loss',
                                              'flash_grad_norm',
                                              'dense_grad_norm')):
        faults.append('non-finite loss or grad norm')
    if not r['loss_abs_diff'] < TOL_TRAIN_LOSS:
        faults.append(f"|loss_f - loss_d| {r['loss_abs_diff']} >= "
                      f'{TOL_TRAIN_LOSS}')
    if not r['grad_norm_rel_diff'] < TOL_TRAIN_GRAD_REL:
        faults.append(f"grad norm rel diff {r['grad_norm_rel_diff']} >= "
                      f'{TOL_TRAIN_GRAD_REL}')
    for name in PARITY_PROJ:
        err = r[f'{name}_grad_rel_err']
        if not err < TOL_TRAIN_PROJ_REL:
            faults.append(f'{name} grad max|a-b|/max|b| {err} >= '
                          f'{TOL_TRAIN_PROJ_REL}')
    return faults


# Kernel-name substrings of the train step's profile categories.
TRAIN_SHARES = {
    'K1 flash_fwd': ('flash_fwd_kernel',),
    'K3 flash_bwd_dq': ('flash_bwd_dq_kernel',),
    'K4 flash_bwd_dkv': ('flash_bwd_dkv_kernel',),
    'GEMMs': ('nvjet', 'gemm', 'cutlass', 'xmma'),
    'elementwise and copies': ('elementwise_kernel', 'copy'),
    'reductions': ('reduce_kernel',),
}


# The gemma train phase: gemma2-2b at full width and depth (26 layers,
# d 256, window 4096 on every other layer, softcaps 50 / 30), batch 1 x
# 8192 (past the window, so the local layers' K3/K4 mask it), 10 steps.
GEMMA_TRAIN_MODEL = 'gemma2-2b'
GEMMA_TRAIN_SEQ = 8192
GEMMA_TRAIN_STEPS = 10


def train_phase(torch, fa, model='bench-8b', seq_len=4096,
                steps=TRAIN_STEPS):
    """A training main path: fit() on `model` at batch 1 x `seq_len` for
    `steps` steps, with the launch counts of K1, K2, K3 and K4 set to 0
    just before and read just after. Each step launches K3 and K4 once a
    layer and K1 twice (the forward and the remat recompute), K2 never;
    the launches of each window (`window_launches`) are those of the
    layers `layer_windows` gives that window."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.observability import instruments as obs
    from skypilot_tpu_torch.train import loop, trainer
    cfg = trainer.TrainerConfig(model=model, batch_size=1,
                                seq_len=seq_len, max_steps=steps,
                                learning_rate=TRAIN_LR,
                                warmup_steps=TRAIN_WARMUP)
    mcfg = cfg.model_config()
    counters = (fa.flash_attention, fa.flash_attention_quant,
                fa.flash_attention_dq, fa.flash_attention_dkv)
    # What earlier phases left in reference cycles (the serving engines
    # and their llama3-8b weights) goes before the peak is reset, so the
    # peak is the trainer's own.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    logs = []
    for c in counters:
        c.launches = 0
        c.window_launches = {}
    before = (obs.TRAIN_TOKENS.value(),
              obs.TRAIN_STEP_SECONDS.child_snapshot()[2],
              obs.TRAIN_MFU.value())
    t0 = time.perf_counter()
    res = loop.fit(cfg, DEV, log_every=1, log_fn=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # The TRAIN_* instruments against the loop's own steps and its last
    # log window (log_every 1: the last step's loss and MFU).
    last = res['history'][-1]
    instruments = {
        'TRAIN_STEP': obs.TRAIN_STEP.value(),
        'TRAIN_TOKENS': obs.TRAIN_TOKENS.value() - before[0],
        'TRAIN_STEP_SECONDS_count':
            obs.TRAIN_STEP_SECONDS.child_snapshot()[2] - before[1],
        'TRAIN_LOSS': obs.TRAIN_LOSS.value(),
        'TRAIN_MFU': obs.TRAIN_MFU.value()}
    bad = counter_faults(instruments, {
        'TRAIN_STEP': steps,
        'TRAIN_TOKENS': steps * cfg.batch_size * cfg.seq_len,
        'TRAIN_STEP_SECONDS_count': steps, 'TRAIN_LOSS': last['loss'],
        # No MFU without a PEAK_FLOPS entry: the gauge stays where it was.
        'TRAIN_MFU': before[2] if last['mfu'] is None else last['mfu']})
    if bad:
        raise AssertionError(f'TRAIN_* instruments: {bad}')
    fwd, quant, dq, dkv = (c.launches for c in counters)
    by_window = {name: dict(c.window_launches) for name, c in zip(
        ('K1', 'K2', 'K3', 'K4'), counters)}
    layers = mcfg.num_layers
    if min(fwd, dq, dkv) <= 0:
        raise AssertionError(f'train path launches: K1 {fwd}, K3 {dq}, '
                             f'K4 {dkv}')
    if dq != layers * steps or dkv != layers * steps:
        raise AssertionError(f'K3 {dq} / K4 {dkv} launches, want '
                             f'{layers} x {steps}')
    if fwd != 2 * layers * steps or quant != 0:
        raise AssertionError(f'K1 {fwd} / K2 {quant} launches, want '
                             f'2 x {layers} x {steps} / 0')
    windows = llama.layer_windows(mcfg)
    want = {w: windows.count(w) * steps for w in set(windows)}
    want = {'K1': {w: 2 * n for w, n in want.items()}, 'K2': {},
            'K3': want, 'K4': want}
    if by_window != want:
        raise AssertionError(f'launches by window {by_window}, want {want}')
    losses = [h['loss'] for h in res['history']]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f'train losses {losses}')
    step_s = sorted(h['step_s'] for h in res['history'][2:])
    median = step_s[len(step_s) // 2]
    tok_s = cfg.batch_size * cfg.seq_len / median
    peak_mem = torch.cuda.max_memory_allocated() / 1e9
    # One more step under the profiler, on the trained state.
    step_fn = trainer.make_train_step(cfg, DEV)
    batch = trainer.synthetic_batch(cfg, DEV)
    state = res['state']
    profile = profile_breakdown(torch, lambda: step_fn(state, batch),
                                top=10, shares=TRAIN_SHARES)
    # The optimizer alone (zero grads: weight decay only; the state is
    # not used after this).
    opt = trainer.make_optimizer(cfg)
    zeros = [torch.zeros_like(p) for p in trainer.tree_leaves(
        state['params'])]
    optimizer_ms = time_ms(torch, lambda: opt.update_(
        zeros, state['opt_state'], state['params']), iters=3, warmup=1)
    return {'model': model, 'layers': layers,
            'hidden': mcfg.hidden_size,
            'intermediate': mcfg.intermediate_size,
            'heads': [mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim],
            'vocab': mcfg.vocab_size, 'params': mcfg.num_params(),
            'batch': cfg.batch_size, 'seq_len': cfg.seq_len,
            'steps': steps, 'learning_rate': TRAIN_LR,
            'warmup_steps': TRAIN_WARMUP, 'remat': mcfg.remat,
            'losses': losses, 'wall_s': wall,
            'step_s': [h['step_s'] for h in res['history']],
            'median_step_s': median, 'tokens_per_s': tok_s,
            'mfu': trainer.mfu(tok_s, mcfg, cfg.seq_len,
                               trainer.PEAK_FLOPS['h100']),
            'peak_mem_gb': peak_mem, 'optimizer_ms': optimizer_ms,
            'launches': {'K1': fwd, 'K2': quant, 'K3': dq, 'K4': dkv},
            'window_launches': by_window, 'instruments': instruments,
            'step_profile': profile}


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this '
              'script runs on an NVIDIA GPU', file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import flash_attention as fa
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. toolchain
    smi = sh(['nvidia-smi', '--query-gpu=name,power.limit',
              '--format=csv,noheader']).splitlines()[0]
    nvcc = sh([_build.find_nvcc(), '--version']).splitlines()[-1]
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    info = _build.build_info()
    ptxas = ptxas_entries(info.log, 'flash_')
    emit('toolchain', python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
         gpu=smi, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), build_s=build_s,
         compiled=info.compiled, ptxas=ptxas)
    bad = [e for e in ptxas if e['spill_stores'] or e['spill_loads']
           or e['serialized']]
    if bad:
        raise AssertionError(f'kernels spill or serialise wgmma: {bad}')

    # 2-4. kernels against their plain versions, then timing
    kernels = {}
    for quant, name in ((False, 'flash_attention'),
                        (True, 'flash_attention_quant')):
        cases = kernel_readings(torch, fa, quant)
        max_err = max(c['max_abs_err'] for c in cases.values()
                      if c['shape'][-1] != 256)
        max_err_d256 = max(c['max_abs_err'] for c in cases.values()
                           if c['shape'][-1] == 256)
        emit('check_int8' if quant else 'check_bf16', kernel=name,
             cases=cases, max_abs_err=max_err,
             max_abs_err_d256=max_err_d256, tol_o=TOL_O, tol_lse=TOL_LSE)
        bad = {case: kernel_faults(c) for case, c in cases.items()
               if kernel_faults(c)}
        if bad:
            raise AssertionError(f'{name} disagrees with its plain '
                                 f'version: {bad}')
        timing = kernel_timing(torch, fa, quant)
        emit('timing', kernel=name, path='serving', **timing)
        kernels[name] = {
            'name': name, 'route': 'cuda', 'source': KERNEL_SOURCE,
            'replaces': ('skypilot_tpu/ops/flash_attention.py:100' if quant
                         else 'skypilot_tpu/ops/flash_attention.py:96'),
            'launches': 0, 'max_abs_err': max_err, 'ms': timing['ms'],
            'plain_ms': timing['plain_ms'], 'bound_ms': timing['bound_ms'],
            'bound_by': timing['bound_by'],
            'library_ms': timing['library_ms']}
        paths = [('serving', timing)]
        if not quant:
            # K1's second shape, the training path's; its launches come
            # from the train phase.
            train_timing = kernel_timing(torch, fa, quant,
                                         TRAIN_TIMING_SHAPE)
            emit('timing', kernel=name, path='training', **train_timing)
            paths.append(('training', train_timing))
        kernels[name]['shapes'] = [
            {'path': path, 'shape': tm['shape'],
             'q_offset': tm['q_offset'], 'launches': 0,
             **{key: tm[key] for key in ('ms', 'plain_ms', 'bound_ms',
                                         'bound_by', 'library_ms')}}
            for path, tm in paths]
        # The d 256 instance at gemma2-9b's heaviest chunk, a local and a
        # global layer; the entry's numbers are the global layer's (the
        # larger bound). Its launches come from the gemma phases.
        d256 = {}
        for layer, window in GEMMA_TIMING_LAYERS:
            d256[layer] = kernel_timing(torch, fa, quant, GEMMA_TIMING_SHAPE,
                                        window=window, softcap=GEMMA_SOFTCAP)
            emit('timing', kernel=name, path=f'gemma_{layer}', **d256[layer])
        if not quant:
            # K1's d 256 training shape (the gemma train phase's forward
            # and remat recompute); its launches come from that phase.
            for layer, window in GEMMA_TIMING_LAYERS:
                d256['train_' + layer] = kernel_timing(
                    torch, fa, quant, GEMMA_TRAIN_TIMING_SHAPE,
                    window=window, softcap=GEMMA_SOFTCAP)
                emit('timing', kernel=name, path=f'gemma_train_{layer}',
                     **d256['train_' + layer])
        top = d256['global']
        kernels[name + '_d256'] = {
            'name': name + '_d256', 'route': 'cuda', 'source': KERNEL_SOURCE,
            'replaces': kernels[name]['replaces'], 'launches': 0,
            'max_abs_err': max_err_d256, 'ms': top['ms'],
            'plain_ms': top['plain_ms'], 'bound_ms': top['bound_ms'],
            'bound_by': top['bound_by'], 'library_ms': top['library_ms'],
            'ms_softcap_off': top['ms_softcap_off'],
            'shapes': [{'path': f'gemma_{layer}', 'shape': tm['shape'],
                        'q_offset': tm['q_offset'], 'window': tm['window'],
                        'softcap': tm['softcap'],
                        **{key: tm[key] for key in (
                            'ms', 'ms_softcap_off', 'plain_ms', 'bound_ms',
                            'bound_by', 'library_ms')}}
                       for layer, tm in d256.items()]}

    # 8-9. backward kernels against their plain version, then timing
    cases = bwd_readings(torch, fa)
    emit('check_bwd', kernels=['flash_attention_dq', 'flash_attention_dkv'],
         cases=cases, tol_rel=TOL_BWD_REL, tol_o=TOL_O, tol_lse=TOL_LSE)
    bad = {case: bwd_faults(c) for case, c in cases.items() if bwd_faults(c)}
    if bad:
        raise AssertionError(f'flash forward or backward disagrees with its '
                             f'plain version: {bad}')
    for suffix, at_d256 in (('', False), ('_d256', True)):
        name = 'flash_attention' + suffix
        kernels[name]['max_abs_err'] = max(
            kernels[name]['max_abs_err'],
            *(c['fwd']['max_abs_err'] for c in cases.values()
              if (c['shape'][-1] == 256) == at_d256))
    timing = bwd_timing(torch, fa)
    emit('timing_bwd', path='training', **timing)
    # The d 256 instances at gemma2-2b's training attention, a local and
    # a global layer; the entries' numbers are the global layer's (the
    # larger bound). Their launches come from the gemma train phase.
    d256 = {}
    for case in BWD_GEMMA_TIMING_CASES:
        d256[case[0]] = bwd_timing(torch, fa, case)
        emit('timing_bwd', path=case[0], **d256[case[0]])
        torch.cuda.empty_cache()
    for name, key, parts, line in (
            ('flash_attention_dq', 'dq', ('dq',), 178),
            ('flash_attention_dkv', 'dkv', ('dk', 'dv'), 229)):
        for suffix, tm, at_d256 in (('', timing[key], False),
                                    ('_d256', d256['gemma2b_global'][key],
                                     True)):
            kernels[name + suffix] = {
                'name': name + suffix, 'route': 'cuda', 'source': BWD_SOURCE,
                'replaces': f'skypilot_tpu/ops/flash_attention.py:{line}',
                'launches': 0,
                'max_abs_err': max(c[f'{part}_max_abs_err']
                                   for c in cases.values() for part in parts
                                   if (c['shape'][-1] == 256) == at_d256),
                **{k: tm[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                      'bound_by', 'library_ms')}}
        kernels[name + '_d256']['ms_softcap_off'] = d256['gemma2b_global'][
            key]['ms_softcap_off']
        kernels[name + '_d256']['shapes'] = [
            {'path': layer, 'launches': 0,
             **{k: tm[key][k] for k in (
                 'shape', 'window', 'softcap', 'ms', 'ms_softcap_off',
                 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')}}
            for layer, tm in d256.items()]
    torch.cuda.empty_cache()

    import numpy as np

    from skypilot_tpu_torch import inference
    from skypilot_tpu_torch.inference import engine as eng
    from skypilot_tpu_torch.models import llama
    rng = np.random.default_rng(0)

    # 5. engine, bf16 KV
    t0 = time.perf_counter()
    engine = inference.build_engine('llama3-8b', device=DEV, seed=0,
                                    kv_quant='none', **ENGINE_KW)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    out, launches = engine_phase(torch, inference, eng, fa, llama,
                                 engine, rng, quant=False)
    kernels['flash_attention']['launches'] = launches
    shape_entry(kernels['flash_attention'], 'serving')['launches'] = launches
    emit('engine_bf16', model='llama3-8b', layers=32, init_s=init_s,
         **ENGINE_KW, **out)
    params, config = engine.params, engine.config
    del engine
    torch.cuda.empty_cache()

    # 6. engine, int8 KV
    engine = inference.InferenceEngine(params, config, kv_quant='int8',
                                       device=DEV, **ENGINE_KW)
    torch.cuda.reset_peak_memory_stats()
    out, launches = engine_phase(torch, inference, eng, fa, llama,
                                 engine, rng, quant=True)
    kernels['flash_attention_quant']['launches'] = launches
    shape_entry(kernels['flash_attention_quant'], 'serving')['launches'] = \
        launches
    emit('engine_int8', model='llama3-8b', layers=32, **out)
    del engine
    torch.cuda.empty_cache()

    # 7. server, with the telemetry plane
    out = server_phase(torch, inference, fa, params, config)
    obs_line = out.pop('observability')
    emit('server', **out)
    emit('observability', **obs_line)
    torch.cuda.empty_cache()

    # 7b. the telemetry plane's cost on a decode host step
    out = overhead_phase(torch, inference, params, config)
    emit('overhead', **out)
    if overhead_faults(out):
        raise AssertionError(f'telemetry overhead: {overhead_faults(out)}')
    gc.collect()
    torch.cuda.empty_cache()

    # 12-14. prefix cache (bf16, then int8), then request migration
    for quant, name in ((False, 'flash_attention'),
                        (True, 'flash_attention_quant')):
        out = prefix_phase(torch, inference, fa, params, config, rng, quant)
        # Every shape a prefix hit launched, held against the plain
        # version and timed, beside its launches in the phase.
        out['hit_checks'] = hit_shape_readings(torch, fa, quant,
                                               out['hit_shapes'])
        emit('prefix_int8' if quant else 'prefix_bf16', model='llama3-8b',
             **ENGINE_KW, **out)
        bad = {str(c['shape'] + [c['q_offset']]): kernel_faults(c)
               for c in out['hit_checks'] if kernel_faults(c)}
        if bad:
            raise AssertionError(f'{name} disagrees with its plain version '
                                 f'at the prefix phase\'s shapes: {bad}')
        for hit in out['hit_shapes']:
            tm = kernel_timing(torch, fa, quant, hit['shape'])
            emit('timing', kernel=name, path='warm_tail', **tm)
            kernels[name]['shapes'].append({
                'path': 'warm_tail', 'shape': tm['shape'],
                'q_offset': tm['q_offset'], 'launches': hit['launches'],
                **{key: tm[key] for key in ('ms', 'plain_ms', 'bound_ms',
                                            'bound_by', 'library_ms')}})
        gc.collect()
        torch.cuda.empty_cache()
    emit('migration', **migration_phase(torch, inference, params, config,
                                        rng))
    gc.collect()
    torch.cuda.empty_cache()

    # 15. speculative decode: engines and the server with a draft
    t0 = time.perf_counter()
    spec = spec_phase(torch, inference, fa, params, config, rng)
    emit('spec', phase_s=time.perf_counter() - t0, **spec)
    if spec['faults']:
        raise AssertionError(f'spec decode: {spec["faults"]}')
    for quant, name in ((False, 'flash_attention'),
                        (True, 'flash_attention_quant')):
        run = spec['int8' if quant else 'bf16']
        # The spec engines' prefill is the main path's batched one: its
        # heaviest chunk is the serving shape timed above.
        serving = shape_entry(kernels[name], 'serving')
        heaviest = max(run['launched_shapes'],
                       key=lambda c: (c['shape'][1], c['shape'][-1]))
        if heaviest['shape'] != serving['shape'] + [serving['q_offset']]:
            raise AssertionError(f'spec prefill shapes {heaviest} differ '
                                 f'from the serving shape {serving}')
        kernels[name]['shapes'].append({
            **serving, 'path': 'spec', 'launches': run['kernel_launches']})
    del params, config
    gc.collect()
    torch.cuda.empty_cache()

    # 16-17. gemma2-9b at full width and depth through the d 256 instances
    for quant, name in ((False, 'flash_attention'),
                        (True, 'flash_attention_quant')):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        if quant:
            engine = inference.InferenceEngine(
                gparams, gconfig, kv_quant='int8', device=DEV, **GEMMA_KW)
        else:
            engine = inference.build_engine(GEMMA_MODEL, device=DEV, seed=0,
                                            kv_quant='none', **GEMMA_KW)
            gparams, gconfig = engine.params, engine.config
        init_s = time.perf_counter() - t0
        out, launches = gemma_phase(torch, inference, eng, fa, llama,
                                    engine, rng, quant)
        kernels[name + '_d256']['launches'] = launches
        emit('gemma_int8' if quant else 'gemma_bf16', model=GEMMA_MODEL,
             layers=gconfig.num_layers, init_s=init_s,
             phase_s=time.perf_counter() - t0, **GEMMA_KW, **out)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    del gparams, gconfig
    gc.collect()
    torch.cuda.empty_cache()

    # 18. an HF checkpoint through build_engine and the server's --checkpoint
    t0 = time.perf_counter()
    out = checkpoint_phase(torch, inference, rng)
    emit('checkpoint', phase_s=time.perf_counter() - t0, **out)
    gc.collect()
    torch.cuda.empty_cache()

    # 10. flash against dense training at bench-8b widths
    model, layers, seq_len = PARITY_BENCH
    parity = train_parity(torch, model, layers, seq_len)
    emit('train_parity', model=model, layers=layers, seq_len=seq_len,
         tol_loss=TOL_TRAIN_LOSS, tol_grad_rel=TOL_TRAIN_GRAD_REL,
         tol_proj_rel=TOL_TRAIN_PROJ_REL, **parity)
    if train_faults(parity):
        raise AssertionError(f'train parity: {train_faults(parity)}')
    torch.cuda.empty_cache()

    # 11. the training main path
    train = train_phase(torch, fa)
    shape_entry(kernels['flash_attention'], 'training')['launches'] = train[
        'launches']['K1']
    kernels['flash_attention_dq']['launches'] = train['launches']['K3']
    kernels['flash_attention_dkv']['launches'] = train['launches']['K4']
    emit('train', **train)
    del train
    gc.collect()
    torch.cuda.empty_cache()

    # 19. flash against dense training at gemma2-2b widths (d 256)
    model, layers, seq_len = PARITY_GEMMA
    parity = train_parity(torch, model, layers, seq_len)
    emit('train_parity_gemma', model=model, layers=layers, seq_len=seq_len,
         tol_loss=TOL_TRAIN_LOSS, tol_grad_rel=TOL_TRAIN_GRAD_REL,
         tol_proj_rel=TOL_TRAIN_PROJ_REL, **parity)
    if train_faults(parity):
        raise AssertionError(f'gemma train parity: {train_faults(parity)}')
    del parity
    gc.collect()
    torch.cuda.empty_cache()

    # 20. gemma2-2b trained at full width and depth through K3/K4 at d 256
    train = train_phase(torch, fa, GEMMA_TRAIN_MODEL, GEMMA_TRAIN_SEQ,
                        GEMMA_TRAIN_STEPS)
    # Each shape's launches are those its window was counted for.
    for shape in kernels['flash_attention_d256']['shapes']:
        if shape['path'].startswith('gemma_train'):
            shape['launches'] = train['window_launches']['K1'].get(
                shape['window'], 0)
    for name, counter in (('flash_attention_dq_d256', 'K3'),
                          ('flash_attention_dkv_d256', 'K4')):
        kernels[name]['launches'] = train['launches'][counter]
        for shape in kernels[name]['shapes']:
            shape['launches'] = train['window_launches'][counter].get(
                shape['window'], 0)
    emit('train_gemma', **train)

    emit('done', seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({'kernels': list(kernels.values())}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
