#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (skypilot_tpu_torch) end to end on one GPU.

    python3 chip_smoke.py            # every phase, one CUDA device

Phases, each printing one JSON line:
  1. toolchain  - torch/CUDA/nvcc versions, the card's name and power
                  limit, and the build of the hand-written kernels
                  (ops/csrc/flash_fwd.cu and flash_bwd.cu, one nvcc for
                  sm_90a per source, started together) with its time;
                  ptxas' registers, spills and wgmma serialisation of
                  every forward and backward kernel instance (`ptxas`).
                  An instance that spills or has its wgmmas serialised
                  fails.
  2. check_bf16 - K1 (flash_attention) against its plain PyTorch version
                  on the card: cached-prefill offset, window + softcap,
                  fully-masked rows, the engine's prefill shape, head_dim
                  64, ragged q/kv tiles at an unaligned offset, and four
                  warm tails of a prefix-cache hit (16 to 512 rows at
                  page-aligned offsets, and the repeat's 16 rows at
                  1215), within TOL_O on O and TOL_LSE on lse.
  3. check_int8 - K2 (flash_attention_quant) the same way.
  4. timing     - per kernel at the engine's prefill shape (K1 also at
                  the training shape, TRAIN_TIMING_SHAPE; both kernels
                  at the prefix phase's shapes after it): kernel, plain
                  version, scaled_dot_product_attention as a yardstick
                  (timed only, never used by the port), and the bound.
  5. engine_bf16 - build_engine('llama3-8b') at full width and depth with
                  random weights: prefill logits through the kernel
                  against the plain version and against the dense
                  forward, prefill and decode throughput, then the main
                  path: 9 requests (one interleaved) run to completion
                  with the K1 launch count read around it.
  6. engine_int8 - the same engine over an int8 KV cache (K2).
  7. server     - the port's HTTP server in-process: /health and three
                  /generate requests, one streaming.
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
                  run; blob bytes, snapshot and restore ms. Server to
                  server: a stream drained by /internal/drain into a
                  migrate frame continues through /internal/restore on a
                  second server with no token lost or repeated; a
                  corrupted blob gets 400. (12-14 run after phase 7.)
  8. check_bwd  - K3 (flash_attention_dq) and K4 (flash_attention_dkv,
                  ops/csrc/flash_bwd.cu) against flash_attention_bwd_plain
                  on the same bf16 inputs: the training shape, rows with
                  no visible key (dQ must be 0 there), ragged tiles,
                  window + softcap, non-causal ragged, q_offset and
                  head_dim 64 MHA, max|a-b| / max|b| of dQ, dK and dV
                  within TOL_BWD_REL; and K1's O and lse, which both
                  take, against flash_attention_plain at each of these
                  cases within TOL_O and TOL_LSE.
  9. timing_bwd - K3 and K4 at the training shape: kernel, plain version,
                  the backward of scaled_dot_product_attention as a
                  yardstick for both together (never used by the port),
                  and each kernel's bound.
 10. train_parity - one loss_fn + backward at bench-8b widths (2 layers,
                  S2048) through attention_impl 'flash' and 'dense': loss
                  and grad norm within TOL_TRAIN_LOSS / TOL_TRAIN_GRAD_REL,
                  the wq (K3), wk and wv (K4) grads within
                  TOL_TRAIN_PROJ_REL.
 11. train      - the training main path: skypilot_tpu_torch.train.loop.fit
                  on bench-8b (5 layers at llama3-8b width, vocab 32768),
                  batch 1 x 4096, random weights and a fixed synthetic
                  batch, with the K1/K3/K4 launch counts read around it;
                  the loss must be finite and fall; step time, tok/s, MFU,
                  peak memory, and one step under the profiler.
Then a `kernels` line and, last, {"ok": true, "device": {...}}.
Any failure raises (non-zero exit). Without CUDA it exits non-zero
before printing any result.
"""
import collections
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
# read at most 0.0061 (one step; bwd_accuracy.py over three seeds);
# kernel_fault_check.py's five backward faults read 0.073 and more. Rows
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
)
# The main path's heaviest prefill chunk: batch 8, chunk 512 at cache
# position 1536 of a 2048-position paged view (llama3-8b heads).
TIMING_SHAPE = (8, 512, 2048, 32, 8, 128, 1536)
# The train phase's attention (K1, forward and remat recompute): bench-8b
# heads at batch 1, seq 4096, causal, no offset.
TRAIN_TIMING_SHAPE = (1, 4096, 4096, 32, 8, 128, 0)


def kernel_readings(torch, fa, quant):
    """A reading of every CHECK_CASES case, by case name."""
    gen = torch.Generator(device=DEV).manual_seed(1 + int(quant))
    return {name: kernel_reading(torch, fa, gen, quant, *rest)
            for name, *rest in CHECK_CASES}


def kernel_timing(torch, fa, quant, shape=TIMING_SHAPE):
    """K1 (K2 with `quant`) at `shape` (B, T, S, H, KV, D, q_offset; causal
    from q_offset): kernel ms, plain ms, one SDPA call over the same
    (dequantised) inputs, and the bound, each on a queue the host has
    filled ahead; and the kernel's ms when the host paces the calls
    (`host_paced_ms`: the larger of the kernel's and the wrapper's
    per-call time, as the engine sees it)."""
    import torch.nn.functional as F
    b, t, s, h, kv, d, off = shape
    gen = torch.Generator(device=DEV).manual_seed(7)
    q, k, v, ks, vs = attn_inputs(torch, gen, b, t, s, h, kv, d, quant)
    kw = dict(causal=True, q_offset=off)
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
    if off == 0 and t == s:
        sdpa_kw = dict(is_causal=True)
    else:
        q_pos = off + torch.arange(t, device=DEV)
        sdpa_kw = dict(attn_mask=torch.arange(s, device=DEV)[None, :]
                       <= q_pos[:, None])
    try:
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **sdpa_kw), queue_ahead=True)
    except TypeError:  # a torch without enable_gqa: no one-call yardstick
        library_ms = None
    bms, bound_by, flops = bound_ms(b, t, s, h, kv, d, off, None, quant)
    return {'shape': [b, t, s, h, kv, d], 'q_offset': off, 'ms': ms,
            'host_paced_ms': host_paced_ms, 'plain_ms': plain_ms, 'library_ms': library_ms,
            'bound_ms': bms, 'bound_by': bound_by,
            'tflops': flops / (ms * 1e-3) / 1e12}


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


def logits_readings(torch, eng, fa, llama, engine, rng):
    """Last-token prefill logits of two prompts (700 and 1300 tokens)
    through the kernel, against the plain version and, on a bf16 cache,
    against the dense forward: max|a-b| / max|b| of each."""
    check_prompts = [prompt_tokens(rng, m, engine.config.vocab_size)
                     for m in (700, 1300)]
    k_logits, p_logits = prefill_paths(torch, eng, fa, engine,
                                       check_prompts)
    out = {'prefill_logits_finite': bool(torch.isfinite(k_logits).all()),
           'prefill_logits_rel_err_vs_plain': rel_err(torch, k_logits,
                                                      p_logits),
           'argmax_agree_vs_plain': int((k_logits.argmax(-1)
                                         == p_logits.argmax(-1)).sum())}
    if engine.kv_quant == 'none':
        with torch.inference_mode():
            ref = llama.forward(engine.params, torch.tensor(
                [check_prompts[0]], device=DEV), engine.config)[0, -1]
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


def server_phase(torch, inference, fa, params, config):
    from skypilot_tpu_torch.inference import server as server_lib
    engine = inference.InferenceEngine(
        params, config, batch_size=4, max_seq_len=2048, prefill_chunk=512,
        kv_page_size=64, device=DEV)
    holder = {'loop': None}
    srv = server_lib.create_server(holder, host='127.0.0.1', port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    loop = None
    try:
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
        rng_lens = ((300, 8, False), (900, 12, False), (600, 16, True))
        results = {}
        fa.flash_attention.launches = 0

        def request(i, n_prompt, max_new, stream):
            prompt = list(range(1, n_prompt + 1))
            status, text = http_json(base + '/generate', {
                'prompt_tokens': prompt, 'max_new_tokens': max_new,
                'stream': stream})
            if stream:
                frames = [json.loads(line[len('data: '):])
                          for line in text.splitlines()
                          if line.startswith('data: ')]
                toks = [f['token'] for f in frames if 'token' in f]
                done = frames[-1]
                if not done.get('done') or done['tokens'] != toks:
                    raise AssertionError(f'bad stream frames {frames[-2:]}')
            else:
                toks = json.loads(text)['tokens']
            results[i] = (status, len(toks), max_new)

        threads = [threading.Thread(target=request, args=(i, *case))
                   for i, case in enumerate(rng_lens)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or len(results) != 3:
            raise AssertionError(f'server requests incomplete: {results}')
        for i, (status, n, want) in results.items():
            if status != 200 or n != want:
                raise AssertionError(f'request {i}: {status}, {n} tokens, '
                                     f'want {want}')
        if fa.flash_attention.launches <= 0:
            raise AssertionError('server path never launched the kernel')
        return {'requests': len(results), 'streamed': 1, 'wall_s': wall,
                'token_counts': [results[i][1] for i in sorted(results)],
                'kernel_launches': fa.flash_attention.launches}
    finally:
        srv.shutdown()
        srv.server_close()
        if loop is not None:
            loop.stop()


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
               'tokens': [len(g) for g in got], 'equal': True}
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
)
# The train phase's attention: bench-8b heads at batch 1, seq 4096.
BWD_TIMING_CASE = BWD_CASES[0]


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


def bwd_timing(torch, fa):
    """K3 and K4 at the training shape: kernel ms, plain ms, the bound,
    and the backward of scaled_dot_product_attention (K3 + K4's work in
    one call, timed only)."""
    import torch.nn.functional as F
    case = BWD_TIMING_CASE
    _, b, sq, skv, h, kv, d, causal, off, window, softcap = case
    gen = torch.Generator(device=DEV).manual_seed(9)
    q, k, v, do, _, lse, delta = bwd_inputs(torch, fa, gen, b, sq, skv, h,
                                            kv, d, causal, off, window,
                                            softcap)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    plain_kw = dict(causal=causal, block_k=512, window=window,
                    softcap=softcap, q_offset=off)
    ms = {'dq': time_ms(torch, lambda: fa.flash_attention_dq(
              q, k, v, do, lse, delta, **kw)),
          'dkv': time_ms(torch, lambda: fa.flash_attention_dkv(
              q, k, v, do, lse, delta, **kw))}
    plain_ms = {'dq': time_ms(torch, lambda: fa._plain_bwd(
                    q, k, v, do, lse, delta, want_dkv=False, **plain_kw),
                    iters=3, warmup=1),
                'dkv': time_ms(torch, lambda: fa._plain_bwd(
                    q, k, v, do, lse, delta, want_dq=False, **plain_kw),
                    iters=3, warmup=1)}
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    try:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=True)
        go = do.transpose(1, 2)
        library_ms = time_ms(torch, lambda: torch.autograd.grad(
            out, (qt, kt, vt), go, retain_graph=True))
    except TypeError:  # a torch without enable_gqa: no one-call yardstick
        library_ms = None
    bounds = bwd_bounds(b, sq, skv, h, kv, d, off, window)
    return {name: {'shape': [b, sq, skv, h, kv, d], 'causal': causal,
                   'ms': ms[name], 'plain_ms': plain_ms[name],
                   'library_ms': library_ms, 'bound_ms': bounds[name][0],
                   'bound_by': bounds[name][1],
                   'tflops': bounds[name][2] / (ms[name] * 1e-3) / 1e12}
            for name in ('dq', 'dkv')}


def _global_norm(torch, tensors):
    return float(torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors])))


def train_parity(torch):
    """One loss_fn + backward at bench-8b widths (2 layers, S2048) through
    flash and dense attention on the same params and tokens."""
    import dataclasses

    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer
    base = dataclasses.replace(llama.CONFIGS['bench-8b'], num_layers=2)
    gen = torch.Generator(device=DEV).manual_seed(5)
    params = llama.init_params(base, gen, DEV)
    params = trainer.tree_map(lambda p: p.requires_grad_(True), params)
    leaves = trainer.tree_leaves(params)
    batch = {'tokens': torch.randint(0, base.vocab_size, (1, 2048),
                                     generator=gen, device=DEV)}
    out = {}
    grads = {}
    for impl in ('flash', 'dense'):
        config = dataclasses.replace(base, attention_impl=impl)
        loss = llama.loss_fn(params, batch, config)
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


def train_phase(torch, fa):
    """The training main path: fit() on bench-8b with the launch counts
    of K1, K2, K3 and K4 set to 0 just before and read just after."""
    from skypilot_tpu_torch.train import loop, trainer
    cfg = trainer.TrainerConfig(model='bench-8b', batch_size=1,
                                seq_len=4096, max_steps=TRAIN_STEPS,
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
    t0 = time.perf_counter()
    res = loop.fit(cfg, DEV, log_every=1, log_fn=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, quant, dq, dkv = (c.launches for c in counters)
    layers = mcfg.num_layers
    if min(fwd, dq, dkv) <= 0:
        raise AssertionError(f'train path launches: K1 {fwd}, K3 {dq}, '
                             f'K4 {dkv}')
    if dq != layers * TRAIN_STEPS or dkv != layers * TRAIN_STEPS:
        raise AssertionError(f'K3 {dq} / K4 {dkv} launches, want '
                             f'{layers} x {TRAIN_STEPS}')
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
    return {'model': 'bench-8b', 'layers': layers,
            'hidden': mcfg.hidden_size,
            'intermediate': mcfg.intermediate_size,
            'heads': [mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim],
            'vocab': mcfg.vocab_size, 'params': mcfg.num_params(),
            'batch': cfg.batch_size, 'seq_len': cfg.seq_len,
            'steps': TRAIN_STEPS, 'learning_rate': TRAIN_LR,
            'warmup_steps': TRAIN_WARMUP, 'remat': mcfg.remat,
            'losses': losses, 'wall_s': wall,
            'step_s': [h['step_s'] for h in res['history']],
            'median_step_s': median, 'tokens_per_s': tok_s,
            'mfu': trainer.mfu(tok_s, mcfg, cfg.seq_len,
                               trainer.PEAK_FLOPS['h100']),
            'peak_mem_gb': peak_mem, 'optimizer_ms': optimizer_ms,
            'launches': {'K1': fwd, 'K2': quant, 'K3': dq, 'K4': dkv},
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
        max_err = max(c['max_abs_err'] for c in cases.values())
        emit('check_int8' if quant else 'check_bf16', kernel=name,
             cases=cases, max_abs_err=max_err, tol_o=TOL_O,
             tol_lse=TOL_LSE)
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

    # 8-9. backward kernels against their plain version, then timing
    cases = bwd_readings(torch, fa)
    emit('check_bwd', kernels=['flash_attention_dq', 'flash_attention_dkv'],
         cases=cases, tol_rel=TOL_BWD_REL, tol_o=TOL_O, tol_lse=TOL_LSE)
    bad = {case: bwd_faults(c) for case, c in cases.items() if bwd_faults(c)}
    if bad:
        raise AssertionError(f'flash forward or backward disagrees with its '
                             f'plain version: {bad}')
    kernels['flash_attention']['max_abs_err'] = max(
        kernels['flash_attention']['max_abs_err'],
        *(c['fwd']['max_abs_err'] for c in cases.values()))
    timing = bwd_timing(torch, fa)
    emit('timing_bwd', **timing)
    for name, key, parts, line in (
            ('flash_attention_dq', 'dq', ('dq',), 178),
            ('flash_attention_dkv', 'dkv', ('dk', 'dv'), 229)):
        kernels[name] = {
            'name': name, 'route': 'cuda', 'source': BWD_SOURCE,
            'replaces': f'skypilot_tpu/ops/flash_attention.py:{line}',
            'launches': 0,
            'max_abs_err': max(c[f'{part}_max_abs_err']
                               for c in cases.values() for part in parts),
            'ms': timing[key]['ms'], 'plain_ms': timing[key]['plain_ms'],
            'bound_ms': timing[key]['bound_ms'],
            'bound_by': timing[key]['bound_by'],
            'library_ms': timing[key]['library_ms']}
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

    # 7. server
    emit('server', **server_phase(torch, inference, fa, params,
                                  config))
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
    del params, config
    gc.collect()
    torch.cuda.empty_cache()

    # 10. flash against dense training at bench-8b widths
    parity = train_parity(torch)
    emit('train_parity', model='bench-8b', layers=2, seq_len=2048,
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

    emit('done', seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({'kernels': list(kernels.values())}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
