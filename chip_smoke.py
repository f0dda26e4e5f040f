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
 14b. lb_serve  - inside migration, before its engines' teardown: the port's
                  load balancer (serve/load_balancer.py,
                  LoadBalancer('prefix_affinity')) in front of three
                  in-process servers on the migration phase's two engines
                  and a third (llama3-8b, 32 layers, MIGRATION_KW, the
                  prefix cache on) as the pools prefill, decode and
                  general (lb_serve_phase): a planned handoff of a
                  1000-token stream token for token against a cold run,
                  K1 on the prefill replica alone; the lb.handoff-armed
                  co-located fallback; a drain through the LB; prefix
                  affinity over two families; a dead replica opening its
                  breaker; the LB's stats, federated time series, the pool
                  autoscalers' decisions and its added TTFT.
                  `lb_fault_check.py` plants five faults the gates must
                  catch (LB_FAULTS, lb_plant).
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
 21. openai     - (after 7) the OpenAI routes on the port's server in this
                  process over phase 5's llama3-8b params (OPENAI_KW: 8
                  slots, no prefix cache, no interleave): /v1/models
                  gives the served name; a token-id /v1/completions
                  equals /generate on the same prompt token for token and
                  logprob for logprob (sent one at a time, so the batch
                  holds the same rows); n=2 greedy gives two identical
                  choices; a stream concatenates to the non-streamed
                  tokens; a text prompt and a chat request through
                  ToyTokenizer (a stdlib word-level tokenizer; the card
                  has no transformers) equal /generate on the encoded
                  prompt; a stop string truncates the text and, streamed,
                  ends the stream and aborts the request; usage equals the
                  counts; K1's launches around the /v1 requests equal
                  expected_prefill_launches of the admissions read around
                  the engine (`admissions`); the /metrics deltas equal the
                  requests and tokens.
 22. shedding   - the same server with max_queue_depth SHED_LIMIT: 10
                  streams, each admitted or queued before the next
                  arrives, fill the 8 slots (long ones) and queue 2
                  (short ones); then /generate
                  and /v1/completions each get 503 with Retry-After: 1
                  and REQUESTS_SHED rises by exactly 2; once the queue
                  drains a request gets 200, nothing else was shed, and
                  every stream finishes.
 23. batch      - (after 18) `python -m skypilot_tpu_torch.inference.batch`
                  as a process: 16 JSONL prompts of 100-1500 tokens, 32
                  new each, greedy, on llama3-8b (bf16, then int8 KV: K2)
                  and on phase 18's HF checkpoint; each output equal, byte
                  for byte, to run_batch in this process on an engine
                  built from the same flags, whose K1 (K2) launches equal
                  the admissions' expected count; the process's tok/s.
 24. roundtrip  - the fine-tune round trip at gemma2-2b width, 2 layers:
                  fit from phase 18's HF checkpoint, 4 steps at 1 x 8192
                  with a train checkpoint every 2 (K3 = K4 = 2 x 4, K1
                  2 x 2 x 4); a second fit to step 6 resumes at step 4,
                  its losses within TOL_RESUME_LOSS of an uninterrupted
                  6-step run; the resumed params exported to HF
                  (CKPT_EXPORT_* equal to ExportStats) load back bit for
                  bit and serve (build_engine(checkpoint=)) token for
                  token as an engine on the in-memory params; batch
                  --checkpoint on the train checkpoint as a process; a
                  step without its sentinel is not resumed; phase 18's
                  imported params re-export byte for byte; the
                  checkpoints CLI's inspect and verify as processes (rc 0
                  clean, non-zero with a NaN planted and on a truncated
                  shard). Save, restore and export seconds and GB/s.
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
 25. moe_serve  - mixtral-8x7b at its published widths, depth cut to 16
                  of 32 layers (46 GB of weights), random weights from
                  seed 0, the llama3-8b engine phase's traffic without
                  interleave or prefix cache; bf16, then int8 KV:
                  prefill logits through K1 (K2) against the plain
                  version and the dense path (use_flash=False) within
                  TOL_LOGITS_REL; on bf16, throughput, the expert MLP
                  (`_moe_mlp`) against its one-hot form
                  (`_moe_mlp_dense`) on a 4096-token chunk within
                  TOL_MOE_REL, three planted faults against the same
                  output (the second top-k slot dropped, a swapped pair
                  of experts, the combine weights left in f32), each of
                  which must break it, and the ms of routing, dispatch,
                  expert GEMMs and combine of each form; the main path
                  (9 greedy requests, 32 new) with K1 (K2) launches held
                  to the admissions' expected count, run twice on bf16
                  with the tokens equal; one fused decode dispatch with
                  torch.cuda.set_sync_debug_mode 'error' inside every MoE
                  layer and one sync a step (the loop's own) around them.
 26. moe_train  - train_parity at mixtral-8x7b's widths, 2 layers, seq
                  4096, then fit through TrainerConfig.attention_impl
                  'flash' (the preset is dense) on the same cut, 1 x 4096,
                  10 steps: K3 = K4 = 2 x 10, K1 2 x 2 x 10, K2 never;
                  the loss must fall and the router aux loss on the
                  trained params be finite and > 0; step time, tok/s, MFU
                  over the active params, peak memory.
 27. tp_serve   - llama3-8b at full width and depth over a tensor=2 mesh
                  (TP_KW: 8 slots, max_seq_len 2048, chunk 512, page 64):
                  two rank processes share the card over gloo (NCCL
                  refuses two ranks on one GPU), each built by
                  build_engine(mesh_arg=) from the gang variables with its
                  half of the seed-0 weights (16 q / 4 kv heads, half the
                  MLP and vocab). 8 greedy prompts of 100-1500 tokens, 32
                  new each, on bf16 then int8 KV: first-token logits
                  within TOL_LOGITS_REL of the unsharded engine (run
                  here beside the ranks), tokens
                  equal to its tokens up to near-ties (TOL_SPEC_GAP) and
                  equal across the ranks, K1 (K2) launches on each rank
                  equal to expected_prefill_launches; prefill and decode
                  tok/s, the collectives' time in the run and their
                  share of the prefill and of decode, peak memory per
                  rank. Two ranks
                  asking for NCCL on the one card exit with the mesh's
                  error. In the same ranks: the target as its own draft
                  (SPEC_K, SPEC_ROUNDS; tokens equal the ranks' bf16
                  tokens up to near-ties, acceptance at least
                  TOL_SPEC_ACCEPT, K1 launches per rank as the bf16
                  leg's), a migration leg (the longest and the shortest
                  prompt snapshotted after TP_MIG_DISPATCHES dispatches,
                  a third exported at its handoff pause, all restored:
                  tokens equal the bf16 leg's, the restored pages
                  byte-equal to the snapshotted ones on every rank, all 8
                  KV heads in each blob) and `moe_mesh`: mixtral-8x7b at
                  full width, MOE_MESH_LAYERS (4) layers, over expert=2
                  (4 experts a rank) on the moe_serve prompts, against an
                  unsharded engine of the same depth and seed run here
                  beside the ranks (logits within TOL_LOGITS_REL, tokens
                  up to near-ties, K1 launches, no host sync in a decode
                  dispatch's MoE layers on either rank). Then the server
                  as two processes (--mesh tensor=2): /health, three
                  /generate (one streamed) and one /v1/completions, token
                  for token the engine leg's answers to the same
                  requests; a stream drained by /internal/drain, its blob
                  restored on an unsharded engine and continued (the
                  near-tie rule against the ranks' tokens); SIGTERM to
                  rank 0, and rank 1 exits within TP_FOLLOWER_EXIT_S.
                  `mesh_fault_check.py` plants four serving faults the
                  gates must catch (`tp_plant`). K1 and K2
                  checked (check_bf16/check_int8 `tp2_engine_chunk`) and
                  timed at a rank's heaviest chunk (TP_TIMING_SHAPE).
 28. mesh_train - bench-8b at full width (2 of 5 layers, bf16, global
                  batch 2 x 4096, MT_STEPS steps a leg) trained by two
                  rank processes sharing the card over gloo, one gang,
                  each leg through `train.loop.main`: --mesh fsdp=-1
                  (from the seed weights as an HF --checkpoint, each
                  rank importing its cut; saving its last step), tensor=2
                  (16 / 4 heads a rank) and its resume of the fsdp
                  checkpoint for one more step, context=2 --attention
                  ring (2048 local tokens, K1/K3/K4 per hop). Against
                  the unsharded flash steps on the same seed weights and
                  batch (computed here while the ranks start): each
                  step's loss and grad norm within TOL_MT_LOSS_REL /
                  TOL_MT_NORM_REL, the boundary probe within
                  TOL_MT_PROBE, the ranks agreeing, replicated leaves
                  bit-equal across ranks, K1/K3/K4 launches per rank and
                  causal flag (the wrappers' `causal_launches`) equal to
                  `mt_expected_launches`; step s per leg, the
                  collectives' time and share, the set-up's seconds,
                  bytes staged through the host, peak memory per rank,
                  checkpoint save and restore GB/s. Then K1, K3 and K4
                  checked against their plain versions and timed at the
                  ring's per-hop shapes (`mesh_train_ring_kernels`),
                  with the ring leg's launches at each. In the same
                  ranks, two more legs (`extra_legs`): `pipe`, bench-8b
                  through `pipeline.llama_pipeline_forward` over pipe=2
                  (one layer a stage, 2 microbatches, each stage holding
                  its layers of the seed-0 draw), one forward and
                  backward of the cross-entropy: the sampled logits, the
                  loss and every gradient leaf's norm against the
                  unsharded forward's (TOL_PIPE_*), the replicated
                  leaves' gradients bit-equal across the stages, K1 4
                  and K3/K4 2 a rank; `expert`, mixtral-8x7b at full
                  width (2 layers, 1 x 4096, 4 experts a rank) through
                  `train.loop.main --mesh expert=2 --attention flash`,
                  against the parent's unsharded steps (run once the
                  ranks' fsdp, tensor and ring legs are done: the two
                  mixtral states never share the card) within
                  TOL_MT_LOSS_REL / TOL_MT_NORM_REL, the ranks agreeing,
                  replicated leaves bit-equal, K1 8 and K3/K4 4 a rank,
                  peak memory a rank and for the card.
                  `mesh_fault_check.py` plants the ten faults the
                  limits must catch.
Then a `kernels` line (each kernel's `path_launches`: its launches on
the openai, lb_serve, batch, roundtrip, MoE, tp_serve (its spec and migration
legs and moe_mesh among them) and mesh_train paths, the pipe and expert
legs among them) and,
last,
{"ok": true, "device": {...}}.
Any failure raises (non-zero exit). Without CUDA it exits non-zero
before printing any result.
"""
import collections
import contextlib
import dataclasses
import filecmp
import functools
import gc
import json
import math
import os
import signal
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
# The bytecode cache's directory in the checkout (`bytecode_cache`).
PYCACHE = '_pycache'
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
    kv positions any query needs, number of query rows that see at least
    one key) for one (batch, head)."""
    pairs, lo_min, hi_max, rows = 0, s, 0, 0
    for row in range(t):
        qp = off + row
        hi = min(s, qp + 1)
        lo = max(0, qp - window + 1) if window is not None else 0
        if hi > lo:
            pairs += hi - lo
            rows += 1
            lo_min, hi_max = min(lo_min, lo), max(hi_max, hi)
    return pairs, max(0, hi_max - lo_min), rows


def bound_ms(b, t, s, h, kv, d, off, window, quant):
    """(bound_ms, bound_by, flops) of K1 (K2 with `quant`): 4*d FLOP a
    visible pair; q read for the rows that see a key, the kv rows any
    query needs read once, O and lse written for every row (a row that
    sees no key only writes O = 0 and lse = +inf)."""
    pairs, kv_rows, q_rows = visible_span(t, s, off, window)
    flops = 4.0 * b * h * d * pairs
    esz = 1 if quant else 2
    nbytes = (b * q_rows * h * d * 2                  # q (rows that see)
              + 2 * b * kv_rows * kv * d * esz       # k, v (needed rows)
              + (2 * b * kv_rows * kv * 4 if quant else 0)  # scales
              + b * t * h * d * 2 + b * h * t * 4)   # o, lse
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes', flops)


def kernel_reading(torch, fa, gen, quant, b, t, s, h, kv, d, off, window,
                   softcap, causal=True):
    """K1 (K2 with `quant`) vs plain version on the same inputs, as
    `fwd_compare` reads them (`causal` False: no mask, `off` None)."""
    q, k, v, ks, vs = attn_inputs(torch, gen, b, t, s, h, kv, d, quant)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    o_k, lse_k = fa.flash_fwd(q, k, v, k_scale=ks, v_scale=vs, **kw)
    if quant:
        o_p, lse_p = fa.flash_attention_quant_plain(q, k, ks, v, vs, **kw)
    else:
        o_p, lse_p = fa.flash_attention_plain(q, k, v, **kw)
    return {'shape': [b, t, s, h, kv, d], 'q_offset': off,
            'window': window, 'softcap': softcap, 'causal': causal,
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
    # One rank's heads of llama3-8b at tensor 2 (16 q / 4 kv, the GQA
    # group of 4) at the main path's heaviest chunk (the tp_serve phase).
    ('tp2_engine_chunk', 8, 512, 2048, 16, 4, 128, 1536, None, None),
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
                  softcap=None, causal=True):
    """K1 (K2 with `quant`) at `shape` (B, T, S, H, KV, D, q_offset; causal
    from q_offset, with `window` and `softcap`; with `causal` False no
    mask, the offset None): kernel ms, plain ms, one
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
    kw = dict(causal=causal, q_offset=off, window=window, softcap=softcap)
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
    if not causal:
        sdpa_kw = {}
    elif off == 0 and t == s and window is None:
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
    # Without a mask every query sees every key: the causal count at an
    # offset past the block.
    bms, bound_by, flops = bound_ms(b, t, s, h, kv, d,
                                    off if causal else s, window, quant)
    out = {'shape': [b, t, s, h, kv, d], 'q_offset': off, 'window': window,
           'softcap': softcap, 'causal': causal, 'ms': ms,
           'host_paced_ms': host_paced_ms,
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
    the busy time. Only the device's activity is traced: every reading
    here is a kernel's, and tracing the host's ops as well tripled the
    profiler's cost (40 s against 13 s after a gemma2-9b batch of 60,000
    kernels) and added its overhead to the wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
                           page_size=engine.kv_page_size, device=dev,
                           mesh=engine.mesh)
    w = cache['table'].shape[1]
    cache['table'][:] = 1 + torch.arange(n * w, dtype=torch.int32,
                                         device=dev).reshape(n, w)
    return tokens, lengths, torch.arange(n, device=dev), cache


def prefill_logits(torch, eng, engine, prompts, use_flash=True):
    """Last-token logits of one batched chunked prefill of `prompts`
    into a fresh paged cache of the engine's layout."""
    chunk = engine.prefill_chunk
    padded_len = -(-max(map(len, prompts)) // chunk) * chunk
    tokens, lengths, slots, cache = batch_inputs(torch, eng, engine, prompts,
                                                 padded_len)
    logits, _ = eng.prefill_chunked(engine.params, tokens, lengths, cache,
                                    slots, engine.config, chunk,
                                    use_flash=use_flash)
    torch.cuda.synchronize()
    return logits


@contextlib.contextmanager
def plain_kernels(fa):
    """K1 and K2 swapped for their plain version for the block."""
    def wrap(launch):
        def plain_launch(q, k, v, causal, window, softcap, q_offset,
                         k_scale=None, v_scale=None):
            return fa._plain(q, k, v, causal, 512, window, softcap, q_offset,
                             k_scale=k_scale, v_scale=v_scale)
        return plain_launch

    with patched(fa, '_launch', wrap):
        yield


def prefill_paths(torch, eng, fa, engine, prompts):
    """Last-token prefill logits of `prompts` through the kernel and
    through the plain version (the kernel swapped out), each into a
    fresh paged cache. Returns (kernel, plain)."""
    kernel_logits = prefill_logits(torch, eng, engine, prompts)
    with plain_kernels(fa):
        plain_logits = prefill_logits(torch, eng, engine, prompts)
    return kernel_logits, plain_logits


def rel_err(torch, a, b):
    a, b = a.float(), b.float()
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
                'prefill_logits_rel_err_vs_dense_forward',
                'prefill_logits_rel_err_vs_dense_path'):
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
def patched(obj, name, wrap):
    """`obj.name` replaced by `wrap(obj.name)` for the block, then
    restored (an attribute the object did not hold itself, such as a
    method of its class, is deleted again)."""
    fn = getattr(obj, name)
    own = name in vars(obj)
    setattr(obj, name, wrap(fn))
    try:
        yield
    finally:
        if own:
            setattr(obj, name, fn)
        else:
            delattr(obj, name)


@contextlib.contextmanager
def counted(obj, name, counts, key):
    """Count the calls of `obj.name` in `counts[key]` for the block,
    outside the books of the code that makes them."""
    def wrap(fn):
        def wrapper(*args, **kwargs):
            counts[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    with patched(obj, name, wrap):
        yield counts


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


def sse_frames(lines):
    """The SSE frames of an open HTTP response (or of a body's lines),
    one dict at a time; an OpenAI stream's closing `[DONE]` as None."""
    for line in lines:
        line = line.strip()
        if isinstance(line, bytes):
            line = line.decode()
        if line.startswith('data: '):
            data = line[len('data: '):]
            yield None if data == '[DONE]' else json.loads(data)


# The server-to-server migration's engines, and the lb_serve phase's.
MIGRATION_KW = dict(batch_size=4, max_seq_len=2048, prefill_chunk=512,
                    kv_page_size=64)


def migration_phase(torch, inference, params, config, rng, lb_serve=None):
    """Engine to engine: two requests (600 and 1500 tokens, 64 new,
    greedy) on engine A are snapshotted after 16 tokens, aborted and
    restored into engine B; their tokens must equal an uninterrupted
    run. Server to server: a stream on server 1 drained into a migrate
    frame continues through /internal/restore on server 2 with no token
    duplicated or missing; a corrupted blob gets 400. With `lb_serve`,
    a third engine is built beside the servers' two and
    `lb_serve(one, two, three)` runs before their teardown; its result
    is the reading's `lb_serve`."""
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

    kw = dict(**MIGRATION_KW, device=DEV)
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
    out = {'engine_to_engine': engines,
           'server_to_server': {
               'prompt_tokens': len(prompt), 'max_new_tokens': max_new,
               'tokens_before_drain': len(first), 'sent': sent,
               'tokens_after_restore': len(rest), 'blob_bytes': len(blob),
               'drain': drained['body'], 'corrupted_blob_status': bad_status,
               'restore_to_done_s': resumed_s, 'equal': True}}
    if lb_serve is not None:
        out['lb_serve'] = lb_serve(
            one, two, inference.InferenceEngine(params, config, **kw))
    return out


# The fifteenth slice: the port's load balancer (serve/load_balancer.py,
# prefix_affinity, pools prefill / decode / general) in front of three
# llama3-8b replicas of the port's server in this process: the migration
# phase's two engines and a third (batch 4, 2048 positions, chunk 512,
# page 64, the prefix cache on), on the same weights. The phase draws
# from a generator of its own.
LB_POOLS = ('prefill', 'decode', 'general')
LB_HANDOFF = (1000, 32)      # (prompt tokens, new tokens): legs (a), (b)
LB_DRAIN = (200, 64)         # leg (c), drained after LB_DRAIN_AFTER tokens
LB_DRAIN_AFTER = 2
LB_FAMILY = (1024, 64, 8)    # leg (d): shared prefix, tail, new tokens
LB_FAMILIES = 2
LB_FAMILY_SIZE = 3
LB_AFFINITY_HITS_MIN = 4
LB_SHORT = (64, 4)           # legs (e) and (f): a short decode-shaped prompt
LB_DEAD_MAX_REQUESTS = 24
LB_TTFT_RUNS = 5
# A 1000-token tokenized stream with 32 new tokens is prefill-shaped.
# The LB starts its sampler and its watchdog; the watchdog's tick (its
# scrape of the replicas) is run once, in leg (f): the replicas share
# this process's time-series store with the LB, so a federation running
# all through the phase would fold each scrape back into the next.
# The prefill replica's lease is the reference's test's (30 s): only the
# LB's abandon (or a fallback's resume) may free a paused slot within
# the phase, so a broken release shows. Leg (a) reads the seconds from
# its first token to the decode leg's restore against the 5 s default
# lease (`fits_default_lease`), a reading and not a gate: the
# ~190 MB frame's JSON and base64 on the host set it (PERF.md).
# The affinity policy's load is its in-flight requests alone (no window
# of recent starts, as the reference's own affinity tests set it): the
# legs send one request at a time, so a window would count requests
# already answered, and spill a family off its replica or not by how
# fast the host ran them.
LB_ENV = {'SKYTPU_LB_POOL_PROMPT_THRESHOLD': '1000',
          'SKYTPU_LB_AFFINITY_LOAD_WINDOW': '0',
          'SKYTPU_TS_SAMPLE_SECONDS': '1.0',
          'SKYTPU_WATCHDOG_TICK_SECONDS': '3600',
          'SKYTPU_HANDOFF_LEASE_SECONDS': '30'}
# The pooled spec whose autoscalers read the phase's signals.
LB_SERVICE = {'readiness_probe': '/health',
              'load_balancing_policy': 'prefix_affinity',
              'pools': {
                  'prefill': {'role': 'prefill', 'min_replicas': 1,
                              'max_replicas': 2,
                              'target_queue_per_replica': 4.0,
                              'ttft_p95_upscale_threshold': 2.0,
                              'upscale_delay_seconds': 0,
                              'downscale_delay_seconds': 0},
                  'decode': {'role': 'decode', 'min_replicas': 1,
                             'max_replicas': 2,
                             'kv_util_upscale_threshold': 0.85,
                             'decode_step_p95_upscale_threshold': 0.3,
                             'upscale_delay_seconds': 0,
                             'downscale_delay_seconds': 0},
                  'general': {'role': 'general', 'min_replicas': 1}}}
# lb_fault_check.py's planted faults: each breaks the gate named here.
LB_FAULTS = {'handoff_frame_forwarded': 'handoff_no_internal_frame',
             'restore_to_prefill': 'handoff_decode_leg',
             'sent_uncounted': 'handoff_stream_equal',
             'affinity_ignored': 'affinity_hits',
             'breaker_never_opens': 'breaker_opens'}
LB_COUNTERS = ('HANDOFF_ATTEMPTS', 'HANDOFF_SUCCESSES', 'HANDOFF_FALLBACKS',
               'MIGRATION_ATTEMPTS', 'MIGRATION_SUCCESSES',
               'MIGRATION_FAILURES', 'LB_MIDSTREAM_FAILURES',
               'LB_PROXY_ERRORS', 'LB_UPSTREAM_RETRIES', 'LB_NO_REPLICA',
               'LB_AFFINITY_HITS', 'LB_AFFINITY_MISSES',
               'LB_AFFINITY_FALLBACKS')


@contextlib.contextmanager
def env_set(values):
    """The block with the environment variables `values` set, each
    restored (or unset) on the way out."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def lb_plant(name, lb, urls):
    """Plant one of lb_fault_check.py's faults in `lb` (None plants
    nothing); each patches the instance, so nothing outlives the phase:
    - 'handoff_frame_forwarded': the relay passes the handoff frame to
      the client (and then walks the ladder as before);
    - 'restore_to_prefill': every restore leg goes to the prefill
      replica, the source pool;
    - 'sent_uncounted': the relay counts one frame the client never got
      into the `sent` of the handoff's restore;
    - 'affinity_ignored': the policy's select drops the request's
      fingerprints (least-load for all);
    - 'breaker_never_opens': the breaker drops every failure."""
    if name is None:
        return
    from skypilot_tpu_torch.serve import load_balancer as lb_lib
    if name == 'handoff_frame_forwarded':
        local = threading.local()
        relay, handoff = lb._relay_managed, lb._handoff_stream

        def capture(handler, *args, **kwargs):
            local.handler = handler
            return relay(handler, *args, **kwargs)

        def forward(context, state, src, key, payload):
            lb_lib._write_chunk(local.handler, b'data: ' + json.dumps(
                {'handoff': payload}).encode() + b'\n\n')
            return handoff(context, state, src, key, payload)

        lb._relay_managed, lb._handoff_stream = capture, forward
    elif name == 'restore_to_prefill':
        restore = lb._restore_leg
        lb._restore_leg = lambda cand, sent, blob: restore(urls[0], sent,
                                                           blob)
    elif name == 'sent_uncounted':
        handoff = lb._handoff_stream

        def miscount(context, state, src, key, payload):
            state['sent'] += 1
            return handoff(context, state, src, key, payload)

        lb._handoff_stream = miscount
    elif name == 'affinity_ignored':
        select = lb.policy.select
        lb.policy.select = lambda context=None, candidates=None: select(
            None, candidates)
    elif name == 'breaker_never_opens':
        lb.breaker.record_failure = lambda target: None
    else:
        raise ValueError(f'unknown lb fault {name!r}')


def lb_stream(url, prompt, new, on_token=None, stream=True):
    """One greedy /generate at `url`: its tokens, the done frame's
    tokens, the keys of every frame (streamed) and the seconds to the
    first token frame (to the whole answer unstreamed)."""
    body = {'prompt_tokens': prompt, 'max_new_tokens': new,
            'temperature': 0.0, 'stream': stream}
    req = urllib.request.Request(url + '/generate',
                                 data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    t0 = time.perf_counter()
    out = {'tokens': [], 'done': None, 'kinds': set(), 'ttft_s': None}
    with urllib.request.urlopen(req, timeout=300) as resp:
        out['status'] = resp.status
        if not stream:
            out['tokens'] = out['done'] = json.loads(resp.read())['tokens']
            out['ttft_s'] = time.perf_counter() - t0
            return out
        for frame in sse_frames(resp):
            out['kinds'].update(frame)
            if 'token' in frame:
                if out['ttft_s'] is None:
                    out['ttft_s'] = time.perf_counter() - t0
                out['tokens'].append(frame['token'])
                if on_token is not None:
                    on_token(len(out['tokens']))
            elif 'done' in frame:
                out['done'] = frame['tokens']
    return out


def lb_counters(obs):
    out = {name: getattr(obs, name).value() for name in LB_COUNTERS}
    out['CIRCUIT_OPEN'] = sum(v for _, labels, v in obs.CIRCUIT_OPEN.samples()
                              if dict(labels).get('breaker') == 'lb')
    return out


def lb_delta(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def lb_idle(engines, lb=None, timeout=30.0):
    """Wait until no engine holds a request (a handoff's abandon is a
    background call) and, given `lb`, no leg is in flight there (a
    connection thread ends its leg after the client has the answer)."""
    def busy():
        return any(e.has_work for e in engines) or (
            lb is not None and any(
                lb.policy.stats().get('in_flight', {}).values()))

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and busy():
        time.sleep(0.02)
    return not busy()


def lb_serve_phase(torch, inference, fa, engines, rng, fault=None):
    """The port's LoadBalancer('prefix_affinity', honor_env_policy=False)
    in front of the port's server on each of `engines` (pools prefill,
    decode, general, in that order), legs (a)-(f):
    (a) planned handoff: a streamed greedy 1000-token request, 32 new,
        equal token for token to the same engines' uninterrupted run (a
        cold run on the third engine), no handoff/migrate/error frame at
        the client, HANDOFF_ATTEMPTS and HANDOFF_SUCCESSES +1, the
        decode leg restored on the decode replica, K1 launched
        expected_prefill_launches times on the prefill replica and never
        on the others (decode attention is plain torch);
    (b) the fallback rung: `lb.handoff` armed once, the same request
        resumes co-located with the same stream, HANDOFF_FALLBACKS +1;
    (c) a drain through the LB: a decode-shaped stream whose replica is
        drained (/internal/drain?deadline=0) after its 2nd token is
        whole, nothing repeated or missing, MIGRATION_SUCCESSES +1;
    (d) affinity, the fleet poolless: two families of three requests (a
        shared 1024-token prefix and distinct 64-token tails, 8 new
        each): each family on one replica, whose prefix-cache hits rise
        by the family's warm requests, LB_AFFINITY_HITS +4 or more;
        warm against cold TTFT through the LB;
    (e) a dead replica (a closed port in the decode pool): every request
        completes through failover before the first byte, the breaker
        opens after 3 failures (CIRCUIT_OPEN +1), LB_NO_REPLICA +0;
    (f) the LB's surface: /internal/stats with the QPS and no request in
        flight, the federated /internal/timeseries holding every
        replica's series under its `replica` label, the pool
        autoscalers' decisions on MetricsSignalSource.read_pools, and
        the LB's added TTFT (the median of LB_TTFT_RUNS short prompts
        direct and through the LB).
    `faults` maps each broken gate to what broke it; `fault` plants one
    of LB_FAULTS (lb_plant)."""
    import statistics

    from skypilot_tpu_torch.inference import server as server_lib
    from skypilot_tpu_torch.observability import instruments as obs
    from skypilot_tpu_torch.observability import timeseries
    from skypilot_tpu_torch.resilience import faults as faults_lib
    from skypilot_tpu_torch.serve import autoscalers
    from skypilot_tpu_torch.serve import load_balancer as lb_lib
    from skypilot_tpu_torch.serve import service_spec
    t_phase = time.perf_counter()
    gates = {}

    def gate(name, ok, detail):
        if not ok:
            gates.setdefault(name, []).append(detail)

    vocab = engines[0].config.vocab_size
    prompts = {'handoff': prompt_tokens(rng, LB_HANDOFF[0], vocab),
               'drain': prompt_tokens(rng, LB_DRAIN[0], vocab)}
    news = {'handoff': LB_HANDOFF[1], 'drain': LB_DRAIN[1]}
    # Each stream's uninterrupted greedy run on a cold cache (leg (b)
    # sends leg (a)'s request again); then every replica starts the legs
    # with no request and an empty prefix cache.
    want = {}
    for leg, prompt in prompts.items():
        engines[2].abort_all()
        rid = engines[2].submit(prompt, inference.SamplingParams(
            max_new_tokens=news[leg]))
        want[leg] = engines[2].run_to_completion()[rid]
    for engine in engines:
        engine.abort_all()
    out = {'model_layers': engines[0].config.num_layers,
           'pools': list(LB_POOLS), 'fault': fault}
    # The replicas share this process's time-series store with the LB,
    # which federates their dumps back into it: each run starts it
    # empty, and leaves it so.
    timeseries.STORE.clear()
    holders, servers = [], []
    lb = None
    threads_before = set(threading.enumerate())
    with env_set(LB_ENV):
        try:
            for engine in engines:
                holder = {'loop': server_lib.EngineLoop(engine)}
                srv = server_lib.create_server(holder, host='127.0.0.1',
                                               port=0)
                threading.Thread(target=srv.serve_forever,
                                 kwargs={'poll_interval': 0.05},
                                 daemon=True).start()
                holders.append(holder)
                servers.append(srv)
            urls = [f'http://127.0.0.1:{srv.server_address[1]}'
                    for srv in servers]
            pools = dict(zip(urls, LB_POOLS))
            replica_of = {h['loop']._thread: name
                          for h, name in zip(holders, LB_POOLS)}
            k1 = {name: 0 for name in LB_POOLS}

            def attributed(count):
                def wrapper(fn, *args, **kwargs):
                    name = replica_of.get(threading.current_thread())
                    if fn is fa.flash_attention and name is not None:
                        k1[name] += 1
                    return count(fn, *args, **kwargs)
                return wrapper

            lb = lb_lib.LoadBalancer('prefix_affinity',
                                     honor_env_policy=False)
            lb.set_replicas(urls, pools)
            lb_plant(fault, lb, urls)
            base = f'http://127.0.0.1:{lb.start()}'

            def admitted():
                return {n: e._next_id for n, e in zip(LB_POOLS, engines)}

            fa.flash_attention.launches = 0
            with patched(fa, '_count', attributed):
                lb_legs(torch, inference, engines, holders, lb, lb_lib,
                        base, urls, pools, prompts, news, want, k1,
                        admitted, obs, faults_lib, gate, out, rng)
            out['kernel_launches'] = fa.flash_attention.launches

            # (f) the LB's own surface.
            t_surface = time.perf_counter()
            stats = poll(lambda: json.loads(http_call(
                base + '/internal/stats')[2]),
                lambda doc: not any(doc['routing']['affinity'][
                    'in_flight'].values()))
            in_flight = stats['routing']['affinity']['in_flight']
            gate('stats', stats['qps'] > 0 and not any(in_flight.values())
                 and sorted(stats['replicas']) == sorted(urls),
                 f'qps {stats["qps"]}, in flight {in_flight}')

            def federated():
                doc = json.loads(http_call(base + '/internal/timeseries')[2])
                seen = {}
                for series in doc.get('series', []):
                    labels = series.get('labels') or {}
                    if labels.get('replica') in urls:
                        seen.setdefault(labels['replica'], set()).add(
                            series['name'])
                return seen

            timeseries.STORE.sample_now()
            lb._watchdog.tick()  # one scrape of every replica
            seen = poll(federated, lambda s: all(
                len(s.get(u, ())) > 1 for u in urls), timeout=20.0)
            gate('federation', all(len(seen.get(u, ())) > 1 for u in urls),
                 f'series by replica {[len(seen.get(u, ())) for u in urls]}')
            spec = service_spec.ServiceSpec.from_yaml_config(LB_SERVICE)
            scalers = autoscalers.make_pool_autoscalers(spec)
            signals = autoscalers.MetricsSignalSource().read_pools(
                list(scalers))
            qps = lb.tracker.qps()
            out['surface'] = {
                'qps': stats['qps'], 'in_flight': list(in_flight.values()),
                'breakers': list(stats['breakers'].values()),
                'affinity': {k: stats['routing']['affinity'][k]
                             for k in ('entries', 'hits', 'misses',
                                       'fallbacks')},
                'federated_series': [len(seen.get(u, ())) for u in urls],
                'autoscalers': {
                    name: {'signals': dataclasses.asdict(signals[name]),
                           'decision': dataclasses.asdict(
                               scaler.decide(1, 1, qps, signals[name]))}
                    for name, scaler in scalers.items()}}
            # The LB's added TTFT: one short decode-shaped prompt sent
            # direct to the decode replica and through the LB, in turns
            # (the median sets the first, cold, run aside).
            short = prompt_tokens(rng, LB_SHORT[0], vocab)
            ttft = {'direct': [], 'lb': []}
            for run in range(LB_TTFT_RUNS):
                for path, url in (('direct', urls[1]), ('lb', base)):
                    ttft[path].append(lb_stream(url, short,
                                                LB_SHORT[1])['ttft_s'])
            out['added_ttft'] = {
                'runs': LB_TTFT_RUNS, 'prompt_tokens': LB_SHORT[0],
                'direct_median_s': statistics.median(ttft['direct']),
                'lb_median_s': statistics.median(ttft['lb']),
                'added_ms': 1e3 * (statistics.median(ttft['lb'])
                                   - statistics.median(ttft['direct']))}
            out['leg_s']['surface'] = time.perf_counter() - t_surface
        finally:
            faults_lib.reset()
            if lb is not None:
                lb.stop()
            for srv in servers:
                srv.shutdown()
                srv.server_close()
            for holder in holders:
                holder['loop'].stop()
    timeseries.STORE.clear()
    left = [t.name for t in set(threading.enumerate()) - threads_before
            if t.is_alive() and t.name.startswith(('skytpu-lb', 'skytpu-ts',
                                                   'skytpu-watchdog'))]
    gate('threads', not left, f'threads left after stop(): {left}')
    out['phase_s'] = time.perf_counter() - t_phase
    out['faults'] = gates
    return out


def lb_legs(torch, inference, engines, holders, lb, lb_lib, base, urls,
            pools, prompts, news, want, k1, admitted, obs, faults_lib, gate,
            out, rng):
    """Legs (a)-(e) of lb_serve_phase, in its fleet; readings into
    `out`, broken gates through `gate`."""
    from skypilot_tpu_torch import envs
    internal = {'handoff', 'migrate', 'error'}
    expected = expected_prefill_launches(engines[0], [LB_HANDOFF[0]])
    out['leg_s'] = {}
    last = [time.perf_counter()]

    def lap(leg):
        now = time.perf_counter()
        out['leg_s'][leg] = now - last[0]
        last[0] = now

    # (a) the planned handoff, with the seconds to the LB's reading of
    # the handoff frame and of its restore on the decode pool.
    c0, k0, a0 = lb_counters(obs), dict(k1), admitted()
    marks = {}

    def marked(handoff):
        def ladder(*args, **kwargs):
            marks['frame_s'] = time.perf_counter() - t0
            try:
                return handoff(*args, **kwargs)
            finally:
                marks['restored_s'] = time.perf_counter() - t0
        return ladder

    t0 = time.perf_counter()
    with patched(lb, '_handoff_stream', marked):
        got = lb_stream(base, prompts['handoff'], news['handoff'])
    wall = time.perf_counter() - t0
    gate('handoff_idle', lb_idle(engines, lb),
         'a replica or the LB still holds a request')
    d = lb_delta(c0, lb_counters(obs))
    launches = {n: k1[n] - k0[n] for n in LB_POOLS}
    legs = {n: admitted()[n] - a0[n] for n in LB_POOLS}
    gate('handoff_stream_equal', got['tokens'] == want['handoff']
         and got['done'] == want['handoff'],
         f'{len(got["tokens"])} tokens, equal to the run '
         f'{got["tokens"] == want["handoff"]}')
    gate('handoff_no_internal_frame', not got['kinds'] & internal,
         f'frames {sorted(got["kinds"])}')
    # No fallback either: the decode leg restored inside the prefill
    # replica's lease (past it the engine resumes co-located and counts
    # one).
    gate('handoff_counters', d.get('HANDOFF_ATTEMPTS') == 1
         and d.get('HANDOFF_SUCCESSES') == 1
         and 'HANDOFF_FALLBACKS' not in d, f'deltas {d}')
    gate('handoff_launches', launches == {'prefill': expected, 'decode': 0,
                                          'general': 0},
         f'K1 by replica {launches}, want {expected} on prefill only')
    gate('handoff_decode_leg', legs == {'prefill': 1, 'decode': 1,
                                        'general': 0},
         f'admissions by replica {legs}')
    # The lease runs from the pause at the first token until the LB's
    # abandon, which follows the restore.
    default_lease = envs.SKYTPU_HANDOFF_LEASE_SECONDS.default
    lease_used = (None if 'restored_s' not in marks or got['ttft_s'] is None
                  else marks['restored_s'] - got['ttft_s'])
    out['handoff'] = {'prompt_tokens': LB_HANDOFF[0],
                      'tokens': len(got['tokens']),
                      'equal': got['tokens'] == want['handoff'],
                      'frames': sorted(got['kinds']), 'ttft_s': got['ttft_s'],
                      'handoff_frame_read_s': marks.get('frame_s'),
                      'decode_leg_restored_s': marks.get('restored_s'),
                      'lease_used_s': lease_used,
                      'default_lease_s': default_lease,
                      'fits_default_lease': (lease_used is not None
                                             and lease_used < default_lease),
                      'wall_s': wall, 'counters': d,
                      'k1_by_replica': launches, 'k1_expected': expected,
                      'admissions_by_replica': legs}

    lap('handoff')

    # (b) the fallback rung: the same request, the ladder forced
    # co-located, on a prefill replica whose prefix cache is dropped
    # first (a warm prefill would not be the reference's run).
    holders[0]['loop'].run_on_engine(engines[0].abort_all).result()
    c0, a0 = lb_counters(obs), admitted()
    faults_lib.arm('lb.handoff', times=1, exc=OSError('armed by chip_smoke'))
    try:
        got = lb_stream(base, prompts['handoff'], news['handoff'])
    finally:
        faults_lib.reset()
    gate('fallback_idle', lb_idle(engines, lb),
         'a replica or the LB still holds a request')
    d = lb_delta(c0, lb_counters(obs))
    legs = {n: admitted()[n] - a0[n] for n in LB_POOLS}
    gate('fallback_stream_equal', got['tokens'] == want['handoff']
         and got['done'] == want['handoff']
         and not got['kinds'] & internal,
         f'{len(got["tokens"])} tokens, equal '
         f'{got["tokens"] == want["handoff"]}, frames {sorted(got["kinds"])}')
    gate('fallback_counter', d.get('HANDOFF_FALLBACKS') == 1
         and 'HANDOFF_SUCCESSES' not in d
         and legs == {'prefill': 1, 'decode': 0, 'general': 0},
         f'deltas {d}, admissions {legs}')
    out['fallback'] = {'tokens': len(got['tokens']),
                       'equal': got['tokens'] == want['handoff'],
                       'counters': d, 'admissions_by_replica': legs}

    lap('fallback')

    # (c) a drain through the LB after the stream's 2nd token.
    c0 = lb_counters(obs)
    drained = {}

    def drain_serving(n):
        if n != LB_DRAIN_AFTER:
            return
        in_flight = lb.policy.stats()['in_flight']
        url = next(u for u, k in in_flight.items() if k)
        drained['replica'] = pools[url]

        def post():
            drained['status'], body = http_json(
                url + '/internal/drain?deadline=0', {})
            drained['body'] = json.loads(body)
        drained['thread'] = threading.Thread(target=post)
        drained['thread'].start()

    got = lb_stream(base, prompts['drain'], news['drain'], drain_serving)
    if 'thread' in drained:
        drained.pop('thread').join(300)
    gate('drain_idle', lb_idle(engines, lb),
         'a replica or the LB still holds a request')
    d = lb_delta(c0, lb_counters(obs))
    body = drained.get('body') or {}
    gate('drain_stream_whole', got['tokens'] == want['drain']
         and got['done'] == want['drain'] and not got['kinds'] & internal,
         f'{len(got["tokens"])} of {len(want["drain"])} tokens, equal '
         f'{got["tokens"] == want["drain"]}, frames {sorted(got["kinds"])}')
    gate('drain_counter', d.get('MIGRATION_SUCCESSES') == 1
         and 'LB_MIDSTREAM_FAILURES' not in d
         and body.get('migrated_streams') == 1,
         f'deltas {d}, drain {body.get("migrated_streams")} streams')
    out['drain'] = {'replica': drained.get('replica'),
                    'tokens': len(got['tokens']),
                    'equal': got['tokens'] == want['drain'],
                    'migrated_streams': body.get('migrated_streams'),
                    'counters': d}
    # The drained replica serves again (a replaced replica would).
    for holder, url in zip(holders, urls):
        holder['draining'] = False

    lap('drain')

    # (d) prefix affinity over the whole fleet (no pools).
    lb.set_replicas(urls, pools={})
    c0 = lb_counters(obs)
    prefix_len, tail_len, new = LB_FAMILY
    families = []
    for _ in range(LB_FAMILIES):
        prefix = prompt_tokens(rng, prefix_len, engines[0].config.vocab_size)
        families.append([prefix + prompt_tokens(
            rng, tail_len, engines[0].config.vocab_size)
            for _ in range(LB_FAMILY_SIZE)])
    served = [[] for _ in families]
    for i in range(LB_FAMILY_SIZE):
        for f, family in enumerate(families):
            a0 = admitted()
            h0 = [e.stats['prefix_hits'] for e in engines]
            got = lb_stream(base, family[i], new)
            lb_idle(engines, lb)
            a1 = admitted()
            replica = [n for n in LB_POOLS if a1[n] != a0[n]]
            served[f].append({
                'replica': replica[0] if len(replica) == 1 else replica,
                'ttft_s': got['ttft_s'], 'tokens': len(got['tokens']),
                'prefix_hits': {n: e.stats['prefix_hits'] - h
                                for n, e, h in zip(LB_POOLS, engines, h0)
                                if e.stats['prefix_hits'] != h}})
    d = lb_delta(c0, lb_counters(obs))
    for f, rows in enumerate(served):
        replicas = {str(r['replica']) for r in rows}
        warm_hits = [r['prefix_hits'].get(rows[0]['replica'], 0)
                     for r in rows[1:]]
        gate('affinity_sticky', len(replicas) == 1 and all(warm_hits),
             f'family {f}: replicas {sorted(replicas)}, warm hits '
             f'{warm_hits}')
    gate('affinity_hits', d.get('LB_AFFINITY_HITS', 0) >= LB_AFFINITY_HITS_MIN,
         f'LB_AFFINITY_HITS +{d.get("LB_AFFINITY_HITS", 0)}, want '
         f'{LB_AFFINITY_HITS_MIN} or more; deltas {d}')
    out['affinity'] = {
        'prefix_tokens': prefix_len, 'tail_tokens': tail_len,
        'families': [{'replicas': [r['replica'] for r in rows],
                      'cold_ttft_s': rows[0]['ttft_s'],
                      'warm_ttft_s': [r['ttft_s'] for r in rows[1:]],
                      'prefix_hits': [r['prefix_hits'] for r in rows]}
                     for rows in served],
        'counters': d}
    lb.set_replicas(urls, pools)

    lap('affinity')

    # (e) a dead replica in the decode pool.
    dead = f'http://127.0.0.1:{free_port()}'
    lb.set_replicas(urls + [dead], {**pools, dead: 'decode'})
    c0 = lb_counters(obs)
    answers, opened_at = [], None
    for n in range(LB_DEAD_MAX_REQUESTS):
        # A fresh prompt each time: a repeated one would stay affine to
        # the live replica, and the dead one would never be tried.
        short = prompt_tokens(rng, LB_SHORT[0],
                              engines[0].config.vocab_size)
        try:
            got = lb_stream(base, short, LB_SHORT[1], stream=False)
            answers.append(len(got['tokens']))
        except urllib.error.HTTPError as e:
            answers.append(e.code)
        if opened_at is None and lb_counters(obs)['CIRCUIT_OPEN'] > \
                c0['CIRCUIT_OPEN']:
            opened_at = n + 1
        if opened_at is not None and n + 1 > opened_at:
            break  # one request past the opening, routed around
    d = lb_delta(c0, lb_counters(obs))
    state = lb.breaker.state(dead).name.lower()
    gate('dead_completes', answers == [LB_SHORT[1]] * len(answers),
         f'answers {answers}')
    gate('breaker_opens', d.get('CIRCUIT_OPEN') == 1 and state == 'open'
         and d.get('LB_PROXY_ERRORS') == 3
         and d.get('LB_UPSTREAM_RETRIES') == 3,
         f'deltas {d}, breaker {state}')
    gate('no_replica_zero', 'LB_NO_REPLICA' not in d, f'deltas {d}')
    out['dead_replica'] = {'requests': len(answers),
                           'opened_after_requests': opened_at,
                           'breaker': state, 'counters': d}
    lb.set_replicas(urls, pools)
    lap('dead_replica')


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
    from a dense forward (`llama.forward`, or an MoE module's) over the
    prompt and the plain tokens before it."""
    j = first_divergence(plain, spec)
    if j is None:
        return {'equal': True}
    out = {'equal': False, 'index': j, 'plain_token': None,
           'spec_token': None, 'top2': None, 'gap': None, 'deficits': None}
    if j < min(len(plain), len(spec)):
        with torch.inference_mode():
            logits = llama.forward(params, torch.tensor(
                [list(prompt) + list(plain[:j])], device=DEV), config)
        if isinstance(logits, tuple):      # an MoE forward: (logits, aux)
            logits = logits[0]
        logits = logits[0, -1].float()
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
    engines' runs only. Returns the readings, with
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
    runs = {}
    try:
        for name, draft in drafts:
            engine = inference.InferenceEngine(
                params, config, draft=draft, spec_k=SPEC_K,
                spec_fuse_rounds=SPEC_ROUNDS, **kw)
            runs[name] = run_greedy(torch, inference, engine, prompts,
                                    SPEC_NEW)
            del engine
            torch.cuda.empty_cache()
    finally:
        fa._launch = launch
    out['kernel_launches'] = counter.launches
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


def spec_server_start():
    """Start the port's server as a process with --draft-model
    SPEC_DRAFT (weights from --seed 0); spec_server waits for it and
    stops it. Started first in the spec phase, it loads while the spec
    engines run here."""
    import tempfile
    port = free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.inference.server',
           '--model', SPEC_MODEL, '--draft-model', SPEC_DRAFT, '--spec-k',
           str(SPEC_K), '--spec-fuse-rounds', str(SPEC_ROUNDS), '--device',
           DEV, '--port', str(port), '--seed', '0',
           '--batch-size', str(SPEC_KW['batch_size']),
           '--max-seq-len', str(SPEC_KW['max_seq_len']),
           '--prefill-chunk', str(SPEC_KW['prefill_chunk']),
           '--kv-page-size', str(SPEC_KW['kv_page_size'])]
    log = tempfile.TemporaryFile()
    proc = subprocess.Popen(cmd, cwd=here, stdout=log,
                            stderr=subprocess.STDOUT)
    return {'proc': proc, 'log': log, 'port': port, 'cmd': cmd,
            't0': time.perf_counter()}


def spec_server_stop(started):
    """Stop spec_server_start's process (idempotent)."""
    proc = started['proc']
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    started['log'].close()


def spec_server(torch, inference, params, config, prompt, started):
    """The server process of spec_server_start (weights from --seed 0,
    as the params in hand): one greedy /generate against the draft-free
    server in this process on the same params, under the divergence
    rule; /health must count spec rounds. Stops the process."""
    from skypilot_tpu_torch.inference import server as server_lib
    proc, log, port, cmd = (started[k] for k in ('proc', 'log', 'port',
                                                 'cmd'))
    body = {'prompt_tokens': prompt, 'max_new_tokens': SPEC_NEW}
    plain_engine = inference.InferenceEngine(params, config,
                                             prefix_cache=False, device=DEV,
                                             **SPEC_KW)
    holder = {'loop': server_lib.EngineLoop(plain_engine)}
    srv = server_lib.create_server(holder, host='127.0.0.1', port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        plain = json.loads(http_json(
            f'http://127.0.0.1:{srv.server_address[1]}/generate',
            body)[1])['tokens']
        base = f'http://127.0.0.1:{port}'
        t0 = started['t0']
        wait_t0 = time.perf_counter()
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
            if time.perf_counter() - wait_t0 > 300:
                raise AssertionError('spec server never loaded')
            time.sleep(0.1)
        load_s = time.perf_counter() - t0
        wait_s = time.perf_counter() - wait_t0
        t0 = time.perf_counter()
        spec = json.loads(http_json(base + '/generate', body)[1])['tokens']
        request_s = time.perf_counter() - t0
        health = json.loads(http_json(base + '/health')[1])['engine']
    finally:
        spec_server_stop(started)
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
            'load_wait_s': wait_s,
            'request_s': request_s, 'prompt_tokens': len(prompt),
            'tokens': len(spec), 'tokens_equal': reading['equal'],
            'divergence': None if reading['equal'] else reading,
            'health_spec': health['spec'], 'faults': faults}


def spec_phase(torch, inference, fa, params, config, rng):
    """Speculative decode on the target in hand: the draft's weights
    drawn as build_engine draws them (seed 1), 8 prompts of 100-1500
    tokens through spec_engines with bf16 KV (and the target as its own
    draft), then int8 KV, then the server (started first, so it loads
    while the engines run). `faults` gathers every part's."""
    started = spec_server_start()
    try:
        return spec_legs(torch, inference, fa, params, config, rng, started)
    finally:
        spec_server_stop(started)


def spec_legs(torch, inference, fa, params, config, rng, started):
    """spec_phase's engines and its server leg on `started`."""
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
                                              vocab), started)
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


def hf_shard_bytes(params):
    """The shard size that puts the embedding alone in the first of two
    shards and every other tensor in the second."""
    def nbytes(t):
        return t.numel() * t.element_size()

    rest = nbytes(params['final_norm']) + sum(
        nbytes(t) for t in params['layers'].values())
    return max(nbytes(params['embed']), rest)


def write_hf_checkpoint(params, config, out_dir):
    """`params` as an HF checkpoint in HF's tensor order (embeddings,
    layers, final norm) through the port's ShardedWriter, the embedding
    alone in the first of two shards, then config.json. Returns the
    files written."""
    from skypilot_tpu_torch.checkpoints import hf_import
    from skypilot_tpu_torch.checkpoints import safetensors_io
    specs = {spec.key: spec for spec in hf_import.param_specs(config)}
    embed = params['embed']
    writer = safetensors_io.ShardedWriter(
        out_dir, max_shard_bytes=hf_shard_bytes(params),
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


def checkpoint_phase(torch, inference, rng, keep=None):
    """A synthetic HF gemma2 checkpoint (gemma2-2b widths, CKPT_LAYERS
    layers, random bf16 weights from seed 2) written by the port's writer
    over two shards (into `keep`, which outlives the phase for the batch
    and roundtrip phases, else a temporary directory), imported by load_params (every tensor equal to the one written;
    import seconds and peak host bytes), served by
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
    tmp = keep or tempfile.mkdtemp(prefix='chip_smoke_ckpt_')
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
        # The server as a process on the written checkpoint: started now,
        # it loads while the import and the in-process engine run here.
        with socket.socket() as sock:
            sock.bind(('127.0.0.1', 0))
            port = sock.getsockname()[1]
        cmd = [sys.executable, '-m', 'skypilot_tpu_torch.inference.server',
               '--model', CKPT_MODEL, '--checkpoint', tmp, '--device', DEV,
               '--port', str(port)]
        for key, value in CKPT_KW.items():
            cmd += ['--' + key.replace('_', '-'), str(value)]
        log = tempfile.TemporaryFile()
        t_start = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=os.path.dirname(
            os.path.abspath(__file__)), stdout=log, stderr=subprocess.STDOUT)
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
        base = f'http://127.0.0.1:{port}'
        t0 = time.perf_counter()
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
        out['server_load_s'] = time.perf_counter() - t_start
        out['server_load_wait_s'] = time.perf_counter() - t0
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
        if keep is None:
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


# -- the OpenAI API, load shedding, batch inference and the fine-tune
# round trip (the eighth slice) ---------------------------------------------

# The openai and shedding phases: phase 5's llama3-8b params behind the
# port's server in this process, 8 slots, no prefix cache (a repeated
# prompt prefills again, so /v1 and /generate run the same rows), no
# interleave (each admission is one batched prefill) and 2 decode steps
# a host step (a request waits for the host step in flight to be
# admitted: ~100 ms, not ~400).
OPENAI_KW = dict(batch_size=8, max_seq_len=2048, prefill_chunk=512,
                 kv_page_size=64, prefill_interleave=0, prefix_cache=False,
                 decode_fuse_steps=2)
OPENAI_NAME = 'llama3-8b-chip-smoke'
OPENAI_PROMPT = 300
OPENAI_TEXT_WORDS = 40
OPENAI_NEW = 16
# Shedding: SHED_REQUESTS long streams fill the 8 slots and queue the
# rest; with the limit at the queue depth that leaves, the next request
# of each route is shed. A slot's stream outlasts the fill (10-20
# tokens a second a slot at 8 slots); the queued ones are short.
SHED_LIMIT = 2
SHED_REQUESTS = 10
SHED_PROMPT = 64
SHED_NEW = 128
SHED_QUEUED_NEW = 16
# The batch phase: JSONL prompts (more than the 8 slots, so slots
# recycle) through `python -m skypilot_tpu_torch.inference.batch`.
BATCH_REQUESTS = 16
BATCH_PROMPT_LENGTHS = (100, 1500)
BATCH_NEW = 32
BATCH_MODEL = 'llama3-8b'
BATCH_FLAGS = ('--max-seq-len', '2048')
# The round trip: gemma2-2b at full width, CKPT_LAYERS layers (one local,
# one global), fine-tuned from phase 18's HF checkpoint at 1 x RT_SEQ.
# The warmup outlasts both legs, so a 4-step and a 6-step run share
# their schedule (decay_steps = max(max_steps, warmup + 1)).
RT_SEQ = 8192
RT_STEPS = 4
RT_RESUME_STEPS = 6
RT_EVERY = 2
RT_LR = 1e-3
RT_WARMUP = 8
RT_BATCH_REQUESTS = 8
RT_BATCH_NEW = 16
# The resumed run's losses at steps 5-6 against an uninterrupted run's.
# On the H100 a sound resume reads 0.0 (the restored state is bitwise the
# saved one, and the step's kernels are deterministic); the planted
# restore faults read 1.21 (optimizer state dropped: the count restarts
# at 0, so the warmup's first lr is 0) and 3.98 (a stale step restored).
TOL_RESUME_LOSS = 1e-3
TOY_WORDS = ('[UNK]', '</s>', 'hello', 'world', 'foo', 'bar', 'stop', 'go')


class ToyTokenizer:
    """A word-level tokenizer on the standard library (the card has no
    transformers and no tokenizer files): TOY_WORDS are ids 0-7 ([UNK],
    the eos '</s>', ...), every other id n is the word 'w<n>'. It has
    what the OpenAI routes call: encode, decode (skip_special_tokens
    drops [UNK] and </s>), convert_ids_to_tokens, apply_chat_template and
    eos_token_id."""
    eos_token_id = 1
    special = (0, 1)

    def __init__(self, vocab_size):
        self.vocab_size = vocab_size

    def word(self, i):
        return TOY_WORDS[i] if i < len(TOY_WORDS) else f'w{i}'

    def _id(self, word):
        if word in TOY_WORDS:
            return TOY_WORDS.index(word)
        if word[:1] == 'w' and word[1:].isdigit() and \
                len(TOY_WORDS) <= int(word[1:]) < self.vocab_size:
            return int(word[1:])
        return 0

    def encode(self, text):
        return [self._id(w) for w in text.split()]

    def decode(self, ids, skip_special_tokens=False):
        return ' '.join(self.word(i) for i in ids
                        if not (skip_special_tokens and i in self.special))

    def convert_ids_to_tokens(self, ids):
        return [self.word(i) for i in ids]

    def apply_chat_template(self, messages, add_generation_prompt=True,
                            tokenize=True):
        text = ' '.join(m['content'] for m in messages)
        return self.encode(text + (' go' if add_generation_prompt else ''))


@contextlib.contextmanager
def admissions(engine):
    """The prompt lengths of every admission the engine made in the
    block (one list a call of `_insert_from_queue` that admitted), read
    off its queue around the call: outside the engine's books."""
    record = []

    def wrap(fn):
        def wrapper():
            before = list(engine._queue)
            fn()
            left = {id(item) for item in engine._queue}
            lengths = [min(len(item[1]), engine.state.max_seq_len - 1)
                       for item in before if id(item) not in left]
            if lengths:
                record.append(lengths)
        return wrapper

    with patched(engine, '_insert_from_queue', wrap):
        yield record


@contextlib.contextmanager
def timed(obj, name, record):
    """The wall seconds of every call of `obj.name` in the block."""
    def wrap(fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                record.append(time.perf_counter() - t0)
        return wrapper

    with patched(obj, name, wrap):
        yield record


@contextlib.contextmanager
def depth_cut(model, layers):
    """`model` cut to `layers` layers at full width, registered for the
    block as its family's preset '<model>-<layers>l'; yields the name."""
    from skypilot_tpu_torch import models as models_lib
    family, preset = models_lib.resolve(model)
    name = f'{model}-{layers}l'
    family.CONFIGS[name] = dataclasses.replace(preset, num_layers=layers)
    try:
        yield name
    finally:
        del family.CONFIGS[name]


def openai_phase(torch, fa, params, config, rng):
    """The OpenAI routes (phase 7b') and load shedding (7c) on an
    in-process server over `params` (OPENAI_KW), and what they read.
    Raises on the first check missed."""
    from skypilot_tpu_torch import inference
    from skypilot_tpu_torch.inference import server as server_lib
    from skypilot_tpu_torch.observability import instruments as obs
    engine = inference.InferenceEngine(params, config, device=DEV,
                                       **OPENAI_KW)
    holder = {'loop': server_lib.EngineLoop(engine), 'tokenizer': None,
              'model_name': OPENAI_NAME, 'max_queue_depth': None}
    srv = server_lib.create_server(holder, host='127.0.0.1', port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f'http://127.0.0.1:{srv.server_address[1]}'
    try:
        with admissions(engine) as admitted:
            out = openai_checks(torch, fa, engine, holder, base, admitted,
                                rng, obs)
        shedding = shedding_checks(holder, base)
    finally:
        srv.shutdown()
        srv.server_close()
        holder['loop'].stop()
    return out, shedding


def openai_checks(torch, fa, engine, holder, base, admitted, rng, obs):
    v1 = {'launches': 0, 'expected': 0, 'requests': 0}
    tally = {'prompt': 0, 'generated': 0, 'requests': 0, 'posts': 0}

    def post(path, body, engine_requests=()):
        """One POST; K1's launches and the admissions' expected count
        for /v1 requests; the tally of (prompt, tokens) engine requests
        in the /metrics window."""
        fa.flash_attention.launches = 0
        admitted.clear()
        status, _, text = http_call(base + path, body)
        if status != 200:
            raise AssertionError(f'{path}: {status} {text[:300]}')
        if path.startswith('/v1/'):
            v1['launches'] += fa.flash_attention.launches
            v1['expected'] += sum(expected_prefill_launches(engine, lens)
                                  for lens in admitted)
            v1['requests'] += 1
        tally['posts'] += 1
        return text

    def stream_post(body):
        """The frames of a streamed /v1/completions, and whether the
        stream closed with [DONE]."""
        frames = list(sse_frames(post('/v1/completions',
                                      body).splitlines()))
        return [f for f in frames if f is not None], frames[-1:] == [None]

    def count(n_prompt, tokens):
        tally['prompt'] += n_prompt
        tally['generated'] += len(tokens)
        tally['requests'] += 1

    checks = {}
    vocab = engine.config.vocab_size
    status, _, text = http_call(base + '/v1/models')
    checks['models'] = json.loads(text)['data'][0]['id'] == OPENAI_NAME
    before = parse_metrics(http_call(base + '/metrics')[2])
    prompt = prompt_tokens(rng, OPENAI_PROMPT, vocab)
    gen = json.loads(post('/generate', {
        'prompt_tokens': prompt, 'max_new_tokens': OPENAI_NEW,
        'logprobs': True}))
    count(len(prompt), gen['tokens'])
    doc = json.loads(post('/v1/completions', {
        'prompt': prompt, 'max_tokens': OPENAI_NEW, 'temperature': 0,
        'logprobs': 0}))
    choice = doc['choices'][0]
    count(len(prompt), choice['tokens'])
    lps = choice['logprobs']['token_logprobs']
    checks['tokens_equal_generate'] = choice['tokens'] == gen['tokens']
    checks['logprob_max_abs_diff'] = max(
        abs(a - b) for a, b in zip(lps, gen['logprobs']))
    checks['logprobs_equal_generate'] = lps == gen['logprobs']
    checks['usage'] = doc['usage'] == {
        'prompt_tokens': len(prompt), 'completion_tokens': OPENAI_NEW,
        'total_tokens': len(prompt) + OPENAI_NEW}
    checks['finish_length'] = choice['finish_reason'] == 'length'
    checks['model_name'] = doc['model'] == OPENAI_NAME
    doc = json.loads(post('/v1/completions', {
        'prompt': prompt, 'max_tokens': OPENAI_NEW, 'temperature': 0,
        'n': 2}))
    pair = [c['tokens'] for c in doc['choices']]
    for tokens in pair:
        count(len(prompt), tokens)
    checks['n2_identical'] = (len(pair) == 2 and pair[0] == pair[1]
                              and [c['index'] for c in doc['choices']]
                              == [0, 1])
    checks['n2_usage'] = doc['usage']['prompt_tokens'] == len(prompt) and \
        doc['usage']['completion_tokens'] == 2 * OPENAI_NEW
    frames, done = stream_post({
        'prompt': prompt, 'max_tokens': OPENAI_NEW, 'temperature': 0,
        'stream': True})
    streamed = [t for f in frames for t in f['choices'][0].get('tokens', [])]
    count(len(prompt), streamed)
    checks['stream_equals_nonstream'] = (
        done and streamed == choice['tokens']
        and frames[-1]['choices'][0]['finish_reason'] == 'length')

    tok = ToyTokenizer(vocab)
    holder['tokenizer'] = tok
    words = ['hello', 'world', 'foo', 'bar'] + [
        tok.word(int(t)) for t in rng.integers(len(TOY_WORDS), vocab,
                                               OPENAI_TEXT_WORDS)]
    text_prompt = ' '.join(words)
    ids = tok.encode(text_prompt)
    want = json.loads(post('/generate', {
        'prompt_tokens': ids, 'max_new_tokens': OPENAI_NEW,
        'eos_token_id': tok.eos_token_id}))['tokens']
    count(len(ids), want)
    want_text = tok.decode(want, skip_special_tokens=True)
    doc = json.loads(post('/v1/completions', {
        'prompt': text_prompt, 'max_tokens': OPENAI_NEW,
        'temperature': 0}))
    count(len(ids), want)
    checks['text_equal_generate'] = doc['choices'][0]['text'] == want_text
    checks['text_usage'] = doc['usage'] == {
        'prompt_tokens': len(ids), 'completion_tokens': len(want),
        'total_tokens': len(ids) + len(want)}
    messages = [{'role': 'system', 'content': 'go foo'},
                {'role': 'user', 'content': text_prompt}]
    chat_ids = tok.apply_chat_template(messages)
    chat_want = json.loads(post('/generate', {
        'prompt_tokens': chat_ids, 'max_new_tokens': OPENAI_NEW,
        'eos_token_id': tok.eos_token_id}))['tokens']
    count(len(chat_ids), chat_want)
    doc = json.loads(post('/v1/chat/completions', {
        'messages': messages, 'max_tokens': OPENAI_NEW, 'temperature': 0}))
    count(len(chat_ids), chat_want)
    checks['chat_equal_generate'] = (
        doc['choices'][0]['message']['content']
        == tok.decode(chat_want, skip_special_tokens=True)
        and doc['object'] == 'chat.completion'
        and doc['usage']['completion_tokens'] == len(chat_want))
    # A stop string: the first generated word not seen before it, past
    # the first; the text is cut where the server's rule cuts it.
    gen_words = want_text.split()
    stop = next((w for j, w in enumerate(gen_words)
                 if j and w not in gen_words[:j]), None)
    if stop is None:
        raise AssertionError(f'no stop word in {want_text!r}')
    cut = want_text[:want_text.find(stop)]
    doc = json.loads(post('/v1/completions', {
        'prompt': text_prompt, 'max_tokens': OPENAI_NEW, 'temperature': 0,
        'stop': stop}))
    count(len(ids), want)
    checks['stop_truncates'] = (doc['choices'][0]['text'] == cut
                                and doc['choices'][0]['finish_reason']
                                == 'stop')
    # The /metrics window ends here: the aborted stream below generated
    # tokens the client never saw.
    want_deltas = {
        'skytpu_prompt_tokens_total': tally['prompt'],
        'skytpu_generated_tokens_total': tally['generated'],
        'skytpu_requests_finished_total': tally['requests'],
        'skytpu_http_requests_total{plane="inference",method="POST",'
        'code="200"}': tally['posts']}

    def deltas():
        after = parse_metrics(http_call(base + '/metrics')[2])
        return {k: after.get(k, 0) - before.get(k, 0) for k in want_deltas}
    post_key = list(want_deltas)[-1]
    got_deltas = poll(deltas, lambda d: d[post_key] >= tally['posts'])
    # Streamed, the stop ends the stream and aborts the request, which
    # could decode 3 x OPENAI_NEW tokens past the stop's.
    aborted = obs.REQUESTS_ABORTED.value()
    frames, done = stream_post({
        'prompt': text_prompt, 'max_tokens': 4 * OPENAI_NEW,
        'temperature': 0, 'stream': True, 'stop': stop})
    streamed = ''.join(f['choices'][0]['text'] for f in frames)
    aborted = poll(lambda: obs.REQUESTS_ABORTED.value() - aborted,
                   lambda n: n >= 1)
    checks['stream_stop'] = (done and streamed == cut
                             and frames[-1]['choices'][0]['finish_reason']
                             == 'stop' and aborted == 1)
    holder['tokenizer'] = None
    out = {'model': 'llama3-8b', **OPENAI_KW, 'served_name': OPENAI_NAME,
           'prompt_tokens': OPENAI_PROMPT, 'max_tokens': OPENAI_NEW,
           'stop': stop, 'checks': checks,
           # A 2-row prefill may sum in another order than a 1-row one.
           'n2_equal_generate': pair[0] == gen['tokens'],
           'metrics_deltas': got_deltas,
           'metrics_want': want_deltas, 'v1_requests': v1['requests'],
           'kernel_launches': v1['launches'],
           'expected_launches': v1['expected']}
    failed = [k for k, v in checks.items()
              if v is False or (k == 'logprob_max_abs_diff' and v != 0.0)]
    if v1['launches'] != v1['expected'] or v1['launches'] <= 0:
        failed.append(f'K1 launched {v1["launches"]} times around the /v1 '
                      f'requests, expected {v1["expected"]}')
    bad = counter_faults(got_deltas, want_deltas)
    if failed or bad:
        raise AssertionError(f'openai: {failed} {bad} {out}')
    return out


def shedding_checks(holder, base):
    """SHED_REQUESTS long streams fill the slots and queue SHED_LIMIT;
    the next /generate and /v1/completions are shed (503, Retry-After:
    1, REQUESTS_SHED + 2); once the queue drains a request passes and
    the streams all finish."""
    shed_key = 'skytpu_requests_shed_total'
    depth_key = 'skytpu_queue_depth'
    slots_key = 'skytpu_batch_slots_active'

    def metric(key):
        return parse_metrics(http_call(base + '/metrics')[2]).get(key, 0)

    holder['max_queue_depth'] = SHED_LIMIT
    shed0 = metric(shed_key)
    results = {}
    slots = len(holder['loop'].engine.state.slots)
    new = [SHED_NEW if i < slots else SHED_QUEUED_NEW
           for i in range(SHED_REQUESTS)]

    def stream(i, started):
        req = urllib.request.Request(base + '/generate', data=json.dumps({
            'prompt_tokens': list(range(10 + i, 10 + i + SHED_PROMPT)),
            'max_new_tokens': new[i], 'stream': True}).encode(),
            headers={'Content-Type': 'application/json'})
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                started.set()
                frames = list(sse_frames(resp))
                results[i] = (resp.status, frames[-1])
        except urllib.error.HTTPError as e:
            results[i] = (e.code, None)
            started.set()

    threads = []
    try:
        t0 = time.perf_counter()
        # One at a time, each admitted (or queued) before the next
        # arrives: no request below the limit can read a passing depth.
        for i in range(SHED_REQUESTS):
            started = threading.Event()
            t = threading.Thread(target=stream, args=(i, started),
                                 daemon=True)
            t.start()
            threads.append(t)
            if not started.wait(120):
                raise AssertionError(f'stream {i} never started')
            key, want = ((slots_key, i + 1) if i < slots
                         else (depth_key, i + 1 - slots))
            got = poll(lambda: metric(key), lambda v: v == want, timeout=60)
            if got != want:
                raise AssertionError(f'stream {i}: {key} {got}, want {want}')
        depth = metric(depth_key)
        if depth != SHED_LIMIT:
            raise AssertionError(f'queue depth {depth}, want {SHED_LIMIT}')
        fill_s = time.perf_counter() - t0
        msg = {'error': f'overloaded: queue depth >= {SHED_LIMIT}'}
        shed = {}
        for path, body in (('/generate', {'prompt_tokens': [1, 2, 3],
                                          'max_new_tokens': 4}),
                           ('/v1/completions', {'prompt': [1, 2, 3],
                                                'max_tokens': 4})):
            try:
                status, headers, text = http_call(base + path, body)
            except urllib.error.HTTPError as e:
                status, headers, text = e.code, dict(e.headers), e.read()
            doc = json.loads(text)
            shed[path] = {'status': status,
                          'retry_after': headers.get('Retry-After'),
                          'body': doc}
            if (status, headers.get('Retry-After'), doc) != (503, '1', msg):
                raise AssertionError(f'{path} not shed: {shed[path]}')
        shed_delta = metric(shed_key) - shed0
        drained = poll(lambda: metric(depth_key), lambda d: d == 0,
                       timeout=120)
        if drained != 0:
            raise AssertionError(f'queue never drained: depth {drained}')
        status, _, text = http_call(base + '/generate', {
            'prompt_tokens': [1, 2, 3], 'max_new_tokens': 4})
        after = json.loads(text)['tokens']
        for t in threads:
            t.join(300)
        wall = time.perf_counter() - t0
    finally:
        holder['max_queue_depth'] = None
    final_delta = metric(shed_key) - shed0
    streams_ok = (sorted(results) == list(range(SHED_REQUESTS)) and all(
        s == 200 and last.get('done') and len(last['tokens']) == new[i]
        for i, (s, last) in results.items()))
    out = {'limit': SHED_LIMIT, 'streams': SHED_REQUESTS,
           'stream_prompt': SHED_PROMPT, 'stream_new': new,
           'queue_depth_seen': depth, 'shed': shed,
           'shed_delta': shed_delta, 'shed_delta_final': final_delta,
           'after_drain_status': status, 'after_drain_tokens': len(after),
           'streams_ok': streams_ok, 'fill_s': fill_s, 'wall_s': wall}
    if shed_delta != 2 or final_delta != 2 or status != 200 or \
            not streams_ok or any(t.is_alive() for t in threads):
        raise AssertionError(f'shedding: {out}')
    return out


def batch_request_file(rng, path, n, lengths, vocab):
    reqs = [{'prompt_tokens': prompt_tokens(rng, int(m), vocab)}
            for m in rng.integers(lengths[0], lengths[1] + 1, size=n)]
    with open(path, 'w') as f:
        for req in reqs:
            f.write(json.dumps(req) + '\n')
    return reqs


def batch_process(inp, argv, command=('-m',
                                      'skypilot_tpu_torch.inference.batch')):
    """Start `python -m skypilot_tpu_torch.inference.batch` (or
    `command`) on `argv` as a process writing `inp`.out; returns wait():
    (its full argv, its stderr's last `[batch]` line, its output, its
    seconds), raising if it failed."""
    outp = inp + '.out'
    argv = ['--input', inp, '--output', outp, '--device', DEV, *argv]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, *command, *argv],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ended = {}

    def collect():
        # Its seconds end when it does, not when the caller asks.
        try:
            ended['err'] = proc.communicate(timeout=600)[1]
        finally:
            ended['s'] = time.perf_counter() - t0
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    collector = threading.Thread(target=collect, daemon=True)
    collector.start()

    def wait():
        collector.join()
        err, process_s = ended.get('err', ''), ended['s']
        if proc.returncode != 0:
            raise AssertionError(f'batch {argv}: rc {proc.returncode}\n'
                                 f'{err[-3000:]}')
        line = [ln for ln in err.splitlines()
                if ln.startswith('[batch]')][-1]
        with open(outp) as f:
            return argv, line, f.read(), process_s

    return wait


def batch_run(torch, inference, fa, reqs, inp, argv,
              command=('-m', 'skypilot_tpu_torch.inference.batch'),
              started=None, then=None):
    """`python -m skypilot_tpu_torch.inference.batch` (or `command`) on
    `argv` as a process (`started`: batch_process's wait() of one already
    running), then `run_batch` in this process on an engine built from
    the same flags, with K1's (K2's) launches and the admissions'
    expected count around it; the two outputs must be equal, byte for
    byte. `then` (a function) runs once the process has ended and
    before the in-process run: the next leg's process starts there, so
    its start-up overlaps this run."""
    from skypilot_tpu_torch.inference import batch as batch_lib
    wait = started or batch_process(inp, argv, command)
    argv, line, written, process_s = wait()
    if then is not None:
        then()
    args = batch_lib.build_parser().parse_args(argv)
    engine = inference.build_engine(args.model, **batch_lib.engine_kwargs(args))
    counter = (fa.flash_attention_quant if engine.kv_quant == 'int8'
               else fa.flash_attention)
    counter.launches = 0
    with admissions(engine) as admitted:
        records = batch_lib.run_batch(engine, reqs, inference.SamplingParams(
            temperature=args.temperature, top_k=args.top_k,
            max_new_tokens=args.max_new_tokens))
    launches = counter.launches
    expected = sum(expected_prefill_launches(engine, lens)
                   for lens in admitted)
    in_process = ''.join(json.dumps(r) + '\n' for r in records)
    out = {'argv': ' '.join(argv[6:]), 'kv_quant': engine.kv_quant,
           'layers': engine.config.num_layers,
           'requests': len(reqs), 'process_s': process_s,
           'process_line': line,
           'process_tok_s': float(line.rsplit('(', 1)[1].split()[0]),
           'tokens': sum(r['num_tokens'] for r in records),
           'admissions': [len(a) for a in admitted],
           'kernel': 'K2' if engine.kv_quant == 'int8' else 'K1',
           'kernel_launches': launches, 'expected_launches': expected,
           'outputs_equal': written == in_process,
           'output_bytes': len(written)}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    if not out['outputs_equal'] or launches != expected or launches <= 0:
        raise AssertionError(f'batch: {out}')
    return out


def batch_phase(torch, inference, fa, rng, hf_dir, tmp):
    """Batch inference as a process (BATCH_REQUESTS prompts of
    BATCH_PROMPT_LENGTHS tokens, BATCH_NEW new each, greedy, 8 slots):
    llama3-8b on bf16 then int8 KV, then phase 18's HF checkpoint; each
    output equal, byte for byte, to run_batch in this process."""
    import shutil

    from skypilot_tpu_torch import models as models_lib
    vocab = models_lib.resolve(BATCH_MODEL)[1].vocab_size
    inp = os.path.join(tmp, 'batch.jsonl')
    reqs = batch_request_file(rng, inp, BATCH_REQUESTS, BATCH_PROMPT_LENGTHS,
                              vocab)
    common = ['--max-new-tokens', str(BATCH_NEW), *BATCH_FLAGS]
    out = {'requests': BATCH_REQUESTS, 'lengths': BATCH_PROMPT_LENGTHS,
           'max_new_tokens': BATCH_NEW}
    legs = [('bf16', ['--model', BATCH_MODEL, '--kv-quant', 'none']),
            ('int8', ['--model', BATCH_MODEL, '--kv-quant', 'int8']),
            ('checkpoint', ['--model', CKPT_MODEL, '--checkpoint', hf_dir])]
    # Each leg's process writes its own file; the next leg's process
    # starts (imports, CUDA, weights) while this leg's in-process run
    # goes, and only once this leg's process has ended.
    paths = {name: f'{inp}.{name}' for name, _ in legs}
    for path in paths.values():
        shutil.copyfile(inp, path)
    running = {}

    def start(i):
        if i < len(legs):
            name, flags = legs[i]
            running[name] = batch_process(paths[name], common + flags)

    start(0)
    for i, (name, flags) in enumerate(legs):
        out[name] = batch_run(torch, inference, fa, reqs, paths[name],
                              common + flags, started=running.pop(name),
                              then=functools.partial(start, i + 1))
    return out


def _tree_equal(torch, a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(torch, a[k], b[k])
                                            for k in a)
    return a.dtype == b.dtype and torch.equal(a.detach(), b.detach())


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, fn))
               for root, _dirs, files in os.walk(path) for fn in files)


def roundtrip_phase(torch, inference, fa, rng, hf_dir, tmp):
    """`roundtrip_legs` on CKPT_MODEL cut to CKPT_LAYERS layers."""
    with depth_cut(CKPT_MODEL, CKPT_LAYERS) as model:
        return roundtrip_legs(torch, inference, fa, rng, hf_dir, tmp, model)


def roundtrip_legs(torch, inference, fa, rng, hf_dir, tmp, model):
    """The fine-tune round trip at gemma2-2b width, CKPT_LAYERS layers:
    fine-tune phase 18's HF checkpoint (fit, RT_STEPS steps at 1 x
    RT_SEQ, a train checkpoint every RT_EVERY), resume to
    RT_RESUME_STEPS against an uninterrupted run, a torn step skipped,
    the resumed params exported to HF and loaded back bit for bit, served
    by build_engine(checkpoint=) against the in-memory params and by
    batch --checkpoint on the train checkpoint, phase 18's imported
    params re-exported byte for byte, and the checkpoints CLI's inspect
    and verify as processes on clean and damaged copies."""
    import shutil

    from skypilot_tpu_torch import checkpoints as ckpt_lib
    from skypilot_tpu_torch.observability import instruments as obs
    from skypilot_tpu_torch.train import checkpoints as train_ckpts
    from skypilot_tpu_torch.train import loop, trainer
    run_dir = os.path.join(tmp, 'train')
    counters = (fa.flash_attention, fa.flash_attention_quant,
                fa.flash_attention_dq, fa.flash_attention_dkv)

    def cfg(steps):
        return trainer.TrainerConfig(
            model=model, batch_size=1, seq_len=RT_SEQ, max_steps=steps,
            learning_rate=RT_LR, warmup_steps=RT_WARMUP)

    def fit(steps, **kw):
        for c in counters:
            c.launches = 0
        logs = []
        res = loop.fit(cfg(steps), DEV, init_checkpoint=hf_dir, log_every=1,
                       log_fn=logs.append, **kw)
        torch.cuda.synchronize()
        return res, logs, {k: c.launches for k, c in zip(
            ('K1', 'K2', 'K3', 'K4'), counters)}

    out = {'model': CKPT_MODEL, 'layers': CKPT_LAYERS, 'seq_len': RT_SEQ,
           'steps': RT_STEPS, 'resume_to': RT_RESUME_STEPS,
           'checkpoint_every': RT_EVERY, 'learning_rate': RT_LR,
           'warmup_steps': RT_WARMUP}
    saves, restores = [], []
    t0 = time.perf_counter()
    with timed(train_ckpts, 'save_train_state', saves):
        first, _logs, launches = fit(RT_STEPS, checkpoint_dir=run_dir,
                                     checkpoint_every=RT_EVERY)
    out['fine_tune_s'] = time.perf_counter() - t0
    out['fine_tune_launches'] = launches
    want = {'K1': 2 * CKPT_LAYERS * RT_STEPS, 'K2': 0,
            'K3': CKPT_LAYERS * RT_STEPS, 'K4': CKPT_LAYERS * RT_STEPS}
    if launches != want:
        raise AssertionError(f'fine-tune launches {launches}, want {want}')
    steps_saved = sorted(int(s) for s in os.listdir(run_dir))
    if steps_saved != list(range(RT_EVERY, RT_STEPS + 1, RT_EVERY)):
        raise AssertionError(f'saved steps {steps_saved}')
    step_bytes = _dir_bytes(os.path.join(run_dir, str(RT_STEPS)))
    # What the resume limit catches: the resume run with a fault planted
    # in the restore, saving nothing (run_dir keeps steps 2 and 4).
    restore = train_ckpts.restore_train_state

    def moments_dropped(ckpt_dir, state, step=None, shardings=None):
        restore(ckpt_dir, state, step, shardings)
        for t in trainer.tree_leaves(state['opt_state']['mu']) + \
                trainer.tree_leaves(state['opt_state']['nu']):
            t.zero_()
        state['opt_state']['count'] = 0
        return state

    def stale_step(ckpt_dir, state, step=None, shardings=None):
        return restore(ckpt_dir, state, RT_EVERY, shardings)

    planted = {}
    for name, fault in (('moments_dropped', moments_dropped),
                        ('stale_step', stale_step)):
        with patched(train_ckpts, 'restore_train_state',
                     lambda _fn: fault), \
                patched(loop, '_save_with_retries',
                        lambda _fn: lambda *a, **k: None):
            res, _logs, _launches = fit(RT_RESUME_STEPS,
                                        checkpoint_dir=run_dir,
                                        checkpoint_every=RT_EVERY)
        planted[name] = [h['loss'] for h in res['history']]
        del res
    with timed(train_ckpts, 'save_train_state', saves), \
            timed(train_ckpts, 'restore_train_state', restores):
        resumed, logs, launches = fit(RT_RESUME_STEPS,
                                      checkpoint_dir=run_dir,
                                      checkpoint_every=RT_EVERY)
    out['resume_launches'] = launches
    resumed_steps = RT_RESUME_STEPS - RT_STEPS
    want = {'K1': 2 * CKPT_LAYERS * resumed_steps, 'K2': 0,
            'K3': CKPT_LAYERS * resumed_steps,
            'K4': CKPT_LAYERS * resumed_steps}
    if logs[0] != f'[fit] resumed from step {RT_STEPS}' or launches != want:
        raise AssertionError(f'resume: {logs[:1]}, launches {launches}, '
                             f'want {want}')
    # `batch --checkpoint` on the train checkpoint as a process (below):
    # started now, it loads while the rest of the round trip runs here.
    # The process registers the same depth-cut preset before batch's
    # main: a train checkpoint is read with --model's geometry.
    config = cfg(RT_RESUME_STEPS).model_config()
    prompt = prompt_tokens(rng, CKPT_PROMPT, config.vocab_size)
    inp = os.path.join(tmp, 'roundtrip.jsonl')
    reqs = batch_request_file(rng, inp, RT_BATCH_REQUESTS,
                              BATCH_PROMPT_LENGTHS, config.vocab_size)
    batch_argv = ['--model', model, '--checkpoint', run_dir,
                  '--max-new-tokens', str(RT_BATCH_NEW), *BATCH_FLAGS]
    batch_command = (
        '-c', 'import chip_smoke\n'
        'from skypilot_tpu_torch.inference import batch\n'
        f'with chip_smoke.depth_cut({CKPT_MODEL!r}, {CKPT_LAYERS}):\n'
        '    batch.main()\n')
    batch_started = batch_process(inp, batch_argv, batch_command)
    whole, _logs, _launches = fit(RT_RESUME_STEPS)
    losses = {'fine_tune': [h['loss'] for h in first['history']],
              'resumed': [h['loss'] for h in resumed['history']],
              'uninterrupted': [h['loss'] for h in whole['history']]}
    diffs = [abs(a - b) for a, b in zip(
        losses['resumed'], losses['uninterrupted'][RT_STEPS:])]
    param_diff = max(
        float((a.detach().float() - b.detach().float()).abs().max())
        for a, b in zip(trainer.tree_leaves(resumed['state']['params']),
                        trainer.tree_leaves(whole['state']['params'])))
    caught = {name: max(abs(a - b) for a, b in zip(
        got, losses['uninterrupted'][RT_STEPS:]))
        for name, got in planted.items()}
    out.update({'losses': losses, 'resume_loss_abs_diff': diffs,
                'resume_param_max_abs_diff': param_diff,
                'tol_resume_loss': TOL_RESUME_LOSS,
                'planted_resume_losses': planted,
                'planted_loss_abs_diff': caught,
                'first_leg_equal': losses['fine_tune'] ==
                losses['uninterrupted'][:RT_STEPS]})
    # The restored state is the saved one, bit for bit, so the resumed
    # params must equal the uninterrupted run's exactly.
    if not all(math.isfinite(x) for v in losses.values() for x in v) or \
            len(diffs) != resumed_steps or not max(diffs) < TOL_RESUME_LOSS \
            or param_diff != 0.0:
        raise AssertionError(f'resumed losses or params: {out}')
    if not all(d >= TOL_RESUME_LOSS for d in caught.values()):
        raise AssertionError(f'a planted resume fault passes the limit: '
                             f'{caught}')
    del whole
    out['save_s'] = saves
    out['save_bytes'] = step_bytes
    out['save_gb_s'] = step_bytes / 1e9 / (sum(saves) / len(saves))
    out['restore_s'] = restores
    out['restore_gb_s'] = step_bytes / 1e9 / restores[0]
    gc.collect()
    torch.cuda.empty_cache()

    # The resumed params exported to HF and loaded back, bit for bit.
    params = resumed['state']['params']
    del resumed
    export_dir = os.path.join(tmp, 'export')
    before = (obs.CKPT_EXPORT_BYTES.value(),
              obs.CKPT_EXPORT_SECONDS.child_snapshot()[1:])
    stats = ckpt_lib.export_params(params, config, export_dir,
                                   max_shard_bytes=hf_shard_bytes(params))
    seconds_sum, seconds_count = obs.CKPT_EXPORT_SECONDS.child_snapshot()[1:]
    instruments = {
        'bytes': obs.CKPT_EXPORT_BYTES.value() - before[0],
        'seconds_count': seconds_count - before[1][1],
        'seconds_sum': seconds_sum - before[1][0]}
    out['export'] = {**dataclasses.asdict(stats),
                     'gb_s': stats.bytes_written / 1e9 / stats.seconds,
                     'instruments': instruments}
    bad = counter_faults(instruments, {'bytes': stats.bytes_written,
                                       'seconds_count': 1})
    if bad or not math.isclose(instruments['seconds_sum'], stats.seconds,
                               rel_tol=1e-9, abs_tol=1e-9):
        raise AssertionError(f'CKPT_EXPORT_* against ExportStats: {bad}, '
                             f'{instruments} vs {stats}')
    loaded, _detected, _stats = ckpt_lib.load_params(export_dir, device=DEV)
    out['export_loads_equal'] = _tree_equal(torch, loaded, params)
    del loaded
    if not out['export_loads_equal']:
        raise AssertionError('the exported params load back unequal')
    # The CLI's processes start now (they never touch the card) and are
    # read at the end.
    cli_started = cli_start(export_dir, tmp)

    # Served: the export through build_engine(checkpoint=) against an
    # engine on the in-memory params; the train checkpoint through
    # batch --checkpoint against build_engine(checkpoint=) in process.
    served = inference.build_engine(CKPT_MODEL, device=DEV,
                                    checkpoint=export_dir, **CKPT_KW)
    tokens, lps = greedy_tokens(inference, served, prompt, CKPT_NEW)
    del served
    direct = inference.InferenceEngine(
        trainer.tree_map(lambda t: t.detach(), params), config, device=DEV,
        **CKPT_KW)
    want_tokens, want_lps = greedy_tokens(inference, direct, prompt,
                                          CKPT_NEW)
    del direct, params
    gc.collect()
    torch.cuda.empty_cache()
    out['serve'] = {'tokens_equal': tokens == want_tokens,
                    'logprob_max_abs_diff': max(
                        abs(a - b) for a, b in zip(lps, want_lps)),
                    'tokens': len(tokens)}
    if tokens != want_tokens or \
            not out['serve']['logprob_max_abs_diff'] < TOL_CKPT_LOGPROB:
        raise AssertionError(f'serving the export: {out["serve"]}')
    out['batch'] = batch_run(torch, inference, fa, reqs, inp, batch_argv,
                             command=batch_command, started=batch_started)

    # A torn step (sentinel gone) is never the resume candidate.
    os.remove(os.path.join(run_dir, str(RT_RESUME_STEPS),
                           train_ckpts.COMPLETE_SENTINEL))
    torn_latest = train_ckpts.latest_step(run_dir)
    state = trainer.make_train_state(cfg(RT_RESUME_STEPS), DEV)
    train_ckpts.restore_train_state(run_dir, state)
    out['torn'] = {'latest_step': torn_latest, 'restored_step': state['step']}
    del state
    if torn_latest != RT_STEPS or out['torn']['restored_step'] != RT_STEPS:
        raise AssertionError(f'torn checkpoint: {out["torn"]}')

    # Phase 18's imported params export byte for byte as phase 18 wrote.
    imported, _config, _stats = ckpt_lib.load_params(hf_dir, device=DEV)
    again = os.path.join(tmp, 'reexport')
    ckpt_lib.export_params(imported, _config, again,
                           max_shard_bytes=hf_shard_bytes(imported))
    del imported
    shards = sorted(fn for fn in os.listdir(hf_dir)
                    if fn.endswith('.safetensors')
                    or fn == 'model.safetensors.index.json')
    same = [fn for fn in shards if filecmp.cmp(
        os.path.join(hf_dir, fn), os.path.join(again, fn), shallow=False)]
    out['reexport'] = {'files': shards, 'identical': same}
    if same != shards:
        raise AssertionError(f're-export differs: {out["reexport"]}')
    shutil.rmtree(again)

    # The CLI as processes: rc 0 on the clean export, non-zero on a copy
    # with a NaN planted and on one with a shard cut short.
    out['cli'] = cli_checks(cli_started)
    return out


def cli_start(export_dir, tmp):
    """Start `python -m skypilot_tpu_torch.checkpoints inspect` and
    `verify` on the export, and `verify` on two damaged copies (the last
    shard copied, the rest hard-linked), side by side; cli_checks reads
    them."""
    from skypilot_tpu_torch.checkpoints import safetensors_io
    here = os.path.dirname(os.path.abspath(__file__))

    def cli(*argv):
        """Start the CLI as a process; the four run side by side (none
        touches the card)."""
        return subprocess.Popen(
            [sys.executable, '-m', 'skypilot_tpu_torch.checkpoints', *argv],
            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    shard = sorted(fn for fn in os.listdir(export_dir)
                   if fn.endswith('.safetensors'))[-1]
    import numpy as np
    with safetensors_io.CheckpointReader(export_dir) as reader:
        name = [n for n, t in reader.tensors.items() if t.shard == shard][0]
        tensor = reader.tensor(name)
        offset = tensor._start
        # One NaN element of the tensor's dtype (BF16: the top half of an
        # f32 NaN).
        nan = np.array([np.nan], np.float32)
        nan = ((nan.view(np.uint32) >> 16).astype(np.uint16) if
               tensor.tag == 'BF16' else nan.astype(tensor.dtype)).tobytes()
    copies = {}
    for kind in ('nan', 'truncated'):
        d = os.path.join(tmp, f'cli_{kind}')
        os.makedirs(d)
        for fn in os.listdir(export_dir):
            src, dst = os.path.join(export_dir, fn), os.path.join(d, fn)
            if fn == shard:
                with open(src, 'rb') as f, open(dst, 'wb') as g:
                    g.write(f.read())
            else:
                os.link(src, dst)
        copies[kind] = d
    with open(os.path.join(copies['nan'], shard), 'r+b') as f:
        f.seek(offset)
        f.write(nan)
    path = os.path.join(copies['truncated'], shard)
    os.truncate(path, os.path.getsize(path) - 6)
    t0 = time.perf_counter()
    procs = {'inspect': cli('inspect', export_dir)}
    for kind, d in (('clean', export_dir), ('nan', copies['nan']),
                    ('truncated', copies['truncated'])):
        procs[f'verify_{kind}'] = cli('verify', d)
    return procs, t0


def cli_checks(started):
    """cli_start's processes, waited for and read: rc 0 on the clean
    export, non-zero on the damaged copies; `wall_s` from their start."""
    procs, t0 = started
    texts = {}
    for name, proc in procs.items():
        try:
            texts[name] = proc.communicate(timeout=300)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = {'wall_s': time.perf_counter() - t0}
    rc = procs['inspect'].returncode
    doc = json.loads(texts['inspect']) if rc == 0 else {}
    out.update({'inspect_rc': rc, 'inspect': {
        k: doc.get(k) for k in ('family', 'shards', 'tensors', 'total_bytes',
                                'params')}})
    for kind in ('clean', 'nan', 'truncated'):
        text = texts[f'verify_{kind}']
        out[f'verify_{kind}'] = {
            'rc': procs[f'verify_{kind}'].returncode,
            'first_line': text.splitlines()[0] if text else ''}
    if out['inspect_rc'] != 0 or doc.get('family') != 'gemma2' or \
            out['verify_clean']['rc'] != 0 or \
            out['verify_nan']['rc'] == 0 or \
            out['verify_truncated']['rc'] == 0:
        raise AssertionError(f'checkpoints CLI: {out}')
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
    FLOP a visible pair; each input read once where a row needs it (q,
    dO, lse and delta of the rows that see a key, the kv rows any query
    needs), each output written once (dQ [B,Sq,H,D], dK, dV)."""
    pairs, kv_rows, q_rows = visible_span(sq, skv, off if off else 0,
                                          window)
    q_bytes = b * q_rows * h * d * 2
    kv_bytes = b * kv_rows * kv * d * 2
    row_bytes = 2 * b * h * q_rows * 4
    out = {}
    for name, per_pair, nbytes in (
            ('dq', 6, 2 * q_bytes + b * sq * h * d * 2 + 2 * kv_bytes
             + row_bytes),
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
    # Without a mask every query sees every key: the causal count at an
    # offset past the block.
    bounds = bwd_bounds(b, sq, skv, h, kv, d, off if causal else skv, window)
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


@contextlib.contextmanager
def replayed_routes(torch, moe):
    """`moe._route` patched for a flash-against-dense comparison: while
    `record` is set, each call's expert choices are kept in order, per
    layer (keyed by its router tensor); after, each call takes its
    layer's next recorded choices (from the first again once `cursor`
    is cleared), with the gates renormalised from its own probabilities
    and its own aux loss, so two passes that route in
    the same order (the chunks of a prefill, a forward and its remat
    recompute) differ by their attention alone, and not by a bf16 step
    that moves a token across a near-tie of the router. Of the (token,
    slot) choices the later calls route (`routed`; a cached engine's
    real tokens only, `_moe_mlp`'s `valid`), `flips` counts those they
    would have made otherwise."""
    state = {'record': True, 'choices': collections.defaultdict(list),
             'cursor': collections.Counter(), 'flips': 0, 'routed': 0,
             'valid': None}

    def wrap_mlp(fn):
        def mlp(h, layer_params, config, mode='auto', valid=None,
                replicated=False):
            state['valid'] = valid
            try:
                return fn(h, layer_params, config, mode=mode, valid=valid,
                          replicated=replicated)
            finally:
                state['valid'] = None
        return mlp

    def wrap(fn):
        def route(h, router, config):
            key = router.data_ptr()
            own = fn(h, router, config)
            if state['record']:
                state['choices'][key].append(own.experts)
                return own
            forced = state['choices'][key][state['cursor'][key]]
            state['cursor'][key] += 1
            probs = torch.softmax(h.float() @ router.float(), dim=-1)
            k = forced.shape[1]
            rank = 2.0 * torch.arange(k, 0, -1, device=probs.device)
            bonus = torch.zeros_like(probs).scatter(
                1, forced, rank.expand(forced.shape).contiguous())
            r = moe._assign(probs.detach() + bonus, config)
            gates = torch.gather(probs, 1, forced)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
            counted = torch.ones_like(forced, dtype=torch.bool)
            if state['valid'] is not None:
                counted = counted & state['valid'].reshape(-1, 1)
            state['flips'] += int(((own.experts != forced) & counted).sum())
            state['routed'] += int(counted.sum())
            return r._replace(gates=gates, aux_loss=own.aux_loss)
        return route

    with patched(moe, '_route', wrap), patched(moe, '_moe_mlp', wrap_mlp):
        yield state


def train_parity(torch, model, layers, seq_len):
    """One loss_fn + backward at `model`'s widths, depth cut to `layers`,
    through flash and dense attention on the same params and tokens. An
    MoE model's dense pass takes the flash pass's expert choices
    (`replayed_routes`), and `routing_flips` counts those it would have
    changed."""
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
    moe = hasattr(family, '_route')
    with (replayed_routes(torch, family) if moe
          else contextlib.nullcontext()) as replay:
        for impl in ('flash', 'dense'):
            config = dataclasses.replace(base, attention_impl=impl)
            loss = family.loss_fn(params, batch, config)
            grads[impl] = torch.autograd.grad(loss, leaves)
            out[f'{impl}_loss'] = float(loss.detach())
            out[f'{impl}_grad_norm'] = _global_norm(torch, grads[impl])
            if moe:
                replay['record'] = False
    if moe:
        out['routing_flips'] = replay['flips']
        out['routed_choices'] = replay['routed']
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
                steps=TRAIN_STEPS, attention_impl=None):
    """A training main path: fit() on `model` at batch 1 x `seq_len` for
    `steps` steps (`attention_impl` overrides the preset's, as the
    loop's --attention), with the launch counts of K1, K2, K3 and K4 set
    to 0 just before and read just after. Each step launches K3 and K4
    once a layer and K1 twice (the forward and the remat recompute), K2
    never; the launches of each window (`window_launches`) are those of
    the layers `layer_windows` gives that window. An MoE model's router
    aux loss on the trained params is read after (`aux_loss`)."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.observability import instruments as obs
    from skypilot_tpu_torch.train import loop, trainer
    cfg = trainer.TrainerConfig(model=model, batch_size=1,
                                seq_len=seq_len, max_steps=steps,
                                learning_rate=TRAIN_LR,
                                warmup_steps=TRAIN_WARMUP,
                                attention_impl=attention_impl)
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
    aux = {}
    if hasattr(mcfg, 'num_experts'):
        with torch.no_grad():
            aux['aux_loss'] = float(cfg.model_family().forward(
                state['params'], batch['tokens'], mcfg)[1])
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
            'attention_impl': mcfg.attention_impl,
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
            'step_profile': profile, **aux}


# The MoE phases: mixtral-8x7b at its published widths (hidden 4096,
# intermediate 14336, 32/8 heads, d 128, 8 experts top-2, vocab 32000),
# depth cut to fit one card (16 of 32 layers serve: 46 GB of bf16
# weights; 2 layers train: params, grads and AdamW moments ~25 GB).
# Serving takes the llama3-8b engine phase's traffic (8 slots, 2048
# positions, chunk 512, page 64; 8 greedy prompts of 100-1500 tokens and
# one of 1900, 32 new) without interleave and without the prefix cache,
# so every admission's launches are known and two runs take one path.
MOE_MODEL = 'mixtral-8x7b'
MOE_SERVE_LAYERS = 16
MOE_KW = dict(batch_size=8, max_seq_len=2048, prefill_chunk=512,
              kv_page_size=64, prefix_cache=False)
MOE_PROMPT_LENGTHS = (100, 1500)
MOE_LONG = 1900
MOE_NEW = 32
MOE_DECODE_STEPS = 4
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_SEQ = 4096
MOE_TRAIN_STEPS = 10
# `_moe_mlp` (the expert rows gathered per expert) against
# `_moe_mlp_dense` (the reference's one-hot form) on one 4096-token
# chunk of layer 0 at serving capacity, max|a-b| / max|b| of the bf16
# outputs. Sound readings on the H100 (700 W): 0.0, grouped and static
# (the per-expert and the batched GEMMs round each row alike). The
# planted faults (`moe_mlp_faults`) read: the combine weights left in
# f32 0.0054 (half a bf16 step of a gate weight), the second top-k slot
# dropped 0.54, two experts swapped 1.21. The limit sits under the
# smallest, a bf16 step at the largest element (2^-8) above it.
TOL_MOE_REL = 0.002


def moe_mlp_readings(torch, moe, llama, params, config):
    """Layer 0's expert MLP on a 4096-token chunk (8 slots x 512) of
    normalised random hidden states, at the engine's capacity: the
    index path (`_moe_mlp`, auto and static) against `_moe_mlp_dense`,
    three planted faults against the same dense output, and the ms of
    routing, dispatch, the expert GEMMs and the combine of each form."""
    lp = llama.layer_params_at(params, 0)
    gen = torch.Generator(device=DEV).manual_seed(11)
    e = config.hidden_size
    x = torch.randn((8, 512, e), generator=gen, device=DEV).to(config.dtype)
    h = llama._rms_norm(x, lp['mlp_norm'], config.rms_norm_eps)
    k = config.num_experts_per_tok
    with torch.inference_mode():
        dense, _ = moe._moe_mlp_dense(h, lp, config)
        out = {'tokens': h.shape[0] * h.shape[1],
               'capacity_factor': config.capacity_factor,
               'rel_err': rel_err(torch, moe._moe_mlp(h, lp, config)[0],
                                  dense),
               'rel_err_static': rel_err(torch, moe._moe_mlp(
                   h, lp, config, mode='static')[0], dense)}

        def second_slot_dropped(fn):
            def assign(probs, cfg):
                r = fn(probs, cfg)
                first = torch.arange(k, device=probs.device) == 0
                return r._replace(keep=r.keep & first)
            return assign

        def combine_f32(fn):
            def combine(outputs, route, cfg):
                w = route.gates * route.keep
                return (outputs.float() * w[..., None]).sum(1).to(cfg.dtype)
            return combine

        faults = {}
        with patched(moe, '_assign', second_slot_dropped):
            faults['second_slot_dropped'] = rel_err(
                torch, moe._moe_mlp(h, lp, config)[0], dense)
        with patched(moe, '_combine', combine_f32):
            faults['combine_f32'] = rel_err(
                torch, moe._moe_mlp(h, lp, config)[0], dense)
        perm = torch.arange(config.num_experts, device=DEV)
        perm[:2] = perm[:2].flip(0)
        swapped = {**lp, **{w: lp[w][perm] for w in ('w_gate', 'w_up',
                                                     'w_down')}}
        faults['swapped_experts'] = rel_err(
            torch, moe._moe_mlp(h, swapped, config)[0], dense)
        out['faults'] = faults
        out.update(moe_split_ms(torch, moe, h, lp, config))
    return out


def moe_mlp_faults(r):
    """The limits a `moe_mlp_readings` reading breaks: the sound index
    paths must pass and every planted fault must not."""
    bad = [f'{key} {r[key]} >= {TOL_MOE_REL}'
           for key in ('rel_err', 'rel_err_static')
           if not r[key] < TOL_MOE_REL]
    bad += [f'planted {key} read {value} < {TOL_MOE_REL}'
            for key, value in r['faults'].items()
            if not value >= TOL_MOE_REL]
    return bad


def moe_split_ms(torch, moe, h, lp, config):
    """Device ms of each stage of one layer's expert MLP on `h`, for the
    index path (grouped: the sort and the counts' host read, the
    per-expert GEMMs, the scatter back and weighted sum) and the dense
    one-hot form."""
    flat = h.reshape(-1, h.shape[-1])
    g, x_n = flat.shape[0], config.num_experts
    route = moe._route(flat, lp['router'], config)
    rows, cells, counts = moe._grouped_dispatch(flat, route, config)
    y = moe._grouped_experts(rows, counts, lp, config)
    dispatch, combine = moe.dispatch_combine(route, x_n)
    expert_in = torch.einsum('gxc,ge->xce', dispatch.to(config.dtype), flat)
    y_dense = moe._expert(expert_in, lp['w_gate'], lp['w_up'],
                          lp['w_down'], config)
    routing = time_ms(torch, lambda: moe._route(flat, lp['router'], config))

    def dense_dispatch():
        d, _ = moe.dispatch_combine(route, x_n)
        return torch.einsum('gxc,ge->xce', d.to(config.dtype), flat)

    return {
        'rows_per_expert': counts,
        'index_ms': {
            'routing': routing,
            'dispatch': time_ms(torch, lambda: moe._grouped_dispatch(
                flat, route, config)),
            'expert_gemms': time_ms(torch, lambda: moe._grouped_experts(
                rows, counts, lp, config)),
            'combine': time_ms(torch, lambda: moe._combine(
                moe._grouped_undispatch(y, cells, g, config), route,
                config)),
            'total': time_ms(torch, lambda: moe._moe_mlp(h, lp, config))},
        'dense_ms': {
            'routing': routing,
            'dispatch': time_ms(torch, dense_dispatch),
            'expert_gemms': time_ms(torch, lambda: moe._expert(
                expert_in, lp['w_gate'], lp['w_up'], lp['w_down'], config)),
            'combine': time_ms(torch, lambda: torch.einsum(
                'gxc,xce->ge', combine.to(config.dtype), y_dense)),
            'total': time_ms(torch, lambda: moe._moe_mlp_dense(
                h, lp, config))}}


def moe_main_path(torch, inference, fa, engine, prompts, quant):
    """`prompts` through submit() and step() on `engine` (greedy,
    MOE_NEW new tokens), K1 (K2 on an int8 cache) counted around the run
    and held to the admissions' expected launches. Returns (the tokens
    in prompt order, the reading)."""
    counter = fa.flash_attention_quant if quant else fa.flash_attention
    other = fa.flash_attention if quant else fa.flash_attention_quant
    vocab = engine.config.vocab_size
    sampling = inference.SamplingParams(max_new_tokens=MOE_NEW)
    before = {key: engine.stats[key] for key in (
        'prompt_tokens', 'generated_tokens', 'prefill_seconds',
        'decode_seconds')}
    with admissions(engine) as admitted:
        rids = [engine.submit(p, sampling) for p in prompts]
        counter.launches = other.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, other_launches = counter.launches, other.launches
    expected = sum(expected_prefill_launches(engine, lens)
                   for lens in admitted)
    if sorted(results) != sorted(rids) or any(
            len(results[r]) != MOE_NEW
            or not all(0 <= x < vocab for x in results[r]) for r in rids):
        raise AssertionError(f'moe requests incomplete: '
                             f'{ {r: len(t) for r, t in results.items()} }')
    if launches != expected or other_launches:
        raise AssertionError(f'moe main path launched {launches} '
                             f'(other kernel {other_launches}), expected '
                             f'{expected} over admissions {admitted}')
    st = {key: engine.stats[key] - before[key] for key in before}
    return [results[r] for r in rids], {
        'e2e_wall_s': wall, 'kernel_launches': launches,
        'expected_launches': expected,
        'admissions': [len(lens) for lens in admitted],
        'engine_prefill_tok_s': st['prompt_tokens'] / st['prefill_seconds'],
        'engine_decode_tok_s': ((st['generated_tokens'] - len(rids))
                                / max(st['decode_seconds'], 1e-9))}


def moe_decode_syncs(torch, eng, moe, engine, rng, exempt=()):
    """One fused decode dispatch (MOE_DECODE_STEPS steps, 8 slots)
    under torch.cuda.set_sync_debug_mode: 'error' inside every MoE layer
    (a host sync there raises), 'warn' around the rest, whose syncs are
    counted and held to the loop's own check, one a step. The functions
    `exempt` names ((module, name) pairs: a mesh's collectives, which
    gloo stages through the host) run unchecked inside the layers."""
    import warnings
    n = engine.state.cache['length'].shape[0]
    prompts = [prompt_tokens(rng, 64, engine.config.vocab_size)
               for _ in range(n)]
    tokens, lengths, slots, cache = batch_inputs(
        torch, eng, engine, prompts, engine.prefill_chunk)
    logits, _ = eng.prefill_chunked(engine.params, tokens, lengths, cache,
                                    slots, engine.config,
                                    engine.prefill_chunk, use_flash=True)
    dev = engine.device
    args = dict(temperature=torch.zeros(n, device=dev),
                top_k=torch.zeros(n, dtype=torch.int32, device=dev),
                top_p=torch.ones(n, device=dev),
                eos_ids=torch.full((n,), -1, dtype=torch.int32, device=dev),
                budgets=torch.full((n,), 10 ** 6, dtype=torch.int32,
                                   device=dev),
                max_len=engine.state.max_seq_len - 2, generator=None,
                config=engine.config)
    last = torch.argmax(logits, dim=-1).to(torch.int32)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    eng.fused_decode_steps(engine.params, cache, last, active, n_steps=1,
                           **args)
    torch.cuda.synchronize()
    layers = [0]

    def strict(fn):
        def wrapper(*a, **kw):
            layers[0] += 1
            torch.cuda.set_sync_debug_mode('error')
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode('warn')
        return wrapper

    def unchecked(fn):
        # Called inside a layer, where the mode is 'error'.
        def wrapper(*a, **kw):
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode('error')
        return wrapper

    with contextlib.ExitStack() as stack:
        for obj, name in exempt:
            stack.enter_context(patched(obj, name, unchecked))
        caught = stack.enter_context(warnings.catch_warnings(record=True))
        stack.enter_context(patched(moe, '_moe_mlp', strict))
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            _, _, emitted, _, _ = eng.fused_decode_steps(
                engine.params, cache, last, active,
                n_steps=MOE_DECODE_STEPS, **args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = [f'{os.path.basename(w.filename)}:{w.lineno}' for w in caught
             if 'called a synchronizing CUDA operation' in str(w.message)]
    syncs = len(sites)
    out = {'steps': MOE_DECODE_STEPS, 'moe_layers_run': layers[0],
           'syncs_in_moe_layers': 0, 'syncs_in_dispatch': syncs,
           'sync_sites': dict(collections.Counter(sites)),
           'emitted': emitted.tolist()}
    if layers[0] != MOE_DECODE_STEPS * engine.config.num_layers or \
            syncs != MOE_DECODE_STEPS or \
            out['emitted'] != [MOE_DECODE_STEPS] * n:
        raise AssertionError(f'moe fused decode syncs: {out}')
    return out


def moe_serve_phase(torch, inference, eng, fa, rng):
    """mixtral-8x7b, MOE_SERVE_LAYERS layers, on bf16 then int8 KV: the
    engine's prefill logits through the kernel against the plain
    version and the dense path (use_flash=False); on bf16 throughput,
    the expert MLP against its one-hot form with planted faults, the
    main path twice (tokens equal) and a fused decode dispatch held to
    no sync in its MoE layers; on int8 the main path once. Returns
    (reading, {'bf16': K1 launches, 'int8': K2 launches})."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models import moe
    vocab = moe.CONFIGS[MOE_MODEL].vocab_size
    prompts = moe_prompts(rng)
    check = [prompt_tokens(rng, m, vocab) for m in (700, 1300)]
    out, launches = {'layers': MOE_SERVE_LAYERS, **MOE_KW,
                     'prompt_lengths': [len(p) for p in prompts],
                     'max_new_tokens': MOE_NEW}, {}
    params = config = None
    for quant in (False, True):
        key = 'int8' if quant else 'bf16'
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if quant:
            engine = inference.InferenceEngine(params, config,
                                               kv_quant='int8', device=DEV,
                                               **MOE_KW)
        else:
            with depth_cut(MOE_MODEL, MOE_SERVE_LAYERS) as name:
                engine = inference.build_engine(name, device=DEV, seed=0,
                                                kv_quant='none', **MOE_KW)
            params, config = engine.params, engine.config
        torch.cuda.synchronize()
        r = {'init_s': time.perf_counter() - t0,
             'capacity_factor': engine.config.capacity_factor}
        # The kernel against its plain version and against the dense path,
        # both on the kernel path's expert choices: the attentions round
        # differently, and a token near a tie of the router would take
        # other experts (the dense path on its own choices is read, not
        # gated, as `..._own_routes`; the flips are counted).
        with replayed_routes(torch, moe) as replay:
            k_logits = prefill_logits(torch, eng, engine, check)
            replay['record'] = False
            with plain_kernels(fa):
                p_logits = prefill_logits(torch, eng, engine, check)
            plain = (replay['flips'], replay['routed'])
            replay['cursor'].clear()
            d_logits = prefill_logits(torch, eng, engine, check,
                                      use_flash=False)
        own = prefill_logits(torch, eng, engine, check, use_flash=False)
        r.update({
            'prefill_logits_finite': bool(torch.isfinite(k_logits).all()),
            'prefill_logits_rel_err_vs_plain': rel_err(torch, k_logits,
                                                       p_logits),
            'prefill_logits_rel_err_vs_dense_path': rel_err(
                torch, k_logits, d_logits),
            'plain_routing_flips': plain[0],
            'dense_path_routing_flips': replay['flips'] - plain[0],
            'routed_choices': plain[1],
            'prefill_logits_rel_err_vs_dense_path_own_routes': rel_err(
                torch, k_logits, own),
            'argmax_agree_vs_dense_path': int(
                (k_logits.argmax(-1) == d_logits.argmax(-1)).sum())})
        if logits_faults(r):
            raise AssertionError(f'moe prefill logits ({key}): '
                                 f'{logits_faults(r)}')
        if not quant:
            r['throughput'] = throughput(torch, eng, engine, rng)
            torch.cuda.empty_cache()
            r['moe_mlp'] = moe_mlp_readings(torch, moe, llama, params,
                                            config)
            if moe_mlp_faults(r['moe_mlp']):
                raise AssertionError(f'moe mlp: '
                                     f'{moe_mlp_faults(r["moe_mlp"])}')
            torch.cuda.empty_cache()
        tokens, r['main_path'] = moe_main_path(torch, inference, fa, engine,
                                               prompts, quant)
        launches[key] = r['main_path']['kernel_launches']
        if not quant:
            again, _ = moe_main_path(torch, inference, fa, engine, prompts,
                                     quant)
            r['greedy_tokens_equal_across_runs'] = again == tokens
            if again != tokens:
                raise AssertionError('moe greedy tokens differ between two '
                                     'identical runs')
            r['decode_syncs'] = moe_decode_syncs(torch, eng, moe, engine,
                                                 rng)
        r['peak_mem_gb'] = torch.cuda.max_memory_allocated() / 1e9
        out[key] = r
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return out, launches


def moe_train_phase(torch, fa):
    """mixtral-8x7b at full width, MOE_TRAIN_LAYERS layers, flash
    attention through TrainerConfig.attention_impl (the preset is
    dense): train_parity (flash against dense), then fit for
    MOE_TRAIN_STEPS steps at 1 x MOE_TRAIN_SEQ through K1/K3/K4."""
    parity = train_parity(torch, MOE_MODEL, MOE_TRAIN_LAYERS, MOE_TRAIN_SEQ)
    if train_faults(parity):
        raise AssertionError(f'moe train parity: {train_faults(parity)}')
    gc.collect()
    torch.cuda.empty_cache()
    with depth_cut(MOE_MODEL, MOE_TRAIN_LAYERS) as name:
        train = train_phase(torch, fa, name, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS,
                            attention_impl='flash')
    if not (math.isfinite(train['aux_loss']) and train['aux_loss'] > 0):
        raise AssertionError(f'moe aux loss {train["aux_loss"]}')
    return parity, train


# The tp_serve phase: llama3-8b at full width and depth served by two
# ranks of a `tensor=2` mesh sharing the one card over gloo (NCCL refuses
# two ranks on one GPU), each holding half the heads (16 q / 4 kv), half
# the MLP and half the vocab, and running K1 (K2) on its own heads.
TP_MODEL = 'llama3-8b'
TP_MESH = 'tensor=2'
TP_RANKS = 2
TP_KW = dict(batch_size=8, max_seq_len=2048, prefill_chunk=512,
             kv_page_size=64)
TP_PROMPT_LENGTHS = (100, 1500)      # 8 prompts drawn in this range
TP_NEW = 32
# The server leg's requests (prompt tokens, new tokens, streamed), sent
# one at a time; then /v1/completions on the first.
TP_SERVER_REQUESTS = ((300, 8, False), (900, 8, False), (600, 8, True))
TP_FOLLOWER_EXIT_S = 30
# clock_overhead's collectives a round, rounds, and the product's size.
TP_CLOCK_PROBE = (100, 3, 2048)
# Each rank's K1/K2 shape on the main path's heaviest chunk.
TP_TIMING_SHAPE = (8, 512, 2048, 16, 4, 128, 1536)
# A `module:function` each rank process calls first (a CPU rehearsal's
# counting stand-in for the kernels), with the directory it lives in.
TP_RANK_SETUP = None
# The legs tp_serve's ranks run, in order (mesh_fault_check.py runs the
# ones a planted fault touches).
TP_LEGS = ('bf16', 'server', 'int8', 'spec', 'migration', 'moe', 'fsdp',
           'context')
# The migration leg: the fused decode dispatches (the prefill's
# included) before its snapshots.
TP_MIG_DISPATCHES = 2
# The server leg's drained stream: prompt tokens and new tokens, drained
# after TP_DRAIN_AFTER streamed tokens.
TP_DRAIN_REQUEST = (500, 48)
TP_DRAIN_AFTER = 4
# The moe leg: mixtral-8x7b at full width over MOE_MESH, its depth cut to
# MOE_MESH_LAYERS of 32 (the script's time; each layer holds the same
# expert and collective work), the moe_serve phase's 8 prompts.
MOE_MESH = 'expert=2'
MOE_MESH_LAYERS = 4
# The fsdp leg: llama3-8b at full width and depth over FSDP_MESH on the
# bf16 leg's engine flags (TP_KW), FSDP_PROMPTS prompts drawn in
# FSDP_PROMPT_LENGTHS (one prefill chunk), FSDP_NEW tokens each (the
# prefill's and one decode step's): every forward gathers each layer's
# weights over gloo through the host, the leg's cost.
FSDP_MESH = 'fsdp=2'
FSDP_PROMPTS = 4
FSDP_PROMPT_LENGTHS = (100, 500)
FSDP_NEW = 2
# The context leg: llama3-8b at full width over CTX_MESH, its depth cut to
# CTX_LAYERS of 32 (the card holds this gang beside tp_serve's two: each
# rank holds every weight), one CTX_PROMPT-token prompt prefilled in
# chunks of 1536 into a dense cache of 4608 positions: the spans are
# [0, 2304) and [2304, 4608), so the chunk [1536, 3072) straddles the
# boundary and rank 1's first chunk sees no key of its span; then
# CTX_NEW - 1 decode steps, on bf16 and then int8 KV.
CTX_MESH = 'context=2'
CTX_LAYERS = 16
CTX_KW = dict(batch_size=2, max_seq_len=4608, prefill_chunk=1536,
              kv_page_size=0)
CTX_PROMPT = 4000
CTX_NEW = 8
# K1/K2 at a context rank's shapes (B, T, S, H, KV, D, q_offset): rank
# 1's first chunk, every row before its span (no tile to read, lse +inf),
# and its straddling chunk, 768 rows before the span and 768 in it.
CTX_TIMING_SHAPES = (('cp_masked', (1, 1536, 2304, 32, 8, 128, -2304)),
                     ('cp_partial', (1, 1536, 2304, 32, 8, 128, -768)))
# The context leg's layer-0 K row against the unsharded engine's:
# max|a - b| / max|b| over the prompt's positions and the decoded ones
# both share (a write landing in the wrong rank's span moves whole
# rows).
TOL_CTX_SPAN_REL = 0.05
# The gangs the legs run in (`tp_serve_legs`): the first starts at once,
# the second once the parent's unsharded references have freed the card,
# the third once the first has ended (three gangs beside the references
# ran the card out of memory).
TP_GANGS = (('spec', 'migration', 'moe'), ('bf16', 'server', 'int8'),
            ('fsdp', 'context'))
# The faults mesh_fault_check.py plants in tp_serve's ranks (`tp_plant`)
# and the legs each runs.
TP_FAULT_LEGS = {'serve_expert_not_reduced': ('moe',),
                 'draft_off_mesh': ('bf16', 'spec'),
                 'snapshot_rank0_heads': ('bf16', 'migration'),
                 'restore_rank0_heads': ('bf16', 'migration'),
                 'fsdp_layer_ungathered': ('fsdp',),
                 'fsdp_weights_whole': ('fsdp',),
                 'context_lse_unmerged': ('context',),
                 'context_write_other_span': ('context',),
                 'context_cache_whole': ('context',),
                 'context_masked_unlaunched': ('context',)}
# The gate each fault of the fsdp and context legs is counted by: the
# start of the fault line it must break (`tp_fsdp_checks`,
# `tp_context_checks`), or the starts of that gate's line on bf16 and
# on int8 KV.
TP_FAULT_GATES = {'fsdp_layer_ungathered': 'fsdp logits',
                  'fsdp_weights_whole': 'fsdp weight bytes',
                  'context_lse_unmerged': 'context bf16 logits',
                  'context_write_other_span': "context: the spans'",
                  'context_cache_whole': ('context bf16: cache bytes',
                                          'context int8: cache bytes'),
                  'context_masked_unlaunched': ('context bf16 launches',
                                                'context int8 launches')}
# The faults that leave every output as it was and so must break their
# named gate and no other: a weight or a cache kept whole, a launch left
# out. A misplaced write, an unmerged lse or an ungathered layer changes
# what attention reads, and so the logits and tokens too.
TP_FAULTS_ALONE = ('fsdp_weights_whole', 'context_cache_whole',
                   'context_masked_unlaunched')


def tp_plant(name):
    """Plant one of mesh_fault_check.py's serving faults in this rank
    process (None plants nothing):
    - 'serve_expert_not_reduced': the expert outputs not all-reduced
      over `expert` on the serving path (each rank combines its own
      experts' outputs only);
    - 'draft_off_mesh': the draft's layers run off the mesh in the
      speculative rounds: its cut weights' row-parallel products left
      unreduced over `tensor` (a draft not sharded as the target);
    - 'snapshot_rank0_heads': the snapshot's gather packs rank 0's KV
      heads in every rank's place;
    - 'restore_rank0_heads': every rank keeps rank 0's KV heads of the
      restore's broadcast blob;
    - 'fsdp_layer_ungathered': each layer's weights read from rank 0's
      fsdp shard alone, in every rank's place, never gathered whole;
    - 'fsdp_weights_whole': every rank drawing and keeping each weight
      whole, read with no gather (the fsdp axis cutting nothing);
    - 'context_lse_unmerged': the context ranks' partials folded by a
      bare logaddexp, a span with no visible key left at lse = +inf
      instead of weighing 0;
    - 'context_write_other_span': each context rank writes every new
      position into its own span (modulo its length), the other rank's
      positions included;
    - 'context_cache_whole': every rank keeping the whole dense cache
      and attending all of it (the context axis cutting no sequence);
    - 'context_masked_unlaunched': a chunk whose rows all lie before
      this rank's span takes O = 0, lse = +inf without its K1/K2
      launch."""
    if name is None:
        return
    import torch

    from skypilot_tpu_torch.inference import engine as eng
    from skypilot_tpu_torch.parallel import collectives
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    if name == 'serve_expert_not_reduced':
        mt_plant_expert('expert_not_reduced')
    elif name == 'draft_off_mesh':
        real = eng.fused_spec_rounds

        def off_mesh(params, cache, draft_params, *args, **kwargs):
            hidden, layer = eng._hidden_with_cache, eng._layer_with_cache

            def layer_off_mesh(*a, **kw):
                with mesh_lib.use_mesh(None):
                    return layer(*a, **kw)

            def draft_hidden(p, *a, **kw):
                if p is not draft_params:
                    return hidden(p, *a, **kw)
                eng._layer_with_cache = layer_off_mesh
                try:
                    return hidden(p, *a, **kw)
                finally:
                    eng._layer_with_cache = layer

            eng._hidden_with_cache = draft_hidden
            try:
                return real(params, cache, draft_params, *args, **kwargs)
            finally:
                eng._hidden_with_cache = hidden
        eng.fused_spec_rounds = off_mesh
    elif name == 'snapshot_rank0_heads':
        real, gather = eng.InferenceEngine._all_heads, collectives.all_gather

        def rank0_everywhere(t, group, dim):
            parts = gather(t, group, dim).chunk(
                collectives.group_size(group), dim)
            return torch.cat([parts[0]] * len(parts), dim)

        def rank0(self, leaf, dim):
            collectives.all_gather = rank0_everywhere
            try:
                return real(self, leaf, dim)
            finally:
                collectives.all_gather = gather
        eng.InferenceEngine._all_heads = rank0
    elif name == 'fsdp_layer_ungathered':
        real, gather = eng._layer_at, collectives.gather_weight

        def rank0_shard(x, group, dim):
            whole = gather(x, group, dim)
            n = collectives.group_size(group)
            return torch.cat([whole.narrow(dim, 0, x.shape[dim])] * n, dim)

        def layer_at(params, i, cuts):
            collectives.gather_weight = rank0_shard
            try:
                return real(params, i, cuts)
            finally:
                collectives.gather_weight = gather
        eng._layer_at = layer_at
    elif name == 'fsdp_weights_whole':
        from skypilot_tpu_torch import inference
        inference._shardings = lambda mesh, config: None
        eng._place_params = lambda params, config, mesh, device: \
            eng._to_device(params, device)
        collectives.gather_weight = lambda x, group, dim: x
    elif name == 'context_lse_unmerged':
        from skypilot_tpu_torch.ops import flash_attention as fa

        def logaddexp_merge(o_acc, lse_acc, o, lse):
            o = o.float()
            if o_acc is None:
                return o, lse
            new = torch.logaddexp(lse_acc, lse)
            return (o_acc * torch.exp(lse_acc - new).permute(0, 2, 1, 3)
                    + o * torch.exp(lse - new).permute(0, 2, 1, 3), new)
        fa._merge = logaddexp_merge
    elif name == 'context_cache_whole':
        real = eng.init_cache

        def whole(*args, mesh=None, **kwargs):
            return real(*args, **kwargs)
        eng.init_cache = whole
        eng._context_span = lambda local_len: (None, 0, local_len)
    elif name == 'context_masked_unlaunched':
        from skypilot_tpu_torch.ops import flash_attention as fa
        real = fa.flash_fwd

        def skip_masked(q, k, v, causal=True, *args, q_offset=None,
                        **kwargs):
            b, t, h, _ = q.shape
            if causal and q_offset is not None and q_offset + t <= 0:
                return (torch.zeros_like(q),
                        torch.full((b, h, t, 1), math.inf,
                                   dtype=torch.float32, device=q.device))
            return real(q, k, v, causal, *args, q_offset=q_offset, **kwargs)
        fa.flash_fwd = skip_masked
    elif name == 'context_write_other_span':
        def write_everywhere(leaf, new, local_start, rows):
            s_loc = leaf.shape[1]
            for p0 in range(0, new.shape[1], s_loc):
                piece = new[:, p0:p0 + s_loc]
                idx = torch.remainder(local_start[:, None] + p0 + torch.arange(
                    piece.shape[1], device=leaf.device)[None], s_loc)
                leaf[rows, idx] = piece.to(leaf.dtype)
        eng._span_write = write_everywhere
    elif name == 'restore_rank0_heads':
        real = eng.InferenceEngine._scatter_kv

        def rank0(self, *args):
            mesh = self.mesh
            self.mesh = dataclasses.replace(mesh, tensor_rank=0)
            try:
                return real(self, *args)
            finally:
                self.mesh = mesh
        eng.InferenceEngine._scatter_kv = rank0
    else:
        raise ValueError(f'unknown serving fault {name!r}')


@contextlib.contextmanager
def collective_clock(torch, dist, eng):
    """Time every all_reduce and all_gather for the block, split by
    whether a fused decode dispatch made it (`decode_s`, `decode_calls`)
    or the prefill (`prefill_s`, `prefill_calls`). A gloo collective on a
    CUDA tensor holds the host until its copy to the host (which waits
    for the work before it) and the exchange are done, and queues the
    copy back; so each call is timed from a synchronize, which moves no
    work, to its return: the copy out and the exchange, not the copy
    back."""
    clock = {'prefill_s': 0.0, 'prefill_calls': 0, 'decode_s': 0.0,
             'decode_calls': 0}
    where = ['prefill']

    def timed(fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            clock[where[0] + '_s'] += time.perf_counter() - t0
            clock[where[0] + '_calls'] += 1
            return result
        return wrapper

    def in_decode(fn):
        def wrapper(*args, **kwargs):
            where[0] = 'decode'
            try:
                return fn(*args, **kwargs)
            finally:
                where[0] = 'prefill'
        return wrapper

    with patched(dist, 'all_reduce', timed), \
            patched(dist, 'all_gather', timed), \
            patched(eng, 'fused_decode_steps', in_decode):
        yield clock


def clock_overhead(torch, dist, mesh, width, probe):
    """What `collective_clock`'s synchronize adds to a collective: on
    every rank together, `calls` f32 all-reduces of a decode step's
    [8, width] each behind a queued [n, n] product (a layer's work before
    its reduce), without and with a synchronize before each, `rounds`
    times each (`probe`: TP_CLOCK_PROBE); the fastest round of each.
    Returns the milliseconds a call of each and their difference."""
    calls, rounds, n = probe
    x = torch.zeros(8, width, device=mesh.device)
    a = torch.randn(n, n, device=mesh.device)

    def run(sync):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            a @ a
            if sync:
                torch.cuda.synchronize()
            dist.all_reduce(x, group=mesh.tensor_group)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls

    run(False)
    plain = min(run(False) for _ in range(rounds))
    synced = min(run(True) for _ in range(rounds))
    return {'calls': calls, 'plain_ms': plain * 1e3,
            'synced_ms': synced * 1e3, 'added_ms': (synced - plain) * 1e3}


def tp_rank_main(spec_path):
    """One rank of the tp_serve gang, run as its own process with the
    gang variables set, through the legs `spec['legs']` names in order:
    build_engine(mesh_arg=TP_MESH) (its slice of the seed-0 weights),
    then on bf16 KV the 8 prompts (rank 0 submits, the other rank
    follows) with K1's launches, the collectives' time
    (`collective_clock`) and the replicated scheduler's own host time
    (the plan hash on every rank, rank 0's publish) read around them;
    the server leg's requests one at a time on a fresh engine; what the
    clock's synchronizes cost (`clock_overhead`); the 8 prompts on int8
    KV (K2); the target as its own draft (`tp_spec_leg`); snapshot,
    restore and handoff (`tp_migration_leg`); mixtral-8x7b over
    MOE_MESH (`tp_moe_leg`); then llama3-8b over FSDP_MESH
    (`tp_fsdp_leg`) and over CTX_MESH (`tp_context_leg`). Writes its
    readings as JSON (rank 0's
    first-token logits beside them); any failure raises (non-zero
    exit)."""
    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ['SKYTPU_PROCESS_ID'])
    if spec['setup']:
        import importlib
        sys.path.insert(0, spec['setup_path'])
        module, fn = spec['setup'].split(':')
        getattr(importlib.import_module(module), fn)()
    tp_plant(spec['fault'])
    import torch
    import torch.distributed as dist

    from skypilot_tpu_torch import inference
    from skypilot_tpu_torch.inference import engine as eng
    from skypilot_tpu_torch.ops import flash_attention as fa
    dev = spec['device']
    kw = spec['engine_kw']
    prompts = spec['prompts']
    legs = spec['legs']
    out = {'rank': rank}

    def follow_or_lead(engine, lead):
        """Rank 0 runs `lead(engine)`, then stops the followers; the
        others follow. Returns (lead's result or None, every finished
        request's tokens by id on this rank)."""
        seen = {}
        finished = engine.finished

        def recording():
            got = finished()
            seen.update(got)
            return got

        engine.finished = recording
        if rank == 0:
            result = lead(engine)
            engine.stop_followers()
            return result, seen
        engine.follow()
        return None, seen

    engine = None
    if any(leg in legs for leg in ('bf16', 'int8', 'spec', 'migration')):
        t0 = time.perf_counter()
        engine = inference.build_engine(spec['model'], device=dev, seed=0,
                                        mesh_arg=spec['mesh'],
                                        kv_quant='none', **kw)
        torch.cuda.synchronize()
        params, config, mesh = engine.params, engine.config, engine.mesh
        out.update({'init_s': time.perf_counter() - t0,
                    'backend': mesh.backend, 'device': str(mesh.device),
                    'local_heads': int(params['layers']['wq'].shape[2]),
                    'local_kv_heads': int(params['layers']['wk'].shape[2]),
                    'local_mlp': int(params['layers']['w_up'].shape[-1]),
                    'local_vocab': int(params['embed'].shape[0])})
    for key in ('bf16', 'int8'):
        if key not in legs:
            continue
        if key == 'int8':
            del engine
            gc.collect()
            torch.cuda.empty_cache()
            engine = inference.InferenceEngine(params, config, mesh=mesh,
                                               kv_quant='int8', **kw)
        counter = fa.flash_attention_quant if key == 'int8' \
            else fa.flash_attention
        counter.launches = 0
        logits = capture_first_logits(engine)
        plan_s, publish_s = [], []
        with collective_clock(torch, dist, eng) as clock, \
                timed(engine, '_plan', plan_s), \
                timed(engine._channel, 'publish', publish_s):
            run, seen = follow_or_lead(engine, lambda e: run_greedy(
                torch, inference, e, prompts, spec['new'])[1])
        r = {'launches': counter.launches,
             'tokens': [seen.get(i) for i in range(len(prompts))],
             'expected_launches': expected_prefill_launches(
                 engine, [len(p) for p in prompts]),
             'collectives': clock,
             'scheduler': {'plan_calls': len(plan_s),
                           'plan_s': sum(plan_s),
                           'plan_max_s': max(plan_s, default=0.0),
                           'publish_calls': len(publish_s),
                           'publish_s': sum(publish_s)}}
        if rank == 0:
            prompt_total = sum(len(p) for p in prompts)
            r.update(run, prefill_s=engine.stats['prefill_seconds'],
                     prefill_tok_s=prompt_total / max(
                         engine.stats['prefill_seconds'], 1e-9))
            torch.save(torch.cat(logits).float().cpu(),
                       os.path.join(spec['dir'], f'logits_{key}.pt'))
        out[key] = r
        if key == 'bf16' and 'server' in legs:
            # The server leg's requests, one at a time on a fresh engine
            # of the server's flags: what the server must answer.
            del engine
            gc.collect()
            engine = inference.InferenceEngine(params, config, mesh=mesh,
                                               kv_quant='none', **kw)

            def serve(e):
                return [greedy_tokens(inference, e, p, n)[0]
                        for p, n in spec['server_requests']]

            _, seen = follow_or_lead(engine, serve)
            out['server_requests'] = [seen.get(i) for i in range(
                len(spec['server_requests']))]
            out['clock_overhead'] = clock_overhead(
                torch, dist, mesh, config.hidden_size,
                spec['clock_probe'])
    if engine is not None:
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    if 'spec' in legs:
        out['spec'] = tp_spec_leg(torch, inference, fa, params, config, mesh,
                                  spec, follow_or_lead)
    if 'migration' in legs:
        out['migration'] = tp_migration_leg(torch, inference, eng, fa,
                                            params, config, mesh, spec,
                                            follow_or_lead)
    out['peak_mem_gb'] = peak_gb(torch)
    if 'moe' in legs:
        params = config = mesh = None
        gc.collect()
        torch.cuda.empty_cache()
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        out['moe'] = tp_moe_leg(torch, inference, eng, fa, spec,
                                follow_or_lead, rank)
    if 'fsdp' in legs:
        out['fsdp'] = tp_fsdp_leg(torch, inference, eng, fa, spec,
                                  follow_or_lead)
    if 'context' in legs:
        out['context'] = tp_context_leg(torch, inference, eng, fa, spec,
                                        follow_or_lead, rank)
    with open(os.path.join(spec['dir'], f'rank{rank}.json'), 'w') as f:
        json.dump(out, f)
    return 0


def peak_gb(torch):
    """The process's peak allocated device memory in GB (None without
    CUDA)."""
    return (torch.cuda.max_memory_allocated() / 1e9
            if torch.cuda.is_available() else None)


def tp_spec_leg(torch, inference, fa, params, config, mesh, spec,
                follow_or_lead):
    """The 8 prompts on bf16 KV with the target as its own draft (the
    same tensors; its cache sharded as the target's), SPEC_K drafted
    tokens a round, SPEC_ROUNDS rounds a dispatch: K1 launches (the
    target's prefill; the draft's is dense) and, on rank 0, the rounds'
    readings (`run_greedy`)."""
    engine = inference.InferenceEngine(
        params, config, mesh=mesh, kv_quant='none', draft=(params, config),
        spec_k=SPEC_K, spec_fuse_rounds=SPEC_ROUNDS, **spec['engine_kw'])
    prompts = spec['prompts']
    fa.flash_attention.launches = fa.flash_attention_quant.launches = 0
    run, seen = follow_or_lead(engine, lambda e: run_greedy(
        torch, inference, e, prompts, spec['new'])[1])
    r = {'launches': fa.flash_attention.launches,
         'other_launches': fa.flash_attention_quant.launches,
         'tokens': [seen.get(i) for i in range(len(prompts))],
         'expected_launches': expected_prefill_launches(
             engine, [len(p) for p in prompts]),
         'draft_local_heads': int(
             engine._draft_params['layers']['wq'].shape[2]),
         'spec_k': SPEC_K, 'spec_fuse_rounds': SPEC_ROUNDS}
    if run is not None:
        r.update(run)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return r


def watch_migration_pages(torch, engine):
    """On any rank: the request's pages of this rank's pool as a
    snapshot gathers them, and whether a restore spliced the same bytes
    (the i-th restore against the i-th snapshot). Returns the list of
    verdicts, filled as the engine runs."""
    snapped, equal = [], []
    snap_kv, restore = engine._snapshot_kv, engine._restore_locked

    def pages_of(slot, n):
        ids = torch.tensor(engine._slot_pages[slot][:n],
                           device=engine.device)
        out = []
        for name in ('k', 'v'):
            leaf = engine.state.cache[name]
            for part in (leaf.values() if isinstance(leaf, dict)
                         else [leaf]):
                out.append(part.index_select(1, ids).clone())
        return out

    def snapshot_kv(i, length):
        snapped.append(pages_of(i, -(-length // engine.kv_page_size)))
        return snap_kv(i, length)

    def restore_locked(header, arrays):
        rid = restore(header, arrays)
        if header.get('layout') == 'paged':
            slot = next(i for i, s in enumerate(engine.state.slots)
                        if s is not None and s.request_id == rid)
            got = pages_of(slot, -(-int(header['length'])
                                   // engine.kv_page_size))
            want = snapped[len(equal)]
            equal.append(all(torch.equal(a, b) for a, b in zip(got, want)))
        return rid

    engine._snapshot_kv = snapshot_kv
    engine._restore_locked = restore_locked
    return equal


def tp_migration_leg(torch, inference, eng, fa, params, config, mesh, spec,
                     follow_or_lead):
    """The 8 prompts on bf16 KV, the one after the longest and the
    shortest submitted with handoff=True: after the prefill and
    TP_MIG_DISPATCHES fused decode dispatches the longest and the
    shortest are snapshotted and the handoff request exported at its
    pause, all three aborted and restored, and every request run to its
    end. Every rank checks that each restore spliced the bytes its
    snapshot gathered; rank 0 reads the blobs (bytes, KV heads) and
    times the gather, pack, unpack, scatter and splice."""
    engine = inference.InferenceEngine(params, config, mesh=mesh,
                                       kv_quant='none', **spec['engine_kw'])
    prompts = spec['prompts']
    lengths = [len(p) for p in prompts]
    longest = lengths.index(max(lengths))
    shortest = lengths.index(min(lengths))
    handoff = next(i for i in range(len(prompts))
                   if i not in (longest, shortest))
    moved = [longest, shortest, handoff]
    equal = watch_migration_pages(torch, engine)
    times = {key: [] for key in ('snapshot', 'gather', 'pack', 'unpack',
                                 'restore', 'scatter', 'splice')}

    def lead(e):
        sampling = inference.SamplingParams(max_new_tokens=spec['new'])
        rids = [e.submit(p, sampling, handoff=i == handoff)
                for i, p in enumerate(prompts)]
        for _ in range(TP_MIG_DISPATCHES):
            e.step()
        paused = e.handoff_pending() == [rids[handoff]]
        progress = e.active_progress()
        at_snapshot = [len(progress[rids[i]]) for i in moved]
        blobs = []
        for i in moved:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blobs.append(e.snapshot_request(rids[i]))
            times['snapshot'].append(time.perf_counter() - t0)
        e.mark_handoff_exported(rids[handoff])
        for i in moved:
            e.abort(rids[i])
        for i, blob in zip(moved, blobs):
            t0 = time.perf_counter()
            rids[i] = e.restore_request(blob)
            torch.cuda.synchronize()
            times['restore'].append(time.perf_counter() - t0)
        e.run_to_completion()
        heads = []
        for blob in blobs:
            _, arrays = eng._snapshot_unpack(blob)
            heads.append(sorted({int(a.shape[3]) for a in arrays.values()}))
        return {'rids': rids, 'paused': paused,
                'tokens_at_snapshot': at_snapshot,
                'blob_bytes': [len(b) for b in blobs],
                'blob_kv_heads': heads}

    fa.flash_attention.launches = 0
    with timed(engine, '_snapshot_kv', times['gather']), \
            timed(eng, '_snapshot_pack', times['pack']), \
            timed(eng, '_snapshot_unpack', times['unpack']), \
            timed(engine, '_scatter_kv', times['scatter']), \
            timed(eng, '_splice_pool_pages', times['splice']):
        run, seen = follow_or_lead(engine, lead)
    r = {'moved': moved, 'handoff': handoff, 'restored_bytes_equal': equal,
         'launches': fa.flash_attention.launches,
         'expected_launches': expected_prefill_launches(engine, lengths),
         'seen': {str(k): v for k, v in seen.items()}}
    if run is not None:
        r.update(run, ms={key: [t * 1e3 for t in v]
                          for key, v in times.items()})
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return r


def tp_moe_leg(torch, inference, eng, fa, spec, follow_or_lead, rank):
    """mixtral-8x7b at full width, MOE_MESH_LAYERS layers, over MOE_MESH
    (each rank its share of the experts), the moe_serve phase's 8
    prompts greedy on bf16 KV: K1 launches, the collectives' time in the
    prefill and in decode, rank 0's first-token logits; then, on every
    rank together, one fused decode dispatch held to no host sync in
    its MoE layers (`moe_decode_syncs`; the collectives themselves, a
    host copy under gloo, exempt)."""
    import numpy as np
    import torch.distributed as dist

    from skypilot_tpu_torch.models import moe
    from skypilot_tpu_torch.parallel import collectives
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    m = spec['moe']
    t0 = time.perf_counter()
    with depth_cut(m['model'], m['layers']) as name:
        engine = inference.build_engine(name, device=spec['device'], seed=0,
                                        mesh_arg=m['mesh'], kv_quant='none',
                                        **m['engine_kw'])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = m['prompts']
    logits = capture_first_logits(engine)
    fa.flash_attention.launches = fa.flash_attention_quant.launches = 0
    with collective_clock(torch, dist, eng) as clock:
        run, seen = follow_or_lead(engine, lambda e: run_greedy(
            torch, inference, e, prompts, m['new'])[1])
    lp = engine.params['layers']
    r = {'init_s': init_s, 'launches': fa.flash_attention.launches,
         'other_launches': fa.flash_attention_quant.launches,
         'tokens': [seen.get(i) for i in range(len(prompts))],
         'expected_launches': expected_prefill_launches(
             engine, [len(p) for p in prompts]),
         'collectives': clock,
         'local_experts': int(lp['w_gate'].shape[1]),
         'param_gb': sum(t.numel() * t.element_size()
                         for t in tree_leaves(engine.params)) / 1e9,
         'layer_param_gb': sum(t.numel() * t.element_size()
                               for t in lp.values()) / 1e9
         / engine.config.num_layers}
    if run is not None:
        prompt_total = sum(len(p) for p in prompts)
        r.update(run, prefill_s=engine.stats['prefill_seconds'],
                 prefill_tok_s=prompt_total / max(
                     engine.stats['prefill_seconds'], 1e-9))
        torch.save(torch.cat(logits).float().cpu(),
                   os.path.join(spec['dir'], 'logits_moe.pt'))
    with mesh_lib.use_mesh(engine.mesh):
        r['decode_syncs'] = moe_decode_syncs(
            torch, eng, moe, engine, np.random.default_rng(m['sync_seed']),
            exempt=((collectives, 'all_reduce_'),
                    (collectives, 'all_gather')))
    r['peak_mem_gb'] = peak_gb(torch)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return r


def tp_fsdp_leg(torch, inference, eng, fa, spec, follow_or_lead):
    """llama3-8b at full width and depth over FSDP_MESH (each rank its
    half of every weight's `embed` dim, each layer gathered for its math),
    the bf16 leg's engine flags, the leg's prompts, FSDP_NEW tokens each:
    K1 launches, the collectives' time, this rank's weight bytes and peak
    memory, rank 0's first-token logits."""
    import torch.distributed as dist
    f = spec['fsdp']
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = inference.build_engine(spec['model'], device=spec['device'],
                                    seed=0, mesh_arg=f['mesh'],
                                    kv_quant='none', **spec['engine_kw'])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = f['prompts']
    logits = capture_first_logits(engine)
    fa.flash_attention.launches = fa.flash_attention_quant.launches = 0
    with collective_clock(torch, dist, eng) as clock:
        run, seen = follow_or_lead(engine, lambda e: run_greedy(
            torch, inference, e, prompts, f['new'])[1])
    r = {'init_s': init_s, 'launches': fa.flash_attention.launches,
         'other_launches': fa.flash_attention_quant.launches,
         'tokens': [seen.get(i) for i in range(len(prompts))],
         'expected_launches': expected_prefill_launches(
             engine, [len(p) for p in prompts]),
         'collectives': clock,
         'weight_bytes': sum(t.numel() * t.element_size()
                             for t in tree_leaves(engine.params)),
         'local_embed': list(engine.params['embed'].shape),
         'peak_mem_gb': peak_gb(torch)}
    if run is not None:
        prompt_total = sum(len(p) for p in prompts)
        r.update(run, prefill_s=engine.stats['prefill_seconds'],
                 prefill_tok_s=prompt_total / max(
                     engine.stats['prefill_seconds'], 1e-9))
        torch.save(torch.cat(logits).float().cpu(),
                   os.path.join(spec['dir'], 'logits_fsdp.pt'))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return r


def kv_bytes(engine):
    """The bytes of an engine's KV cache leaves on this rank."""
    return sum(t.numel() * t.element_size() for name in ('k', 'v')
               for t in tree_leaves(engine.state.cache[name]))


def tp_context_leg(torch, inference, eng, fa, spec, follow_or_lead, rank):
    """llama3-8b at full width, CTX_LAYERS layers, over CTX_MESH (each
    rank its span of the dense cache), the long prompt greedy on bf16 then
    int8 KV: K1 (K2) launches, counted by the offset each launched at,
    the collectives' time, this rank's cache bytes and positions, its
    layer-0 K row of the prompt's slot (a file beside rank 0's
    first-token logits)."""
    import torch.distributed as dist
    c = spec['context']
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with depth_cut(spec['model'], c['layers']) as name:
        engine = inference.build_engine(name, device=spec['device'], seed=0,
                                        mesh_arg=c['mesh'], kv_quant='none',
                                        **c['engine_kw'])
    torch.cuda.synchronize()
    out = {'init_s': time.perf_counter() - t0}
    params, config, mesh = engine.params, engine.config, engine.mesh
    prompt = c['prompt']
    for key in ('bf16', 'int8'):
        if key == 'int8':
            del engine
            gc.collect()
            torch.cuda.empty_cache()
            engine = inference.InferenceEngine(params, config, mesh=mesh,
                                               kv_quant='int8',
                                               **c['engine_kw'])
        counter = fa.flash_attention_quant if key == 'int8' \
            else fa.flash_attention
        logits = capture_first_logits(engine)
        for w in (fa.flash_attention, fa.flash_attention_quant):
            w.launches, w.offset_launches = 0, {}
        with collective_clock(torch, dist, eng) as clock:
            run, seen = follow_or_lead(engine, lambda e: run_greedy(
                torch, inference, e, [prompt], c['new'])[1])
        k = engine.state.cache['k']
        leaf = k['q'] if isinstance(k, dict) else k
        r = {'launches': counter.launches,
             'other_launches': (fa.flash_attention.launches
                                + fa.flash_attention_quant.launches
                                - counter.launches),
             'offset_launches': {str(o): n for o, n in
                                 counter.offset_launches.items()},
             'tokens': seen.get(0),
             'expected_launches': expected_prefill_launches(
                 engine, [len(prompt)]),
             'collectives': clock, 'cache_bytes': kv_bytes(engine),
             'cache_positions': int(leaf.shape[2])}
        if key == 'bf16':
            torch.save(k[0, 0].float().cpu(),
                       os.path.join(spec['dir'], f'krow{rank}.pt'))
        if run is not None:
            r.update(run, prefill_s=engine.stats['prefill_seconds'])
            torch.save(torch.cat(logits).float().cpu(),
                       os.path.join(spec['dir'], f'logits_context_{key}.pt'))
        out[key] = r
    out['peak_mem_gb'] = peak_gb(torch)
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tp_gang_env(port, rank, backend='gloo'):
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('SKYTPU_')}
    return {**env, 'PYTHONPATH': here,
            'SKYTPU_COORDINATOR_ADDR': f'127.0.0.1:{port}',
            'SKYTPU_NUM_PROCESSES': str(TP_RANKS),
            'SKYTPU_PROCESS_ID': str(rank),
            'SKYTPU_TORCH_DIST_BACKEND': backend}


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def start_ranks(argv_of, env_of, log_dir, name, timeout):
    """Start TP_RANKS processes (`argv_of(rank)`, `env_of(rank)`), their
    output to log_dir/{name}{rank}.log. Returns wait(): (return codes,
    logs' tails, seconds) once all have ended; a rank past `timeout` is
    killed."""
    here = os.path.dirname(os.path.abspath(__file__))
    logs = [open(os.path.join(log_dir, f'{name}{r}.log'), 'w+')
            for r in range(TP_RANKS)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv_of(r), cwd=here, env=env_of(r),
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(TP_RANKS)]

    def wait():
        rcs = []
        try:
            for p in procs:
                left = max(1.0, timeout - (time.perf_counter() - t0))
                try:
                    rcs.append(p.wait(left))
                except subprocess.TimeoutExpired:
                    rcs.append(None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            tails = []
            for f in logs:
                f.seek(0)
                tails.append(f.read()[-3000:])
                f.close()
        return rcs, tails, time.perf_counter() - t0

    wait.alive = lambda: all(p.poll() is None for p in procs)
    return wait


def tp_nccl_refusal(tmp):
    """Start two ranks on the one device asking for NCCL; returns the
    check to call later: both must have exited with the mesh's clear
    error, well before any NCCL collective."""
    code = ('from skypilot_tpu_torch.parallel import mesh; '
            f'mesh.mesh_from_env(mesh.MeshSpec.parse({TP_MESH!r}), '
            f'{DEV!r})')
    port = free_port()
    wait = start_ranks(lambda r: [sys.executable, '-c', code],
                       lambda r: tp_gang_env(port, r, backend='nccl'),
                       tmp, 'nccl', timeout=120)

    def check():
        rcs, tails, seconds = wait()
        refused = [rc not in (0, None) and 'NCCL cannot run two ranks on '
                   'one device' in tail for rc, tail in zip(rcs, tails)]
        if not all(refused):
            raise AssertionError(f'nccl with two ranks on one device: rcs '
                                 f'{rcs}, {tails}')
        return {'rcs': rcs, 'seconds': seconds}

    return check


def tp_server_leg(torch, requests, want, tmp, drain=None):
    """The port's server as TP_RANKS processes of --mesh TP_MESH through
    the normal entry point: /health, each of `requests` through /generate
    (one streamed) one at a time, then /v1/completions on the first, every
    answer token for token `want`; with `drain` (prompt, new tokens) a
    stream of it drained by /internal/drain?deadline=0 after
    TP_DRAIN_AFTER tokens (its migrate frame's blob returned as
    `drain['blob']`); then SIGTERM to rank 0, after which rank 1 must
    exit within TP_FOLLOWER_EXIT_S."""
    here = os.path.dirname(os.path.abspath(__file__))
    http, gang = free_port(), free_port()
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.inference.server',
           '--model', TP_MODEL, '--mesh', TP_MESH, '--device', DEV,
           '--port', str(http), '--seed', '0',
           '--batch-size', str(TP_KW['batch_size']),
           '--max-seq-len', str(TP_KW['max_seq_len']),
           '--prefill-chunk', str(TP_KW['prefill_chunk']),
           '--kv-page-size', str(TP_KW['kv_page_size'])]
    logs = [open(os.path.join(tmp, f'server{r}.log'), 'w+')
            for r in range(TP_RANKS)]
    procs = [subprocess.Popen(cmd, cwd=here, env=tp_gang_env(gang, r),
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(TP_RANKS)]
    base = f'http://127.0.0.1:{http}'
    drained = None

    def tail(r):
        logs[r].seek(0)
        return logs[r].read()[-3000:]

    try:
        t0 = time.perf_counter()
        while True:
            for r, p in enumerate(procs):
                if p.poll() is not None:
                    raise AssertionError(f'tp server rank {r} exited: '
                                         + tail(r))
            try:
                if http_json(base + '/health', timeout=10)[0] == 200:
                    break
            except (urllib.error.URLError, ConnectionError):
                pass
            if time.perf_counter() - t0 > 600:
                raise AssertionError('tp server never loaded: ' + tail(0))
            time.sleep(0.2)
        load_s = time.perf_counter() - t0
        got, request_s = [], []
        for prompt, new, stream in requests:
            t0 = time.perf_counter()
            body = {'prompt_tokens': prompt, 'max_new_tokens': new}
            if stream:
                text = http_json(base + '/generate', {**body,
                                                      'stream': True})[1]
                frames = list(sse_frames(text.splitlines()))
                streamed = [f['token'] for f in frames if 'token' in f]
                tokens = frames[-1]['tokens']
                if streamed != tokens:
                    raise AssertionError(f'stream {streamed} != {tokens}')
            else:
                tokens = json.loads(http_json(base + '/generate',
                                              body)[1])['tokens']
            request_s.append(time.perf_counter() - t0)
            got.append(tokens)
        v1 = json.loads(http_json(base + '/v1/completions', {
            'prompt': requests[0][0], 'max_tokens': requests[0][1],
            'temperature': 0})[1])['choices'][0]['tokens']
        if drain is not None:
            drained = tp_drain_stream(base, *drain)
        procs[0].send_signal(signal.SIGTERM)
        t0 = time.perf_counter()
        try:
            follower_rc = procs[1].wait(TP_FOLLOWER_EXIT_S)
        except subprocess.TimeoutExpired:
            raise AssertionError(f'tp server rank 1 still runs '
                                 f'{TP_FOLLOWER_EXIT_S} s after rank 0 '
                                 'was stopped') from None
        follower_exit_s = time.perf_counter() - t0
        leader_rc = procs[0].wait(60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tails = [tail(r) for r in range(TP_RANKS)]
        for f in logs:
            f.close()
    faults = []
    if got != want[:len(requests)]:
        faults.append(f'server tokens {got} != engine leg {want}')
    if v1 != want[0]:
        faults.append(f'/v1 tokens {v1} != engine leg {want[0]}')
    if (leader_rc, follower_rc) != (0, 0):
        faults.append(f'exit codes {leader_rc}, {follower_rc}: {tails}')
    out = {'command': ' '.join(cmd[1:]), 'load_s': load_s,
           'request_s': request_s, 'tokens_equal': got == want[:len(
               requests)], 'v1_equal': v1 == want[0],
           'follower_exit_s': follower_exit_s,
           'exit_codes': [leader_rc, follower_rc], 'faults': faults}
    if drained is not None:
        faults += drained.pop('faults')
        out['drain'] = drained
    return out


def tp_drain_stream(base, prompt, new):
    """A stream of `prompt` on the server at `base`, drained after
    TP_DRAIN_AFTER tokens by POST /internal/drain?deadline=0: the tokens
    streamed, the migrate frame's sent count and blob, the drain's
    answer, and the 503 a new request then gets."""
    import base64
    req = urllib.request.Request(base + '/generate', data=json.dumps({
        'prompt_tokens': prompt, 'max_new_tokens': new,
        'stream': True}).encode(), headers={'Content-Type':
                                            'application/json'})
    got, doc, frame = [], {}, None
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        for frame in sse_frames(line.decode() for line in resp):
            if 'token' not in frame:
                break
            got.append(frame['token'])
            if len(got) == TP_DRAIN_AFTER:
                drain = threading.Thread(target=lambda: doc.update(
                    answer=http_json(base + '/internal/drain?deadline=0',
                                     {})))
                drain.start()
    stream_s = time.perf_counter() - t0
    faults = []
    if len(got) < TP_DRAIN_AFTER:
        raise AssertionError(f'drained stream ended after {got}: {frame}')
    drain.join(120)
    migrate = (frame or {}).get('migrate')
    if migrate is None:
        raise AssertionError(f'drained stream ended with {frame}')
    status, body = doc['answer']
    answer = json.loads(body)
    if status != 200 or answer != {
            'status': 'drained', 'finished_naturally': False,
            'snapshots': [], 'migrated_streams': 1}:
        faults.append(f'drain answered {status} {answer}')
    if migrate['sent'] != len(got):
        faults.append(f'migrate frame sent {migrate["sent"]}, streamed '
                      f'{len(got)}')
    try:
        refused = http_json(base + '/generate', {'prompt_tokens': [1, 2],
                                                 'max_new_tokens': 2})[0]
    except urllib.error.HTTPError as e:
        refused = e.code
    if refused != 503:
        faults.append(f'a draining replica answered {refused}, not 503')
    return {'streamed': got, 'sent': migrate['sent'], 'stream_s': stream_s,
            'blob': base64.b64decode(migrate['snapshot']),
            'new_request_status': refused, 'faults': faults}


def moe_prompts(rng):
    """The moe_serve phase's draws from its generator: the long prompt
    and the 8 prompts of MOE_PROMPT_LENGTHS (in that order)."""
    from skypilot_tpu_torch.models import moe
    lo, hi = MOE_PROMPT_LENGTHS
    vocab = moe.CONFIGS[MOE_MODEL].vocab_size
    lengths = [int(x) for x in rng.integers(lo, hi + 1, size=8)]
    return ([prompt_tokens(rng, MOE_LONG, vocab)]
            + [prompt_tokens(rng, m, vocab) for m in lengths])


def tp_moe_reference(torch, inference, prompts):
    """The moe leg's reference: an unsharded engine of the same depth
    and seed on one device, the same prompts greedy. Returns (tokens,
    first-token logits on the host, its readings, its params on the
    host, its config)."""
    eng_kw = dict(MOE_KW, kv_quant='none')
    with depth_cut(MOE_MODEL, MOE_MESH_LAYERS) as name:
        engine = inference.build_engine(name, device=DEV, seed=0, **eng_kw)
    seen = capture_first_logits(engine)
    tokens, run = run_greedy(torch, inference, engine, prompts, MOE_NEW)
    logits = torch.cat(seen).float().cpu()
    from skypilot_tpu_torch.inference import engine as eng
    params = eng._to_device(engine.params, torch.device('cpu'))
    config = engine.config
    del engine, seen
    gc.collect()
    torch.cuda.empty_cache()
    return tokens, logits, run, params, config


def tp_serve_phase(torch, inference, fa, rng, legs=None, fault=None):
    """llama3-8b served over a TP_MESH mesh (see tp_rank_main): the ranks'
    first-token logits within TOL_LOGITS_REL of the unsharded engine's
    on the same seed (run here beside the ranks), their greedy tokens
    equal to its tokens up to near-ties (the divergence rule,
    TOL_SPEC_GAP) and to each other's, K1 (K2) launches on each rank
    equal to expected_prefill_launches; NCCL with two ranks on one
    device refused; the target as its own draft (tokens equal the
    ranks' own bf16 tokens up to near-ties, acceptance at least
    TOL_SPEC_ACCEPT); snapshot, restore and handoff (tokens equal, the
    restored pages byte-equal on every rank, every KV head in the blob);
    mixtral-8x7b over MOE_MESH against its unsharded engine (run here
    beside the ranks); llama3-8b over FSDP_MESH against the bf16
    reference's first FSDP_NEW tokens (`tp_fsdp_checks`) and at
    CTX_LAYERS layers over CTX_MESH against its own unsharded engine
    (`tp_context_checks`), in a gang of their own; then the server leg
    (tp_server_leg), drained into an unsharded engine. `legs` (default
    TP_LEGS) and `fault` (`tp_plant`) serve mesh_fault_check.py. Returns
    (reading, K1/K2 launches per rank by leg)."""
    import shutil
    import tempfile

    from skypilot_tpu_torch import models as models_lib
    from skypilot_tpu_torch.inference import engine as eng
    from skypilot_tpu_torch.models import llama
    legs = TP_LEGS if legs is None else legs
    vocab = models_lib.resolve(TP_MODEL)[1].vocab_size
    lo, hi = TP_PROMPT_LENGTHS
    lengths = [int(x) for x in rng.integers(lo, hi + 1, size=8)]
    prompts = [prompt_tokens(rng, m, vocab) for m in lengths]
    requests = [(prompt_tokens(rng, n, vocab), new, stream)
                for n, new, stream in TP_SERVER_REQUESTS]
    drain = (prompt_tokens(rng, TP_DRAIN_REQUEST[0], vocab),
             TP_DRAIN_REQUEST[1])
    out = {'model': TP_MODEL, 'mesh': TP_MESH, 'ranks': TP_RANKS,
           'backend': 'gloo', **TP_KW, 'prompt_lengths': lengths,
           'max_new_tokens': TP_NEW, 'legs': list(legs), 'fault': fault}
    tmp = tempfile.mkdtemp(prefix='chip_smoke_tp_')
    try:
        launches = tp_serve_legs(torch, inference, eng, llama, prompts,
                                 requests, drain, out, tmp, legs, fault)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, launches


def tp_serve_legs(torch, inference, eng, llama, prompts, requests, drain,
                  out, tmp, legs, fault):
    """tp_serve_phase's legs in `tmp`, filling `out` (with `faults`), run
    by gangs of TP_RANKS ranks each (`TP_GANGS`, their gloo collectives
    host-bound, so they overlap): the first starts at once, beside the
    unsharded engines here (llama3-8b on the same seed, then its
    CTX_LAYERS-layer cut, then mixtral-8x7b at the moe leg's depth) and
    the NCCL refusal's ranks; the second once those have freed the card,
    the third once the first has ended. Returns the K1/K2 launches per
    rank by leg."""
    import numpy as np

    from skypilot_tpu_torch import models as models_lib
    moe_all = moe_prompts(np.random.default_rng(9))
    moe_in = moe_all[1:]
    # The fsdp and context legs' prompts, from generators of their own.
    vocab = models_lib.resolve(TP_MODEL)[1].vocab_size
    fsdp_rng = np.random.default_rng(17)
    fsdp_prompts = [prompt_tokens(fsdp_rng, int(n), vocab) for n in
                    fsdp_rng.integers(FSDP_PROMPT_LENGTHS[0],
                                      FSDP_PROMPT_LENGTHS[1] + 1,
                                      size=FSDP_PROMPTS)]
    ctx_prompt = prompt_tokens(np.random.default_rng(16), CTX_PROMPT, vocab)
    spec = {'model': TP_MODEL, 'mesh': TP_MESH, 'device': DEV,
            'fsdp': {'mesh': FSDP_MESH, 'prompts': fsdp_prompts,
                     'new': FSDP_NEW},
            'context': {'mesh': CTX_MESH, 'layers': CTX_LAYERS,
                        'engine_kw': CTX_KW, 'prompt': ctx_prompt,
                        'new': CTX_NEW},
            'engine_kw': TP_KW, 'prompts': prompts, 'new': TP_NEW,
            'server_requests': [(p, n) for p, n, _ in requests] + [drain],
            'clock_probe': TP_CLOCK_PROBE, 'legs': list(legs),
            'fault': fault,
            'moe': {'model': MOE_MODEL, 'layers': MOE_MESH_LAYERS,
                    'mesh': MOE_MESH, 'engine_kw': MOE_KW,
                    'prompts': moe_in, 'new': MOE_NEW, 'sync_seed': 11},
            'setup': TP_RANK_SETUP and TP_RANK_SETUP[0],
            'setup_path': TP_RANK_SETUP and TP_RANK_SETUP[1]}
    gang_legs = [[leg for leg in gang if leg in legs] for gang in TP_GANGS]
    gang_dirs = [os.path.join(tmp, f'gang{g}') for g in range(len(TP_GANGS))]
    waits = {}

    def start_gang(g):
        if not gang_legs[g]:
            return
        os.makedirs(gang_dirs[g])
        path = os.path.join(gang_dirs[g], 'spec.json')
        with open(path, 'w') as f:
            json.dump({**spec, 'legs': gang_legs[g], 'dir': gang_dirs[g]}, f)
        code = ('import sys, chip_smoke; '
                'sys.exit(chip_smoke.tp_rank_main(sys.argv[1]))')
        port = free_port()
        waits[g] = start_ranks(lambda r: [sys.executable, '-c', code, path],
                               lambda r: tp_gang_env(port, r), gang_dirs[g],
                               'rank', timeout=1200)

    start_gang(0)
    nccl_check = tp_nccl_refusal(tmp) if 'server' in legs else None
    # The unsharded references, beside the ranks: llama3-8b on the bf16
    # and int8 legs' prompts and on the fsdp leg's.
    ref, host_params, config = {}, None, None
    t0 = time.perf_counter()
    llama_keys = [k for k in ('bf16', 'int8') if k in legs]
    ref_runs = {'bf16': ('none', prompts, TP_NEW),
                'int8': ('int8', prompts, TP_NEW),
                'fsdp': ('none', fsdp_prompts, FSDP_NEW)}
    ref_keys = [k for k in ref_runs if k in legs]
    if ref_keys:
        engine = inference.build_engine(TP_MODEL, device=DEV, seed=0,
                                        kv_quant='none', **TP_KW)
        params, config = engine.params, engine.config
        del engine
        ref['param_bytes'] = sum(t.numel() * t.element_size()
                                 for t in tree_leaves(params))
        ref['layer_bytes'] = sum(
            t.numel() * t.element_size()
            for t in params['layers'].values()) // config.num_layers
        for key in ref_keys:
            quant, ref_prompts, new = ref_runs[key]
            engine = inference.InferenceEngine(
                params, config, kv_quant=quant, device=DEV, **TP_KW)
            seen = capture_first_logits(engine)
            tokens, run = run_greedy(torch, inference, engine, ref_prompts,
                                     new)
            ref[key] = {'tokens': tokens,
                        'logits': torch.cat(seen).float().cpu(),
                        'decode_tok_s': run['decode_tok_s']}
            del engine, seen
        # The near-tie rule's dense forward needs the params after the
        # ranks: they wait on the host.
        host_params = eng._to_device(params, torch.device('cpu'))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    out['unsharded_s'] = time.perf_counter() - t0
    ctx_ref = None
    if 'context' in legs:
        t0 = time.perf_counter()
        ctx_ref = tp_context_reference(torch, inference, eng, ctx_prompt)
        out['context_unsharded_s'] = time.perf_counter() - t0
    moe_ref = None
    if 'moe' in legs:
        t0 = time.perf_counter()
        moe_ref = tp_moe_reference(torch, inference, moe_in)
        out['moe_unsharded_s'] = time.perf_counter() - t0
    if nccl_check is not None:
        out['nccl_refusal'] = nccl_check()
    start_gang(1)
    t0 = time.perf_counter()
    ranks = [{} for _ in range(TP_RANKS)]
    out['gangs'] = {}

    def collect(g):
        if g not in waits:
            return
        rcs, tails, ranks_s = waits[g]()
        if rcs != [0] * TP_RANKS:
            raise AssertionError(f'tp ranks failed: rcs {rcs}: {tails}')
        out['gangs'][g] = {'legs': gang_legs[g], 'ranks_s': ranks_s,
                           'ended_s': time.perf_counter() - t0}
        for r in range(TP_RANKS):
            with open(os.path.join(gang_dirs[g], f'rank{r}.json')) as f:
                got = json.load(f)
            # Each gang's own rank facts beside its legs' readings.
            ranks[r].update({**got, **{f'{k}_gang{g}': got.get(k) for k in (
                'init_s', 'peak_mem_gb')}})

    # The gangs after the second take the card the first one frees: three
    # gangs beside the references do not fit its 80 GB.
    collect(0)
    for g in range(2, len(TP_GANGS)):
        start_gang(g)
    for g in range(1, len(TP_GANGS)):
        collect(g)
    out['ranks_wait_s'] = time.perf_counter() - t0
    faults, launches, diverged = [], {}, []
    logits_dir = {leg: gang_dirs[g] for g, gang in enumerate(gang_legs)
                  for leg in gang}
    for key in llama_keys:
        got = torch.load(os.path.join(logits_dir[key], f'logits_{key}.pt'))
        r0 = ranks[0][key]
        reading = {
            'logits_rel_err': rel_err(torch, got, ref[key]['logits']),
            'launches_per_rank': [r[key]['launches'] for r in ranks],
            'expected_launches': r0['expected_launches'],
            'ranks_tokens_equal': all(r[key]['tokens'] == r0['tokens']
                                      for r in ranks),
            'tokens_equal_unsharded': r0['tokens'] == ref[key]['tokens'],
            **{k: r0[k] for k in ('prefill_s', 'prefill_tok_s',
                                  'decode_s', 'decode_tok_s',
                                  'decode_dispatches',
                                  'ms_per_dispatch', 'wall_s')},
            'unsharded_decode_tok_s': ref[key]['decode_tok_s']}
        if not reading['logits_rel_err'] < TOL_LOGITS_REL:
            faults.append(f'{key} logits rel err '
                          f'{reading["logits_rel_err"]}')
        if any(n != r0['expected_launches']
               for n in reading['launches_per_rank']):
            faults.append(f'{key} launches {reading["launches_per_rank"]}'
                          f' != {r0["expected_launches"]} per rank')
        if not reading['ranks_tokens_equal']:
            faults.append(f'{key}: the ranks\' tokens differ')
        launches[key] = reading['launches_per_rank']
        out[key] = reading
        # Near-ties: a divergence from the unsharded tokens passes only
        # where both tokens lie within TOL_SPEC_GAP of the top logit.
        diverged += [(key, i, ref[key]['tokens'][i], r0['tokens'][i])
                     for i in range(len(prompts))
                     if r0['tokens'][i] != ref[key]['tokens'][i]]
    if 'spec' in legs:
        faults += tp_spec_checks(ranks, out, launches, diverged)
    if 'migration' in legs:
        faults += tp_migration_checks(ranks, out, config, prompts,
                                      launches)
    if 'moe' in legs:
        faults += tp_moe_checks(torch, ranks, out, launches, moe_ref,
                                moe_in, logits_dir['moe'])
    del moe_ref
    if 'fsdp' in legs:
        faults += tp_fsdp_checks(torch, ranks, out, launches, ref,
                                 fsdp_prompts, logits_dir['fsdp'], diverged)
    if 'context' in legs:
        faults += tp_context_checks(torch, llama, ranks, out, launches,
                                    ctx_ref, ctx_prompt,
                                    logits_dir['context'])
    del ctx_ref
    if llama_keys:
        tp_llama_summary(ranks, out, llama_keys, config)
        if ranks[0]['local_heads'] * TP_RANKS != config.num_heads:
            faults.append(f'rank heads {out["per_rank"]}')
    if 'server' in legs:
        out['server_requests_ranks_equal'] = all(
            r['server_requests'] == ranks[0]['server_requests']
            for r in ranks)
        if not out['server_requests_ranks_equal']:
            faults.append('the ranks\' server-leg tokens differ')
        t0 = time.perf_counter()
        out['server'] = tp_server_leg(torch, requests,
                                      ranks[0]['server_requests'], tmp,
                                      drain=drain)
        out['server']['leg_s'] = time.perf_counter() - t0
        faults += [f'server: {f}' for f in out['server'].pop('faults')]
    blob = out.get('server', {}).get('drain', {}).pop('blob', None)
    if diverged or blob is not None:
        # The dense forward of the near-tie rule, and the drained
        # stream's blob restored on an unsharded engine.
        params = eng._to_device(host_params, torch.device(DEV))
        for key in sorted({d[0] for d in diverged}):
            source = fsdp_prompts if key == 'fsdp' else prompts
            out[key]['divergences'] = [divergence_reading(
                torch, llama, params, config, source[i], want, got)
                for k, i, want, got in diverged if k == key]
            faults += [f'{key}: {f}' for f in divergence_faults(
                out[key]['divergences'])]
        if blob is not None:
            faults += tp_drain_restore(torch, inference, params, config,
                                       blob, drain, out, ranks, llama)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    out['faults'] = faults
    return launches


def tp_fsdp_checks(torch, ranks, out, launches, ref, prompts, tmp,
                   diverged):
    """The fsdp leg's gates against the unsharded engine on the same
    flags and prompts: first-token logits within TOL_LOGITS_REL, the
    ranks' tokens equal and equal to the unsharded ones up to near-ties
    (added to `diverged`), K1 launches per rank the expected prefill
    launches (K2 none), each rank's weight bytes half the unsharded
    engine's; the collectives' share of the prefill and of decode, and
    each rank's peak memory beside the unsharded weights' half and one
    gathered layer."""
    faults = []
    r0 = ranks[0]['fsdp']
    got = torch.load(os.path.join(tmp, 'logits_fsdp.pt'))
    want = ref['fsdp']['tokens']
    clock = r0['collectives']
    reading = {
        'model': TP_MODEL, 'mesh': FSDP_MESH, **TP_KW,
        'prompt_lengths': [len(p) for p in prompts],
        'max_new_tokens': FSDP_NEW,
        'logits_rel_err': rel_err(torch, got, ref['fsdp']['logits']),
        'launches_per_rank': [r['fsdp']['launches'] for r in ranks],
        'expected_launches': r0['expected_launches'],
        'ranks_tokens_equal': all(r['fsdp']['tokens'] == r0['tokens']
                                  for r in ranks),
        'tokens_equal_unsharded': sum(a == b for a, b in zip(
            r0['tokens'], want)),
        'weight_bytes_per_rank': [r['fsdp']['weight_bytes'] for r in ranks],
        'unsharded_weight_bytes': ref['param_bytes'],
        'gathered_layer_bytes': ref['layer_bytes'],
        'local_embed': r0['local_embed'],
        'peak_mem_gb_per_rank': [r['fsdp']['peak_mem_gb'] for r in ranks],
        **{k: r0[k] for k in ('init_s', 'prefill_s', 'prefill_tok_s',
                              'decode_s', 'decode_tok_s', 'wall_s')},
        'collectives': {**clock, 'share_of_prefill': clock['prefill_s']
                        / r0['prefill_s'],
                        'share_of_decode': clock['decode_s']
                        / max(r0['decode_s'], 1e-9)}}
    if not reading['logits_rel_err'] < TOL_LOGITS_REL:
        faults.append(f'fsdp logits rel err {reading["logits_rel_err"]}')
    if any(n != r0['expected_launches']
           for n in reading['launches_per_rank']) or any(
               r['fsdp']['other_launches'] for r in ranks):
        faults.append(f'fsdp launches {reading["launches_per_rank"]} != '
                      f'{r0["expected_launches"]} per rank')
    if not reading['ranks_tokens_equal']:
        faults.append('fsdp: the ranks\' tokens differ')
    if any(2 * b != ref['param_bytes']
           for b in reading['weight_bytes_per_rank']):
        faults.append(f'fsdp weight bytes a rank '
                      f'{reading["weight_bytes_per_rank"]}, not half of '
                      f'{ref["param_bytes"]}')
    diverged += [('fsdp', i, want[i], r0['tokens'][i])
                 for i in range(len(want)) if r0['tokens'][i] != want[i]]
    launches['fsdp'] = reading['launches_per_rank']
    out['fsdp'] = reading
    return faults


def tp_context_reference(torch, inference, eng, prompt):
    """The context leg's reference: an unsharded engine of CTX_LAYERS
    layers on the same seed and CTX_KW, the long prompt greedy on bf16
    then int8 KV: tokens, first-token logits, cache bytes, and the bf16
    cache's layer-0 K row of the prompt's slot. Returns (those by key,
    the params on the host, the config)."""
    with depth_cut(TP_MODEL, CTX_LAYERS) as name:
        engine = inference.build_engine(name, device=DEV, seed=0,
                                        kv_quant='none', **CTX_KW)
    params, config = engine.params, engine.config
    ref = {}
    for key in ('bf16', 'int8'):
        if key == 'int8':
            del engine
            gc.collect()
            torch.cuda.empty_cache()
            engine = inference.InferenceEngine(params, config, device=DEV,
                                               kv_quant='int8', **CTX_KW)
        seen = capture_first_logits(engine)
        tokens, run = run_greedy(torch, inference, engine, [prompt],
                                 CTX_NEW)
        ref[key] = {'tokens': tokens[0],
                    'logits': torch.cat(seen).float().cpu(),
                    'cache_bytes': kv_bytes(engine),
                    'wall_s': run['wall_s']}
        if key == 'bf16':
            ref[key]['k_row'] = engine.state.cache['k'][0, 0].float().cpu()
        del seen
    del engine
    host = eng._to_device(params, torch.device('cpu'))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return ref, host, config


def tp_context_checks(torch, llama, ranks, out, launches, ctx_ref, prompt,
                      tmp):
    """The context leg's gates against its unsharded engine, on bf16 and
    int8 KV: first-token logits within TOL_LOGITS_REL, the ranks' tokens
    equal and equal to the unsharded ones up to near-ties (a dense
    forward on the host params), K1 (K2) launches per rank the expected
    prefill launches and no other kernel's, each rank's cache half the
    unsharded cache's bytes and positions; on bf16 the ranks' layer-0 K
    rows, side by side, within TOL_CTX_SPAN_REL of the unsharded row over
    the prompt's positions and those of the decoded tokens both share;
    the collectives' share."""
    faults = []
    ref, host_params, config = ctx_ref
    reading = {'model': TP_MODEL, 'layers': CTX_LAYERS, 'mesh': CTX_MESH,
               **CTX_KW, 'prompt_len': len(prompt),
               'max_new_tokens': CTX_NEW,
               'peak_mem_gb_per_rank': [r['context']['peak_mem_gb']
                                        for r in ranks],
               'init_s': ranks[0]['context']['init_s']}
    diverged = []
    for key in ('bf16', 'int8'):
        r0 = ranks[0]['context'][key]
        got = torch.load(os.path.join(tmp, f'logits_context_{key}.pt'))
        clock = r0['collectives']
        rk = {
            'logits_rel_err': rel_err(torch, got, ref[key]['logits']),
            'launches_per_rank': [r['context'][key]['launches']
                                  for r in ranks],
            'offset_launches_per_rank': [r['context'][key]['offset_launches']
                                         for r in ranks],
            'expected_launches': r0['expected_launches'],
            'ranks_tokens_equal': all(r['context'][key]['tokens']
                                      == r0['tokens'] for r in ranks),
            'tokens_equal_unsharded': r0['tokens'] == ref[key]['tokens'],
            'cache_bytes_per_rank': [r['context'][key]['cache_bytes']
                                     for r in ranks],
            'unsharded_cache_bytes': ref[key]['cache_bytes'],
            'cache_positions_per_rank': [r['context'][key]['cache_positions']
                                         for r in ranks],
            **{k: r0[k] for k in ('prefill_s', 'decode_s', 'decode_tok_s',
                                  'wall_s')},
            'unsharded_wall_s': ref[key]['wall_s'],
            'collectives': {**clock, 'share_of_prefill': clock['prefill_s']
                            / r0['prefill_s'],
                            'share_of_decode': clock['decode_s']
                            / max(r0['decode_s'], 1e-9)}}
        if not rk['logits_rel_err'] < TOL_LOGITS_REL:
            faults.append(f'context {key} logits rel err '
                          f'{rk["logits_rel_err"]}')
        if any(n != r0['expected_launches']
               for n in rk['launches_per_rank']) or any(
                   r['context'][key]['other_launches'] for r in ranks):
            faults.append(f'context {key} launches '
                          f'{rk["launches_per_rank"]} != '
                          f'{r0["expected_launches"]} per rank')
        if not rk['ranks_tokens_equal']:
            faults.append(f'context {key}: the ranks\' tokens differ')
        if any(2 * b != ref[key]['cache_bytes']
               for b in rk['cache_bytes_per_rank']) or any(
                   2 * n != CTX_KW['max_seq_len']
                   for n in rk['cache_positions_per_rank']):
            faults.append(f'context {key}: cache bytes a rank '
                          f'{rk["cache_bytes_per_rank"]} and positions '
                          f'{rk["cache_positions_per_rank"]}, not half the '
                          f'unsharded {ref[key]["cache_bytes"]}')
        if not rk['tokens_equal_unsharded']:
            diverged.append((key, ref[key]['tokens'], r0['tokens']))
        reading[key] = rk
        launches[f'context_{key}'] = rk['launches_per_rank']
    rows = torch.cat([torch.load(os.path.join(tmp, f'krow{r}.pt'))
                      for r in range(len(ranks))])
    # The prompt's positions and those of the decoded tokens both sides
    # share (a near-tie's token has its own key).
    j = first_divergence(ref['bf16']['tokens'],
                         ranks[0]['context']['bf16']['tokens'])
    n = len(prompt) + min(CTX_NEW - 1, CTX_NEW if j is None else j)
    reading['span_positions'] = n
    want = ref['bf16']['k_row'][:n]
    reading['span_rel_err'] = float((rows[:n] - want).abs().max()
                                    / want.abs().max())
    if not reading['span_rel_err'] < TOL_CTX_SPAN_REL:
        faults.append(f'context: the spans\' layer-0 K rows off the '
                      f'unsharded row by {reading["span_rel_err"]}')
    if diverged:
        from skypilot_tpu_torch.inference import engine as eng
        dev_params = eng._to_device(host_params, torch.device(DEV))
        for key, want_tokens, have in diverged:
            reading[key]['divergence'] = divergence_reading(
                torch, llama, dev_params, config, prompt, want_tokens, have)
            faults += [f'context {key}: {f}' for f in divergence_faults(
                [reading[key]['divergence']])]
        del dev_params
        gc.collect()
        torch.cuda.empty_cache()
    out['context'] = reading
    return faults


def tp_llama_summary(ranks, out, keys, config):
    """The collectives' share of the prefill and of decode, read in the
    run (rank 0's clock against its engine's own seconds), the
    replicated scheduler's host time (each rank's plan hashes, rank 0's
    publishes) against the run's wall time, what the clock's
    synchronizes add, and each rank's cut and peak memory."""
    for key in keys:
        clock = ranks[0][key]['collectives']
        out[key]['collectives'] = {
            **clock, 'share_of_prefill': clock['prefill_s']
            / out[key]['prefill_s'], 'share_of_decode': clock[
                'decode_s'] / out[key]['decode_s']}
        sched = [r[key]['scheduler'] for r in ranks]
        out[key]['scheduler'] = {
            'per_rank': sched,
            'share_of_wall': (sched[0]['plan_s'] + sched[0]['publish_s'])
            / out[key]['wall_s']}
    if 'clock_overhead' in ranks[0]:
        over = ranks[0]['clock_overhead']
        out['clock_overhead'] = {**over, **{
            f'share_of_{key}_wall': over['added_ms'] * 1e-3 * (
                out[key]['collectives']['prefill_calls']
                + out[key]['collectives']['decode_calls'])
            / out[key]['wall_s'] for key in keys}}
    out['per_rank'] = [{k: r.get(k) for k in (
        'rank', 'backend', 'device', 'init_s', 'local_heads',
        'local_kv_heads', 'local_mlp', 'local_vocab', 'peak_mem_gb')}
        for r in ranks]


def tp_spec_checks(ranks, out, launches, diverged):
    """The spec leg's gates: K1 launches per rank the target's expected
    prefill launches (and K2 none), the ranks' tokens equal, acceptance
    at least TOL_SPEC_ACCEPT; its divergences from the ranks' own bf16
    tokens join `diverged` (the near-tie rule)."""
    faults = []
    r0 = ranks[0]['spec']
    reading = {
        'launches_per_rank': [r['spec']['launches'] for r in ranks],
        'expected_launches': r0['expected_launches'],
        'ranks_tokens_equal': all(r['spec']['tokens'] == r0['tokens']
                                  for r in ranks),
        'tokens_equal_bf16': sum(a == b for a, b in zip(
            r0['tokens'], ranks[0]['bf16']['tokens'])),
        'draft_local_heads': [r['spec']['draft_local_heads']
                              for r in ranks],
        **{k: r0[k] for k in (
            'spec_k', 'spec_fuse_rounds', 'wall_s', 'decode_s',
            'decode_tok_s', 'spec_dispatches', 'spec_rounds',
            'ms_per_round', 'tokens_per_round', 'proposed_tokens',
            'accepted_tokens', 'acceptance', 'accepted_per_round')
           if k in r0},
        'decode_tok_s_vs_bf16': r0.get('decode_tok_s', 0.0)
        / out['bf16']['decode_tok_s']}
    if any(n != r0['expected_launches']
           for n in reading['launches_per_rank']) or any(
               r['spec']['other_launches'] for r in ranks):
        faults.append(f'spec launches {reading["launches_per_rank"]} != '
                      f'{r0["expected_launches"]} per rank')
    if not reading['ranks_tokens_equal']:
        faults.append('spec: the ranks\' tokens differ')
    faults += [f'spec: {f}' for f in acceptance_faults(
        r0.get('accepted_tokens', 0), r0.get('proposed_tokens', 0))]
    want = ranks[0]['bf16']['tokens']
    diverged += [('spec', i, want[i], r0['tokens'][i])
                 for i in range(len(want)) if r0['tokens'][i] != want[i]]
    launches['spec'] = reading['launches_per_rank']
    out['spec'] = reading
    return faults


def tp_migration_checks(ranks, out, config, prompts, launches):
    """The migration leg's gates: every request's tokens on every rank
    equal the ranks' own uninterrupted bf16 tokens (the migration
    phase's rule), each restore spliced on every rank the bytes its
    snapshot gathered, every blob carries all KV heads, and the handoff
    request paused."""
    faults = []
    r0 = ranks[0]['migration']
    rids = r0['rids']
    want = ranks[0]['bf16']['tokens']
    per_rank = [[r['migration']['seen'].get(str(rid)) for rid in rids]
                for r in ranks]
    equal = [sum(a == b for a, b in zip(tokens, want))
             for tokens in per_rank]
    bytes_equal = [r['migration']['restored_bytes_equal'] for r in ranks]
    launched = [r['migration']['launches'] for r in ranks]
    reading = {
        'launches_per_rank': launched,
        'expected_launches': r0['expected_launches'],
        'moved': r0['moved'], 'handoff': r0['handoff'],
        'prompt_lengths': [len(prompts[i]) for i in r0['moved']],
        'tokens_at_snapshot': r0['tokens_at_snapshot'],
        'tokens_equal_bf16_per_rank': equal,
        'restored_bytes_equal_per_rank': bytes_equal,
        'handoff_paused': r0['paused'],
        'blob_bytes': r0['blob_bytes'], 'blob_kv_heads': r0['blob_kv_heads'],
        'ms': r0['ms']}
    if any(n != len(want) for n in equal):
        faults.append(f'migration: tokens equal the bf16 leg\'s on '
                      f'{equal} of {len(want)} requests (per rank)')
    if any(v != [True] * len(r0['moved']) for v in bytes_equal):
        faults.append(f'migration: restored pages not byte-equal to the '
                      f'snapshotted ones: {bytes_equal}')
    heads = config.num_kv_heads
    if any(h != [heads] for h in r0['blob_kv_heads']):
        faults.append(f'migration: blob KV heads {r0["blob_kv_heads"]} '
                      f'!= [{heads}]')
    if not r0['paused']:
        faults.append('migration: the handoff request did not pause')
    if any(n != r0['expected_launches'] for n in launched):
        faults.append(f'migration launches {launched} != '
                      f'{r0["expected_launches"]} per rank')
    launches['migration'] = launched
    out['migration'] = reading
    return faults


def tp_moe_checks(torch, ranks, out, launches, moe_ref, prompts, tmp):
    """The moe leg's gates against its unsharded engine: first-token
    logits within TOL_LOGITS_REL, the ranks' tokens equal and equal to
    the unsharded ones up to near-ties (a dense MoE forward on the host
    params), K1 launches per rank the expected prefill launches, no host
    sync in a decode dispatch's MoE layers on any rank; the collectives'
    share of the prefill and of decode, and the peak memory a rank with
    the full depth's worked out from it."""
    from skypilot_tpu_torch.models import moe
    faults = []
    tokens, logits, run, params, config = moe_ref
    r0 = ranks[0]['moe']
    got = torch.load(os.path.join(tmp, 'logits_moe.pt'))
    clock = r0['collectives']
    layers = MOE_MESH_LAYERS
    full = moe.CONFIGS[MOE_MODEL].num_layers
    reading = {
        'model': MOE_MODEL, 'layers': layers, 'mesh': MOE_MESH,
        'logits_rel_err': rel_err(torch, got, logits),
        'launches_per_rank': [r['moe']['launches'] for r in ranks],
        'expected_launches': r0['expected_launches'],
        'ranks_tokens_equal': all(r['moe']['tokens'] == r0['tokens']
                                  for r in ranks),
        'tokens_equal_unsharded': sum(a == b for a, b in zip(
            r0['tokens'], tokens)),
        'local_experts': [r['moe']['local_experts'] for r in ranks],
        'decode_syncs': [r['moe']['decode_syncs'] for r in ranks],
        **{k: r0[k] for k in ('init_s', 'prefill_s', 'prefill_tok_s',
                              'decode_s', 'decode_tok_s', 'wall_s')},
        'unsharded': {k: run[k] for k in ('wall_s', 'decode_tok_s')},
        'collectives': {**clock, 'share_of_prefill': clock['prefill_s']
                        / r0['prefill_s'],
                        'share_of_decode': clock['decode_s']
                        / r0['decode_s']},
        'peak_mem_gb_per_rank': [r['moe']['peak_mem_gb'] for r in ranks],
        'param_gb_per_rank': r0['param_gb'],
        'layer_param_gb_per_rank': r0['layer_param_gb']}
    if r0['peak_mem_gb'] is not None:
        reading['full_depth_peak_gb_per_rank'] = (
            r0['peak_mem_gb'] + (full - layers) * r0['layer_param_gb'])
    if not reading['logits_rel_err'] < TOL_LOGITS_REL:
        faults.append(f'moe logits rel err {reading["logits_rel_err"]}')
    if any(n != r0['expected_launches']
           for n in reading['launches_per_rank']) or any(
               r['moe']['other_launches'] for r in ranks):
        faults.append(f'moe launches {reading["launches_per_rank"]} != '
                      f'{r0["expected_launches"]} per rank')
    if not reading['ranks_tokens_equal']:
        faults.append('moe: the ranks\' tokens differ')
    if reading['local_experts'] != [
            moe.CONFIGS[MOE_MODEL].num_experts // TP_RANKS] * TP_RANKS:
        faults.append(f'moe experts a rank {reading["local_experts"]}')
    diverged = [(i, tokens[i], r0['tokens'][i]) for i in range(len(tokens))
                if r0['tokens'][i] != tokens[i]]
    if diverged:
        from skypilot_tpu_torch.inference import engine as eng
        dev_params = eng._to_device(params, torch.device(DEV))
        reading['divergences'] = [divergence_reading(
            torch, moe, dev_params, config, prompts[i], want, have)
            for i, want, have in diverged]
        faults += [f'moe: {f}' for f in divergence_faults(
            reading['divergences'])]
        del dev_params
        gc.collect()
        torch.cuda.empty_cache()
    launches['moe'] = reading['launches_per_rank']
    out['moe'] = reading
    return faults


def tp_drain_restore(torch, inference, params, config, blob, drain, out,
                     ranks, llama):
    """The drained stream's blob restored on an unsharded engine built
    from the same params: the continued tokens against the sharded
    engine's for that request (the ranks' server leg) under the
    divergence rule, the streamed tokens a prefix of them."""
    faults = []
    engine = inference.InferenceEngine(params, config, device=DEV,
                                       kv_quant='none', **TP_KW)
    t0 = time.perf_counter()
    rid = engine.restore_request(blob)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = engine.run_to_completion()[rid]
    del engine
    want = ranks[0]['server_requests'][-1]
    streamed = out['server']['drain']['streamed']
    reading = divergence_reading(torch, llama, params, config, drain[0],
                                 want, got)
    out['server']['drain'].update(
        blob_bytes=len(blob), restore_ms=restore_s * 1e3,
        tokens=len(got), equal_sharded=got == want, divergence=reading)
    if got[:len(streamed)] != streamed:
        faults.append(f'drain: restored tokens {got[:len(streamed)]} do '
                      f'not continue the stream {streamed}')
    faults += [f'drain: {f}' for f in divergence_faults([reading])]
    return faults


# The mesh_train phase: bench-8b at full width (4096 / 14336, 32 / 8
# heads, d 128, vocab 32768), depth cut to MT_LAYERS of its 5 layers,
# trained by two ranks sharing the card over gloo (NCCL refuses two
# ranks on one GPU), one gang for every leg, each leg through
# `train.loop.main` with its own --mesh (each rank rebuilds the mesh):
# fsdp=-1 (saving its last step), tensor=2 (16 / 4 heads a rank) and
# its resume of the fsdp leg's checkpoint for one more step, then
# context=2 --attention ring (2048 local tokens, K1/K3/K4 per hop).
# Global batch MT_BATCH x MT_SEQ, bf16, MT_STEPS steps a leg (3 read the
# phase at 104 s against the ~90 aimed at) at MT_LR with a warmup of
# MT_WARMUP steps; the batch is `synthetic_batch`'s (seed 1) and the
# params the seed-0 draw, which the parent also trains unsharded.
MT_MODEL = 'bench-8b'
MT_LAYERS = 2
MT_BATCH = 2
MT_SEQ = 4096
MT_STEPS = 2
MT_LR = TRAIN_LR
# No warmup, so step 1 updates at MT_LR (a warmup starts at lr 0) and
# step 2's loss and grad norm read an update made on the shards, the
# resumed step 3 one made before the save. `train.loop` takes no warmup
# flag (nor does the reference's): the ranks set the trainer's default.
# The cosine decays over max_steps: MT_STEPS on the legs, MT_STEPS + 1
# on the resume, and the unsharded steps follow the same two schedules.
MT_WARMUP = 0
MT_RANKS = 2
# (leg, --mesh, --attention, the kernel calls each rank makes a layer
# per pass as (causal, unmasked): the diagonal block, and on the later
# context rank a past block)
MT_LEGS = (('fsdp', 'fsdp=-1', None, ((1, 0), (1, 0))),
           ('tensor', 'tensor=2', None, ((1, 0), (1, 0))),
           ('ring', 'context=2', 'ring', ((1, 0), (1, 1))))
# The probe: a loss whose mask is 1 only on the MT_PROBE positions just
# before the middle of each row, where the ring's two context ranks
# meet: the last of them is the earlier rank's last position, whose
# target is the later rank's first token. With one position the probe
# is that target's loss alone (a ring that masks it reads 0).
MT_PROBE = 1
# The ring's K1/K3/K4 shapes a rank launches per layer: the diagonal
# block (causal) and the past block (no mask), B x 2048 local tokens.
MT_RING_SHAPES = (('ring_diag', True), ('ring_past', False))
# A `module:function` each rank process calls first (a CPU rehearsal's
# counting stand-in for the kernels), with the directory it lives in.
MT_RANK_SETUP = None
# The limits, each against the unsharded one-device flash steps on the
# same seed weights and batch. Sound readings on the H100 (700 W), 2
# steps a leg without warmup: loss <= 5.4e-5 relative, grad norm <=
# 1.6e-3 (both the ring's step 2: a full-lr AdamW step moves each
# weight by about lr times its gradient's sign, so the hops' rounding
# flips near-zero gradients' updates), the probe <= 0.016.
# mesh_fault_check.py's faults read, at step 2: loss 0.049 / 0.038 (the
# batch reductions dropped, fsdp / ring), 0.052 (the column all-reduce
# dropped), 0.20 (the ring backward on the local lse); grad norm
# 0.10-0.29, 0.41-0.49 and 8.6e4 (then non-finite); the probe 1.5-1.9,
# 2.1 and 1.0. The boundary target masked reads the probe at 0 (its
# only target gone) against 9.3, its loss and grad norm 8.9e-5 and
# 2.5e-3, within sound reach. Each limit sits between the sound maximum
# and the least fault reading it is there to catch, about their
# geometric mean.
TOL_MT_LOSS_REL = 1e-3       # |loss - unsharded| / unsharded, a step
TOL_MT_NORM_REL = 1e-2       # |grad norm - unsharded| / unsharded
TOL_MT_PROBE = 0.1           # |probe loss - unsharded probe loss|
# The two legs after MT_LEGS, in the same ranks (MT_EXTRA_LEGS):
# - 'pipe': the same bench-8b cut (MT_LAYERS layers, one a stage) through
#   `pipeline.llama_pipeline_forward` over MT_PIPE_MESH, the global batch
#   MT_BATCH x MT_SEQ in MT_MICROBATCHES microbatches, each stage holding
#   only its layers of the seed-0 draw; one forward and backward of the
#   port's cross-entropy (`llama.cross_entropy`), its gradients through
#   the trainer's reduction (`reduce_grads_`: none over `pipe`). Held
#   against the unsharded `llama.forward` of the same weights and batch
#   (the parent's, before its first step): the logits at every
#   MT_LOGIT_STRIDE-th position of each row (max |a - b| / max |b|), the
#   loss, and the norm of every gradient leaf (each layer's on its
#   stage), relative; the replicated leaves' gradients (embed, final
#   norm, head) bit-equal across the stages.
# - 'expert': mixtral-8x7b at full width cut to MT_EXPERT_LAYERS layers,
#   `train.loop.main --mesh expert=2 --attention flash`, MT_EXPERT_BATCH
#   x MT_SEQ, MT_STEPS steps without warmup, each rank holding 4 of the 8
#   experts; against the unsharded steps the parent runs on the same
#   seed and schedule (after its bench-8b steps, and before this leg
#   starts: the ranks wait for its marker, so the two mixtral states
#   never share the card), with the mesh limits.
MT_EXTRA_LEGS = ('pipe', 'expert')
MT_PIPE_MESH = 'pipe=2'
MT_MICROBATCHES = 2
MT_LOGIT_STRIDE = 64
MT_EXPERT_MODEL = 'mixtral-8x7b'
MT_EXPERT_LAYERS = 2
MT_EXPERT_BATCH = 1
MT_EXPERT_MESH = 'expert=2'
# The pipe leg's limits. Sound on the H100 (700 W): the logits and the
# loss bit-equal to the unsharded forward's (0.0), each gradient leaf's
# norm within 9.3e-5 (the microbatches' gradients summed in f32 against
# one product over the batch). mesh_fault_check.py's faults read: the
# logits 1.29-1.33 (stages swapped, the recorded microbatch off by one),
# the loss 4.8e-4 and 9.3e-4 (the same two), a leaf's norm 5.9e-3 to 1.0
# (off by one 5.9e-3, swapped 0.035, the embedding's left on stage 0
# 1.0, the replicated leaves summed over pipe 1.0). The logits limit
# allows a sound reading four bf16 steps (2^-8 each) off, should another
# cuBLAS kernel serve the microbatch's rows; the loss limit sits between
# the mesh legs' sound reach (5.4e-5) and the least fault (4.8e-4), and
# the norm limit between the sound 9.3e-5 and the least fault 5.9e-3,
# about their geometric means.
TOL_PIPE_LOGITS_REL = 0.02   # pipelined logits, max|a-b| / max|b|
TOL_PIPE_LOSS_REL = 1.5e-4   # |loss - unsharded| / unsharded
TOL_PIPE_NORM_REL = 1e-3     # each gradient leaf's norm, relative


def mt_plant(name):
    """Plant one of mesh_fault_check.py's faults in this rank process
    (None plants nothing):
    - 'batch_reduce': the gradient reductions over the batch axes left
      out (the FSDP reduce-scatter keeps this rank's part unsummed, the
      data/context all-reduce does nothing);
    - 'column_allreduce': the column-parallel inputs' backward
      all-reduce left out (`copy_to` is the identity both ways);
    - 'boundary_masked': every context rank's last target masked, the
      boundary's included;
    - 'local_lse': the ring backward run on the diagonal hop's lse
      instead of the merged one."""
    if name is None:
        return
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.parallel import collectives
    from skypilot_tpu_torch.train import trainer
    if name == 'batch_reduce':
        collectives.reduce_scatter = lambda t, group, dim: t.chunk(
            collectives.group_size(group), dim=dim)[
                collectives.group_rank(group)].contiguous()
        trainer.reduce_grads_ = lambda grads, cuts, mesh: None
    elif name == 'column_allreduce':
        collectives.copy_to = lambda x, group: x
    elif name == 'boundary_masked':
        real = llama.loss_fn

        def loss_fn(params, batch, config):
            mask = batch['mask'].clone()
            mask[:, -1] = 0.0
            return real(params, {**batch, 'mask': mask}, config)
        llama.loss_fn = loss_fn
    elif name == 'local_lse':
        merge = fa._merge

        def local(o_acc, lse_acc, o, lse):
            o_new, lse_new = merge(o_acc, lse_acc, o, lse)
            return o_new, lse if lse_acc is None else lse_acc
        fa._merge = local
    elif name in MT_PIPE_FAULTS:
        mt_plant_pipe(name)
    elif name in MT_EXPERT_FAULTS:
        mt_plant_expert(name)
    else:
        raise ValueError(f'unknown mesh fault {name!r}')


MT_PIPE_FAULTS = ('stages_swapped', 'microbatch_off_by_one',
                  'embed_stage0_only', 'head_summed_twice')
MT_EXPERT_FAULTS = ('expert_not_reduced', 'topk_local')


def mt_plant_pipe(name):
    """The pipe leg's faults:
    - 'stages_swapped': each stage holds the other stage's layers (the
      stack runs layer 1 before layer 0);
    - 'microbatch_off_by_one': the last stage's outputs recorded one
      microbatch on (microbatch j's output in j + 1's place);
    - 'embed_stage0_only': the stack's input gradient left on stage 0
      (no broadcast: the embedding's gradient 0 on the later stage);
    - 'head_summed_twice': the replicated leaves' gradients (the
      head's, the final norm's, the embedding's) all-reduced over `pipe`
      by the trainer's reduction, as if `pipe` were a gradient axis: each
      summed over the two stages."""
    import numpy as np
    import torch

    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import pipeline, sharding
    if name == 'stages_swapped':
        real = sharding.stage_shard

        def swapped(mesh, shard=None, rank=None):
            rank = mesh.rank if rank is None else rank
            other = mesh_lib.index_along(mesh.spec, rank, 'pipe')
            size = mesh.spec.sizes()['pipe']
            coords = mesh_lib.coords_of(mesh.spec, rank)
            coords['pipe'] = size - 1 - other
            flip = int(np.ravel_multi_index(
                tuple(coords[a] for a in mesh_lib.AXIS_ORDER),
                mesh.spec.shape()))
            return real(mesh, shard, rank=flip)
        sharding.stage_shard = swapped
    elif name == 'microbatch_off_by_one':
        real = pipeline._forward

        def shifted(s, x, leaves):
            out, inputs = real(s, x, leaves)
            mb = out.reshape(s.microbatches, -1, *out.shape[1:])
            return mb.roll(1, 0).reshape(out.shape), inputs
        pipeline._forward = shifted
    elif name == 'embed_stage0_only':
        real = pipeline._input_grads

        def stage0(s, dx, like):
            got = real(s, dx, like)
            return got if s.stage == 0 else torch.zeros_like(got)
        pipeline._input_grads = stage0
    elif name == 'head_summed_twice':
        from skypilot_tpu_torch.train import trainer
        real = trainer._reduce_axes

        def with_pipe(shard):
            cut = {a for c in shard.cuts for a in c.axes}
            return real(shard) + (() if 'pipe' in cut else ('pipe',))
        trainer._reduce_axes = with_pipe


def mt_plant_expert(name):
    """The expert leg's faults:
    - 'expert_not_reduced': the expert outputs not all-reduced over
      `expert` (each rank combines its own experts' outputs only);
    - 'topk_local': the router's logits not gathered over `expert`: each
      rank's own experts' logits with the others' at -1e30, so each rank
      takes its top-k over its own experts."""
    import torch

    from skypilot_tpu_torch.parallel import collectives
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    op = {'expert_not_reduced': 'reduce_from',
          'topk_local': 'gather_from'}[name]
    real = getattr(collectives, op)

    def planted(x, group, *args):
        mesh = mesh_lib.current()
        if mesh is None or group is None or group is not mesh.group(
                'expert'):
            return real(x, group, *args)
        if name == 'expert_not_reduced':
            return x
        parts = [torch.full_like(x, -1e30)
                 for _ in range(collectives.group_size(group))]
        parts[collectives.group_rank(group)] = x
        return torch.cat(parts, dim=args[0])
    setattr(collectives, op, planted)


def mt_probe_batch(torch, trainer, cfg, mesh, probe):
    """The probe: `synthetic_batch`'s tokens, the mask 1 only on the
    `probe` (MT_PROBE) positions just before each row's middle; this
    rank's cut."""
    batch = trainer.synthetic_batch(cfg, mesh.device)
    mask = torch.zeros_like(batch['mask'])
    mid = cfg.seq_len // 2
    mask[:, mid - probe:mid] = 1.0
    cut = trainer.batch_shardings(mesh)
    return {'tokens': cut['tokens'](batch['tokens']).contiguous(),
            'mask': cut['mask'](mask).contiguous()}


def mt_digests(torch, trainer, state, cfg, mesh):
    """sha256 of every param leaf no mesh axis cuts (bf16 as its bits),
    by leaf index: what replicated leaves must agree on across ranks."""
    import hashlib

    from skypilot_tpu_torch.models import llama
    cuts = trainer.tree_leaves(llama.shard_tree(cfg.model_config(), mesh))
    out = {}
    for i, (leaf, shard) in enumerate(zip(
            trainer.tree_leaves(state['params']), cuts)):
        if shard.cuts:
            continue
        t = leaf.detach()
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        out[str(i)] = hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
    return out


def mt_leg(torch, argv, cuda):
    """One run of `train.loop.main(argv)` in this rank: per step its loss,
    grad norm and seconds (synchronized), the time its collectives took
    (`parallel.collectives`' ops, each timed from a synchronize), the
    checkpoint save's and restore's seconds and bytes, the seconds of
    the set-up before the first step (`setup_s`: the mesh, the train
    state, the --checkpoint import) and of the whole run (`main_s`),
    K1/K2/K3/K4 launches by causal flag, the peak memory, and (returned
    beside the reading) the result and the mesh it ran on."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.parallel import collectives
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.train import checkpoints, loop, trainer
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    steps, meshes = [], []
    clock = {'s': 0.0, 'calls': 0}
    ckpt = {}
    setup = collections.defaultdict(float)

    def clocked(key):
        def wrap(fn):
            def wrapper(*args, **kwargs):
                sync()
                t0 = time.perf_counter()
                result = fn(*args, **kwargs)
                sync()
                setup[key] += time.perf_counter() - t0
                return result
            return wrapper
        return wrap

    def recording(make):
        def wrapper(*args, **kwargs):
            fn = make(*args, **kwargs)

            def step(state, batch):
                sync()
                t0 = time.perf_counter()
                before = (clock['s'], clock['calls'])
                state, m = fn(state, batch)
                sync()
                steps.append({'loss': float(m['loss']),
                              'grad_norm': float(m['grad_norm']),
                              's': time.perf_counter() - t0,
                              'collectives_s': clock['s'] - before[0],
                              'collective_calls': clock['calls']
                              - before[1]})
                return state, m
            return step
        return wrapper

    def timed(fn):
        def wrapper(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            clock['s'] += time.perf_counter() - t0
            clock['calls'] += 1
            return result
        return wrapper

    def ckpt_timed(key):
        def wrap(fn):
            def wrapper(ckpt_dir, state, *args, **kwargs):
                sync()
                t0 = time.perf_counter()
                result = fn(ckpt_dir, state, *args, **kwargs)
                sync()
                step = kwargs.get('step') or int(state['step'])
                ckpt[key + '_s'] = time.perf_counter() - t0
                ckpt[key + '_bytes'] = _dir_bytes(os.path.join(
                    ckpt_dir, str(step)))
                return result
            return wrapper
        return wrap

    def recording_mesh(make):
        def wrapper(*args, **kwargs):
            meshes.append(make(*args, **kwargs))
            return meshes[-1]
        return wrapper

    counters = (fa.flash_attention, fa.flash_attention_quant,
                fa.flash_attention_dq, fa.flash_attention_dkv)
    for c in counters:
        c.causal_launches = {}
    for key in collectives.staged_bytes:
        collectives.staged_bytes[key] = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(trainer, 'make_train_step', recording))
        stack.enter_context(patched(mesh_lib, 'mesh_from_env',
                                    recording_mesh))
        for obj, name, key in (
                (mesh_lib, 'mesh_from_env', 'mesh'),
                (trainer, 'make_train_state', 'train_state'),
                (checkpoints, 'restore_params', 'checkpoint_import')):
            stack.enter_context(patched(obj, name, clocked(key)))
        for name in ('all_reduce_', 'all_gather', 'reduce_scatter',
                     'send_recv'):
            stack.enter_context(patched(collectives, name, timed))
        stack.enter_context(patched(checkpoints, 'save_train_state',
                                    ckpt_timed('save')))
        stack.enter_context(patched(checkpoints, 'restore_train_state',
                                    ckpt_timed('restore')))
        t0 = time.perf_counter()
        res = loop.main(argv)
        sync()
        main_s = time.perf_counter() - t0
    reading = {'argv': argv, 'steps': steps, 'main_s': main_s,
               'setup_s': dict(setup),
               'staged_bytes': dict(collectives.staged_bytes),
               'launches': {name: {'causal': c.causal_launches.get(True, 0),
                                   'full': c.causal_launches.get(False, 0)}
                            for name, c in zip(('K1', 'K2', 'K3', 'K4'),
                                               counters)},
               'peak_mem_gb': (torch.cuda.max_memory_allocated() / 1e9
                               if cuda else None), **ckpt}
    return reading, res, meshes[-1]


def mt_leaf_names(params):
    """Every leaf's name in `trainer.tree_leaves(params)` order
    (`layers.<key>` for a stacked leaf)."""
    return sorted([f'layers.{k}' for k in params['layers']]
                  + [k for k in params if k != 'layers'])


def mt_grad_norms(torch, params, grads, first=0):
    """The f32 norm of every gradient leaf by name (`layers.<key>.<i>`
    for layer i of the whole stack: this stage's layers start at
    `first`), from `grads` in `trainer.tree_leaves(params)` order."""
    out = {}
    for name, g in zip(mt_leaf_names(params), grads):
        if name.startswith('layers.'):
            for i in range(g.shape[0]):
                out[f'{name}.{first + i}'] = float(torch.linalg.vector_norm(
                    g[i], dtype=torch.float32))
        else:
            out[name] = float(torch.linalg.vector_norm(g, dtype=torch.float32))
    return out


def mt_pipe_leg(torch, model, spec, cuda):
    """The pipe leg in this rank (see MT_EXTRA_LEGS): set-up (the mesh,
    the seed-0 draw cut to this stage), then one forward and backward
    through `pipeline.llama_pipeline_forward`, timed, with the time its
    collectives took, the bytes staged through the host, K1/K3/K4
    launches by causal flag, the loss, the sampled logits (written to
    `spec['dir']`), every gradient leaf's norm, the replicated leaves'
    gradient digests and the peak memory."""
    import hashlib

    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.parallel import collectives
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import pipeline, sharding
    from skypilot_tpu_torch.train import trainer
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    mesh = mesh_lib.mesh_from_env(mesh_lib.MeshSpec.parse(spec['pipe_mesh']),
                                  spec['device'])
    cfg = trainer.TrainerConfig(model=model, batch_size=spec['batch'],
                                seq_len=spec['seq'], attention_impl='flash')
    config = cfg.model_config()
    trainer.check_kernels(config, mesh.device)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    full = llama.init_params(config, gen, mesh.device)
    cuts = llama.shard_tree(config, mesh)
    cuts['layers'] = {k: sharding.stage_shard(mesh, v)
                      for k, v in cuts['layers'].items()}
    params = sharding.tree_map(
        lambda leaf, shard: shard(leaf).clone().requires_grad_(True),
        full, cuts)
    del full
    leaf_cuts = trainer.tree_leaves(cuts)
    batch = trainer.synthetic_batch(cfg, mesh)
    sync()
    setup_s = time.perf_counter() - t0
    clock = {'s': 0.0, 'calls': 0}

    def timed(fn):
        def wrapper(*args, **kwargs):
            sync()
            t = time.perf_counter()
            result = fn(*args, **kwargs)
            sync()
            clock['s'] += time.perf_counter() - t
            clock['calls'] += 1
            return result
        return wrapper

    counters = (fa.flash_attention, fa.flash_attention_quant,
                fa.flash_attention_dq, fa.flash_attention_dkv)
    for c in counters:
        c.causal_launches = {}
    for key in collectives.staged_bytes:
        collectives.staged_bytes[key] = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    leaves = trainer.tree_leaves(params)
    with contextlib.ExitStack() as stack:
        for name in ('send', 'recv', 'broadcast', 'all_reduce_'):
            stack.enter_context(patched(collectives, name, timed))
        sync()
        t1 = time.perf_counter()
        logits = pipeline.llama_pipeline_forward(
            params, batch['tokens'], config, mesh,
            num_microbatches=spec['microbatches'])
        with mesh_lib.use_mesh(mesh):
            loss = llama.cross_entropy(logits, batch)
        grads = list(torch.autograd.grad(loss, leaves))
        trainer.reduce_grads_(grads, leaf_cuts, mesh)
        sync()
        step_s = time.perf_counter() - t1
    stage = mesh.index('pipe')
    per = config.num_layers // mesh.shape['pipe']
    sample = logits.detach()[:, ::spec['logit_stride']].float().cpu()
    torch.save(sample, os.path.join(spec['dir'],
                                    f'pipe_logits{mesh.rank}.pt'))
    digests = {}
    for name, g in zip(mt_leaf_names(params), grads):
        if not name.startswith('layers.'):
            t = g.detach()
            t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            digests[name] = hashlib.sha256(
                t.cpu().numpy().tobytes()).hexdigest()
    return {'mesh': spec['pipe_mesh'], 'stage': stage,
            'microbatches': spec['microbatches'],
            'local_layers': int(params['layers']['wq'].shape[0]),
            'setup_s': setup_s, 'step_s': step_s,
            'collectives_s': clock['s'], 'collective_calls': clock['calls'],
            'staged_bytes': dict(collectives.staged_bytes),
            'loss': float(loss.detach()),
            'grad_norms': mt_grad_norms(torch, params, grads, stage * per),
            'digests': digests,
            'launches': {name: {'causal': c.causal_launches.get(True, 0),
                                'full': c.causal_launches.get(False, 0)}
                         for name, c in zip(('K1', 'K2', 'K3', 'K4'),
                                            counters)},
            'peak_mem_gb': (torch.cuda.max_memory_allocated() / 1e9
                            if cuda else None),
            'leg_s': time.perf_counter() - t0}


def mt_device_used_gb(torch, cuda):
    """The card's memory in use now, every process's (None off CUDA)."""
    if not cuda:
        return None
    free, total = torch.cuda.mem_get_info()
    return (total - free) / 1e9


def mt_rank_main(spec_path):
    """One rank of the mesh_train gang, run as its own process with the
    gang variables set: the legs of `spec['legs']` in order, each through
    `train.loop.main` (`mt_leg`), then on the leg's final state the probe
    loss and the digests of its replicated leaves; then the legs of
    `spec['extra']`: 'pipe' (`mt_pipe_leg`) and 'expert' (through
    `train.loop.main` once the parent's unsharded mixtral steps are
    done). Writes its readings as JSON; any failure raises (non-zero
    exit)."""
    with open(spec_path) as f:
        spec = json.load(f)
    import_s = time.time() - spec['started']
    rank = int(os.environ['SKYTPU_PROCESS_ID'])
    if spec['setup']:
        import importlib
        sys.path.insert(0, spec['setup_path'])
        module, fn = spec['setup'].split(':')
        getattr(importlib.import_module(module), fn)()
    import torch

    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.train import trainer
    mt_plant(spec['fault'])
    cuda = spec['device'] == 'cuda'
    out = {'rank': rank, 'legs': {}, 'import_s': import_s,
           'start_s': time.time() - spec['started']}
    if spec['hf'] is not None:
        mt_wait_ready(spec['hf'])
        out['ready_s'] = time.time() - spec['started']
    # MT_WARMUP as the trainer's default: `train.loop.main` has no flag.
    trainer.TrainerConfig = functools.partial(trainer.TrainerConfig,
                                              warmup_steps=spec['warmup'])
    base = ['--batch-size', str(spec['batch']), '--seq-len',
            str(spec['seq']), '--learning-rate', str(spec['lr']),
            '--device', spec['device']]
    with depth_cut(spec['model'], spec['layers']) as name:
        for leg, mesh_arg, attention, _hops in spec['legs']:
            argv = ['--model', name, '--mesh', mesh_arg, '--max-steps',
                    str(spec['steps'])] + base
            if attention:
                argv += ['--attention', attention]
            if leg == 'fsdp':
                # Starts from the seed weights as an HF checkpoint, each
                # rank importing its fsdp cut; saves its last step.
                argv += ['--checkpoint', spec['hf'], '--checkpoint-dir',
                         spec['ckpt'], '--checkpoint-every',
                         str(spec['steps'])]
            t0 = time.perf_counter()
            reading, res, mesh = mt_leg(torch, argv, cuda)
            t_checks = time.perf_counter()
            cfg = trainer.TrainerConfig(
                model=name, batch_size=spec['batch'], seq_len=spec['seq'],
                learning_rate=spec['lr'], attention_impl=attention)
            with mesh_lib.use_mesh(mesh), torch.no_grad():
                reading['probe_loss'] = float(llama.loss_fn(
                    res['state']['params'], mt_probe_batch(
                        torch, trainer, cfg, mesh, spec['probe']),
                    cfg.model_config()))
            reading['digests'] = mt_digests(torch, trainer, res['state'],
                                            cfg, mesh)
            reading['world'] = mesh.world_size
            reading['local_heads'] = int(
                res['state']['params']['layers']['wq'].shape[2])
            reading['checks_s'] = time.perf_counter() - t_checks
            del res
            if leg == 'tensor' and spec['resume']:
                # The fsdp leg's checkpoint, one more step under tensor=2.
                resume, res, _ = mt_leg(torch, argv[:5] + [
                    str(spec['steps'] + 1), '--checkpoint-dir',
                    spec['ckpt']] + argv[6:], cuda)
                reading['resume'] = resume
                del res
            reading['leg_s'] = time.perf_counter() - t0
            out['legs'][leg] = reading
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        if rank == 0:
            # The parent's unsharded mixtral steps may take the card now:
            # the legs with the largest states are done.
            mt_mark_ready(spec['legs_done'], 'ok')
        if 'pipe' in spec['extra']:
            out['legs']['pipe'] = mt_pipe_leg(torch, name, spec, cuda)
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
    if 'expert' in spec['extra']:
        # After the parent's unsharded mixtral steps have freed the card.
        t0 = time.perf_counter()
        mt_wait_ready(spec['moe_ready'])
        wait_s = time.perf_counter() - t0
        with depth_cut(spec['expert_model'], spec['expert_layers']) as name:
            argv = ['--model', name, '--mesh', spec['expert_mesh'],
                    '--max-steps', str(spec['steps']), '--batch-size',
                    str(spec['expert_batch']), '--seq-len', str(spec['seq']),
                    '--learning-rate', str(spec['lr']), '--device',
                    spec['device'], '--attention', 'flash']
            reading, res, mesh = mt_leg(torch, argv, cuda)
            reading['device_used_gb'] = mt_device_used_gb(torch, cuda)
            cfg = trainer.TrainerConfig(
                model=name, batch_size=spec['expert_batch'],
                seq_len=spec['seq'], attention_impl='flash')
            reading['digests'] = mt_digests(torch, trainer, res['state'],
                                            cfg, mesh)
            reading['world'] = mesh.world_size
            reading['local_experts'] = int(
                res['state']['params']['layers']['w_gate'].shape[1])
            del res
        reading['wait_s'] = wait_s
        reading['leg_s'] = time.perf_counter() - t0 - wait_s
        out['legs']['expert'] = reading
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    with open(os.path.join(spec['dir'], f'rank{rank}.json'), 'w') as f:
        json.dump(out, f)
    return 0


def mt_mark_ready(path, state):
    """Mark `path` ready ('ok') or failed (the error) for `mt_wait_ready`
    on the other side: the marker appears whole (written aside, then
    renamed), so a waiter never reads it half written."""
    with open(path + '.ready.tmp', 'w') as f:
        f.write(state)
    os.replace(path + '.ready.tmp', path + '.ready')


def mt_wait_ready(hf_dir, timeout=600.0, alive=None):
    """Wait until the other side has marked `hf_dir` ready (its marker
    `hf_dir.ready`): in a rank, the parent's seed weights or unsharded
    mixtral steps; in the parent, the ranks' largest legs. Raise if it
    failed, timed out, or `alive()` says the writer has ended."""
    marker = hf_dir + '.ready'
    t0 = time.perf_counter()
    while not os.path.exists(marker):
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f'no seed checkpoint at {hf_dir} after '
                               f'{timeout} s')
        if alive is not None and not alive():
            raise RuntimeError(f'{marker}: its writer has ended')
        time.sleep(0.05)
    with open(marker) as f:
        state = f.read()
    if state != 'ok':
        raise RuntimeError(f'the parent failed to write {hf_dir}: {state}')


def mt_expected_launches(legs, layers, steps, remat):
    """K1/K2/K3/K4 launches each rank of each leg makes, from the code,
    by causal flag ('causal', 'full'): per step and layer, K1 once in the
    forward and once more in the remat recompute, K3 and K4 once in the
    backward, each per kernel call of MT_LEGS' per-rank (causal,
    unmasked) counts: a ring hop's diagonal block causal, a past block
    unmasked, a block wholly in the future skipped (`_hop_causal`); K2
    never. The tensor leg's resume adds one step."""
    per_pass = {'K1': 2 if remat else 1, 'K2': 0, 'K3': 1, 'K4': 1}

    def rank(calls, n_steps):
        return {k: {'causal': n * layers * n_steps * calls[0],
                    'full': n * layers * n_steps * calls[1]}
                for k, n in per_pass.items()}
    out = {}
    for leg, _mesh, _attention, calls in legs:
        out[leg] = [rank(c, steps) for c in calls]
        if leg == 'tensor':
            out['resume'] = [rank(c, 1) for c in calls]
    return out


def mt_extra_launches(extra, pipe_layers, stages, microbatches,
                      expert_layers, steps, expert_remat):
    """K1/K2/K3/K4 launches each rank of the extra legs makes, from the
    code, by causal flag. The pipe leg, per layer its stage holds and per
    microbatch: K1 once in the forward and once in the backward's
    recompute of the stage, K3 and K4 once; no bubble step runs. The
    expert leg as a one-device step: per step and layer K1 once (twice
    with remat), K3 and K4 once; each rank runs every layer's
    attention."""
    out = {}
    if 'pipe' in extra:
        n = pipe_layers // stages * microbatches
        out['pipe'] = [{k: {'causal': c * n, 'full': 0} for k, c in (
            ('K1', 2), ('K2', 0), ('K3', 1), ('K4', 1))}] * stages
    if 'expert' in extra:
        n = expert_layers * steps
        out['expert'] = [{k: {'causal': c * n, 'full': 0} for k, c in (
            ('K1', 2 if expert_remat else 1), ('K2', 0), ('K3', 1),
            ('K4', 1))}] * MT_RANKS
    return out


def mt_total(launches):
    """A rank's launches by kernel, both causal flags summed."""
    return {k: n['causal'] + n['full'] for k, n in launches.items()}


def mt_pipe_reference(torch, params, batch, config, mesh):
    """The pipe leg's oracle: the unsharded `llama.forward` of `params` on
    `batch`, its cross-entropy and gradients (the first step's, before
    its update): the logits at every MT_LOGIT_STRIDE-th position (a host
    tensor), the loss and every gradient leaf's norm."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.train import trainer
    with mesh_lib.use_mesh(mesh):
        logits = llama.forward(params, batch['tokens'], config)
        loss = llama.cross_entropy(logits, batch)
        grads = torch.autograd.grad(loss, trainer.tree_leaves(params))
    sample = logits.detach()[:, ::MT_LOGIT_STRIDE].float().cpu()
    del logits
    return {'loss': float(loss.detach()), 'logits': sample,
            'grad_norms': mt_grad_norms(torch, params, grads)}


def mt_unsharded_moe(torch, name, marker):
    """The expert leg's oracle: mixtral's unsharded flash steps (`name`,
    the depth cut) at the leg's batch, seed and schedule: (loss, grad
    norm) a step, the seconds a step and the peak memory; the state is
    freed and `marker` marked ready for the ranks (failed, if it
    failed)."""
    from skypilot_tpu_torch.train import trainer
    try:
        cfg = trainer.TrainerConfig(model=name, batch_size=MT_EXPERT_BATCH,
                                    seq_len=MT_SEQ, max_steps=MT_STEPS,
                                    learning_rate=MT_LR,
                                    warmup_steps=MT_WARMUP,
                                    attention_impl='flash')
        mesh = trainer.placement(DEV)
        cuda = mesh.device.type == 'cuda'
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        state = trainer.make_train_state(cfg, mesh)
        step = trainer.make_train_step(cfg, mesh)
        batch = trainer.synthetic_batch(cfg, mesh)
        out = {'steps': [], 'step_s': []}
        for _ in range(MT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            out['steps'].append((float(m['loss']), float(m['grad_norm'])))
            out['step_s'].append(time.perf_counter() - t0)
        out['peak_mem_gb'] = (torch.cuda.max_memory_allocated() / 1e9
                              if cuda else None)
        del state, step, batch
        gc.collect()
        torch.cuda.empty_cache()
    except BaseException as e:
        mt_mark_ready(marker, f'{type(e).__name__}: {e}')
        raise
    mt_mark_ready(marker, 'ok')
    return out


def mt_unsharded(torch, name, hf_dir=None, pipe=False):
    """The one-device flash steps on the same seed weights and batch:
    (loss, grad norm) of steps 1..MT_STEPS + 1, the first MT_STEPS on the
    legs' schedule (max_steps MT_STEPS), the last on the resume's
    (MT_STEPS + 1); the probe loss after step MT_STEPS (the legs' last)
    and the seconds a step. With `hf_dir`, the seed weights are first
    exported there as an HF checkpoint (`checkpoints.export_params`) for
    the fsdp leg's --checkpoint, then marked ready for the ranks
    (`mt_wait_ready`), which start before this runs; a failed export
    marks it failed. With `pipe`, the pipe leg's oracle on the seed
    weights first (`mt_pipe_reference`)."""
    from skypilot_tpu_torch import checkpoints
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.train import trainer
    cfgs = [trainer.TrainerConfig(model=name, batch_size=MT_BATCH,
                                  seq_len=MT_SEQ, max_steps=n,
                                  learning_rate=MT_LR,
                                  warmup_steps=MT_WARMUP)
            for n in (MT_STEPS, MT_STEPS + 1)]
    cfg = cfgs[0]
    mesh = trainer.placement(DEV)
    if hf_dir is not None:
        try:
            state = trainer.make_train_state(cfg, mesh)
            checkpoints.export_params(trainer.tree_map(
                torch.Tensor.detach, state['params']), cfg.model_config(),
                hf_dir)
        except BaseException as e:
            mt_mark_ready(hf_dir, f'{type(e).__name__}: {e}')
            raise
        mt_mark_ready(hf_dir, 'ok')
    else:
        state = trainer.make_train_state(cfg, mesh)
    legs, resume = (trainer.make_train_step(c, mesh) for c in cfgs)
    batch = trainer.synthetic_batch(cfg, mesh)
    out = {'steps': [], 'step_s': []}
    if pipe:
        out['pipe'] = mt_pipe_reference(torch, state['params'], batch,
                                        cfg.model_config(), mesh)
    for i in range(MT_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = (legs if i < MT_STEPS else resume)(state, batch)
        out['steps'].append((float(m['loss']), float(m['grad_norm'])))
        out['step_s'].append(time.perf_counter() - t0)
        if i == MT_STEPS - 1:
            with mesh_lib.use_mesh(mesh), torch.no_grad():
                out['probe_loss'] = float(llama.loss_fn(
                    state['params'], mt_probe_batch(torch, trainer, cfg,
                                                    mesh, MT_PROBE),
                    cfg.model_config()))
    return out


def mt_faults(out, ref, expected):
    """The limits a mesh_train reading breaks; empty when it passes."""
    faults = []

    def held(what, got, want):
        for i, ((loss, norm), (w_loss, w_norm)) in enumerate(zip(got, want)):
            if not (math.isfinite(loss) and math.isfinite(norm)):
                faults.append(f'{what} step {i + 1}: non-finite')
                continue
            if not abs(loss - w_loss) / abs(w_loss) < TOL_MT_LOSS_REL:
                faults.append(f'{what} step {i + 1}: loss {loss} vs '
                              f'{w_loss} (rel limit {TOL_MT_LOSS_REL})')
            if not abs(norm - w_norm) / w_norm < TOL_MT_NORM_REL:
                faults.append(f'{what} step {i + 1}: grad norm {norm} vs '
                              f'{w_norm} (rel limit {TOL_MT_NORM_REL})')

    for leg, r in out['legs'].items():
        ranks = r['per_rank']
        held(leg, r['losses'], ref['steps'][:len(r['losses'])])
        if any([(x['loss'], x['grad_norm']) for x in p['steps']]
               != r['losses'] for p in ranks):
            faults.append(f'{leg}: the ranks report different losses or '
                          'grad norms')
        if not abs(r['probe_loss'] - ref['probe_loss']) < TOL_MT_PROBE:
            faults.append(f"{leg}: probe loss {r['probe_loss']} vs "
                          f"{ref['probe_loss']} (limit {TOL_MT_PROBE})")
        if not r['replicated_equal']:
            faults.append(f'{leg}: replicated leaves differ across ranks')
        if r['launches_per_rank'] != expected[leg]:
            faults.append(f"{leg}: launches {r['launches_per_rank']} != "
                          f'{expected[leg]}')
        if 'resume' in r:
            held(f'{leg} resume', r['resume']['losses'],
                 ref['steps'][MT_STEPS:MT_STEPS + 1])
            if r['resume']['launches_per_rank'] != expected['resume']:
                faults.append(f"{leg} resume: launches "
                              f"{r['resume']['launches_per_rank']} != "
                              f"{expected['resume']}")
    return faults


def mt_extra_faults(out, ref, expected):
    """The limits the extra legs' readings break; empty when they pass."""
    faults = []
    legs = out['extra_legs']
    if 'pipe' in legs:
        r = legs['pipe']
        if not r['logits_rel'] < TOL_PIPE_LOGITS_REL:
            faults.append(f"pipe: logits {r['logits_rel']} off the "
                          f'unsharded (rel limit {TOL_PIPE_LOGITS_REL})')
        if not r['loss_rel'] < TOL_PIPE_LOSS_REL:
            faults.append(f"pipe: loss {r['loss_rel']} off the unsharded "
                          f'(rel limit {TOL_PIPE_LOSS_REL})')
        if not r['grad_norm_rel'] < TOL_PIPE_NORM_REL:
            faults.append(f"pipe: grad norm of {r['worst_leaf']} "
                          f"{r['grad_norm_rel']} off the unsharded (rel "
                          f'limit {TOL_PIPE_NORM_REL})')
        if r['missing_leaves']:
            faults.append(f"pipe: no gradient for {r['missing_leaves']}")
        if not (r['replicated_equal'] and r['logits_equal']):
            faults.append('pipe: the stages\' replicated gradients or '
                          'logits differ')
        if r['launches_per_rank'] != expected['pipe']:
            faults.append(f"pipe: launches {r['launches_per_rank']} != "
                          f"{expected['pipe']}")
    if 'expert' in legs:
        r = legs['expert']
        for i, ((loss, norm), (w_loss, w_norm)) in enumerate(zip(
                r['losses'], ref['moe']['steps'])):
            if not (math.isfinite(loss) and math.isfinite(norm)):
                faults.append(f'expert step {i + 1}: non-finite')
                continue
            if not abs(loss - w_loss) / abs(w_loss) < TOL_MT_LOSS_REL:
                faults.append(f'expert step {i + 1}: loss {loss} vs '
                              f'{w_loss} (rel limit {TOL_MT_LOSS_REL})')
            if not abs(norm - w_norm) / w_norm < TOL_MT_NORM_REL:
                faults.append(f'expert step {i + 1}: grad norm {norm} vs '
                              f'{w_norm} (rel limit {TOL_MT_NORM_REL})')
        if len(r['losses']) != MT_STEPS:
            faults.append(f"expert: {len(r['losses'])} steps")
        if not r['ranks_agree']:
            faults.append('expert: the ranks report different losses or '
                          'grad norms')
        if not r['replicated_equal']:
            faults.append('expert: replicated leaves differ across ranks')
        if r['launches_per_rank'] != expected['expert']:
            faults.append(f"expert: launches {r['launches_per_rank']} != "
                          f"{expected['expert']}")
    return faults


def mt_pipe_summary(torch, per_rank, ref, tmp):
    """The pipe leg's readings across ranks against the parent's oracle
    (`mt_pipe_reference`): the sampled logits' relative error (each
    rank's, the largest) and whether the ranks' are bit-equal, the loss's,
    the largest gradient-leaf norm's and its leaf, the replicated
    gradients bit-equal, and the times."""
    want = ref['logits']
    samples = [torch.load(os.path.join(tmp, f'pipe_logits{r}.pt'))
               for r in range(len(per_rank))]
    logits_rel = max(float((g - want).abs().max() / want.abs().max())
                     for g in samples)
    norms = {}
    for p in per_rank:
        norms.update(p['grad_norms'])
    rel = {name: abs(norms[name] - w) / w
           for name, w in ref['grad_norms'].items() if name in norms}
    worst = max(rel, key=rel.get)
    r0 = per_rank[0]
    return {'mesh': r0['mesh'], 'microbatches': r0['microbatches'],
            'local_layers': [p['local_layers'] for p in per_rank],
            'logits_rel': logits_rel,
            'logits_equal': all(bool((g == samples[0]).all())
                                for g in samples),
            'loss': r0['loss'], 'ref_loss': ref['loss'],
            'loss_rel': max(abs(p['loss'] - ref['loss']) / ref['loss']
                            for p in per_rank),
            'grad_norm_rel': rel[worst], 'worst_leaf': worst,
            'missing_leaves': sorted(set(ref['grad_norms']) - set(norms)),
            'replicated_leaves': len(r0['digests']),
            'replicated_equal': all(p['digests'] == r0['digests']
                                    for p in per_rank),
            'launches_per_rank': [p['launches'] for p in per_rank],
            'peak_mem_gb_per_rank': [p['peak_mem_gb'] for p in per_rank],
            'step_s': [p['step_s'] for p in per_rank],
            'setup_s': [p['setup_s'] for p in per_rank],
            'leg_s': r0['leg_s'],
            'collectives_s': r0['collectives_s'],
            'collective_calls': r0['collective_calls'],
            'collectives_share': r0['collectives_s'] / r0['step_s'],
            'staged_bytes': r0['staged_bytes']}


def _mt_checkpoint_io(r):
    """A rank's checkpoint save and restore in a run of `main`: seconds,
    bytes and GB/s, for those it made."""
    out = {}
    for key in ('save', 'restore'):
        if f'{key}_s' in r:
            out[f'{key}_s'] = r[f'{key}_s']
            out[f'{key}_bytes'] = r[f'{key}_bytes']
            out[f'{key}_gb_per_s'] = r[f'{key}_bytes'] / 1e9 / r[f'{key}_s']
    return out


def _mt_summary(per_rank):
    """A leg's (or resume's) reading across ranks: rank 0's losses, each
    rank's steps, launches and peak memory, the median step's seconds
    and the collectives' share of the step time on rank 0."""
    steps = per_rank[0]['steps']
    step_s = sorted(x['s'] for x in steps)
    total = sum(x['s'] for x in steps)
    return {'losses': [(x['loss'], x['grad_norm']) for x in steps],
            'median_step_s': step_s[len(step_s) // 2],
            'step_s': [x['s'] for x in steps],
            'collectives_s': sum(x['collectives_s'] for x in steps),
            'collective_calls': sum(x['collective_calls'] for x in steps),
            'collectives_share': (sum(x['collectives_s'] for x in steps)
                                  / total),
            'launches_per_rank': [p['launches'] for p in per_rank],
            'peak_mem_gb_per_rank': [p['peak_mem_gb'] for p in per_rank],
            'per_rank': [{'steps': p['steps']} for p in per_rank]}


def mesh_train_phase(torch, legs=None, fault=None, extra=MT_EXTRA_LEGS):
    """bench-8b trained over MT_LEGS by MT_RANKS ranks on the card (see
    the constants' comment): each leg's losses and grad norms, the
    resumed step's and the probe loss against the unsharded flash steps
    (TOL_MT_*), the ranks' replicated leaves bit-equal, each rank's
    K1/K3/K4 launches equal to `mt_expected_launches`; then in the same
    ranks the `extra` legs (MT_EXTRA_LEGS: bench-8b pipelined over
    pipe=2, mixtral-8x7b over expert=2) against their unsharded oracles
    (`mt_extra_faults`). `fault` plants one of `mt_plant`'s faults in
    the ranks. Returns the reading, with `faults`."""
    import shutil
    import tempfile
    legs = MT_LEGS if legs is None else legs
    t0 = time.perf_counter()
    out = {'model': MT_MODEL, 'layers': MT_LAYERS, 'batch': MT_BATCH,
           'seq_len': MT_SEQ, 'steps': MT_STEPS, 'warmup': MT_WARMUP,
           'ranks': MT_RANKS,
           'backend': 'gloo', 'fault': fault,
           'legs_run': [leg[0] for leg in legs] + list(extra)}
    tmp = tempfile.mkdtemp(prefix='chip_smoke_mt_')
    try:
        from skypilot_tpu_torch import models as models_lib
        fsdp = any(leg[0] == 'fsdp' for leg in legs)
        hf_dir = os.path.join(tmp, 'hf') if fsdp else None
        moe_ready = os.path.join(tmp, 'moe')
        legs_done = os.path.join(tmp, 'legs')
        remat = models_lib.resolve(MT_MODEL)[1].remat
        expected = mt_expected_launches(legs, MT_LAYERS, MT_STEPS, remat)
        expected.update(mt_extra_launches(
            extra, MT_LAYERS, MT_RANKS, MT_MICROBATCHES, MT_EXPERT_LAYERS,
            MT_STEPS, models_lib.resolve(MT_EXPERT_MODEL)[1].remat))
        spec = {'model': MT_MODEL, 'layers': MT_LAYERS, 'batch': MT_BATCH,
                'seq': MT_SEQ, 'steps': MT_STEPS, 'lr': MT_LR,
                'warmup': MT_WARMUP, 'probe': MT_PROBE,
                'device': DEV, 'legs': legs, 'fault': fault,
                'resume': fsdp, 'ckpt': os.path.join(tmp, 'ckpt'),
                'hf': hf_dir, 'dir': tmp, 'extra': list(extra),
                'pipe_mesh': MT_PIPE_MESH, 'microbatches': MT_MICROBATCHES,
                'logit_stride': MT_LOGIT_STRIDE,
                'expert_model': MT_EXPERT_MODEL,
                'expert_layers': MT_EXPERT_LAYERS,
                'expert_batch': MT_EXPERT_BATCH,
                'expert_mesh': MT_EXPERT_MESH, 'moe_ready': moe_ready,
                'legs_done': legs_done,
                'setup': MT_RANK_SETUP and MT_RANK_SETUP[0],
                'setup_path': MT_RANK_SETUP and MT_RANK_SETUP[1]}
        spec_path = os.path.join(tmp, 'spec.json')
        with open(spec_path, 'w') as f:
            json.dump({**spec, 'started': time.time()}, f)
        code = ('import sys, chip_smoke; '
                'sys.exit(chip_smoke.mt_rank_main(sys.argv[1]))')
        port = free_port()
        # The ranks start up while the seed weights are exported and the
        # unsharded steps run here; the fsdp leg waits for the export,
        # the expert leg for the unsharded mixtral steps to end.
        wait = start_ranks(
            lambda r: [sys.executable, '-c', code, spec_path],
            lambda r: tp_gang_env(port, r), tmp, 'mt', timeout=900)
        try:
            with depth_cut(MT_MODEL, MT_LAYERS) as name:
                ref = mt_unsharded(torch, name, hf_dir,
                                   pipe='pipe' in extra)
            gc.collect()
            torch.cuda.empty_cache()
            if 'expert' in extra:
                # Not beside the ranks' fsdp, tensor and ring legs: the
                # unsharded mixtral state peaks at ~52 GB on the H100.
                mt_wait_ready(legs_done, alive=wait.alive)
                with depth_cut(MT_EXPERT_MODEL, MT_EXPERT_LAYERS) as name:
                    ref['moe'] = mt_unsharded_moe(torch, name, moe_ready)
            out['parent_reserved_gb'] = (torch.cuda.memory_reserved() / 1e9
                                         if DEV == 'cuda' else None)
        finally:
            gc.collect()
            torch.cuda.empty_cache()
            rcs, tails, ranks_s = wait()
            # A rank's failure explains a failure here too: report it.
            if rcs != [0] * MT_RANKS:
                raise AssertionError(f'mesh_train ranks failed: rcs {rcs}: '
                                     f'{tails}')
        out['unsharded'] = {k: v for k, v in ref.items() if k != 'pipe'}
        ranks = []
        for r in range(MT_RANKS):
            with open(os.path.join(tmp, f'rank{r}.json')) as f:
                ranks.append(json.load(f))
        out['extra_legs'] = {}
        if 'pipe' in extra:
            out['extra_legs']['pipe'] = mt_pipe_summary(
                torch, [r['legs']['pipe'] for r in ranks], ref['pipe'], tmp)
            out['unsharded']['pipe_loss'] = ref['pipe']['loss']
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out['ranks_s'] = ranks_s
    # Seconds from the ranks' launch: imports done, the legs' loop
    # reached, the seed checkpoint ready (the fsdp leg's wait).
    out['rank_start'] = {key: [r.get(key) for r in ranks]
                         for key in ('import_s', 'start_s', 'ready_s')}
    out['legs'] = {}
    for leg, *_ in legs:
        per_rank = [r['legs'][leg] for r in ranks]
        r0 = per_rank[0]
        reading = {**_mt_summary(per_rank), 'argv': r0['argv'],
                   'leg_s': r0['leg_s'], 'main_s': r0['main_s'],
                   'setup_s': r0['setup_s'], 'checks_s': r0['checks_s'],
                   'world': r0['world'],
                   'staged_bytes': r0['staged_bytes'],
                   'local_heads': r0['local_heads'],
                   'probe_loss': r0['probe_loss'],
                   'probe_per_rank': [p['probe_loss'] for p in per_rank],
                   'replicated_leaves': len(r0['digests']),
                   'replicated_equal': all(p['digests'] == r0['digests']
                                           for p in per_rank)}
        reading.update(_mt_checkpoint_io(r0))
        if 'resume' in r0:
            # The resume's run ends, as `fit` does, with a save of its
            # last step: the mesh-independent save under tensor=2.
            resume = [p['resume'] for p in per_rank]
            reading['resume'] = {**_mt_summary(resume),
                                 'main_s': resume[0]['main_s'],
                                 'setup_s': resume[0]['setup_s'],
                                 **_mt_checkpoint_io(resume[0])}
        out['legs'][leg] = reading
    if 'expert' in extra:
        per_rank = [r['legs']['expert'] for r in ranks]
        r0 = per_rank[0]
        peaks = [p['peak_mem_gb'] for p in per_rank]
        out['extra_legs']['expert'] = {
            **_mt_summary(per_rank), 'argv': r0['argv'],
            'leg_s': r0['leg_s'], 'wait_s': r0['wait_s'],
            'main_s': r0['main_s'], 'setup_s': r0['setup_s'],
            'world': r0['world'], 'local_experts': r0['local_experts'],
            'staged_bytes': r0['staged_bytes'],
            'ranks_agree': all([(x['loss'], x['grad_norm'])
                                for x in p['steps']]
                               == [(x['loss'], x['grad_norm'])
                                   for x in r0['steps']]
                               for p in per_rank),
            'replicated_leaves': len(r0['digests']),
            'replicated_equal': all(p['digests'] == r0['digests']
                                    for p in per_rank),
            'device_used_gb_per_rank': [p['device_used_gb']
                                        for p in per_rank],
            # The card's peak, reckoned: every rank's peak at once, plus
            # what the parent keeps reserved meanwhile.
            'card_peak_gb_reckoned': (
                sum(peaks) + out['parent_reserved_gb']
                if None not in peaks + [out['parent_reserved_gb']]
                else None)}
    out['expected_launches'] = expected
    out['faults'] = (mt_faults(out, ref, expected)
                     + mt_extra_faults(out, ref, expected))
    out['phase_s'] = time.perf_counter() - t0
    return out


def mt_ring_readings(torch, fa):
    """K1, K3 and K4 at the ring's per-hop shapes (MT_RING_SHAPES: a
    rank's B x 2048 local queries against the diagonal block, causal,
    and against a past block, no mask) against their plain versions,
    and timed (`kernel_timing`, `bwd_timing`)."""
    b, t = MT_BATCH, MT_SEQ // MT_RANKS
    h, kv, d = 32, 8, 128
    gen = torch.Generator(device=DEV).manual_seed(13)
    out = {}
    for path, causal in MT_RING_SHAPES:
        case = (path, b, t, t, h, kv, d, causal, None, None, None)
        out[path] = {
            'check_fwd': kernel_reading(torch, fa, gen, False, b, t, t, h,
                                        kv, d, None, None, None,
                                        causal=causal),
            'check_bwd': bwd_reading(torch, fa, gen, case),
            'fwd': kernel_timing(torch, fa, False, (
                b, t, t, h, kv, d, 0 if causal else None), causal=causal),
            'bwd': bwd_timing(torch, fa, case)}
        torch.cuda.empty_cache()
    return out


def bytecode_cache():
    """Keep the bytecode of every module this process and the processes
    it starts import under PYCACHE in the checkout. Where the Python
    installation ships no .pyc files and the environment forbids writing
    them (PYTHONDONTWRITEBYTECODE), every process compiles each module it
    imports from source again: ~1,900 modules and ~7 s of a rank
    process's start on the H100 machine (cProfile, `mesh_train`). With
    the cache the first process to import a module compiles it and the
    later ones read it."""
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, PYCACHE)
    os.environ['PYTHONPYCACHEPREFIX'] = path
    os.environ.pop('PYTHONDONTWRITEBYTECODE', None)
    sys.pycache_prefix = path
    sys.dont_write_bytecode = False


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this '
              'script runs on an NVIDIA GPU', file=sys.stderr)
        return 2
    bytecode_cache()
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

    # 21-22. the OpenAI routes, then load shedding, on an in-process
    # server over the same llama3-8b params. The eighth slice's phases
    # draw from a generator of their own, so every earlier phase reads
    # the prompts it always read.
    new_rng = np.random.default_rng(8)
    t0 = time.perf_counter()
    out, shedding = openai_phase(torch, fa, params, config, new_rng)
    path_launches = {name: {} for name in kernels}
    path_launches['flash_attention']['openai'] = out['kernel_launches']
    emit('openai', phase_s=time.perf_counter() - t0 - shedding['wall_s'],
         **out)
    emit('shedding', **shedding)
    gc.collect()
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
    # 14b. the serving data plane: the port's load balancer in front of
    # three llama3-8b replicas (the migration phase's engines and a
    # third), with a generator of its own.
    out = migration_phase(
        torch, inference, params, config, rng,
        lb_serve=lambda *engines: lb_serve_phase(
            torch, inference, fa, engines, np.random.default_rng(17)))
    lb_serve = out.pop('lb_serve')
    emit('migration', **out)
    emit('lb_serve', **lb_serve)
    if lb_serve['faults']:
        raise AssertionError(f'lb_serve: {lb_serve["faults"]}')
    path_launches['flash_attention']['lb_serve'] = lb_serve['kernel_launches']
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
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix='chip_smoke_roundtrip_')
    try:
        hf_dir = os.path.join(tmp, 'hf')
        t0 = time.perf_counter()
        out = checkpoint_phase(torch, inference, rng, keep=hf_dir)
        emit('checkpoint', phase_s=time.perf_counter() - t0, **out)
        gc.collect()
        torch.cuda.empty_cache()

        # 23. batch inference as a process: llama3-8b bf16 and int8 KV,
        # then phase 18's checkpoint
        t0 = time.perf_counter()
        out = batch_phase(torch, inference, fa, new_rng, hf_dir, tmp)
        emit('batch', phase_s=time.perf_counter() - t0, **out)
        path_launches['flash_attention']['batch'] = out['bf16'][
            'kernel_launches']
        path_launches['flash_attention_quant']['batch'] = out['int8'][
            'kernel_launches']
        path_launches['flash_attention_d256']['batch_checkpoint'] = out[
            'checkpoint']['kernel_launches']

        # 24. the fine-tune round trip at gemma2-2b width
        t0 = time.perf_counter()
        out = roundtrip_phase(torch, inference, fa, new_rng, hf_dir, tmp)
        emit('roundtrip', phase_s=time.perf_counter() - t0, **out)
        for leg in ('fine_tune', 'resume'):
            got = out[f'{leg}_launches']
            path_launches['flash_attention_d256'][f'roundtrip_{leg}'] = \
                got['K1']
            path_launches['flash_attention_dq_d256'][
                f'roundtrip_{leg}'] = got['K3']
            path_launches['flash_attention_dkv_d256'][
                f'roundtrip_{leg}'] = got['K4']
        path_launches['flash_attention_d256']['roundtrip_batch'] = out[
            'batch']['kernel_launches']
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
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
    del train
    gc.collect()
    torch.cuda.empty_cache()

    # 25. mixtral-8x7b served (16 layers) through K1, then K2. The ninth
    # slice's phases draw from a generator of their own.
    t0 = time.perf_counter()
    out, launches = moe_serve_phase(torch, inference, eng, fa,
                                    np.random.default_rng(9))
    emit('moe_serve', model=MOE_MODEL, phase_s=time.perf_counter() - t0,
         **out)
    path_launches['flash_attention']['moe_serve'] = launches['bf16']
    path_launches['flash_attention_quant']['moe_serve'] = launches['int8']
    del out
    gc.collect()
    torch.cuda.empty_cache()

    # 26. mixtral-8x7b trained (2 layers, flash) through K1/K3/K4
    t0 = time.perf_counter()
    parity, train = moe_train_phase(torch, fa)
    emit('moe_train', phase_s=time.perf_counter() - t0,
         tol_loss=TOL_TRAIN_LOSS, tol_grad_rel=TOL_TRAIN_GRAD_REL,
         tol_proj_rel=TOL_TRAIN_PROJ_REL, parity=parity, **train)
    for name, counter in (('flash_attention', 'K1'),
                          ('flash_attention_dq', 'K3'),
                          ('flash_attention_dkv', 'K4')):
        path_launches[name]['moe_train'] = train['launches'][counter]
    del parity, train
    gc.collect()
    torch.cuda.empty_cache()

    # 27. llama3-8b over a tensor=2 mesh: two ranks on the card over gloo,
    # K1 (K2) on each rank's 16 q / 4 kv heads, the target as its own
    # draft, snapshot / restore / handoff; in the same ranks mixtral-8x7b
    # over expert=2 (the unsharded references run here beside them);
    # then the server as two processes, drained into an unsharded
    # engine. Its own generator, as the later slices' phases.
    t0 = time.perf_counter()
    out, launches = tp_serve_phase(torch, inference, fa,
                                   np.random.default_rng(10))
    moe_mesh = out.pop('moe')
    fsdp_serve, context_serve = out.pop('fsdp'), out.pop('context')
    emit('tp_serve', phase_s=time.perf_counter() - t0, **out)
    emit('moe_mesh', **moe_mesh)
    emit('fsdp_serve', **fsdp_serve)
    emit('context_serve', **context_serve)
    if out['faults']:
        raise AssertionError(f'tp_serve: {out["faults"]}')
    path_launches['flash_attention']['tp_serve_spec'] = launches['spec']
    path_launches['flash_attention']['tp_serve_migration'] = launches[
        'migration']
    path_launches['flash_attention']['moe_mesh'] = launches['moe']
    # The fourteenth slice's paths, launches per rank: llama3-8b over
    # fsdp=2 (the serving shape's chunks) and over context=2 (each
    # rank's span; the shapes below).
    path_launches['flash_attention']['tp_serve_fsdp'] = launches['fsdp']
    path_launches['flash_attention']['tp_serve_context'] = launches[
        'context_bf16']
    path_launches['flash_attention_quant']['tp_serve_context'] = launches[
        'context_int8']
    # K1/K2 at a context rank's shapes, rank 1's negative offsets: held
    # against their plain versions (lse = +inf rows among them) and
    # timed, beside the launches each rank made at that offset.
    for quant, name in ((False, 'flash_attention'),
                        (True, 'flash_attention_quant')):
        gen = torch.Generator(device=DEV).manual_seed(16 + int(quant))
        offsets = context_serve['int8' if quant else 'bf16'][
            'offset_launches_per_rank']
        for path, shape in CTX_TIMING_SHAPES:
            check = kernel_reading(torch, fa, gen, quant, *shape, None, None)
            if kernel_faults(check):
                raise AssertionError(f'{name} disagrees with its plain '
                                     f'version at {path}: '
                                     f'{kernel_faults(check)}')
            tm = kernel_timing(torch, fa, quant, shape)
            emit('timing', kernel=name, path=path, check=check, **tm)
            per_rank = [n.get(str(shape[-1]), 0) for n in offsets]
            kernels[name]['max_abs_err'] = max(kernels[name]['max_abs_err'],
                                               check['max_abs_err'])
            kernels[name]['shapes'].append({
                'path': path, 'shape': tm['shape'],
                'q_offset': tm['q_offset'], 'launches': sum(per_rank),
                'launches_per_rank': per_rank,
                'max_abs_err': check['max_abs_err'],
                'masked_rows': check['masked_rows'],
                **{k: tm[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                      'bound_by', 'library_ms')}})
    for quant, name in ((False, 'flash_attention'),
                        (True, 'flash_attention_quant')):
        key = 'int8' if quant else 'bf16'
        # Rank 0's launches (each rank's equal the expected count).
        path_launches[name]['tp_serve'] = launches[key][0]
        tm = kernel_timing(torch, fa, quant, TP_TIMING_SHAPE)
        emit('timing', kernel=name, path='tp_serve', **tm)
        kernels[name]['shapes'].append({
            'path': 'tp_serve', 'shape': tm['shape'],
            'q_offset': tm['q_offset'], 'launches': launches[key][0],
            'launches_per_rank': launches[key],
            **{k: tm[k] for k in ('ms', 'plain_ms', 'bound_ms', 'bound_by',
                                  'library_ms')}})

    # 28. bench-8b trained over a mesh: two ranks on the card over gloo,
    # the fsdp, tensor (and its resume of the fsdp checkpoint) and ring
    # legs through train.loop.main, against the unsharded steps; then in
    # the same ranks bench-8b pipelined over pipe=2 and mixtral-8x7b over
    # expert=2.
    out = mesh_train_phase(torch)
    emit('mesh_train', tol_loss_rel=TOL_MT_LOSS_REL,
         tol_norm_rel=TOL_MT_NORM_REL, tol_probe=TOL_MT_PROBE,
         tol_pipe_logits_rel=TOL_PIPE_LOGITS_REL,
         tol_pipe_loss_rel=TOL_PIPE_LOSS_REL,
         tol_pipe_norm_rel=TOL_PIPE_NORM_REL, **out)
    if out['faults']:
        raise AssertionError(f'mesh_train: {out["faults"]}')
    for name, counter in (('flash_attention', 'K1'),
                          ('flash_attention_dq', 'K3'),
                          ('flash_attention_dkv', 'K4')):
        for leg, reading in out['legs'].items():
            path_launches[name][f'mesh_train_{leg}'] = [
                mt_total(n)[counter] for n in reading['launches_per_rank']]
            if 'resume' in reading:
                path_launches[name][f'mesh_train_{leg}_resume'] = [
                    mt_total(n)[counter] for n in reading['resume'][
                        'launches_per_rank']]
        for leg, reading in out['extra_legs'].items():
            path_launches[name][f'mesh_train_{leg}'] = [
                mt_total(n)[counter] for n in reading['launches_per_rank']]
    # K1, K3 and K4 at the ring's per-hop shapes, checked against their
    # plain versions and timed; their launches are the ring leg's as the
    # wrappers counted them by causal flag (the diagonal block causal,
    # a past block unmasked).
    ring = mt_ring_readings(torch, fa)
    emit('mesh_train_ring_kernels', **ring)
    bad = {path: kernel_faults(r['check_fwd']) + bwd_faults(r['check_bwd'])
           for path, r in ring.items()
           if kernel_faults(r['check_fwd']) + bwd_faults(r['check_bwd'])}
    if bad:
        raise AssertionError(f'the ring hops\' kernels disagree with their '
                             f'plain versions: {bad}')
    ring_leg = out['legs']['ring']
    for path, causal in MT_RING_SHAPES:
        reading = ring[path]
        flag = 'causal' if causal else 'full'
        for name, tm, counter in (
                ('flash_attention', reading['fwd'], 'K1'),
                ('flash_attention_dq', reading['bwd']['dq'], 'K3'),
                ('flash_attention_dkv', reading['bwd']['dkv'], 'K4')):
            per_hop = [n[counter][flag]
                       for n in ring_leg['launches_per_rank']]
            kernels[name].setdefault('shapes', []).append({
                'path': f'mesh_train_{path}', 'shape': tm['shape'],
                'causal': tm['causal'], 'launches': sum(per_hop),
                'launches_per_rank': per_hop,
                **{k: tm[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                      'bound_by', 'library_ms')}})

    # The later slices' paths, each read with the counts set to 0 just
    # before and read just after (launches beside the main path's).
    for name, paths in path_launches.items():
        kernels[name]['path_launches'] = paths
    emit('done', seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({'kernels': list(kernels.values())}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
