// Flash-attention forward for Hopper (sm_90a): bf16 KV and int8 KV.
//
// Replaces the TPU kernel skypilot_tpu/ops/flash_attention.py::_fwd_kernel
// in both of its modes: quant=False (flash_attention, K1) and quant=True
// (flash_attention_quant, K2). It computes
//     O = softmax(mask(softcap(Q K^T / sqrt(d)))) V      and      lse
// with an online softmax (m, l, acc in f32), the causal mask shifted by a
// runtime q_offset (cached prefill: a chunk of T queries at cache position
// q_offset attends the whole cache), a runtime sliding window, and an
// optional logit softcap. GQA reads kv head h / (H / KV); no repeat.
// Rows with no visible key give O = 0 and lse = +inf, as the reference.
//
// What bounds it on this card: serving prefill at chunk 512-1024 against a
// cache of a few thousand positions (and training at S 4096) does
// 4*B*H*T*S_visible*D FLOP over O((T + S_visible)*D) bytes per (b, h), far
// above the H100's ~295 FLOP per byte, so it is bound by the tensor cores
// (989 TFLOP/s dense bf16), and only wgmma reaches their rate. The first
// port (mma.sync, loads and math serialised in 4-warp blocks) ran at 61
// TFLOP/s.
//
// What the design does about it:
//  * One CTA per (128-row q tile, q head, batch): two consumer warpgroups
//    of 64 q rows each and a producer warpgroup. The producer gives
//    registers back (setmaxnreg.dec) and the consumers take them
//    (setmaxnreg.inc): the S tile, the O accumulator and the P fragments
//    of 64 rows stay in registers, with no spills. (d 256: see below.)
//  * Loads by TMA: Q once per CTA; K and V in 128-row tiles into a ring
//    of kStages stages guarded by full/empty mbarriers, so the next tile
//    is in flight while the consumers compute. TMA writes the tiles
//    128-byte swizzled (a d 128 bf16 row is two 64-column slabs) and
//    zero-fills rows past Sq / Skv.
//  * S = Q K^T and O += P V both on wgmma (bf16 in, f32 accumulate): Q
//    and K from shared memory (K-major), P from registers (the S
//    accumulator rounded in place to bf16 A fragments), V from shared
//    memory as an MN-major operand through wgmma's transpose bit.
//  * The kv loop runs over [lo, hi) (the reference's _clamped_kv_index as
//    loop bounds). Each tile is classified against the warpgroup's rows:
//    only a tile crossing the causal frontier, the window's lower edge or
//    Skv runs the per-element mask. exp2 with scale * log2(e) folded into
//    the score; lse goes back to the natural log at the end.
//  * int8 K/V (K2) arrive by TMA at half the bytes into an int8 ring; the
//    producer warpgroup widens each tile into the bf16 stage (exact, two
//    values per bf16x2 subtraction) in the swizzled layout, with its
//    ks/vs beside it, while the consumers compute on the previous stage.
//    ks scales the score columns and vs folds into P, as the reference.
//  * head_dim 256 (gemma-2) runs 64-row q CTAs of one consumer
//    warpgroup and the producer (256 threads), kv tiles of 64 rows, and
//    P V as two m64n128k16 issues a k-step (V's slabs 0-1 and 2-3 into
//    the accumulator's two halves). Why:
//    - registers: a consumer thread holds 128 f32 of O at d 256, plus
//      the S tile. ptxas plans a 384-thread launch within 168 registers
//      a thread whatever setmaxnreg grants (it spilled ~500 bytes and
//      serialised every wgmma of a two-consumer d 256 CTA); a 256-thread
//      launch may use 255, so the one consumer warpgroup keeps O, S and
//      P in registers with no setmaxnreg at all;
//    - shared memory: a 128-row K+V stage is 128 KB at d 256. With 64-row
//      kv tiles and a 64-row Q tile, Q (32 KB) and two 64 KB stages take
//      160 KB, and K2's int8 ring keeps its two 32 KB stages beside them
//      (225 KB of the 227 KB a block may use). A one-stage bf16 or int8
//      ring would stall the consumer or the widening on every tile;
//    - the S tile of a 64-row kv tile is 32 registers (Q K^T on
//      m64n64k16), against 64 at a 128-row tile.
//    The cost: one warpgroup per SM alternates Q K^T, softmax and P V,
//    and each Q tile feeds half the rows it feeds at d 128.
// Measured by chip_smoke.py on an H100 SXM at 700 W (PERF.md section 6):
// K1 about 440 TFLOP/s at the serving chunk and 420 at the training
// shape, K2 about 280 (the widening pass competes for issue slots).
// Not done here: the two-warpgroup softmax/GEMM ping-pong (each warpgroup
// still runs Q K^T, softmax and P V in turn), persistent CTAs, fp8.
//
// Launch contract: runs on the caller's stream, never synchronises and
// allocates nothing; O and lse are allocated by the wrapper. Each entry
// point returns cudaGetLastError() of its launch (cudaErrorInvalidValue
// when a tensor map cannot describe an input).

#include "hopper.cuh"

namespace {

constexpr int kStages = 2;         // K/V ring depth
constexpr float kNegInf = -1e30f;  // the reference's masked score
constexpr float kLn2 = 0.6931471805599453f;

// The CTA's shape and its byte offsets in dynamic shared memory, from a
// base aligned to 1024. Consumer warpgroup w owns q rows [64 w, 64 w +
// 64); the producer warpgroup comes after them. K and V reach wgmma as
// bf16 tiles of kBK rows in kStages stages; int8 K/V (K2) land first in
// an int8 ring of as many stages, with their scales beside.
template <int D, bool QUANT>
struct Smem {
  static constexpr int kBQ = D == 256 ? 64 : 128;      // q rows per CTA
  static constexpr int kBK = D == 256 ? 64 : 128;      // kv rows per tile
  static constexpr int kConsumerWGs = kBQ / 64;
  static constexpr int kConsumers = 128 * kConsumerWGs;
  static constexpr int kThreads = kConsumers + 128;    // + the producer
  static constexpr int kSlabs = D / 64;                // slabs of a bf16 row
  static constexpr int kQSlab = kBQ * 128;             // one [kBQ x 64] slab
  static constexpr int kKvSlab = kBK * 128;            // one [kBK x 64] slab
  static constexpr int kQTile = kSlabs * kQSlab;
  static constexpr int kTile = kSlabs * kKvSlab;       // kBK bf16 kv rows
  static constexpr int kStageBytes = 2 * kTile;        // K then V
  static constexpr int kInt8Tile = kBK * D;            // kBK int8 rows
  static constexpr int kQ = 0;
  static constexpr int kOperands = kQ + kQTile;
  static constexpr int kInt8Ring = kOperands + kStages * kStageBytes;
  static constexpr int kScales =
      kInt8Ring + (QUANT ? kStages * 2 * kInt8Tile : 0);   // ks then vs
  static constexpr int kBars = kScales + (QUANT ? kStages * 2 * kBK * 4 : 0);
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages);
  static constexpr int kAlloc =
      kBytes + 1024 < kMaxSmem ? kBytes + 1024 : kMaxSmem;
  static_assert(kBytes <= kMaxSmem, "shared memory layout too large");
};

}  // namespace

// Mirrors FlashParams in skypilot_tpu_torch/ops/_build.py (ctypes).
struct FlashParams {
  const void* q;      // [B, Sq, H, D] bf16
  const void* k;      // [B, Skv, KV, D] bf16 or int8
  const void* v;      // [B, Skv, KV, D] bf16 or int8
  const float* ks;    // [B, Skv, KV] f32 (int8 only)
  const float* vs;    // [B, Skv, KV] f32 (int8 only)
  void* o;            // [B, Sq, H, D] bf16
  float* lse;         // [B, H, Sq] f32, contiguous
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t ks_sb, ks_ss, ks_sh;
  int64_t vs_sb, vs_ss, vs_sh;
  int64_t o_sb, o_ss, o_sh;
  int32_t B, Sq, Skv, H, KV, D;
  int32_t causal, windowed, window, q_offset;
  float scale, softcap;  // softcap <= 0: off
};

// ---- forward-only helpers (the rest is in hopper.cuh) ----

__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Two int8 in bits 0-7 and 16-23 -> two bf16, exactly, as
// (128 + (x & 127)) - (128 or 256): the low seven bits set as mantissa
// bits of 128.0, the sign bit landing on the exponent's lowest bit
// (128.0 -> 256.0), then one bf16x2 subtraction.
__device__ __forceinline__ uint32_t widen2(uint32_t spread) {
  const uint32_t v = (spread & 0x007F007Fu) | 0x43004300u;
  const uint32_t s = (spread & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

template <int D, bool QUANT, bool SOFTCAP>
__global__ void __launch_bounds__(Smem<D, QUANT>::kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ FlashParams p,
                     const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv) {
  using L = Smem<D, QUANT>;
  constexpr int kBQ = L::kBQ;
  constexpr int kBK = L::kBK;
  constexpr int kConsumers = L::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  if (pad + L::kBytes > L::kAlloc) __trap();
  uint8_t* smem = smem_raw + pad;
  const uint32_t base = smem_u32(smem);
  const uint32_t q_smem = base + L::kQ;
  const uint32_t operands = base + L::kOperands;
  const uint32_t q_full = base + L::kBars;
  const uint32_t full0 = q_full + 8;              // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;    // empty[s]
  const uint32_t int8_full0 = empty0 + 8 * kStages;  // int8 ring (K2)

  // Heavier (later) causal q tiles first: they finish last otherwise.
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q_start = q_tile * kBQ;

  // kv tiles [k_first, kv_hi): nothing past the causal frontier of the
  // CTA's last row nor before the window of its first row is read.
  int kv_hi = p.Skv;
  int kv_lo = 0;
  if (p.causal) {
    const int last_row = min(q_start + kBQ, p.Sq) - 1;
    kv_hi = min(p.Skv, p.q_offset + last_row + 1);
    if (p.windowed) kv_lo = max(0, p.q_offset + q_start - p.window + 1);
  }
  const int k_first = (kv_lo / kBK) * kBK;
  const int n_tiles = kv_hi > k_first ? (kv_hi - k_first + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one arrival a warp
      mbar_init(int8_full0 + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == L::kConsumerWGs) {
    // ---- producer warpgroup: one thread issues the TMA loads; for K2
    // the whole warpgroup widens each int8 tile into the bf16 stage.
    // With two consumer warpgroups it gives registers back to them. ----
    if constexpr (L::kConsumerWGs == 2) {
      if constexpr (QUANT)
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
      else
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    }
    const int pt = threadIdx.x - kConsumers;
    // int8 K/V tile i into int8 ring stage i % kStages.
    auto load_int8 = [&](int i) {
      const int s = i % kStages;
      const uint32_t dst = base + L::kInt8Ring + s * 2 * L::kInt8Tile;
      const int k0 = k_first + i * kBK;
      mbar_expect_tx(int8_full0 + 8 * s, 2 * L::kInt8Tile);
      tma_load(dst, &tk, int8_full0 + 8 * s, 0, kvh, k0, b);
      tma_load(dst + L::kInt8Tile, &tv, int8_full0 + 8 * s, 0, kvh, k0, b);
    };
    if (pt == 0) {
      mbar_expect_tx(q_full, L::kQTile);
      for (int sl = 0; sl < L::kSlabs; ++sl)
        tma_load(q_smem + sl * L::kQSlab, &tq, q_full, sl * 64, h, q_start,
                 b);
      if constexpr (QUANT) {
        for (int i = 0; i < kStages && i < n_tiles; ++i) load_int8(i);
      } else {
        for (int i = 0; i < n_tiles; ++i) {
          const int s = i % kStages;
          mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
          const uint32_t dst = operands + s * L::kStageBytes;
          const int k0 = k_first + i * kBK;
          mbar_expect_tx(full0 + 8 * s, L::kStageBytes);
          for (int sl = 0; sl < L::kSlabs; ++sl) {
            tma_load(dst + sl * L::kKvSlab, &tk, full0 + 8 * s, sl * 64, kvh,
                     k0, b);
            tma_load(dst + L::kTile + sl * L::kKvSlab, &tv, full0 + 8 * s,
                     sl * 64, kvh, k0, b);
          }
        }
      }
    }
    if constexpr (QUANT) {
      constexpr int kRowStep = 128 / (D / 8);  // rows widened a pass
      const int widen_ch = pt % (D / 8);
      const int widen_row = pt / (D / 8);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t parity = (i / kStages) & 1;
        const int k0 = k_first + i * kBK;
        const int kpos = k0 + pt;  // this thread's ks/vs, read early
        const bool in = pt < kBK && kpos < p.Skv;
        const float ksv =
            in ? p.ks[b * p.ks_sb + kpos * p.ks_ss + kvh * p.ks_sh] : 0.f;
        const float vsv =
            in ? p.vs[b * p.vs_sb + kpos * p.vs_ss + kvh * p.vs_sh] : 0.f;
        mbar_wait(int8_full0 + 8 * s, parity);
        mbar_wait(empty0 + 8 * s, parity ^ 1);
        // Widen into the stage, swizzled as TMA writes a bf16 tile: each
        // thread takes one 8-column chunk of every kRowStep-th row, at
        // the 16-byte chunk (chunk ^ row % 8) of the row.
        const uint32_t src = base + L::kInt8Ring + s * 2 * L::kInt8Tile +
                             widen_row * D + widen_ch * 8;
        const uint32_t dst = operands + s * L::kStageBytes +
                             (widen_ch / 8) * L::kKvSlab + widen_row * 128;
#pragma unroll
        for (int which = 0; which < 2; ++which) {  // K, then V
#pragma unroll 4
          for (int r = 0; r < kBK; r += kRowStep) {
            const uint2 w = ld_shared_v2(src + which * L::kInt8Tile + r * D);
            const int row = widen_row + r;
            st_shared_v4(dst + which * L::kTile + r * 128 +
                             (((widen_ch % 8) ^ (row % 8)) * 16),
                         widen2(__byte_perm(w.x, 0, 0x4140)),
                         widen2(__byte_perm(w.x, 0, 0x4342)),
                         widen2(__byte_perm(w.y, 0, 0x4140)),
                         widen2(__byte_perm(w.y, 0, 0x4342)));
          }
        }
        float* sc = reinterpret_cast<float*>(smem + L::kScales) + s * 2 * kBK;
        if (pt < kBK) {
          sc[pt] = ksv;
          sc[kBK + pt] = vsv;
        }
        fence_proxy_async();               // generic writes -> wgmma reads
        named_barrier_sync(1, 128);        // the int8 stage is read
        if (pt == 0) {
          mbar_arrive(full0 + 8 * s);
          if (i + kStages < n_tiles) load_int8(i + kStages);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64) ----
    if constexpr (L::kConsumerWGs == 2) {
      if constexpr (QUANT)
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
      else
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    }
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int tig = lane % 4;                        // thread in quad
    const int row0 = q_start + wg * 64 + (t / 32) * 16 + lane / 4;
    const float scale_log2 = p.scale * kLog2e;
    // softcap: cap * tanh(scale * s / cap), in log2 units.
    const float cap_in = SOFTCAP ? p.scale / p.softcap : 0.f;
    const float cap_out = p.softcap * kLog2e;
    const uint32_t q_wg = q_smem + wg * 64 * 128;  // 64 rows into each slab

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max, log2 units
    float l[2] = {0.f, 0.f};          // per-thread partial row sums
    mbar_wait(q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int stage = i % kStages;
      const int k0 = k_first + i * kBK;
      mbar_wait(full0 + 8 * stage, (i / kStages) & 1);
      const uint32_t stage_base = operands + stage * L::kStageBytes;
      const uint32_t k_tile = stage_base;
      const uint32_t v_tile = stage_base + L::kTile;
      // int8: this thread's ks/vs pairs at column 2 tig, 8 columns apart.
      const uint32_t ks_pair =
          base + L::kScales + (stage * 2 * kBK + tig * 2) * 4;

      // S = Q K^T over the tile (wgmma, both operands in shared memory).
      float s[kBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t qd = desc_b128(
            q_wg + (kk / 4) * L::kQSlab + (kk % 4) * 32, 16, 1024);
        const uint64_t kd = desc_b128(
            k_tile + (kk / 4) * L::kKvSlab + (kk % 4) * 32, 16, 1024);
        if constexpr (kBK == 128)
          wgmma_ss_n128(s, qd, kd, kk > 0);
        else
          wgmma_ss_n64(s, qd, kd, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<kBK / 2>(s);

      // Score mods in the reference's order (_score_mods): scale, ks,
      // softcap, then the mask; scores in log2 units from here on.
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        uint2 ksj = make_uint2(0u, 0u);
        if (QUANT) ksj = ld_shared_v2(ks_pair + j * 32);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float kscale = __uint_as_float((e & 1) ? ksj.y : ksj.x);
          float x = s[4 * j + e];
          if (SOFTCAP) {
            x *= QUANT ? cap_in * kscale : cap_in;
            x = tanhf(x) * cap_out;
          } else {
            x *= QUANT ? scale_log2 * kscale : scale_log2;
          }
          s[4 * j + e] = x;
        }
      }
      // Only a tile that reaches past Skv, crosses the causal frontier of
      // the warpgroup's first row or the window of its last row is masked.
      const int qp_lo = p.q_offset + q_start + wg * 64;  // warpgroup's rows
      const int qp_hi = qp_lo + 63;
      const bool past_skv = k0 + kBK > p.Skv;
      const bool crosses_frontier = p.causal && k0 + kBK - 1 > qp_lo;
      const bool below_window =
          p.causal && p.windowed && k0 <= qp_hi - p.window;
      if (past_skv || crosses_frontier || below_window) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + j * 8 + tig * 2 + (e & 1);
            const int qpos = p.q_offset + row0 + (e >> 1) * 8;
            bool ok = kpos < p.Skv;
            if (p.causal) {
              ok = ok && qpos >= kpos;
              if (p.windowed) ok = ok && (qpos - kpos < p.window);
            }
            if (!ok) s[4 * j + e] = kNegInf;
          }
        }
      }
      float mb[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        mb[0] = fmaxf(mb[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mb[1] = fmaxf(mb[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      float corr[2];
      float safe_m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 1));
        mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 2));
        const float m_new = fmaxf(m[r], mb[r]);
        safe_m[r] = m_new <= kNegInf * 0.5f ? 0.f : m_new;
        corr[r] = fast_exp2(m[r] - safe_m[r]);
        m[r] = m_new;
      }
      float lsum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        uint2 vsj = make_uint2(0u, 0u);
        if (QUANT) vsj = ld_shared_v2(ks_pair + kBK * 4 + j * 32);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = fast_exp2(s[4 * j + e] - safe_m[e >> 1]);
          lsum[e >> 1] += pe;
          if (QUANT) pe *= __uint_as_float((e & 1) ? vsj.y : vsj.x);
          s[4 * j + e] = pe;
        }
      }
      l[0] = l[0] * corr[0] + lsum[0];
      l[1] = l[1] * corr[1] + lsum[1];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= corr[0];
        acc[4 * j + 1] *= corr[0];
        acc[4 * j + 2] *= corr[1];
        acc[4 * j + 3] *= corr[1];
      }

      // O += P V: the score accumulators of columns [16 t, 16 t + 16) are
      // the A fragment of k-step t, all rounded before the first wgmma;
      // V's k-step t is its rows 16 t.. (2 KB into each slab), MN-major,
      // 64-column slabs kKvSlab apart. At D 256 each k-step issues twice:
      // slabs 0-1 into acc[0, 64), slabs 2-3 into acc[64, 128).
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kt = 0; kt < kBK / 16; ++kt) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kt][r] = pack_f32(s[8 * kt + 2 * r], s[8 * kt + 2 * r + 1]);
      }
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < kBK / 16; ++kt) {
        const uint32_t v_k = v_tile + kt * 16 * 128;
        const uint64_t vd = desc_b128(v_k, L::kKvSlab, 1024);
        if constexpr (D == 256) {
          wgmma_rs_n128(acc, pa[kt], vd);
          wgmma_rs_n128(acc + 64, pa[kt],
                        desc_b128(v_k + 2 * L::kKvSlab, L::kKvSlab, 1024));
        } else if constexpr (D == 128) {
          wgmma_rs_n128(acc, pa[kt], vd);
        } else {
          wgmma_rs_n64(acc, pa[kt], vd);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<D / 2>(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    }

    // Finalize: full row sums across the quad, O = acc / l (l == 0 ->
    // O = 0) and lse in natural log (+inf on rows with no visible key).
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                        h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[r];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = row0 + r * 8;
      if (row >= p.Sq) continue;
      const float norm = lt == 0.f ? 1.f : lt;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(op + row * p.o_ss + j * 8 + tig * 2) =
            pack_f32(acc[4 * j + 2 * r] / norm, acc[4 * j + 2 * r + 1] / norm);
      }
      if (tig == 0) {
        const float sm = m[r] <= kNegInf * 0.5f ? 0.f : m[r] * kLn2;
        p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + row] =
            lt > 0.f ? sm + logf(fmaxf(lt, 1e-37f))
                     : __int_as_float(0x7f800000);
      }
    }
  }
}

// ---- host side: tensor maps and launch ----

namespace {

template <int D, bool QUANT, bool SOFTCAP>
int launch(const FlashParams& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, p.q, false, p.q_sb, p.q_ss, p.q_sh, p.B, p.Sq, p.H,
                D, Smem<D, QUANT>::kBQ) ||
      !make_map(&tk, p.k, QUANT, p.k_sb, p.k_ss, p.k_sh, p.B, p.Skv, p.KV,
                D, Smem<D, QUANT>::kBK) ||
      !make_map(&tv, p.v, QUANT, p.v_sb, p.v_ss, p.v_sh, p.B, p.Skv, p.KV,
                D, Smem<D, QUANT>::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  using L = Smem<D, QUANT>;
  auto kernel = flash_fwd_kernel<D, QUANT, SOFTCAP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sq + L::kBQ - 1) / L::kBQ, p.H, p.B);
  kernel<<<grid, L::kThreads, L::kAlloc, stream>>>(p, tq, tk, tv);
  return static_cast<int>(cudaGetLastError());
}

template <bool QUANT>
int dispatch(const FlashParams* p, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool softcap = p->softcap > 0.f;
  switch (p->D) {
    case 64:
      return softcap ? launch<64, QUANT, true>(*p, stream)
                     : launch<64, QUANT, false>(*p, stream);
    case 128:
      return softcap ? launch<128, QUANT, true>(*p, stream)
                     : launch<128, QUANT, false>(*p, stream);
    case 256:
      return softcap ? launch<256, QUANT, true>(*p, stream)
                     : launch<256, QUANT, false>(*p, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Size of FlashParams, so the binding can check its ctypes mirror.
int skytpu_flash_params_size() { return static_cast<int>(sizeof(FlashParams)); }

// K1: bf16 K/V.
int skytpu_flash_fwd_bf16(const FlashParams* p, void* stream) {
  return dispatch<false>(p, stream);
}

// K2: int8 K/V with per-(position, head) f32 scales.
int skytpu_flash_fwd_int8(const FlashParams* p, void* stream) {
  return dispatch<true>(p, stream);
}

}  // extern "C"
