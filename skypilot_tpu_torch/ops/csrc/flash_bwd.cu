// Flash-attention backward for Hopper (sm_90a): dQ (K3) and dK/dV (K4).
//
// Replaces the TPU kernels skypilot_tpu/ops/flash_attention.py::_dq_kernel
// (K3) and ::_dkv_kernel (K4), reached through _flash_bwd_impl. With the
// forward's lse and delta = rowsum(dO * O) (computed by the wrapper), both
// recompute the probabilities instead of storing them:
//     S  = softcap(Q K^T / sqrt(d)), masked        P  = exp(S - lse)
//     dP = dO V^T                                  dS = P * (dP - delta)
//     (dS *= 1 - tanh^2 under softcap), then dS *= 1 / sqrt(d)
//     K3: dQ = dS K          K4: dV = P^T dO,  dK = dS^T Q
// with the causal mask shifted by a runtime q_offset, a runtime sliding
// window, GQA (q head h reads kv head h / (H / KV)), and rows with
// lse = +inf (no visible key) giving P = 0.
//
// What bounds them on this card: training attention at S = 4096 does 6*d
// (K3) and 8*d (K4) FLOP per visible (query, key) pair over O(S*D) bytes
// per head, far above the H100's ~295 FLOP per byte, so both are bound by
// the tensor cores (989 TFLOP/s dense bf16), and only wgmma reaches their
// rate. This replaces a first port of 4-warp blocks on warp-level m16n8k16
// products whose K/V (K3) or Q/dO (K4) tiles were staged by plain loads
// between two __syncthreads, so loads and math never overlapped, with the
// transposed operands read by transposing shared-memory matrix loads.
//
// What the design does about it (the forward's template, flash_fwd.cu,
// with the PTX helpers shared through hopper.cuh):
//  * One CTA of 384 threads: two consumer warpgroups (setmaxnreg.inc 240)
//    and a producer warpgroup (setmaxnreg.dec 24). The CTA's own tiles
//    arrive by TMA once; 64-row tiles of the other side stream through a
//    ring of 4 stages guarded by full/empty mbarriers, so the next tiles
//    are in flight while the consumers compute. TMA writes every tile
//    128-byte swizzled (a d 128 bf16 row is two 64-column slabs) and
//    zero-fills rows past Sq / Skv. Every mbarrier wait traps after 2^28
//    polls: a lost barrier is an error, not a hung card.
//  * Blocks are dispatched heaviest first across all heads: the head is
//    blockIdx.x (dispatched fastest), the tile blockIdx.y.
//  * K3: one CTA per (128-row q tile, q head, batch); each consumer
//    warpgroup owns 64 q rows. Q and dO arrive once; K and V stream over
//    the forward's kv bounds (the reference's _clamped_kv_index). Per kv
//    tile and warpgroup: S = Q K^T and dP = dO V^T on SS wgmma m64n64k16
//    (all operands K-major, V exactly as K); the score math in the
//    reference's order, exp2 with log2(e) folded into the scale and lse;
//    dS rounded in place to bf16 A fragments; dQ += dS K on RS wgmma with
//    K MN-major through the transpose bit (the forward's V in P V). dQ
//    (64 f32 a thread at d 128) stays in registers; lse and delta of the
//    thread's two rows are read once.
//  * K4: one CTA per (64-row kv tile, kv head, batch), earliest kv tiles
//    (the most queries) first. K and V arrive once and stay; (Q, dO)
//    tiles stream over every (q head of the GQA group, visible q tile)
//    pair (the reference's _clamped_q_index as bounds). The producer warp
//    writes each stage's 64 lse (times log2(e)) and delta values beside it
//    with plain loads (a [B, H, Sq] row need not be 16-byte aligned that
//    way) and arrives on the full barrier with the TMA bytes. Both
//    consumer warpgroups work on all 64 kv rows and split the outputs:
//    warpgroup 0 computes S^T = K Q^T (SS wgmma), hands it to warpgroup 1
//    through a double-buffered f32 tile in shared memory (s_full/s_empty
//    mbarriers), then P^T and dV += P^T dO; warpgroup 1 computes
//    dP^T = V dO^T meanwhile, then P^T and dS^T from the handed-over S^T,
//    and dK += dS^T Q. P^T and dS^T are rounded in place to bf16 A
//    fragments; dO and Q are MN-major B operands. Each thread sums one of
//    dK, dV (64 f32 at d 128) over the whole GQA group and rounds it to
//    bf16 once: no atomics, no per-head partials, deterministic. A single
//    warpgroup holding both (128 f32) does not work: ptxas plans the wgmma
//    pipeline within the 168 registers of a 384-thread launch, whatever
//    setmaxnreg grants, and spilled and serialised every wgmma.
//  * Each tile is classified against the warpgroup's rows: a tile with no
//    visible pair skips its products; only a tile crossing the causal
//    frontier, the window's edge, Skv or Sq runs the per-element mask.
// Not done here: the fused single pass (dS K added into an f32 dQ from
// K4's CTA by atomics or a TMA reduce-add, 10*d FLOP a pair instead of
// 14*d); hiding K4's score math behind the other warpgroup's products
// (its two warpgroups run in step, so the tensor cores idle during it);
// persistent CTAs.
//
// Launch contract: runs on the caller's stream, never synchronises and
// allocates nothing; dQ, dK and dV are allocated by the wrapper. Each
// entry point returns cudaGetLastError() of its launch
// (cudaErrorInvalidValue when a tensor map cannot describe an input).

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 256;    // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup

// Byte offsets in dynamic shared memory, from a base aligned to 1024:
// the CTA's own two tiles of OWN rows (Q, dO in K3; K, V in K4), a ring of
// STAGES streamed tile pairs of ROWS rows (K, V in K3; Q, dO in K4), K4's
// per-stage lse and delta, HANDOFF f32 [OWN x ROWS] score buffers (K4's
// S^T, from one consumer warpgroup to the other), then the barriers
// (own_full, full[STAGES], empty[STAGES], s_full[HANDOFF],
// s_empty[HANDOFF]). A bf16 row is D / 64 slabs of 64 columns, each slab
// 128-byte swizzled by TMA.
template <int D, int OWN, int ROWS, int STAGES, int HANDOFF>
struct Smem {
  static constexpr int kOwnRows = OWN;
  static constexpr int kRows = ROWS;
  static constexpr int kStages = STAGES;
  static constexpr int kHandoffs = HANDOFF;
  static constexpr int kSlabs = D / 64;                 // slabs of a row
  static constexpr int kOwnSlab = OWN * 128;            // [OWN x 64] slab
  static constexpr int kRingSlab = ROWS * 128;          // [ROWS x 64] slab
  static constexpr int kOwnTile = kSlabs * kOwnSlab;
  static constexpr int kRingTile = kSlabs * kRingSlab;
  static constexpr int kStageBytes = 2 * kRingTile;
  static constexpr int kOwn = 0;
  static constexpr int kRing = kOwn + 2 * kOwnTile;
  static constexpr int kRowVals = kRing + STAGES * kStageBytes;
  static constexpr int kHandoffBuf = OWN * ROWS * 4;
  static constexpr int kHandoff = kRowVals + STAGES * 2 * ROWS * 4;
  static constexpr int kBars = kHandoff + HANDOFF * kHandoffBuf;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * STAGES + 2 * HANDOFF);
  static constexpr int kAlloc =
      kBytes + 1024 < kMaxSmem ? kBytes + 1024 : kMaxSmem;
  static_assert(kBytes <= kMaxSmem, "shared memory layout too large");
};
// K3: 128 q rows a CTA (64 a consumer warpgroup), K/V streamed in 64-row
// tiles through 4 stages.
template <int D>
using DqSmem = Smem<D, 128, 64, 4, 0>;
// K4: 64 kv rows a CTA (both consumer warpgroups on the same rows), Q/dO
// streamed in 64-row tiles through 4 stages, S^T handed over through 2
// buffers (194 KB at d 128). 64-row q tiles give the score products
// m64n64; 32-row ones (m64n32, twice the stages) were slower.
template <int D>
using DkvSmem = Smem<D, 64, 64, 4, 2>;

}  // namespace

// Mirrors FlashBwdParams in skypilot_tpu_torch/ops/_build.py (ctypes).
struct FlashBwdParams {
  const void* q;       // [B, Sq, H, D] bf16
  const void* k;       // [B, Skv, KV, D] bf16
  const void* v;       // [B, Skv, KV, D] bf16
  const void* dout;    // [B, Sq, H, D] bf16
  const float* lse;    // [B, H, Sq] f32, contiguous
  const float* delta;  // [B, H, Sq] f32, contiguous
  void* dq;            // [B, Sq, H, D] bf16
  void* dk;            // [B, Skv, KV, D] bf16
  void* dv;            // [B, Skv, KV, D] bf16
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t do_sb, do_ss, do_sh;
  int64_t dq_sb, dq_ss, dq_sh;
  int64_t dk_sb, dk_ss, dk_sh;
  int64_t dv_sb, dv_ss, dv_sh;
  int32_t B, Sq, Skv, H, KV, D;
  int32_t causal, windowed, window, q_offset;
  float scale, softcap;  // softcap <= 0: off
};

namespace {

// Barriers of a CTA: own_full (the CTA's own tiles), full[s], empty[s],
// and K4's s_full[h], s_empty[h] (one arrival a thread of a warpgroup).
template <int STAGES, int HANDOFF>
__device__ __forceinline__ void init_barriers(uint32_t own_full,
                                              uint32_t full_count) {
  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(own_full + 8 + 8 * s, full_count);
      mbar_init(own_full + 8 + 8 * (STAGES + s), kConsumers / 32);
    }
    for (int h = 0; h < 2 * HANDOFF; ++h)
      mbar_init(own_full + 8 + 8 * (2 * STAGES + h), 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// P and dS of one score element in the reference's order: scale, softcap
// (keeping t = tanh for its Jacobian), P = exp(S - lse) in log2 units
// (lse2 = lse * log2 e; +inf gives P = 0), dS = P (dP - delta)
// (1 - t^2) scale. The caller masks P before dS.
template <bool SOFTCAP>
struct ScoreMath {
  float scale_log2, cap_in, cap_out, scale;
  __device__ __forceinline__ explicit ScoreMath(const FlashBwdParams& p)
      : scale_log2(p.scale * kLog2e),
        cap_in(SOFTCAP ? p.scale / p.softcap : 0.f),
        cap_out(p.softcap * kLog2e),
        scale(p.scale) {}
  // Returns P; *t gets tanh under softcap.
  __device__ __forceinline__ float prob(float s, float lse2, float* t) const {
    if (SOFTCAP) {
      *t = tanhf(s * cap_in);
      return fast_exp2(*t * cap_out - lse2);
    }
    return fast_exp2(s * scale_log2 - lse2);
  }
  __device__ __forceinline__ float dscore(float pe, float dp, float delta,
                                          float t) const {
    float ds = pe * (dp - delta);
    if (SOFTCAP) ds *= 1.f - t * t;
    return ds * scale;
  }
};

__device__ __forceinline__ void st_shared_f4(uint32_t addr, const float* v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

__device__ __forceinline__ void ld_shared_f4(uint32_t addr, float* v) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(addr)
               : "memory");
}

// d[N / 2] += A[64x16] B[16xN]; A in registers, B MN-major.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b) {
  if constexpr (N == 128)
    wgmma_rs_n128(d, a, b);
  else
    wgmma_rs_n64(d, a, b);
}

}  // namespace

// K3: dQ for one (128-row q tile, q head, batch).
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ FlashBwdParams p,
                        const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo) {
  using L = DqSmem<D>;
  constexpr int kRingRows = L::kRows;
  constexpr int kStages = L::kStages;
  constexpr int kOwnRows = L::kOwnRows;
  constexpr int kOwnSlab = L::kOwnSlab;
  constexpr int kRingSlab = L::kRingSlab;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  if (pad + L::kBytes > L::kAlloc) __trap();
  const uint32_t base = smem_u32(smem_raw) + pad;
  const uint32_t q_smem = base + L::kOwn;
  const uint32_t do_smem = q_smem + L::kOwnTile;
  const uint32_t ring = base + L::kRing;
  const uint32_t own_full = base + L::kBars;
  const uint32_t full0 = own_full + 8;              // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;      // empty[s]

  // Heavier (later) causal q tiles first, across all heads: blocks are
  // dispatched with blockIdx.x (the head) fastest, so every head's last
  // tile starts before any head's second to last.
  const int h = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q_start = q_tile * kOwnRows;

  // kv tiles [k_first, kv_hi): nothing past the causal frontier of the
  // CTA's last row nor before the window of its first row is read.
  int kv_hi = p.Skv;
  int kv_lo = 0;
  if (p.causal) {
    const int last_row = min(q_start + kOwnRows, p.Sq) - 1;
    kv_hi = min(p.Skv, p.q_offset + last_row + 1);
    if (p.windowed) kv_lo = max(0, p.q_offset + q_start - p.window + 1);
  }
  const int k_first = (kv_lo / kRingRows) * kRingRows;
  const int n_tiles =
      kv_hi > k_first ? (kv_hi - k_first + kRingRows - 1) / kRingRows : 0;

  init_barriers<kStages, L::kHandoffs>(own_full, 1);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer warpgroup: one thread issues the TMA loads ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers && n_tiles > 0) {
      mbar_expect_tx(own_full, 2 * L::kOwnTile);
      for (int sl = 0; sl < L::kSlabs; ++sl) {
        tma_load(q_smem + sl * kOwnSlab, &tq, own_full, sl * 64, h, q_start,
                 b);
        tma_load(do_smem + sl * kOwnSlab, &tdo, own_full, sl * 64, h,
                 q_start, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
        const uint32_t dst = ring + s * L::kStageBytes;
        const int k0 = k_first + i * kRingRows;
        mbar_expect_tx(full0 + 8 * s, L::kStageBytes);
        for (int sl = 0; sl < L::kSlabs; ++sl) {
          tma_load(dst + sl * kRingSlab, &tk, full0 + 8 * s, sl * 64, kvh,
                   k0, b);
          tma_load(dst + L::kRingTile + sl * kRingSlab, &tv, full0 + 8 * s,
                   sl * 64, kvh, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int tig = lane % 4;                        // thread in quad
    const int row0 = q_start + wg * 64 + (t / 32) * 16 + lane / 4;
    const ScoreMath<SOFTCAP> math(p);
    // lse (log2 units) and delta of this thread's rows row0, row0 + 8;
    // rows past Sq get lse = +inf (P = 0).
    float lse2[2];
    float dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      const int64_t at = (static_cast<int64_t>(b) * p.H + h) * p.Sq + row;
      lse2[r] = row < p.Sq ? p.lse[at] * kLog2e : __int_as_float(0x7f800000);
      dlt[r] = row < p.Sq ? p.delta[at] : 0.f;
    }
    const uint32_t q_wg = q_smem + wg * 64 * 128;   // 64 rows into each slab
    const uint32_t do_wg = do_smem + wg * 64 * 128;
    const int qp_lo = p.q_offset + q_start + wg * 64;  // warpgroup's rows
    const int qp_hi = qp_lo + 63;
    const bool rows_past_sq = q_start + wg * 64 >= p.Sq;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    if (n_tiles > 0) mbar_wait(own_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int stage = i % kStages;
      const int k0 = k_first + i * kRingRows;
      mbar_wait(full0 + 8 * stage, (i / kStages) & 1);
      // S = Q K^T and dP = dO V^T over the kv tile (SS wgmma, K-major).
      const uint32_t k_tile = ring + stage * L::kStageBytes;
      const uint32_t v_tile = k_tile + L::kRingTile;
      // No visible pair: past every row's frontier, below every row's
      // window, or no row below Sq.
      const bool dq_tile_hidden =
          rows_past_sq ||
          (p.causal &&
           (k0 > qp_hi ||
            (p.windowed && k0 + kRingRows - 1 <= qp_lo - p.window)));
      if (!dq_tile_hidden) {
        float sc[32];
        float dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t own = (kk / 4) * kOwnSlab + (kk % 4) * 32;
          const uint32_t streamed = (kk / 4) * kRingSlab + (kk % 4) * 32;
          wgmma_ss_n64(sc, desc_b128(q_wg + own, 16, 1024),
                       desc_b128(k_tile + streamed, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t own = (kk / 4) * kOwnSlab + (kk % 4) * 32;
          const uint32_t streamed = (kk / 4) * kRingSlab + (kk % 4) * 32;
          wgmma_ss_n64(dp, desc_b128(do_wg + own, 16, 1024),
                       desc_b128(v_tile + streamed, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<32>(sc);
        fence_regs<32>(dp);

        // Only a tile that reaches past Skv, crosses the causal frontier
        // of the warpgroup's first row or the window of its last row is
        // masked per element.
        const bool past_skv = k0 + kRingRows > p.Skv;
        const bool crosses_frontier =
            p.causal && k0 + kRingRows - 1 > qp_lo;
        const bool below_window =
            p.causal && p.windowed && k0 <= qp_hi - p.window;
        const bool edge = past_skv || crosses_frontier || below_window;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float th = 0.f;
            float pe = math.prob(sc[4 * j + e], lse2[e >> 1], &th);
            if (edge) {
              const int kpos = k0 + j * 8 + tig * 2 + (e & 1);
              const int qpos = p.q_offset + row0 + (e >> 1) * 8;
              bool ok = kpos < p.Skv;
              if (p.causal) {
                ok = ok && qpos >= kpos;
                if (p.windowed) ok = ok && (qpos - kpos < p.window);
              }
              if (!ok) pe = 0.f;
            }
            sc[4 * j + e] = math.dscore(pe, dp[4 * j + e], dlt[e >> 1], th);
          }
        }

        // dQ += dS K: the dS accumulators of columns [16 kt, 16 kt + 16)
        // are the A fragment of k-step kt, all rounded before the fence;
        // K's k-step kt is its rows 16 kt.. (2 KB into each slab),
        // MN-major, 64-column slabs kRingSlab apart.
        uint32_t da[4][4];
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            da[kt][r] = pack_f32(sc[8 * kt + 2 * r], sc[8 * kt + 2 * r + 1]);
        }
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
          const uint64_t kd = desc_b128(k_tile + kt * 16 * 128, kRingSlab,
                                        1024);
          wgmma_rs<D>(dq, da[kt], kd);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<D / 2>(dq);
      }
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    }

    __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb +
                         h * p.dq_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row >= p.Sq) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dqp + row * p.dq_ss + j * 8 + tig * 2) =
            pack_f32(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
      }
    }
  }
}

// One consumer warpgroup of K4 over the CTA's 64 kv rows. IS_DK false:
// S^T = K Q^T, handed to the other warpgroup, then P^T and dV += P^T dO.
// IS_DK true: dP^T = V dO^T while the other computes S^T, then S^T from
// the hand-over buffer, P^T and dS^T, dK += dS^T Q. Each warpgroup runs
// two of the four products (4*d FLOP a visible pair) and holds one
// accumulator (64 f32 a thread at d 128): with dK and dV both in one
// warpgroup (128 f32) ptxas, which plans the wgmma pipeline within the
// 168 registers of a 384-thread launch, spilled and serialised every
// wgmma.
template <int D, bool SOFTCAP, bool IS_DK>
__device__ __forceinline__ void dkv_consumer(const FlashBwdParams& p,
                                             uint32_t base, int k_start,
                                             int kvh, int b, int group,
                                             int q_first, int n_q) {
  using L = DkvSmem<D>;
  constexpr int kRingRows = L::kRows;
  constexpr int kStages = L::kStages;
  constexpr int kOwnSlab = L::kOwnSlab;
  constexpr int kRingSlab = L::kRingSlab;
  static_assert(kRingRows == 64, "score products are m64n64");
  const uint32_t k_smem = base + L::kOwn;
  const uint32_t v_smem = k_smem + L::kOwnTile;
  const uint32_t ring = base + L::kRing;
  const uint32_t own_full = base + L::kBars;
  const uint32_t full0 = own_full + 8;
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t s_full0 = empty0 + 8 * kStages;    // S^T written
  const uint32_t s_empty0 = s_full0 + 8 * L::kHandoffs;  // S^T read
  const int n_steps = group * n_q;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int tig = lane % 4;
  const int krow0 = k_start + (t / 32) * 16 + lane / 4;  // rows krow0, +8
  const ScoreMath<SOFTCAP> math(p);
  const int kp_lo = k_start;                        // the CTA's kv rows
  const int kp_hi = k_start + L::kOwnRows - 1;
  // This thread's slice of a hand-over buffer: its accumulator values in
  // 16-byte groups, 128 threads apart (each thread reads what the thread
  // of the same index in the other warpgroup wrote).
  const uint32_t handoff = base + L::kHandoff + t * 16;
  int visible = 0;                                  // hand-overs so far

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (n_steps > 0) mbar_wait(own_full, 0);

  for (int i = 0; i < n_steps; ++i) {
    const int stage = i % kStages;
    const int hh = i / n_q;                         // q head in the group
    const int q0 = q_first + (i - hh * n_q) * kRingRows;
    const int qp0 = p.q_offset + q0;                // tile's first q pos
    mbar_wait(full0 + 8 * stage, (i / kStages) & 1);
    const uint32_t q_tile = ring + stage * L::kStageBytes;
    const uint32_t do_tile = q_tile + L::kRingTile;
    const uint32_t vals = base + L::kRowVals + stage * 2 * kRingRows * 4;
    // No visible pair: every row past Skv, every query before every key,
    // or every query past every key's window.
    const bool dkv_tile_hidden =
        kp_lo >= p.Skv ||
        (p.causal && (qp0 + kRingRows - 1 < kp_lo ||
                      (p.windowed && qp0 - kp_hi >= p.window)));
    if (!dkv_tile_hidden) {
      // S^T = K Q^T (dV's warpgroup) or dP^T = V dO^T (dK's): SS wgmma,
      // K-major, kv rows as M.
      float st[kRingRows / 2];
      float dpt[IS_DK ? kRingRows / 2 : 1];
      float* acc_ss = IS_DK ? dpt : st;
      const uint32_t a_own = IS_DK ? v_smem : k_smem;
      const uint32_t b_ring = IS_DK ? do_tile : q_tile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t own = (kk / 4) * kOwnSlab + (kk % 4) * 32;
        const uint32_t streamed = (kk / 4) * kRingSlab + (kk % 4) * 32;
        wgmma_ss_n64(acc_ss, desc_b128(a_own + own, 16, 1024),
                     desc_b128(b_ring + streamed, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<kRingRows / 2>(acc_ss);

      // Hand S^T over: buffer visible % kHandoffs, its
      // (visible / kHandoffs)-th use.
      const int buf = visible % L::kHandoffs;
      const uint32_t parity = (visible / L::kHandoffs) & 1;
      ++visible;
      const uint32_t slot = handoff + buf * L::kHandoffBuf;
      if constexpr (IS_DK) {
        mbar_wait(s_full0 + 8 * buf, parity);
#pragma unroll
        for (int c = 0; c < kRingRows / 8; ++c)
          ld_shared_f4(slot + c * 128 * 16, st + 4 * c);
        mbar_arrive(s_empty0 + 8 * buf);
      } else {
        mbar_wait(s_empty0 + 8 * buf, parity ^ 1);
#pragma unroll
        for (int c = 0; c < kRingRows / 8; ++c)
          st_shared_f4(slot + c * 128 * 16, st + 4 * c);
        mbar_arrive(s_full0 + 8 * buf);
      }

      // P^T (and dS^T), element (kv row, q column); lse and delta per
      // column. Only a tile reaching past Skv or Sq, crossing the causal
      // frontier or the window's edge is masked per element. Each
      // 8-column group is rounded into its half of a k-step's A fragment
      // as soon as it is done: the accumulators of q columns
      // [16 kt, 16 kt + 16) are k-step kt of the RS product.
      const bool edge_rows = kp_hi >= p.Skv || q0 + kRingRows > p.Sq;
      const bool dkv_crosses_frontier = p.causal && qp0 < kp_hi;
      const bool dkv_below_window =
          p.causal && p.windowed && qp0 + kRingRows - 1 - kp_lo >= p.window;
      const bool edge = edge_rows || dkv_crosses_frontier || dkv_below_window;
      uint32_t fa[kRingRows / 16][4];
#pragma unroll
      for (int j = 0; j < kRingRows / 8; ++j) {
        const uint2 lp = ld_shared_v2(vals + (j * 8 + tig * 2) * 4);
        uint2 dl = make_uint2(0u, 0u);
        if constexpr (IS_DK)
          dl = ld_shared_v2(vals + (kRingRows + j * 8 + tig * 2) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float col_lse = __uint_as_float((e & 1) ? lp.y : lp.x);
          const float col_dlt = __uint_as_float((e & 1) ? dl.y : dl.x);
          float th = 0.f;
          float pe = math.prob(st[4 * j + e], col_lse, &th);
          if (edge) {
            const int kpos = krow0 + (e >> 1) * 8;
            const int qrow = q0 + j * 8 + tig * 2 + (e & 1);
            const int qpos = p.q_offset + qrow;
            bool ok = kpos < p.Skv && qrow < p.Sq;
            if (p.causal) {
              ok = ok && qpos >= kpos;
              if (p.windowed) ok = ok && (qpos - kpos < p.window);
            }
            if (!ok) pe = 0.f;
          }
          if constexpr (IS_DK)
            st[4 * j + e] = math.dscore(pe, dpt[4 * j + e], col_dlt, th);
          else
            st[4 * j + e] = pe;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
          fa[j / 2][(j % 2) * 2 + r] =
              pack_f32(st[4 * j + 2 * r], st[4 * j + 2 * r + 1]);
      }

      // dV += P^T dO or dK += dS^T Q: dO and Q MN-major B operands, k-step
      // kt their rows 16 kt.. of each slab.
      const uint32_t b_tile = IS_DK ? q_tile : do_tile;
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < kRingRows / 16; ++kt)
        wgmma_rs<D>(acc, fa[kt],
                    desc_b128(b_tile + kt * 16 * 128, kRingSlab, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<D / 2>(acc);
    }
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);
  }

  __nv_bfloat16* out =
      IS_DK ? static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh
            : static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
  const int64_t out_ss = IS_DK ? p.dk_ss : p.dv_ss;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow0 + r * 8;
    if (row >= p.Skv) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(out + row * out_ss + j * 8 + tig * 2) =
          pack_f32(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// K4: dK and dV for one (64-row kv tile, kv head, batch), summed over the
// q heads of the GQA group.
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ FlashBwdParams p,
                         const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo) {
  using L = DkvSmem<D>;
  constexpr int kRingRows = L::kRows;
  constexpr int kStages = L::kStages;
  constexpr int kOwnRows = L::kOwnRows;
  constexpr int kLaneRows = kRingRows / 32;  // rows a producer lane
  static_assert(kRingRows % 32 == 0, "whole rows for every producer lane");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  if (pad + L::kBytes > L::kAlloc) __trap();
  uint8_t* smem = smem_raw + pad;
  const uint32_t base = smem_u32(smem);
  const uint32_t k_smem = base + L::kOwn;
  const uint32_t v_smem = k_smem + L::kOwnTile;
  const uint32_t ring = base + L::kRing;
  const uint32_t own_full = base + L::kBars;
  const uint32_t full0 = own_full + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int kvh = blockIdx.x;
  const int b = blockIdx.z;
  const int group = p.H / p.KV;
  // Under a causal mask the first kv tiles see the most queries: they go
  // first, across all kv heads (blockIdx.x, the head, is dispatched
  // fastest).
  const int k_start = blockIdx.y * kOwnRows;

  // Visible local q rows [q_lo, q_hi): q_pos >= k_pos, and under a window
  // q_pos - k_pos < window (the reference's _clamped_q_index as bounds).
  int q_lo = 0;
  int q_hi = p.Sq;
  if (p.causal) {
    q_lo = max(0, k_start - p.q_offset);
    if (p.windowed) {
      q_hi = min(p.Sq, k_start + kOwnRows - 1 + p.window - p.q_offset);
    }
  }
  const int q_first = (q_lo / kRingRows) * kRingRows;
  const int n_q =
      q_hi > q_first ? (q_hi - q_first + kRingRows - 1) / kRingRows : 0;
  // Stage i holds q head kvh * group + i / n_q, q tile i % n_q.
  const int n_steps = group * n_q;

  // full[s]: the 32 lanes of the producer warp, one with the TMA bytes.
  init_barriers<kStages, L::kHandoffs>(own_full, 32);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer warp: lse/delta by plain loads, Q/dO by TMA ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int pt = threadIdx.x - kConsumers;
    if (pt < 32 && n_steps > 0) {
      if (pt == 0) {
        mbar_expect_tx(own_full, 2 * L::kOwnTile);
        for (int sl = 0; sl < L::kSlabs; ++sl) {
          tma_load(k_smem + sl * L::kOwnSlab, &tk, own_full, sl * 64, kvh,
                   k_start, b);
          tma_load(v_smem + sl * L::kOwnSlab, &tv, own_full, sl * 64, kvh,
                   k_start, b);
        }
      }
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % kStages;
        const int head = kvh * group + i / n_q;
        const int q0 = q_first + (i % n_q) * kRingRows;
        // This lane's rows q0 + pt + 32 r, read before the wait; rows past
        // Sq get lse = +inf (P = 0) and delta = 0.
        const int64_t row_base = (static_cast<int64_t>(b) * p.H + head) * p.Sq;
        float lse2[kLaneRows];
        float dlt[kLaneRows];
#pragma unroll
        for (int r = 0; r < kLaneRows; ++r) {
          const int row = q0 + pt + 32 * r;
          const bool in = row < p.Sq;
          lse2[r] = in ? p.lse[row_base + row] * kLog2e
                       : __int_as_float(0x7f800000);
          dlt[r] = in ? p.delta[row_base + row] : 0.f;
        }
        mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
        float* vals = reinterpret_cast<float*>(smem + L::kRowVals) +
                      s * 2 * kRingRows;
#pragma unroll
        for (int r = 0; r < kLaneRows; ++r) {
          vals[pt + 32 * r] = lse2[r];
          vals[kRingRows + pt + 32 * r] = dlt[r];
        }
        if (pt == 0) {
          const uint32_t dst = ring + s * L::kStageBytes;
          mbar_expect_tx(full0 + 8 * s, L::kStageBytes);
          for (int sl = 0; sl < L::kSlabs; ++sl) {
            tma_load(dst + sl * L::kRingSlab, &tq, full0 + 8 * s, sl * 64,
                     head, q0, b);
            tma_load(dst + L::kRingTile + sl * L::kRingSlab, &tdo,
                     full0 + 8 * s, sl * 64, head, q0, b);
          }
        } else {
          mbar_arrive(full0 + 8 * s);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 0 sums dV, warpgroup 1 dK ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    if (wg == 0)
      dkv_consumer<D, SOFTCAP, false>(p, base, k_start, kvh, b, group,
                                      q_first, n_q);
    else
      dkv_consumer<D, SOFTCAP, true>(p, base, k_start, kvh, b, group,
                                     q_first, n_q);
  }
}

// ---- host side: tensor maps and launch ----

namespace {

// K3 (DKV false) or K4: q/dO boxes of the CTA's own rows in K3 and of
// the ring's rows in K4, k/v boxes the other way round.
template <int D, bool SOFTCAP, bool DKV>
int launch(const FlashBwdParams& p, cudaStream_t stream) {
  const int q_rows = DKV ? DkvSmem<D>::kRows : DqSmem<D>::kOwnRows;
  const int kv_rows = DKV ? DkvSmem<D>::kOwnRows : DqSmem<D>::kRows;
  const int own_rows = DKV ? DkvSmem<D>::kOwnRows : DqSmem<D>::kOwnRows;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, p.q, false, p.q_sb, p.q_ss, p.q_sh, p.B, p.Sq, p.H, D,
                q_rows) ||
      !make_map(&tk, p.k, false, p.k_sb, p.k_ss, p.k_sh, p.B, p.Skv, p.KV,
                D, kv_rows) ||
      !make_map(&tv, p.v, false, p.v_sb, p.v_ss, p.v_sh, p.B, p.Skv, p.KV,
                D, kv_rows) ||
      !make_map(&tdo, p.dout, false, p.do_sb, p.do_ss, p.do_sh, p.B, p.Sq,
                p.H, D, q_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = DKV ? flash_bwd_dkv_kernel<D, SOFTCAP>
                    : flash_bwd_dq_kernel<D, SOFTCAP>;
  constexpr int smem = DKV ? DkvSmem<D>::kAlloc : DqSmem<D>::kAlloc;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = DKV ? dim3(p.KV, (p.Skv + own_rows - 1) / own_rows, p.B)
                        : dim3(p.H, (p.Sq + own_rows - 1) / own_rows, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p, tq, tk, tv, tdo);
  return static_cast<int>(cudaGetLastError());
}

template <bool DKV>
int dispatch(const FlashBwdParams* p, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool softcap = p->softcap > 0.f;
  switch (p->D) {
    case 64:
      return softcap ? launch<64, true, DKV>(*p, stream)
                     : launch<64, false, DKV>(*p, stream);
    case 128:
      return softcap ? launch<128, true, DKV>(*p, stream)
                     : launch<128, false, DKV>(*p, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Size of FlashBwdParams, so the binding can check its ctypes mirror.
int skytpu_flash_bwd_params_size() {
  return static_cast<int>(sizeof(FlashBwdParams));
}

// K3: dQ.
int skytpu_flash_bwd_dq(const FlashBwdParams* p, void* stream) {
  return dispatch<false>(p, stream);
}

// K4: dK and dV, GQA groups summed in the kernel.
int skytpu_flash_bwd_dkv(const FlashBwdParams* p, void* stream) {
  return dispatch<true>(p, stream);
}

}  // extern "C"
