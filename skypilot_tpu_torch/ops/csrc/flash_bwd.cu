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
// the tensor cores (989 TFLOP/s dense bf16).
//
// What this first design does about it:
//  * K3: one block of 4 warps per (64-row q tile, q head, batch); each
//    warp owns 16 query rows with their Q and dO fragments in registers.
//    The kv loop runs over [lo, hi) with K1's bounds (the reference's
//    _clamped_kv_index), 32 kv positions a tile, so tiles past the causal
//    frontier or before the window are never read. The dQ accumulator
//    stays in f32 registers; the dS accumulator fragment is repacked as
//    the A operand of dS K, as K1 repacks P. No atomics.
//  * K4: one block of 4 warps per (64-row kv tile, kv head, batch); each
//    warp owns 16 kv rows. The block loops over the q heads of its GQA
//    group and, inside, over 32-row q tiles in the visible range (the
//    reference's _clamped_q_index). It computes S^T = K Q^T and
//    dP^T = V dO^T with kv rows as the M dimension, so P^T and dS^T are
//    already accumulator fragments that repack as the A operands of
//    P^T dO and dS^T Q; lse and delta are read per column. dK and dV of
//    the kv head accumulate in f32 registers across the whole group, so
//    the reference's per-q-head partials and its group sum outside the
//    kernel are gone: deterministic, and rounded to bf16 once.
//  * The transposed B operands (K in dS K, dO in P^T dO, Q in dS^T Q) are
//    read with ldmatrix.trans from the padded shared-memory tiles.
//  * Registers: K4 keeps dK + dV (2 x 64 f32 a thread at head_dim 128)
//    live across the loop; the q tile is 32 rows (S^T and dP^T take 16
//    registers each) and K/V fragments are re-read from shared memory
//    rather than held, to stay clear of spills at 4 warps. K3 keeps Q and
//    dO fragments (64 registers) and dQ (64) live, with a 32-wide kv tile.
//    ptxas at head_dim 128: 238 (K4) and 234 (K3) registers a thread, no
//    spills; 2 blocks of 4 warps fit an SM.
// Not yet done (later work): wgmma, TMA, a cp.async pipeline; loads and
// math do not overlap here.
//
// Launch contract: runs on the caller's stream, never synchronises and
// allocates nothing; dQ, dK and dV are allocated by the wrapper. Each
// entry point returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // 4 warps
constexpr int kBQ3 = 64;           // K3: q rows per block (4 warps x 16)
constexpr int kBK3 = 32;           // K3: kv positions per tile
constexpr int kBK4 = 64;           // K4: kv rows per block (4 warps x 16)
constexpr int kBQ4 = 32;           // K4: q rows per tile

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// B fragments of two adjacent n-tiles of an m16n8k16 product whose B is a
// row-major shared-memory tile T[k][n] (k = rows): ldmatrix.x4.trans,
// lanes 0-15 address rows k0..k0+15 at column n0, lanes 16-31 the same
// rows at column n0 + 8. r[0], r[1] = (b0, b1) of n-tile n0; r[2], r[3] of
// n-tile n0 + 8. `row_ptr` is this lane's row address.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r,
                                              const __nv_bfloat16* row_ptr) {
  const uint32_t a =
      static_cast<uint32_t>(__cvta_generic_to_shared(row_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// A fragment (16 x 16, row-major) of rows r0..r0+15, columns c0..c0+15 of
// a row-major bf16 tile with leading dimension ld.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* t,
                                       int ld, int r0, int c0, int g,
                                       int tig) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a[r] = *reinterpret_cast<const uint32_t*>(
        t + (r0 + g + (r & 1) * 8) * ld + c0 + (r >> 1) * 8 + tig * 2);
  }
}

// Stage rows [r0, r0 + ROWS) of one head of a [B, S, heads, D] bf16 tensor
// into a padded shared-memory tile; rows at or past `limit` are zero.
template <int ROWS, int D>
__device__ __forceinline__ void stage(__nv_bfloat16* tile,
                                      const __nv_bfloat16* base, int64_t ss,
                                      int r0, int limit, int tid) {
  constexpr int LD = D + 8;
  for (int c = tid; c < ROWS * D / 8; c += kThreads) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (r0 + r < limit) {
      w = *reinterpret_cast<const uint4*>(base + (r0 + r) * ss + col);
    }
    *reinterpret_cast<uint4*>(&tile[r * LD + col]) = w;
  }
}

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

// K3: dQ for one (64-row q tile, q head, batch).
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const FlashBwdParams p) {
  constexpr int LD = D + 8;          // padded smem row: no bank conflicts
  constexpr int KSTEPS = D / 16;     // k-steps of QK^T and dO V^T
  constexpr int DTILES = D / 8;      // n-tiles of dQ
  constexpr int STILES = kBK3 / 8;   // n-tiles of the score tile

  __shared__ __align__(16) __nv_bfloat16 k_tile[kBK3 * LD];
  __shared__ __align__(16) __nv_bfloat16 v_tile[kBK3 * LD];

  // Heavier (later) causal q tiles first: they finish last otherwise.
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;    // fragment row group
  const int tig = lane & 3;   // thread in group
  const int q_start = q_tile * kBQ3;
  const int row0 = q_start + warp * 16 + g;  // this thread's rows: row0, row0+8

  // Q and dO fragments (A operands) straight into registers; rows past Sq
  // are zero and never stored.
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dop = static_cast<const __nv_bfloat16*>(p.dout) +
                             b * p.do_sb + h * p.do_sh;
  uint32_t qf[KSTEPS][4];
  uint32_t df[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + (r & 1) * 8;
      const int col = kk * 16 + (r >> 1) * 8 + tig * 2;
      const bool in = row < p.Sq;
      qf[kk][r] = in ? *reinterpret_cast<const uint32_t*>(qp + row * p.q_ss +
                                                          col)
                     : 0u;
      df[kk][r] = in ? *reinterpret_cast<const uint32_t*>(
                           dop + row * p.do_ss + col)
                     : 0u;
    }
  }
  // lse and delta of this thread's two rows; rows past Sq get lse = +inf
  // (P = 0).
  float lse_r[2];
  float dlt_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    const int64_t at = (static_cast<int64_t>(b) * p.H + h) * p.Sq + row;
    lse_r[i] = row < p.Sq ? p.lse[at] : __int_as_float(0x7f800000);
    dlt_r[i] = row < p.Sq ? p.delta[at] : 0.f;
  }

  int kv_hi = p.Skv;
  int kv_lo = 0;
  if (p.causal) {
    const int last_row = min(q_start + kBQ3, p.Sq) - 1;
    kv_hi = min(p.Skv, p.q_offset + last_row + 1);
    if (p.windowed) kv_lo = max(0, p.q_offset + q_start - p.window + 1);
  }

  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) +
                            b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) +
                            b * p.v_sb + kvh * p.v_sh;

  float dq[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i)
    dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  const int qpos[2] = {p.q_offset + row0, p.q_offset + row0 + 8};

  for (int k0 = (kv_lo / kBK3) * kBK3; k0 < kv_hi; k0 += kBK3) {
    __syncthreads();  // the previous tile is consumed
    stage<kBK3, D>(k_tile, kb, p.k_ss, k0, p.Skv, tid);
    stage<kBK3, D>(v_tile, vb, p.v_ss, k0, p.Skv, tid);
    __syncthreads();

    // dP = dO V^T and S = Q K^T for this warp's 16 rows x kBK3 columns.
    float dp[STILES][4];
    float s[STILES][4];
#pragma unroll
    for (int j = 0; j < STILES; ++j) {
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const __nv_bfloat16* vr = &v_tile[(j * 8 + g) * LD + kk * 16 + tig * 2];
        mma_16816(dp[j], df[kk], *reinterpret_cast<const uint32_t*>(vr),
                  *reinterpret_cast<const uint32_t*>(vr + 8));
        const __nv_bfloat16* kr = &k_tile[(j * 8 + g) * LD + kk * 16 + tig * 2];
        mma_16816(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // dS in the reference's order: scale, softcap (keeping tanh for its
    // Jacobian), mask, P = exp(S - lse), dS = P (dP - delta) (1 - t^2),
    // then the second scale.
#pragma unroll
    for (int j = 0; j < STILES; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int kpos = k0 + j * 8 + tig * 2 + (e & 1);
        float x = s[j][e] * p.scale;
        float t = 0.f;
        if (SOFTCAP) {
          t = tanhf(x / p.softcap);
          x = p.softcap * t;
        }
        bool ok = kpos < p.Skv;
        if (p.causal) {
          ok = ok && qpos[half] >= kpos;
          if (p.windowed) ok = ok && (qpos[half] - kpos < p.window);
        }
        const float pe = ok ? expf(x - lse_r[half]) : 0.f;
        float ds = pe * (dp[j][e] - dlt_r[half]);
        if (SOFTCAP) ds *= 1.f - t * t;
        s[j][e] = ds * p.scale;
      }
    }

    // dQ += dS K: the dS accumulators of n-tiles (2t, 2t+1) are the A
    // fragment of k-step t; K (B operand, k = kv, n = d) by ldmatrix.trans.
#pragma unroll
    for (int t = 0; t < kBK3 / 16; ++t) {
      const uint32_t a[4] = {
          pack_f32(s[2 * t][0], s[2 * t][1]),
          pack_f32(s[2 * t][2], s[2 * t][3]),
          pack_f32(s[2 * t + 1][0], s[2 * t + 1][1]),
          pack_f32(s[2 * t + 1][2], s[2 * t + 1][3]),
      };
#pragma unroll
      for (int dt = 0; dt < DTILES; dt += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, &k_tile[(t * 16 + (lane & 15)) * LD +
                                  (dt + (lane >> 4)) * 8]);
        mma_16816(dq[dt], a, bf[0], bf[1]);
        mma_16816(dq[dt + 1], a, bf[2], bf[3]);
      }
    }
  }

  __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb +
                       h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      *reinterpret_cast<uint32_t*>(dqp + row * p.dq_ss + dt * 8 + tig * 2) =
          pack_f32(dq[dt][2 * i], dq[dt][2 * i + 1]);
    }
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * kBK4 + 2 * kBQ4) * (D + 8) * 2 + 2 * kBQ4 * 4;
}

// K4: dK and dV for one (64-row kv tile, kv head, batch), summed over the
// q heads of the GQA group.
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const FlashBwdParams p) {
  constexpr int LD = D + 8;
  constexpr int KSTEPS = D / 16;     // k-steps of K Q^T and V dO^T
  constexpr int DTILES = D / 8;      // n-tiles of dK and dV
  constexpr int QTILES = kBQ4 / 8;   // n-tiles of the S^T tile

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_tile = k_tile + kBK4 * LD;
  __nv_bfloat16* q_tile = v_tile + kBK4 * LD;
  __nv_bfloat16* do_tile = q_tile + kBQ4 * LD;
  float* lse_t = reinterpret_cast<float*>(do_tile + kBQ4 * LD);
  float* dlt_t = lse_t + kBQ4;

  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.H / p.KV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  // Under a causal mask the first kv tiles see the most queries: they go
  // first.
  const int k_start = blockIdx.x * kBK4;
  const int krow0 = k_start + warp * 16 + g;  // this thread's kv rows
  const int kpos[2] = {krow0, krow0 + 8};

  stage<kBK4, D>(k_tile,
                 static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb +
                     kvh * p.k_sh,
                 p.k_ss, k_start, p.Skv, tid);
  stage<kBK4, D>(v_tile,
                 static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb +
                     kvh * p.v_sh,
                 p.v_ss, k_start, p.Skv, tid);

  // Visible local q rows [q_lo, q_hi): q_pos >= k_pos, and under a window
  // q_pos - k_pos < window (the reference's _clamped_q_index as bounds).
  int q_lo = 0;
  int q_hi = p.Sq;
  if (p.causal) {
    q_lo = max(0, k_start - p.q_offset);
    if (p.windowed) {
      q_hi = min(p.Sq, k_start + kBK4 - 1 + p.window - p.q_offset);
    }
  }

  float dk[DTILES][4];
  float dv[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) +
                              b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* dob = static_cast<const __nv_bfloat16*>(p.dout) +
                               b * p.do_sb + h * p.do_sh;
    const int64_t row_base = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
    for (int q0 = (q_lo / kBQ4) * kBQ4; q0 < q_hi; q0 += kBQ4) {
      __syncthreads();  // the previous q tile is consumed
      stage<kBQ4, D>(q_tile, qb, p.q_ss, q0, p.Sq, tid);
      stage<kBQ4, D>(do_tile, dob, p.do_ss, q0, p.Sq, tid);
      for (int c = tid; c < kBQ4; c += kThreads) {
        const bool in = q0 + c < p.Sq;
        lse_t[c] = in ? p.lse[row_base + q0 + c] : __int_as_float(0x7f800000);
        dlt_t[c] = in ? p.delta[row_base + q0 + c] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 kv rows x kBQ4
      // query columns. K and V fragments are re-read from shared memory.
      float st[QTILES][4];
      float dpt[QTILES][4];
#pragma unroll
      for (int j = 0; j < QTILES; ++j) {
        st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
        dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t ka[4];
        uint32_t va[4];
        load_a(ka, k_tile, LD, warp * 16, kk * 16, g, tig);
        load_a(va, v_tile, LD, warp * 16, kk * 16, g, tig);
#pragma unroll
        for (int j = 0; j < QTILES; ++j) {
          const __nv_bfloat16* qr =
              &q_tile[(j * 8 + g) * LD + kk * 16 + tig * 2];
          mma_16816(st[j], ka, *reinterpret_cast<const uint32_t*>(qr),
                    *reinterpret_cast<const uint32_t*>(qr + 8));
          const __nv_bfloat16* dr =
              &do_tile[(j * 8 + g) * LD + kk * 16 + tig * 2];
          mma_16816(dpt[j], va, *reinterpret_cast<const uint32_t*>(dr),
                    *reinterpret_cast<const uint32_t*>(dr + 8));
        }
      }

      // P^T and dS^T, element (kv row, q column); lse and delta per column.
#pragma unroll
      for (int j = 0; j < QTILES; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1;
          const int col = j * 8 + tig * 2 + (e & 1);
          const int qrow = q0 + col;
          const int qp = p.q_offset + qrow;
          float x = st[j][e] * p.scale;
          float t = 0.f;
          if (SOFTCAP) {
            t = tanhf(x / p.softcap);
            x = p.softcap * t;
          }
          bool ok = kpos[half] < p.Skv && qrow < p.Sq;
          if (p.causal) {
            ok = ok && qp >= kpos[half];
            if (p.windowed) ok = ok && (qp - kpos[half] < p.window);
          }
          const float pe = ok ? expf(x - lse_t[col]) : 0.f;
          float ds = pe * (dpt[j][e] - dlt_t[col]);
          if (SOFTCAP) ds *= 1.f - t * t;
          st[j][e] = pe;
          dpt[j][e] = ds * p.scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q: the accumulators of n-tiles
      // (2t, 2t+1) are the A fragment of k-step t (k = q); dO and Q
      // (B operands, k = q, n = d) by ldmatrix.trans.
#pragma unroll
      for (int t = 0; t < kBQ4 / 16; ++t) {
        const uint32_t pa[4] = {
            pack_f32(st[2 * t][0], st[2 * t][1]),
            pack_f32(st[2 * t][2], st[2 * t][3]),
            pack_f32(st[2 * t + 1][0], st[2 * t + 1][1]),
            pack_f32(st[2 * t + 1][2], st[2 * t + 1][3]),
        };
        const uint32_t sa[4] = {
            pack_f32(dpt[2 * t][0], dpt[2 * t][1]),
            pack_f32(dpt[2 * t][2], dpt[2 * t][3]),
            pack_f32(dpt[2 * t + 1][0], dpt[2 * t + 1][1]),
            pack_f32(dpt[2 * t + 1][2], dpt[2 * t + 1][3]),
        };
        const int lrow = (t * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
        for (int dt = 0; dt < DTILES; dt += 2) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, &do_tile[lrow + dt * 8]);
          mma_16816(dv[dt], pa, bf[0], bf[1]);
          mma_16816(dv[dt + 1], pa, bf[2], bf[3]);
          ldsm_x4_trans(bf, &q_tile[lrow + dt * 8]);
          mma_16816(dk[dt], sa, bf[0], bf[1]);
          mma_16816(dk[dt + 1], sa, bf[2], bf[3]);
        }
      }
    }
  }

  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb +
                       kvh * p.dk_sh;
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb +
                       kvh * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kpos[i];
    if (row >= p.Skv) continue;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      const int col = dt * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(dkp + row * p.dk_ss + col) =
          pack_f32(dk[dt][2 * i], dk[dt][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvp + row * p.dv_ss + col) =
          pack_f32(dv[dt][2 * i], dv[dt][2 * i + 1]);
    }
  }
}

template <int D, bool SOFTCAP>
static int launch_dq(const FlashBwdParams& p, cudaStream_t stream) {
  const dim3 grid((p.Sq + kBQ3 - 1) / kBQ3, p.H, p.B);
  flash_bwd_dq_kernel<D, SOFTCAP><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool SOFTCAP>
static int launch_dkv(const FlashBwdParams& p, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D>();
  // Above 48 KB only as opted-in dynamic shared memory.
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, SOFTCAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.Skv + kBK4 - 1) / kBK4, p.KV, p.B);
  flash_bwd_dkv_kernel<D, SOFTCAP><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// Size of FlashBwdParams, so the binding can check its ctypes mirror.
int skytpu_flash_bwd_params_size() {
  return static_cast<int>(sizeof(FlashBwdParams));
}

// K3: dQ.
int skytpu_flash_bwd_dq(const FlashBwdParams* p, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool softcap = p->softcap > 0.f;
  switch (p->D) {
    case 64:
      return softcap ? launch_dq<64, true>(*p, stream)
                     : launch_dq<64, false>(*p, stream);
    case 128:
      return softcap ? launch_dq<128, true>(*p, stream)
                     : launch_dq<128, false>(*p, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4: dK and dV, GQA groups summed in the kernel.
int skytpu_flash_bwd_dkv(const FlashBwdParams* p, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool softcap = p->softcap > 0.f;
  switch (p->D) {
    case 64:
      return softcap ? launch_dkv<64, true>(*p, stream)
                     : launch_dkv<64, false>(*p, stream);
    case 128:
      return softcap ? launch_dkv<128, true>(*p, stream)
                     : launch_dkv<128, false>(*p, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
