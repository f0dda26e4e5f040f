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
// cache of a few thousand positions does 4*B*H*T*S_visible*D FLOP over
// O((T + S_visible)*D) bytes per (b, h), far above the H100's ~295 FLOP per
// byte, so it is bound by the tensor cores (989 TFLOP/s dense bf16).
//
// What this first design does about it:
//  * The TPU grid's sequential kv axis becomes a loop inside the block:
//    one block of 4 warps per (q-tile of 64 rows, head, batch); each warp
//    owns 16 query rows, held in registers as mma.sync A fragments.
//  * The kv loop runs only over [lo, hi): hi = min(Skv, q_offset + last
//    row + 1), lo = q_offset + first row - window + 1 (the reference's
//    _clamped_kv_index as loop bounds), so tiles past the causal frontier
//    are never read from device memory.
//  * QK^T and PV run on the tensor cores through mma.sync.m16n8k16 (bf16
//    in, f32 accumulate); the score tile never leaves registers: the S
//    accumulator fragment of QK^T is re-packed as the A fragment of PV.
//  * int8 K/V tiles are read at half width and widened to bf16 while
//    they are staged into shared memory; ks scales the score columns and
//    vs folds into p before the PV product, as the reference does.
// Not yet done (later work): wgmma, TMA, a multi-stage cp.async pipeline
// and warp specialisation. Loads and math do not overlap here.
//
// Launch contract: runs on the caller's stream, never synchronises and
// allocates nothing; O and lse are allocated by the wrapper. Each entry
// point returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block (4 warps x 16)
constexpr int kBK = 64;        // kv positions per tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the reference's masked score

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

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16, `lo` in the low half (the
// element with the smaller column index in an mma fragment).
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t widen2(int8_t lo, int8_t hi) {
  return pack_f32(static_cast<float>(lo), static_cast<float>(hi));
}

template <int D, bool QUANT, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const FlashParams p) {
  constexpr int LD = D + 8;          // padded smem row: no bank conflicts
  constexpr int KSTEPS = D / 16;     // k-steps of the QK^T product
  constexpr int DTILES = D / 8;      // n-tiles of the PV product
  constexpr int STILES = kBK / 8;    // n-tiles of the score tile
  constexpr int CHUNKS = kBK * D / 8;  // 8-element chunks per K/V tile

  __shared__ __align__(16) __nv_bfloat16 k_tile[kBK * LD];
  __shared__ __align__(16) __nv_bfloat16 v_tile[kBK * LD];
  __shared__ float ks_tile[kBK];
  __shared__ float vs_tile[kBK];

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
  const int q_start = q_tile * kBQ;
  const int row0 = q_start + warp * 16 + g;  // this thread's rows: row0, row0+8

  // Q fragments (A operand, row-major 16x16 per k-step) straight into
  // registers; rows past Sq are zero and never stored.
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.q_sb + h * p.q_sh;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + (r & 1) * 8;
      const int col = kk * 16 + (r >> 1) * 8 + tig * 2;
      qf[kk][r] = row < p.Sq ? *reinterpret_cast<const uint32_t*>(
                                   qp + row * p.q_ss + col)
                             : 0u;
    }
  }

  int kv_hi = p.Skv;
  int kv_lo = 0;
  if (p.causal) {
    const int last_row = min(q_start + kBQ, p.Sq) - 1;
    kv_hi = min(p.Skv, p.q_offset + last_row + 1);
    if (p.windowed) kv_lo = max(0, p.q_offset + q_start - p.window + 1);
  }

  const char* kbase = static_cast<const char*>(p.k);
  const char* vbase = static_cast<const char*>(p.v);
  constexpr int ESZ = QUANT ? 1 : 2;

  float acc[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums
  const int qpos[2] = {p.q_offset + row0, p.q_offset + row0 + 8};

  for (int k0 = (kv_lo / kBK) * kBK; k0 < kv_hi; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int c = tid; c < CHUNKS; c += kThreads) {
      const int r = c / (D / 8);
      const int col = (c % (D / 8)) * 8;
      const int kpos = k0 + r;
      uint4 kw = make_uint4(0, 0, 0, 0);
      uint4 vw = make_uint4(0, 0, 0, 0);
      if (kpos < p.Skv) {
        const int64_t koff =
            (b * p.k_sb + kpos * p.k_ss + kvh * p.k_sh + col) * ESZ;
        const int64_t voff =
            (b * p.v_sb + kpos * p.v_ss + kvh * p.v_sh + col) * ESZ;
        if (QUANT) {
          const uint2 k8 = *reinterpret_cast<const uint2*>(kbase + koff);
          const uint2 v8 = *reinterpret_cast<const uint2*>(vbase + voff);
          const int8_t* kb = reinterpret_cast<const int8_t*>(&k8);
          const int8_t* vb = reinterpret_cast<const int8_t*>(&v8);
          kw = make_uint4(widen2(kb[0], kb[1]), widen2(kb[2], kb[3]),
                          widen2(kb[4], kb[5]), widen2(kb[6], kb[7]));
          vw = make_uint4(widen2(vb[0], vb[1]), widen2(vb[2], vb[3]),
                          widen2(vb[4], vb[5]), widen2(vb[6], vb[7]));
        } else {
          kw = *reinterpret_cast<const uint4*>(kbase + koff);
          vw = *reinterpret_cast<const uint4*>(vbase + voff);
        }
      }
      *reinterpret_cast<uint4*>(&k_tile[r * LD + col]) = kw;
      *reinterpret_cast<uint4*>(&v_tile[r * LD + col]) = vw;
    }
    if (QUANT) {
      for (int c = tid; c < kBK; c += kThreads) {
        const int kpos = k0 + c;
        const bool in = kpos < p.Skv;
        ks_tile[c] = in ? p.ks[b * p.ks_sb + kpos * p.ks_ss + kvh * p.ks_sh]
                        : 0.f;
        vs_tile[c] = in ? p.vs[b * p.vs_sb + kpos * p.vs_ss + kvh * p.vs_sh]
                        : 0.f;
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 kv columns.
    float s[STILES][4];
#pragma unroll
    for (int j = 0; j < STILES; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const __nv_bfloat16* kr = &k_tile[(j * 8 + g) * LD + kk * 16 + tig * 2];
        mma_16816(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // Score mods in the reference's order (_score_mods): scale, ks,
    // softcap, then the causal/window mask.
    float mb[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < STILES; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int col = j * 8 + tig * 2 + (e & 1);
        const int kpos = k0 + col;
        float x = s[j][e] * p.scale;
        if (QUANT) x *= ks_tile[col];
        if (SOFTCAP) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kpos < p.Skv;
        if (p.causal) {
          ok = ok && qpos[half] >= kpos;
          if (p.windowed) ok = ok && (qpos[half] - kpos < p.window);
        }
        x = ok ? x : kNegInf;
        s[j][e] = x;
        mb[half] = fmaxf(mb[half], x);
      }
    }
    float corr[2];
    float safe_m[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mb[i] = fmaxf(mb[i], __shfl_xor_sync(0xffffffffu, mb[i], 1));
      mb[i] = fmaxf(mb[i], __shfl_xor_sync(0xffffffffu, mb[i], 2));
      const float m_new = fmaxf(m[i], mb[i]);
      safe_m[i] = m_new <= kNegInf * 0.5f ? 0.f : m_new;
      corr[i] = expf(m[i] - safe_m[i]);
      m[i] = m_new;
    }
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < STILES; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        float pe = expf(s[j][e] - safe_m[half]);
        lsum[half] += pe;
        if (QUANT) pe *= vs_tile[j * 8 + tig * 2 + (e & 1)];
        s[j][e] = pe;
      }
    }
    l[0] = l[0] * corr[0] + lsum[0];
    l[1] = l[1] * corr[1] + lsum[1];
#pragma unroll
    for (int i = 0; i < DTILES; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // O += P V: the score accumulators of n-tiles (2t, 2t+1) are the A
    // fragment of k-step t; V (B operand, k = kv, n = d) is gathered
    // from the row-major tile.
#pragma unroll
    for (int t = 0; t < kBK / 16; ++t) {
      const uint32_t a[4] = {
          pack_f32(s[2 * t][0], s[2 * t][1]),
          pack_f32(s[2 * t][2], s[2 * t][3]),
          pack_f32(s[2 * t + 1][0], s[2 * t + 1][1]),
          pack_f32(s[2 * t + 1][2], s[2 * t + 1][3]),
      };
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        const __nv_bfloat16* vr = &v_tile[(t * 16 + tig * 2) * LD + dt * 8 + g];
        mma_16816(acc[dt], a, pack_bf16(vr[0], vr[LD]),
                  pack_bf16(vr[8 * LD], vr[9 * LD]));
      }
    }
  }

  // Finalize: full row sums across the 4 threads of a group, then
  // O = acc / l (l == 0 -> O = 0) and lse (+inf on fully masked rows).
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                      h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = row0 + i * 8;
    if (row >= p.Sq) continue;
    const float norm = lt == 0.f ? 1.f : lt;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      *reinterpret_cast<uint32_t*>(op + row * p.o_ss + dt * 8 + tig * 2) =
          pack_f32(acc[dt][2 * i] / norm, acc[dt][2 * i + 1] / norm);
    }
    if (tig == 0) {
      const float sm = m[i] <= kNegInf * 0.5f ? 0.f : m[i];
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + row] =
          lt > 0.f ? sm + logf(fmaxf(lt, 1e-37f)) : __int_as_float(0x7f800000);
    }
  }
}

template <int D, bool QUANT, bool SOFTCAP>
static int launch(const FlashParams& p, cudaStream_t stream) {
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd_kernel<D, QUANT, SOFTCAP><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool QUANT>
static int dispatch(const FlashParams* p, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool softcap = p->softcap > 0.f;
  switch (p->D) {
    case 64:
      return softcap ? launch<64, QUANT, true>(*p, stream)
                     : launch<64, QUANT, false>(*p, stream);
    case 128:
      return softcap ? launch<128, QUANT, true>(*p, stream)
                     : launch<128, QUANT, false>(*p, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
