// PTX helpers shared by the flash forward (flash_fwd.cu) and backward
// (flash_bwd.cu) kernels for Hopper (sm_90a): mbarriers whose waits trap
// instead of hanging, TMA tensor loads, 128-byte-swizzled wgmma
// descriptors, the wgmma wrappers the kernels use, and on the host the
// tensor-map builder. Everything here is in an unnamed namespace: each
// source gets its own copy, and both link into one library.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kSpinLimit = 1u << 28;  // a lost barrier traps, not hangs
constexpr int kMaxSmem = 232448;   // a block's dynamic shared memory, opted in
constexpr float kLog2e = 1.4426950408889634f;

// ---- barriers, TMA, wgmma (PTX) ----

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == kSpinLimit) __trap();
  }
}

// One box of a 4-D tensor map ({d, head, seq, batch}) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int head,
                                         int seq, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(head),
      "r"(seq), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand.
// lbo / sbo in bytes: K-major uses only sbo (8-row groups, 1024 B apart);
// MN-major uses lbo between 64-column slabs and sbo between 8-row groups.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads of an accumulator across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define SKYTPU_F8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

#define SKYTPU_R32                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define SKYTPU_R64                                                          \
  SKYTPU_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "    \
             "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
             "%55, %56, %57, %58, %59, %60, %61, %62, %63"

// d[64] (+)= A[64x16] B[16x128]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SKYTPU_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SKYTPU_F8(d, 0), SKYTPU_F8(d, 8), SKYTPU_F8(d, 16), SKYTPU_F8(d, 24),
        SKYTPU_F8(d, 32), SKYTPU_F8(d, 40), SKYTPU_F8(d, 48), SKYTPU_F8(d, 56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[32] (+)= A[64x16] B[16x64]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SKYTPU_R32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SKYTPU_F8(d, 0), SKYTPU_F8(d, 8), SKYTPU_F8(d, 16), SKYTPU_F8(d, 24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64] += A[64x16] B[16x128]; A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SKYTPU_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : SKYTPU_F8(d, 0), SKYTPU_F8(d, 8), SKYTPU_F8(d, 16), SKYTPU_F8(d, 24),
        SKYTPU_F8(d, 32), SKYTPU_F8(d, 40), SKYTPU_F8(d, 48), SKYTPU_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[32] += A[64x16] B[16x64]; A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SKYTPU_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SKYTPU_F8(d, 0), SKYTPU_F8(d, 8), SKYTPU_F8(d, 16), SKYTPU_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats -> one register of two bf16, `lo` in the low half (the
// element with the smaller column index in a fragment).
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint2 ld_shared_v2(uint32_t addr) {
  uint2 w;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(w.x), "=r"(w.y)
               : "r"(addr));
  return w;
}

// ---- host side: tensor maps ----

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found through the CUDA runtime, so
// the library links only the runtime.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(ptr)
               : nullptr;
  }();
  return fn;
}

// A map of a [batch, seq, heads, d] tensor (strides in elements) whose box
// is `rows` rows of one head: 64 bf16 columns, 128-byte swizzled, or the
// whole int8 row unswizzled. TMA zero-fills rows past `seq`. A size-1
// dim's stride is never used; it gets the packed value so that
// cuTensorMapEncodeTiled accepts the map.
bool make_map(CUtensorMap* map, const void* ptr, bool int8, int64_t sb,
              int64_t ss, int64_t sh, int batch, int seq, int heads, int d,
              int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const int64_t esz = int8 ? 1 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  int64_t st[3] = {sh, ss, sb};
  int64_t packed = d;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) st[i] = packed;
    packed = st[i] * static_cast<int64_t>(dims[i + 1]);
  }
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[0] * esz),
                                 static_cast<cuuint64_t>(st[1] * esz),
                                 static_cast<cuuint64_t>(st[2] * esz)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(int8 ? d : 64), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map,
                int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
