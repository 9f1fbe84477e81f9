// Hopper-only instructions (sm_90a) behind named functions, for K7's bf16
// path (flash_attention.cu): TMA tensor maps (built on the host) and the
// tile copies they drive, global to shared completing on an mbarrier and
// shared to global in a bulk group; the mbarriers themselves; shared-memory
// matrix descriptors and the warpgroup product wgmma m64n64k16 (bf16 in,
// float32 accumulator) with its fence / commit / wait; the async-proxy
// fence.
//
// Under nvcc each function is its PTX (the tensor map comes from
// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so the library needs no -lcuda).
// Anywhere else (g++ for the CPU emulation of the port's kernels) the same
// names come from tests/cuda_emu/sm90_emu.h, which copies tiles and
// computes each thread's accumulator elements from the operands in shared
// memory with the layouts below.
//
// Tensor maps here are bf16 with 5 dimensions (innermost first), a box
// whose innermost extent is 64 elements (128 bytes), the 128-byte swizzle
// and zeros for elements out of bounds. A box lands in shared memory as
// rows of 128 bytes, row index the box's outer coordinates linearised
// (dimension 1 fastest), swizzled as below.
//
// Layouts (PTX ISA, "Matrix Descriptor" and the canonical layouts of
// wgmma; CUTLASS's GmmaDescriptor names the same fields):
//   * Every operand tile lives in shared memory in the 128-byte swizzle:
//     rows of 64 bf16 (128 bytes), 8 rows to a 1024-byte atom; the 16-byte
//     chunk c of a row sits at chunk c ^ (row % 8). The swizzle acts on
//     the shared address bits: physical = a ^ ((a >> 3) & 0x70), so every
//     tile starts 1024-byte aligned (sm90_sw128 below).
//   * A descriptor holds the start address >> 4 (bits 0-13), the leading
//     byte offset LBO >> 4 (16-29), the stride byte offset SBO >> 4
//     (32-45), base offset 0 (49-51) and layout 1 = 128-byte swizzle
//     (62-63).
//   * K-major operand (A always; B with trans_b = 0), element (row x,
//     depth k < 16): start + (x % 8) * 128 + (x / 8) * SBO + 2 k before the
//     swizzle. Stepping k by 16 inside a 128-byte row adds 32 bytes to the
//     start.
//   * MN-major B (trans_b = 1), element (depth k < 16, column n < 64):
//     start + 2 n + (k % 8) * 128 + (k / 8) * SBO before the swizzle (LBO
//     would step to the next 64 columns; an n64 product never does).
//   * Accumulator fragment of m64nN (float32): thread t of the warpgroup,
//     w = t / 32, l = t % 32, register i holds row
//     16 w + l / 4 + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (l % 4) + i % 2.
#pragma once

#include <cstdint>

// Physical offset of logical byte offset `a` in the 128-byte swizzle.
__host__ __device__ __forceinline__ uint32_t sm90_sw128(uint32_t a) {
  return a ^ ((a >> 3) & 0x70u);
}

// Descriptor of a 128-byte-swizzled operand at shared address `addr`.
__host__ __device__ __forceinline__ uint64_t sm90_desc(uint32_t addr,
                                                       uint32_t lbo,
                                                       uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

#ifdef __CUDACC__

#include <cuda.h>

#define SM90_DYNAMIC_SMEM(name) \
  extern __shared__ __align__(1024) unsigned char name[]

typedef CUtensorMap Sm90TensorMap;

// Encode a bf16 tensor map: dims[5] elements (innermost first), strides[4]
// bytes between consecutive indices of dimensions 1-4, box[5] elements.
// Returns 0, or a nonzero CUDA error.
static inline int sm90_map_bf16(Sm90TensorMap* map, const void* base,
                                const uint64_t* dims, const uint64_t* strides,
                                const uint32_t* box) {
  typedef CUresult (*Encode)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return 500;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1;  // 1: cudaErrorInvalidValue
}

__device__ __forceinline__ uint32_t sm90_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void sm90_mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(sm90_smem_addr(bar)), "r"(count) : "memory");
}

// Makes the initialised mbarriers visible (before the block barrier).
__device__ __forceinline__ void sm90_mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void sm90_mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n"
      :: "r"(sm90_smem_addr(bar)), "r"(parity) : "memory");
}

// One arrival on `bar` that also expects `bytes` of copies to land.
__device__ __forceinline__ void sm90_mbar_arrive_expect_tx(uint64_t* bar,
                                                           uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(sm90_smem_addr(bar)), "r"(bytes) : "memory");
}

// The box of `map` at coordinates c0..c4 into shared memory at `dst`
// (1024-byte aligned); its bytes complete on `bar`.
__device__ __forceinline__ void sm90_tma_load(void* dst,
                                              const Sm90TensorMap* map,
                                              uint64_t* bar, int c0, int c1,
                                              int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      :: "r"(sm90_smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
         "r"(sm90_smem_addr(bar))
      : "memory");
}

// Shared memory at `src` into the box of `map` at c0..c4 (elements out of
// bounds are not written), in this thread's bulk group.
__device__ __forceinline__ void sm90_tma_store(const Sm90TensorMap* map,
                                               const void* src, int c0,
                                               int c1, int c2, int c3,
                                               int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90_smem_addr(src)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// Close this thread's bulk group and wait until its stores have read
// shared memory.
__device__ __forceinline__ void sm90_tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's shared-memory stores (generic proxy) before the
// wgmma reads and TMA stores that follow (async proxy).
__device__ __forceinline__ void sm90_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void sm90_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void sm90_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void sm90_wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product (after a wait, before a fence).
__device__ __forceinline__ void sm90_fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (m64 x n64, fragment above) = A (64 x 16) . B (16 x 64) + (acc ? d : 0)
// with A and B read through descriptors; TRANS_B = 1 reads B MN-major.
template <int TRANS_B>
__device__ __forceinline__ void sm90_mma_m64n64k16(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(acc), "n"(TRANS_B));
}

#else  // the CPU emulation of the same functions
#include "sm90_emu.h"
#endif
