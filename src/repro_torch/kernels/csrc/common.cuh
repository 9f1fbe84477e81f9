// Device code shared by the port's kernels (verify_grouped.cu,
// probe_walk.cu, probe_scan.cu, hamming_scan.cu, blockmax_scan.cu,
// verify_tuples.cu): the exact Hamming tuple of one packed query against
// one packed code, its bucket-key packing (the reference's grouped verify)
// and its Eq. 3 score (the reference's scan kernels).
//
// Packed codes are W 32-bit words per row, LSB-first (the host's uint32
// words, viewed as int32 by torch). For query q and code c:
//   r10 = sum_w popc(q_w & ~c_w)   (bits 1 in q, 0 in c)
//   r01 = sum_w popc(~q_w & c_w)   (bits 0 in q, 1 in c)
//   key = r10 * (p + 1) + r01      (p + 1 > any r01, so the key is exact)
// The scan kernels count the same tuple with W population counts per pair
// instead of 2W: a = sum_w popc(q_w & c_w) (bits the two share) per pair
// and y = sum_w popc(c_w) per code, shared by every query, give
//   r10 = z - a,  r01 = y - a  (z: the query's popcount).
#pragma once

#include <cuda_runtime.h>

// A kernel's dynamic shared memory as `unsigned char* name` (the
// emulation of tests/cuda_emu/ gives each block its own buffer).
#ifdef __CUDACC__
#define DYNAMIC_SMEM(name) \
  extern __shared__ __align__(16) unsigned char name[]
#else
#define DYNAMIC_SMEM(name) unsigned char* name = emu_block->dyn
#endif

// "Never probed" marker of a position map (int32 max).
#define POS_INF 0x7FFFFFFF

// Widest code a kernel keeps in registers: W <= 8 words, p <= 256 bits.
#define MAX_WORDS 8

__device__ __forceinline__ int tuple_key(const int* __restrict__ q,
                                         const int* __restrict__ c,
                                         int W, int p) {
  int r10 = 0;
  int r01 = 0;
  for (int w = 0; w < W; ++w) {
    const unsigned qw = static_cast<unsigned>(q[w]);
    const unsigned cw = static_cast<unsigned>(c[w]);
    r10 += __popc(qw & ~cw);
    r01 += __popc(~qw & cw);
  }
  return r10 * (p + 1) + r01;
}

// The tuple (r10, r01) with the code already in registers (c[w], w < W).
__device__ __forceinline__ void tuple_counts_regs(const int* __restrict__ q,
                                                  const int (&c)[MAX_WORDS],
                                                  int W, int& r10, int& r01) {
  r10 = 0;
  r01 = 0;
#pragma unroll
  for (int w = 0; w < MAX_WORDS; ++w) {
    if (w < W) {
      const unsigned qw = static_cast<unsigned>(q[w]);
      const unsigned cw = static_cast<unsigned>(c[w]);
      r10 += __popc(qw & ~cw);
      r01 += __popc(~qw & cw);
    }
  }
}

// Bits shared by a query and a code in registers: a = sum_w popc(q_w & c_w).
__device__ __forceinline__ int shared_bits_regs(const int* __restrict__ q,
                                                const int (&c)[MAX_WORDS],
                                                int W) {
  int a = 0;
#pragma unroll
  for (int w = 0; w < MAX_WORDS; ++w)
    if (w < W)
      a += __popc(static_cast<unsigned>(q[w]) & static_cast<unsigned>(c[w]));
  return a;
}

// Set bits of a code in registers: y = sum_w popc(c_w).
__device__ __forceinline__ int code_bits_regs(const int (&c)[MAX_WORDS],
                                              int W) {
  int y = 0;
#pragma unroll
  for (int w = 0; w < MAX_WORDS; ++w)
    if (w < W) y += __popc(static_cast<unsigned>(c[w]));
  return y;
}

// The packed key with the code already in registers.
__device__ __forceinline__ int tuple_key_regs(const int* __restrict__ q,
                                              const int (&c)[MAX_WORDS],
                                              int W, int p) {
  int r10, r01;
  tuple_counts_regs(q, c, W, r10, r01);
  return r10 * (p + 1) + r01;
}

// Load code row `row` (W <= MAX_WORDS words) into registers.
__device__ __forceinline__ void load_code(const int* __restrict__ db,
                                          long long row, int W,
                                          int (&c)[MAX_WORDS]) {
#pragma unroll
  for (int w = 0; w < MAX_WORDS; ++w) c[w] = w < W ? db[row * W + w] : 0;
}

// Eq. 3 cosine of a query with popcount z against a code with tuple
// (r10, r01), in float32 as the reference's `scores_from_tuples`:
//   num = z - r10, den_sq = z * (z - r10 + r01),
//   score = num * (1 / sqrt(den_sq)), or 0.0 where den_sq <= 0.
// num and den_sq are exact integers (< 2^24); the square root and the
// reciprocal are the correctly rounded intrinsics (never rsqrtf), so the
// score has the same bits as the plain PyTorch version's.
__device__ __forceinline__ float eq3_score(int z, int r10, int r01) {
  const float zf = static_cast<float>(z);
  const float r10f = static_cast<float>(r10);
  const float num = zf - r10f;
  const float den_sq = zf * (zf - r10f + static_cast<float>(r01));
  return den_sq > 0.0f ? num * __frcp_rn(__fsqrt_rn(den_sq)) : 0.0f;
}

// |q & c| over W words, the query in shared memory (16-byte rows when W is
// a multiple of 4: one vector load per 4 words).
template <int W>
__device__ __forceinline__ int shared_bits_w(const int* __restrict__ q,
                                             const int (&c)[MAX_WORDS]) {
  int a = 0;
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int w = 0; w < W; w += 4) {
      const int4 v = *reinterpret_cast<const int4*>(q + w);
      a += __popc(static_cast<unsigned>(v.x & c[w])) +
           __popc(static_cast<unsigned>(v.y & c[w + 1])) +
           __popc(static_cast<unsigned>(v.z & c[w + 2])) +
           __popc(static_cast<unsigned>(v.w & c[w + 3]));
    }
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w)
      a += __popc(static_cast<unsigned>(q[w] & c[w]));
  }
  return a;
}

// Row r's code (W words) into registers: 16-byte loads when W is a
// multiple of 4.
template <int W>
__device__ __forceinline__ void load_code_w(const int* __restrict__ db,
                                            long long r, int (&c)[MAX_WORDS]) {
  const int* row = db + r * W;
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int w = 0; w < W; w += 4) {
      const int4 v = *reinterpret_cast<const int4*>(row + w);
      c[w] = v.x;
      c[w + 1] = v.y;
      c[w + 2] = v.z;
      c[w + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) c[w] = row[w];
  }
}
