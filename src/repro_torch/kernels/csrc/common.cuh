// Device code shared by the port's three kernels (verify_grouped.cu,
// probe_walk.cu, probe_scan.cu): the exact Hamming-tuple verify of one
// packed query against one packed code, fused with the bucket-key packing
// of the reference's grouped verify kernel.
//
// Packed codes are W 32-bit words per row, LSB-first (the host's uint32
// words, viewed as int32 by torch). For query q and code c:
//   r10 = sum_w popc(q_w & ~c_w)   (bits 1 in q, 0 in c)
//   r01 = sum_w popc(~q_w & c_w)   (bits 0 in q, 1 in c)
//   key = r10 * (p + 1) + r01      (p + 1 > any r01, so the key is exact)
#pragma once

#include <cuda_runtime.h>

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

// The same key with the code already in registers (c[w] for w < W).
__device__ __forceinline__ int tuple_key_regs(const int* __restrict__ q,
                                              const int (&c)[MAX_WORDS],
                                              int W, int p) {
  int r10 = 0;
  int r01 = 0;
#pragma unroll
  for (int w = 0; w < MAX_WORDS; ++w) {
    if (w < W) {
      const unsigned qw = static_cast<unsigned>(q[w]);
      const unsigned cw = static_cast<unsigned>(c[w]);
      r10 += __popc(qw & ~cw);
      r01 += __popc(~qw & cw);
    }
  }
  return r10 * (p + 1) + r01;
}
