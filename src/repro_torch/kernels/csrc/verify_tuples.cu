// K6: one query against a block of codes, the exact Hamming tuples.
//
// Replaces the Pallas kernel `verify_tuples`
// (src/repro/kernels/verify_tuples.py:134, body `_verify_kernel`), which
// `ops.verify_tuples_op` launches.
//
// For code r it writes r10[r] = sum_w popc(q_w & ~c_w) and
// r01[r] = sum_w popc(~q_w & c_w), each (N,) int32.
//
// What bounds it on an H100: the bytes, the codes read once (4W B a row)
// and two int32 written per row; the population counts are 2W per row.
// The design: one thread per row, grid-stride, the query's words read by
// every thread from the same address (a broadcast) and kept in registers.
#include "common.cuh"

#define VT_THREADS 256

struct VerifyOneArgs {
  const int* q;     // (W,) packed query
  const int* cand;  // (N, W) packed codes
  int* r10;         // (N,)
  int* r01;         // (N,)
  int N, W;
};

__global__ void __launch_bounds__(VT_THREADS)
verify_tuples_kernel(const VerifyOneArgs a) {
  int qw[MAX_WORDS];
#pragma unroll
  for (int w = 0; w < MAX_WORDS; ++w) qw[w] = w < a.W ? a.q[w] : 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < a.N; r += stride) {
    int c[MAX_WORDS];
    load_code(a.cand, r, a.W, c);
    int r10, r01;
    tuple_counts_regs(qw, c, a.W, r10, r01);
    a.r10[r] = r10;
    a.r01[r] = r01;
  }
}

// ptr: q, cand, r10, r01; sc: N, W.
extern "C" int verify_tuples_launch(const long long* ptr, const int* sc,
                                    void* stream) {
  VerifyOneArgs a;
  a.q = reinterpret_cast<const int*>(ptr[0]);
  a.cand = reinterpret_cast<const int*>(ptr[1]);
  a.r10 = reinterpret_cast<int*>(ptr[2]);
  a.r01 = reinterpret_cast<int*>(ptr[3]);
  a.N = sc[0];
  a.W = sc[1];
  if (a.N == 0) return 0;
  if (a.W > MAX_WORDS) return 1;  // cudaErrorInvalidValue
  long long blocks = (static_cast<long long>(a.N) + VT_THREADS - 1) /
                     VT_THREADS;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  void* args[] = {&a};
  cudaError_t e = cudaLaunchKernel(verify_tuples_kernel,
                                   dim3(static_cast<unsigned>(blocks)),
                                   dim3(VT_THREADS), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
