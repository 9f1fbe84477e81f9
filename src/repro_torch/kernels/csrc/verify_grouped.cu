// K1: grouped candidate verification with the row gather fused in.
//
// Replaces the Pallas kernel `verify_tuples_grouped`
// (src/repro/kernels/verify_tuples.py:93, body `_verify_grouped_kernel`)
// together with the `jnp.take` row gather in front of it
// (`_gather_verify_grouped_impl`, src/repro/kernels/ops.py:353).
//
// For query b and candidate slot c < lens[b] it writes the packed key
// r10 * (p + 1) + r01 of db[idx[b, c]] against q[b]; padded slots get -1.
//
// What bounds it on an H100: the random row gathers. Each live slot reads
// one index (4 B) and one code row (4W B) at an address that depends on
// the data, and writes 4 B; the popcounts are a handful of integer ops per
// word. The design spends nothing else: one thread per (query, slot), the
// query's words are the same address for the whole block (a broadcast
// read), padded slots skip the gather entirely, and the (B, C, W) gathered
// block the reference materialises never exists.
#include "common.cuh"

#define VERIFY_THREADS 256

struct VerifyArgs {
  const int* q;     // (B, W) packed queries
  const int* db;    // (N, W) packed codes
  const int* idx;   // (B, C) candidate rows
  const int* lens;  // (B,) live slots per query
  int* out;         // (B, C) packed keys, -1 in padded slots
  int B, C, W, p;
};

__global__ void __launch_bounds__(VERIFY_THREADS)
verify_grouped_kernel(const VerifyArgs a) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  const long long o = static_cast<long long>(b) * a.C + c;
  int key = -1;
  if (c < a.lens[b]) {
    const long long row = a.idx[o];
    key = tuple_key(a.q + static_cast<long long>(b) * a.W, a.db + row * a.W,
                    a.W, a.p);
  }
  a.out[o] = key;
}

// ptr: q, db, idx, lens, out (device addresses); sc: B, C, W, p.
// Returns the CUDA error code of the launch (0: launched).
extern "C" int verify_grouped_launch(const long long* ptr, const int* sc,
                                     void* stream) {
  VerifyArgs a;
  a.q = reinterpret_cast<const int*>(ptr[0]);
  a.db = reinterpret_cast<const int*>(ptr[1]);
  a.idx = reinterpret_cast<const int*>(ptr[2]);
  a.lens = reinterpret_cast<const int*>(ptr[3]);
  a.out = reinterpret_cast<int*>(ptr[4]);
  a.B = sc[0];
  a.C = sc[1];
  a.W = sc[2];
  a.p = sc[3];
  if (a.B == 0 || a.C == 0) return 0;
  const dim3 grid((a.C + VERIFY_THREADS - 1) / VERIFY_THREADS, a.B);
  void* args[] = {&a};
  cudaError_t e = cudaLaunchKernel(verify_grouped_kernel, grid,
                                   dim3(VERIFY_THREADS), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
