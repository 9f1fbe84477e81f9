// K4: Eq. 3 scores of every (query, code) pair, the linear scan's body.
//
// Replaces the Pallas kernel `hamming_scan_scores`
// (src/repro/kernels/hamming_scan.py:62, body `_scores_kernel`), which
// `ops.scan_scores` and the chunk loop of `ops.scan_topk` launch.
//
// For query b and code r it writes out[b, r] = eq3_score(z[b], r10, r01)
// (common.cuh), (B, N) float32.
//
// What bounds it on an H100: the (B, N) float32 scores it must write. The
// score needs W population counts per pair (|q & c|) and W per code
// (|c|, shared by the queries); this kernel spends 2W per pair (r10 and
// r01), twice that. Codes are read once per query tile. The design:
// one thread per code row, the row in registers, a tile of SCAN_QTILE
// queries per block (broadcast reads of the same query words by every
// thread), so consecutive threads write consecutive scores of each output
// row. The query tiles of one row block have neighbouring block indices,
// so they run side by side and the tiles after the first read the rows
// from L2. The kernel is unfused: the scores go to device memory and the
// running top-K reads them back (fusing the two is later work).
#include "common.cuh"

#define SCAN_THREADS 256
#define SCAN_QTILE 8

struct HammingArgs {
  const int* q;   // (B, W) packed queries
  const int* z;   // (B,) query popcounts
  const int* db;  // (N, W) packed codes
  float* out;     // (B, N) scores
  int B, W, N, n_qtiles;
};

__global__ void __launch_bounds__(SCAN_THREADS)
hamming_scan_kernel(const HammingArgs a) {
  const int qt = static_cast<int>(blockIdx.x % a.n_qtiles);
  const long long rb = blockIdx.x / a.n_qtiles;
  const long long r = rb * blockDim.x + threadIdx.x;
  if (r >= a.N) return;
  int c[MAX_WORDS];
  load_code(a.db, r, a.W, c);
  const int b0 = qt * SCAN_QTILE;
  const int b1 = min(b0 + SCAN_QTILE, a.B);
  for (int b = b0; b < b1; ++b) {
    int r10, r01;
    tuple_counts_regs(a.q + static_cast<long long>(b) * a.W, c, a.W, r10,
                      r01);
    a.out[static_cast<long long>(b) * a.N + r] = eq3_score(a.z[b], r10, r01);
  }
}

// ptr: q, z, db, out (device addresses); sc: B, W, N.
// Returns the CUDA error code of the launch (0: launched).
extern "C" int hamming_scan_launch(const long long* ptr, const int* sc,
                                   void* stream) {
  HammingArgs a;
  a.q = reinterpret_cast<const int*>(ptr[0]);
  a.z = reinterpret_cast<const int*>(ptr[1]);
  a.db = reinterpret_cast<const int*>(ptr[2]);
  a.out = reinterpret_cast<float*>(ptr[3]);
  a.B = sc[0];
  a.W = sc[1];
  a.N = sc[2];
  if (a.B == 0 || a.N == 0) return 0;
  if (a.W > MAX_WORDS) return 1;  // cudaErrorInvalidValue
  a.n_qtiles = (a.B + SCAN_QTILE - 1) / SCAN_QTILE;
  const long long blocks =
      (static_cast<long long>(a.N) + SCAN_THREADS - 1) / SCAN_THREADS *
      a.n_qtiles;
  if (blocks > 0x7FFFFFFFLL) return 1;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchKernel(hamming_scan_kernel,
                                   dim3(static_cast<unsigned>(blocks)),
                                   dim3(SCAN_THREADS), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
