// K5: per-block maxima of the Eq. 3 scores, phase 1 of the pruned scan.
//
// Replaces the Pallas kernel `blockmax_scores`
// (src/repro/kernels/blockmax_scan.py:53, body `_blockmax_kernel`), which
// `ops.scan_topk_pruned` launches.
//
// For query b and code block j (rows j*blk .. j*blk + blk - 1) it writes
// out[b, j] = max over the block's rows of eq3_score (common.cuh), (B,
// ceil(N / blk)) float32. Rows past N count as the zero-code rows the
// reference pads with: they score 0.0, which never exceeds a real score
// (every score is >= 0, since z - r10 >= 0), so they are skipped.
//
// What bounds it on an H100: the population counts of the scores, W per
// pair and W per code (see K4), with almost nothing written; this kernel
// spends 2W per pair, as K4 does. The design: one CUDA block per
// (code block, tile of BM_QTILE queries); each thread keeps a running max
// per query over its rows, then a warp-shuffle max and one shared-memory
// atomicMax per warp and query. Every score is a non-negative float, so
// its bits order like ints and the maxima are integer maxima of the bits.
// The query tiles of one code block have neighbouring block indices, so
// the tiles after the first read the block's rows from L2.
#include "common.cuh"

#define BM_THREADS 256
#define BM_QTILE 8

struct BlockmaxArgs {
  const int* q;   // (B, W) packed queries
  const int* z;   // (B,) query popcounts
  const int* db;  // (N, W) packed codes
  float* out;     // (B, n_blocks) per-block maxima
  int B, W, N, blk, n_blocks, n_qtiles;
};

__global__ void __launch_bounds__(BM_THREADS)
blockmax_kernel(const BlockmaxArgs a) {
  __shared__ int smax[BM_QTILE];
  const int qt = static_cast<int>(blockIdx.x % a.n_qtiles);
  const long long j = blockIdx.x / a.n_qtiles;
  const int b0 = qt * BM_QTILE;
  const int nq = min(BM_QTILE, a.B - b0);
  if (threadIdx.x < BM_QTILE) smax[threadIdx.x] = 0;  // the bits of 0.0f
  __syncthreads();
  int best[BM_QTILE];
#pragma unroll
  for (int t = 0; t < BM_QTILE; ++t) best[t] = 0;
  const long long row0 = j * a.blk;
  long long row_end = row0 + a.blk;
  if (row_end > a.N) row_end = a.N;
  for (long long r = row0 + threadIdx.x; r < row_end; r += blockDim.x) {
    int c[MAX_WORDS];
    load_code(a.db, r, a.W, c);
#pragma unroll
    for (int t = 0; t < BM_QTILE; ++t) {
      if (t < nq) {
        const int b = b0 + t;
        int r10, r01;
        tuple_counts_regs(a.q + static_cast<long long>(b) * a.W, c, a.W, r10,
                          r01);
        best[t] = max(best[t], __float_as_int(eq3_score(a.z[b], r10, r01)));
      }
    }
  }
#pragma unroll
  for (int t = 0; t < BM_QTILE; ++t) {
    int v = best[t];
    for (int off = 16; off > 0; off >>= 1)
      v = max(v, __shfl_down_sync(0xFFFFFFFFu, v, off));
    if ((threadIdx.x & 31) == 0) atomicMax(&smax[t], v);
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < nq)
    a.out[static_cast<long long>(b0 + threadIdx.x) * a.n_blocks + j] =
        __int_as_float(smax[threadIdx.x]);
}

// ptr: q, z, db, out; sc: B, W, N, blk.
extern "C" int blockmax_scan_launch(const long long* ptr, const int* sc,
                                    void* stream) {
  BlockmaxArgs a;
  a.q = reinterpret_cast<const int*>(ptr[0]);
  a.z = reinterpret_cast<const int*>(ptr[1]);
  a.db = reinterpret_cast<const int*>(ptr[2]);
  a.out = reinterpret_cast<float*>(ptr[3]);
  a.B = sc[0];
  a.W = sc[1];
  a.N = sc[2];
  a.blk = sc[3];
  if (a.B == 0 || a.N == 0) return 0;
  if (a.W > MAX_WORDS || a.blk <= 0) return 1;  // cudaErrorInvalidValue
  a.n_blocks = static_cast<int>((static_cast<long long>(a.N) + a.blk - 1) /
                                a.blk);
  a.n_qtiles = (a.B + BM_QTILE - 1) / BM_QTILE;
  const long long blocks = static_cast<long long>(a.n_blocks) * a.n_qtiles;
  if (blocks > 0x7FFFFFFFLL) return 1;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchKernel(blockmax_kernel,
                                   dim3(static_cast<unsigned>(blocks)),
                                   dim3(BM_THREADS), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
