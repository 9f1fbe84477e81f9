// K5: per-group maxima of the Eq. 3 scores, phase 1 of the pruned scan.
//
// Replaces the Pallas kernel `blockmax_scores`
// (src/repro/kernels/blockmax_scan.py:53, body `_blockmax_kernel`), which
// `ops.scan_topk_pruned` launches.
//
// For query b and code group j (rows j*blk .. j*blk + blk - 1) it writes
// out[b, j] = max over the group's rows of eq3_score (common.cuh), (B,
// ceil(N / blk)) float32. Rows past N count as the zero-code rows the
// reference pads with: they score 0.0, which never exceeds a real score
// (every score is >= +0.0), so they are skipped.
//
// What bounds it on an H100: the population counts, W per (query, code)
// pair for a = |q & c| and W per code for y = |c| (16 a clock on each
// SM), with almost nothing written. A first design spent 2W counts and a
// correctly rounded square root and reciprocal per pair, read each pair's
// query words from device memory and kept 8 queries a block, and took
// twice as long as the fused top-k's pass 1 over the same pairs. This one
// follows that pass (hamming_scan.cu):
//   * It is instantiated per W (1..8), so every word loop unrolls, and
//     per query tile: 16 queries a block, or one query alone, whose
//     threads take 4 rows a step for more loads in flight.
//   * A block keeps its queries' words and the table inv[s][y] =
//     1 / sqrt(z_s y) (eq3_score's rounding, 0 where z y = 0) in shared
//     memory. A pair scores a * inv[s][y], eq3_score's bits (its numerator
//     z - r10 is a, its den_sq z y), so no square root is taken per pair;
//     a row is scored against all of the block's queries before any is
//     kept, so their counts overlap.
//   * Code rows arrive with 16-byte loads where W is a multiple of 4 and
//     the codes start on a 16-byte boundary (a scalar-load instantiation
//     takes the others), one step ahead of being scored.
//   * The grid is one wave (blockmax_scan.py `blockmax_plan`): a block
//     walks whole groups over a row range, and the query tiles of one
//     range sit on neighbouring block indices, so at B = 64 the codes come
//     once from device memory and three more times from L2.
//   * Each thread keeps one running maximum per query. At a group's end a
//     warp halves its 16 maxima across its lanes (16 shuffles), one lane
//     per query takes a shared atomicMax of the score bits (every score is
//     >= +0.0, so its bits order as the float) and one thread per query
//     writes the group's maximum. The maxima alternate between two shared
//     rows, so a group costs one barrier.
#include "common.cuh"

#define BM_THREADS 256
#define BM_QMAX 16  // queries a block takes at most
// Blocks an SM by the launch bounds, for Q queries a block and codes of W
// words (blockmax_scan.py `blockmax_plan` sizes the grid by it): the
// fastest of 2, 3 and 4 on an H100 at 10M codes, p in {64, 128, 256} and
// B in {1, 64}; above 4 words (and for one query's 4 rows a step above
// 2) a thread's codes need more than a third of an SM's registers.
#define BM_BLOCKS_PER_SM(W, Q) \
  ((W) <= 2 ? 4 : (W) <= 4 && (Q) > 1 ? 3 : 2)

struct BlockmaxArgs {
  const int* q;   // (B, W) packed queries
  const int* z;   // (B,) query popcounts
  const int* db;  // (N, W) packed codes
  float* out;     // (B, n_groups) per-group maxima
  int B, N, blk, n_groups, gpb, n_qtiles;
};

__host__ __device__ constexpr int bm_log2(int n) {
  return n <= 1 ? 0 : 1 + bm_log2(n / 2);
}

// The maxima of Q queries (a power of two <= 32) over a warp's lanes, Q
// values a lane: each step keeps half of a lane's values and takes their
// partners from lane ^ M, until one is left (query lane >> (5 - log2 Q)),
// which the lanes still sharing it then reduce.
template <int Q, int N, int M>
__device__ __forceinline__ void warp_halve(float (&v)[Q], int lane) {
  if constexpr (N > 1) {
    const bool hi = (lane & M) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = hi ? v[i] : v[i + N / 2];
      const float keep = hi ? v[i + N / 2] : v[i];
      v[i] = fmaxf(keep, __shfl_xor_sync(0xFFFFFFFFu, send, M));
    }
    warp_halve<Q, N / 2, M / 2>(v, lane);
  } else {
#pragma unroll
    for (int m = M; m > 0; m >>= 1)
      v[0] = fmaxf(v[0], __shfl_xor_sync(0xFFFFFFFFu, v[0], m));
  }
}

// Score one code row (in registers) against the block's Q queries and
// keep each query's running maximum. The scores come first, with no
// branch between them, so that their population counts overlap.
template <int W, int Q>
__device__ __forceinline__ void blockmax_row(const int (&c)[MAX_WORDS],
                                             const int* __restrict__ qw,
                                             const float* __restrict__ inv,
                                             float (&best)[Q]) {
  constexpr int P1 = 32 * W + 1;
  const float* inv_y = inv + code_bits_regs(c, W);
  float s[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    // float(a) for 0 <= a < 2^23 without a conversion instruction (the
    // conversions share the population counts' pipe), as in K4
    const float af = __int_as_float(shared_bits_w<W>(qw + i * W, c) |
                                    0x4B000000) - 8388608.0f;
    s[i] = af * inv_y[i * P1];
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) best[i] = fmaxf(best[i], s[i]);
}

// Codes of W words, Q queries a block (queries past the block's score 0:
// zero words and a zero table), RPT rows a thread per step; VEC: 16-byte
// code loads (W a multiple of 4, codes on a 16-byte boundary).
template <int W, int Q, int RPT, bool VEC>
__global__ void __launch_bounds__(BM_THREADS, BM_BLOCKS_PER_SM(W, Q))
blockmax_kernel(const BlockmaxArgs a) {
  constexpr int P1 = 32 * W + 1;  // y in [0, 32 W]
  constexpr int STEP = BM_THREADS * RPT;
  constexpr int SH = 5 - bm_log2(Q);  // lanes sharing a query: 1 << SH
  __shared__ __align__(16) int qw[Q * W];
  __shared__ float inv[Q * P1];
  __shared__ int smax[2][Q];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int b0 = static_cast<int>(blockIdx.x % a.n_qtiles) * Q;
  const int nq = min(Q, a.B - b0);
  const long long g0 =
      static_cast<long long>(blockIdx.x / a.n_qtiles) * a.gpb;
  const long long g1 =
      g0 + a.gpb < a.n_groups ? g0 + a.gpb : a.n_groups;

  for (int e = t; e < Q * W; e += BM_THREADS)
    qw[e] = e < nq * W ? a.q[static_cast<long long>(b0) * W + e] : 0;
  for (int e = t; e < Q * P1; e += BM_THREADS) {
    const int s = e / P1;
    const int y = e % P1;
    const float den =
        s < nq ? static_cast<float>(a.z[b0 + s]) * static_cast<float>(y)
               : 0.0f;
    inv[e] = den > 0.0f ? __frcp_rn(__fsqrt_rn(den)) : 0.0f;
  }
  if (t < 2 * Q) smax[t / Q][t % Q] = 0;  // the bits of +0.0
  __syncthreads();

  // a step's rows: base + t + j * BM_THREADS below the group's end,
  // loaded one step ahead of being scored
  int c_next[RPT][MAX_WORDS];
  bool ok_next[RPT];
  auto load_step = [&](long long base, long long end) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const long long r = base + t + j * BM_THREADS;
      ok_next[j] = r < end;
      if (ok_next[j]) {
        if constexpr (VEC)
          load_code_w<W>(a.db, r, c_next[j]);
        else
          load_code(a.db, r, W, c_next[j]);
      }
    }
  };
  auto group_end = [&](long long g) {
    const long long e = (g + 1) * a.blk;
    return e < a.N ? e : static_cast<long long>(a.N);
  };
  if (g0 < g1) load_step(g0 * a.blk, group_end(g0));
  int buf = 0;
  for (long long g = g0; g < g1; ++g) {
    const long long end = group_end(g);
    float best[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) best[i] = 0.0f;
    for (long long base = g * a.blk; base < end; base += STEP) {
      int c[RPT][MAX_WORDS];
      bool ok[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
#pragma unroll
        for (int w = 0; w < W; ++w) c[j][w] = c_next[j][w];
        ok[j] = ok_next[j];
      }
      // the next step: this group's, or the next group's first
      if (base + STEP < end)
        load_step(base + STEP, end);
      else if (g + 1 < g1)
        load_step(end, group_end(g + 1));
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        if (ok[j]) blockmax_row<W, Q>(c[j], qw, inv, best);
    }
    warp_halve<Q, Q, 16>(best, lane);
    if ((lane & ((1 << SH) - 1)) == 0)
      atomicMax(&smax[buf][lane >> SH], __float_as_int(best[0]));
    __syncthreads();
    // smax[buf] is written again two groups on, after the next barrier
    if (t < Q) {
      const int v = smax[buf][t];
      smax[buf][t] = 0;
      if (t < nq)
        a.out[static_cast<long long>(b0 + t) * a.n_groups + g] =
            __int_as_float(v);
    }
    buf ^= 1;
  }
}

typedef void (*BlockmaxKernel)(BlockmaxArgs);

template <int Q, bool VEC>
static BlockmaxKernel blockmax_for(int W) {
  constexpr int RPT = Q == 1 ? 4 : 1;
  switch (W) {
    case 1: return blockmax_kernel<1, Q, RPT, false>;
    case 2: return blockmax_kernel<2, Q, RPT, false>;
    case 3: return blockmax_kernel<3, Q, RPT, false>;
    case 4: return blockmax_kernel<4, Q, RPT, VEC>;
    case 5: return blockmax_kernel<5, Q, RPT, false>;
    case 6: return blockmax_kernel<6, Q, RPT, false>;
    case 7: return blockmax_kernel<7, Q, RPT, false>;
    case 8: return blockmax_kernel<8, Q, RPT, VEC>;
    default: return nullptr;
  }
}

// ptr: q, z, db, out; sc: B, W, N, blk, gpb (groups a block walks), vec
// (1: 16-byte code loads; the codes must then start on a 16-byte
// boundary). One query runs the one-query instantiation, more run tiles
// of BM_QMAX. Returns the CUDA error code of the launch (0: launched).
extern "C" int blockmax_scan_launch(const long long* ptr, const int* sc,
                                    void* stream) {
  BlockmaxArgs a;
  a.q = reinterpret_cast<const int*>(ptr[0]);
  a.z = reinterpret_cast<const int*>(ptr[1]);
  a.db = reinterpret_cast<const int*>(ptr[2]);
  a.out = reinterpret_cast<float*>(ptr[3]);
  a.B = sc[0];
  const int W = sc[1];
  a.N = sc[2];
  a.blk = sc[3];
  a.gpb = sc[4];
  const bool vec = sc[5] != 0;
  if (a.B == 0 || a.N == 0) return 0;
  if (W < 1 || W > MAX_WORDS || a.blk <= 0 || a.gpb <= 0 ||
      (vec && (W % 4 != 0 || ptr[2] % 16 != 0)))
    return 1;  // cudaErrorInvalidValue
  const int Q = a.B == 1 ? 1 : BM_QMAX;
  a.n_groups = static_cast<int>((static_cast<long long>(a.N) + a.blk - 1) /
                                a.blk);
  a.n_qtiles = (a.B + Q - 1) / Q;
  const long long chunks =
      (static_cast<long long>(a.n_groups) + a.gpb - 1) / a.gpb;
  const long long blocks = chunks * a.n_qtiles;
  if (blocks > 0x7FFFFFFFLL) return 1;
  const BlockmaxKernel k = Q == 1 ? (vec ? blockmax_for<1, true>(W)
                                         : blockmax_for<1, false>(W))
                                  : (vec ? blockmax_for<BM_QMAX, true>(W)
                                         : blockmax_for<BM_QMAX, false>(W));
  void* args[] = {&a};
  cudaError_t e = cudaLaunchKernel(k, dim3(static_cast<unsigned>(blocks)),
                                   dim3(BM_THREADS), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
