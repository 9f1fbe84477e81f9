// K4: the linear scan. Two entry points:
//
// hamming_scan_launch: Eq. 3 scores of every (query, code) pair, (B, N)
// float32. Replaces the Pallas kernel `hamming_scan_scores`
// (src/repro/kernels/hamming_scan.py:62, body `_scores_kernel`), which
// `ops.scan_scores` launches.
//
// hamming_scan_topk_launch: the scan's exact top-k, fused. Replaces that
// kernel together with the chunk loop of the reference's `scan_topk`
// (src/repro/kernels/ops.py:173: B5 per chunk of 65,536 codes, then
// `lax.top_k` over [best so far, chunk] in a `lax.scan`). It returns the
// (B, k) sims and ids by descending score, ties to the lowest id; rows
// whose id is >= n_valid take no part, and slots no row fills hold -inf
// and -1. The (B, N) scores never reach device memory.
//
// Per pair both count W population counts, a = |q & c|, with y = |c| once
// per code (common.cuh): r10 = z - a and r01 = y - a are the integers the
// reference counts, and the score is eq3_score's, bit for bit.
//
// What bounds them on an H100: the scores kernel writes (B, N) float32
// (bytes). The fused pass writes only (B, tiles, k) keys; at B = 64 it is
// bound by its 64 x N x W population counts (16 a clock on each SM), at
// B = 1 by reading the codes once. Its design:
//   * A candidate is an int64 key, the score's bits (a score is >= +0.0,
//     so its bits order as the float) in the high half and 2^32 - 1 - id
//     in the low half. Keys are unique, so "key > threshold" is exact and
//     the order of keys is score descending, ties to the lowest id.
//   * Pass 1 (scan_topk_tiles_kernel), one block per (row tile, tile of up
//     to 16 queries), instantiated per W (1..8) so that every loop
//     unrolls: each thread scores one code row a step (four with one
//     query), loaded a step ahead with 16-byte loads, against the
//     queries' words in shared memory. The score of a pair is a *
//     inv[q][y] with inv[q][y] = 1 / sqrt(z y), rounded as eq3_score
//     rounds it and tabulated per block, so no square root is taken per
//     pair; a row's scores for 8 queries are computed before any is
//     tested, so their population counts overlap.
//   * Each query keeps in shared memory its best k keys so far (sorted;
//     the threshold is the k-th, its score bits also in a register for a
//     one-compare test) and a staging area that a pair beating the
//     threshold is appended to with a shared atomic. After the first
//     steps few pairs do. When an offer finds the area full, the block
//     sorts each query's L keys (bitonic, descending), keeps the first k
//     and offers what did not fit again. The block writes its k best
//     keys per query: (B, tiles, k), each tile's sorted.
//   * Pass 2 (scan_topk_merge_kernel), one block per query: every tile's
//     k-th key is a lower bound of the overall k-th, so the largest of
//     them starts the threshold; then the same staging and sort over the
//     query's tiles x k keys, and the first k decode to sims and ids.
//   * The host picks the row tiles (hamming_scan.py `topk_plan`): one
//     wave of the pass-1 blocks that fit on the SMs (3 an SM, by
//     registers and shared memory), two an SM for one query (pass 2 then
//     reads few keys), and never more than keep pass 1's keys within 1%
//     of the (B, N) float32 scores.
#include "common.cuh"
#include "topk.cuh"

#define SCAN_THREADS 256
#define SCAN_QTILE 8
#define TOPK_QMAX 16  // queries a pass-1 block takes at most

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
  const int y = code_bits_regs(c, a.W);
  const int b0 = qt * SCAN_QTILE;
  const int b1 = min(b0 + SCAN_QTILE, a.B);
  for (int b = b0; b < b1; ++b) {
    const int s = shared_bits_regs(a.q + static_cast<long long>(b) * a.W, c,
                                   a.W);
    const int z = a.z[b];
    a.out[static_cast<long long>(b) * a.N + r] = eq3_score(z, z - s, y - s);
  }
}

// ------------------------------------------------------------ fused top-k
struct TopkArgs {
  const int* q;        // (B, W) packed queries
  const int* z;        // (B,) query popcounts
  const int* db;       // (N, W) packed codes
  const int* row_ids;  // (N,) ascending ids, or null: the id is the row
  const int* nv_ptr;   // device n_valid, or null: nv
  long long* part;     // (B, n_tiles, k) keys of pass 1
  float* sims;         // (B, k)
  int* ids;            // (B, k)
  int B, W, N, k;
  int L;               // keys a query keeps in shared memory (power of 2)
  int QT;              // queries per pass-1 block
  int tile_rows, n_tiles, n_qtiles;
  int nv;
};

// Byte offsets of pass 1's shared memory for QT queries of W words:
// keys (QT x L int64), query words (QR x W), thresholds (QT int64),
// staged counts (QT), 1/sqrt(z y) (QR x (32 W + 1) float); the total.
// QR = QMAX rows of words and of 1/sqrt(z y) (zeros past the block's
// queries), read by the instantiation for QMAX whatever QT is.
struct TopkSmem {
  long long qw, th, cnt, inv, bytes;
};
__host__ __device__ inline long long topk_up16(long long x) {
  return (x + 15) / 16 * 16;
}
__host__ __device__ inline int topk_qmax(int QT) {
  return QT == 1 ? 1 : TOPK_QMAX;
}
__host__ __device__ inline TopkSmem topk_smem(int QT, int L, int W) {
  const long long QR = topk_qmax(QT);
  TopkSmem m;
  m.qw = static_cast<long long>(QT) * L * 8;
  m.th = topk_up16(m.qw + QR * W * 4);
  m.cnt = m.th + static_cast<long long>(QT) * 8;
  m.inv = topk_up16(m.cnt + static_cast<long long>(QT) * 4);
  m.bytes = m.inv + QR * (32 * W + 1) * 4;
  return m;
}

// Score one code row (in registers, id `id`) against the block's QMAX
// queries and offer each pair in `mask` that passes its query's threshold
// (th_hi of a query past the block's is INT_MAX: none passes). The scores
// of a group of up to 8 queries come first, with no branch between them,
// so that their population counts overlap. Returns the queries whose
// offer did not fit.
template <int W, int QMAX>
__device__ __forceinline__ unsigned topk_score_row(
    const int (&c)[MAX_WORDS], int id, unsigned mask,
    const int* __restrict__ qw, const float* __restrict__ inv,
    const int (&th_hi)[QMAX], long long* buf, const long long* th, int* cnt,
    int L, int k) {
  constexpr int P1 = 32 * W + 1;
  constexpr int G = QMAX < 8 ? QMAX : 8;
  const float* inv_y = inv + code_bits_regs(c, W);
  const long long low = 0xFFFFFFFFLL - static_cast<unsigned>(id);
  unsigned failed = 0;
#pragma unroll
  for (int g = 0; g < QMAX; g += G) {
    int bits[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      // float(a) for 0 <= a < 2^23 without a conversion instruction (the
      // conversions share the population counts' pipe): the bits of
      // 2^23 + a, minus 2^23, both exact
      const float af = __int_as_float(shared_bits_w<W>(qw + (g + i) * W, c) |
                                      0x4B000000) - 8388608.0f;
      bits[i] = __float_as_int(af * inv_y[(g + i) * P1]);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int s = g + i;
      // a pair whose score bits are below the threshold's cannot beat it
      if (((mask >> s) & 1u) && bits[i] >= th_hi[s] &&
          !topk_offer(buf, th, cnt, s, L, k,
                      (static_cast<long long>(bits[i]) << 32) | low))
        failed |= 1u << s;
    }
  }
  return failed;
}

// Pass 1 for codes of W words, at most QMAX queries a block (the block's
// a.QT <= QMAX) and RPT rows a thread per step; compile-time bounds, so
// the loops unroll and each query's threshold stays in a register. The
// next step's rows are loaded before this step's are scored.
template <int W, int QMAX, int RPT>
__global__ void __launch_bounds__(TOPK_THREADS, QMAX == 1 ? 2 : 3)
scan_topk_tiles_kernel(const TopkArgs a) {
  static_assert(QMAX * RPT <= 32, "one bit per (row, query) of a thread");
  constexpr unsigned ALL = QMAX == 32 ? 0xFFFFFFFFu : (1u << QMAX) - 1;
  DYNAMIC_SMEM(smem);
  const int t = threadIdx.x;
  const int QT = a.QT;
  constexpr int P1 = 32 * W + 1;  // y in [0, 32 W]
  const TopkSmem lay = topk_smem(QT, a.L, W);
  long long* buf = reinterpret_cast<long long*>(smem);         // QT x L
  int* qw = reinterpret_cast<int*>(smem + lay.qw);             // QT x W
  long long* th = reinterpret_cast<long long*>(smem + lay.th);  // QT
  int* cnt = reinterpret_cast<int*>(smem + lay.cnt);           // QT
  float* inv = reinterpret_cast<float*>(smem + lay.inv);       // QT x P1

  const int qt = static_cast<int>(blockIdx.x % a.n_qtiles);
  const int tile = static_cast<int>(blockIdx.x / a.n_qtiles);
  const int b0 = qt * QT;
  const int nq = min(QT, a.B - b0);

  for (int e = t; e < QT * a.L; e += blockDim.x) buf[e] = KEY_NONE;
  if (t < QT) {
    th[t] = KEY_NONE;
    cnt[t] = 0;
  }
  for (int e = t; e < QMAX * W; e += blockDim.x)
    qw[e] = e < nq * W ? a.q[static_cast<long long>(b0) * W + e] : 0;
  // inv[s][y]: eq3_score's 1 / sqrt(den_sq) with den_sq = z y (exact in
  // float32), 0 where den_sq is 0, so a * inv is the score's bits
  for (int e = t; e < QMAX * P1; e += blockDim.x) {
    const int s = e / P1;
    const int y = e % P1;
    const float den = s < nq ? static_cast<float>(a.z[b0 + s]) *
                                   static_cast<float>(y)
                             : 0.0f;
    inv[e] = den > 0.0f ? __frcp_rn(__fsqrt_rn(den)) : 0.0f;
  }
  __syncthreads();

  // the thresholds' high halves (score bits), refreshed after each merge
  int th_hi[QMAX];
#pragma unroll
  for (int s = 0; s < QMAX; ++s)
    th_hi[s] = s < nq ? static_cast<int>(KEY_NONE >> 32) : 0x7FFFFFFF;

  const int nv = a.nv_ptr != nullptr ? *a.nv_ptr : a.nv;
  const long long r0 = static_cast<long long>(tile) * a.tile_rows;
  long long r1 = r0 + a.tile_rows;
  if (r1 > a.N) r1 = a.N;
  constexpr int STEP = TOPK_THREADS * RPT;
  // rows base + t + j * TOPK_THREADS of a step (coalesced), loaded a step
  // ahead: their codes, ids and whether they take part
  int c_next[RPT][MAX_WORDS];
  int id_next[RPT];
  bool ok_next[RPT];
  auto load_step = [&](long long base) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const long long r = base + t + j * TOPK_THREADS;
      ok_next[j] = false;
      if (r < r1) {
        load_code_w<W>(a.db, r, c_next[j]);
        id_next[j] = a.row_ids != nullptr ? a.row_ids[r]
                                          : static_cast<int>(r);
        ok_next[j] = id_next[j] < nv;
      }
    }
  };
  load_step(r0);
  for (long long base = r0; base < r1; base += STEP) {
    int c[RPT][MAX_WORDS];
    int id[RPT];
    bool ok[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
#pragma unroll
      for (int w = 0; w < W; ++w) c[j][w] = c_next[j][w];
      id[j] = id_next[j];
      ok[j] = ok_next[j];
    }
    load_step(base + STEP);
    unsigned failed = 0;  // bit j QMAX + s: row j's offer to query s
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      if (ok[j])
        failed |= topk_score_row<W, QMAX>(c[j], id[j], ALL, qw, inv, th_hi,
                                          buf, th, cnt, a.L, a.k)
                  << (j * QMAX);
    // a full staging area: merge, then offer what did not fit again
    // (each round stages at least a full area or everything left)
    while (__syncthreads_or(failed != 0)) {
      topk_merge(buf, th, cnt, QT, a.L, a.k);
#pragma unroll
      for (int s = 0; s < QMAX; ++s)
        if (s < nq) th_hi[s] = static_cast<int>(th[s] >> 32);
      unsigned again = 0;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const unsigned m = (failed >> (j * QMAX)) & ALL;
        if (m)
          again |= topk_score_row<W, QMAX>(c[j], id[j], m, qw, inv, th_hi,
                                           buf, th, cnt, a.L, a.k)
                   << (j * QMAX);
      }
      failed = again;
    }
  }
  topk_merge(buf, th, cnt, QT, a.L, a.k);

  for (int e = t; e < nq * a.k; e += blockDim.x) {
    const int s = e / a.k;
    const int j = e % a.k;
    a.part[(static_cast<long long>(b0 + s) * a.n_tiles + tile) * a.k + j] =
        buf[s * a.L + j];
  }
}

// Pass 2, one block per query: the best k of its n_tiles x k keys
// (topk_select), decoded to sims and ids.
__global__ void __launch_bounds__(TOPK_THREADS)
scan_topk_merge_kernel(const TopkArgs a) {
  DYNAMIC_SMEM(smem);
  const long long* buf = topk_select(
      a.part + blockIdx.x * static_cast<long long>(a.n_tiles) * a.k,
      a.n_tiles, a.k, a.L, smem);
  for (int j = threadIdx.x; j < a.k; j += blockDim.x) {
    const long long key = buf[j];
    const long long o = static_cast<long long>(blockIdx.x) * a.k + j;
    if (key == KEY_NONE) {
      a.sims[o] = __int_as_float(static_cast<int>(0xFF800000u));  // -inf
      a.ids[o] = -1;
    } else {
      a.sims[o] = __int_as_float(static_cast<int>(key >> 32));
      a.ids[o] = static_cast<int>(0xFFFFFFFFLL - (key & 0xFFFFFFFFLL));
    }
  }
}

typedef void (*TopkKernel)(TopkArgs);

// Pass 1's instantiation for W words and blocks of up to QMAX queries
// (one query: four rows a thread per step, for more loads in flight).
template <int QMAX>
static TopkKernel topk_tiles_for(int W) {
  constexpr int RPT = QMAX == 1 ? 4 : 1;
  switch (W) {
    case 1: return scan_topk_tiles_kernel<1, QMAX, RPT>;
    case 2: return scan_topk_tiles_kernel<2, QMAX, RPT>;
    case 3: return scan_topk_tiles_kernel<3, QMAX, RPT>;
    case 4: return scan_topk_tiles_kernel<4, QMAX, RPT>;
    case 5: return scan_topk_tiles_kernel<5, QMAX, RPT>;
    case 6: return scan_topk_tiles_kernel<6, QMAX, RPT>;
    case 7: return scan_topk_tiles_kernel<7, QMAX, RPT>;
    case 8: return scan_topk_tiles_kernel<8, QMAX, RPT>;
    default: return nullptr;
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

// ptr: q, z, db, row_ids (0: none), n_valid (0: sc[9]), part, sims, ids;
// sc: B, W, N, k, L, QT, tile_rows, n_tiles, n_qtiles, nv.
// Two launches: pass 1 over n_tiles x n_qtiles blocks, pass 2 over B.
// Returns the CUDA error code (0: both launched).
extern "C" int hamming_scan_topk_launch(const long long* ptr, const int* sc,
                                        void* stream) {
  TopkArgs a;
  a.q = reinterpret_cast<const int*>(ptr[0]);
  a.z = reinterpret_cast<const int*>(ptr[1]);
  a.db = reinterpret_cast<const int*>(ptr[2]);
  a.row_ids = reinterpret_cast<const int*>(ptr[3]);
  a.nv_ptr = reinterpret_cast<const int*>(ptr[4]);
  a.part = reinterpret_cast<long long*>(ptr[5]);
  a.sims = reinterpret_cast<float*>(ptr[6]);
  a.ids = reinterpret_cast<int*>(ptr[7]);
  a.B = sc[0];
  a.W = sc[1];
  a.N = sc[2];
  a.k = sc[3];
  a.L = sc[4];
  a.QT = sc[5];
  a.tile_rows = sc[6];
  a.n_tiles = sc[7];
  a.n_qtiles = sc[8];
  a.nv = sc[9];
  if (a.B == 0 || a.k == 0) return 0;
  if (a.W < 1 || a.W > MAX_WORDS || a.QT < 1 || a.QT > TOPK_QMAX ||
      (a.L & (a.L - 1)) != 0 || a.L - a.k < TOPK_THREADS ||
      a.tile_rows < 1 || a.n_tiles < 1 ||
      static_cast<long long>(a.n_tiles) * a.tile_rows < a.N ||
      a.n_qtiles * a.QT < a.B)
    return 1;  // cudaErrorInvalidValue
  const long long blocks = static_cast<long long>(a.n_tiles) * a.n_qtiles;
  if (blocks > 0x7FFFFFFFLL) return 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem1 = static_cast<int>(topk_smem(a.QT, a.L, a.W).bytes);
  const TopkKernel tiles = topk_qmax(a.QT) == 1
                               ? topk_tiles_for<1>(a.W)
                               : topk_tiles_for<TOPK_QMAX>(a.W);
  cudaError_t e = cudaFuncSetAttribute(
      tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a};
  e = cudaLaunchKernel(tiles,
                       dim3(static_cast<unsigned>(blocks)),
                       dim3(TOPK_THREADS), args, smem1, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem2 = topk_select_smem(a.L);
  e = cudaFuncSetAttribute(scan_topk_merge_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernel(scan_topk_merge_kernel,
                       dim3(static_cast<unsigned>(a.B)), dim3(TOPK_THREADS),
                       args, smem2, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
