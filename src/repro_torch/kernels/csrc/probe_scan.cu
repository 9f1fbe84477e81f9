// K3: the exhaustive scan, the fallback of the probing walk. Two entry
// points, both replacing `device_probe_scan_multi`
// (src/repro/kernels/device_probe.py:534) and `device_probe_scan` (:264,
// the same with one inv_pos row); both reach the Pallas kernel
// `verify_tuples_grouped` through `_verify` (:561, :288).
//
// probe_scan_launch, the position map: for query b and every stored row r
//   out[b, r] = inv_pos[gid[b], key(q[b], db[r])]   for r < n_valid,
//   out[b, r] = POS_INF                              for pad rows,
// the exact walk position of every code. What bounds it: writing the
// (B, n_pad) int32 map. Each code row is read once into registers and the
// queries loop inside the thread, so consecutive threads write consecutive
// words of each output row (coalesced stores).
//
// probe_scan_topk_launch, fused position-and-top-k (the main path's bail
// route): per query b the k smallest keys (pos << 32) | r over real rows
// with pos = inv_pos[gid[b], key(q[b], db[r])] <= t_stop[b] (and pos !=
// POS_INF), ascending, decoded to (ids, pos), -1 past the last; and
// `verified`, the rows with pos != POS_INF. That is what the AMIH
// extraction selects from a map row (ties at the k-th position to the
// smallest ids), without the (B, n_pad) map ever being written. Its design
// follows K4's fused top-k (hamming_scan.cu, topk.cuh):
//   * Keys are unique, so every merge order gives the same result; the
//     block keeps ~key (largest first) in topk.cuh's segments.
//   * The host sorts the queries by (inv_pos row, popcount z) and cuts
//     them into segments of at most QT. A pass-1 block takes one (row
//     tile, segment): the segment's queries' words, and each distinct
//     (row, z) of them as a table: the row of inv_pos compacted to the
//     (z + 1)(p - z + 1) tuples a query of popcount z can meet, positions
//     in 16 bits (at most 8.5 KB at p = 128), in shared memory. Per pair
//     it spends W population counts: with a = |q & c| and y = |c|
//     counted once per code, r10 = z - a and r01 = y - a, so the table
//     index is z (p - z + 1) + y - a (p - z + 2), one multiply-add, then
//     one shared load. A pair is offered only if its position is at most
//     the query's bound in a register: min(t_stop, the running k-th key's
//     position). Segments that mix popcounts keep the codes' re-reads
//     few: one z per segment would hold ~2 queries at B = 64.
//   * Blocks of one row tile are adjacent in the grid, so the segments
//     that share a tile read its codes from L2.
//   * Pass 2, one block per query, merges its tiles' k keys
//     (topk_select) and sums their `verified` counts.
// What bounds it: at B = 64 its B x n x W population counts, at B = 1
// reading the codes once.
#include "common.cuh"
#include "topk.cuh"

#define SCAN_THREADS 256

struct ScanArgs {
  const int* q;        // (B, W) packed queries
  const int* gid;      // (B,) row of inv_pos per query
  const int* db;       // (n_pad, W) zero-padded packed codes
  const int* inv_pos;  // (G, pp2) packed key -> walk position
  int* out;            // (B, n_pad) walk positions
  int B, W, n_pad, n_valid, pp2, p;
};

__global__ void __launch_bounds__(SCAN_THREADS)
probe_scan_kernel(const ScanArgs a) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < a.n_pad; r += stride) {
    int c[MAX_WORDS];
#pragma unroll
    for (int w = 0; w < MAX_WORDS; ++w) c[w] = w < a.W ? a.db[r * a.W + w] : 0;
    const bool real = r < a.n_valid;
    for (int b = 0; b < a.B; ++b) {
      int pos = POS_INF;
      if (real) {
        const int key = tuple_key_regs(a.q + static_cast<long long>(b) * a.W,
                                       c, a.W, a.p);
        pos = a.inv_pos[static_cast<long long>(a.gid[b]) * a.pp2 + key];
      }
      a.out[static_cast<long long>(b) * a.n_pad + r] = pos;
    }
  }
}

// ptr: q, gid, db, inv_pos, out; sc: B, W, n_pad, n_valid, pp2, p.
extern "C" int probe_scan_launch(const long long* ptr, const int* sc,
                                 void* stream) {
  ScanArgs a;
  a.q = reinterpret_cast<const int*>(ptr[0]);
  a.gid = reinterpret_cast<const int*>(ptr[1]);
  a.db = reinterpret_cast<const int*>(ptr[2]);
  a.inv_pos = reinterpret_cast<const int*>(ptr[3]);
  a.out = reinterpret_cast<int*>(ptr[4]);
  a.B = sc[0];
  a.W = sc[1];
  a.n_pad = sc[2];
  a.n_valid = sc[3];
  a.pp2 = sc[4];
  a.p = sc[5];
  if (a.B == 0 || a.n_pad == 0) return 0;
  long long blocks = (static_cast<long long>(a.n_pad) + SCAN_THREADS - 1) /
                     SCAN_THREADS;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  void* args[] = {&a};
  cudaError_t e = cudaLaunchKernel(probe_scan_kernel,
                                   dim3(static_cast<unsigned>(blocks)),
                                   dim3(SCAN_THREADS), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------- fused top-k (bails)
#define SCAN_TOPK_QMAX 16     // queries a pass-1 block takes at most
#define SCAN_TBL_NONE 0xFFFF  // a table entry for POS_INF

struct ScanTopkArgs {
  const int* q;        // (B, W) packed queries, in segment order
  const int* t_stop;   // (B,) last walk position each query keeps
  const int* db;       // (n_pad, W) zero-padded packed codes
  const int* inv_pos;  // (G, pp2) packed key -> walk position
  const int* seg;      // (n_segs, 4): first query, queries, first table,
                       // tables
  const int* tabs;     // (n_tabs, 3): offset (16-bit entries), inv_pos row,
                       // popcount z
  const int* qtab;     // (B,) each query's table
  long long* part;     // (B, n_tiles, k) pass 1's keys
  int* part_cnt;       // (B, n_tiles) pass 1's verified counts
  int* ids;            // (B, k) output
  int* pos;            // (B, k) output
  int* verified;       // (B,) output
  int B, W, n_valid, pp2, p, k, L, QT, tile_rows, n_tiles, n_segs, tbl_cap;
};

// Byte offsets of pass 1's shared memory: keys (QT x L int64), query words
// (QMAX x W), thresholds (QT int64), staged counts (QT), verified counts
// (QMAX), the segment's compacted inv_pos rows (tbl_cap 16-bit entries);
// the total.
struct ScanTopkSmem {
  long long qw, th, cnt, cv, tbl, bytes;
};
__host__ __device__ inline long long scan_up16(long long x) {
  return (x + 15) / 16 * 16;
}
__host__ __device__ inline ScanTopkSmem scan_topk_smem(int QT, int L, int W,
                                                       int tbl_cap) {
  ScanTopkSmem m;
  m.qw = static_cast<long long>(QT) * L * 8;
  m.th = scan_up16(m.qw + SCAN_TOPK_QMAX * W * 4);
  m.cnt = m.th + static_cast<long long>(QT) * 8;
  m.cv = m.cnt + static_cast<long long>(QT) * 4;
  m.tbl = scan_up16(m.cv + SCAN_TOPK_QMAX * 4);
  m.bytes = m.tbl + scan_up16(static_cast<long long>(tbl_cap) * 2);
  return m;
}

// Positions of one code row (in registers, id r, y = |c|) for the
// segment's queries: query s reads its table at tix[s] + y - a * step[s]
// (a = |q_s & c|). Offers each pair in `mask` whose position passes its
// query's bound. Returns the queries whose offer did not fit.
template <int W>
__device__ __forceinline__ unsigned scan_topk_row(
    const int (&c)[MAX_WORDS], int r, int y, unsigned mask, int nq,
    const int (&tix)[SCAN_TOPK_QMAX], const int (&step)[SCAN_TOPK_QMAX],
    const int* __restrict__ qw, const unsigned short* __restrict__ tbl,
    const int (&pos_max)[SCAN_TOPK_QMAX], int (&cnt_v)[SCAN_TOPK_QMAX],
    bool count, long long* buf, const long long* th, int* cnt, int L, int k) {
  unsigned failed = 0;
#pragma unroll
  for (int s = 0; s < SCAN_TOPK_QMAX; ++s) {
    if (s >= nq || !((mask >> s) & 1u)) continue;
    const int e = tbl[tix[s] + y - shared_bits_w<W>(qw + s * W, c) * step[s]];
    const int ps = e == SCAN_TBL_NONE ? POS_INF : e;
    if (count) cnt_v[s] += ps != POS_INF ? 1 : 0;
    if (ps <= pos_max[s] &&
        !topk_offer(buf, th, cnt, s, L, k,
                    ~((static_cast<long long>(ps) << 32) |
                      static_cast<unsigned>(r))))
      failed |= 1u << s;
  }
  return failed;
}

template <int W>
__global__ void __launch_bounds__(TOPK_THREADS, 2)
probe_scan_topk_tiles_kernel(const ScanTopkArgs a) {
  DYNAMIC_SMEM(smem);
  const int t = threadIdx.x;
  const int QT = a.QT;
  const ScanTopkSmem lay = scan_topk_smem(QT, a.L, W, a.tbl_cap);
  long long* buf = reinterpret_cast<long long*>(smem);          // QT x L
  int* qw = reinterpret_cast<int*>(smem + lay.qw);              // QMAX x W
  long long* th = reinterpret_cast<long long*>(smem + lay.th);  // QT
  int* cnt = reinterpret_cast<int*>(smem + lay.cnt);            // QT
  int* cv = reinterpret_cast<int*>(smem + lay.cv);              // QMAX
  unsigned short* tbl =
      reinterpret_cast<unsigned short*>(smem + lay.tbl);        // tbl_cap

  const int sg = static_cast<int>(blockIdx.x % a.n_segs);
  const int tile = static_cast<int>(blockIdx.x / a.n_segs);
  const int b0 = a.seg[4 * sg];
  const int nq = a.seg[4 * sg + 1];
  const int tab0 = a.seg[4 * sg + 2];
  const int ntab = a.seg[4 * sg + 3];

  for (int e = t; e < QT * a.L; e += blockDim.x) buf[e] = KEY_NONE;
  if (t < QT) {
    th[t] = KEY_NONE;
    cnt[t] = 0;
  }
  if (t < SCAN_TOPK_QMAX) cv[t] = 0;
  for (int e = t; e < SCAN_TOPK_QMAX * W; e += blockDim.x)
    qw[e] = e < nq * W ? a.q[static_cast<long long>(b0) * W + e] : 0;
  // each table: the tuples r10 <= z, r01 <= p - z of its inv_pos row, at
  // r10 * (p - z + 1) + r01, positions in 16 bits (all < (p/2 + 1)^2)
  for (int j = 0; j < ntab; ++j) {
    const int* tb = a.tabs + 3 * (tab0 + j);
    const int off = tb[0];
    const int z = tb[2];
    const int pz1 = a.p - z + 1;
    const int* row = a.inv_pos + static_cast<long long>(tb[1]) * a.pp2;
    for (int e = t; e < (z + 1) * pz1; e += blockDim.x) {
      const int v = row[(e / pz1) * (a.p + 1) + e % pz1];
      tbl[off + e] = static_cast<unsigned short>(
          v == POS_INF ? SCAN_TBL_NONE : v);
    }
  }
  __syncthreads();

  // per query: its table's index for a = 0 less y (z (p - z + 1) past the
  // table's offset), the index step per shared bit (p - z + 2), t_stop,
  // and its bound on a position worth offering: t_stop, and the position
  // of its running k-th key (refreshed after each merge)
  int tix[SCAN_TOPK_QMAX];
  int step[SCAN_TOPK_QMAX];
  int tstop[SCAN_TOPK_QMAX];
  int pos_max[SCAN_TOPK_QMAX];
  int cnt_v[SCAN_TOPK_QMAX];
#pragma unroll
  for (int s = 0; s < SCAN_TOPK_QMAX; ++s) {
    tix[s] = 0;
    step[s] = 0;
    tstop[s] = -1;
    if (s < nq) {
      const int* tb = a.tabs + 3 * a.qtab[b0 + s];
      const int z = tb[2];
      tix[s] = tb[0] + z * (a.p - z + 1);
      step[s] = a.p - z + 2;
      tstop[s] = a.t_stop[b0 + s];
    }
    pos_max[s] = tstop[s];
    cnt_v[s] = 0;
  }
  const unsigned all = nq >= 32 ? 0xFFFFFFFFu : (1u << nq) - 1;

  const long long r0 = static_cast<long long>(tile) * a.tile_rows;
  long long r1 = r0 + a.tile_rows;
  if (r1 > a.n_valid) r1 = a.n_valid;
  // rows base + t (coalesced), loaded a step ahead
  int c_next[MAX_WORDS];
  if (r0 + t < r1) load_code_w<W>(a.db, r0 + t, c_next);
  for (long long base = r0; base < r1; base += TOPK_THREADS) {
    const long long r = base + t;
    const bool ok = r < r1;
    int c[MAX_WORDS];
#pragma unroll
    for (int w = 0; w < W; ++w) c[w] = c_next[w];
    if (r + TOPK_THREADS < r1) load_code_w<W>(a.db, r + TOPK_THREADS, c_next);
    const int y = code_bits_regs(c, W);
    unsigned failed = 0;
    if (ok)
      failed = scan_topk_row<W>(c, static_cast<int>(r), y, all, nq, tix,
                                step, qw, tbl, pos_max, cnt_v, true, buf, th,
                                cnt, a.L, a.k);
    // a full staging area: merge, then offer what did not fit again
    while (__syncthreads_or(failed != 0)) {
      topk_merge(buf, th, cnt, QT, a.L, a.k);
#pragma unroll
      for (int s = 0; s < SCAN_TOPK_QMAX; ++s)
        if (s < nq) pos_max[s] = min(tstop[s], ~static_cast<int>(th[s] >> 32));
      if (failed)
        failed = scan_topk_row<W>(c, static_cast<int>(r), y, failed, nq, tix,
                                  step, qw, tbl, pos_max, cnt_v, false, buf,
                                  th, cnt, a.L, a.k);
    }
  }
  topk_merge(buf, th, cnt, QT, a.L, a.k);

#pragma unroll
  for (int s = 0; s < SCAN_TOPK_QMAX; ++s)
    if (s < nq && cnt_v[s]) atomicAdd(cv + s, cnt_v[s]);
  __syncthreads();
  for (int e = t; e < nq * a.k; e += blockDim.x) {
    const int s = e / a.k;
    const int j = e % a.k;
    a.part[(static_cast<long long>(b0 + s) * a.n_tiles + tile) * a.k + j] =
        buf[s * a.L + j];
  }
  if (t < nq)
    a.part_cnt[static_cast<long long>(b0 + t) * a.n_tiles + tile] = cv[t];
}

// Pass 2, one block per query: the best k of its tiles' keys, decoded.
__global__ void __launch_bounds__(TOPK_THREADS)
probe_scan_topk_merge_kernel(const ScanTopkArgs a) {
  DYNAMIC_SMEM(smem);
  const long long b = blockIdx.x;
  const long long* buf =
      topk_select(a.part + b * a.n_tiles * a.k, a.n_tiles, a.k, a.L, smem);
  for (int j = threadIdx.x; j < a.k; j += blockDim.x) {
    const long long nkey = buf[j];
    const long long o = b * a.k + j;
    if (nkey == KEY_NONE) {
      a.ids[o] = -1;
      a.pos[o] = -1;
    } else {
      const long long key = ~nkey;
      a.ids[o] = static_cast<int>(key & 0xFFFFFFFFLL);
      a.pos[o] = static_cast<int>(key >> 32);
    }
  }
  if (threadIdx.x == 0) {
    int v = 0;
    for (int i = 0; i < a.n_tiles; ++i) v += a.part_cnt[b * a.n_tiles + i];
    a.verified[b] = v;
  }
}

typedef void (*ScanTopkKernel)(ScanTopkArgs);

static ScanTopkKernel scan_topk_for(int W) {
  switch (W) {
    case 1: return probe_scan_topk_tiles_kernel<1>;
    case 2: return probe_scan_topk_tiles_kernel<2>;
    case 3: return probe_scan_topk_tiles_kernel<3>;
    case 4: return probe_scan_topk_tiles_kernel<4>;
    case 5: return probe_scan_topk_tiles_kernel<5>;
    case 6: return probe_scan_topk_tiles_kernel<6>;
    case 7: return probe_scan_topk_tiles_kernel<7>;
    case 8: return probe_scan_topk_tiles_kernel<8>;
    default: return nullptr;
  }
}

// ptr: q, t_stop, db, inv_pos, seg, tabs, qtab, part, part_cnt, ids, pos,
// verified; sc: B, W, n_valid, pp2, p, k, L, QT, tile_rows, n_tiles,
// n_segs, tbl_cap. Two launches: pass 1 over n_tiles x n_segs blocks (segments
// fastest), pass 2 over B. Returns the CUDA error code (0: both launched).
extern "C" int probe_scan_topk_launch(const long long* ptr, const int* sc,
                                      void* stream) {
  ScanTopkArgs a;
  a.q = reinterpret_cast<const int*>(ptr[0]);
  a.t_stop = reinterpret_cast<const int*>(ptr[1]);
  a.db = reinterpret_cast<const int*>(ptr[2]);
  a.inv_pos = reinterpret_cast<const int*>(ptr[3]);
  a.seg = reinterpret_cast<const int*>(ptr[4]);
  a.tabs = reinterpret_cast<const int*>(ptr[5]);
  a.qtab = reinterpret_cast<const int*>(ptr[6]);
  a.part = reinterpret_cast<long long*>(ptr[7]);
  a.part_cnt = reinterpret_cast<int*>(ptr[8]);
  a.ids = reinterpret_cast<int*>(ptr[9]);
  a.pos = reinterpret_cast<int*>(ptr[10]);
  a.verified = reinterpret_cast<int*>(ptr[11]);
  a.B = sc[0];
  a.W = sc[1];
  a.n_valid = sc[2];
  a.pp2 = sc[3];
  a.p = sc[4];
  a.k = sc[5];
  a.L = sc[6];
  a.QT = sc[7];
  a.tile_rows = sc[8];
  a.n_tiles = sc[9];
  a.n_segs = sc[10];
  a.tbl_cap = sc[11];
  if (a.B == 0 || a.k == 0) return 0;
  if (a.W < 1 || a.W > MAX_WORDS || a.QT < 1 || a.QT > SCAN_TOPK_QMAX ||
      (a.L & (a.L - 1)) != 0 || a.L - a.k < TOPK_THREADS ||
      a.tile_rows < 1 || a.n_tiles < 1 || a.n_segs < 1 ||
      static_cast<long long>(a.n_tiles) * a.tile_rows < a.n_valid)
    return 1;  // cudaErrorInvalidValue
  const long long blocks = static_cast<long long>(a.n_tiles) * a.n_segs;
  if (blocks > 0x7FFFFFFFLL) return 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem1 =
      static_cast<int>(scan_topk_smem(a.QT, a.L, a.W, a.tbl_cap).bytes);
  const ScanTopkKernel tiles = scan_topk_for(a.W);
  cudaError_t e = cudaFuncSetAttribute(
      tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a};
  e = cudaLaunchKernel(tiles, dim3(static_cast<unsigned>(blocks)),
                       dim3(TOPK_THREADS), args, smem1, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem2 = topk_select_smem(a.L);
  e = cudaFuncSetAttribute(probe_scan_topk_merge_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernel(probe_scan_topk_merge_kernel,
                       dim3(static_cast<unsigned>(a.B)), dim3(TOPK_THREADS),
                       args, smem2, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
