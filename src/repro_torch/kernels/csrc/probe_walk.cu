// K2: the fused AMIH probing walk, ONE launch per query batch.
//
// Replaces `device_probe_walk_batched` (src/repro/kernels/device_probe.py:309)
// and `device_probe_walk` (:81, the same walk with one z-group: G = 1, one
// cursor, one inv_pos row). The reference is an XLA `lax.while_loop` that
// reaches the Pallas kernel `verify_tuples_grouped` through `_verify`
// (:478, :212). The port keeps the loop on the card: a persistent kernel
// steps every z-group in lock-step, iteration by iteration, exactly like
// the while_loop, so `iters`, the budget and the check cadence match by
// construction. Phases of one iteration, separated by barriers over every
// block of the launch:
//   (a) per (query, tile entry): validity, XOR flip mask over the KMAX
//       index columns, bucket value, CSR range lo/hi, adj;
//   (b) per query: prefix sums of adj and of the probe flags over the tile;
//   (c) per group: max over its queries, n_take and partial;
//   (d) per (query, slot): the slot's entry by binary search over the
//       prefix sums, CSR id, code, key, walk position, atomicMin into the
//       position map; per group: cursor and resume offset;
//   (e) per query: the Prop. 2 done check.
// Group state and done flags are double-buffered by iteration parity, so
// no phase reads a value another block is rewriting.
//
// Two forms:
//   * grid (probe_walk_kernel): a cooperative launch of as many blocks as
//     are co-resident (two an SM), a grid sync between phases; the fused
//     multi-group launch, and any launch.
//   * cluster (probe_walk_local_kernel, below): ONE thread-block cluster
//     of up to 16 blocks (cudaLaunchKernelEx), whose barrier the SMs of
//     one GPC complete without a round trip through the whole card, each
//     block keeping the tile in its own shared memory; for one z-group of
//     at most WALK_CLUSTER_B queries (every B = 1 call).
//
// The position map is the dedup structure of the walk and is NOT filled
// here: the caller hands in a map that holds POS_INF everywhere (a pooled
// buffer, filled once when allocated, which the extraction resets entry by
// entry). A code's walk position depends only on (query, code), so an
// entry is lowered at most once, from POS_INF; on that transition
// (atomicMin's return value) the kernel counts the position in the query's
// histogram and records the id in the query's touched list at the slot's
// own place, iteration * cap + slot (-1 where the slot lowered nothing),
// so that no counter is shared by a query's slots. The histogram's total
// is the query's `verified`. The extraction (probe_extract_launch, at the
// end) then reads the first iterations * cap entries of the lists and the
// histograms, never the whole map.
//
// What bounds it on an H100: the random gathers of phase (d) (CSR id and
// code row per candidate slot), the touched entries' map writes and the
// lists. The reference's done check counts `posmap <= eff` over the whole
// (B, n_pad) map every iteration; the histogram makes a check read at most
// (p+1)^2 bins per query. At B = 1 the walk is a chain of short phases
// whose time is set less by the barriers than by each phase's chain of
// dependent device-memory reads, which the cluster form cuts.
#include <cooperative_groups.h>

#include "common.cuh"
#include "topk.cuh"

namespace cg = cooperative_groups;

#define WALK_THREADS 256
#define WALK_CLUSTER_MAX 16  // blocks of the cluster form (non-portable)
#define WALK_CLUSTER_B 4     // queries of one group that take the cluster
#define WALK_FORM_AUTO 0
#define WALK_FORM_GRID 1
#define WALK_FORM_CLUSTER 2

// Every array is device memory; the kernel writes only the output and
// scratch ones.
struct WalkArgs {
  int* posmap;            // (B, n_pad) position map, POS_INF on entry
  int* hist;              // (B, H) output: walk positions, by position
  int* q_words;           // (B, W)
  int* q_sub;             // (B, m) query substring values
  int* z_sub;             // (B, m) substring popcounts
  int* pow1;              // (B, m, wp1) one-position bit values
  int* pow0;              // (B, m, wp1) zero-position bit values
  int* gid;               // (B,) schedule row per query
  int* t_stop;            // (B,) last walk position to consider (<0: done)
  int* g_start;           // (G,) segment start per row
  int* g_end;             // (G,) segment end per row
  int* tbl;               // (Pt,) table id per stream entry
  int* step;              // (Pt,) walk step per stream entry
  int* idx1;              // (Pt, kmax) one-side combination indices
  int* idx0;              // (Pt, kmax) zero-side combination indices
  int* maxi1;             // (Pt,) largest one-side index
  int* maxi0;             // (Pt,) largest zero-side index
  int* widths;            // (m,) substring widths
  int* offsets;           // (m, V) dense CSR bucket offsets
  int* ids;               // (m, n_pad) CSR sorted ids (pad: n_pad)
  int* db;                // (n_pad, W) packed codes
  int* inv_pos;           // (G, pp2) packed key -> walk position
  int* lo;                // (B, T) scratch: bucket start per entry
  int* adj;               // (B, T) scratch: candidates per entry
  int* vfl;               // (B, T) scratch: probe flags, then their prefix
  int* csum;              // (B, T) scratch: prefix sum of adj
  int* ntake;             // (G,) scratch: entries taken this iteration
  int* cursor;            // (2, G) scratch: cursor by iteration parity
  int* off;               // (2, G) scratch: resume offset by parity
  int* done;              // (2, B) scratch: done flags by parity
  int* probes;            // (B,) output
  int* retrieved;         // (B,) output
  int* done_out;          // (B,) output
  int* cursor_out;        // (G,) output
  int* iters_out;         // (1,) output
  int* touched;           // (B, lt) output: per (iteration, slot) the id
                          // it lowered from POS_INF, else -1
  int B, G, W, m, wp1, V, n_pad, Pt, pp2, H, tile, cap, kmax, check_every,
      k, budget, p, lt;
};



// Inclusive scan of two ints across the block; every thread calls it.
__device__ __forceinline__ int2 block_scan2(int2 v, int2* ws, int2* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, v.x, o);
    const int y = __shfl_up_sync(0xffffffffu, v.y, o);
    if (lane >= o) {
      v.x += x;
      v.y += y;
    }
  }
  if (lane == 31) ws[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int2 w = lane < nw ? ws[lane] : make_int2(0, 0);
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, w.x, o);
      const int y = __shfl_up_sync(0xffffffffu, w.y, o);
      if (lane >= o) {
        w.x += x;
        w.y += y;
      }
    }
    ws[lane] = w;
  }
  __syncthreads();
  if (wid > 0) {
    v.x += ws[wid - 1].x;
    v.y += ws[wid - 1].y;
  }
  *total = ws[nw - 1];
  __syncthreads();
  return v;
}

// Sum of one int per thread across the block; every thread calls it.
__device__ __forceinline__ int block_sum(int v, int* acc) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (threadIdx.x == 0) *acc = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) atomicAdd(acc, v);
  __syncthreads();
  const int r = *acc;
  __syncthreads();
  return r;
}

// Does any group still have an undone query and stream left? Every block
// computes it from the same synced state, so every block takes the same
// branch. Every thread calls it.
__device__ __forceinline__ bool block_any_active(const WalkArgs& a,
                                                 const int* cursor,
                                                 const int* done) {
  int act = 0;
  for (int b = threadIdx.x; b < a.B; b += blockDim.x) {
    const int g = a.gid[b];
    act |= (!done[b] && cursor[g] < a.g_end[g]) ? 1 : 0;
  }
  return __syncthreads_or(act) != 0;
}

__global__ void __launch_bounds__(WALK_THREADS)
probe_walk_kernel(const WalkArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int2 ws[32];
  __shared__ int s_acc;
  const int tid = threadIdx.x;
  const long long gtid = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  const long long gsz = static_cast<long long>(gridDim.x) * blockDim.x;
  const int B = a.B;
  const int G = a.G;
  const int T = a.tile;
  const int C = a.cap;

  // -- start: histogram and lists to 0, carry to its start (the map
  //    already holds POS_INF)
  {
    for (long long i = gtid; i < static_cast<long long>(B) * a.H; i += gsz)
      a.hist[i] = 0;
    for (long long i = gtid; i < B; i += gsz) {
      a.probes[i] = 0;
      a.retrieved[i] = 0;
      a.done[i] = a.t_stop[i] < 0 ? 1 : 0;
    }
    for (long long i = gtid; i < G; i += gsz) {
      a.cursor[i] = a.g_start[i];
      a.off[i] = 0;
    }
  }
  grid.sync();

  int it = 0;
  for (;;) {
    const int cur = it & 1;
    const int* cur_c = a.cursor + cur * G;
    int* cur_n = a.cursor + (cur ^ 1) * G;
    const int* off_c = a.off + cur * G;
    int* off_n = a.off + (cur ^ 1) * G;
    const int* done_c = a.done + cur * B;
    int* done_n = a.done + (cur ^ 1) * B;
    if (it >= a.budget) break;
    if (!block_any_active(a, cur_c, done_c)) break;

    // (a) per (query, tile entry)
    for (long long i = gtid; i < static_cast<long long>(B) * T; i += gsz) {
      const int b = static_cast<int>(i / T);
      const int j = static_cast<int>(i % T);
      const int g = a.gid[b];
      const int offq = off_c[g];
      const int raw = cur_c[g] + j;
      int l = 0;
      int sz = 0;
      int valid = 0;
      if (raw < a.g_end[g] && !done_c[b]) {
        const int tidx = min(raw, a.Pt - 1);
        const int tt = a.tbl[tidx];
        const int zq = a.z_sub[b * a.m + tt];
        const int wd = a.widths[tt];
        if (a.maxi1[tidx] < zq && a.maxi0[tidx] < wd - zq) {
          valid = 1;
          const int* p1 = a.pow1 + (static_cast<long long>(b) * a.m + tt) * a.wp1;
          const int* p0 = a.pow0 + (static_cast<long long>(b) * a.m + tt) * a.wp1;
          const int* i1 = a.idx1 + static_cast<long long>(tidx) * a.kmax;
          const int* i0 = a.idx0 + static_cast<long long>(tidx) * a.kmax;
          int mask = 0;
          for (int jj = 0; jj < a.kmax; ++jj) mask |= p1[i1[jj]] | p0[i0[jj]];
          int val = a.q_sub[b * a.m + tt] ^ mask;
          val = min(max(val, 0), a.V - 2);
          const long long fo = static_cast<long long>(tt) * a.V + val;
          l = a.offsets[fo];
          sz = a.offsets[fo + 1] - l;
        }
      }
      a.lo[i] = l;
      a.adj[i] = max(sz - (j == 0 ? offq : 0), 0);
      // a resumed entry 0 was counted when it was first probed
      a.vfl[i] = (valid && !(j == 0 && offq > 0)) ? 1 : 0;
    }
    grid.sync();

    // (b) per query: inclusive prefix sums over the tile
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      int2 carry = make_int2(0, 0);
      const long long row = static_cast<long long>(b) * T;
      for (int base = 0; base < T; base += blockDim.x) {
        const int j = base + tid;
        int2 v = j < T ? make_int2(a.adj[row + j], a.vfl[row + j])
                       : make_int2(0, 0);
        int2 tot;
        v = block_scan2(v, ws, &tot);
        if (j < T) {
          a.csum[row + j] = v.x + carry.x;
          a.vfl[row + j] = v.y + carry.y;
        }
        carry.x += tot.x;
        carry.y += tot.y;
      }
    }
    grid.sync();

    // (c) per group: the greedy prefix of entries whose total fits cap
    //     for every query of the group
    for (int g = blockIdx.x; g < G; g += gridDim.x) {
      int cnt = 0;
      for (int base = 0; base < T; base += blockDim.x) {
        const int j = base + tid;
        int fits = 0;
        if (j < T) {
          int gm = 0;
          for (int b = 0; b < B; ++b)
            if (a.gid[b] == g)
              gm = max(gm, a.csum[static_cast<long long>(b) * T + j]);
          fits = gm <= C ? 1 : 0;
        }
        cnt += __syncthreads_count(fits);
      }
      if (tid == 0) a.ntake[g] = cnt;
    }
    grid.sync();

    // (d) per (query, slot): expand, gather, verify, scatter-min; the slot
    //     records in the touched list the id it lowered from POS_INF, or -1
    for (long long i = gtid; i < static_cast<long long>(B) * C; i += gsz) {
      const int b = static_cast<int>(i / C);
      const int s = static_cast<int>(i % C);
      const int g = a.gid[b];
      const int nt = a.ntake[g];
      const bool part = nt == 0;  // entry 0 alone overflows cap
      const long long row = static_cast<long long>(b) * T;
      const int* cs = a.csum + row;
      const int* ad = a.adj + row;
      const int tot = part ? min(ad[0], C) : cs[nt - 1];
      if (s == 0) {
        a.probes[b] += a.vfl[row + (part ? 0 : nt - 1)];
        a.retrieved[b] += tot;
      }
      int first = -1;
      do {
        if (s >= tot) break;
        int ent = 0;
        if (!part) {  // first taken entry whose prefix sum passes s
          int l = 0;
          int h = nt - 1;
          while (l < h) {
            const int mid = (l + h) >> 1;
            if (cs[mid] > s) h = mid; else l = mid + 1;
          }
          ent = l;
        }
        const int start = cs[ent] - ad[ent];
        long long base = static_cast<long long>(a.lo[row + ent]) +
                         (ent == 0 ? off_c[g] : 0) + (s - start);
        base = base < 0 ? 0 : (base > a.n_pad - 1 ? a.n_pad - 1 : base);
        const int tt = a.tbl[min(cur_c[g] + ent, a.Pt - 1)];
        const int cand = a.ids[static_cast<long long>(tt) * a.n_pad + base];
        if (cand < 0 || cand >= a.n_pad) break;  // CSR pad: dropped
        const int key = tuple_key(a.q_words + static_cast<long long>(b) * a.W,
                                  a.db + static_cast<long long>(cand) * a.W,
                                  a.W, a.p);
        const int pos = a.inv_pos[static_cast<long long>(g) * a.pp2 + key];
        const int old = atomicMin(
            a.posmap + static_cast<long long>(b) * a.n_pad + cand, pos);
        if (pos < old) {
          int* h = a.hist + static_cast<long long>(b) * a.H;
          if (old != POS_INF) atomicSub(h + old, 1); else first = cand;
          atomicAdd(h + pos, 1);
        }
      } while (false);
      a.touched[static_cast<long long>(b) * a.lt +
                static_cast<long long>(it) * C + s] = first;
    }
    // frozen groups (no undone query, or stream exhausted) keep their state
    for (long long gg = gtid; gg < G; gg += gsz) {
      const int g = static_cast<int>(gg);
      int undone = 0;
      for (int b = 0; b < B; ++b) undone |= (a.gid[b] == g && !done_c[b]);
      const bool act = undone && cur_c[g] < a.g_end[g];
      const int nt = a.ntake[g];
      const bool part = nt == 0;
      cur_n[g] = (act && !part) ? cur_c[g] + nt : cur_c[g];
      off_n[g] = act ? (part ? off_c[g] + C : 0) : off_c[g];
    }
    grid.sync();

    // (e) done check: k positions <= min(T_comp, t_stop) are final, or
    //     the walk has passed t_stop
    {
      const bool any2 = block_any_active(a, cur_n, done_c);
      const bool check = ((it + 1) % a.check_every) == 0 || !any2;
      for (int b = blockIdx.x; b < B; b += gridDim.x) {
        int nd = done_c[b];
        if (check) {
          const int cq = min(cur_n[a.gid[b]], a.Pt - 1);
          const int tc = a.step[cq] - 1;
          const int eff = min(tc, a.t_stop[b]);
          const int* h = a.hist + static_cast<long long>(b) * a.H;
          int part = 0;
          for (int j = tid; j <= eff; j += blockDim.x) part += h[j];
          const int cnt = block_sum(part, &s_acc);
          nd = (nd || cnt >= a.k || tc >= a.t_stop[b]) ? 1 : 0;
        }
        if (tid == 0) done_n[b] = nd;
      }
    }
    grid.sync();
    ++it;
  }

  if (blockIdx.x == 0) {
    const int cur = it & 1;
    for (int g = tid; g < G; g += blockDim.x)
      a.cursor_out[g] = a.cursor[cur * G + g];
    for (int b = tid; b < B; b += blockDim.x)
      a.done_out[b] = a.done[cur * B + b];
    if (tid == 0) a.iters_out[0] = it;
  }
}

// The cluster form for one z-group of at most WALK_CLUSTER_B queries
// (every B = 1 walk): the same iteration, but each block keeps the tile's
// state in its own shared memory. Phases (a)-(c) touch only the B x T tile
// entries, so EVERY block computes them for every query (the same values
// in each block: they depend only on the walk's state, which every block
// also keeps, identically); then the cluster shares out phase (d)'s B x C
// slots, whose binary search, bucket starts and tables are shared-memory
// reads, and meets twice an iteration: after (d), so that (e) reads every
// update of the histograms, and after (e), so that no block's next (d)
// changes a histogram another block is still reading. On the grid form a
// B = 1 iteration costs about five barriers and a chain of ~17 dependent
// device-memory reads (the binary search over the prefix sums alone is
// ten); this form, two barriers and about six.
struct LocalSmem {
  int lo, adj, csum, vfl, tt, qsub, zsub, pw1, pw0, wd, done, bytes;
};
__host__ __device__ inline LocalSmem local_smem(int B, int T, int m,
                                                int wp1) {
  LocalSmem l;
  const int bt = B * T;
  l.lo = 0;
  l.adj = l.lo + bt;
  l.csum = l.adj + bt;
  l.vfl = l.csum + bt;
  l.tt = l.vfl + bt;
  l.qsub = l.tt + bt;
  l.zsub = l.qsub + B * m;
  l.pw1 = l.zsub + B * m;
  l.pw0 = l.pw1 + B * m * wp1;
  l.wd = l.pw0 + B * m * wp1;
  l.done = l.wd + m;
  l.bytes = (l.done + B) * 4;  // ints
  return l;
}

__global__ void __launch_bounds__(WALK_THREADS)
probe_walk_local_kernel(const WalkArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  DYNAMIC_SMEM(smem_raw);
  int* sm = reinterpret_cast<int*>(smem_raw);
  __shared__ int2 ws[32];
  __shared__ int s_acc;
  const int tid = threadIdx.x;
  const int B = a.B;
  const int T = a.tile;
  const int C = a.cap;
  const int m = a.m;
  const LocalSmem L = local_smem(B, T, m, a.wp1);
  int* lo_s = sm + L.lo;
  int* adj_s = sm + L.adj;
  int* csum_s = sm + L.csum;
  int* vfl_s = sm + L.vfl;
  int* tt_s = sm + L.tt;
  int* qsub_s = sm + L.qsub;
  int* zsub_s = sm + L.zsub;
  int* pw1_s = sm + L.pw1;
  int* pw0_s = sm + L.pw0;
  int* wd_s = sm + L.wd;
  int* done_s = sm + L.done;
  const long long gtid = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  const long long gsz = static_cast<long long>(gridDim.x) * blockDim.x;

  // -- start: histograms to 0 (the cluster), the queries' arrays into
  //    every block's shared memory
  for (long long i = gtid; i < static_cast<long long>(B) * a.H; i += gsz)
    a.hist[i] = 0;
  for (long long i = gtid; i < B; i += gsz) {
    a.probes[i] = 0;
    a.retrieved[i] = 0;
  }
  for (int i = tid; i < B * m; i += blockDim.x) {
    qsub_s[i] = a.q_sub[i];
    zsub_s[i] = a.z_sub[i];
  }
  for (int i = tid; i < B * m * a.wp1; i += blockDim.x) {
    pw1_s[i] = a.pow1[i];
    pw0_s[i] = a.pow0[i];
  }
  for (int i = tid; i < m; i += blockDim.x) wd_s[i] = a.widths[i];
  for (int i = tid; i < B; i += blockDim.x) done_s[i] = a.t_stop[i] < 0;
  int cursor = a.g_start[0];
  const int g_end = a.g_end[0];
  int off = 0;
  cluster.sync();

  int it = 0;
  for (;;) {
    int undone = 0;
    for (int b = 0; b < B; ++b) undone |= !done_s[b];
    if (it >= a.budget || !undone || cursor >= g_end) break;

    // (a) every tile entry of every query
    for (int i = tid; i < B * T; i += blockDim.x) {
      const int b = i / T;
      const int j = i % T;
      const int raw = cursor + j;
      int l = 0;
      int sz = 0;
      int valid = 0;
      int tt = 0;
      const int tidx = min(raw, a.Pt - 1);
      tt = a.tbl[tidx];
      if (raw < g_end && !done_s[b]) {
        const int zq = zsub_s[b * m + tt];
        if (a.maxi1[tidx] < zq && a.maxi0[tidx] < wd_s[tt] - zq) {
          valid = 1;
          const int* p1 = pw1_s + (b * m + tt) * a.wp1;
          const int* p0 = pw0_s + (b * m + tt) * a.wp1;
          const int* i1 = a.idx1 + static_cast<long long>(tidx) * a.kmax;
          const int* i0 = a.idx0 + static_cast<long long>(tidx) * a.kmax;
          int mask = 0;
          for (int jj = 0; jj < a.kmax; ++jj) mask |= p1[i1[jj]] | p0[i0[jj]];
          int val = qsub_s[b * m + tt] ^ mask;
          val = min(max(val, 0), a.V - 2);
          const long long fo = static_cast<long long>(tt) * a.V + val;
          l = a.offsets[fo];
          sz = a.offsets[fo + 1] - l;
        }
      }
      lo_s[i] = l;
      tt_s[i] = tt;
      adj_s[i] = max(sz - (j == 0 ? off : 0), 0);
      // a resumed entry 0 was counted when it was first probed
      vfl_s[i] = (valid && !(j == 0 && off > 0)) ? 1 : 0;
    }
    __syncthreads();

    // (b) per query: inclusive prefix sums over the tile, each thread
    //     over ept consecutive entries
    const int ept = (T + blockDim.x - 1) / blockDim.x;
    for (int b = 0; b < B; ++b) {
      const int j0 = b * T + tid * ept;
      const int j1 = min(b * T + (tid + 1) * ept, (b + 1) * T);
      int2 v = make_int2(0, 0);
      for (int j = j0; j < j1; ++j) {
        v.x += adj_s[j];
        v.y += vfl_s[j];
      }
      int2 tot;
      const int2 incl = block_scan2(v, ws, &tot);
      int2 run = make_int2(incl.x - v.x, incl.y - v.y);
      for (int j = j0; j < j1; ++j) {
        run.x += adj_s[j];
        run.y += vfl_s[j];
        csum_s[j] = run.x;
        vfl_s[j] = run.y;
      }
    }
    __syncthreads();

    // (c) the greedy prefix of entries whose total fits cap for every query
    int fits = 0;
    for (int j = tid; j < T; j += blockDim.x) {
      int gm = 0;
      for (int b = 0; b < B; ++b) gm = max(gm, csum_s[b * T + j]);
      fits += gm <= C ? 1 : 0;
    }
    const int nt = block_sum(fits, &s_acc);
    const bool part = nt == 0;  // entry 0 alone overflows cap

    // (d) the cluster's share of the B x C slots
    for (long long i = gtid; i < static_cast<long long>(B) * C; i += gsz) {
      const int b = static_cast<int>(i / C);
      const int s = static_cast<int>(i % C);
      const int* cs = csum_s + b * T;
      const int* ad = adj_s + b * T;
      const int tot = part ? min(ad[0], C) : cs[nt - 1];
      if (s == 0) {
        a.probes[b] += vfl_s[b * T + (part ? 0 : nt - 1)];
        a.retrieved[b] += tot;
      }
      int first = -1;
      if (s < tot) {
        int ent = 0;
        if (!part) {  // first taken entry whose prefix sum passes s
          int l = 0;
          int h = nt - 1;
          while (l < h) {
            const int mid = (l + h) >> 1;
            if (cs[mid] > s) h = mid; else l = mid + 1;
          }
          ent = l;
        }
        const int start = cs[ent] - ad[ent];
        long long base = static_cast<long long>(lo_s[b * T + ent]) +
                         (ent == 0 ? off : 0) + (s - start);
        base = base < 0 ? 0 : (base > a.n_pad - 1 ? a.n_pad - 1 : base);
        const int tt = tt_s[b * T + ent];
        const int cand = a.ids[static_cast<long long>(tt) * a.n_pad + base];
        if (cand >= 0 && cand < a.n_pad) {  // CSR pad: dropped
          const int key = tuple_key(
              a.q_words + static_cast<long long>(b) * a.W,
              a.db + static_cast<long long>(cand) * a.W, a.W, a.p);
          const int pos = a.inv_pos[key];
          const int old = atomicMin(
              a.posmap + static_cast<long long>(b) * a.n_pad + cand, pos);
          if (pos < old) {
            int* h = a.hist + static_cast<long long>(b) * a.H;
            if (old != POS_INF) atomicSub(h + old, 1); else first = cand;
            atomicAdd(h + pos, 1);
          }
        }
      }
      a.touched[static_cast<long long>(b) * a.lt +
                static_cast<long long>(it) * C + s] = first;
    }
    // the walk's state, the same in every block (frozen once no query is
    // undone or the stream is exhausted)
    const int cursor_n = part ? cursor : cursor + nt;
    const int off_n = part ? off + C : 0;
    cluster.sync();

    // (e) done check: k positions <= min(T_comp, t_stop) are final, or
    //     the walk has passed t_stop
    const bool any2 = cursor_n < g_end;  // some query is undone
    const bool check = ((it + 1) % a.check_every) == 0 || !any2;
    if (check) {
      const int tc = a.step[min(cursor_n, a.Pt - 1)] - 1;
      for (int b = 0; b < B; ++b) {
        const int eff = min(tc, a.t_stop[b]);
        const int* h = a.hist + static_cast<long long>(b) * a.H;
        int part_cnt = 0;
        for (int j = tid; j <= eff; j += blockDim.x) part_cnt += h[j];
        const int cnt = block_sum(part_cnt, &s_acc);
        if (tid == 0)
          done_s[b] = (done_s[b] || cnt >= a.k || tc >= a.t_stop[b]) ? 1 : 0;
      }
    }
    cursor = cursor_n;
    off = off_n;
    ++it;
    cluster.sync();
  }

  if (blockIdx.x == 0) {
    if (tid == 0) {
      a.cursor_out[0] = cursor;
      a.iters_out[0] = it;
    }
    for (int b = tid; b < B; b += blockDim.x) a.done_out[b] = done_s[b];
  }
}

// Launch one form; info[0..2] receives blocks, threads per block, form.
static int launch_grid(const WalkArgs& a, cudaStream_t stream, int* info) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, probe_walk_kernel, WALK_THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // co-resident blocks only (a grid sync needs every block running);
  // two per SM keep the syncs cheap and the slot phase busy
  const int blocks = sms * (per_sm < 2 ? per_sm : 2);
  info[0] = blocks;
  info[1] = WALK_THREADS;
  info[2] = WALK_FORM_GRID;
  WalkArgs arg = a;
  void* args[] = {&arg};
  e = cudaLaunchCooperativeKernel(probe_walk_kernel, dim3(blocks),
                                  dim3(WALK_THREADS), args, 0, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

static int launch_cluster(const WalkArgs& a, cudaStream_t stream, int* info) {
  if (a.G != 1 || a.B > WALK_CLUSTER_B) return 1;  // cudaErrorInvalidValue
  void (*kernel)(WalkArgs) = probe_walk_local_kernel;
  const int smem = local_smem(a.B, a.tile, a.m, a.wp1).bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(WALK_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // 16 blocks where a GPC can hold such a cluster, else the portable 8
  int size = WALK_CLUSTER_MAX;
  for (;;) {
    cfg.gridDim = dim3(size, 1, 1);
    attr[0].val.clusterDim.x = size;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (clusters > 0) break;
    if (size == 8) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    size = 8;
  }
  info[0] = size;
  info[1] = WALK_THREADS;
  info[2] = WALK_FORM_CLUSTER;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ptr: the 36 addresses of WalkArgs in declaration order; sc: B, G, W, m,
// wp1, V, n_pad, Pt, pp2, H, tile, cap, kmax, check_every, k, budget, p,
// lt, form (WALK_FORM_AUTO: the cluster for one group of at most
// WALK_CLUSTER_B queries, else the grid).
// info (host, 3 ints) receives blocks, threads per block and the form.
extern "C" int probe_walk_launch(const long long* ptr, const int* sc,
                                 void* stream, int* info) {
  WalkArgs a;
  int** dst[] = {
      &a.posmap, &a.hist,    &a.q_words, &a.q_sub,  &a.z_sub,     &a.pow1,
      &a.pow0,   &a.gid,     &a.t_stop,  &a.g_start, &a.g_end,    &a.tbl,
      &a.step,   &a.idx1,    &a.idx0,    &a.maxi1,  &a.maxi0,     &a.widths,
      &a.offsets, &a.ids,    &a.db,      &a.inv_pos, &a.lo,       &a.adj,
      &a.vfl,    &a.csum,    &a.ntake,   &a.cursor, &a.off,       &a.done,
      &a.probes, &a.retrieved, &a.done_out, &a.cursor_out, &a.iters_out,
      &a.touched};
  const int n_ptr = static_cast<int>(sizeof(dst) / sizeof(dst[0]));
  for (int i = 0; i < n_ptr; ++i) *dst[i] = reinterpret_cast<int*>(ptr[i]);
  a.B = sc[0];
  a.G = sc[1];
  a.W = sc[2];
  a.m = sc[3];
  a.wp1 = sc[4];
  a.V = sc[5];
  a.n_pad = sc[6];
  a.Pt = sc[7];
  a.pp2 = sc[8];
  a.H = sc[9];
  a.tile = sc[10];
  a.cap = sc[11];
  a.kmax = sc[12];
  a.check_every = sc[13];
  a.k = sc[14];
  a.budget = sc[15];
  a.p = sc[16];
  a.lt = sc[17];
  int form = sc[18];
  if (form == WALK_FORM_AUTO)
    form = a.G == 1 && a.B <= WALK_CLUSTER_B ? WALK_FORM_CLUSTER
                                             : WALK_FORM_GRID;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == WALK_FORM_CLUSTER) return launch_cluster(a, st, info);
  if (form == WALK_FORM_GRID) return launch_grid(a, st, info);
  return 1;  // cudaErrorInvalidValue
}

// ------------------------------------------------------------ extraction
// probe_extract_launch: the AMIH extraction after a walk, one block per
// map row. A selected row (slot >= 0) finds its k-th walk position, the
// first histogram bin whose prefix count reaches k (H if none), and ranks
// the touched ids at or below thr = min(k-th, t_stop) by the unique key
// (pos << 32) | id in topk.cuh's segment (as ~key: largest first); few
// entries pass thr, so the staging area rarely fills. Every row, selected
// or not, resets each touched entry of the map to POS_INF. Its first
// `width` list entries are read once, coalesced, and their map entries
// gathered: one launch where the same in torch ops took ~40 and a wait.
struct ExtractArgs {
  int* posmap;         // (B, n_pad) the walk's map; POS_INF after
  const int* touched;  // (B, lt) the walk's lists, -1 where none
  const int* hist;     // (B, H) walk positions, by position
  const int* t_stop;   // (B,)
  const int* slot;     // (B,) output row of each map row, or -1
  int* ids;            // (R, k) output, -1 past the last
  int* pos;            // (R, k) output
  int B, n_pad, lt, width, H, k, L;
};

#define EXTRACT_RPT 4  // list entries a thread reads a step

__global__ void __launch_bounds__(TOPK_THREADS)
probe_extract_kernel(const ExtractArgs a) {
  DYNAMIC_SMEM(smem);
  __shared__ int2 ws[32];
  __shared__ int s_kth;
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int out = a.slot[b];
  long long* buf = reinterpret_cast<long long*>(smem);  // L
  long long* th = buf + a.L + TOPK_THREADS;
  int* cnt = reinterpret_cast<int*>(th + 1);

  // thr: the k-th position, by a running prefix over the histogram
  int thr = -1;
  if (out >= 0) {
    const int* h = a.hist + static_cast<long long>(b) * a.H;
    int run = 0;  // the prefix before this chunk, the same in every thread
    for (int base = 0; base < a.H; base += blockDim.x) {
      const int j = base + t;
      const int v = j < a.H ? h[j] : 0;
      int2 tot;
      const int incl = block_scan2(make_int2(v, 0), ws, &tot).x;
      if (run + incl >= a.k && run + incl - v < a.k) s_kth = j;  // one thread
      run += tot.x;
      if (run >= a.k) break;
    }
    __syncthreads();
    thr = min(run >= a.k ? s_kth : a.H, a.t_stop[b]);
  }
  for (int e = t; e < a.L; e += blockDim.x) buf[e] = KEY_NONE;
  if (t == 0) {
    th[0] = KEY_NONE;
    cnt[0] = 0;
  }
  __syncthreads();

  const int* list = a.touched + static_cast<long long>(b) * a.lt;
  int* row = a.posmap + static_cast<long long>(b) * a.n_pad;
  constexpr int STEP = TOPK_THREADS * EXTRACT_RPT;
  for (int base = 0; base < a.width; base += STEP) {
    long long key[EXTRACT_RPT];
    int id[EXTRACT_RPT];
#pragma unroll
    for (int r = 0; r < EXTRACT_RPT; ++r) {
      const int j = base + r * TOPK_THREADS + t;
      id[r] = j < a.width ? list[j] : -1;
    }
    int ps[EXTRACT_RPT];
#pragma unroll
    for (int r = 0; r < EXTRACT_RPT; ++r)
      ps[r] = id[r] >= 0 ? row[id[r]] : POS_INF;
    unsigned failed = 0;
#pragma unroll
    for (int r = 0; r < EXTRACT_RPT; ++r) {
      if (id[r] < 0) continue;
      row[id[r]] = POS_INF;
      key[r] = ~((static_cast<long long>(ps[r]) << 32) |
                 static_cast<unsigned>(id[r]));
      if (ps[r] <= thr && !topk_offer(buf, th, cnt, 0, a.L, a.k, key[r]))
        failed |= 1u << r;
    }
    // a full staging area: merge, then offer what did not fit again
    while (__syncthreads_or(failed != 0)) {
      topk_merge(buf, th, cnt, 1, a.L, a.k);
      unsigned again = 0;
#pragma unroll
      for (int r = 0; r < EXTRACT_RPT; ++r)
        if (((failed >> r) & 1u) &&
            !topk_offer(buf, th, cnt, 0, a.L, a.k, key[r]))
          again |= 1u << r;
      failed = again;
    }
  }
  if (out < 0) return;
  topk_merge(buf, th, cnt, 1, a.L, a.k);
  for (int j = t; j < a.k; j += blockDim.x) {
    const long long nkey = buf[j];
    const long long o = static_cast<long long>(out) * a.k + j;
    if (nkey == KEY_NONE) {
      a.ids[o] = -1;
      a.pos[o] = -1;
    } else {
      a.ids[o] = static_cast<int>(~nkey & 0xFFFFFFFFLL);
      a.pos[o] = static_cast<int>(~nkey >> 32);
    }
  }
}

// ptr: posmap, touched, hist, t_stop, slot, ids, pos; sc: B, n_pad, lt,
// width, H, k, L. One launch of B blocks.
extern "C" int probe_extract_launch(const long long* ptr, const int* sc,
                                    void* stream) {
  ExtractArgs a;
  a.posmap = reinterpret_cast<int*>(ptr[0]);
  a.touched = reinterpret_cast<const int*>(ptr[1]);
  a.hist = reinterpret_cast<const int*>(ptr[2]);
  a.t_stop = reinterpret_cast<const int*>(ptr[3]);
  a.slot = reinterpret_cast<const int*>(ptr[4]);
  a.ids = reinterpret_cast<int*>(ptr[5]);
  a.pos = reinterpret_cast<int*>(ptr[6]);
  a.B = sc[0];
  a.n_pad = sc[1];
  a.lt = sc[2];
  a.width = sc[3];
  a.H = sc[4];
  a.k = sc[5];
  a.L = sc[6];
  if (a.B == 0) return 0;
  if (a.k < 1 || (a.L & (a.L - 1)) != 0 || a.L - a.k < TOPK_THREADS ||
      a.width > a.lt)
    return 1;  // cudaErrorInvalidValue
  const int smem = topk_select_smem(a.L);
  cudaError_t e = cudaFuncSetAttribute(
      probe_extract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a};
  e = cudaLaunchKernel(probe_extract_kernel, dim3(a.B), dim3(TOPK_THREADS),
                       args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
