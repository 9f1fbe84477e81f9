// K2: the fused AMIH probing walk, ONE launch per query batch.
//
// Replaces `device_probe_walk_batched` (src/repro/kernels/device_probe.py:309)
// and `device_probe_walk` (:81, the same walk with one z-group: G = 1, one
// cursor, one inv_pos row). The reference is an XLA `lax.while_loop` that
// reaches the Pallas kernel `verify_tuples_grouped` through `_verify`
// (:478, :212). The port keeps the loop on the card: a persistent
// cooperative kernel with as many blocks as are co-resident steps every
// z-group in lock-step, iteration by iteration, exactly like the
// while_loop, so `iters`, the budget and the check cadence match by
// construction. Phases of one iteration, separated by grid syncs:
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
// What bounds it on an H100: the random gathers of phase (d) (CSR id and
// code row per candidate slot) and the (B, n_pad) int32 position map the
// walk must write once (filled with POS_INF at the start). The reference's
// done check counts `posmap <= eff` over the whole (B, n_pad) map every
// iteration, B * n_pad * 4 bytes per check. This kernel keeps a per-query
// histogram of walk positions instead, updated from the atomicMin return
// values (a lowered entry leaves its old bin unless that was POS_INF and
// enters its new one), so a check reads at most (p+1)^2 bins per query.
// The count is exact: every lowering is one atomic transition.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define WALK_THREADS 256

// Every array is device memory; the kernel writes only the output and
// scratch ones.
struct WalkArgs {
  int* posmap;            // (B, n_pad) output position map
  int* hist;              // (B, H) walk-position histogram (scratch)
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
  int B, G, W, m, wp1, V, n_pad, Pt, pp2, H, tile, cap, kmax, check_every,
      k, budget, p;
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

  // -- start: position map to POS_INF, histogram to 0, carry to its start
  {
    int4* pm4 = reinterpret_cast<int4*>(a.posmap);
    const long long n4 = static_cast<long long>(B) * a.n_pad / 4;
    const int4 inf4 = make_int4(POS_INF, POS_INF, POS_INF, POS_INF);
    for (long long i = gtid; i < n4; i += gsz) pm4[i] = inf4;
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

    // (d) per (query, slot): expand, gather, verify, scatter-min
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
      if (s >= tot) continue;
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
      if (cand < 0 || cand >= a.n_pad) continue;  // CSR pad: dropped
      const int key = tuple_key(a.q_words + static_cast<long long>(b) * a.W,
                                a.db + static_cast<long long>(cand) * a.W,
                                a.W, a.p);
      const int pos = a.inv_pos[static_cast<long long>(g) * a.pp2 + key];
      const int old =
          atomicMin(a.posmap + static_cast<long long>(b) * a.n_pad + cand, pos);
      if (pos < old) {
        int* h = a.hist + static_cast<long long>(b) * a.H;
        if (old != POS_INF) atomicSub(h + old, 1);
        if (pos != POS_INF) atomicAdd(h + pos, 1);
      }
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

// ptr: the 35 addresses of WalkArgs in declaration order; sc: B, G, W, m,
// wp1, V, n_pad, Pt, pp2, H, tile, cap, kmax, check_every, k, budget, p.
// info (host, 2 ints) receives the grid: blocks, threads per block.
extern "C" int probe_walk_launch(const long long* ptr, const int* sc,
                                 void* stream, int* info) {
  WalkArgs a;
  int** dst[] = {
      &a.posmap, &a.hist,    &a.q_words, &a.q_sub,  &a.z_sub,     &a.pow1,
      &a.pow0,   &a.gid,     &a.t_stop,  &a.g_start, &a.g_end,    &a.tbl,
      &a.step,   &a.idx1,    &a.idx0,    &a.maxi1,  &a.maxi0,     &a.widths,
      &a.offsets, &a.ids,    &a.db,      &a.inv_pos, &a.lo,       &a.adj,
      &a.vfl,    &a.csum,    &a.ntake,   &a.cursor, &a.off,       &a.done,
      &a.probes, &a.retrieved, &a.done_out, &a.cursor_out, &a.iters_out};
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

  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_walk_kernel,
                                                    WALK_THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // co-resident blocks only (a grid sync needs every block running);
  // two per SM keep the syncs cheap and the slot phase busy
  const int blocks = sms * (per_sm < 2 ? per_sm : 2);
  info[0] = blocks;
  info[1] = WALK_THREADS;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(probe_walk_kernel, dim3(blocks),
                                  dim3(WALK_THREADS), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
