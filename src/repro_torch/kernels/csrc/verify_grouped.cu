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
// the data, and writes 4 B; the counts are a few integer ops per word. At
// the host walk's calls (B = 1, C up to 2^17) the least time is under a
// microsecond, the order of a launch, so what a launch takes is latency:
// the chain of dependent reads before the key, and how many gathers the
// SMs keep in flight. A first design gave each thread one slot, read the
// slot's index only after the row's length had arrived (length -> index
// -> row: three reads in a chain) and took 2W counts with two NOTs per
// pair. This one:
//   * is instantiated per W (1..8, and a runtime-W form above 8), so the
//     word loops unroll;
//   * reads the row's length, the query's words and the slots' indices
//     as independent loads, so the chain is two reads, index then row; a
//     block covers slots of one query row, so those are the same length
//     and words for all its threads (L1 serves all but the first); a
//     block wholly past the length gathers nothing and writes -1s, and
//     threads past C return at once;
//   * gives each thread 2 slots, 32 apart, and issues both rows' gathers
//     before any count, so each load and store instruction of a warp
//     covers 32 neighbouring slots (the candidates of one bucket are
//     ascending ids) and each thread has two independent reads in flight;
//     blocks of 128 threads (256 slots) spread a call's live slots over
//     all the SMs. On an H100 this beat 4 slots a thread (neighbouring or
//     32 apart), 256-thread blocks, and one thread per slot, at the host
//     walk's calls and at B = 1, C = 8; so did it reading the query and
//     length per thread over one thread reading them into shared memory
//     behind a barrier;
//   * loads rows with 16-byte loads (W a multiple of 4) or 8-byte loads
//     (W = 2) where the codes are aligned for them (a scalar-load
//     instantiation takes the others);
//   * counts W population counts per pair, a = |q & c|, and W for
//     y = |c|: r10 = z - a and r01 = y - a, with no NOTs. Padded slots
//     gather nothing.
#include "common.cuh"

#define VERIFY_THREADS 128
#define VERIFY_SLOTS 2  // slots a thread takes, 32 apart

struct VerifyArgs {
  const int* q;     // (B, W) packed queries
  const int* db;    // (N, W) packed codes
  const int* idx;   // (B, C) candidate rows
  const int* lens;  // (B,) live slots per query
  int* out;         // (B, C) packed keys, -1 in padded slots
  int B, C, W, p;
};

// Row `row` of W words into registers: vector loads where VEC.
template <int W, bool VEC>
__device__ __forceinline__ void gather_row(const int* __restrict__ db,
                                           long long row,
                                           int (&c)[MAX_WORDS]) {
  if constexpr (VEC && W == 2) {
    const int2 v = *reinterpret_cast<const int2*>(db + row * 2);
    c[0] = v.x;
    c[1] = v.y;
  } else if constexpr (VEC) {
    load_code_w<W>(db, row, c);
  } else {
    load_code(db, row, W, c);
  }
}

// W words (W = 0: a.W words, read from device memory per pair instead of
// kept in registers); VEC: vector row loads.
template <int W, bool VEC>
__global__ void __launch_bounds__(VERIFY_THREADS)
verify_grouped_kernel(const VerifyArgs a) {
  const int b = blockIdx.y;
  const long long b_w = static_cast<long long>(b) * a.W;
  const long long first =
      static_cast<long long>(blockIdx.x) * VERIFY_THREADS * VERIFY_SLOTS;
  // slot j of a lane: its warp's first slot + 32 j + lane
  const long long c0 = first + (threadIdx.x >> 5) * 32 * VERIFY_SLOTS +
                       (threadIdx.x & 31);
  if (c0 >= a.C) return;
  const long long o = static_cast<long long>(b) * a.C + c0;
  // the row's length, the query's words and the slots' indices: loads
  // that depend on nothing, all in flight at once
  const int len = min(a.lens[b], a.C);
  int q[MAX_WORDS];
  if constexpr (W > 0) {
#pragma unroll
    for (int w = 0; w < W; ++w) q[w] = a.q[b_w + w];
  }
  int row[VERIFY_SLOTS];
#pragma unroll
  for (int j = 0; j < VERIFY_SLOTS; ++j)
    row[j] = c0 + 32 * j < a.C ? a.idx[o + 32 * j] : 0;
  int key[VERIFY_SLOTS];
#pragma unroll
  for (int j = 0; j < VERIFY_SLOTS; ++j) key[j] = -1;

  if (first < len) {
    if constexpr (W > 0) {
      int c[VERIFY_SLOTS][MAX_WORDS];
#pragma unroll
      for (int j = 0; j < VERIFY_SLOTS; ++j)
        if (c0 + 32 * j < len) gather_row<W, VEC>(a.db, row[j], c[j]);
      int z = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) z += __popc(static_cast<unsigned>(q[w]));
#pragma unroll
      for (int j = 0; j < VERIFY_SLOTS; ++j) {
        if (c0 + 32 * j < len) {
          int s = 0;
          int y = 0;
#pragma unroll
          for (int w = 0; w < W; ++w) {
            s += __popc(static_cast<unsigned>(q[w] & c[j][w]));
            y += __popc(static_cast<unsigned>(c[j][w]));
          }
          key[j] = (z - s) * (a.p + 1) + (y - s);
        }
      }
    } else {
      int z = 0;
      for (int w = 0; w < a.W; ++w)
        z += __popc(static_cast<unsigned>(a.q[b_w + w]));
#pragma unroll
      for (int j = 0; j < VERIFY_SLOTS; ++j) {
        if (c0 + 32 * j < len) {
          const int* cw = a.db + static_cast<long long>(row[j]) * a.W;
          int s = 0;
          int y = 0;
          for (int w = 0; w < a.W; ++w) {
            const unsigned v = static_cast<unsigned>(cw[w]);
            s += __popc(static_cast<unsigned>(a.q[b_w + w]) & v);
            y += __popc(v);
          }
          key[j] = (z - s) * (a.p + 1) + (y - s);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VERIFY_SLOTS; ++j)
    if (c0 + 32 * j < a.C) a.out[o + 32 * j] = key[j];
}

typedef void (*VerifyKernel)(VerifyArgs);

template <bool VEC>
static VerifyKernel verify_for(int W) {
  switch (W) {
    case 1: return verify_grouped_kernel<1, false>;
    case 2: return verify_grouped_kernel<2, VEC>;
    case 3: return verify_grouped_kernel<3, false>;
    case 4: return verify_grouped_kernel<4, VEC>;
    case 5: return verify_grouped_kernel<5, false>;
    case 6: return verify_grouped_kernel<6, false>;
    case 7: return verify_grouped_kernel<7, false>;
    case 8: return verify_grouped_kernel<8, VEC>;
    default: return verify_grouped_kernel<0, false>;
  }
}

// ptr: q, db, idx, lens, out (device addresses); sc: B, C, W, p, vec (1:
// vector row loads, for W = 2 with the codes on an 8-byte boundary or W a
// multiple of 4 with them on a 16-byte one). Returns the CUDA error code
// of the launch (0: launched).
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
  const bool vec = sc[4] != 0;
  if (a.B == 0 || a.C == 0) return 0;
  if (a.W < 1 || a.B > 65535 ||
      (vec && !((a.W == 2 && ptr[1] % 8 == 0) ||
                (a.W % 4 == 0 && a.W <= MAX_WORDS && ptr[1] % 16 == 0))))
    return 1;  // cudaErrorInvalidValue
  const long long per_block = VERIFY_THREADS * VERIFY_SLOTS;
  const long long gx = (static_cast<long long>(a.C) + per_block - 1) /
                       per_block;
  const VerifyKernel k = vec ? verify_for<true>(a.W) : verify_for<false>(a.W);
  const dim3 grid(static_cast<unsigned>(gx), a.B);
  void* args[] = {&a};
  cudaError_t e = cudaLaunchKernel(k, grid, dim3(VERIFY_THREADS), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
