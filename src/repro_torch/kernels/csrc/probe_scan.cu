// K3: the exhaustive position map, the fallback of the probing walk.
//
// Replaces `device_probe_scan_multi` (src/repro/kernels/device_probe.py:534)
// and `device_probe_scan` (:264, the same with one inv_pos row); both reach
// the Pallas kernel `verify_tuples_grouped` through `_verify` (:561, :288).
//
// For query b and every stored row r it writes
//   out[b, r] = inv_pos[gid[b], key(q[b], db[r])]   for r < n_valid,
//   out[b, r] = POS_INF                              for pad rows,
// the exact walk position of every code.
//
// What bounds it on an H100: writing the (B, n_pad) int32 map. The codes
// are read once (n_pad * 4W bytes) and the map is B times larger for any
// B > W. The design reads each code row once into registers and loops over
// the queries inside the thread, so consecutive threads write consecutive
// words of each output row (coalesced stores). The reference's `lax.map`
// chunking only bounded XLA's (B, chunk, W) temporary; the kernel has none.
#include "common.cuh"

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
