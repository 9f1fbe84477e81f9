// A CPU emulation of the CUDA subset the port's kernels use, so their
// sources compile with g++ and run on the CPU (tests/test_torch_emulated.py).
//
// One block runs as std::threads (blockDim threads); __syncthreads is a
// barrier over the block, warp shuffles exchange through a per-warp buffer
// between two warp barriers, atomics are the compiler's, and the float
// math functions (expf, fmaf, fmaxf, sqrt) are <cmath>'s. A cooperative
// launch, and a cluster launch (cudaLaunchKernelEx), runs as ONE block, so
// a grid or cluster sync is a block barrier and
// __shared__ (made `static`) is block memory; an ordinary launch runs its
// blocks one after another. A launch's dynamic shared memory is a
// 1024-byte-aligned buffer per block (filled with 0xFF bytes, so a read of
// what no thread wrote is a bf16 NaN), reached through DYNAMIC_SMEM
// (common.cuh) or SM90_DYNAMIC_SMEM (sm90_emu.h); threads 0-127 of a
// block share a warpgroup barrier.
// Enough to hold a kernel's logic against its plain PyTorch version;
// timing, occupancy and the real compiler are the card's business.
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
inline int2 make_int2(int a, int b) { return {a, b}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorCooperativeLaunchTooLarge = 720,
  cudaDevAttrMultiProcessorCount = 16
};
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 12
};
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct {
    struct { unsigned x, y, z; } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
// threads of the one block an emulated cooperative launch runs
constexpr unsigned kEmuCoopThreads = 64;

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
// IEEE float32 square root and reciprocal, rounded to nearest
inline float __fsqrt_rn(float x) { return std::sqrt(x); }
inline float __frcp_rn(float x) { return 1.0f / x; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline int atomicMin(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v < old && !__atomic_compare_exchange_n(
                        p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline int atomicMax(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v > old && !__atomic_compare_exchange_n(
                        p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline int atomicSub(int* p, int v) { return __atomic_fetch_sub(p, v, __ATOMIC_SEQ_CST); }

struct EmuBlock {
  std::barrier<>* bar;
  std::barrier<>* wg_bar;  // threads 0-127 (nullptr in smaller blocks)
  std::vector<std::barrier<>*> warp_bar;
  unsigned char* dyn;      // dynamic shared memory
  size_t dyn_bytes;
  int buf[64][32];
  std::atomic<int> red;
};
inline EmuBlock* emu_block;

inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
inline int emu_reduce(int p, bool count) {
  __syncthreads();
  if (threadIdx.x == 0) emu_block->red = 0;
  __syncthreads();
  if (p) {
    if (count) emu_block->red.fetch_add(1); else emu_block->red.fetch_or(1);
  }
  __syncthreads();
  const int r = emu_block->red;
  __syncthreads();
  return r;
}
inline int __syncthreads_or(int p) { return emu_reduce(p, false); }
inline int __syncthreads_count(int p) { return emu_reduce(p, true); }
inline int emu_shfl(int v, int delta) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  emu_block->buf[w][l] = v;
  emu_block->warp_bar[w]->arrive_and_wait();
  const int s = l + delta;
  const int r = (s >= 0 && s < 32) ? emu_block->buf[w][s] : v;
  emu_block->warp_bar[w]->arrive_and_wait();
  return r;
}
inline int __shfl_up_sync(unsigned, int v, int o) { return emu_shfl(v, -o); }
inline int __shfl_down_sync(unsigned, int v, int o) { return emu_shfl(v, o); }
// butterfly exchange with lane ^ mask (the whole warp takes part)
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  emu_block->buf[w][l] = __float_as_int(v);
  emu_block->warp_bar[w]->arrive_and_wait();
  const int r = emu_block->buf[w][(l ^ mask) & 31];
  emu_block->warp_bar[w]->arrive_and_wait();
  return __int_as_float(r);
}

inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }

template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }

template <class A>
cudaError_t emu_run(void (*f)(A), dim3 g, dim3 b, void** args,
                    size_t smem = 0) {
  const A a = *reinterpret_cast<A*>(args[0]);
  blockDim = b;
  gridDim = g;
  const size_t dyn_bytes = (smem + 1023) / 1024 * 1024;
  for (unsigned by = 0; by < g.y; ++by) {
    for (unsigned bx = 0; bx < g.x; ++bx) {
      EmuBlock blk;
      blk.bar = new std::barrier<>(b.x);
      blk.wg_bar = b.x >= 128 ? new std::barrier<>(128) : nullptr;
      blk.dyn_bytes = dyn_bytes;
      blk.dyn = dyn_bytes ? static_cast<unsigned char*>(
                                std::aligned_alloc(1024, dyn_bytes))
                          : nullptr;
      if (blk.dyn) std::memset(blk.dyn, 0xFF, dyn_bytes);
      for (unsigned w = 0; w < (b.x + 31) / 32; ++w)
        blk.warp_bar.push_back(new std::barrier<>(32));
      emu_block = &blk;
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < b.x; ++t)
        ts.emplace_back([=]() {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          f(a);
        });
      for (auto& t : ts) t.join();
      delete blk.bar;
      delete blk.wg_bar;
      std::free(blk.dyn);
      for (auto* w : blk.warp_bar) delete w;
    }
  }
  return 0;
}

template <class A>
cudaError_t cudaLaunchCooperativeKernel(void (*f)(A), dim3, dim3, void** args,
                                        size_t, cudaStream_t) {
  return emu_run(f, dim3(1), dim3(kEmuCoopThreads), args);
}
template <class A>
cudaError_t cudaLaunchKernel(void (*f)(A), dim3 g, dim3 b, void** args,
                             size_t smem, cudaStream_t) {
  return emu_run(f, g, b, args, smem);
}
template <class A>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, void (*)(A),
                                           const cudaLaunchConfig_t*) {
  *n = 1;
  return 0;
}
template <class A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*f)(A),
                               A a) {
  void* args[] = {&a};
  return emu_run(f, dim3(1), dim3(kEmuCoopThreads), args,
                 cfg->dynamicSmemBytes);
}
