// CPU emulation (see cuda_runtime.h) of the Hopper-only functions of
// src/repro_torch/kernels/csrc/sm90.cuh, included from there when the
// source is not compiled by nvcc.
//
// Shared addresses are offsets into the block's dynamic shared memory
// (1024-byte aligned, so the swizzle acts on the same bits as on the card).
// A tensor map keeps its base, dims, strides and box; a TMA load copies
// the box into shared memory at once (zeros out of bounds) in the layout
// sm90.cuh states and then completes its bytes on the mbarrier; a TMA store
// copies the in-bounds elements back. An mbarrier is an arrival count, a
// count of bytes still expected and a phase bit in its 8 bytes; a wgmma
// m64n64k16 computes this thread's 32 accumulator elements from the
// operands in shared memory, decoding the descriptors with the canonical
// layouts and the fragment stated in sm90.cuh, and the wait after it is a
// barrier over the warpgroup (so no thread overwrites an operand that
// another thread's product has not read yet, as on the card, where the
// product is one operation of the whole warpgroup).
#pragma once
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>

#include "cuda_bf16.h"
#include "cuda_runtime.h"

#define SM90_DYNAMIC_SMEM(name) unsigned char* name = emu_block->dyn
#define __grid_constant__

struct alignas(64) Sm90TensorMap {
  const void* base;
  uint64_t dims[5];
  uint64_t strides[5];  // bytes; strides[0] = 2
  uint32_t box[5];
};

inline int sm90_map_bf16(Sm90TensorMap* map, const void* base,
                         const uint64_t* dims, const uint64_t* strides,
                         const uint32_t* box) {
  map->base = base;
  map->strides[0] = 2;
  for (int i = 0; i < 5; ++i) {
    map->dims[i] = dims[i];
    map->box[i] = box[i];
    if (i) map->strides[i] = strides[i - 1];
    if (i && strides[i - 1] % 16) return 1;  // as the card's encoder
    if (box[i] == 0 || box[i] > 256) return 1;
  }
  return box[0] == 64 ? 0 : 1;  // one 128-byte swizzle span
}

inline uint32_t sm90_smem_addr(const void* p) {
  const unsigned char* c = static_cast<const unsigned char*>(p);
  if (c < emu_block->dyn || c >= emu_block->dyn + emu_block->dyn_bytes)
    std::abort();  // not in dynamic shared memory
  return static_cast<uint32_t>(c - emu_block->dyn);
}

// mbarrier: bits 0-31 the bytes still expected (int32), 32-47 pending
// arrivals, 48-62 the arrival count, 63 the phase
inline void sm90_mbar_init(uint64_t* bar, int count) {
  const uint64_t c = static_cast<uint64_t>(count);
  __atomic_store_n(bar, (c << 32) | (c << 48), __ATOMIC_SEQ_CST);
}
inline void sm90_mbar_init_fence() {}
// arrivals -1 or 0, expected bytes + tx; the phase completes at 0 and 0
inline void emu_mbar_update(uint64_t* bar, int arrive, int32_t tx) {
  uint64_t old = __atomic_load_n(bar, __ATOMIC_SEQ_CST), nw;
  do {
    const int32_t bytes = static_cast<int32_t>(old & 0xFFFFFFFFull) + tx;
    const uint64_t pending = ((old >> 32) & 0xFFFF) - arrive;
    const uint64_t count = (old >> 48) & 0x7FFF;
    const uint64_t phase = old >> 63;
    if (pending > count) std::abort();  // more arrivals than the count
    if (pending == 0 && bytes == 0)
      nw = (count << 32) | (count << 48) | ((phase ^ 1) << 63);
    else
      nw = static_cast<uint32_t>(bytes) | (pending << 32) | (count << 48) |
           (phase << 63);
  } while (!__atomic_compare_exchange_n(bar, &old, nw, false,
                                        __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST));
}
inline void sm90_mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  emu_mbar_update(bar, 1, static_cast<int32_t>(bytes));
}
inline void sm90_mbar_wait(uint64_t* bar, int parity) {
  while (static_cast<int>(__atomic_load_n(bar, __ATOMIC_SEQ_CST) >> 63) ==
         (parity & 1))
    std::this_thread::yield();
}

// Visit the box of `map` at c[5]: f(shared offset of the element, global
// element address or nullptr out of bounds).
template <class F>
void emu_box(const Sm90TensorMap* map, const int* c, F f) {
  const uint32_t* b = map->box;
  uint32_t row = 0;
  for (uint32_t i4 = 0; i4 < b[4]; ++i4)
    for (uint32_t i3 = 0; i3 < b[3]; ++i3)
      for (uint32_t i2 = 0; i2 < b[2]; ++i2)
        for (uint32_t i1 = 0; i1 < b[1]; ++i1, ++row)
          for (uint32_t i0 = 0; i0 < b[0]; ++i0) {
            const long long x[5] = {c[0] + (long long)i0, c[1] + (long long)i1,
                                    c[2] + (long long)i2, c[3] + (long long)i3,
                                    c[4] + (long long)i4};
            const unsigned char* g =
                static_cast<const unsigned char*>(map->base);
            for (int d = 0; d < 5; ++d) {
              if (x[d] < 0 || x[d] >= static_cast<long long>(map->dims[d])) {
                g = nullptr;
                break;
              }
              g += x[d] * map->strides[d];
            }
            f(sm90_sw128(row * 128 + i0 * 2), g);
          }
}

inline void sm90_tma_load(void* dst, const Sm90TensorMap* map, uint64_t* bar,
                          int c0, int c1, int c2, int c3, int c4) {
  const uint32_t base = sm90_smem_addr(dst);
  if (base & 1023) std::abort();
  const int c[5] = {c0, c1, c2, c3, c4};
  uint32_t bytes = 0;
  emu_box(map, c, [&](uint32_t off, const unsigned char* g) {
    if (base + off + 2 > emu_block->dyn_bytes) std::abort();
    unsigned char* s = emu_block->dyn + base + off;
    if (g) std::memcpy(s, g, 2);
    else std::memset(s, 0, 2);
    bytes += 2;
  });
  emu_mbar_update(bar, 0, -static_cast<int32_t>(bytes));
}

inline void sm90_tma_store(const Sm90TensorMap* map, const void* src,
                           int c0, int c1, int c2, int c3, int c4) {
  const uint32_t base = sm90_smem_addr(src);
  if (base & 1023) std::abort();
  const int c[5] = {c0, c1, c2, c3, c4};
  emu_box(map, c, [&](uint32_t off, const unsigned char* g) {
    if (g) std::memcpy(const_cast<unsigned char*>(g),
                       emu_block->dyn + base + off, 2);
  });
}
inline void sm90_tma_store_wait() {}

inline void sm90_fence_proxy_async() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline void sm90_wgmma_fence() {}
inline void sm90_wgmma_commit() {}
inline void sm90_wgmma_wait0() { emu_block->wg_bar->arrive_and_wait(); }
inline void sm90_fence_regs(float (&)[32]) {}

struct EmuDesc {
  uint32_t start, lbo, sbo;
};
inline EmuDesc emu_desc(uint64_t d) {
  if ((d >> 62) != 1 || ((d >> 49) & 7)) std::abort();  // 128B, offset 0
  return {static_cast<uint32_t>(d & 0x3FFF) << 4,
          static_cast<uint32_t>((d >> 16) & 0x3FFF) << 4,
          static_cast<uint32_t>((d >> 32) & 0x3FFF) << 4};
}
// the bf16 at logical shared address a (before the swizzle)
inline float emu_bf16_at(uint32_t a) {
  const uint32_t phys = sm90_sw128(a);
  if (phys + 2 > emu_block->dyn_bytes) std::abort();
  __nv_bfloat16 h;
  std::memcpy(&h.x, emu_block->dyn + phys, 2);
  return __bfloat162float(h);
}

template <int TRANS_B>
void sm90_mma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                        int acc) {
  const EmuDesc A = emu_desc(desc_a), B = emu_desc(desc_b);
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
  for (int i = 0; i < 32; ++i) {
    const int row = 16 * w + l / 4 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (l % 4) + i % 2;
    float s = 0.0f;
    for (int k = 0; k < 16; ++k) {
      const float x =
          emu_bf16_at(A.start + (row % 8) * 128 + (row / 8) * A.sbo + 2 * k);
      const float y = TRANS_B
          ? emu_bf16_at(B.start + 2 * col + (k % 8) * 128 + (k / 8) * B.sbo)
          : emu_bf16_at(B.start + (col % 8) * 128 + (col / 8) * B.sbo +
                        2 * k);
      s = std::fma(x, y, s);
    }
    d[i] = acc ? d[i] + s : s;
  }
}

// One m64n64k16 product on a shared-memory image, for the tests: `image`
// (`bytes`, copied to offset 0 of the dynamic shared memory) holds A and B
// where the descriptors point; frag receives the 128 threads' 32
// accumulator registers each (thread-major).
struct EmuMmaTileArgs {
  const unsigned char* image;
  int bytes;
  uint64_t desc_a, desc_b;
  int trans_b;
  float* frag;
};
inline void emu_mma_tile_kernel(EmuMmaTileArgs a) {
  if (threadIdx.x == 0) std::memcpy(emu_block->dyn, a.image, a.bytes);
  __syncthreads();
  float d[32] = {};
  if (a.trans_b) sm90_mma_m64n64k16<1>(d, a.desc_a, a.desc_b, 0);
  else sm90_mma_m64n64k16<0>(d, a.desc_a, a.desc_b, 0);
  std::memcpy(a.frag + 32 * threadIdx.x, d, sizeof d);
}
extern "C" __attribute__((visibility("default"))) int sm90_emu_mma_tile(
    const unsigned char* image, int bytes, unsigned long long desc_a,
    unsigned long long desc_b, int trans_b, float* frag) {
  EmuMmaTileArgs a{image, bytes, desc_a, desc_b, trans_b, frag};
  void* args[] = {&a};
  return cudaLaunchKernel(emu_mma_tile_kernel, dim3(1), dim3(128), args,
                          static_cast<size_t>(bytes), nullptr);
}
