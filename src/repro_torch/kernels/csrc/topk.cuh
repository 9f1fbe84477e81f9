// A block's exact top-k of unique int64 keys, largest first, shared by the
// fused scans (hamming_scan.cu: K4's score-and-top-k; probe_scan.cu: K3's
// position-and-top-k).
//
// Keys are unique, so "key > threshold" is exact and every merge order is
// free. A segment of L keys (L a power of 2) in shared memory holds the
// best k so far (sorted, descending) and a staging area of L - k keys that
// an offer beating the threshold (the k-th key) is appended to with a
// shared atomic. An offer that finds the area full fails; the block then
// sorts every segment (bitonic), keeps the first k, and the caller offers
// what did not fit again.
#pragma once

#include "common.cuh"

#define TOPK_THREADS 256
#define MERGE_RPT 8   // keys a merge thread offers per step
#define KEY_NONE (-0x7FFFFFFFFFFFFFFFLL - 1)  // below every candidate key

// Sort each of the nseg segments of L keys (L a power of 2) descending.
__device__ void topk_sort_desc(long long* buf, int nseg, int L) {
  const int half = nseg * L / 2;
  for (int size = 2; size <= L; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int e = threadIdx.x; e < half; e += blockDim.x) {
        // e -> the pair (i, i + stride), i with the bit `stride` clear
        const int i = ((e & ~(stride - 1)) << 1) | (e & (stride - 1));
        const int j = i + stride;
        const long long x = buf[i];
        const long long y = buf[j];
        const bool desc = ((i & (L - 1)) & size) == 0;
        if (desc ? x < y : x > y) {
          buf[i] = y;
          buf[j] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Fold every segment's staged keys into its best k: sort each segment
// [best k | staged | KEY_NONE...], keep the first k, clear the rest and
// set the threshold to the k-th key. Every thread of the block calls it.
__device__ void topk_merge(long long* buf, long long* th, int* cnt, int nseg,
                           int L, int k) {
  const int t = threadIdx.x;
  if (!__syncthreads_or(t < nseg && cnt[t] > 0)) return;
  topk_sort_desc(buf, nseg, L);
  for (int e = t; e < nseg * L; e += blockDim.x)
    if ((e & (L - 1)) >= k) buf[e] = KEY_NONE;
  if (t < nseg) {
    th[t] = buf[t * L + k - 1];
    cnt[t] = 0;
  }
  __syncthreads();
}

// Offer `key` to segment s: nothing to do if it does not beat the
// threshold, else stage it. Returns false if the staging area was full
// (the caller offers the key again after the next merge).
__device__ __forceinline__ bool topk_offer(long long* buf, const long long* th,
                                           int* cnt, int s, int L, int k,
                                           long long key) {
  if (key <= th[s]) return true;
  const int pos = atomicAdd(&cnt[s], 1);
  if (pos >= L - k) return false;
  buf[s * L + k + pos] = key;
  return true;
}

// Shared memory of topk_select: the L keys, a reduction area and the
// threshold and staged count.
__host__ __device__ inline int topk_select_smem(int L) {
  return L * 8 + TOPK_THREADS * 8 + 16;
}

// The best k of one row's n_tiles x k keys (src, each tile's k keys sorted
// descending, KEY_NONE-padded) into buf[0..k), descending; the whole block
// calls it, with blockDim.x == TOPK_THREADS and topk_select_smem(L) bytes
// at smem. Every tile's k keys are at least its k-th key, so the largest
// of those is a lower bound of the k-th key overall and starts the
// threshold; each thread then offers MERGE_RPT keys a step, loaded a step
// ahead.
__device__ long long* topk_select(const long long* __restrict__ src,
                                  int n_tiles, int k, int L,
                                  unsigned char* smem) {
  const int t = threadIdx.x;
  long long* buf = reinterpret_cast<long long*>(smem);  // L
  long long* red = buf + L;                             // TOPK_THREADS
  long long* th = red + TOPK_THREADS;
  int* cnt = reinterpret_cast<int*>(th + 1);
  const long long m = static_cast<long long>(n_tiles) * k;
  for (int e = t; e < L; e += blockDim.x) buf[e] = KEY_NONE;
  long long lb = KEY_NONE;
  for (int i = t; i < n_tiles; i += blockDim.x) {
    const long long x = src[static_cast<long long>(i) * k + k - 1];
    lb = x > lb ? x : lb;
  }
  red[t] = lb;
  __syncthreads();
  for (int off = TOPK_THREADS / 2; off > 0; off >>= 1) {
    if (t < off && red[t + off] > red[t]) red[t] = red[t + off];
    __syncthreads();
  }
  if (t == 0) {
    th[0] = red[0] == KEY_NONE ? KEY_NONE : red[0] - 1;  // keys >= the bound
    cnt[0] = 0;
  }
  __syncthreads();

  // keys base + t + j * TOPK_THREADS of a step, loaded a step ahead
  constexpr int STEP = TOPK_THREADS * MERGE_RPT;
  long long next[MERGE_RPT];
#pragma unroll
  for (int j = 0; j < MERGE_RPT; ++j) {
    const long long e = t + j * TOPK_THREADS;
    next[j] = e < m ? src[e] : KEY_NONE;
  }
  for (long long base = 0; base < m; base += STEP) {
    long long key[MERGE_RPT];
#pragma unroll
    for (int j = 0; j < MERGE_RPT; ++j) {
      key[j] = next[j];
      const long long e = base + STEP + t + j * TOPK_THREADS;
      next[j] = e < m ? src[e] : KEY_NONE;
    }
    unsigned failed = 0;
#pragma unroll
    for (int j = 0; j < MERGE_RPT; ++j)
      if (!topk_offer(buf, th, cnt, 0, L, k, key[j])) failed |= 1u << j;
    while (__syncthreads_or(failed != 0)) {
      topk_merge(buf, th, cnt, 1, L, k);
      unsigned again = 0;
#pragma unroll
      for (int j = 0; j < MERGE_RPT; ++j)
        if (((failed >> j) & 1u) &&
            !topk_offer(buf, th, cnt, 0, L, k, key[j]))
          again |= 1u << j;
      failed = again;
    }
  }
  topk_merge(buf, th, cnt, 1, L, k);
  return buf;
}
