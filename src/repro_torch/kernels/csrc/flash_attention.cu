// K7: fused attention forward with an online softmax.
//
// Replaces the Pallas kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:125, body `_flash_kernel` at :48),
// which the reference's `blocked_attention` (src/repro/models/layers.py)
// runs on every attention layer of the LM encoder.
//
// For query row s of head h in batch b it computes
//   out[b, s, h] = sum_j softmax_j(q . k_j * D^-0.5) v_j
// over the keys j that the masks keep (all from absolute positions):
// k_pos < Sk; with valid_len >= 0 only k_pos < valid_len (and, with a
// window, k_pos >= valid_len - window); causal: q_pos >= k_pos; window
// without valid_len: q_pos - k_pos < window. Head h reads kv head
// h / (Hq / Hkv) (GQA and MQA without duplicating k and v). q, k and v are
// float32 or bf16; everything inside is float32; the output has q's type
// and is acc / max(l, 1e-30), so a row with no key left is 0.
//
// Design: one CUDA block of FA_THREADS threads per (b, h, tile of QT query
// rows); a loop over kv tiles of KT keys takes the place of the TPU's
// sequential kv grid axis, and kv tiles that every row of the tile masks
// are skipped. Per kv tile the block stages k and v in shared memory as
// float32, computes the QT x KT scores (each thread a few whole dot
// products over D; lanes of a warp take consecutive keys, so k rows are
// padded to D + 1 floats and the reads are free of bank conflicts), then
// each query row's TPR threads update the row's running max m and sum l
// (shuffle reductions) and their D / TPR columns of the float32
// accumulator, which stays in registers. QK^T and PV are the kernel's own
// loops of fused multiply-adds.
//
// What bounds it on an H100: at the encoder's shape (q (32, 128, 8, 256),
// k and v (32, 128, 1, 256), bf16, causal) the bytes of q, k, v and the
// output, 37.7 MB, take 0.011 ms at 3.35 TB/s; its 2.1 GFLOP of causal
// products take 0.002 ms on the bf16 tensor cores. This simple design uses
// no tensor cores (float32 FMAs on the CUDA cores) and reads its operands
// from shared memory once per multiply-add, so shared-memory bandwidth,
// not device memory, holds it; each q tile re-reads its kv tiles (from L2),
// and the 8 q heads that share one kv head read it separately. A Hopper
// design (wgmma on bf16 tiles fed by TMA, several heads of one kv head per
// block) is later work.
#include "common.cuh"

#include <cuda_bf16.h>

#define FA_THREADS 128
#define FA_NEG_INF (-1e30f)

struct FlashArgs {
  const void* q;  // (B, Sq, Hq, D)
  const void* k;  // (B, Sk, Hkv, D)
  const void* v;  // (B, Sk, Hkv, D)
  void* out;      // (B, Sq, Hq, D), q's type
  int B, Sq, Sk, Hq, Hkv;
  int causal, window, valid_len;  // valid_len < 0: no valid_len
};

// Query rows (QT) and keys (KT) per tile: the float32 tiles of q, k, v and
// the scores stay under the 48 KB of static shared memory a block may use.
template <int D> struct FlashTile;
template <> struct FlashTile<32> { static constexpr int QT = 16, KT = 32; };
template <> struct FlashTile<64> { static constexpr int QT = 16, KT = 32; };
template <> struct FlashTile<128> { static constexpr int QT = 16, KT = 32; };
template <> struct FlashTile<256> { static constexpr int QT = 8, KT = 16; };

__device__ __forceinline__ float fa_load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float fa_load(const __nv_bfloat16* p,
                                         long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void fa_store(float* p, long long i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void fa_store(__nv_bfloat16* p, long long i,
                                         float x) {
  p[i] = __float2bfloat16(x);  // round to nearest even
}

// Whether key position kp survives the masks for query position qp.
__device__ __forceinline__ bool fa_keep(const FlashArgs& a, int qp, int kp) {
  bool ok = kp < a.Sk;
  if (a.valid_len >= 0) {
    ok = ok && kp < a.valid_len;
    if (a.window > 0) ok = ok && kp >= a.valid_len - a.window;
  }
  if (a.causal) ok = ok && qp >= kp;
  if (a.window > 0 && a.valid_len < 0) ok = ok && qp - kp < a.window;
  return ok;
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const FlashArgs a) {
  constexpr int QT = FlashTile<D>::QT;
  constexpr int KT = FlashTile<D>::KT;
  constexpr int TPR = FA_THREADS / QT;  // threads per query row
  constexpr int ACC = D / TPR;          // accumulator columns per thread
  constexpr int PAIRS = QT * KT / FA_THREADS;
  static_assert(32 % TPR == 0 && D % TPR == 0, "tile shape");
  static_assert(PAIRS * FA_THREADS == QT * KT, "tile shape");
  __shared__ float qs[QT][D + 1];
  __shared__ float ks[KT][D + 1];
  __shared__ float vs[KT][D];
  __shared__ float ps[QT][KT + 1];

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);
  const int t = threadIdx.x;
  const int nq = (a.Sq + QT - 1) / QT;
  const int q0 = static_cast<int>(blockIdx.x % nq) * QT;
  const int bh = static_cast<int>(blockIdx.x / nq);
  const int h = bh % a.Hq;
  const int b = bh / a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));

  for (int e = t; e < QT * D; e += FA_THREADS) {
    const int r = e / D, d = e % D;
    const int s = q0 + r;
    qs[r][d] = s < a.Sq
        ? fa_load(q, (static_cast<long long>(b) * a.Sq + s) * a.Hq * D +
                         static_cast<long long>(h) * D + d)
        : 0.0f;
  }

  // this thread's query row and accumulator columns c + TPR * i
  const int row = t / TPR;
  const int c = t % TPR;
  float m = FA_NEG_INF;
  float l = 0.0f;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;

  const int last_q = q0 + QT - 1;
  for (int k0 = 0; k0 < a.Sk; k0 += KT) {
    const int last_k = k0 + KT - 1;
    bool live = true;
    if (a.causal) live = live && k0 <= last_q;
    if (a.window > 0 && a.valid_len < 0)
      live = live && last_k >= q0 - a.window + 1;
    if (a.valid_len >= 0) {
      live = live && k0 < a.valid_len;
      if (a.window > 0) live = live && last_k >= a.valid_len - a.window;
    }
    if (!live) continue;  // the same for every thread of the block

    __syncthreads();  // the last tile's readers are done with ks, vs, ps
    for (int e = t; e < KT * D; e += FA_THREADS) {
      const int j = e / D, d = e % D;
      const int s = k0 + j;
      float kx = 0.0f, vx = 0.0f;  // zeros past Sk: p = 0 meets no NaN
      if (s < a.Sk) {
        const long long off =
            (static_cast<long long>(b) * a.Sk + s) * a.Hkv * D +
            static_cast<long long>(hk) * D + d;
        kx = fa_load(k, off);
        vx = fa_load(v, off);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();

    // scores: pair e -> (row e / KT, key e % KT)
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int e = t + i * FA_THREADS;
      const int r = e / KT, j = e % KT;
      float dot = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qs[r][d], ks[j][d], dot);
      ps[r][j] = fa_keep(a, q0 + r, k0 + j) ? dot * scale : FA_NEG_INF;
    }
    __syncthreads();

    // online softmax of this row's tile; each thread reads and then
    // overwrites only its own columns j = c, c + TPR, ...
    float mt = FA_NEG_INF;
    for (int j = c; j < KT; j += TPR) mt = fmaxf(mt, ps[row][j]);
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
    const float m_new = fmaxf(m, mt);
    float lt = 0.0f;
    for (int j = c; j < KT; j += TPR) {
      const float p =
          fa_keep(a, q0 + row, k0 + j) ? expf(ps[row][j] - m_new) : 0.0f;
      ps[row][j] = p;
      lt += p;
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, o);
    const float corr = expf(m - m_new);
    l = l * corr + lt;
    m = m_new;
    __syncthreads();  // the row's p, written by its TPR threads

#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] *= corr;
    for (int j = 0; j < KT; ++j) {
      const float p = ps[row][j];
#pragma unroll
      for (int i = 0; i < ACC; ++i)
        acc[i] = fmaf(p, vs[j][c + TPR * i], acc[i]);
    }
  }

  const int s = q0 + row;
  if (s < a.Sq) {
    const float lm = fmaxf(l, 1e-30f);
    const long long base =
        (static_cast<long long>(b) * a.Sq + s) * a.Hq * D +
        static_cast<long long>(h) * D;
#pragma unroll
    for (int i = 0; i < ACC; ++i) fa_store(out, base + c + TPR * i,
                                           acc[i] / lm);
  }
}

template <typename T, int D>
static int flash_launch(FlashArgs& a, cudaStream_t stream) {
  const long long nq = (a.Sq + FlashTile<D>::QT - 1) / FlashTile<D>::QT;
  const long long blocks = static_cast<long long>(a.B) * a.Hq * nq;
  if (blocks > 0x7FFFFFFFLL) return 1;  // cudaErrorInvalidValue
  void* args[] = {&a};
  void (*kernel)(FlashArgs) = flash_attention_kernel<T, D>;
  cudaError_t e = cudaLaunchKernel(kernel,
                                   dim3(static_cast<unsigned>(blocks)),
                                   dim3(FA_THREADS), args, 0, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int flash_dispatch(FlashArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return flash_launch<T, 32>(a, stream);
    case 64: return flash_launch<T, 64>(a, stream);
    case 128: return flash_launch<T, 128>(a, stream);
    case 256: return flash_launch<T, 256>(a, stream);
    default: return 1;
  }
}

// ptr: q, k, v, out (device addresses);
// sc: B, Sq, Sk, Hq, Hkv, D, bf16 (0: float32, 1: bf16), causal, window,
//     valid_len (< 0: none).
// Returns the CUDA error code of the launch (0: launched).
extern "C" int flash_attention_launch(const long long* ptr, const int* sc,
                                      void* stream) {
  FlashArgs a;
  a.q = reinterpret_cast<const void*>(ptr[0]);
  a.k = reinterpret_cast<const void*>(ptr[1]);
  a.v = reinterpret_cast<const void*>(ptr[2]);
  a.out = reinterpret_cast<void*>(ptr[3]);
  a.B = sc[0];
  a.Sq = sc[1];
  a.Sk = sc[2];
  a.Hq = sc[3];
  a.Hkv = sc[4];
  const int D = sc[5];
  const int bf16 = sc[6];
  a.causal = sc[7];
  a.window = sc[8];
  a.valid_len = sc[9];
  if (a.B == 0 || a.Sq == 0 || a.Hq == 0) return 0;
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0) return 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? flash_dispatch<__nv_bfloat16>(a, D, st)
              : flash_dispatch<float>(a, D, st);
}
