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
// float32 or bf16; the sums are float32; the output has q's type and is
// acc / max(l, 1e-30), so a row with no key left is 0. Key tiles that
// every row of a query tile masks are skipped.
//
// What bounds it on an H100: at the encoder's shape (q (32, 128, 8, 256),
// k and v (32, 128, 1, 256), bf16, causal) the bytes of q, k, v and the
// output, 37.7 MB, take 0.011 ms at 3.35 TB/s; its 2.2 GFLOP of causal
// products take 0.002 ms on the bf16 tensor cores. The bound is bytes, and
// q and the output are 33.6 MB of them: each is read or written once, by
// TMA, and each k/v tile once per block for all the q heads that share it.
//
// bf16 (flash_attention_bf16_kernel, Hopper, sm_90a; the instructions
// live in sm90.cuh):
//   * GQA packing: the G = Hq / Hkv heads of kv head hk at position s are
//     contiguous in q, so a block takes the P = 64 / G positions s0.. of
//     one (b, hk) as up to 64 rows r = (s - s0) * G + g (G = 3: 63 rows,
//     and row 63 is never loaded or stored). At the encoder's shape that
//     is 32 x 16 = 512 blocks of 8 positions. Above 64 heads per kv head,
//     a block takes one position and a tile of GT = 64 of its heads
//     (ceil(G / 64) tiles; heads past G are zeros, never stored). Causal, window and the skip of
//     key tiles use the tile's first and last positions; the masks act per
//     element, as the interval of keys [k_lo, k_hi) each row keeps.
//   * Copies by TMA, issued by one elected thread (thread 0): Q once (box
//     (64 columns, G heads, 1, P positions, 1) of a 5-d map of q), then K
//     and V of each live key tile (KT = 64 keys, box of 64 keys x 64
//     columns) into a ring of STAGES stages, each completing on its
//     mbarrier (Q, K[s], V[s]). TMA writes the 128-byte swizzle that the
//     wgmma descriptors read, zero-fills past Sq, Sk and D, and the thread
//     refills a stage once the warpgroup's last product has read it.
//   * One warpgroup (128 threads) per block, two blocks per SM: one
//     block's copies and epilogue overlap the other's products and softmax.
//   * S = Q K^T on the tensor cores: D/16 wgmma m64n64k16 per key tile,
//     Q and K read K-major from shared memory.
//   * Online softmax in registers on S's fragment, in log2 units (exp2 of
//     the score times D^-0.5 log2 e): row max and row sum across the quad
//     of lanes that share a row, running (m, l) float32.
//   * PV on the tensor cores without rounding P to bf16 once: P is split
//     into P_hi = bf16(P) and P_lo = bf16(P - P_hi), written to shared
//     memory (into the stage's K tile, dead once S is computed, where it
//     fits), and O += P_hi V + P_lo V by wgmma m64n64k16 with V read
//     MN-major (the transpose-B bit; no transposed copy), one product per
//     64 columns of D. P then carries about 16 significant bits.
//   * O (64 x D float32) stays in registers (128 a thread at D = 256).
//     The epilogue scales by 1 / max(l, 1e-30), rounds to bf16 (nearest
//     even), stages the tile in Q's shared memory in the layout a TMA load
//     gives, and one TMA store per 64 columns writes it (rows past Sq are
//     out of bounds and not written).
//   * Any head dim D <= 256 runs on the smallest instantiation (32, 64,
//     128, 256) at least as wide, with zero columns past D: the maps take
//     the true D, the scale is D^-0.5 of the true D, and the columns past
//     it are neither read nor stored. D = 32 runs as D = 64 (the tiles'
//     rows are 64 bf16 wide). A D that is not a multiple of 8 comes padded
//     from the wrapper (TMA's row strides must be multiples of 16 bytes).
//     Above 256, bf16 runs on the float32 kernel below, on float32 copies
//     (no reference config has such a D).
//   * Dynamic shared memory, with DP = max(D, 64) (FlashPlan): Q 128 DP
//     bytes, STAGES stages of K and V 256 DP each (one stage at D = 256,
//     two below), P_hi and P_lo 16 KiB outside K only at D <= 64, the
//     mbarriers and 1 KiB to align the tiles: D = 32 and 64: 58,408 bytes;
//     128: 82,984; 256: 99,352.
//
// float32 (flash_attention_kernel, as in the first port but for guarded
// loads and stores past a head dim below the tile's width): one
// block of FA_THREADS threads per (b, h, tile of QT query rows) and, above
// D = 256, per 256-wide slice of the output, whose scores accumulate over
// 256-column chunks of q and k; a loop
// over kv tiles of KT keys stages k and v in shared memory as float32,
// computes the QT x KT scores as dot products, each query row's TPR
// threads update the row's running (m, l) and their D / TPR accumulator
// columns, all with float32 FMAs on the CUDA cores (TF32 could not hold
// the 2e-5 tolerance). No main-path call passes float32 on the card.
#include "common.cuh"
#include "sm90.cuh"

#include <cuda_bf16.h>

#include <cmath>

#define FA_THREADS 128
#define FA_NEG_INF (-1e30f)

struct FlashArgs {
  const void* q;  // (B, Sq, Hq, D)
  const void* k;  // (B, Sk, Hkv, D)
  const void* v;  // (B, Sk, Hkv, D)
  void* out;      // (B, Sq, Hq, D), q's type
  int B, Sq, Sk, Hq, Hkv;
  int D;          // row width in memory, <= the instantiation's width
  int causal, window, valid_len;  // valid_len < 0: no valid_len
  float scale;    // head_dim^-0.5 (the true head dim, not the padded one)
  float scale2;   // scale * log2(e)
};

// Query rows (QT) and keys (KT) per tile: the float32 tiles of q, k, v and
// the scores stay under the 48 KB of static shared memory a block may use.
// A head dim D routes to the smallest width here that is >= D; the
// columns past D are zeros in shared memory and are never stored. Above
// 256 the wide instantiation (FA_WIDE) takes any D: it stages q and k
// FA_DC columns at a time, accumulating each score over the chunks, and
// each block writes one FA_DC-wide slice of the output (blockIdx.y).
#define FA_WIDE 512
#define FA_DC 256
template <int D> struct FlashTile;
template <> struct FlashTile<32> { static constexpr int QT = 16, KT = 32; };
template <> struct FlashTile<64> { static constexpr int QT = 16, KT = 32; };
template <> struct FlashTile<128> { static constexpr int QT = 16, KT = 32; };
template <> struct FlashTile<256> { static constexpr int QT = 8, KT = 16; };
template <> struct FlashTile<FA_WIDE> { static constexpr int QT = 8, KT = 16; };

__device__ __forceinline__ float fa_load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ void fa_store(float* p, long long i, float x) {
  p[i] = x;
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

// Whether any query position in [q_first, q_last] keeps a key of the tile
// [k0, k0 + kt): the same answer for every thread of a block.
__device__ __forceinline__ bool fa_tile_live(const FlashArgs& a, int q_first,
                                             int q_last, int k0, int kt) {
  const int last_k = k0 + kt - 1;
  bool live = true;
  if (a.causal) live = live && k0 <= q_last;
  if (a.window > 0 && a.valid_len < 0)
    live = live && last_k >= q_first - a.window + 1;
  if (a.valid_len >= 0) {
    live = live && k0 < a.valid_len;
    if (a.window > 0) live = live && last_k >= a.valid_len - a.window;
  }
  return live;
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const FlashArgs a) {
  // D: the tile width; a.D <= D: the row width of q, k, v and out (any
  // a.D for the wide instantiation)
  constexpr bool WIDE = D == FA_WIDE;
  constexpr int DC = WIDE ? FA_DC : D;  // columns staged; the output slice
  constexpr int QT = FlashTile<D>::QT;
  constexpr int KT = FlashTile<D>::KT;
  constexpr int TPR = FA_THREADS / QT;  // threads per query row
  constexpr int ACC = DC / TPR;         // accumulator columns per thread
  constexpr int PAIRS = QT * KT / FA_THREADS;
  static_assert(32 % TPR == 0 && DC % TPR == 0, "tile shape");
  static_assert(PAIRS * FA_THREADS == QT * KT, "tile shape");
  __shared__ float qs[QT][DC + 1];
  __shared__ float ks[KT][DC + 1];
  __shared__ float vs[KT][DC];
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
  const float scale = a.scale;
  const int Dm = a.D;
  const int n_chunks = WIDE ? (Dm + DC - 1) / DC : 1;
  const int v0 = static_cast<int>(blockIdx.y) * DC;  // this block's slice

  // q's columns [c0, c0 + DC) of the tile's rows
  auto load_q = [&](int c0) {
    for (int e = t; e < QT * DC; e += FA_THREADS) {
      const int r = e / DC, d = e % DC;
      const int s = q0 + r;
      qs[r][d] = s < a.Sq && c0 + d < Dm
          ? fa_load(q, (static_cast<long long>(b) * a.Sq + s) * a.Hq * Dm +
                           static_cast<long long>(h) * Dm + c0 + d)
          : 0.0f;
    }
  };
  if (!WIDE) load_q(0);

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
    if (!fa_tile_live(a, q0, last_q, k0, KT)) continue;

    __syncthreads();  // the last tile's readers are done with ks, vs, ps
    for (int e = t; e < KT * DC; e += FA_THREADS) {
      const int j = e / DC, d = e % DC;
      const int s = k0 + j;
      float vx = 0.0f;  // zeros past Sk: p = 0 meets no NaN
      if (s < a.Sk && v0 + d < Dm)
        vx = fa_load(v, (static_cast<long long>(b) * a.Sk + s) * a.Hkv * Dm +
                            static_cast<long long>(hk) * Dm + v0 + d);
      vs[j][d] = vx;
    }
    // scores: pair e -> (row e / KT, key e % KT), summed over the chunks
    float dot[PAIRS];
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) dot[i] = 0.0f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int c0 = ch * DC;
      if (ch > 0) __syncthreads();  // the last chunk's readers are done
      if (WIDE) load_q(c0);
      for (int e = t; e < KT * DC; e += FA_THREADS) {
        const int j = e / DC, d = e % DC;
        const int s = k0 + j;
        float kx = 0.0f;
        if (s < a.Sk && c0 + d < Dm)
          kx = fa_load(k, (static_cast<long long>(b) * a.Sk + s) * a.Hkv *
                              Dm + static_cast<long long>(hk) * Dm + c0 + d);
        ks[j][d] = kx;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < PAIRS; ++i) {
        const int e = t + i * FA_THREADS;
        const int r = e / KT, j = e % KT;
#pragma unroll 8
        for (int d = 0; d < DC; ++d) dot[i] = fmaf(qs[r][d], ks[j][d], dot[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int e = t + i * FA_THREADS;
      const int r = e / KT, j = e % KT;
      ps[r][j] = fa_keep(a, q0 + r, k0 + j) ? dot[i] * scale : FA_NEG_INF;
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
        (static_cast<long long>(b) * a.Sq + s) * a.Hq * Dm +
        static_cast<long long>(h) * Dm + v0;
#pragma unroll
    for (int i = 0; i < ACC; ++i)
      if (v0 + c + TPR * i < Dm)
        fa_store(out, base + c + TPR * i, acc[i] / lm);
  }
}

// ------------------------------------------------------------ bf16, sm_90a
#define FA_ROWS 64       // query rows of a block's tile (one wgmma M)
#define FA_KT 64         // keys per kv tile (the N of S = Q K^T)
#define FA_BF16_THREADS 128  // one warpgroup
#define FA_ATOM 8192     // bytes of 64 rows x 64 bf16

// Shared-memory plan of the bf16 kernel for head width D (padded to DP):
// Q, a ring of STAGES K/V tiles, P_hi and P_lo (inside the stage's K tile
// where it holds them: K is dead once S is computed), the mbarriers, and
// 1 KiB to align the tiles to the swizzle's 1024 bytes. Two blocks fit on
// an SM at every D.
template <int D> struct FlashPlan {
  static constexpr int DP = D < 64 ? 64 : D;
  static constexpr int NDB = DP / 64;      // 64-column blocks of a row
  static constexpr int TILE = FA_ATOM * NDB;  // a 64-row tile of Q, K or V
  static constexpr int STAGES = D == 256 ? 1 : 2;  // 2 blocks/SM at 256
  static constexpr bool P_IN_K = TILE >= 2 * FA_ATOM;
  static constexpr int Q = 0;
  static constexpr int KV = TILE;             // stage s: K at KV + 2 s TILE
  static constexpr int P = KV + 2 * STAGES * TILE;  // unless P_IN_K
  static constexpr int BAR = P + (P_IN_K ? 0 : 2 * FA_ATOM);
  static constexpr int BARS = 1 + 2 * STAGES;  // q, kfull, vfull
  static constexpr int BYTES = BAR + 8 * BARS + 1024;
};

// The bf16 kernel's arguments: the shapes and the tensor maps of q, k, v
// and out (see flash_launch_bf16).
struct FlashTmaArgs {
  Sm90TensorMap q, k, v, out;
  FlashArgs a;
  int GT;    // q heads per tile: min(G, 64)
  int n_gt;  // tiles of GT heads per kv head: ceil(G / GT)
  int P;     // query positions per tile (its rows: P * GT <= 64)
};

// Offset in a 64-row tile of the bf16 pair at (row r, even column c).
__device__ __forceinline__ uint32_t fa_pair(int r, int c) {
  return sm90_sw128(static_cast<uint32_t>((c >> 6) * FA_ATOM + r * 128 +
                                          (c & 63) * 2));
}

__device__ __forceinline__ uint32_t fa_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi)))
          << 16);
}

// The first live kv tile at or after k0 (a.Sk if none is left).
__device__ __forceinline__ int fa_next_live(const FlashArgs& a, int q_first,
                                            int q_last, int k0) {
  while (k0 < a.Sk && !fa_tile_live(a, q_first, q_last, k0, FA_KT))
    k0 += FA_KT;
  return k0;
}

// Issue the TMA loads of the K and V tiles at key k0 into one stage.
template <int D>
__device__ __forceinline__ void fa_load_kv(const FlashTmaArgs& p,
                                           unsigned char* k_tile,
                                           uint64_t* kfull, uint64_t* vfull,
                                           int hk, int k0, int b) {
  using Plan = FlashPlan<D>;
  // keys past Sk arrive as zeros: p = 0 meets no NaN
  sm90_mbar_arrive_expect_tx(kfull, Plan::TILE);
  for (int db = 0; db < Plan::NDB; ++db)
    sm90_tma_load(k_tile + db * FA_ATOM, &p.k, kfull, 64 * db, hk, k0, b, 0);
  sm90_mbar_arrive_expect_tx(vfull, Plan::TILE);
  for (int db = 0; db < Plan::NDB; ++db)
    sm90_tma_load(k_tile + Plan::TILE + db * FA_ATOM, &p.v, vfull, 64 * db,
                  hk, k0, b, 0);
}

template <int D>
__global__ void __launch_bounds__(FA_BF16_THREADS, 2)
flash_attention_bf16_kernel(const __grid_constant__ FlashTmaArgs p) {
  using Plan = FlashPlan<D>;
  constexpr int NDB = Plan::NDB;
  constexpr int STAGES = Plan::STAGES;
  const FlashArgs& a = p.a;
  SM90_DYNAMIC_SMEM(fa_smem);
  unsigned char* smem =
      fa_smem + ((1024u - (sm90_smem_addr(fa_smem) & 1023u)) & 1023u);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Plan::BAR);
  uint64_t* qbar = bars;
  uint64_t* kfull = bars + 1;
  uint64_t* vfull = bars + 1 + STAGES;

  const int GT = p.GT;
  const int ntiles = (a.Sq + p.P - 1) / p.P;
  // the longest tiles (last positions, causal) first
  const int s0 = (ntiles - 1 - static_cast<int>(blockIdx.x % ntiles)) * p.P;
  const int rest = static_cast<int>(blockIdx.x / ntiles);
  const int g0 = (rest % p.n_gt) * GT;  // the tile's first head of hk's G
  const int hk = (rest / p.n_gt) % a.Hkv;
  const int b = rest / p.n_gt / a.Hkv;
  const int q_last = min(s0 + p.P, a.Sq) - 1;
  const int t = threadIdx.x;

  // thread 0 issues every copy: Q, then the first STAGES live kv tiles,
  // then each further tile into the stage the last product freed
  int k_load = fa_next_live(a, s0, q_last, 0);  // next tile to load
  if (t == 0) {
    sm90_mbar_init(qbar, 1);
    for (int st = 0; st < STAGES; ++st) {
      sm90_mbar_init(&kfull[st], 1);
      sm90_mbar_init(&vfull[st], 1);
    }
    sm90_mbar_init_fence();
    sm90_mbar_arrive_expect_tx(qbar, NDB * p.P * GT * 128);
    for (int db = 0; db < NDB; ++db)
      sm90_tma_load(smem + Plan::Q + db * FA_ATOM, &p.q, qbar, 64 * db, g0,
                    hk, s0, b);
    for (int st = 0; st < STAGES && k_load < a.Sk; ++st) {
      fa_load_kv<D>(p, smem + Plan::KV + 2 * st * Plan::TILE, &kfull[st],
                    &vfull[st], hk, k_load, b);
      k_load = fa_next_live(a, s0, q_last, k_load + FA_KT);
    }
  }
  __syncthreads();  // the mbarriers are initialised

  // rows m of the fragment, m and m + 8; row m is head hk * G + g0 +
  // m % GT at position s0 + m / GT (rows past P * GT, and heads past G,
  // are neither loaded nor stored)
  const int w = t >> 5, l = t & 31;
  const int m_row[2] = {16 * w + (l >> 2), 16 * w + (l >> 2) + 8};
  // the masks keep the keys [k_lo, k_hi) of each row (fa_keep's terms)
  int k_lo[2], k_hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = s0 + m_row[h] / GT;
    k_hi[h] = a.Sk;
    k_lo[h] = 0;
    if (a.valid_len >= 0) {
      k_hi[h] = min(k_hi[h], a.valid_len);
      if (a.window > 0) k_lo[h] = a.valid_len - a.window;
    } else if (a.window > 0) {
      k_lo[h] = qp - a.window + 1;
    }
    if (a.causal) k_hi[h] = min(k_hi[h], qp + 1);
  }
  // scores in log2 units: exp(x * scale) = exp2(x * scale * log2(e))
  const float scale2 = a.scale2;
  const uint32_t sq = sm90_smem_addr(smem + Plan::Q);

  float o[NDB][32];
#pragma unroll
  for (int db = 0; db < NDB; ++db)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[db][i] = 0.0f;
  float m_run[2] = {FA_NEG_INF, FA_NEG_INF};
  float l_run[2] = {0.0f, 0.0f};  // this thread's columns; quad sum at end

  sm90_mbar_wait(qbar, 0);
  int it = 0;
  for (int k0 = 0; k0 < a.Sk; k0 += FA_KT) {
    if (!fa_tile_live(a, s0, q_last, k0, FA_KT)) continue;
    const int st = it % STAGES;
    const int parity = (it / STAGES) & 1;
    unsigned char* k_tile = smem + Plan::KV + 2 * st * Plan::TILE;
    const uint32_t sk = sm90_smem_addr(k_tile);
    const uint32_t sv = sk + Plan::TILE;
    unsigned char* p_hi = Plan::P_IN_K ? k_tile : smem + Plan::P;
    unsigned char* p_lo = p_hi + FA_ATOM;
    const uint32_t sp = sm90_smem_addr(p_hi);

    // S = Q K^T
    sm90_mbar_wait(&kfull[st], parity);
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    sm90_wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < Plan::DP / 16; ++ks) {
      const uint32_t off = (ks >> 2) * FA_ATOM + (ks & 3) * 32;
      sm90_mma_m64n64k16<0>(s, sm90_desc(sq + off, 16, 1024),
                            sm90_desc(sk + off, 16, 1024), ks > 0);
    }
    sm90_wgmma_commit();
    sm90_wgmma_wait0();
    sm90_fence_regs(s);

    // masks, scale and the tile's row maxima (quad of lanes per row)
    uint32_t keep = 0;
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int kp = k0 + 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
      if (kp >= k_lo[h] && kp < k_hi[h]) {
        keep |= 1u << i;
        s[i] *= scale2;
        m_new[h] = fmaxf(m_new[h], s[i]);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
      corr[h] = exp2f(m_run[h] - m_new[h]);
      m_run[h] = m_new[h];
      l_run[h] *= corr[h];
    }

    // P = exp(S - m) as P_hi + P_lo, in the A layout of the PV product (in
    // the K tile where it fits: every product of S has read K)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      float e[2], lo[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        e[j] = (keep >> (i + j)) & 1u ? exp2f(s[i + j] - m_run[h]) : 0.0f;
        l_run[h] += e[j];
        lo[j] = e[j] - __bfloat162float(__float2bfloat16(e[j]));
      }
      const uint32_t at = fa_pair(m_row[h], 8 * (i >> 2) + 2 * (l & 3));
      *reinterpret_cast<uint32_t*>(p_hi + at) = fa_bf16x2(e[0], e[1]);
      *reinterpret_cast<uint32_t*>(p_lo + at) = fa_bf16x2(lo[0], lo[1]);
    }
    sm90_fence_proxy_async();
    __syncthreads();  // every row of P is written

    // O = O * corr + P_hi V + P_lo V
#pragma unroll
    for (int db = 0; db < NDB; ++db)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[db][i] *= corr[(i >> 1) & 1];
    sm90_mbar_wait(&vfull[st], parity);
    sm90_wgmma_fence();
#pragma unroll
    for (int db = 0; db < NDB; ++db) {
#pragma unroll
      for (int ks = 0; ks < FA_KT / 16; ++ks) {
        const uint64_t dv = sm90_desc(sv + db * FA_ATOM + ks * 2048, 1024,
                                      1024);
        sm90_mma_m64n64k16<1>(o[db], sm90_desc(sp + ks * 32, 16, 1024), dv,
                              1);
        sm90_mma_m64n64k16<1>(o[db],
                              sm90_desc(sp + FA_ATOM + ks * 32, 16, 1024), dv,
                              1);
      }
    }
    sm90_wgmma_commit();
    sm90_wgmma_wait0();
#pragma unroll
    for (int db = 0; db < NDB; ++db) sm90_fence_regs(o[db]);
    if (t == 0 && k_load < a.Sk) {  // every product has read this stage
      fa_load_kv<D>(p, k_tile, &kfull[st], &vfull[st], hk, k_load, b);
      k_load = fa_next_live(a, s0, q_last, k_load + FA_KT);
    }
    ++it;
  }

  // epilogue: O / max(l, 1e-30) in bf16, staged in Q's tile (the layout a
  // TMA load gives), then one TMA store per 64 columns
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    inv[h] = 1.0f / fmaxf(l_run[h], 1e-30f);
  }
  unsigned char* stage_out = smem + Plan::Q;
#pragma unroll
  for (int db = 0; db < NDB; ++db)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      const int c = 64 * db + 8 * (i >> 2) + 2 * (l & 3);
      *reinterpret_cast<uint32_t*>(stage_out + fa_pair(m_row[h], c)) =
          fa_bf16x2(o[db][i] * inv[h], o[db][i + 1] * inv[h]);
    }
  sm90_fence_proxy_async();
  __syncthreads();
  if (t == 0) {
    for (int db = 0; db < NDB; ++db)
      sm90_tma_store(&p.out, stage_out + db * FA_ATOM, 64 * db, g0, hk, s0,
                     b);
    sm90_tma_store_wait();
  }
}

template <int D>
static int flash_launch_f32(FlashArgs& a, cudaStream_t stream) {
  const long long nq = (a.Sq + FlashTile<D>::QT - 1) / FlashTile<D>::QT;
  const long long blocks = static_cast<long long>(a.B) * a.Hq * nq;
  const int slices = D == FA_WIDE ? (a.D + FA_DC - 1) / FA_DC : 1;
  if (blocks > 0x7FFFFFFFLL || slices > 65535) return 1;
  void* args[] = {&a};
  void (*kernel)(FlashArgs) = flash_attention_kernel<float, D>;
  cudaError_t e = cudaLaunchKernel(kernel,
                                   dim3(static_cast<unsigned>(blocks), slices),
                                   dim3(FA_THREADS), args, 0, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Tensor maps of the bf16 kernel, over the row width a.D (TMA needs every
// row stride, a.D * 2 bytes, to be a multiple of 16: the wrapper pads a
// width that is not a multiple of 8). q and out as (a.D, G, Hkv, Sq, B)
// with a box of (64, GT, 1, P, 1): a tile of P positions x GT heads (GT =
// min(G, 64); above 64 heads a kv head's G heads take n_gt tiles of one
// position each), the rows r = s * GT + g in order; k and v as
// (a.D, Hkv, Sk, B, 1) with a box of (64, 1, 64, 1, 1). Columns past a.D
// (up to the instantiation's D), heads past G and positions past Sq or Sk
// are zeros when loaded and never stored.
template <int D>
static int flash_launch_bf16(FlashArgs& a, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  FlashTmaArgs p;
  p.a = a;
  p.GT = G < FA_ROWS ? G : FA_ROWS;
  p.n_gt = (G + p.GT - 1) / p.GT;
  p.P = FA_ROWS / p.GT;
  const uint64_t e = 2;  // bytes of a bf16
  const uint64_t Dm = static_cast<uint64_t>(a.D);
  const uint64_t q_dims[5] = {Dm, static_cast<uint64_t>(G),
                              static_cast<uint64_t>(a.Hkv),
                              static_cast<uint64_t>(a.Sq),
                              static_cast<uint64_t>(a.B)};
  const uint64_t q_strides[4] = {Dm * e, G * Dm * e, a.Hq * Dm * e,
                                 static_cast<uint64_t>(a.Sq) * a.Hq * Dm * e};
  const uint32_t q_box[5] = {64, static_cast<uint32_t>(p.GT), 1,
                             static_cast<uint32_t>(p.P), 1};
  const uint64_t kv_dims[5] = {Dm, static_cast<uint64_t>(a.Hkv),
                               static_cast<uint64_t>(a.Sk),
                               static_cast<uint64_t>(a.B), 1};
  const uint64_t kv_strides[4] = {
      Dm * e, a.Hkv * Dm * e, static_cast<uint64_t>(a.Sk) * a.Hkv * Dm * e,
      static_cast<uint64_t>(a.B) * a.Sk * a.Hkv * Dm * e};
  const uint32_t kv_box[5] = {64, 1, FA_KT, 1, 1};
  if (a.Sk > 0) {
    int r = sm90_map_bf16(&p.k, a.k, kv_dims, kv_strides, kv_box);
    if (r == 0) r = sm90_map_bf16(&p.v, a.v, kv_dims, kv_strides, kv_box);
    if (r != 0) return r;
  }
  int r = sm90_map_bf16(&p.q, a.q, q_dims, q_strides, q_box);
  if (r == 0) r = sm90_map_bf16(&p.out, a.out, q_dims, q_strides, q_box);
  if (r != 0) return r;
  const long long blocks = static_cast<long long>(a.B) * a.Hkv * p.n_gt *
                           ((a.Sq + p.P - 1) / p.P);
  if (blocks > 0x7FFFFFFFLL) return 1;
  void (*kernel)(FlashTmaArgs) = flash_attention_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FlashPlan<D>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  err = cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(blocks)),
                         dim3(FA_BF16_THREADS), args, FlashPlan<D>::BYTES,
                         stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Route the row width a.D to the smallest instantiation that holds it.
static int flash_dispatch(FlashArgs& a, int bf16, cudaStream_t st) {
  if (a.D < 1) return 1;
  if (a.D <= 32) return bf16 ? flash_launch_bf16<32>(a, st)
                             : flash_launch_f32<32>(a, st);
  if (a.D <= 64) return bf16 ? flash_launch_bf16<64>(a, st)
                             : flash_launch_f32<64>(a, st);
  if (a.D <= 128) return bf16 ? flash_launch_bf16<128>(a, st)
                              : flash_launch_f32<128>(a, st);
  if (a.D <= 256) return bf16 ? flash_launch_bf16<256>(a, st)
                              : flash_launch_f32<256>(a, st);
  return bf16 ? 1 : flash_launch_f32<FA_WIDE>(a, st);  // bf16: the wrapper
                                                        // widens it
}

// ptr: q, k, v, out (device addresses; bf16 ones 16-byte aligned);
// sc: B, Sq, Sk, Hq, Hkv, D (the row width, <= 256; bf16: a multiple of
//     8), bf16 (0: float32, 1: bf16), causal, window, valid_len (< 0:
//     none), head_dim (<= D: the scale is head_dim^-0.5; the columns past
//     it are zeros).
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
  a.D = sc[5];
  const int bf16 = sc[6];
  a.causal = sc[7];
  a.window = sc[8];
  a.valid_len = sc[9];
  const int head_dim = sc[10];
  a.scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(head_dim)));
  a.scale2 = static_cast<float>(1.4426950408889634 /
                                std::sqrt(static_cast<double>(head_dim)));
  if (a.B == 0 || a.Sq == 0 || a.Hq == 0) return 0;
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0) return 1;
  if (head_dim < 1 || head_dim > a.D) return 1;
  if (bf16) {
    if (a.D % 8) return 1;  // TMA's 16-byte row strides
    for (int i = 0; i < 4; ++i)
      if (ptr[i] & 15) return 716;  // cudaErrorMisalignedAddress
  }
  return flash_dispatch(a, bf16, static_cast<cudaStream_t>(stream));
}
