// GLoRIA word-region similarity, forward (K3) and the backward's prologue —
// for sm_90a.
//
// Replaces the Pallas TPU kernel `_sim_kernel` (driven by `_sim_forward`,
// forward chain `_cell_recompute`) in medmoe_tpu/ops/pallas/gloria_attention.py
// and, as the backward's prologue, the share of `_cell_cotangents` down to
// d_wei. For each (image b, caption i) pair, over the image's M = H·W regions:
//   scores[m,t] = Σ_d ctx[b,m,d]·words[i,d,t]              bf16 products, f32 sums
//   a1 = softmax_t(scores | t < cap_i),  a2 = softmax_m(temp1·a1)     f32
//   wei[d,t] = Σ_m ctx[b,m,d]·a2[m,t]                      f32 a2
//   cos[t] = ⟨w_t, wei_t⟩ / max(‖w_t‖·‖wei_t‖, 1e-8)
//   sim[b,i] = temp3 · log Σ_{t<cap_i} exp(temp2·cos[t])
// The prologue (`medmoe_gloria_pair_cotangents`) goes on to bf16(d_wei) and
// four per-word vectors for K4a/K4b (csrc/gloria_attention_bwd.cu) and,
// when d_words is asked for, K4b's f32 terms (dwords_wei_kernel).
//
// What bounds it on the H100: operations. Two products of 2·M·T·D per pair,
// 7.89 TFLOP each at B=256, flagship shapes and T = 25 (16.0 ms of bf16
// tensor-core time), against 1.2 GB of ctx (0.37 ms of memory). The passes
// below run padded products: F1 2·M·D·TPAD per pair (10.1 TFLOP at TPAD = 32
// and B = 256) and F2 twice that (20.2 TFLOP), since f32 a2 enters the
// tensor cores as two bf16 parts.
//
// Design: three kernels for each chunk of images, the pair loop moved into
// the products' N and K, the products on the tiled GEMM core of
// csrc/gemm_core.cuh (mma.sync, 128 × 128 block tiles, a cp.async ring):
//   F1 (sim_e_kernel): S_b = ctx_b [M, D] · W [D, B_txt·TPAD]. A 128-wide
//     tile holds whole captions (four of 32 padded words, or one of up to
//     128), so its epilogue sees every word of a row: the masked word
//     softmax, e = exp(temp1·a1 - e_off), written transposed as Eᵀ_b =
//     [bf16 hi ; bf16 lo] of e, [2, B_txt·TPAD, MP] (MP = M rounded up to 8),
//     and Σ_m e of each word over the tile's 128 rows.
//   F2 (sim_wei_kernel): weiᵀ_b [B_txt·TPAD, D] = [E_hiᵀ | E_loᵀ] ·
//     [ctx_b ; ctx_b], K = 2·MP in order. Its epilogue sums Σ_m e over the M
//     tiles in order, divides, and writes per-(D tile, word) partial sums of
//     w·wei, wei² and w² (the prologue also wei itself, f32).
//   F3 (sim_finish_kernel): a warp a pair. The D tiles' partials in order,
//     cos, Σ_t row, then sim (K3), or the tail of `_cell_cotangents` (the
//     prologue): dnum, c2, d_wei = bf16(dnum·w + dnwei/max(‖wei‖, 1e-20)·wei),
//     s = Σ_d bf16(d_wei)·wei and Σ_m e.
//   dwords_wei_kernel (the prologue, for K4b): Σ_b dnum·wei [B_txt, D, TPAD]
//     from F2's f32 wei, and Σ_b c2 [B_txt, TPAD], the images in order
//     across the chunks: d_words' two terms that take no product.
// The softmax over M needs no running maximum: 0 <= a1 <= 1, so temp1·a1
// never exceeds e_off = max(temp1, 0), and e lies in [exp(-|temp1|), 1] (the
// wrapper takes |temp1| <= 80); a2 = e/Σe. ctx is exactly bf16, so the hi
// and lo products give f32 wei to about 2^-16 relative.
//
// What this answers in the single kernel it replaces (one block a pair, a
// template shared by both entry points):
//   - each block streamed its image's whole ctx (4.8 MB) for one caption,
//     ≈315 GB from L2 a call at B=256; here ctx_b is an operand of dense
//     products over all captions at once, read once a 128-word tile;
//   - its products were WMMA 16×16×16 on [32, 32] tiles, a warp an eighth of
//     D, with no load behind a product; here 128 × 128 tiles of mma.sync on
//     a cp.async ring;
//   - its [D, 32] f32 wei accumulator (96 registers a thread) left room for
//     one caption a block and one block an SM; here wei is a product's
//     output tile, two blocks an SM;
//   - above T = 32 it recomputed the scores of every word tile at each M
//     tile; here a tile holds whole captions, so no score is recomputed.
// No atomics: every sum over M, D or words runs in a fixed order, and two
// runs give the same bits. The wrapper allocates the scratch (E, the
// partial sums, and the prologue's wei [chunk, B_txt, D, TPAD] f32) for a
// chunk of images and sizes the chunk.
//
// Shapes the kernels take (the wrapper checks them): T <= 128, D % 16 == 0,
// D <= 768, |temp1| <= 80.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (medmoe_torch/ops/_build.py).

#include "gemm_core.cuh"
#include "gloria_common.cuh"

#define TILE 128  // the passes' block tiles: 128 rows, 128 columns

using F1Tile = gemm::Tile<TILE, TILE, 64, 32, 3, gemm::kKN>;
using F2Tile = gemm::Tile<TILE, TILE, 64, 32, 4, gemm::kKN>;

// The passes' scratch for one chunk of images (N = B_txt·TPAD words)
struct PassArgs {
  bf16* e;       // [chunk, 2, N, MP]: bf16 hi, then lo, of e, transposed
  float* esum;   // [chunk, n_mt, N]: Σ_m e over each 128-row M tile
  float* part;   // [chunk, n_dt, 3, N]: Σ_d w·wei, wei², w² over each D tile
  float* wei;    // [chunk, B_txt, D, TPAD] f32 (the prologue only)
  int N, MP, n_mt, n_dt;
};

// ---------------------------------------------------------------------------
// F1: e and Σ_m e; grid (M tiles, caption tiles, images of the chunk)
// ---------------------------------------------------------------------------
// A caption's pitch in the tile: TPAD, or the whole tile for TPAD = 96
// (its last 32 columns zero)
template <int NT>
struct F1Geom {
  static constexpr int TPAD = TP * NT, CW = NT == 3 ? TILE : TPAD, CPT = TILE / CW, WPT = CW / 8;
};

__device__ __forceinline__ unsigned bf162_bits(__nv_bfloat162 v) {
  unsigned u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

constexpr int F1_SMEM = F1Tile::SMEM + 2 * TILE * 4;
constexpr int F2_SMEM = F2Tile::SMEM + 7 * TILE * 4;

template <int NT>
__global__ void __launch_bounds__(gemm::kThreads, F1Tile::MIN_BLOCKS)
sim_e_kernel(GloriaArgs a, PassArgs p, int b0) {
  using Cfg = F1Tile;
  using G = F1Geom<NT>;
  constexpr int TPAD = G::TPAD, CW = G::CW, CPT = G::CPT, WPT = G::WPT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + Cfg::SMEM);  // [2][TILE] Σ e of half the rows
  const int D = a.D, M = a.M, Bt = a.Bt, T = a.T, MP = p.MP, N = p.N;
  const int m0 = blockIdx.x * Cfg::BM, i0 = blockIdx.y * CPT, bl = blockIdx.z;
  const int tid = threadIdx.x;
  const bf16* ctx = a.ctx + (size_t)(b0 + bl) * M * D;

  // A = ctx_b rows m0.., D contiguous
  auto load_a = [&](bf16* as, int k0) {
    for (int v = tid; v < Cfg::BM * (gemm::BK / 8); v += gemm::kThreads) {
      const int r = v >> 2, c = (v & 3) * 8, m = m0 + r, k = k0 + c;
      const bool ok = m < M && k < D;
      gemm::cp16(as + r * gemm::LDK + c, ok ? ctx + (size_t)m * D + k : ctx, ok);
    }
  };
  // B = the tile's captions' words, rows d = k0.., N contiguous
  auto load_b = [&](bf16* bs, int k0) {
    constexpr int CH = Cfg::BN / 8;  // 16-byte chunks of a row
    for (int v = tid; v < gemm::BK * CH; v += gemm::kThreads) {
      const int kr = v / CH, n = (v % CH) * 8, d = k0 + kr;
      const int i = i0 + n / CW, c = n % CW;
      const bool ok = d < D && i < Bt && c < TPAD;
      gemm::cp16(bs + kr * Cfg::LDN + n, ok ? a.words + ((size_t)i * D + d) * TPAD + c : a.words,
                 ok);
    }
  };

  float acc[Cfg::MI][Cfg::NI][4];
  gemm::mainloop<Cfg>(smem, D, load_a, load_b, acc);
  float* cs = reinterpret_cast<float*>(smem);
  gemm::store_tile<Cfg>(cs, acc);

  // the row step: 8 threads a (row, caption), words q·WPT.. in this thread;
  // e replaces the scores in place. Fast intrinsics, as in K4a's pass 1 (the
  // divisor, Σ_t of a row, is >= 1).
  const int q = tid & 7;
  for (int u0 = 0; u0 < Cfg::BM * CPT; u0 += gemm::kThreads / 8) {
    const int u = u0 + (tid >> 3);
    const int ci = u / Cfg::BM, r = u % Cfg::BM, i = i0 + ci, m = m0 + r;
    const int cap = i < Bt ? a.cap[i] : 1;
    float* crow = cs + r * Cfg::LDC + ci * CW + q * WPT;
    float x[WPT];
#pragma unroll
    for (int j = 0; j < WPT; j += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(crow + j);
      x[j] = s4.x, x[j + 1] = s4.y, x[j + 2] = s4.z, x[j + 3] = s4.w;
    }
    // a1: softmax over the words t < cap (masked at NEG_INF, as the JAX
    // package), the padded words t >= T left out
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int t = q * WPT + j;
      x[j] = t >= T ? -INFINITY : (t < cap ? x[j] : NEG_INF_F);
      mx = fmaxf(mx, x[j]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float z = 0.0f;
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      x[j] = __expf(x[j] - mx);
      z += x[j];
    }
    z = row_sum8(z);
#pragma unroll
    for (int j = 0; j < WPT; ++j)
      x[j] = m < M && q * WPT + j < T ? __expf(a.temp1 * __fdividef(x[j], z) - a.e_off) : 0.0f;
#pragma unroll
    for (int j = 0; j < WPT; j += 4)
      *reinterpret_cast<float4*>(crow + j) = make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
  }
  __syncthreads();

  // Eᵀ: a thread a (column, half of the rows), 8 rows at a time, 16 bytes
  // of hi and of lo each; Σ_m e of its 64 rows in order
  {
    const int n = tid & (TILE - 1), h = tid >> 7;
    const int i = i0 + n / CW, c = n % CW;
    const bool col = i < Bt && c < TPAD;
    bf16* hi = p.e + ((size_t)bl * 2 * N + (size_t)i * TPAD + c) * MP;
    bf16* lo = hi + (size_t)N * MP;
    float s = 0.0f;
#pragma unroll 2
    for (int g = 0; g < 8; ++g) {
      const int r0 = h * 64 + g * 8, m = m0 + r0;
      unsigned hv[4], lv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v0 = cs[(r0 + 2 * j) * Cfg::LDC + n], v1 = cs[(r0 + 2 * j + 1) * Cfg::LDC + n];
        s += v0;
        s += v1;
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
        const float2 back = __bfloat1622float2(h2);
        hv[j] = bf162_bits(h2);
        lv[j] = bf162_bits(__floats2bfloat162_rn(v0 - back.x, v1 - back.y));
      }
      if (col && m < MP) {
        *reinterpret_cast<uint4*>(hi + m) = make_uint4(hv[0], hv[1], hv[2], hv[3]);
        *reinterpret_cast<uint4*>(lo + m) = make_uint4(lv[0], lv[1], lv[2], lv[3]);
      }
    }
    red[h * TILE + n] = s;
  }
  __syncthreads();
  if (tid < TILE) {
    const int i = i0 + tid / CW, c = tid % CW;
    if (i < Bt && c < TPAD)
      p.esum[((size_t)bl * p.n_mt + blockIdx.x) * N + (size_t)i * TPAD + c] =
          red[tid] + red[TILE + tid];
  }
}

// ---------------------------------------------------------------------------
// F2: weiᵀ_b = [E_hiᵀ | E_loᵀ] · [ctx_b ; ctx_b]; grid (D tiles, word tiles,
// images of the chunk)
// ---------------------------------------------------------------------------
template <bool kBwd>
__global__ void __launch_bounds__(gemm::kThreads, F2Tile::MIN_BLOCKS)
sim_wei_kernel(GloriaArgs a, PassArgs p, int b0) {
  using Cfg = F2Tile;
  extern __shared__ __align__(128) unsigned char smem[];
  float* csum = reinterpret_cast<float*>(smem + Cfg::SMEM);  // [TILE] Σ_m e
  float* red = csum + TILE;                                   // [2][3][TILE]
  const int D = a.D, M = a.M, T = a.T, TPAD = a.TPAD, MP = p.MP, N = p.N, K = 2 * MP;
  const int d0 = blockIdx.x * Cfg::BN, n0 = blockIdx.y * Cfg::BM, bl = blockIdx.z;
  const int tid = threadIdx.x;
  const bf16* ctx = a.ctx + (size_t)(b0 + bl) * M * D;
  const bf16* eh = p.e + (size_t)bl * 2 * N * MP;

  // Σ_m e of the tile's words, the M tiles in order (the ring's barriers
  // order it before the epilogue)
  if (tid < TILE) {
    const int n = n0 + tid;
    float s = 0.0f;
    if (n < N)
      for (int t = 0; t < p.n_mt; ++t) s += p.esum[((size_t)bl * p.n_mt + t) * N + n];
    csum[tid] = s;
  }

  // A = E rows n0.., K contiguous: hi for k < MP, then lo
  auto load_a = [&](bf16* as, int k0) {
    for (int v = tid; v < Cfg::BM * (gemm::BK / 8); v += gemm::kThreads) {
      const int r = v >> 2, c = (v & 3) * 8, n = n0 + r, k = k0 + c;
      const bool ok = n < N && k < K;
      const bf16* src = eh + (k < MP ? (size_t)n * MP + k : (size_t)(N + n) * MP + (k - MP));
      gemm::cp16(as + r * gemm::LDK + c, ok ? src : eh, ok);
    }
  };
  // B = ctx_b rows k mod MP, columns d0.., D contiguous
  auto load_b = [&](bf16* bs, int k0) {
    constexpr int CH = Cfg::BN / 8;
    for (int v = tid; v < gemm::BK * CH; v += gemm::kThreads) {
      const int kr = v / CH, c = (v % CH) * 8, k = k0 + kr, d = d0 + c;
      const int m = k < MP ? k : k - MP;
      const bool ok = k < K && m < M && d < D;
      gemm::cp16(bs + kr * Cfg::LDN + c, ok ? ctx + (size_t)m * D + d : ctx, ok);
    }
  };

  float acc[Cfg::MI][Cfg::NI][4];
  gemm::mainloop<Cfg>(smem, K, load_a, load_b, acc);
  float* cs = reinterpret_cast<float*>(smem);
  gemm::store_tile<Cfg>(cs, acc);

  // a thread a (word, half of the D tile): wei = Σ ctx·e / Σ e (0 for the
  // padded words t >= T), and its sums of w·wei, wei², w² in order of d
  const int r = tid & (TILE - 1), h = tid >> 7, n = n0 + r;
  const int i = n / TPAD, t = n % TPAD;
  const bool word = n < N && t < T;
  float num = 0.0f, wei2 = 0.0f, w2 = 0.0f;
  if (n < N) {
    const bf16* w = a.words + (size_t)i * D * TPAD + t;
    float* out = kBwd ? p.wei + (size_t)bl * N * D + (size_t)i * D * TPAD + t : nullptr;
    const float div = word ? csum[r] : 1.0f;
    for (int c = h * (Cfg::BN / 2); c < (h + 1) * (Cfg::BN / 2); c += 4) {
      const int d = d0 + c;
      if (d >= D) break;  // D % 16 == 0: four columns are all in or all out
      const float4 x4 = *reinterpret_cast<const float4*>(cs + r * Cfg::LDC + c);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = word ? x[j] / div : 0.0f;
        const float wv = __bfloat162float(w[(size_t)(d + j) * TPAD]);
        num += wv * v;
        wei2 += v * v;
        w2 += wv * wv;
        if constexpr (kBwd) out[(size_t)(d + j) * TPAD] = v;
      }
    }
  }
  red[(h * 3 + 0) * TILE + r] = num;
  red[(h * 3 + 1) * TILE + r] = wei2;
  red[(h * 3 + 2) * TILE + r] = w2;
  __syncthreads();
  if (tid < TILE && n < N) {
    float* o = p.part + ((size_t)bl * p.n_dt + blockIdx.x) * 3 * N + n;
#pragma unroll
    for (int k = 0; k < 3; ++k) o[(size_t)k * N] = red[k * TILE + tid] + red[(3 + k) * TILE + tid];
  }
}

// ---------------------------------------------------------------------------
// F3: a warp a pair of the chunk; lane: words lane + 32j, j < NT
// ---------------------------------------------------------------------------
template <bool kBwd>
__global__ void __launch_bounds__(THREADS)
sim_finish_kernel(GloriaArgs a, PassArgs p, int b0, int nb, float* __restrict__ sim,
                  const float* __restrict__ g, bf16* __restrict__ dwei,
                  float* __restrict__ vecs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pl = blockIdx.x * NWARPS + warp;
  if (pl >= nb * a.Bt) return;
  const int bl = pl / a.Bt, i = pl % a.Bt;
  const int D = a.D, T = a.T, TPAD = a.TPAD, N = p.N, nt = a.NT, cap = a.cap[i];
  const size_t pair = (size_t)(b0 + bl) * a.Bt + i;

  // num, ‖w‖, ‖wei‖ of each word: the D tiles in order; row = exp(temp2·cos)
  float num[MAX_NT], nw[MAX_NT], nwei[MAX_NT], term[MAX_NT], rs = 0.0f;
#pragma unroll
  for (int j = 0; j < MAX_NT; ++j) {
    num[j] = nw[j] = nwei[j] = term[j] = 0.0f;
    if (j < nt) {
      const int t = lane + TP * j;
      const float* q = p.part + (size_t)bl * p.n_dt * 3 * N + (size_t)i * TPAD + t;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
      for (int dt = 0; dt < p.n_dt; ++dt, q += 3 * (size_t)N) {
        s0 += q[0];
        s1 += q[N];
        s2 += q[2 * (size_t)N];
      }
      num[j] = s0;
      nwei[j] = sqrtf(s1);
      nw[j] = sqrtf(s2);
      const float den = fmaxf(nw[j] * nwei[j], 1e-8f);
      term[j] = (t < T && t < cap) ? expf(s0 / den * a.temp2) : 0.0f;
      rs += term[j];
    }
  }
  const float rowsum = warp_sum(rs);
  if constexpr (!kBwd) {
    if (lane == 0) sim[pair] = logf(rowsum) * a.temp3;
  } else {
    // _cell_cotangents: sim = temp3·log Σ row; d_wei kept as bf16 (the
    // rounding the cotangent products take); Σ_d bf16(d_wei)·wei per word,
    // which equals the softmax backward's Σ_m a2·d_a2
    const float gg = g[pair];
#pragma unroll
    for (int j = 0; j < MAX_NT; ++j) {
      if (j >= nt) break;
      const int t = lane + TP * j;
      const size_t n = (size_t)i * TPAD + t;
      float colsum = 0.0f;
      for (int mt = 0; mt < p.n_mt; ++mt) colsum += p.esum[((size_t)bl * p.n_mt + mt) * N + n];
      const float den_raw = nw[j] * nwei[j];
      const float den = fmaxf(den_raw, 1e-8f);
      const float dcos = gg * (a.temp2 * a.temp3) * term[j] / rowsum;
      const float mask = den_raw > 1e-8f ? 1.0f : 0.0f;
      const float dnum = dcos / den;
      const float dden = -dcos * num[j] / (den * den) * mask;
      const float dnwei = dden * nw[j], dnw = dden * nwei[j];
      const float cw = dnwei / fmaxf(nwei[j], 1e-20f);
      float* v = vecs + pair * N_VECS * TPAD + t;
      v[V_COLSUM * TPAD] = colsum;
      v[V_DNUM * TPAD] = dnum;
      v[V_C2 * TPAD] = dnw / fmaxf(nw[j], 1e-20f);
      const float* wr = p.wei + (size_t)bl * N * D + (size_t)i * D * TPAD + t;
      const bf16* ww = a.words + (size_t)i * D * TPAD + t;
      bf16* dw = dwei + pair * D * TPAD + t;
      float s = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float x = wr[(size_t)d * TPAD];
        const bf16 dq = __float2bfloat16_rn(dnum * __bfloat162float(ww[(size_t)d * TPAD]) + cw * x);
        dw[(size_t)d * TPAD] = dq;
        s += __bfloat162float(dq) * x;
      }
      v[V_S * TPAD] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// K4b's f32 terms over one chunk: wsum [B_txt, D, TPAD] += Σ_b dnum·wei and
// c2sum [B_txt, TPAD] += Σ_b c2, the chunk's images in order (the first
// chunk starts them at 0); a thread an element, no atomics
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
dwords_wei_kernel(GloriaArgs a, PassArgs p, int b0, int nb, const float* __restrict__ vecs,
                  float* __restrict__ wsum, float* __restrict__ c2sum) {
  const int D = a.D, Bt = a.Bt, TPAD = a.TPAD;
  const long long n = (long long)Bt * D * TPAD;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x; v < n;
       v += (long long)gridDim.x * blockDim.x) {
    const int t = (int)(v % TPAD);
    const long long id = v / TPAD;
    const int d = (int)(id % D), i = (int)(id / D);
    const float* vec = vecs + ((size_t)b0 * Bt + i) * N_VECS * TPAD + t;
    const float* wei = p.wei + (size_t)i * D * TPAD + (size_t)d * TPAD + t;
    float s = b0 == 0 ? 0.0f : wsum[v];
    for (int bl = 0; bl < nb; ++bl)
      s += vec[((size_t)bl * Bt * N_VECS + V_DNUM) * TPAD] * wei[(size_t)bl * Bt * D * TPAD];
    wsum[v] = s;
    if (d == 0) {
      float c = b0 == 0 ? 0.0f : c2sum[(size_t)i * TPAD + t];
      for (int bl = 0; bl < nb; ++bl) c += vec[((size_t)bl * Bt * N_VECS + V_C2) * TPAD];
      c2sum[(size_t)i * TPAD + t] = c;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
static PassArgs pass_args(const GloriaArgs& a, void* e, void* esum, void* part, void* wei) {
  PassArgs p;
  p.e = static_cast<bf16*>(e);
  p.esum = static_cast<float*>(esum);
  p.part = static_cast<float*>(part);
  p.wei = static_cast<float*>(wei);
  p.N = a.Bt * a.TPAD;
  p.MP = round_up(a.M, 8);
  p.n_mt = (a.M + TILE - 1) / TILE;
  p.n_dt = (a.D + TILE - 1) / TILE;
  return p;
}

template <int NT>
static cudaError_t launch_e(const GloriaArgs& a, const PassArgs& p, int b0, int nb,
                            cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(sim_e_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, F1_SMEM);
  if (err != cudaSuccess) return err;
  sim_e_kernel<NT><<<dim3(p.n_mt, (a.Bt + F1Geom<NT>::CPT - 1) / F1Geom<NT>::CPT, nb),
                     gemm::kThreads, F1_SMEM, st>>>(a, p, b0);
  return cudaGetLastError();
}

// F1, F2 and F3 over the chunks of images in order (and K4b's f32 terms
// when wsum is given)
template <bool kBwd>
static int run_passes(const GloriaArgs& a, const PassArgs& p, int chunk, float* sim,
                      const float* g, bf16* dwei, float* vecs, float* wsum, float* c2sum,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(sim_wei_kernel<kBwd>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, F2_SMEM);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < a.Bi; b0 += chunk) {
    const int nb = a.Bi - b0 < chunk ? a.Bi - b0 : chunk;
    switch (a.NT) {
      case 1: err = launch_e<1>(a, p, b0, nb, st); break;
      case 2: err = launch_e<2>(a, p, b0, nb, st); break;
      case 3: err = launch_e<3>(a, p, b0, nb, st); break;
      default: err = launch_e<4>(a, p, b0, nb, st); break;
    }
    if (err != cudaSuccess) return (int)err;
    sim_wei_kernel<kBwd><<<dim3(p.n_dt, (p.N + TILE - 1) / TILE, nb), gemm::kThreads, F2_SMEM,
                           st>>>(a, p, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int pairs = nb * a.Bt;
    sim_finish_kernel<kBwd><<<(pairs + NWARPS - 1) / NWARPS, THREADS, 0, st>>>(a, p, b0, nb, sim,
                                                                             g, dwei, vecs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (wsum != nullptr) {
      const long long n = (long long)a.Bt * a.D * a.TPAD;
      dwords_wei_kernel<<<(int)((n + THREADS - 1) / THREADS), THREADS, 0, st>>>(a, p, b0, nb, vecs,
                                                                               wsum, c2sum);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

extern "C" {

// K3: out [Bi, Bt] f32, through the scratch of one chunk of images: e
// [chunk, 2, Bt·TPAD, MP] bf16, esum [chunk, ⌈M/128⌉, Bt·TPAD] f32 and part
// [chunk, ⌈D/128⌉, 3, Bt·TPAD] f32 (MP = M rounded up to 8). Returns a
// cudaError_t: 0 when the launches were accepted.
int medmoe_gloria_sim(const void* ctx, const void* words, const void* cap, int Bi, int Bt, int M,
                      int D, int T, float temp1, float temp2, float temp3, void* e, void* esum,
                      void* part, int chunk, void* out, void* stream) {
  if (!shapes_ok(Bi, Bt, M, D, T) || chunk < 1 || chunk > 65535)
    return (int)cudaErrorInvalidValue;
  const GloriaArgs a = make_args(ctx, words, cap, Bi, Bt, M, D, T, temp1, temp2, temp3);
  return run_passes<false>(a, pass_args(a, e, esum, part, nullptr), chunk,
                           static_cast<float*>(out), nullptr, nullptr, nullptr, nullptr, nullptr,
                           stream);
}

// The backward's prologue: the forward chain again, then the cotangents
// down to bf16(d_wei) [Bi·Bt, D, TPAD] and the per-word vectors
// [Bi·Bt, 4, TPAD] for the upstream cotangent g [Bi, Bt] f32; the scratch
// of K3 and wei [chunk, Bt, D, TPAD] f32. With wsum [Bt, D, TPAD] and c2sum
// [Bt, TPAD] (both or neither) also K4b's terms Σ_b dnum·wei and Σ_b c2.
int medmoe_gloria_pair_cotangents(const void* ctx, const void* words, const void* cap, int Bi,
                                  int Bt, int M, int D, int T, float temp1, float temp2,
                                  float temp3, const void* g, void* e, void* esum, void* part,
                                  void* wei, int chunk, void* dwei, void* vecs, void* wsum,
                                  void* c2sum, void* stream) {
  if (!shapes_ok(Bi, Bt, M, D, T) || chunk < 1 || chunk > 65535 ||
      (wsum == nullptr) != (c2sum == nullptr))
    return (int)cudaErrorInvalidValue;
  const GloriaArgs a = make_args(ctx, words, cap, Bi, Bt, M, D, T, temp1, temp2, temp3);
  return run_passes<true>(a, pass_args(a, e, esum, part, wei), chunk, nullptr,
                          static_cast<const float*>(g), static_cast<bf16*>(dwei),
                          static_cast<float*>(vecs), static_cast<float*>(wsum),
                          static_cast<float*>(c2sum), stream);
}

const char* medmoe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
