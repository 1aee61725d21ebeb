// GLoRIA word-region similarity, backward (K4a: d_ctx, K4b: d_words) —
// for sm_90a.
//
// Replace the Pallas TPU kernels `_dctx_kernel` and `_dwords_kernel`
// (driven by `_bwd_pallas`, chain `_cell_cotangents`) in
// medmoe_tpu/ops/pallas/gloria_attention.py. Both start from the per-pair
// scratch of the prologue in csrc/gloria_attention.cu: bf16(d_wei) [D, TPAD]
// and the per-word vectors Σ_m e, s = Σ_d bf16(d_wei)·wei, dnum and
// c2 = dnw/max(‖w‖, 1e-20). For a pair (b, i) and a row m of ctx:
//   a1, a2      recomputed (a2 = e/Σ_m e, as the forward)
//   d_a2[m,t] = Σ_d ctx[m,d]·bf16(d_wei)[d,t]
//   d_z = a2·(d_a2 - s)  (s is the softmax backward's Σ_m a2·d_a2: equal
//                         in exact arithmetic, and needs no pass over M)
//   d_scores = a1·(temp1·d_z - Σ_t a1·temp1·d_z)
//   K4a: d_ctx[b,m,:] += bf16(a2)[m,:]·bf16(d_wei)ᵀ + bf16(d_scores)[m,:]·wᵀ
//   K4b: d_w[i] += Σ_m ctx[m,:]ᵀ·(bf16(d_scores) + dnum·a2)[m,:]  + c2·w
// (dnum·wei = Σ_m ctx·dnum·a2 is folded into the same product, with
// dnum·a2 split into bf16 hi + lo as the forward splits a2.)
//
// What bounds them on the H100: operations. At B=256 and flagship shapes
// K4a is three products of 7.89 TFLOP (d_a2 and the two d_ctx products,
// 23.9 ms of bf16 tensor-core time) and K4b two (d_a2, d_words; 16.0 ms);
// the recompute of scores (one more product each) is not counted.
//
// K4a: two passes on one tiled GEMM core (csrc/gemm_core.cuh). For an image
// b, with the pair loop moved into the products' K and N:
//   pass 1 (dctx_z_kernel): [scores | d_a2] = ctx_b [M, D] · [w_i | d_wei_bi]
//     [D, B_txt·2·TPAD], the row step in the epilogue, which writes
//     Z_b[m, i, :] = [bf16(a2) | bf16(d_scores)] (the rounding points of
//     the TPU kernel); a 128-wide tile holds whole captions, so the
//     epilogue sees every word of a row;
//   pass 2 (dctx_gemm_kernel): d_ctx[b] = Z_b [M, B_txt·2·TPAD] ·
//     [bf16(d_wei)ᵀ ; wᵀ] [B_txt·2·TPAD, D], B read K-contiguous straight
//     from the scratch, the K loop over the captions in order: no atomics,
//     the same sum on every run.
// The single pass it replaces kept a [32, D] f32 tile of d_ctx in registers
// (a wider one does not fit) and streamed every caption's words and d_wei
// through shared memory for it: ≈617 GB of L2 traffic at B=256 with no load
// hidden behind a product, on 32×32 WMMA tiles. The two passes are dense
// products with 128-wide tiles and a cp.async ring, for ≈53 GB of Z through
// device memory at B=256; Z lives in chunks of images (the wrapper sizes
// them, ≈1.6 GB at flagship). Both are mma.sync; wgmma comes next.
//
// K4b: one block per (caption, share of the images) walks its images and
// their M tiles in order and keeps the caption's [D, TP] d_words in
// registers; a second launch sums the shares in order and adds c2·w.
// Products use WMMA bf16 16×16×16 tiles with f32 accumulators: the
// [32, 32] scores and d_a2 tiles over a quarter of D a warp,
// the row step 8 threads a row, no product behind a branch. Above T = 32
// a third grid axis takes the word tiles, and every M tile forms the
// scores and d_a2 of all word tiles for the row step's sums over T.
//
// The per-pair scratch is B_img·B_txt·D·TPAD bf16 (3.2 GB at B=256, D=768,
// TPAD=32) plus B_img·B_txt·4·TPAD f32, allocated by the wrapper.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (medmoe_torch/ops/_build.py).

#include "gemm_core.cuh"
#include "gloria_common.cuh"

#define MTB 32             // rows of M a tile
#define OLD3 (3 * TP + 8)  // K4b: [d_scores | hi(dnum·a2) | lo(dnum·a2)]

#define PARTS 4            // warps that share one [MTB, TP] product

// ---------------------------------------------------------------------------
// K4a pass 1: Z = [bf16(a2) | bf16(d_scores)]; grid (M tiles, caption
// tiles, images of the chunk)
// ---------------------------------------------------------------------------
// NT <= 2: 128 × 128 tiles (two captions, or one of 64 padded words);
// NT 3-4: 64 × 256 tiles (one caption of up to 128 padded words)
template <int NT>
using ZTile = gemm::Tile<(NT <= 2 ? 128 : 64), (NT <= 2 ? 128 : 256), (NT <= 2 ? 64 : 32),
                         (NT <= 2 ? 32 : 64), 3, gemm::kKN>;

template <int NT>
static int z_smem_bytes() {
  constexpr int CPT = ZTile<NT>::BN / (2 * TP * NT);
  return ZTile<NT>::SMEM + CPT * 2 * TP * NT * 4;
}

template <int NT>
__global__ void __launch_bounds__(gemm::kThreads, ZTile<NT>::MIN_BLOCKS)
dctx_z_kernel(GloriaArgs a, const bf16* __restrict__ dwei, const float* __restrict__ vecs,
              bf16* __restrict__ z, int b0) {
  using Cfg = ZTile<NT>;
  constexpr int TPAD = TP * NT, CW = 2 * TPAD, CPT = Cfg::BN / CW, WPT = TPAD / 8;
  static_assert(CPT * 2 * TPAD <= gemm::kThreads, "one per-word value a thread");
  extern __shared__ __align__(128) unsigned char smem[];
  float* vs = reinterpret_cast<float*>(smem + Cfg::SMEM);  // [CPT][Σ_m e | s][TPAD]
  const int D = a.D, M = a.M, Bt = a.Bt, T = a.T;
  const int m0 = blockIdx.x * Cfg::BM, i0 = blockIdx.y * CPT, bl = blockIdx.z, b = b0 + bl;
  const int tid = threadIdx.x;
  const bf16* ctx = a.ctx + (size_t)b * M * D;

  // this thread's value of the tile's per-word vectors, loaded while the
  // products run and stored to vs after them
  float vreg = 1.0f;
  {
    const int c = tid / (2 * TPAD), r = tid % (2 * TPAD), i = i0 + c;
    if (tid < CPT * 2 * TPAD && i < Bt)
      vreg = vecs[((size_t)b * Bt + i) * N_VECS * TPAD + (r < TPAD ? V_COLSUM : V_S) * TPAD +
                  r % TPAD];
  }

  // A = ctx_b rows m0.., D contiguous
  auto load_a = [&](bf16* as, int k0) {
    for (int v = tid; v < Cfg::BM * (gemm::BK / 8); v += gemm::kThreads) {
      const int r = v >> 2, c = (v & 3) * 8, m = m0 + r, k = k0 + c;
      const bool ok = m < M && k < D;
      gemm::cp16(as + r * gemm::LDK + c, ok ? ctx + (size_t)m * D + k : ctx, ok);
    }
  };
  // B = [w_i | d_wei_bi] for the tile's captions, rows d = k0.., N contiguous
  auto load_b = [&](bf16* bs, int k0) {
    constexpr int CH = Cfg::BN / 8;  // 16-byte chunks of a row
    for (int v = tid; v < gemm::BK * CH; v += gemm::kThreads) {
      const int kr = v / CH, n = (v % CH) * 8, d = k0 + kr;
      const int ci = n / CW, c = n % CW, i = i0 + ci;
      const bool ok = d < D && ci < CPT && i < Bt;
      const bf16* src = a.words;
      if (ok)
        src = c < TPAD ? a.words + ((size_t)i * D + d) * TPAD + c
                       : dwei + (((size_t)b * Bt + i) * D + d) * TPAD + (c - TPAD);
      gemm::cp16(bs + kr * Cfg::LDN + n, src, ok);
    }
  };

  float acc[Cfg::MI][Cfg::NI][4];
  gemm::mainloop<Cfg>(smem, D, load_a, load_b, acc);
  if (tid < CPT * 2 * TPAD) vs[tid] = vreg;
  float* cs = reinterpret_cast<float*>(smem);
  gemm::store_tile<Cfg>(cs, acc);  // its barrier covers vs too

  // the row step: 8 threads a (row, caption), words q·WPT.. in this thread.
  // Its exponentials and quotients are the fast intrinsics, a few f32 ulp
  // off (the divisors, Σ_t of a row >= 1 and Σ_m e >= M·exp(-80), stay
  // inside their range): with expf and IEEE division the row step took a
  // third of the pass.
  const int q = tid & 7;
  const size_t zld = (size_t)Bt * CW;
  bf16* zb = z + (size_t)bl * M * zld;
  for (int u0 = 0; u0 < Cfg::BM * CPT; u0 += gemm::kThreads / 8) {
    const int u = u0 + (tid >> 3);
    const int ci = u / Cfg::BM, r = u % Cfg::BM, i = i0 + ci, m = m0 + r;
    const int cap = i < Bt ? a.cap[i] : 1;
    const float* crow = cs + r * Cfg::LDC + ci * CW + q * WPT;
    const float* cv = vs + ci * 2 * TPAD + q * WPT;
    float x[WPT], dd[WPT];
#pragma unroll
    for (int j = 0; j < WPT; j += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(crow + j);
      const float4 d4 = *reinterpret_cast<const float4*>(crow + TPAD + j);
      x[j] = s4.x, x[j + 1] = s4.y, x[j + 2] = s4.z, x[j + 3] = s4.w;
      dd[j] = d4.x, dd[j + 1] = d4.y, dd[j + 2] = d4.z, dd[j + 3] = d4.w;
    }
    // a1: softmax over the words t < cap (t >= T left out), as word_softmax4
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int t = q * WPT + j;
      x[j] = t >= T ? -INFINITY : (t < cap ? x[j] : NEG_INF_F);
      mx = fmaxf(mx, x[j]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float zs = 0.0f;
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      x[j] = __expf(x[j] - mx);
      zs += x[j];
    }
    zs = row_sum8(zs);
    // a2, d_a1 = temp1·a2·(d_a2 - s), d_scores = a1·(d_a1 - Σ_t a1·d_a1)
    float a2[WPT], da1[WPT], tsum = 0.0f;
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const bool live = m < M && q * WPT + j < T;
      x[j] = __fdividef(x[j], zs);  // a1
      a2[j] = live ? __fdividef(__expf(a.temp1 * x[j] - a.e_off), cv[j]) : 0.0f;
      da1[j] = a.temp1 * (a2[j] * (dd[j] - cv[TPAD + j]));
      tsum += x[j] * da1[j];
    }
    tsum = row_sum8(tsum);
    if (m < M && i < Bt) {
      bf16* zr = zb + (size_t)m * zld + (size_t)i * CW + q * WPT;
#pragma unroll
      for (int j = 0; j < WPT; j += 2) {
        const bool l0 = q * WPT + j < T, l1 = q * WPT + j + 1 < T;
        *reinterpret_cast<__nv_bfloat162*>(zr + j) = __floats2bfloat162_rn(a2[j], a2[j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(zr + TPAD + j) =
            __floats2bfloat162_rn(l0 ? x[j] * (da1[j] - tsum) : 0.0f,
                                  l1 ? x[j + 1] * (da1[j + 1] - tsum) : 0.0f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4a pass 2: d_ctx[b] = Z_b · [bf16(d_wei)ᵀ ; wᵀ]; grid (D tiles, M tiles,
// images of the chunk)
// ---------------------------------------------------------------------------
using GTile = gemm::Tile<128, 128, 64, 32, 4, gemm::kNK>;

__global__ void __launch_bounds__(gemm::kThreads, GTile::MIN_BLOCKS)
dctx_gemm_kernel(GloriaArgs a, const bf16* __restrict__ dwei, const bf16* __restrict__ z,
                 float* __restrict__ dctx, int b0) {
  using Cfg = GTile;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, M = a.M, Bt = a.Bt, tpad = a.TPAD, cw = 2 * a.TPAD;
  const int n0 = blockIdx.x * Cfg::BN, m0 = blockIdx.y * Cfg::BM, bl = blockIdx.z, b = b0 + bl;
  const int K = Bt * cw;  // a multiple of 64
  const int tid = threadIdx.x;
  const bf16* zb = z + (size_t)bl * M * K;

  // A = Z_b rows m0.., K contiguous
  auto load_a = [&](bf16* as, int k0) {
    for (int v = tid; v < Cfg::BM * (gemm::BK / 8); v += gemm::kThreads) {
      const int r = v >> 2, c = (v & 3) * 8, m = m0 + r;
      const bool ok = m < M;
      gemm::cp16(as + r * gemm::LDK + c, ok ? zb + (size_t)m * K + k0 + c : zb, ok);
    }
  };
  // B rows k0..k0+31 lie in one half of one caption's block: bf16(d_wei_bi)
  // [D, TPAD] or w_i [D, TPAD], each K-contiguous
  auto load_b = [&](bf16* bs, int k0) {
    const int i = k0 / cw, c0 = k0 % cw;
    const bf16* base = c0 < tpad ? dwei + ((size_t)b * Bt + i) * D * tpad + c0
                                 : a.words + (size_t)i * D * tpad + (c0 - tpad);
    for (int v = tid; v < Cfg::BN * (gemm::BK / 8); v += gemm::kThreads) {
      const int n = v >> 2, c = (v & 3) * 8, d = n0 + n;
      const bool ok = d < D;
      gemm::cp16(bs + n * gemm::LDK + c, ok ? base + (size_t)d * tpad + c : base, ok);
    }
  };

  float acc[Cfg::MI][Cfg::NI][4];
  gemm::mainloop<Cfg>(smem, K, load_a, load_b, acc);
  float* cs = reinterpret_cast<float*>(smem);
  gemm::store_tile<Cfg>(cs, acc);
  float* out = dctx + (size_t)b * M * D;
  for (int v = tid; v < Cfg::BM * (Cfg::BN / 4); v += gemm::kThreads) {
    const int r = v / (Cfg::BN / 4), c = (v % (Cfg::BN / 4)) * 4, m = m0 + r, d = n0 + c;
    if (m < M && d < D)
      *reinterpret_cast<float4*>(out + (size_t)m * D + d) =
          *reinterpret_cast<const float4*>(cs + r * Cfg::LDC + c);
  }
}

template <int NT>
static int launch_dctx(const GloriaArgs& a, const bf16* dwei, const float* vecs, bf16* z,
                       int chunk, float* dctx, cudaStream_t st) {
  using Z = ZTile<NT>;
  constexpr int CPT = Z::BN / (2 * TP * NT);
  const int zsmem = z_smem_bytes<NT>();
  cudaError_t err = cudaFuncSetAttribute(dctx_z_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, zsmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dctx_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             GTile::SMEM);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < a.Bi; b0 += chunk) {
    const int nb = a.Bi - b0 < chunk ? a.Bi - b0 : chunk;
    dctx_z_kernel<NT><<<dim3((a.M + Z::BM - 1) / Z::BM, (a.Bt + CPT - 1) / CPT, nb),
                        gemm::kThreads, zsmem, st>>>(a, dwei, vecs, z, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dctx_gemm_kernel<<<dim3((a.D + GTile::BN - 1) / GTile::BN, (a.M + GTile::BM - 1) / GTile::BM,
                            nb),
                       gemm::kThreads, GTile::SMEM, st>>>(a, dwei, z, dctx, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// K4b
// ---------------------------------------------------------------------------
// ctx tile, words, d_wei, the partial scores and d_a2 tiles, the bf16
// operand, the pair's vectors
static int bwd_smem_bytes(int D, int tpad) {
  const int r0 = round_up(MTB * (D + 8) * 2, 128);
  const int r1 = 2 * round_up(D * WLD * 2, 128);
  const int r2 = round_up(2 * PARTS * MTB * SLD * 4 + MTB * OLD3 * 2, 128);
  const int r3 = N_VECS * tpad * 4;
  return r0 + r1 + r2 + r3;
}

struct BwdSmem {
  bf16* cs;
  bf16* ws;
  bf16* dws;
  float* sc;
  float* da;
  bf16* op;
  float* vec;
};

__device__ __forceinline__ BwdSmem carve(unsigned char* smem, int D) {
  BwdSmem s;
  unsigned char* p = smem;
  s.cs = reinterpret_cast<bf16*>(p);
  p += round_up(MTB * (D + 8) * 2, 128);
  s.ws = reinterpret_cast<bf16*>(p);
  p += round_up(D * WLD * 2, 128);
  s.dws = reinterpret_cast<bf16*>(p);
  p += round_up(D * WLD * 2, 128);
  s.sc = reinterpret_cast<float*>(p);
  s.da = s.sc + PARTS * MTB * SLD;
  s.op = reinterpret_cast<bf16*>(s.da + PARTS * MTB * SLD);
  p += round_up(2 * PARTS * MTB * SLD * 4 + MTB * OLD3 * 2, 128);
  s.vec = reinterpret_cast<float*>(p);
  return s;
}

// scores = ctx_tile·w (warps 0-3) and d_a2 = ctx_tile·bf16(d_wei) (warps
// 4-7), [MTB, TP] each, as PARTS partial tiles
__device__ __forceinline__ void tile_products(const BwdSmem& s, int D) {
  const int warp = threadIdx.x >> 5;
  if (warp < PARTS)
    tile_times_dt(s.cs, s.ws, D, warp, PARTS, s.sc);
  else
    tile_times_dt(s.cs, s.dws, D, warp - PARTS, PARTS, s.da);
}

// Row r of the tile, words 4q..4q+3 (8 threads a row): a2 and d_scores of
// the pair.
__device__ __forceinline__ void row_cotangents(const GloriaArgs& a, const BwdSmem& s, int r,
                                               int q, bool row_live, int cap, float* a2,
                                               float* dsc) {
  float v[4], d[4], a1[4], da1[4];
  sum_parts(s.sc, PARTS, r, q, v);
  sum_parts(s.da, PARTS, r, q, d);
  word_softmax4(v, q, cap, a.T, a1);
  float tsum = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = 4 * q + j;
    const bool live = row_live && t < a.T;
    a2[j] = live ? expf(a.temp1 * a1[j] - a.e_off) / s.vec[V_COLSUM * TP + t] : 0.0f;
    da1[j] = a.temp1 * (a2[j] * (d[j] - s.vec[V_S * TP + t]));
    tsum += a1[j] * da1[j];
  }
  tsum = row_sum8(tsum);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool live = row_live && 4 * q + j < a.T;
    dsc[j] = live ? a1[j] * (da1[j] - tsum) : 0.0f;
  }
}

// The same over nt word tiles (T > 32): scores v and d_a2 d of every tile,
// Σ_t a1·d_a1 over all of them; a2 and d_scores of word tile wt.
__device__ __forceinline__ void row_cotangents_tiles(const GloriaArgs& a, const float* vec,
                                                     const float (*v)[4], const float (*d)[4],
                                                     int wt, int q, bool row_live, int cap,
                                                     float* a2, float* dsc) {
  const int nt = a.NT, tpad = a.TPAD;
  float a1[MAX_NT][4], da1w[4];
  word_softmax_tiles(v, nt, q, cap, a.T, a1);
  float tsum = 0.0f;
  for (int w = 0; w < nt; ++w)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = TP * w + 4 * q + j;
      const bool live = row_live && t < a.T;
      const float x = live ? expf(a.temp1 * a1[w][j] - a.e_off) / vec[V_COLSUM * tpad + t] : 0.0f;
      const float da1 = a.temp1 * (x * (d[w][j] - vec[V_S * tpad + t]));
      tsum += a1[w][j] * da1;
      if (w == wt) {
        a2[j] = x;
        da1w[j] = da1;
      }
    }
  tsum = row_sum8(tsum);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool live = row_live && TP * wt + 4 * q + j < a.T;
    dsc[j] = live ? a1[wt][j] * (da1w[j] - tsum) : 0.0f;
  }
}

// per-share partial d_words [n_split, Bt, D, TPAD] f32 and Σ c2
// [n_split, Bt, TPAD]; grid (Bt, n_split, word tiles)
template <bool kMulti>
__global__ void __launch_bounds__(THREADS, 1)
dwords_kernel(GloriaArgs a, const bf16* __restrict__ dwei, const float* __restrict__ vecs,
              float* __restrict__ part, float* __restrict__ c2part, int n_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, M = a.M;
  const int nt = kMulti ? a.NT : 1;
  const int tpad = kMulti ? a.TPAD : TP;
  const int wt = kMulti ? (int)blockIdx.z : 0, t0 = wt * TP;
  const BwdSmem s = carve(smem, D);
  const int i = blockIdx.x, split = blockIdx.y;
  const int b0 = (int)((long long)a.Bi * split / n_split);
  const int b1 = (int)((long long)a.Bi * (split + 1) / n_split);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int row = tid >> 3, q = tid & 7;  // the row step: 8 threads a row
  const int n_df = D / 16, tf = warp & 1;
  const int cap = a.cap[i];
  const int cld = D + 8;
  const bf16* words = a.words + (size_t)i * D * tpad;

  if (!kMulti) load_dt(s.ws, words, D);  // complete at the first wait

  // d_words [D, TP]: warp owns column fragment tf, row fragments (warp>>1) + 4j
  Acc acc[N_ACC];
#pragma unroll
  for (int j = 0; j < N_ACC; ++j) wmma::fill_fragment(acc[j], 0.0f);
  float c2sum = 0.0f;

  for (int b = b0; b < b1; ++b) {
    const size_t pair = (size_t)b * a.Bt + i;
    const bf16* ctx = a.ctx + (size_t)b * M * D;
    for (int m0 = 0; m0 < M; m0 += MTB) {
      if (m0 == 0) {
        if (!kMulti) load_dt(s.dws, dwei + pair * D * TP, D);
        for (int v = tid; v < N_VECS * tpad; v += THREADS)
          s.vec[v] = vecs[pair * N_VECS * tpad + v];
      }
      load_ctx_tile(s.cs, ctx, m0, MTB, M, D);
      float a2[4], dsc[4];
      if constexpr (!kMulti) {
        cp_async_wait_sync();
        if (m0 == 0 && tid < TP) c2sum += s.vec[V_C2 * TP + tid];
        tile_products(s, D);
        __syncthreads();
        row_cotangents(a, s, row, q, m0 + row < M, cap, a2, dsc);
      } else {
        float v[MAX_NT][4], d[MAX_NT][4];
        for (int w = 0; w < nt; ++w) {  // scores and d_a2 of every word tile
          load_dt(s.ws, words + w * TP, D, tpad);
          load_dt(s.dws, dwei + pair * D * tpad + w * TP, D, tpad);
          cp_async_wait_sync();
          if (w == 0 && m0 == 0 && tid < TP) c2sum += s.vec[V_C2 * tpad + t0 + tid];
          tile_products(s, D);
          __syncthreads();
          sum_parts(s.sc, PARTS, row, q, v[w]);
          sum_parts(s.da, PARTS, row, q, d[w]);
          __syncthreads();
        }
        row_cotangents_tiles(a, s.vec, v, d, wt, q, m0 + row < M, cap, a2, dsc);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = 4 * q + j;
        const float x = s.vec[V_DNUM * tpad + t0 + t] * a2[j];
        const bf16 hi = __float2bfloat16_rn(x);
        s.op[row * OLD3 + t] = __float2bfloat16_rn(dsc[j]);
        s.op[row * OLD3 + TP + t] = hi;
        s.op[row * OLD3 + 2 * TP + t] = __float2bfloat16_rn(x - __bfloat162float(hi));
      }
      __syncthreads();
      // acc += ctx_tileᵀ · (bf16(d_scores) + hi + lo)
#pragma unroll
      for (int k = 0; k < MTB; k += 16) {
        FragB f0, f1, f2;
        wmma::load_matrix_sync(f0, s.op + k * OLD3 + tf * 16, OLD3);
        wmma::load_matrix_sync(f1, s.op + k * OLD3 + TP + tf * 16, OLD3);
        wmma::load_matrix_sync(f2, s.op + k * OLD3 + 2 * TP + tf * 16, OLD3);
#pragma unroll
        for (int g = 0; g < N_ACC; g += N_ACC / 3) {
          FragAT fa[N_ACC / 3];
#pragma unroll
          for (int u = 0; u < N_ACC / 3; ++u) {
            const int df = min((warp >> 1) + 4 * (g + u), n_df - 1);
            wmma::load_matrix_sync(fa[u], s.cs + k * cld + df * 16, cld);
          }
#pragma unroll
          for (int u = 0; u < N_ACC / 3; ++u) wmma::mma_sync(acc[g + u], fa[u], f0, acc[g + u]);
#pragma unroll
          for (int u = 0; u < N_ACC / 3; ++u) wmma::mma_sync(acc[g + u], fa[u], f1, acc[g + u]);
#pragma unroll
          for (int u = 0; u < N_ACC / 3; ++u) wmma::mma_sync(acc[g + u], fa[u], f2, acc[g + u]);
        }
      }
      __syncthreads();
    }
  }

  float* out = part + ((size_t)split * a.Bt + i) * D * tpad + t0;
#pragma unroll
  for (int j = 0; j < N_ACC; ++j) {
    const int df = (warp >> 1) + 4 * j;
    if (df < n_df)
      wmma::store_matrix_sync(out + df * 16 * tpad + tf * 16, acc[j], tpad, wmma::mem_row_major);
  }
  if (tid < TP) c2part[((size_t)split * a.Bt + i) * tpad + t0 + tid] = c2sum;
}

// d_words [Bt, D, T] = Σ_split part + (Σ_split c2)·w, in split order
__global__ void dwords_reduce_kernel(const float* __restrict__ part,
                                     const float* __restrict__ c2part,
                                     const bf16* __restrict__ words, float* __restrict__ dw,
                                     int Bt, int D, int T, int tpad, int n_split) {
  const long long n = (long long)Bt * D * T;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x; v < n;
       v += (long long)gridDim.x * blockDim.x) {
    const int t = (int)(v % T);
    const long long id = v / T;
    const int d = (int)(id % D), i = (int)(id / D);
    float sum = 0.0f, c2 = 0.0f;
    for (int sp = 0; sp < n_split; ++sp) {
      sum += part[(((size_t)sp * Bt + i) * D + d) * tpad + t];
      c2 += c2part[((size_t)sp * Bt + i) * tpad + t];
    }
    dw[v] = sum + c2 * __bfloat162float(words[((size_t)i * D + d) * tpad + t]);
  }
}

template <bool kMulti>
static int launch_dwords(const GloriaArgs& a, const bf16* dwei, const float* vecs, float* part,
                         float* c2part, int n_split, cudaStream_t st) {
  const int smem = bwd_smem_bytes(a.D, a.TPAD);
  cudaError_t err = cudaFuncSetAttribute(dwords_kernel<kMulti>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dwords_kernel<kMulti><<<dim3(a.Bt, n_split, a.NT), THREADS, smem, st>>>(a, dwei, vecs, part,
                                                                         c2part, n_split);
  return (int)cudaGetLastError();
}

extern "C" {

// K4a: d_ctx [Bi, M, D] f32 from the prologue's scratch, through
// z [chunk, M, Bt·2·TPAD] bf16 (scratch), chunk images at a time. Returns
// a cudaError_t: 0 when the launches were accepted.
int medmoe_gloria_dctx(const void* ctx, const void* words, const void* cap, int Bi, int Bt,
                       int M, int D, int T, float temp1, const void* dwei, const void* vecs,
                       void* z, int chunk, void* dctx, void* stream) {
  if (!shapes_ok(Bi, Bt, M, D, T) || chunk < 1 || chunk > 65535)
    return (int)cudaErrorInvalidValue;
  const GloriaArgs a = make_args(ctx, words, cap, Bi, Bt, M, D, T, temp1, 0.0f, 0.0f);
  const bf16* dw = static_cast<const bf16*>(dwei);
  const float* vv = static_cast<const float*>(vecs);
  bf16* zz = static_cast<bf16*>(z);
  float* out = static_cast<float*>(dctx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.NT) {
    case 1: return launch_dctx<1>(a, dw, vv, zz, chunk, out, st);
    case 2: return launch_dctx<2>(a, dw, vv, zz, chunk, out, st);
    case 3: return launch_dctx<3>(a, dw, vv, zz, chunk, out, st);
    default: return launch_dctx<4>(a, dw, vv, zz, chunk, out, st);
  }
}

// K4b: d_words [Bt, D, T] f32, through the partial sums part
// [n_split, Bt, D, TPAD] and c2part [n_split, Bt, TPAD] (scratch).
int medmoe_gloria_dwords(const void* ctx, const void* words, const void* cap, int Bi, int Bt,
                         int M, int D, int T, float temp1, const void* dwei, const void* vecs,
                         void* part, void* c2part, int n_split, void* dw, void* stream) {
  if (!shapes_ok(Bi, Bt, M, D, T) || n_split < 1 || n_split > Bi || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  const GloriaArgs a = make_args(ctx, words, cap, Bi, Bt, M, D, T, temp1, 0.0f, 0.0f);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* dwq = static_cast<const bf16*>(dwei);
  const float* vv = static_cast<const float*>(vecs);
  float* pp = static_cast<float*>(part);
  float* cp = static_cast<float*>(c2part);
  const int rc = a.NT == 1 ? launch_dwords<false>(a, dwq, vv, pp, cp, n_split, st)
                           : launch_dwords<true>(a, dwq, vv, pp, cp, n_split, st);
  if (rc != 0) return rc;
  const long long n = (long long)Bt * D * T;
  const int blocks = (int)((n + THREADS - 1) / THREADS < 65535 ? (n + THREADS - 1) / THREADS
                                                                 : 65535);
  dwords_reduce_kernel<<<blocks, THREADS, 0, st>>>(
      pp, cp, static_cast<const bf16*>(words), static_cast<float*>(dw), Bt, D, T, a.TPAD,
      n_split);
  return (int)cudaGetLastError();
}

const char* medmoe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
