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
//   K4b: d_w[i] = Σ_b ctx_bᵀ·bf16(d_scores_bi) + Σ_b dnum_bi·wei_bi + (Σ_b c2_bi)·w_i
//
// What bounds them on the H100: operations. At B=256 and flagship shapes
// K4a is three products of 7.89 TFLOP (d_a2 and the two d_ctx products,
// 23.9 ms of bf16 tensor-core time) and K4b one (d_words, 8.0 ms), beside
// the d_a2 product it shares with K4a; the recompute of scores (one more
// product) is not counted.
//
// One host loop runs both, per chunk of images (the wrapper sizes the chunk,
// Z ≈1.6 GB at flagship), on one tiled GEMM core (csrc/gemm_core.cuh). For
// an image b, with the pair loop moved into the products' K and N:
//   pass 1 (dctx_z_kernel): [scores | d_a2] = ctx_b [M, D] · [w_i | d_wei_bi]
//     [D, B_txt·2·TPAD], the row step in the epilogue, which writes
//     Z_b[m, i, :] = [bf16(a2) | bf16(d_scores)] (the rounding points of
//     the TPU kernel); a 128-wide tile holds whole captions, so the
//     epilogue sees every word of a row;
//   pass 2, K4a (dctx_gemm_kernel): d_ctx[b] = Z_b [M, B_txt·2·TPAD] ·
//     [bf16(d_wei)ᵀ ; wᵀ] [B_txt·2·TPAD, D], B read K-contiguous straight
//     from the scratch, the K loop over the captions in order;
//   K4b (dwords_gemm_kernel): d_words [D, B_txt·TPAD] += ctx_chunkᵀ ·
//     Zds, A M-contiguous straight from ctx, B the d_scores half of Z's
//     rows, K over the chunk's images and rows in order; the epilogue adds
//     the tile into the f32 accumulator that the prologue started with
//     Σ_b dnum·wei (f32 wei, as the TPU kernel), in chunk order, and the
//     last chunk's adds (Σ_b c2)·w and writes d_words [B_txt, D, T].
// No atomics: every sum runs in a fixed order, the same on every run. Pass
// 1 runs once a chunk for both cotangents; K4a or K4b is skipped when its
// cotangent is not asked for. Every T <= 128 takes one pass of K4b: a word
// column of the product needs no other word. All are mma.sync; wgmma
// comes next.
//
// The per-pair scratch is B_img·B_txt·D·TPAD bf16 (3.2 GB at B=256, D=768,
// TPAD=32) plus B_img·B_txt·4·TPAD f32, allocated by the wrapper, and, for
// d_words, the accumulator B_txt·D·TPAD f32 (25 MB at flagship).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (medmoe_torch/ops/_build.py).

#include "gemm_core.cuh"
#include "gloria_common.cuh"

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

// ---------------------------------------------------------------------------
// K4b: d_words += ctx_chunkᵀ · Zds; grid (D tiles, word tiles); the last
// chunk also adds (Σ c2)·w and writes d_words [B_txt, D, T]
// ---------------------------------------------------------------------------
using WTile = gemm::Tile<128, 128, 64, 32, 4, gemm::kKN, gemm::kKM>;

__global__ void __launch_bounds__(gemm::kThreads, WTile::MIN_BLOCKS)
dwords_gemm_kernel(GloriaArgs a, const bf16* __restrict__ z, int b0, int nb,
                   float* __restrict__ wsum, const float* __restrict__ c2sum,
                   float* __restrict__ dw) {
  using Cfg = WTile;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, M = a.M, Bt = a.Bt, T = a.T, tpad = a.TPAD, cw = 2 * a.TPAD;
  const int m0 = blockIdx.x * Cfg::BM, n0 = blockIdx.y * Cfg::BN;  // d, word column
  const int N = Bt * tpad, K = nb * M;
  const size_t zld = (size_t)Bt * cw;
  const int tid = threadIdx.x;
  const bf16* ctx = a.ctx + (size_t)b0 * M * D;

  // A = ctxᵀ: slice rows k (the chunk's rows, image by image), columns d
  // contiguous
  auto load_a = [&](bf16* as, int k0) {
    for (int v = tid; v < gemm::BK * (Cfg::BM / 8); v += gemm::kThreads) {
      const int kr = v / (Cfg::BM / 8), c = (v % (Cfg::BM / 8)) * 8, k = k0 + kr, d = m0 + c;
      const bool ok = k < K && d < D;
      gemm::cp16(as + kr * Cfg::LDM + c, ok ? ctx + (size_t)k * D + d : ctx, ok);
    }
  };
  // B = bf16(d_scores): row k of Z, word column n = i·TPAD + t at i·2·TPAD +
  // TPAD + t, N contiguous
  auto load_b = [&](bf16* bs, int k0) {
    for (int v = tid; v < gemm::BK * (Cfg::BN / 8); v += gemm::kThreads) {
      const int kr = v / (Cfg::BN / 8), c = (v % (Cfg::BN / 8)) * 8, k = k0 + kr, n = n0 + c;
      const bool ok = k < K && n < N;
      gemm::cp16(bs + kr * Cfg::LDN + c,
                 ok ? z + (size_t)k * zld + (size_t)(n / tpad) * cw + tpad + n % tpad : z, ok);
    }
  };

  float acc[Cfg::MI][Cfg::NI][4];
  gemm::mainloop<Cfg>(smem, K, load_a, load_b, acc);
  float* cs = reinterpret_cast<float*>(smem);
  gemm::store_tile<Cfg>(cs, acc);

  // four words of one caption a thread: the accumulator [B_txt, D, TPAD]
  // plus this chunk's tile, stored back, or (last chunk) plus (Σ c2)·w to
  // d_words
  const bool last = b0 + nb == a.Bi;
  for (int v = tid; v < Cfg::BM * (Cfg::BN / 4); v += gemm::kThreads) {
    const int r = v / (Cfg::BN / 4), c = (v % (Cfg::BN / 4)) * 4, d = m0 + r, n = n0 + c;
    if (d >= D || n >= N) continue;
    const int i = n / tpad, t = n % tpad;
    const size_t at = ((size_t)i * D + d) * tpad + t;
    const float4 w4 = *reinterpret_cast<const float4*>(wsum + at);
    const float* cv = cs + r * Cfg::LDC + c;
    const float x[4] = {w4.x + cv[0], w4.y + cv[1], w4.z + cv[2], w4.w + cv[3]};
    if (!last) {
      *reinterpret_cast<float4*>(wsum + at) = make_float4(x[0], x[1], x[2], x[3]);
      continue;
    }
    float* out = dw + ((size_t)i * D + d) * T;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (t + j < T)
        out[t + j] = x[j] + c2sum[(size_t)i * tpad + t + j] * __bfloat162float(a.words[at + j]);
  }
}

// pass 1 over the chunks of images in order, then K4a's pass 2 (dctx) and
// K4b (dw) for the chunk, each when asked for
template <int NT>
static int launch_cotangents(const GloriaArgs& a, const bf16* dwei, const float* vecs, bf16* z,
                             int chunk, float* dctx, float* wsum, const float* c2sum, float* dw,
                             cudaStream_t st) {
  using Z = ZTile<NT>;
  constexpr int CPT = Z::BN / (2 * TP * NT);
  const int zsmem = z_smem_bytes<NT>();
  cudaError_t err = cudaFuncSetAttribute(dctx_z_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, zsmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dctx_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             GTile::SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dwords_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WTile::SMEM);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < a.Bi; b0 += chunk) {
    const int nb = a.Bi - b0 < chunk ? a.Bi - b0 : chunk;
    dctx_z_kernel<NT><<<dim3((a.M + Z::BM - 1) / Z::BM, (a.Bt + CPT - 1) / CPT, nb),
                        gemm::kThreads, zsmem, st>>>(a, dwei, vecs, z, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (dctx != nullptr) {
      dctx_gemm_kernel<<<dim3((a.D + GTile::BN - 1) / GTile::BN,
                              (a.M + GTile::BM - 1) / GTile::BM, nb),
                         gemm::kThreads, GTile::SMEM, st>>>(a, dwei, z, dctx, b0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (dw != nullptr) {
      dwords_gemm_kernel<<<dim3((a.D + WTile::BM - 1) / WTile::BM,
                                (a.Bt * a.TPAD + WTile::BN - 1) / WTile::BN),
                           gemm::kThreads, WTile::SMEM, st>>>(a, z, b0, nb, wsum, c2sum, dw);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

extern "C" {

// K4a and K4b from the prologue's scratch, through z [chunk, M, Bt·2·TPAD]
// bf16 (scratch), chunk images at a time: d_ctx [Bi, M, D] f32 when dctx
// is given; d_words [Bt, D, T] f32 when dw is given, with wsum [Bt, D,
// TPAD] and c2sum [Bt, TPAD] as the prologue left them (wsum is summed
// into). Returns a cudaError_t: 0 when the launches were accepted.
int medmoe_gloria_cotangents(const void* ctx, const void* words, const void* cap, int Bi, int Bt,
                             int M, int D, int T, float temp1, const void* dwei, const void* vecs,
                             void* z, int chunk, void* dctx, void* wsum, const void* c2sum,
                             void* dw, void* stream) {
  if (!shapes_ok(Bi, Bt, M, D, T) || chunk < 1 || chunk > 65535 ||
      (dctx == nullptr && dw == nullptr) ||
      (dw != nullptr && (wsum == nullptr || c2sum == nullptr)))
    return (int)cudaErrorInvalidValue;
  const GloriaArgs a = make_args(ctx, words, cap, Bi, Bt, M, D, T, temp1, 0.0f, 0.0f);
  const bf16* dq = static_cast<const bf16*>(dwei);
  const float* vv = static_cast<const float*>(vecs);
  bf16* zz = static_cast<bf16*>(z);
  float* dc = static_cast<float*>(dctx);
  float* ws = static_cast<float*>(wsum);
  const float* c2 = static_cast<const float*>(c2sum);
  float* out = static_cast<float*>(dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.NT) {
    case 1: return launch_cotangents<1>(a, dq, vv, zz, chunk, dc, ws, c2, out, st);
    case 2: return launch_cotangents<2>(a, dq, vv, zz, chunk, dc, ws, c2, out, st);
    case 3: return launch_cotangents<3>(a, dq, vv, zz, chunk, dc, ws, c2, out, st);
    default: return launch_cotangents<4>(a, dq, vv, zz, chunk, dc, ws, c2, out, st);
  }
}

const char* medmoe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
