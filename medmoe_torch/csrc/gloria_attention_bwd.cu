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
// product) is not counted. On padded captions (TPAD words) each of K4a's
// two passes is 20.2 TFLOP at flagship.
//
// One host loop runs both, per chunk of images (the wrapper sizes the chunk,
// Z ≈1.6 GB at flagship). For an image b, with the pair loop moved into the
// products' K and N:
//   pass 1 (dctx_z_kernel): [scores | d_a2] = ctx_b [M, D] · [w_i | d_wei_bi]
//     [D, B_txt·2·TPAD], the row step on the accumulators in registers,
//     which writes Z_b[m, i, :] = [bf16(a2) | bf16(d_scores)] (the rounding
//     points of the TPU kernel); a tile's N holds whole captions (four at
//     TPAD 32, two at 64, one at 96 or 128), so the row step sees every
//     word of a row;
//   pass 2, K4a (dctx_gemm_kernel): d_ctx[b] = Z_b [M, B_txt·2·TPAD] ·
//     [bf16(d_wei)ᵀ ; wᵀ] [B_txt·2·TPAD, D], B read K-contiguous straight
//     from the scratch, the K loop over the captions in order;
//   K4b (dwords_gemm_kernel, then dwords_sum_kernel): d_words [D,
//     B_txt·TPAD] += ctx_chunkᵀ · Zds. K is the chunk's rows (image, m) in
//     order, cut into `slices` slices of whole 64-deep steps (2 from the
//     wrapper); the product writes each slice's f32 partial [B_txt, D,
//     TPAD] to a scratch, and the sum pass adds the slices in order to the
//     f32 accumulator that the prologue started with Σ_b dnum·wei (f32
//     wei, as the TPU kernel), chunk after chunk; on the last chunk it adds
//     (Σ_b c2)·w and writes d_words [B_txt, D, T].
// All three products run on the wgmma core of csrc/wgmma_core.cuh: TMA
// loads through tensor maps built per call, a ring of 64-deep stages, one
// producer warp and two consumer warpgroups on 128 × N tiles (N = 256, or
// 192 at TPAD 96 in pass 1), one persistent block an SM. Pass 1's row step
// reads the accumulators where wgmma left them: a row's columns lie in the
// four threads of a quad, so a caption's softmax is two quad shuffles.
// K4b's tiles are 128 d × 256 words; A is ctx (d contiguous: wgmma's
// transposed A, [64 rows][64 d] boxes at 128-byte swizzle) and B Z's
// d_scores halves (words contiguous: [64 rows][32 words] boxes at 64-byte
// swizzle), both through maps over the chunk's rows, which read zeros past
// the last row and past the last caption, so neither M nor B_txt·TPAD
// needs whole tiles. A chunk has 6 × 32 tiles at flagship (256 captions of
// 32 padded words, D = 768); on 132 SMs whole tiles would take two rounds
// for 1.45 rounds of work, and two slices take three rounds of half
// tiles. The walk puts a word tile's D tiles next to each other (they
// read the same B) and the first slice's tiles first (blocks that run
// together read the same rows of A).
// No atomics: every sum runs in a fixed order, the same on every run. Pass
// 1 runs once a chunk for both cotangents; K4a or K4b is skipped when its
// cotangent is not asked for. Every T <= 128 takes one pass of K4b: a word
// column of the product needs no other word.
//
// The per-pair scratch is B_img·B_txt·D·TPAD bf16 (3.2 GB at B=256, D=768,
// TPAD=32) plus B_img·B_txt·4·TPAD f32, allocated by the wrapper, and, for
// d_words, the accumulator B_txt·D·TPAD f32 (25 MB at flagship) and the
// slices' partials, slices·B_txt·D·TPAD f32 (50 MB).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (medmoe_torch/ops/_build.py).

#include "gloria_common.cuh"
#include "wgmma_core.cuh"

// ---------------------------------------------------------------------------
// K4a pass 1: Z = [bf16(a2) | bf16(d_scores)]; persistent over the tiles
// (images of the chunk, caption tiles, M tiles)
// ---------------------------------------------------------------------------
template <int NT>
struct ZTile {
  static constexpr int TPAD = TP * NT, CW = 2 * TPAD;
  static constexpr int BN = NT == 3 ? 192 : 256;  // whole captions
  static constexpr int CPT = BN / CW;              // captions of a tile
  static constexpr int JT = TPAD / 8;              // 8-column blocks of a half caption
  static constexpr int TX = wg::kABytes + BN * wg::kBK * 2;  // bytes of a stage
  static_assert(CPT * CW == BN && BN * wg::kBK * 2 <= wg::kBBytes, "whole captions a tile");
  static_assert(BN <= wg::kVecFloats, "one per-word value a consumer thread");
};

template <int NT>
__global__ void __launch_bounds__(wg::kThreads, 1)
dctx_z_kernel(const __grid_constant__ CUtensorMap ctx_map,
              const __grid_constant__ CUtensorMap words_map,
              const __grid_constant__ CUtensorMap dwei_map, GloriaArgs a,
              const float* __restrict__ vecs, bf16* __restrict__ z, int b0, int nb) {
  using Z = ZTile<NT>;
  constexpr int TPAD = Z::TPAD, CW = Z::CW, CPT = Z::CPT, JT = Z::JT;
  extern __shared__ unsigned char smem_raw[];
  const wg::Smem s = wg::carve(smem_raw);
  const int M = a.M, Bt = a.Bt, T = a.T;
  const int n_mt = (M + wg::kBM - 1) / wg::kBM, n_ct = (Bt + CPT - 1) / CPT;
  const int tiles = nb * n_ct * n_mt, nk = (a.D + wg::kBK - 1) / wg::kBK;
  wg::init_barriers(s);

  if (threadIdx.x < 128) {
    // producer: one thread loads A = ctx_b rows m0.. (the 3-D map reads
    // zeros past M and past D) and B = [w_i | d_wei_bi] for the tile's
    // captions, boxes of [64 d][32 words] side by side in the tile's column
    // order
    wg::reg_dealloc<wg::kProducerRegs>();
    if (threadIdx.x == 0) {
      wg::prefetch_map(&ctx_map);
      wg::prefetch_map(&words_map);
      wg::prefetch_map(&dwei_map);
      wg::Ring ring;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int mt = tile % n_mt, ct = (tile / n_mt) % n_ct, b = b0 + tile / (n_mt * n_ct);
        for (int kb = 0; kb < nk; ++kb) {
          uint64_t* full = &s.full[ring.stage];
          wg::mbar_wait(&s.empty[ring.stage], ring.phase ^ 1u);
          wg::mbar_expect_tx(full, Z::TX);
          const int d0 = kb * wg::kBK;
          wg::tma_load(wg::stage_a(s, ring.stage), &ctx_map, full, d0, mt * wg::kBM, b);
          const uint32_t bs = wg::stage_b(s, ring.stage);
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const int i = ct * CPT + c;
#pragma unroll
            for (int h = 0; h < NT; ++h) {
              constexpr int box = wg::kBK * wg::kBox * 2;
              wg::tma_load(bs + (c * 2 * NT + h) * box, &words_map, full, h * wg::kBox, d0, i);
              wg::tma_load(bs + (c * 2 * NT + NT + h) * box, &dwei_map, full, h * wg::kBox, d0,
                           b * Bt + i);
            }
          }
          ring.advance();
        }
      }
    }
  } else {
    wg::reg_alloc<wg::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1, ci = threadIdx.x - 128;  // warpgroup, consumer thread
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31, q = lane & 3;
    const size_t zld = (size_t)Bt * CW;
    wg::Ring ring;
    float acc[Z::BN / 2];
    int parity = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, parity ^= 1) {
      const int mt = tile % n_mt, ct = (tile / n_mt) % n_ct, bl = tile / (n_mt * n_ct);
      const int b = b0 + bl, i0 = ct * CPT;
      // this thread's value of the tile's per-word vectors [caption][Σ_m e
      // | s][TPAD] and the captions' lengths, loaded while the products run
      float vreg = 1.0f;
      {
        const int c = ci / CW, r = ci % CW, i = i0 + c;
        if (ci < CPT * CW && i < Bt) vreg = vecs[((size_t)b * Bt + i) * N_VECS * TPAD + r];
      }
      int caps[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) caps[c] = i0 + c < Bt ? a.cap[i0 + c] : 1;

      wg::consume<Z::BN, 0, 1>(
          acc, s, ring, nk,
          [&](int st, int ks) { return wg::desc_k128(wg::stage_a(s, st) + cw * 8192, ks); },
          [&](int st, int ks) { return wg::desc_mn64(wg::stage_b(s, st), ks); });

      // the tile's per-word vectors in shared memory, Σ_m e as its
      // reciprocal: a2 = e·(1/Σ_m e), as __fdividef computes e/Σ_m e
      float* vs = s.vecs + parity * wg::kVecFloats;
      if (ci < CPT * CW) vs[ci] = ci % CW < TPAD ? __fdividef(1.0f, vreg) : vreg;
      wg::consumer_sync();

      // the row step, a caption and a row (h) at a time: this thread holds
      // words t = 8jj + 2q + e (bit 2jj + e of the word masks) of rows
      // 16·warp + lane/4 + 8h. Its exponentials and quotients are the fast
      // intrinsics, a few f32 ulp off (the divisors, Σ_t of a row >= 1 and
      // Σ_m e >= M·exp(-80), stay inside their range). The masks select
      // without predicates (keep): a thread holds up to 32 words of a row.
      uint32_t words_t = 0;  // t < T
#pragma unroll
      for (int k = 0; k < 2 * JT; ++k)
        words_t |= (uint32_t)(8 * (k >> 1) + 2 * q + (k & 1) < T) << k;
      bf16* zb = z + (size_t)bl * a.M * zld;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int i = i0 + c;
        uint32_t words_c = 0;  // t < cap
#pragma unroll
        for (int k = 0; k < 2 * JT; ++k)
          words_c |= (uint32_t)(8 * (k >> 1) + 2 * q + (k & 1) < caps[c]) << k;
        const float* cv = vs + c * CW;  // 1/Σ_m e at [t], s at [TPAD + t]
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * wg::kBM + cw * 64 + warp * 16 + (lane >> 2) + 8 * h;
          const bool store = m < M && i < Bt;
          const uint32_t live = m < M ? words_t : 0u;  // rows past M: a2 = 0
          bf16* zr = zb + (size_t)m * zld + (size_t)i * CW + 2 * q;
          // a1: softmax over the words t < cap (masked at NEG_INF, as the
          // JAX package), the padded words t >= T left out
          float mx = -INFINITY;
#pragma unroll
          for (int k = 0; k < 2 * JT; ++k) {
            float& x = acc[4 * (c * CW / 8 + (k >> 1)) + 2 * h + (k & 1)];
            x = (words_t >> k & 1) ? ((words_c >> k & 1) ? x : NEG_INF_F) : -INFINITY;
            mx = fmaxf(mx, x);
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          float zs = 0.0f;
#pragma unroll
          for (int k = 0; k < 2 * JT; ++k) {
            float& x = acc[4 * (c * CW / 8 + (k >> 1)) + 2 * h + (k & 1)];
            x = __expf(x - mx);
            zs += x;
          }
          zs += __shfl_xor_sync(0xffffffffu, zs, 1);
          zs += __shfl_xor_sync(0xffffffffu, zs, 2);
          const float rz = __fdividef(1.0f, zs);
          // a2 (stored), d_a1 = temp1·a2·(d_a2 - s) over d_a2's registers,
          // then d_scores = a1·(d_a1 - Σ_t a1·d_a1)
          float tsum = 0.0f;
#pragma unroll
          for (int jj = 0; jj < JT; ++jj) {
            const float2 rc = *reinterpret_cast<const float2*>(cv + 8 * jj + 2 * q);
            const float2 sv = *reinterpret_cast<const float2*>(cv + TPAD + 8 * jj + 2 * q);
            float a2[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = acc[4 * (c * CW / 8 + jj) + 2 * h + e];
              float& dd = acc[4 * (c * CW / 8 + JT + jj) + 2 * h + e];
              x *= rz;  // a1
              a2[e] = keep(__expf(a.temp1 * x - a.e_off) * (e ? rc.y : rc.x), live, 2 * jj + e);
              dd = a.temp1 * (a2[e] * (dd - (e ? sv.y : sv.x)));
              tsum += x * dd;
            }
            if (store)
              *reinterpret_cast<__nv_bfloat162*>(zr + 8 * jj) =
                  __floats2bfloat162_rn(a2[0], a2[1]);
          }
          tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
          tsum += __shfl_xor_sync(0xffffffffu, tsum, 2);
          if (store) {
#pragma unroll
            for (int jj = 0; jj < JT; ++jj) {
              const int xa = 4 * (c * CW / 8 + jj) + 2 * h;
              const int da = 4 * (c * CW / 8 + JT + jj) + 2 * h;
              *reinterpret_cast<__nv_bfloat162*>(zr + TPAD + 8 * jj) = __floats2bfloat162_rn(
                  keep(acc[xa] * (acc[da] - tsum), words_t, 2 * jj),
                  keep(acc[xa + 1] * (acc[da + 1] - tsum), words_t, 2 * jj + 1));
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4a pass 2: d_ctx[b] = Z_b · [bf16(d_wei)ᵀ ; wᵀ]; persistent over the
// tiles (images of the chunk, M tiles, 256-wide D tiles)
// ---------------------------------------------------------------------------
constexpr int G_BN = 256;
constexpr int G_BOX = G_BN * wg::kBox * 2;  // a [256 d][32 k] box of B

__global__ void __launch_bounds__(wg::kThreads, 1)
dctx_gemm_kernel(const __grid_constant__ CUtensorMap z_map,
                 const __grid_constant__ CUtensorMap words_map,
                 const __grid_constant__ CUtensorMap dwei_map, GloriaArgs a,
                 float* __restrict__ dctx, int b0, int nb) {
  extern __shared__ unsigned char smem_raw[];
  const wg::Smem s = wg::carve(smem_raw);
  const int M = a.M, D = a.D, Bt = a.Bt, tpad = a.TPAD, cw2 = 2 * a.TPAD;
  const int n_nt = (D + G_BN - 1) / G_BN, n_mt = (M + wg::kBM - 1) / wg::kBM;
  const int tiles = nb * n_mt * n_nt, nk = Bt * cw2 / wg::kBK;  // K a multiple of 64
  wg::init_barriers(s);

  if (threadIdx.x < 128) {
    // producer: A = Z_b rows m0.. (zeros past M); B's 64-deep slice is two
    // [256 d][32 k] boxes, each in one half of one caption's block:
    // bf16(d_wei_bi) or w_i, K-contiguous (zeros past D)
    wg::reg_dealloc<wg::kProducerRegs>();
    if (threadIdx.x == 0) {
      wg::prefetch_map(&z_map);
      wg::prefetch_map(&words_map);
      wg::prefetch_map(&dwei_map);
      wg::Ring ring;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int nt = tile % n_nt, mt = (tile / n_nt) % n_mt, bl = tile / (n_nt * n_mt);
        for (int kb = 0; kb < nk; ++kb) {
          uint64_t* full = &s.full[ring.stage];
          wg::mbar_wait(&s.empty[ring.stage], ring.phase ^ 1u);
          wg::mbar_expect_tx(full, wg::kABytes + 2 * G_BOX);
          wg::tma_load(wg::stage_a(s, ring.stage), &z_map, full, kb * wg::kBK, mt * wg::kBM, bl);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = kb * wg::kBK + h * wg::kBox, i = k / cw2, c = k % cw2;
            const uint32_t dst = wg::stage_b(s, ring.stage) + h * G_BOX;
            if (c < tpad)
              wg::tma_load(dst, &dwei_map, full, c, nt * G_BN, (b0 + bl) * Bt + i);
            else
              wg::tma_load(dst, &words_map, full, c - tpad, nt * G_BN, i);
          }
          ring.advance();
        }
      }
    }
  } else {
    wg::reg_alloc<wg::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31, q = lane & 3;
    wg::Ring ring;
    float acc[G_BN / 2];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int nt = tile % n_nt, mt = (tile / n_nt) % n_mt, b = b0 + tile / (n_nt * n_mt);
      wg::consume<G_BN, 0, 0>(
          acc, s, ring, nk,
          [&](int st, int ks) { return wg::desc_k128(wg::stage_a(s, st) + cw * 8192, ks); },
          [&](int st, int ks) { return wg::desc_k64(wg::stage_b(s, st), ks, G_BOX); });
      // f32 d_ctx straight from the registers: a quad writes 32 bytes of a row
      float* out = dctx + (size_t)b * M * D;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * wg::kBM + cw * 64 + warp * 16 + (lane >> 2) + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < G_BN / 8; ++j) {
          const int d = nt * G_BN + 8 * j + 2 * q;
          if (d < D)
            *reinterpret_cast<float2*>(out + (size_t)m * D + d) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4b's product: slice sl of the chunk's K, part[sl] = ctx_chunkᵀ · Zds over
// the slice's 64-deep steps; persistent over the tiles (slices, 256-word
// tiles, 128-wide D tiles)
// ---------------------------------------------------------------------------
constexpr int W_BN = 256;                          // words of a tile
constexpr int W_ABOX = wg::kBK * wg::kBox128 * 2;  // a [64 rows][64 d] box of ctx, 8 KB
constexpr int W_BBOX = wg::kBK * wg::kBox * 2;     // a [64 rows][32 words] box of Zds, 4 KB
constexpr int W_TX = wg::kABytes + W_BN * wg::kBK * 2;

// the 64-deep steps [k0, k1) of slice sl of nk steps
__device__ __forceinline__ void slice_steps(int sl, int slices, int nk, int& k0, int& k1) {
  k0 = (int)((long long)sl * nk / slices);
  k1 = (int)((long long)(sl + 1) * nk / slices);
}

__global__ void __launch_bounds__(wg::kThreads, 1)
dwords_gemm_kernel(const __grid_constant__ CUtensorMap ctx_map,
                   const __grid_constant__ CUtensorMap zds_map, GloriaArgs a, int rows,
                   int slices, float* __restrict__ part) {
  extern __shared__ unsigned char smem_raw[];
  const wg::Smem s = wg::carve(smem_raw);
  const int D = a.D, Bt = a.Bt, tpad = a.TPAD;
  const int n_dt = (D + wg::kBM - 1) / wg::kBM, n_nt = (Bt * tpad + W_BN - 1) / W_BN;
  const int tiles = slices * n_nt * n_dt, nk = (rows + wg::kBK - 1) / wg::kBK;
  wg::init_barriers(s);

  if (threadIdx.x < 128) {
    // producer: A = the chunk's ctx rows r0.. (images in order, zeros past
    // the chunk), columns d0.. in two [64 rows][64 d] boxes; B = the same
    // rows of Zds, the tile's words in eight [64 rows][32 words] boxes side
    // by side (zeros past the last caption)
    wg::reg_dealloc<wg::kProducerRegs>();
    if (threadIdx.x == 0) {
      wg::prefetch_map(&ctx_map);
      wg::prefetch_map(&zds_map);
      wg::Ring ring;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int dt = tile % n_dt, nt = (tile / n_dt) % n_nt, sl = tile / (n_dt * n_nt);
        int k0, k1;
        slice_steps(sl, slices, nk, k0, k1);
        for (int kb = k0; kb < k1; ++kb) {
          uint64_t* full = &s.full[ring.stage];
          wg::mbar_wait(&s.empty[ring.stage], ring.phase ^ 1u);
          wg::mbar_expect_tx(full, W_TX);
          const int r0 = kb * wg::kBK;
          const uint32_t as = wg::stage_a(s, ring.stage), bs = wg::stage_b(s, ring.stage);
#pragma unroll
          for (int c = 0; c < wg::kBM / wg::kBox128; ++c)
            wg::tma_load(as + c * W_ABOX, &ctx_map, full, dt * wg::kBM + c * wg::kBox128, r0, 0);
#pragma unroll
          for (int j = 0; j < W_BN / wg::kBox; ++j) {
            const int n = nt * W_BN + j * wg::kBox;
            wg::tma_load(bs + j * W_BBOX, &zds_map, full, n % tpad, n / tpad, r0);
          }
          ring.advance();
        }
      }
    }
  } else {
    wg::reg_alloc<wg::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31, q = lane & 3;
    wg::Ring ring;
    float acc[W_BN / 2];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int dt = tile % n_dt, nt = (tile / n_dt) % n_nt, sl = tile / (n_dt * n_nt);
      int k0, k1;
      slice_steps(sl, slices, nk, k0, k1);
      wg::consume<W_BN, 1, 1>(
          acc, s, ring, k1 - k0,
          [&](int st, int ks) { return wg::desc_mn128(wg::stage_a(s, st) + cw * W_ABOX, ks); },
          [&](int st, int ks) { return wg::desc_mn64(wg::stage_b(s, st), ks); });
      // the f32 partial tile straight from the registers into part[sl]
      // [B_txt, D, TPAD]: a quad writes 32 bytes of one caption's row d
      float* out = part + (size_t)sl * Bt * D * tpad;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = dt * wg::kBM + cw * 64 + warp * 16 + (lane >> 2) + 8 * h;
        if (d >= D) continue;
#pragma unroll
        for (int j = 0; j < W_BN / 8; ++j) {
          const int n = nt * W_BN + 8 * j + 2 * q, i = n / tpad;
          if (i < Bt)
            *reinterpret_cast<float2*>(out + ((size_t)i * D + d) * tpad + n % tpad) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4b's sum: wsum [B_txt, D, TPAD] plus the chunk's slices in order, stored
// back, or (last chunk) plus (Σ c2)·w to d_words [B_txt, D, T]; grid (D·TPAD
// / 4 / THREADS, B_txt), four words of caption blockIdx.y a thread
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
dwords_sum_kernel(GloriaArgs a, const float* __restrict__ part, int slices,
                  float* __restrict__ wsum, const float* __restrict__ c2sum,
                  float* __restrict__ dw, int last) {
  const int D = a.D, T = a.T, tpad = a.TPAD, i = blockIdx.y, per = D * tpad / 4;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= per) return;
  const size_t n4 = (size_t)a.Bt * per, v = (size_t)i * per + e;
  float4 x = reinterpret_cast<const float4*>(wsum)[v];
  for (int sl = 0; sl < slices; ++sl) {
    const float4 p = reinterpret_cast<const float4*>(part)[sl * n4 + v];
    x = make_float4(x.x + p.x, x.y + p.y, x.z + p.z, x.w + p.w);
  }
  if (!last) {
    reinterpret_cast<float4*>(wsum)[v] = x;
    return;
  }
  const int d = 4 * e / tpad, t = 4 * e % tpad;
  const float xs[4] = {x.x, x.y, x.z, x.w};
  const bf16* w = a.words + 4 * v;
  float* out = dw + ((size_t)i * D + d) * T + t;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (t + j < T) out[j] = xs[j] + c2sum[(size_t)i * tpad + t + j] * __bfloat162float(w[j]);
}

// pass 1 over the chunks of images in order, then K4a's pass 2 (dctx) and
// K4b's product and sum (dw) for the chunk, each when asked for
template <int NT>
static int launch_cotangents(const GloriaArgs& a, const bf16* dwei, const float* vecs, bf16* z,
                             int chunk, float* dctx, float* part, int slices, float* wsum,
                             const float* c2sum, float* dw, cudaStream_t st) {
  using Z = ZTile<NT>;
  // tensor maps (they hold the pointers, so they are built per call):
  // ctx [B_img][M][D]; words [B_txt][D][TPAD] and bf16(d_wei) [pairs][D][TPAD]
  // as pass 1's [64 d][32 words] boxes and pass 2's [256 d][32 words]; Z
  // [chunk][M][B_txt·2·TPAD]
  const uint64_t D = a.D, M = a.M, tp = a.TPAD, K = (uint64_t)a.Bt * 2 * a.TPAD;
  const uint64_t pairs = (uint64_t)a.Bi * a.Bt;
  CUtensorMap ctx_map, wz_map, dz_map, z_map, wg_map, dg_map;
  const auto sw128 = CU_TENSOR_MAP_SWIZZLE_128B, sw64 = CU_TENSOR_MAP_SWIZZLE_64B;
  const bool ok =
      tensor_map(&ctx_map, a.ctx, D, M, a.Bi, D * 2, M * D * 2, wg::kBK, wg::kBM, sw128) &&
      tensor_map(&wz_map, a.words, tp, D, a.Bt, tp * 2, D * tp * 2, wg::kBox, wg::kBK, sw64) &&
      tensor_map(&dz_map, dwei, tp, D, pairs, tp * 2, D * tp * 2, wg::kBox, wg::kBK, sw64) &&
      tensor_map(&wg_map, a.words, tp, D, a.Bt, tp * 2, D * tp * 2, wg::kBox, G_BN, sw64) &&
      tensor_map(&dg_map, dwei, tp, D, pairs, tp * 2, D * tp * 2, wg::kBox, G_BN, sw64) &&
      tensor_map(&z_map, z, K, M, chunk, K * 2, M * K * 2, wg::kBK, wg::kBM, sw128);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(dctx_z_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         wg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dctx_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dwords_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  const int z_tiles = (a.M + wg::kBM - 1) / wg::kBM * ((a.Bt + Z::CPT - 1) / Z::CPT);
  const int g_tiles = (a.M + wg::kBM - 1) / wg::kBM * ((a.D + G_BN - 1) / G_BN);
  const int w_tiles = slices * ((a.D + wg::kBM - 1) / wg::kBM) *
                      ((a.Bt * a.TPAD + W_BN - 1) / W_BN);
  const dim3 sum_grid((a.D * a.TPAD / 4 + THREADS - 1) / THREADS, a.Bt);
  for (int b0 = 0; b0 < a.Bi; b0 += chunk) {
    const int nb = a.Bi - b0 < chunk ? a.Bi - b0 : chunk;
    const int zg = z_tiles * nb < sms ? z_tiles * nb : sms;
    dctx_z_kernel<NT><<<zg, wg::kThreads, wg::kSmemBytes, st>>>(ctx_map, wz_map, dz_map, a, vecs,
                                                                z, b0, nb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (dctx != nullptr) {
      const int gg = g_tiles * nb < sms ? g_tiles * nb : sms;
      dctx_gemm_kernel<<<gg, wg::kThreads, wg::kSmemBytes, st>>>(z_map, wg_map, dg_map, a, dctx,
                                                                 b0, nb);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (dw != nullptr) {
      // the chunk's rows (image, m) as one K: ctx [rows][D] as [64 rows][64
      // d] boxes, and Zds, Z's d_scores halves from z + TPAD, [rows][B_txt]
      // [TPAD] as [64 rows][1][32 words] boxes; both read zeros past the
      // chunk's rows, so M needs no whole 64-row steps
      const uint64_t rows = (uint64_t)nb * M;
      CUtensorMap wctx_map, zds_map;
      if (!tensor_map(&wctx_map, a.ctx + (size_t)b0 * M * D, D, rows, 1, D * 2, rows * D * 2,
                      wg::kBox128, wg::kBK, sw128) ||
          !tensor_map(&zds_map, z + tp, tp, a.Bt, rows, 2 * tp * 2, K * 2, wg::kBox, 1, sw64,
                      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, wg::kBK))
        return (int)cudaErrorInvalidValue;
      dwords_gemm_kernel<<<w_tiles < sms ? w_tiles : sms, wg::kThreads, wg::kSmemBytes, st>>>(
          wctx_map, zds_map, a, (int)rows, slices, part);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      dwords_sum_kernel<<<sum_grid, THREADS, 0, st>>>(a, part, slices, wsum, c2sum, dw,
                                                      b0 + nb == a.Bi);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

extern "C" {

// K4a and K4b from the prologue's scratch, through z [chunk, M, Bt·2·TPAD]
// bf16 (scratch), chunk images at a time: d_ctx [Bi, M, D] f32 when dctx
// is given; d_words [Bt, D, T] f32 when dw is given, through part
// [slices, Bt, D, TPAD] f32 (scratch: the product's partial sums, each
// chunk's K cut into `slices` slices), with wsum [Bt, D, TPAD] and c2sum
// [Bt, TPAD] as the prologue left them (wsum is summed into). Returns a
// cudaError_t: 0 when the launches were accepted.
int medmoe_gloria_cotangents(const void* ctx, const void* words, const void* cap, int Bi, int Bt,
                             int M, int D, int T, float temp1, const void* dwei, const void* vecs,
                             void* z, int chunk, void* dctx, void* part, int slices, void* wsum,
                             const void* c2sum, void* dw, void* stream) {
  if (!shapes_ok(Bi, Bt, M, D, T) || chunk < 1 || chunk > 65535 ||
      (dctx == nullptr && dw == nullptr) ||
      (dw != nullptr && (part == nullptr || slices < 1 || slices > 64 || wsum == nullptr ||
                         c2sum == nullptr)))
    return (int)cudaErrorInvalidValue;
  const GloriaArgs a = make_args(ctx, words, cap, Bi, Bt, M, D, T, temp1, 0.0f, 0.0f);
  const bf16* dq = static_cast<const bf16*>(dwei);
  const float* vv = static_cast<const float*>(vecs);
  bf16* zz = static_cast<bf16*>(z);
  float* dc = static_cast<float*>(dctx);
  float* pp = static_cast<float*>(part);
  float* ws = static_cast<float*>(wsum);
  const float* c2 = static_cast<const float*>(c2sum);
  float* out = static_cast<float*>(dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.NT) {
    case 1: return launch_cotangents<1>(a, dq, vv, zz, chunk, dc, pp, slices, ws, c2, out, st);
    case 2: return launch_cotangents<2>(a, dq, vv, zz, chunk, dc, pp, slices, ws, c2, out, st);
    case 3: return launch_cotangents<3>(a, dq, vv, zz, chunk, dc, pp, slices, ws, c2, out, st);
    default: return launch_cotangents<4>(a, dq, vv, zz, chunk, dc, pp, slices, ws, c2, out, st);
  }
}

const char* medmoe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
