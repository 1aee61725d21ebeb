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
// tensor cores as two bf16 parts. E, the bf16 hi and lo of e, is written
// once and read once a D tile of F2 (26.3 GB each way at B=256, ≈8 ms of
// memory against ≈31 ms of products), so the passes stay bound by the
// tensor cores, and the design is about feeding them.
//
// Design: three kernels for each chunk of images, the pair loop moved into
// the products' N and K. F1 and F2 run on the wgmma core of
// csrc/wgmma_core.cuh: TMA loads through tensor maps built per call, a
// 4-stage ring of 64-deep slices, one producer warp and two consumer
// warpgroups (setmaxnreg), one persistent block an SM, the accumulators in
// registers from the products through the epilogue.
//   F1 (sim_e_kernel): S_b = ctx_b [M, D] · W [D, B_txt·TPAD] on 128 × 256
//     tiles (128 × 192 at TPAD 96) that hold whole captions: 8 at TPAD 32,
//     4 at 64, 2 at 96 or 128. A is ctx, K-contiguous (128-byte swizzle);
//     B the words, N-contiguous, in [64 d][32 word] boxes (64-byte swizzle,
//     wgmma's transposed B). A row's words lie in the four threads of a
//     quad, so the row step runs on the accumulators: the masked word
//     softmax (two quad shuffles for the maximum and for Σ_t), then e =
//     exp(temp1·a1 - e_off) (0 past T and past M), written from the
//     registers as E_b = [bf16 hi ; bf16 lo] of e, [2, M, B_txt·TPAD]: a
//     quad transposes its bf16 pairs (four shuffles for 4 × 4), so a lane
//     stores 16 bytes and a quad 64 contiguous bytes of a row, a quarter of
//     the store instructions of pair stores; the stores stream past L2
//     (evict-first: E, 1.6 GB a chunk at B=256, is read again only by F2,
//     and would push ctx and the words out of L2). Σ_m e of each word over
//     the tile's 128 rows goes to esum: the thread's two rows, a butterfly
//     over the eight row-lanes of a warp (each lane keeps an eighth of the
//     columns), then the eight warps in order through shared memory.
//   F2 (sim_wei_kernel): weiᵀ_b [B_txt·TPAD, D] = [E_hi | E_lo]ᵀ ·
//     [ctx_b ; ctx_b], K = 2·M in order (hi, then lo), on 128-word × 256-d
//     tiles. A is E, M-contiguous ([64 m][64 word] boxes, wgmma's
//     transposed A); B is ctx, N-contiguous ([64 m][64 d] boxes); both
//     128-byte swizzled, six boxes a stage (with twelve 32-wide boxes,
//     64-byte swizzled, the pass took 43.4 ms at B=256 against 31.5 on an
//     NVIDIA H100 80GB HBM3 at 700 W). Its epilogue sums Σ_m
//     e over F1's M tiles in order, scales each row by its reciprocal (0 for
//     the padded words t >= T), and writes per-(256-wide D tile, word)
//     partial sums of w·wei, wei² and w² (a thread's 64 columns, then the
//     quad; w read two columns a load from the words transposed, [B_txt,
//     TPAD, D], which the wrapper makes), and in the prologue, or in K3
//     when it keeps its state, wei itself, f32. Words as the rows keep
//     each word's Σ_m e and its partial sums in one thread's registers;
//     the other orientation (ctxᵀ·E) would spread them over the columns.
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
// The 3-D tensor maps read zeros past M, past D and past the last caption,
// so no tile needs a masked load (D = 48: one 64-deep slice of F1, the
// columns of F2's D tile past 48 zero). The masks of the row step select
// without predicates (`keep`), so the accumulators stay in registers.
// No atomics: every sum over M, D or words runs in a fixed order, and two
// runs give the same bits. The wrapper allocates the scratch (E, the
// partial sums, and the prologue's wei [chunk, B_txt, D, TPAD] f32) for a
// chunk of images and sizes the chunk.
//
// Kept state. When a gradient will be taken, K3 keeps what F3 reads for the
// backward: F2's f32 wei [B_img, B_txt, D, TPAD], F1's Σ_m e [B_img,
// ⌈M/128⌉, B_txt·TPAD] and F2's partial sums [B_img, ⌈D/256⌉, 3,
// B_txt·TPAD], each written at the image's place in the whole batch (E stays
// a chunk's scratch). F2 stores wei (kStoreWei) while F3 still finishes as
// the forward, so sim is the same bits with the store on or off. The
// prologue then runs F3 as the backward (kBwd) once over every pair, and
// K4b's f32 terms, from that state: no F1, no F2, no E. The same kernels on
// the same inputs wrote it, so d_wei and the per-word vectors are the bits
// that recomputing gives. At 256², D = 768, M = 3136 and TPAD = 32 the
// state is 6.73 GB (wei 6.44, Σ_m e 0.21, partials 0.08); a rank's
// 128 × 256 block half that. The wrapper (ops/gloria_attention.py) keeps
// it only when it takes at most a quarter of the card's memory, and
// otherwise recomputes as before; it frees the state once the prologue's
// launches are queued, before K4a allocates Z.
//
// Shapes the kernels take (the wrapper checks them): T <= 128, D % 16 == 0,
// D <= 768, |temp1| <= 80.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (medmoe_torch/ops/_build.py).

#include "gloria_common.cuh"
#include "wgmma_core.cuh"

constexpr int MTILE = 128;  // F1's rows of a tile: the M tiles of Σ_m e
constexpr int DTILE = 256;  // F2's columns of a tile: the D tiles of the partials
constexpr int BOX = wg::kBK * wg::kBox * 2;        // a [64][32] bf16 box, 4 KB
constexpr int BOX128 = wg::kBK * wg::kBox128 * 2;  // a [64][64] bf16 box, 8 KB

// The passes' scratch for one chunk of images (N = B_txt·TPAD words); in
// the kept state esum, part and wei start at the chunk's first image of
// the whole batch's (at_image)
struct PassArgs {
  bf16* e;       // [chunk, 2, M, N]: bf16 hi, then lo, of e
  float* esum;   // [chunk, n_mt, N]: Σ_m e over each 128-row M tile
  float* part;   // [chunk, n_dt, 3, N]: Σ_d w·wei, wei², w² over each D tile
  float* wei;    // [chunk, B_txt, D, TPAD] f32 (the prologue, or K3 keeping)
  const bf16* wt;  // the words transposed, [B_txt, TPAD, D]: F2's rows
  int N, n_mt, n_dt;
};

// A 4 × 4 transpose over the lanes of a quad (q = lane % 4): lane q's r_j
// becomes lane j's r_q, in two exchanges (lanes 1 apart, then 2 apart)
__device__ __forceinline__ void quad_transpose(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                               uint32_t& r3, int q) {
  const bool q1 = q & 1, q2 = q & 2;
  uint32_t got = __shfl_xor_sync(0xffffffffu, q1 ? r0 : r1, 1);
  r0 = q1 ? got : r0;
  r1 = q1 ? r1 : got;
  got = __shfl_xor_sync(0xffffffffu, q1 ? r2 : r3, 1);
  r2 = q1 ? got : r2;
  r3 = q1 ? r3 : got;
  got = __shfl_xor_sync(0xffffffffu, q2 ? r0 : r2, 2);
  r0 = q2 ? got : r0;
  r2 = q2 ? r2 : got;
  got = __shfl_xor_sync(0xffffffffu, q2 ? r1 : r3, 2);
  r1 = q2 ? got : r1;
  r3 = q2 ? r3 : got;
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x: ex2.approx, the instruction behind __expf
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes to global memory, streamed past L2 (st.global.cs, evict-first);
// no memory clobber: nothing in the kernel reads what it stores
__device__ __forceinline__ void store_cs(bf16* p, const uint32_t (&v)[4]) {
  asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v[0]), "r"(v[1]),
               "r"(v[2]), "r"(v[3]));
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// ---------------------------------------------------------------------------
// F1: E and Σ_m e; persistent over the tiles (images of the chunk, caption
// tiles, M tiles)
// ---------------------------------------------------------------------------
template <int NT>
struct ETile {
  static constexpr int TPAD = TP * NT;
  static constexpr int BN = NT == 3 ? 192 : 256;  // whole captions
  static constexpr int CPT = BN / TPAD;            // captions of a tile
  static constexpr int JT = TPAD / 8;              // 8-column blocks of a caption
  static constexpr int V = BN / 4;                 // a thread's column sums
  static constexpr int TX = wg::kABytes + BN * wg::kBK * 2;  // bytes of a stage
  static_assert(CPT * TPAD == BN && BN * wg::kBK * 2 <= wg::kBBytes, "whole captions a tile");
};
// F1's shared memory: the core's, and [2][8 warps][256] f32 of Σ_m e
constexpr int F1_SMEM = wg::kSmemBytes + 2 * 8 * 256 * 4;

template <int NT>
__global__ void __launch_bounds__(wg::kThreads, 1)
sim_e_kernel(const __grid_constant__ CUtensorMap ctx_map,
             const __grid_constant__ CUtensorMap words_map, GloriaArgs a, PassArgs p, int b0,
             int nb) {
  using G = ETile<NT>;
  constexpr int TPAD = G::TPAD, BN = G::BN, CPT = G::CPT, JT = G::JT, V = G::V;
  extern __shared__ unsigned char smem_raw[];
  const wg::Smem s = wg::carve(smem_raw);
  const int M = a.M, Bt = a.Bt, T = a.T, N = p.N;
  const int n_mt = p.n_mt, n_ct = (Bt + CPT - 1) / CPT;
  const int tiles = nb * n_ct * n_mt, nk = (a.D + wg::kBK - 1) / wg::kBK;
  wg::init_barriers(s);

  if (threadIdx.x < 128) {
    // producer: one thread loads A = ctx_b rows m0.. (zeros past M and D)
    // and B = the tile's captions' words, [64 d][32 word] boxes side by
    // side in the tile's column order (zeros past the last caption)
    wg::reg_dealloc<wg::kProducerRegs>();
    if (threadIdx.x == 0) {
      wg::prefetch_map(&ctx_map);
      wg::prefetch_map(&words_map);
      wg::Ring ring;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int mt = tile % n_mt, ct = (tile / n_mt) % n_ct, b = b0 + tile / (n_mt * n_ct);
        for (int kb = 0; kb < nk; ++kb) {
          uint64_t* full = &s.full[ring.stage];
          wg::mbar_wait(&s.empty[ring.stage], ring.phase ^ 1u);
          wg::mbar_expect_tx(full, G::TX);
          const int d0 = kb * wg::kBK;
          wg::tma_load(wg::stage_a(s, ring.stage), &ctx_map, full, d0, mt * MTILE, b);
          const uint32_t bs = wg::stage_b(s, ring.stage);
#pragma unroll
          for (int c = 0; c < CPT; ++c)
#pragma unroll
            for (int h = 0; h < NT; ++h)
              wg::tma_load(bs + (c * NT + h) * BOX, &words_map, full, h * wg::kBox, d0,
                           ct * CPT + c);
          ring.advance();
        }
      }
    }
  } else {
    wg::reg_alloc<wg::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1, ci = threadIdx.x - 128;  // warpgroup, consumer thread
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31, q = lane & 3;
    float* red = s.vecs + 2 * wg::kVecFloats;  // [2][8 warps][BN]
    // this thread's words t = 8jj + 2q + e of a caption (bit 2jj + e): t < T
    uint32_t words_t = 0;
#pragma unroll
    for (int k = 0; k < 2 * JT; ++k) words_t |= (uint32_t)(8 * (k >> 1) + 2 * q + (k & 1) < T) << k;
    wg::Ring ring;
    float acc[BN / 2];
    int parity = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, parity ^= 1) {
      const int mt = tile % n_mt, ct = (tile / n_mt) % n_ct, bl = tile / (n_mt * n_ct);
      const int i0 = ct * CPT;
      int caps[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) caps[c] = i0 + c < Bt ? a.cap[i0 + c] : 1;

      wg::consume<BN, 0, 1>(
          acc, s, ring, nk,
          [&](int st, int ks) { return wg::desc_k128(wg::stage_a(s, st) + cw * 8192, ks); },
          [&](int st, int ks) { return wg::desc_mn64(wg::stage_b(s, st), ks); });

      // the row step, a caption and a row (h) at a time: this thread holds
      // words t = 8jj + 2q + e of rows 16·warp + lane/4 + 8h. Its
      // exponentials are ex2.approx of an FFMA with log2(e) folded into the
      // constants, a few f32 ulp off, as __expf (Σ_t of a row is >= 1).
      bf16* ehi = p.e + (size_t)bl * 2 * M * N;
      bf16* elo = ehi + (size_t)M * N;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int i = i0 + c;
        uint32_t words_c = 0;  // t < cap
#pragma unroll
        for (int k = 0; k < 2 * JT; ++k)
          words_c |= (uint32_t)(8 * (k >> 1) + 2 * q + (k & 1) < caps[c]) << k;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * MTILE + cw * 64 + warp * 16 + (lane >> 2) + 8 * h;
          const bool store = m < M && i < Bt;
          const uint32_t live = m < M ? words_t : 0u;  // rows past M: e = 0
          // a1: softmax over the words t < cap (masked at NEG_INF, as the
          // JAX package), the padded words t >= T left out
          float mx = -INFINITY;
#pragma unroll
          for (int k = 0; k < 2 * JT; ++k) {
            float& x = acc[4 * (c * JT + (k >> 1)) + 2 * h + (k & 1)];
            x = (words_t >> k & 1) ? ((words_c >> k & 1) ? x : NEG_INF_F) : -INFINITY;
            mx = fmaxf(mx, x);
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mxl = mx * kLog2e;
          float zs = 0.0f;
#pragma unroll
          for (int k = 0; k < 2 * JT; ++k) {
            float& x = acc[4 * (c * JT + (k >> 1)) + 2 * h + (k & 1)];
            x = ex2(fmaf(x, kLog2e, -mxl));
            zs += x;
          }
          zs += __shfl_xor_sync(0xffffffffu, zs, 1);
          zs += __shfl_xor_sync(0xffffffffu, zs, 2);
          // e = exp(temp1·a1 - e_off) = 2^(x·temp1·log2(e)/Σ_t - e_off·log2(e)),
          // kept in the accumulators for Σ_m e; its bf16 hi and lo to E in
          // 16-byte stores, streamed past L2 (E is read again only by F2,
          // after the whole chunk): a quad transposes each four 8-column
          // blocks, so lane q writes block 4·kb + q, and a quad 64
          // contiguous bytes of the row
          const float c1 = a.temp1 * kLog2e * __fdividef(1.0f, zs), c0 = a.e_off * kLog2e;
          const size_t row = (size_t)m * N + (size_t)i * TPAD;
#pragma unroll
          for (int kb = 0; kb < JT / 4; ++kb) {
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int jj = 4 * kb + u;
              float& x0 = acc[4 * (c * JT + jj) + 2 * h];
              float& x1 = acc[4 * (c * JT + jj) + 2 * h + 1];
              x0 = keep(ex2(fmaf(x0, c1, -c0)), live, 2 * jj);
              x1 = keep(ex2(fmaf(x1, c1, -c0)), live, 2 * jj + 1);
              const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
              const float2 back = __bfloat1622float2(h2);
              hi[u] = bf162_bits(h2);
              lo[u] = bf162_bits(__floats2bfloat162_rn(x0 - back.x, x1 - back.y));
            }
            quad_transpose(hi[0], hi[1], hi[2], hi[3], q);
            quad_transpose(lo[0], lo[1], lo[2], lo[3], q);
            if (store) {
              const size_t at = row + 8 * (4 * kb + q);
              store_cs(ehi + at, hi);
              store_cs(elo + at, lo);
            }
          }
        }
      }

      // Σ_m e: the thread's two rows, then a butterfly over the warp's
      // eight row-lanes (lane bits 4, 3, 2), which leaves lane a V/8 of the
      // columns: v = V/2·b4 + V/4·b3 + V/8·b2 + i, column 4v' + 2q + e for
      // v = v' + e, v' even
      float v[V];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        v[2 * j] = acc[4 * j] + acc[4 * j + 2];
        v[2 * j + 1] = acc[4 * j + 1] + acc[4 * j + 3];
      }
      wg::fold<V / 2>(v, lane, 16);
      wg::fold<V / 4>(v, lane, 8);
      wg::fold<V / 8>(v, lane, 4);
      const int base = (lane & 16 ? V / 2 : 0) + (lane & 8 ? V / 4 : 0) + (lane & 4 ? V / 8 : 0);
      float* rw = red + (parity * 8 + cw * 4 + warp) * BN;
#pragma unroll
      for (int k = 0; k < V / 8; k += 2)
        *reinterpret_cast<float2*>(rw + 4 * (base + k) + 2 * q) = make_float2(v[k], v[k + 1]);
      wg::consumer_sync();
      // the eight warps' sums in order: a thread a column
      if (ci < BN && i0 + ci / TPAD < Bt) {
        const float* rc = red + parity * 8 * BN + ci;
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < 8; ++w) sum += rc[w * BN];
        p.esum[((size_t)bl * n_mt + mt) * N + (size_t)i0 * TPAD + ci] = sum;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// F2: weiᵀ_b = [E_hi | E_lo]ᵀ · [ctx_b ; ctx_b]; persistent over the tiles
// (images of the chunk, 128-word tiles, 256-wide D tiles)
// ---------------------------------------------------------------------------
constexpr int F2_TX = wg::kABytes + DTILE * wg::kBK * 2;  // 2 boxes of E, 4 of ctx

// kStoreWei: the epilogue also stores f32 wei (the prologue, or K3 keeping
// its state)
template <bool kStoreWei>
__global__ void __launch_bounds__(wg::kThreads, 1)
sim_wei_kernel(const __grid_constant__ CUtensorMap e_map,
               const __grid_constant__ CUtensorMap ctx_map, GloriaArgs a, PassArgs p, int b0,
               int nb) {
  extern __shared__ unsigned char smem_raw[];
  const wg::Smem s = wg::carve(smem_raw);
  const int M = a.M, D = a.D, Bt = a.Bt, T = a.T, TPAD = a.TPAD, N = p.N;
  const int n_dt = p.n_dt, n_wt = (N + wg::kBM - 1) / wg::kBM;
  const int tiles = nb * n_wt * n_dt, nkh = (M + wg::kBK - 1) / wg::kBK;
  wg::init_barriers(s);

  if (threadIdx.x < 128) {
    // producer: A = E rows m0.. of the hi half (the first nkh slices), then
    // of the lo half, words n0.. in [64 m][64 word] boxes; B = ctx_b rows
    // m0.., columns d0.. in [64 m][64 d] boxes (zeros past M and D)
    wg::reg_dealloc<wg::kProducerRegs>();
    if (threadIdx.x == 0) {
      wg::prefetch_map(&e_map);
      wg::prefetch_map(&ctx_map);
      wg::Ring ring;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int dt = tile % n_dt, wt = (tile / n_dt) % n_wt, bl = tile / (n_dt * n_wt);
        for (int kb = 0; kb < 2 * nkh; ++kb) {
          uint64_t* full = &s.full[ring.stage];
          wg::mbar_wait(&s.empty[ring.stage], ring.phase ^ 1u);
          wg::mbar_expect_tx(full, F2_TX);
          const int half = kb >= nkh, m0 = (kb - half * nkh) * wg::kBK;
          const uint32_t as = wg::stage_a(s, ring.stage), bs = wg::stage_b(s, ring.stage);
#pragma unroll
          for (int c = 0; c < wg::kBM / wg::kBox128; ++c)
            wg::tma_load(as + c * BOX128, &e_map, full, wt * wg::kBM + c * wg::kBox128, m0,
                         2 * bl + half);
#pragma unroll
          for (int c = 0; c < DTILE / wg::kBox128; ++c)
            wg::tma_load(bs + c * BOX128, &ctx_map, full, dt * DTILE + c * wg::kBox128, m0,
                         b0 + bl);
          ring.advance();
        }
      }
    }
  } else {
    wg::reg_alloc<wg::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31, q = lane & 3;
    wg::Ring ring;
    float acc[DTILE / 2];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int dt = tile % n_dt, wt = (tile / n_dt) % n_wt, bl = tile / (n_dt * n_wt);
      // this thread's two words (rows h = 0, 1) and their Σ_m e, the M
      // tiles in order, loaded while the ring fills
      int n[2];
      float rdiv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        n[h] = wt * wg::kBM + cw * 64 + warp * 16 + (lane >> 2) + 8 * h;
        float sum = 0.0f;
        if (n[h] < N) {
          const float* es = p.esum + (size_t)bl * p.n_mt * N + n[h];
#pragma unroll 5
          for (int mt = 0; mt < p.n_mt; ++mt) sum += es[(size_t)mt * N];
        }
        // wei = Σ_m e·ctx / Σ_m e, 0 for the padded words t >= T
        rdiv[h] = n[h] < N && n[h] % TPAD < T ? 1.0f / sum : 0.0f;
      }

      wg::consume<DTILE, 1, 1>(
          acc, s, ring, 2 * nkh,
          [&](int st, int ks) { return wg::desc_mn128(wg::stage_a(s, st) + cw * BOX128, ks); },
          [&](int st, int ks) { return wg::desc_mn128(wg::stage_b(s, st), ks); });

      // per word: Σ_d w·wei, wei², w² over the tile's columns (this
      // thread's 64 in order, then the quad), and f32 wei when it is kept;
      // the word's w from the transposed words, two columns a load
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool row = n[h] < N;
        const int i = n[h] / TPAD, t = n[h] % TPAD;
        const bf16* w = p.wt + (size_t)n[h] * D + dt * DTILE + 2 * q;
        float* out = kStoreWei ? p.wei + ((size_t)bl * Bt + i) * D * TPAD + t : nullptr;
        float num = 0.0f, wei2 = 0.0f, w2 = 0.0f;
#pragma unroll
        for (int j = 0; j < DTILE / 8; ++j) {
          const int d = dt * DTILE + 8 * j + 2 * q;
          const bool in = row && d < D;  // D % 16 == 0: both columns or neither
          const float2 wv = in ? __bfloat1622float2(
                                     *reinterpret_cast<const __nv_bfloat162*>(w + 8 * j))
                               : make_float2(0.0f, 0.0f);
          const float x0 = acc[4 * j + 2 * h] * rdiv[h], x1 = acc[4 * j + 2 * h + 1] * rdiv[h];
          num += wv.x * x0;
          wei2 += x0 * x0;
          w2 += wv.x * wv.x;
          num += wv.y * x1;
          wei2 += x1 * x1;
          w2 += wv.y * wv.y;
          if (kStoreWei && in) {
            out[(size_t)d * TPAD] = x0;
            out[(size_t)(d + 1) * TPAD] = x1;
          }
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          num += __shfl_xor_sync(0xffffffffu, num, o);
          wei2 += __shfl_xor_sync(0xffffffffu, wei2, o);
          w2 += __shfl_xor_sync(0xffffffffu, w2, o);
        }
        if (row && q == 0) {
          float* o = p.part + ((size_t)bl * n_dt + dt) * 3 * N + n[h];
          o[0] = num;
          o[N] = wei2;
          o[2 * (size_t)N] = w2;
        }
      }
    }
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
static PassArgs pass_args(const GloriaArgs& a, const void* wt, void* e, void* esum, void* part,
                          void* wei) {
  PassArgs p;
  p.wt = static_cast<const bf16*>(wt);
  p.e = static_cast<bf16*>(e);
  p.esum = static_cast<float*>(esum);
  p.part = static_cast<float*>(part);
  p.wei = static_cast<float*>(wei);
  p.N = a.Bt * a.TPAD;
  p.n_mt = (a.M + MTILE - 1) / MTILE;
  p.n_dt = (a.D + DTILE - 1) / DTILE;
  return p;
}

template <int NT>
static cudaError_t launch_e(const CUtensorMap& ctx_map, const CUtensorMap& words_map,
                            const GloriaArgs& a, const PassArgs& p, int b0, int nb, int sms,
                            cudaStream_t st) {
  using G = ETile<NT>;
  cudaError_t err =
      cudaFuncSetAttribute(sim_e_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, F1_SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = nb * ((a.Bt + G::CPT - 1) / G::CPT) * p.n_mt;
  sim_e_kernel<NT><<<tiles < sms ? tiles : sms, wg::kThreads, F1_SMEM, st>>>(ctx_map, words_map,
                                                                            a, p, b0, nb);
  return cudaGetLastError();
}

// The kept state seen from the chunk that starts at image b0: the whole
// batch's esum, part and wei at that image's place
static PassArgs at_image(const GloriaArgs& a, PassArgs p, int b0) {
  p.esum += (size_t)b0 * p.n_mt * p.N;
  p.part += (size_t)b0 * p.n_dt * 3 * p.N;
  p.wei += (size_t)b0 * p.N * a.D;
  return p;
}

// F3 over the pairs of images b0 .. b0 + nb - 1 (p: their scratch, image
// b0 first), and K4b's f32 terms when wsum is given
template <bool kBwd>
static cudaError_t finish(const GloriaArgs& a, const PassArgs& p, int b0, int nb, float* sim,
                          const float* g, bf16* dwei, float* vecs, float* wsum, float* c2sum,
                          cudaStream_t st) {
  const int pairs = nb * a.Bt;
  sim_finish_kernel<kBwd><<<(pairs + NWARPS - 1) / NWARPS, THREADS, 0, st>>>(a, p, b0, nb, sim, g,
                                                                           dwei, vecs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || wsum == nullptr) return err;
  const long long n = (long long)a.Bt * a.D * a.TPAD;
  dwords_wei_kernel<<<(int)((n + THREADS - 1) / THREADS), THREADS, 0, st>>>(a, p, b0, nb, vecs,
                                                                           wsum, c2sum);
  return cudaGetLastError();
}

// F1, F2 and F3 over the chunks of images in order (and K4b's f32 terms
// when wsum is given). kStoreWei: F2 stores f32 wei; kBwd: F3 finishes as
// the prologue. K3 storing wei keeps its state: esum, part and wei hold the
// whole batch, E one chunk.
template <bool kStoreWei, bool kBwd>
static int run_passes(const GloriaArgs& a, const PassArgs& p, int chunk, float* sim,
                      const float* g, bf16* dwei, float* vecs, float* wsum, float* c2sum,
                      void* stream) {
  constexpr bool kKept = kStoreWei && !kBwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // tensor maps (they hold the pointers, so they are built per call): ctx
  // [B_img][M][D] as F1's A ([128 m][64 d], 128-byte swizzle) and as F2's B
  // ([64 m][64 d], 128-byte swizzle); words [B_txt][D][TPAD] as F1's B
  // ([64 d][32 words], 64-byte swizzle); E [chunk·2][M][N] as F2's A ([64
  // m][64 words], 128-byte swizzle)
  const uint64_t D = a.D, M = a.M, tp = a.TPAD, N = p.N;
  CUtensorMap ctx_map, words_map, e_map, ctx_b_map;
  const auto sw128 = CU_TENSOR_MAP_SWIZZLE_128B, sw64 = CU_TENSOR_MAP_SWIZZLE_64B;
  const bool ok =
      tensor_map(&ctx_map, a.ctx, D, M, a.Bi, D * 2, M * D * 2, wg::kBK, MTILE, sw128) &&
      tensor_map(&words_map, a.words, tp, D, a.Bt, tp * 2, D * tp * 2, wg::kBox, wg::kBK, sw64) &&
      tensor_map(&e_map, p.e, N, M, 2 * (uint64_t)chunk, N * 2, M * N * 2, wg::kBox128,
                 wg::kBK, sw128) &&
      tensor_map(&ctx_b_map, a.ctx, D, M, a.Bi, D * 2, M * D * 2, wg::kBox128, wg::kBK, sw128);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sim_wei_kernel<kStoreWei>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         wg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  const int w_tiles = (p.N + wg::kBM - 1) / wg::kBM * p.n_dt;
  for (int b0 = 0; b0 < a.Bi; b0 += chunk) {
    const int nb = a.Bi - b0 < chunk ? a.Bi - b0 : chunk;
    const PassArgs pc = kKept ? at_image(a, p, b0) : p;
    switch (a.NT) {
      case 1: err = launch_e<1>(ctx_map, words_map, a, pc, b0, nb, sms, st); break;
      case 2: err = launch_e<2>(ctx_map, words_map, a, pc, b0, nb, sms, st); break;
      case 3: err = launch_e<3>(ctx_map, words_map, a, pc, b0, nb, sms, st); break;
      default: err = launch_e<4>(ctx_map, words_map, a, pc, b0, nb, sms, st); break;
    }
    if (err != cudaSuccess) return (int)err;
    const int wg_grid = w_tiles * nb < sms ? w_tiles * nb : sms;
    sim_wei_kernel<kStoreWei><<<wg_grid, wg::kThreads, wg::kSmemBytes, st>>>(e_map, ctx_b_map, a,
                                                                              pc, b0, nb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = finish<kBwd>(a, pc, b0, nb, sim, g, dwei, vecs, wsum, c2sum, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" {

// K3: out [Bi, Bt] f32, from the words and the words transposed (wt [Bt,
// TPAD, D] bf16), through the scratch of one chunk of images: e [chunk, 2,
// M, Bt·TPAD] bf16, esum [chunk, ⌈M/128⌉, Bt·TPAD] f32 and part [chunk,
// ⌈D/256⌉, 3, Bt·TPAD] f32. With wei [Bi, Bt, D, TPAD] f32 (not null), K3
// keeps its state for the prologue: esum [Bi, ⌈M/128⌉, Bt·TPAD], part [Bi,
// ⌈D/256⌉, 3, Bt·TPAD] and wei then hold the whole batch, e still one
// chunk. Returns a cudaError_t: 0 when the launches were accepted.
int medmoe_gloria_sim(const void* ctx, const void* words, const void* cap, int Bi, int Bt, int M,
                      int D, int T, float temp1, float temp2, float temp3, const void* wt,
                      void* e, void* esum, void* part, void* wei, int chunk, void* out,
                      void* stream) {
  if (!shapes_ok(Bi, Bt, M, D, T) || chunk < 1 || chunk > 65535)
    return (int)cudaErrorInvalidValue;
  const GloriaArgs a = make_args(ctx, words, cap, Bi, Bt, M, D, T, temp1, temp2, temp3);
  const PassArgs p = pass_args(a, wt, e, esum, part, wei);
  float* sim = static_cast<float*>(out);
  if (wei != nullptr)
    return run_passes<true, false>(a, p, chunk, sim, nullptr, nullptr, nullptr, nullptr, nullptr,
                                   stream);
  return run_passes<false, false>(a, p, chunk, sim, nullptr, nullptr, nullptr, nullptr, nullptr,
                                  stream);
}

// The backward's prologue: the forward chain again, then the cotangents
// down to bf16(d_wei) [Bi·Bt, D, TPAD] and the per-word vectors
// [Bi·Bt, 4, TPAD] for the upstream cotangent g [Bi, Bt] f32; the words
// transposed and the scratch of K3, and wei [chunk, Bt, D, TPAD] f32. With
// e null, esum, part and wei are K3's kept state of the whole batch
// (medmoe_gloria_sim) and only F3 runs, once over every pair; wt and chunk
// are not read. With wsum [Bt, D, TPAD] and c2sum [Bt, TPAD] (both or
// neither) also K4b's terms Σ_b dnum·wei and Σ_b c2.
int medmoe_gloria_pair_cotangents(const void* ctx, const void* words, const void* cap, int Bi,
                                  int Bt, int M, int D, int T, float temp1, float temp2,
                                  float temp3, const void* g, const void* wt, void* e, void* esum,
                                  void* part, void* wei, int chunk, void* dwei, void* vecs,
                                  void* wsum, void* c2sum, void* stream) {
  if (!shapes_ok(Bi, Bt, M, D, T) || chunk < 1 || chunk > 65535 ||
      (wsum == nullptr) != (c2sum == nullptr) || esum == nullptr || part == nullptr ||
      wei == nullptr)
    return (int)cudaErrorInvalidValue;
  const GloriaArgs a = make_args(ctx, words, cap, Bi, Bt, M, D, T, temp1, temp2, temp3);
  const PassArgs p = pass_args(a, wt, e, esum, part, wei);
  const float* gp = static_cast<const float*>(g);
  bf16* dw = static_cast<bf16*>(dwei);
  float *v = static_cast<float*>(vecs), *ws = static_cast<float*>(wsum);
  float* cs = static_cast<float*>(c2sum);
  if (e == nullptr)
    return (int)finish<true>(a, p, 0, Bi, nullptr, gp, dw, v, ws, cs,
                             static_cast<cudaStream_t>(stream));
  return run_passes<true, true>(a, p, chunk, nullptr, gp, dw, v, ws, cs, stream);
}

const char* medmoe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
