// Fused MedMoE expert branch, gather mode, backward (K2) — for sm_90a.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` (driven by `_bwd_pallas`) in
// medmoe_tpu/ops/pallas/expert_fusion.py. Per sample b with e = idx[b], from
// the inputs and the cotangent d_out [P, E] f32, the forward chain
// recomputed first (h_s by K1's projection template, as the TPU kernel
// recomputes its forward chain):
//
//   u_s   = bf16(lerp of h_s)                      as in the forward
//   a_s   = bf16(relu(u_s·W1 + b1)),  logit_s = Σ a_s·w2
//   att32 = softmax_s(logit) (f32),   att = bf16(att32)
//   d_att_s = Σ_E d_out·u_s,          d_l = att32·(d_att − Σ_s att32·d_att)
//   dz_a  = [a_s > 0]·d_l_s·w2        dw2 = Σ_{s,P} a_s·d_l_s, db1 = Σ dz_a
//   dW1   = Σ_s u_sᵀ·bf16(dz_a)
//   d_u   = att_s·d_out + bf16(dz_a)·W1ᵀ                       (f32)
//   d_h   = Gᵀ·bf16(d_u) (transposed lerp; d_u itself at the largest scale)
//   dz_h  = [h_s > 0]·d_h  (h_s = bf16(relu(h_pre)): bf16 keeps f32's
//           exponent range, so h_s > 0 exactly when h_pre > 0)
//   d_x   = bf16(dz_h)·Wpᵀ,  dWp = x_sᵀ·bf16(dz_h),  dbp = Σ_P dz_h
// Parameters arrive rounded through bf16 (biases as bf16 values in f32, G's
// weights too, as the TPU kernel's bf16 interpolation matrix); attn_b2
// cancels in the softmax and its gradient is exactly zero.
//
// What bounds it on the H100: operations, in five products. At flagship
// shapes (P=3136, E=768, H=384, 4 scales) a sample takes ≈24.4 GFLOP: the
// a recompute, d_u and dW1 ≈7.4 each, h_s, d_x and dWp ≈0.87 each; ≈0.8
// ms of bf16 tensor-core time at B=32. Around them the passes stream
// O(P·E) bf16 bytes a sample and scale.
//
// The TPU kernel keeps a whole sample's maps (≈36 MB) in VMEM, one grid step
// per sample. Here every product runs on the wgmma core (csrc/wgmma_core.cuh:
// a TMA ring of 64-deep stages, one producer warp, two consumer warpgroups
// of m64n192k16 wgmma, one persistent block an SM), its operands read by TMA
// from bf16 scratch and the bank as stored (zeros past every edge), and
// every sum over P or over tiles runs in a fixed order without atomics. Per
// chunk of images (the wrapper sizes the chunk):
//   0. bwd_proj_kernel (wgmma, M = P_s, N = E, K = D_s): h_s of every
//      scale, stored by TMA (K1's projection, expert_fusion_passes.cuh);
//   1. bwd_u_kernel (streaming, a warp a row of P): u_s = bf16(lerp(h_s))
//      to a scratch for each non-identity scale (the identity scale's u is
//      h_0, read in place), and d_att_s, d_out read once for all scales; a
//      row's loads for up to 768 columns are all in flight before the first
//      is used;
//   2. bwd_act_kernel (wgmma, M = P, N = H, K = E): a_s = bf16(relu(u_s·W1
//      + b1)) to a scratch (stored by TMA from a ring stage), and each
//      192-wide N tile's partial logits;
//   (passes 0 and 2 are K1's projection and logit templates,
//   expert_fusion_passes.cuh, storing h_s and keeping a_s; pass 1 computes
//   the u K1's projection writes: K2's u and logits are K1's, bit for bit)
//   3. bwd_row_kernel (streaming, 64 rows a block): the logits summed in
//      tile order, the softmax over scales and its backward, bf16(att32)
//      for pass 4, bf16(dz_a) over a_s in place, the tile's dw2/db1 sums;
//   4. bwd_du_kernel (wgmma, M = P, N = E, K = H, W1 as stored, K-major):
//      att·d_out + bf16(dz_a)·W1ᵀ; the producer also loads the epilogue's
//      d_out tile (f32) and, at the identity scale, h_0's into the ring,
//      as stages of their own after the products', so that they arrive
//      while the products run; at the identity scale the epilogue masks by
//      h_0 > 0, writes bf16(dz_h_0) and the tile's dbp column sums, at the
//      others it writes bf16(d_u) (what Gᵀ reads), TMA storing the tile
//      from a stage;
//   5. bwd_tlerp_kernel (streaming, banded): d_h_s = Gᵀ·bf16(d_u) over the
//      ≤ 2r + 1 destination rows that read each source row, from a table
//      built in Python (ops/expert_fusion.py, transposed_lerp_plan): 8
//      source rows a block (one a warp), 256 columns a block (8 a lane, in
//      16-byte vectors); each warp walks its band in increasing p, in
//      windows of T_WIN rows read into registers, the next window's loads
//      in flight while this one is summed; then the mask h_s > 0,
//      bf16(dz_h_s) and the block's dbp sums;
//   6. bwd_dx_kernel (wgmma, M = P_s, N = D_s, K = E, Wp as stored,
//      K-major): bf16(dz_h)·Wpᵀ, TMA storing the tile from a stage;
//   7. bwd_wgrad_kernel (wgmma, A and B MN-major): dW1 = Σ_s u_sᵀ·bf16(dz_a)
//      (K = S·P, one accumulation over all scales, each scale's rows past P
//      read as zeros) and dWp_s = x_sᵀ·bf16(dz_h_s) (K = P_s), the dW1
//      tiles (196 stages a flagship tile) first;
//   8. bwd_reduce_kernel (a thread a column, over images and over the
//      columns of H and of every scale's E): the partial sums of db1, dw2
//      and dbp in tile order.
// Scratch a flagship image: h 6.4 MB, u and bf16(d_u) 14.5 MB each, a/dz_a
// 9.6 MB, bf16(dz_h) 6.4 MB, the per-tile sums 0.9 MB (≈52 MB; the
// f32 d_u the single-pass design kept was 38.5 MB an image).
// A block reads idx[b] itself; an out-of-range id writes NaN to that
// sample's outputs only.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (medmoe_torch/ops/_build.py).

#include "expert_fusion_passes.cuh"

#define U_WARPS 4     // rows of P a block of the u pass, one a warp
#define ROW_TM 64     // rows of P a block of the row step
#define T_ROWS 8      // source rows a block of the transposed upsample, one a warp
#define T_COLS 256    // columns a block of the transposed upsample, 8 a lane
#define T_WIN 4       // destination rows of a window of the transposed upsample

// the products' tiles: wg::kBM = 128 rows by kBN columns (the logit
// product's width, kActBN: expert_fusion_passes.cuh)
constexpr int kBN = kActBN;
constexpr int kBoxK = kBN * wg::kBK * 2;  // a K-major [192 rows][64 k] box of B, 24 KB
// the d_u product's shared memory: the core's and [2][8 warps][kBN] f32 of
// dbp column sums
constexpr int kDuSmem = wg::kSmemBytes + 2 * 8 * kBN * 4;

struct BwdArgs {
  const bf16* x[MAX_SCALES];      // [B, P_s, D_s] pyramid
  const bf16* wp[MAX_SCALES];     // [K, D_s, E]
  const bf16* h[MAX_SCALES];      // [B, P_s, E] recomputed projections
  bf16* u[MAX_SCALES];            // [B, P, E] bf16 u_s (h_s itself at P_s = P)
  bf16* du[MAX_SCALES];           // [B, P, E] bf16(d_u_s), P_s < P only
  bf16* act[MAX_SCALES];          // [B, P, H] a_s, then bf16(dz_a_s)
  bf16* dzh[MAX_SCALES];          // [B, P_s, E] bf16(dz_h_s)
  bf16* dx[MAX_SCALES];           // [B, P_s, D_s] out
  float* dwp[MAX_SCALES];         // [B, D_s, E] out
  float* dbp[MAX_SCALES];         // [B, E] out
  float* dbp_part[MAX_SCALES];    // [B, n_part_s, E] scratch
  const int* t_start[MAX_SCALES]; // [P_s + 1] Gᵀ by source row: entries t_start[i]..
  const int* t_row[MAX_SCALES];   // destination row of each entry, increasing in a row
  const float* t_w[MAX_SCALES];   // G[p, i], rounded through bf16
  int P[MAX_SCALES];
  int D[MAX_SCALES];
  int n_part[MAX_SCALES];         // ⌈P/128⌉ at P_s = P (pass 4), else ⌈P_s/8⌉ (pass 5)
  int t_blk[MAX_SCALES + 1];      // pass 5 blocks, scale by scale
  int dx_start[MAX_SCALES + 1];   // pass 6 tiles of an image, scale by scale
  int wg_start[MAX_SCALES + 2];   // pass 7 tiles of an image: dW1, then dWp scale by scale
  int n_scales;
  const bf16* w1;                 // [K, E, H]
  const float* b1;                // [K, H], rounded through bf16
  const float* w2;                // [K, H], rounded through bf16
  const int* idx;                 // [B]
  const float* dout;              // [B, P, E]
  float* dw1;                     // [B, E, H] out
  float* db1;                     // [B, H] out
  float* dw2;                     // [B, H] out
  float* datt;                    // [B, S, P] scratch: d_att
  float* lpart;                   // [B, S, ⌈H/kActBN⌉, P] scratch: partial logits
  float* att;                     // [B, S, P] scratch: bf16(att32)
  float* row_part;                // [B, ⌈P/64⌉, 2, H] scratch: partial dw2, db1
  int P_out, B, K, E, H;
};

// the tensor maps of passes 4, 6 and 7 (pass 2's: ActMaps), each 128-byte
// swizzled, zeros past every edge: K-major operands in [rows][64 k] boxes
// (128 rows of A, kBN rows of B), MN-major ones in [64 k][64 m or n] boxes
struct DuMaps {
  CUtensorMap dz[MAX_SCALES];  // bf16(dz_a_s) [B][P][H], A
  CUtensorMap w1;              // the bank W1 [K][E][H], B
  CUtensorMap dout;            // d_out [B][P][E] f32, [128 p][32 e] boxes: the epilogue's
  CUtensorMap h[MAX_SCALES];   // h_s [B][P][E] at P_s = P, [128 p][64 e] boxes: its mask
  CUtensorMap out[MAX_SCALES]; // bf16(d_u_s), or bf16(dz_h_s) at P_s = P, [B][P][E], stored
};
struct DxMaps {
  CUtensorMap dz[MAX_SCALES];  // bf16(dz_h_s) [B][P_s][E], A
  CUtensorMap wp[MAX_SCALES];  // the banks Wp_s [K][D_s][E], B
  CUtensorMap dx[MAX_SCALES];  // d_x_s [B][P_s][D_s], stored
};
struct WgMaps {
  CUtensorMap u[MAX_SCALES];    // u_s [B][P][E] (h_0 at the identity scale), dW1's A
  CUtensorMap act[MAX_SCALES];  // bf16(dz_a_s) [B][P][H], dW1's B
  CUtensorMap x[MAX_SCALES];    // x_s [B][P_s][D_s], dWp's A
  CUtensorMap dz[MAX_SCALES];   // bf16(dz_h_s) [B][P_s][E], dWp's B
};

__device__ __forceinline__ void store4_bf16(bf16* dst, float4 v) {
  __align__(8) __nv_bfloat162 o[2] = {__floats2bfloat162_rn(v.x, v.y),
                                      __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(o);
}

// ---------------------------------------------------------------------------
// pass 0: h_s of every scale; persistent (expert_fusion_passes.cuh)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(wg::kThreads, 1)
bwd_proj_kernel(const __grid_constant__ ProjMaps maps, const ProjArgs a) {
  extern __shared__ unsigned char smem_raw[];
  proj_tiles<false>(maps, a, smem_raw);
}

// 16 bytes through the read-only path
__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// ---------------------------------------------------------------------------
// pass 1: u_s to scratch (P_s < P) and d_att_s = Σ_E d_out·u_s; a warp a row
// p of P, 8 columns a lane, grid (⌈P/U_WARPS⌉, B). A column step's loads
// (d_out once for all scales, the one or two h rows of every scale) are
// all issued before the first is used; d_out, read once, and u, written
// once, stream past L2 (evict-first), which keeps the h rows that
// neighbouring rows share. d_att sums each step's 8 products, then the
// steps in order, then the warp's lanes.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(U_WARPS * 32) bwd_u_kernel(BwdArgs a) {
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = a.P_out, E = a.E, S = a.n_scales;
  const int p = blockIdx.x * U_WARPS + warp;
  if (p >= P || bad_expert(a, a.idx[b])) return;
  const bf16* hs[MAX_SCALES];
  int i0[MAX_SCALES], i1[MAX_SCALES];
  float w[MAX_SCALES], acc[MAX_SCALES];
#pragma unroll
  for (int s = 0; s < MAX_SCALES; ++s) {
    i0[s] = i1[s] = p;
    w[s] = acc[s] = 0.0f;
    hs[s] = s < S ? a.h[s] + (size_t)b * a.P[s] * E : nullptr;
    if (s < S && a.P[s] != P) lerp_rows(p, a.P[s], P, i0[s], i1[s], w[s]);
  }
  const float* d = a.dout + ((size_t)b * P + p) * E;
  for (int c = lane * 8; c < E; c += 256) {
    const float4 g0 = __ldcs(reinterpret_cast<const float4*>(d + c));
    const float4 g1 = __ldcs(reinterpret_cast<const float4*>(d + c + 4));
    uint4 x0[MAX_SCALES], x1[MAX_SCALES];
#pragma unroll
    for (int s = 0; s < MAX_SCALES; ++s) {
      if (s >= S) continue;
      x0[s] = ldg16(hs[s] + (size_t)i0[s] * E + c);
      x1[s] = a.P[s] != P ? ldg16(hs[s] + (size_t)i1[s] * E + c) : x0[s];
    }
    const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
    for (int s = 0; s < MAX_SCALES; ++s) {
      if (s >= S) continue;
      const bf16* v0 = reinterpret_cast<const bf16*>(&x0[s]);
      const bf16* v1 = reinterpret_cast<const bf16*>(&x1[s]);
      float u[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) u[q] = __bfloat162float(v0[q]);
      if (a.P[s] != P) {
#pragma unroll
        for (int q = 0; q < 8; ++q) u[q] = round_bf16(lerp(u[q], __bfloat162float(v1[q]), w[s]));
        store8_bf16_cs(a.u[s] + ((size_t)b * P + p) * E + c, u);
      }
      float part = 0.0f;
#pragma unroll
      for (int q = 0; q < 8; ++q) part += g[q] * u[q];
      acc[s] += part;
    }
  }
#pragma unroll
  for (int s = 0; s < MAX_SCALES; ++s) {
    if (s >= S) break;
    const float v = warp_sum(acc[s]);
    if (lane == 0) a.datt[((size_t)b * S + s) * P + p] = v;
  }
}

// ---------------------------------------------------------------------------
// pass 2: a_s = bf16(relu(u_s·W1 + b1)) and partial logits; persistent
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(wg::kThreads, 1)
bwd_act_kernel(const __grid_constant__ ActMaps maps, BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  act_tiles<true>(maps, a, smem_raw);
}

// ---------------------------------------------------------------------------
// pass 3: the row step, 64 rows of P a block; grid (⌈P/64⌉, B)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) bwd_row_kernel(BwdArgs a) {
  __shared__ float dl[MAX_SCALES][ROW_TM];
  __shared__ float red[2][THREADS * 8];  // per group: Σ a·d_l, Σ dz_a
  const int b = blockIdx.y;
  const int tile = blockIdx.x, m0 = tile * ROW_TM, tid = threadIdx.x;
  const int P = a.P_out, H = a.H, S = a.n_scales;
  const int rows = P - m0 < ROW_TM ? P - m0 : ROW_TM;
  const int e = a.idx[b];
  if (bad_expert(a, e)) return;
  const int tiles_n = cdiv(H, kActBN);

  if (tid < ROW_TM) {
    const int m = m0 + tid;
    float l[MAX_SCALES], ex[MAX_SCALES], da[MAX_SCALES];
    float mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < MAX_SCALES; ++s) {
      l[s] = da[s] = 0.0f;
      if (s < S && tid < rows) {
        const float* lp = a.lpart + (((size_t)b * S + s) * tiles_n) * P + m;
        for (int t = 0; t < tiles_n; ++t) l[s] += lp[(size_t)t * P];
        da[s] = a.datt[((size_t)b * S + s) * P + m];
        mx = fmaxf(mx, l[s]);
      }
    }
    float z = 0.0f;
#pragma unroll
    for (int s = 0; s < MAX_SCALES; ++s) {
      ex[s] = s < S && tid < rows ? expf(l[s] - mx) : 0.0f;
      z += ex[s];
    }
    float inner = 0.0f;
#pragma unroll
    for (int s = 0; s < MAX_SCALES; ++s) {
      if (s < S && tid < rows) {
        ex[s] = ex[s] / z;  // att32
        inner += ex[s] * da[s];
      }
    }
#pragma unroll
    for (int s = 0; s < MAX_SCALES; ++s) {
      if (s >= S) break;
      dl[s][tid] = tid < rows ? ex[s] * (da[s] - inner) : 0.0f;
      if (tid < rows) a.att[((size_t)b * S + s) * P + m] = round_bf16(ex[s]);
    }
  }
  __syncthreads();

  // dz_a = [a > 0]·d_l·w2 over a in place; group g of nv threads (one 8-wide
  // vector of H each) takes rows g, g + G, ... in order
  const int nv = H / 8, G = THREADS / nv, g = tid / nv, v = tid % nv, c = v * 8;
  const float* w2 = a.w2 + (size_t)e * H;
  float sw2[8], sb1[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) sw2[q] = sb1[q] = 0.0f;
  if (g < G) {
    float w2c[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) w2c[q] = w2[c + q];
    for (int s = 0; s < S; ++s) {
      bf16* act = a.act[s] + ((size_t)b * P + m0) * H + c;
      for (int r = g; r < rows; r += G) {
        float av[8], dz[8];
        load8_bf16(act + (size_t)r * H, av);
        const float d = dl[s][r];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          sw2[q] += av[q] * d;
          dz[q] = av[q] > 0.0f ? d * w2c[q] : 0.0f;
          sb1[q] += dz[q];
        }
        store8_bf16(act + (size_t)r * H, dz);
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      red[0][g * H + c + q] = sw2[q];
      red[1][g * H + c + q] = sb1[q];
    }
  }
  __syncthreads();
  float* part = a.row_part + ((size_t)b * gridDim.x + tile) * 2 * H;
  for (int col = tid; col < H; col += THREADS) {
    float s2 = 0.0f, s1 = 0.0f;
    for (int q = 0; q < G; ++q) {
      s2 += red[0][q * H + col];
      s1 += red[1][q * H + col];
    }
    part[col] = s2;
    part[H + col] = s1;
  }
}

// ---------------------------------------------------------------------------
// pass 4: d_u = att·d_out + bf16(dz_a)·W1ᵀ; persistent over the tiles
// (image, scale, 128-row tile of P, kBN-wide tile of E), the tiles of E
// fastest: a block's share of the walk mixes the scales (a walk with the
// scale fastest gave each block one scale, 132 being a multiple of 4, and
// left the blocks with the identity scale's heavier epilogue the last)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(wg::kThreads, 1)
bwd_du_kernel(const __grid_constant__ DuMaps maps, BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const wg::Smem s = wg::carve(smem_raw);
  const int E = a.E, H = a.H, P = a.P_out, S = a.n_scales;
  const int n_nt = cdiv(E, kBN), n_mt = cdiv(P, wg::kBM);
  const int tiles = a.B * n_mt * n_nt * S, nk = cdiv(H, wg::kBK);
  wg::init_barriers(s);

  if (threadIdx.x < 128) {
    // producer: A = bf16(dz_a_s) rows m0.., B = W1[e] rows n0.. as stored
    // (H contiguous), one [192 e][64 h] box
    wg::reg_dealloc<wg::kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int sc = 0; sc < S; ++sc) {
        wg::prefetch_map(&maps.dz[sc]);
        if (a.P[sc] == P) wg::prefetch_map(&maps.h[sc]);
      }
      wg::prefetch_map(&maps.w1);
      wg::prefetch_map(&maps.dout);
      wg::Ring ring;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int nt = tile % n_nt, mt = (tile / n_nt) % n_mt, sc = (tile / (n_nt * n_mt)) % S;
        const int b = tile / (n_nt * n_mt * S), e = a.idx[b];
        if (bad_expert(a, e)) continue;
        for (int kb = 0; kb < nk; ++kb) {
          uint64_t* full = &s.full[ring.stage];
          wg::mbar_wait(&s.empty[ring.stage], ring.phase ^ 1u);
          wg::mbar_expect_tx(full, wg::kABytes + kBoxK);
          wg::tma_load(wg::stage_a(s, ring.stage), &maps.dz[sc], full, kb * wg::kBK,
                       mt * wg::kBM, b);
          wg::tma_load(wg::stage_b(s, ring.stage), &maps.w1, full, kb * wg::kBK, nt * kBN, e);
          ring.advance();
        }
        // the epilogue's operands, each a stage of its own: d_out's two
        // [128 p][96 e] f32 halves, three [128][32] boxes each, then h_0
        // [128 p][192 e] bf16 at the identity scale, three [128][64] boxes
        const bool ident = a.P[sc] == P;
        for (int part = 0; part < (ident ? 3 : 2); ++part) {
          uint64_t* full = &s.full[ring.stage];
          wg::mbar_wait(&s.empty[ring.stage], ring.phase ^ 1u);
          wg::mbar_expect_tx(full, 3 * kRowBox);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const uint32_t dst = wg::stage_a(s, ring.stage) + c * kRowBox;
            if (part < 2)
              wg::tma_load(dst, &maps.dout, full, nt * kBN + part * (kBN / 2) + c * 32,
                           mt * wg::kBM, b);
            else
              wg::tma_load(dst, &maps.h[sc], full, nt * kBN + c * 64, mt * wg::kBM, b);
          }
          ring.advance();
        }
        wg::reserve(s, ring);  // the output tile's stage
      }
    }
  } else {
    wg::reg_alloc<wg::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1, ci = threadIdx.x - 128;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31, q = lane & 3;
    float* red = s.vecs + 2 * wg::kVecFloats;  // [2][8 warps][kBN]
    wg::Ring ring;
    float acc[kBN / 2];
    int parity = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int nt = tile % n_nt, mt = (tile / n_nt) % n_mt, sc = (tile / (n_nt * n_mt)) % S;
      const int b = tile / (n_nt * n_mt * S);
      if (bad_expert(a, a.idx[b])) continue;
      const bool ident = a.P[sc] == P;
      const int n0 = nt * kBN;
      wg::consume<kBN, 0, 0>(
          acc, s, ring, nk,
          [&](int st, int ks) { return wg::desc_k128(wg::stage_a(s, st) + cw * 8192, ks); },
          [&](int st, int ks) { return wg::desc_k128(wg::stage_b(s, st), ks); });

      // this thread's rows r (h = 0, 1) of the tile and columns n0 + 8j +
      // 2q + (0, 1): o = att·d_out + acc, from the d_out stages (zeros past
      // P and E, where acc is zero too), then at the identity scale masked
      // by h_0 > 0 from its stage and kept in f32 for the dbp sums
      const float* att = a.att + ((size_t)b * S + sc) * P;
      const int r0 = cw * 64 + warp * 16 + (lane >> 2);
      float at[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * wg::kBM + r0 + 8 * h;
        at[h] = m < P ? att[m] : 0.0f;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const unsigned char* g = wg::acquire(s, ring);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int jj = 0; jj < kBN / 16; ++jj) {
            const int j = half * (kBN / 16) + jj;
            const float2 v = *reinterpret_cast<const float2*>(
                g + (jj / 4) * kRowBox + wg::sw128(r0 + 8 * h, 2 * (jj % 4) + (q >> 1)) +
                8 * (q & 1));
            float& o0 = acc[4 * j + 2 * h];
            float& o1 = acc[4 * j + 2 * h + 1];
            o0 = __fadd_rn(__fmul_rn(at[h], v.x), o0);
            o1 = __fadd_rn(__fmul_rn(at[h], v.y), o1);
          }
        wg::release(s, ring);
      }
      if (ident) {  // dz_h_0 = [h_0 > 0]·d_u
        const unsigned char* hb = wg::acquire(s, ring);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j) {
            const float2 hf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                hb + (j / 8) * kRowBox + wg::sw128(r0 + 8 * h, j % 8) + 4 * q));
            float& o0 = acc[4 * j + 2 * h];
            float& o1 = acc[4 * j + 2 * h + 1];
            o0 = hf.x > 0.0f ? o0 : 0.0f;
            o1 = hf.y > 0.0f ? o1 : 0.0f;
          }
        wg::release(s, ring);
      }
      store_tile_bf16(s, ring, acc, &maps.out[sc], n0, E, mt * wg::kBM, b);
      if (!ident) continue;
      // the tile's dbp column sums: each thread its two rows, then a
      // butterfly over the warp's eight row-lanes (lane bits 4, 3, 2), which
      // leaves lane a V/8 of the columns (v = V/2·b4 + V/4·b3 + V/8·b2 + i,
      // column 4v' + 2q + e for v = v' + e, v' even), then the eight warps
      // in order
      constexpr int V = kBN / 4;
      float v[V];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        v[2 * j] = acc[4 * j] + acc[4 * j + 2];
        v[2 * j + 1] = acc[4 * j + 1] + acc[4 * j + 3];
      }
      wg::fold<V / 2>(v, lane, 16);
      wg::fold<V / 4>(v, lane, 8);
      wg::fold<V / 8>(v, lane, 4);
      const int base = (lane & 16 ? V / 2 : 0) + (lane & 8 ? V / 4 : 0) + (lane & 4 ? V / 8 : 0);
      float* rw = red + (parity * 8 + cw * 4 + warp) * kBN;
#pragma unroll
      for (int k = 0; k < V / 8; k += 2)
        *reinterpret_cast<float2*>(rw + 4 * (base + k) + 2 * q) = make_float2(v[k], v[k + 1]);
      wg::consumer_sync();
      if (ci < kBN && n0 + ci < E) {
        const float* rc = red + parity * 8 * kBN + ci;
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < 8; ++w) sum += rc[w * kBN];
        a.dbp_part[sc][((size_t)b * a.n_part[sc] + mt) * E + n0 + ci] = sum;
      }
      parity ^= 1;
    }
    if (ci == 0) wg::tma_store_wait<0, false>();  // store_tile_bf16's
  }
}

// ---------------------------------------------------------------------------
// pass 5: dz_h_s = [h_s > 0]·Gᵀ·bf16(d_u_s), banded; grid (Σ_s blocks, B).
// Warp w of a block sums source row i's band, its destination rows in
// increasing p, in windows of T_WIN rows read straight into registers: the
// next window's loads are in flight while this one is summed (a two-stage
// ring in registers). No window is shared or staged, so no warp waits for
// another's rows, and the r = 64 scale's long bands (≈2r rows) keep their
// loads in flight; the ≤ r rows two neighbouring source rows share come
// from L2 the second time.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) bwd_tlerp_kernel(BwdArgs a) {
  __shared__ float red[T_ROWS][T_COLS];
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int t = blockIdx.x, s = 0;
  while (s + 1 < a.n_scales && t >= a.t_blk[s + 1]) ++s;
  t -= a.t_blk[s];
  const int E = a.E, P = a.P_out, Ps = a.P[s];
  const int n_cc = cdiv(E, T_COLS), cc = t % n_cc, rb = t / n_cc, c0 = cc * T_COLS;
  if (bad_expert(a, a.idx[b])) return;
  const int i = rb * T_ROWS + warp, c = c0 + lane * 8;
  const bool live = i < Ps, col = c < E;
  const int k_beg = live ? a.t_start[s][i] : 0, k_end = live ? a.t_start[s][i + 1] : 0;
  const int* __restrict__ tr = a.t_row[s];
  const float* __restrict__ tw = a.t_w[s];
  const bf16* du = a.du[s] + (size_t)b * P * E + c;
  float acc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = 0.0f;

  uint4 v0[T_WIN], v1[T_WIN];
  float w0[T_WIN], w1[T_WIN];
  // window k0..k0 + T_WIN of the band into (v, wt); entries past its end
  // are not read
  auto fetch = [&](uint4 (&v)[T_WIN], float (&wt)[T_WIN], int k0) {
#pragma unroll
    for (int j = 0; j < T_WIN; ++j) {
      const int k = k0 + j;
      wt[j] = k < k_end ? tw[k] : 0.0f;
      v[j] = k < k_end && col ? ldg16(du + (size_t)tr[k] * E) : make_uint4(0, 0, 0, 0);
    }
  };
  auto add = [&](const uint4 (&v)[T_WIN], const float (&wt)[T_WIN], int k0) {
#pragma unroll
    for (int j = 0; j < T_WIN; ++j) {
      if (k0 + j >= k_end) break;
      const bf16* x = reinterpret_cast<const bf16*>(&v[j]);
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[q] += wt[j] * __bfloat162float(x[q]);
    }
  };
  fetch(v0, w0, k_beg);
  for (int k0 = k_beg; k0 < k_end; k0 += 2 * T_WIN) {
    fetch(v1, w1, k0 + T_WIN);
    add(v0, w0, k0);
    if (k0 + T_WIN >= k_end) break;
    fetch(v0, w0, k0 + 2 * T_WIN);
    add(v1, w1, k0 + T_WIN);
  }

  if (live && col) {
    float hv[8];
    load8_bf16(a.h[s] + ((size_t)b * Ps + i) * E + c, hv);
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = hv[q] > 0.0f ? acc[q] : 0.0f;
    store8_bf16(a.dzh[s] + ((size_t)b * Ps + i) * E + c, acc);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = 0.0f;
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) red[warp][lane * 8 + q] = acc[q];
  __syncthreads();
  if (c0 + tid < E) {  // the block's column sums, source rows in order
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < T_ROWS; ++w) sum += red[w][tid];
    a.dbp_part[s][((size_t)b * a.n_part[s] + rb) * E + c0 + tid] = sum;
  }
}

// ---------------------------------------------------------------------------
// pass 6: d_x_s = bf16(dz_h_s)·Wp[e]ᵀ; persistent over the tiles (image,
// then each scale's 128-row tiles of P_s by kBN-wide tiles of D_s)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(wg::kThreads, 1)
bwd_dx_kernel(const __grid_constant__ DxMaps maps, BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const wg::Smem s = wg::carve(smem_raw);
  const int E = a.E, S = a.n_scales, per = a.dx_start[S];
  const int tiles = a.B * per, nk = cdiv(E, wg::kBK);
  // tile → image b, scale sc, its row and column tiles mt, nt
  auto decode = [&](int tile, int& b, int& sc, int& mt, int& nt) {
    b = tile / per;
    int t = tile - b * per;
    sc = 0;
    while (sc + 1 < S && t >= a.dx_start[sc + 1]) ++sc;
    t -= a.dx_start[sc];
    const int n_nt = cdiv(a.D[sc], kBN);
    mt = t / n_nt;
    nt = t % n_nt;
  };
  wg::init_barriers(s);

  if (threadIdx.x < 128) {
    // producer: A = bf16(dz_h_s) rows m0.., B = Wp_s[e] rows n0.. as stored
    // (E contiguous), one [192 d][64 e] box
    wg::reg_dealloc<wg::kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int sc = 0; sc < S; ++sc) {
        wg::prefetch_map(&maps.dz[sc]);
        wg::prefetch_map(&maps.wp[sc]);
      }
      wg::Ring ring;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int b, sc, mt, nt;
        decode(tile, b, sc, mt, nt);
        const int e = a.idx[b];
        if (bad_expert(a, e)) continue;
        for (int kb = 0; kb < nk; ++kb) {
          uint64_t* full = &s.full[ring.stage];
          wg::mbar_wait(&s.empty[ring.stage], ring.phase ^ 1u);
          wg::mbar_expect_tx(full, wg::kABytes + kBoxK);
          wg::tma_load(wg::stage_a(s, ring.stage), &maps.dz[sc], full, kb * wg::kBK,
                       mt * wg::kBM, b);
          wg::tma_load(wg::stage_b(s, ring.stage), &maps.wp[sc], full, kb * wg::kBK, nt * kBN,
                       e);
          ring.advance();
        }
        wg::reserve(s, ring);  // the output tile's stage
      }
    }
  } else {
    wg::reg_alloc<wg::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1, ci = threadIdx.x - 128;
    wg::Ring ring;
    float acc[kBN / 2];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int b, sc, mt, nt;
      decode(tile, b, sc, mt, nt);
      const int Ps = a.P[sc], D = a.D[sc], n0 = nt * kBN;
      bf16* dx = a.dx[sc] + (size_t)b * Ps * D;
      if (bad_expert(a, a.idx[b])) {  // out-of-range expert id: poison this tile of d_x
        for (int v = ci; v < wg::kBM * kBN / 2; v += wg::kConsumers) {
          const int m = mt * wg::kBM + v / (kBN / 2), n = n0 + (v % (kBN / 2)) * 2;
          if (m < Ps && n < D)
            *reinterpret_cast<__nv_bfloat162*>(dx + (size_t)m * D + n) =
                __floats2bfloat162_rn(nan_f(), nan_f());
        }
        continue;
      }
      wg::consume<kBN, 0, 0>(
          acc, s, ring, nk,
          [&](int st, int ks) { return wg::desc_k128(wg::stage_a(s, st) + cw * 8192, ks); },
          [&](int st, int ks) { return wg::desc_k128(wg::stage_b(s, st), ks); });
      store_tile_bf16(s, ring, acc, &maps.dx[sc], n0, D, mt * wg::kBM, b);
    }
    if (ci == 0) wg::tma_store_wait<0, false>();  // store_tile_bf16's
  }
}

// ---------------------------------------------------------------------------
// pass 7: C = Aᵀ·B with A and B MN-major (rows over K); persistent over the
// tiles, every image's dW1 tiles first, then every image's dWp tiles
//   dW1   = Σ_s u_sᵀ·bf16(dz_a_s)   (M = E, N = H, K = S·P: ⌈P/64⌉
//                                    stages a scale, zeros past P)
//   dWp_s = x_sᵀ·bf16(dz_h_s)      (M = D_s, N = E, K = P_s)
// ---------------------------------------------------------------------------
struct WgTile {
  int b, job, mt, nt;  // job 0: dW1; 1 + s: dWp of scale s
};

__global__ void __launch_bounds__(wg::kThreads, 1)
bwd_wgrad_kernel(const __grid_constant__ WgMaps maps, BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const wg::Smem s = wg::carve(smem_raw);
  const int E = a.E, H = a.H, P = a.P_out, S = a.n_scales;
  const int n_w1 = a.wg_start[1], n_wp = a.wg_start[S + 1] - n_w1;
  const int tiles = a.B * (n_w1 + n_wp), kps = cdiv(P, wg::kBK);  // dW1's stages a scale
  auto decode = [&](int tile) {
    WgTile w;
    int t;
    if (tile < a.B * n_w1) {
      w.b = tile / n_w1;
      t = tile - w.b * n_w1;
      w.job = 0;
    } else {
      tile -= a.B * n_w1;
      w.b = tile / n_wp;
      t = tile - w.b * n_wp + n_w1;
      w.job = 1;
      while (w.job < S && t >= a.wg_start[w.job + 1]) ++w.job;
      t -= a.wg_start[w.job];
    }
    const int n_nt = cdiv(w.job == 0 ? H : E, kBN);
    w.mt = t / n_nt;
    w.nt = t % n_nt;
    return w;
  };
  wg::init_barriers(s);

  if (threadIdx.x < 128) {
    // producer: A's 64-deep slice as two [64 k][64 m] boxes, B's as three
    // [64 k][64 n] boxes, side by side along M and N
    wg::reg_dealloc<wg::kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int sc = 0; sc < S; ++sc) {
        wg::prefetch_map(&maps.u[sc]);
        wg::prefetch_map(&maps.act[sc]);
        wg::prefetch_map(&maps.x[sc]);
        wg::prefetch_map(&maps.dz[sc]);
      }
      wg::Ring ring;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const WgTile w = decode(tile);
        if (bad_expert(a, a.idx[w.b])) continue;
        const int nk = w.job == 0 ? S * kps : cdiv(a.P[w.job - 1], wg::kBK);
        for (int kb = 0; kb < nk; ++kb) {
          const int sc = w.job == 0 ? kb / kps : w.job - 1;
          const int p0 = (w.job == 0 ? kb - sc * kps : kb) * wg::kBK;
          const CUtensorMap* am = w.job == 0 ? &maps.u[sc] : &maps.x[sc];
          const CUtensorMap* bm = w.job == 0 ? &maps.act[sc] : &maps.dz[sc];
          uint64_t* full = &s.full[ring.stage];
          wg::mbar_wait(&s.empty[ring.stage], ring.phase ^ 1u);
          wg::mbar_expect_tx(full, wg::kABytes + kBN * wg::kBK * 2);
#pragma unroll
          for (int c = 0; c < wg::kBM / wg::kBox128; ++c)
            wg::tma_load(wg::stage_a(s, ring.stage) + c * kBox128Bytes, am, full,
                         w.mt * wg::kBM + c * wg::kBox128, p0, w.b);
#pragma unroll
          for (int c = 0; c < kBN / wg::kBox128; ++c)
            wg::tma_load(wg::stage_b(s, ring.stage) + c * kBox128Bytes, bm, full,
                         w.nt * kBN + c * wg::kBox128, p0, w.b);
          ring.advance();
        }
      }
    }
  } else {
    wg::reg_alloc<wg::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1, ci = threadIdx.x - 128, q = threadIdx.x & 3;
    const int r0 = cw * 64 + ((threadIdx.x / 32) & 3) * 16 + ((threadIdx.x & 31) >> 2);
    wg::Ring ring;
    float acc[kBN / 2];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const WgTile w = decode(tile);
      const int M = w.job == 0 ? E : a.D[w.job - 1], N = w.job == 0 ? H : E;
      float* out = w.job == 0 ? a.dw1 + (size_t)w.b * E * H
                              : a.dwp[w.job - 1] + (size_t)w.b * M * E;
      const int n0 = w.nt * kBN;
      if (bad_expert(a, a.idx[w.b])) {  // poison this tile
        for (int v = ci; v < wg::kBM * kBN / 2; v += wg::kConsumers) {
          const int m = w.mt * wg::kBM + v / (kBN / 2), n = n0 + (v % (kBN / 2)) * 2;
          if (m < M && n < N)
            *reinterpret_cast<float2*>(out + (size_t)m * N + n) = make_float2(nan_f(), nan_f());
        }
        continue;
      }
      const int nk = w.job == 0 ? S * kps : cdiv(a.P[w.job - 1], wg::kBK);
      wg::consume<kBN, 1, 1>(
          acc, s, ring, nk,
          [&](int st, int ks) {
            return wg::desc_mn128(wg::stage_a(s, st) + cw * kBox128Bytes, ks);
          },
          [&](int st, int ks) { return wg::desc_mn128(wg::stage_b(s, st), ks); });
      // f32 straight from the registers: a quad writes 32 bytes of a row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = w.mt * wg::kBM + r0 + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int n = n0 + 8 * j + 2 * q;
          if (n < N)  // N % 8 == 0: both columns or neither
            *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pass 8: the per-tile partial sums in tile order, a thread a column; grid
// (⌈max(H, E)/THREADS⌉, B, 1 + S): z = 0 sums row_part into dw2 and db1
// (columns of H), z = 1 + s dbp_part of scale s into dbp_s (columns of E)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) bwd_reduce_kernel(BwdArgs a) {
  const int b = blockIdx.y, z = blockIdx.z, c = blockIdx.x * THREADS + threadIdx.x;
  const bool bad = bad_expert(a, a.idx[b]);
  const int E = a.E, H = a.H;
  if (z == 0) {
    if (c >= H) return;
    const int T = cdiv(a.P_out, ROW_TM);
    const float* part = a.row_part + (size_t)b * T * 2 * H + c;
    float s2 = 0.0f, s1 = 0.0f;
    if (!bad) {
#pragma unroll 8
      for (int t = 0; t < T; ++t) {
        s2 += part[(size_t)t * 2 * H];
        s1 += part[(size_t)t * 2 * H + H];
      }
    }
    a.dw2[(size_t)b * H + c] = bad ? nan_f() : s2;
    a.db1[(size_t)b * H + c] = bad ? nan_f() : s1;
    return;
  }
  const int s = z - 1, T = a.n_part[s];
  if (c >= E) return;
  const float* part = a.dbp_part[s] + (size_t)b * T * E + c;
  float sum = 0.0f;
  if (!bad) {
#pragma unroll 8
    for (int t = 0; t < T; ++t) sum += part[(size_t)t * E];
  }
  a.dbp[s][(size_t)b * E + c] = bad ? nan_f() : sum;
}

template <class Kernel>
static cudaError_t launch(Kernel k, dim3 grid, int threads, cudaStream_t st, const BwdArgs& a) {
  if (grid.x == 0) return cudaSuccess;
  k<<<grid, threads, 0, st>>>(a);
  return cudaGetLastError();
}

extern "C" {

// K2 for a chunk of B images, its projection first (h_s of every scale into
// the scratch hs). parts[0..MAX_SCALES+1]: the partial-sum rows an image
// the caller's scratch holds, dbp_parts' of each scale, then lpart's logit
// tiles, then row_part's row-step tiles; fewer than these tiles write is
// rejected.
// Returns a cudaError_t: 0 when every launch was accepted.
int medmoe_expert_fusion_bwd(int n_scales, const void* const* xs, const void* const* wps,
                             const void* const* bps, void* const* hs, void* const* us,
                             void* const* dus, void* const* acts, void* const* dzhs,
                             void* const* dxs, void* const* dwps, void* const* dbps,
                             void* const* dbp_parts,
                             const void* const* t_starts, const void* const* t_rows,
                             const void* const* t_ws, const int* Ps, const int* Ds,
                             const int* parts, const void* w1, const void* b1, const void* w2,
                             const void* idx, const void* dout, void* dw1, void* db1, void* dw2,
                             void* datt, void* lpart, void* att, void* row_part, int B, int K,
                             int E, int H, int P, void* stream) {
  if (n_scales < 1 || n_scales > MAX_SCALES || E % 8 || H % 8 || H / 8 > THREADS || B < 1 ||
      B > 65535 || parts[MAX_SCALES] < cdiv(H, kActBN) ||
      parts[MAX_SCALES + 1] < cdiv(P, ROW_TM))
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  int t_blk = 0, dx_tiles = 0;
  a.wg_start[0] = 0;
  a.wg_start[1] = cdiv(E, wg::kBM) * cdiv(H, kBN);
  for (int s = 0; s < n_scales; ++s) {
    if (Ds[s] % 8 || Ps[s] < 1 || P % Ps[s]) return (int)cudaErrorInvalidValue;
    const bool ident = Ps[s] == P;
    a.x[s] = static_cast<const bf16*>(xs[s]);
    a.wp[s] = static_cast<const bf16*>(wps[s]);
    a.h[s] = static_cast<const bf16*>(hs[s]);
    a.u[s] = ident ? const_cast<bf16*>(a.h[s]) : static_cast<bf16*>(us[s]);
    a.du[s] = static_cast<bf16*>(dus[s]);
    a.act[s] = static_cast<bf16*>(acts[s]);
    a.dzh[s] = static_cast<bf16*>(dzhs[s]);
    a.dx[s] = static_cast<bf16*>(dxs[s]);
    a.dwp[s] = static_cast<float*>(dwps[s]);
    a.dbp[s] = static_cast<float*>(dbps[s]);
    a.dbp_part[s] = static_cast<float*>(dbp_parts[s]);
    a.t_start[s] = static_cast<const int*>(t_starts[s]);
    a.t_row[s] = static_cast<const int*>(t_rows[s]);
    a.t_w[s] = static_cast<const float*>(t_ws[s]);
    a.P[s] = Ps[s];
    a.D[s] = Ds[s];
    a.n_part[s] = ident ? cdiv(P, wg::kBM) : cdiv(Ps[s], T_ROWS);
    if (parts[s] < a.n_part[s]) return (int)cudaErrorInvalidValue;
    a.t_blk[s] = t_blk;
    if (!ident) t_blk += cdiv(Ps[s], T_ROWS) * cdiv(E, T_COLS);
    a.dx_start[s] = dx_tiles;
    dx_tiles += cdiv(Ps[s], wg::kBM) * cdiv(Ds[s], kBN);
    a.wg_start[s + 2] = a.wg_start[s + 1] + cdiv(Ds[s], wg::kBM) * cdiv(E, kBN);
  }
  a.t_blk[n_scales] = t_blk;
  a.dx_start[n_scales] = dx_tiles;
  a.n_scales = n_scales;
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.idx = static_cast<const int*>(idx);
  a.dout = static_cast<const float*>(dout);
  a.dw1 = static_cast<float*>(dw1);
  a.db1 = static_cast<float*>(db1);
  a.dw2 = static_cast<float*>(dw2);
  a.datt = static_cast<float*>(datt);
  a.lpart = static_cast<float*>(lpart);
  a.att = static_cast<float*>(att);
  a.row_part = static_cast<float*>(row_part);
  a.P_out = P;
  a.B = B;
  a.K = K;
  a.E = E;
  a.H = H;

  // the products' tensor maps (they hold the chunk's pointers, so they are
  // built per call)
  const int S = n_scales;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const uint64_t e2 = (uint64_t)E * 2, h2 = (uint64_t)H * 2;
  ActMaps act_m;
  DuMaps du_m;
  DxMaps dx_m;
  WgMaps wg_m;
  bool ok = act_maps(&act_m, a.u, a.act, S, a.w1, B, K, E, H, P) &&
            tensor_map(&du_m.w1, a.w1, H, E, K, h2, E * h2, wg::kBK, kBN, sw) &&
            tensor_map(&du_m.dout, a.dout, E, P, B, e2 * 2, P * e2 * 2, 32, wg::kBM, sw,
                       CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  for (int s = 0; s < S && ok; ++s) {
    const uint64_t Pq = Ps[s], D = Ds[s];
    ok = tensor_map(&du_m.dz[s], a.act[s], H, P, B, h2, P * h2, wg::kBK, wg::kBM, sw) &&
         (Ps[s] != P ||
          tensor_map(&du_m.h[s], a.h[s], E, P, B, e2, P * e2, wg::kBox128, wg::kBM, sw)) &&
         tensor_map(&du_m.out[s], Ps[s] == P ? a.dzh[s] : a.du[s], E, P, B, e2, P * e2,
                    wg::kBox128, wg::kBM, sw) &&
         tensor_map(&dx_m.dz[s], a.dzh[s], E, Pq, B, e2, Pq * e2, wg::kBK, wg::kBM, sw) &&
         tensor_map(&dx_m.wp[s], a.wp[s], E, D, K, e2, D * e2, wg::kBK, kBN, sw) &&
         tensor_map(&dx_m.dx[s], a.dx[s], D, Pq, B, D * 2, Pq * D * 2, wg::kBox128, wg::kBM,
                    sw) &&
         tensor_map(&wg_m.u[s], a.u[s], E, P, B, e2, P * e2, wg::kBox128, wg::kBK, sw) &&
         tensor_map(&wg_m.act[s], a.act[s], H, P, B, h2, P * h2, wg::kBox128, wg::kBK, sw) &&
         tensor_map(&wg_m.x[s], a.x[s], D, Pq, B, D * 2, Pq * D * 2, wg::kBox128, wg::kBK, sw) &&
         tensor_map(&wg_m.dz[s], a.dzh[s], E, Pq, B, e2, Pq * e2, wg::kBox128, wg::kBK, sw);
  }
  ProjMaps proj_m;
  ProjArgs proj_a;
  if (!ok || !proj_setup(&proj_m, &proj_a, false, S, xs, wps, bps, hs, Ps, Ds, idx, B, K, E, P))
    return (int)cudaErrorInvalidValue;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = launch_persistent(bwd_proj_kernel, proj_a.tile_start[S], wg::kSmemBytes, st, proj_m,
                               proj_a)) != cudaSuccess)
    return (int)err;
  if ((err = launch(bwd_u_kernel, dim3(cdiv(P, U_WARPS), B), U_WARPS * 32, st, a)) != cudaSuccess)
    return (int)err;
  if ((err = launch_persistent(bwd_act_kernel, B * S * cdiv(P, wg::kBM) * cdiv(H, kActBN),
                               wg::kSmemBytes, st, act_m, a)) != cudaSuccess)
    return (int)err;
  if ((err = launch(bwd_row_kernel, dim3(cdiv(P, ROW_TM), B), THREADS, st, a)) != cudaSuccess)
    return (int)err;
  if ((err = launch_persistent(bwd_du_kernel, B * cdiv(P, wg::kBM) * cdiv(E, kBN) * S, kDuSmem,
                               st, du_m, a)) != cudaSuccess)
    return (int)err;
  if ((err = launch(bwd_tlerp_kernel, dim3(t_blk, B), THREADS, st, a)) != cudaSuccess)
    return (int)err;
  if ((err = launch_persistent(bwd_dx_kernel, B * dx_tiles, wg::kSmemBytes, st, dx_m, a)) !=
      cudaSuccess)
    return (int)err;
  if ((err = launch_persistent(bwd_wgrad_kernel, B * a.wg_start[S + 1], wg::kSmemBytes, st, wg_m,
                               a)) != cudaSuccess)
    return (int)err;
  return (int)launch(bwd_reduce_kernel, dim3(cdiv(H > E ? H : E, THREADS), B, 1 + S), THREADS, st,
                     a);
}

const char* medmoe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
