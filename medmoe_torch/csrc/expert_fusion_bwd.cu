// Fused MedMoE expert branch, gather mode, backward (K2) — for sm_90a.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` (driven by `_bwd_pallas`) in
// medmoe_tpu/ops/pallas/expert_fusion.py. Per sample b with e = idx[b], from
// the recomputed projections h_s (K1's projection launch, run by the wrapper
// into a scratch buffer, as the TPU kernel recomputes its forward chain) and
// the cotangent d_out [P, E] f32:
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
// per sample. Here every product is a dense tile product on the shared GEMM
// core (csrc/gemm_core.cuh: mma.sync, ldmatrix, a cp.async ring), its
// operands read with 16-byte copies from bf16 scratch, and every sum over P
// or over tiles runs in a fixed order without atomics. Per chunk of images
// (the wrapper sizes the chunk and runs K1's projection launch first):
//   1. bwd_u_kernel (streaming, a warp a row of P): u_s = bf16(lerp(h_s))
//      to a scratch for each non-identity scale (the identity scale's u is
//      h_0, read in place), and d_att_s, d_out read once for all scales;
//   2. bwd_act_kernel (core, M = P, N = H, K = E): a_s = bf16(relu(u_s·W1
//      + b1)) to a scratch, and each 128-wide N tile's partial logits;
//   (passes 1 and 2 are K1's u and logit passes, expert_fusion_passes.cuh,
//   with d_att and a_s kept: K2's logits are K1's, bit for bit)
//   3. bwd_row_kernel (streaming, 64 rows a block): the logits summed in
//      tile order, the softmax over scales and its backward, bf16(att32)
//      for pass 4, bf16(dz_a) over a_s in place, the tile's dw2/db1 sums;
//   4. bwd_du_kernel (core, M = P, N = E, K = H, W1 as stored):
//      att·d_out + bf16(dz_a)·W1ᵀ; at the identity scale the epilogue
//      masks by h_0 > 0, writes bf16(dz_h_0) and the tile's dbp column
//      sums, at the others it writes bf16(d_u) (what Gᵀ reads);
//   5. bwd_tlerp_kernel (streaming, banded): d_h_s = Gᵀ·bf16(d_u) over the
//      ≤ 2r + 1 destination rows that read each source row, from a table
//      built in Python (ops/expert_fusion.py, transposed_lerp_plan): 8
//      source rows a block (one a warp), 256 columns a block (8 a lane, in
//      16-byte vectors), the destination rows staged in shared memory in
//      windows of 128 so that each is read about once, p summed in
//      increasing order; then the mask h_s > 0, bf16(dz_h_s) and the
//      block's dbp sums;
//   6. bwd_dx_kernel (core, M = P_s, N = D_s, K = E): bf16(dz_h)·Wpᵀ;
//   7. bwd_wgrad_kernel (core, A M-contiguous): dW1 = Σ_s u_sᵀ·bf16(dz_a)
//      (K = S·P, one accumulation over all scales) and dWp_s =
//      x_sᵀ·bf16(dz_h_s) (K = P_s);
//   8. bwd_reduce_kernel: the partial sums of db1, dw2 and dbp in tile
//      order.
// Scratch a flagship image: h 6.4 MB, u and bf16(d_u) 14.5 MB each, a/dz_a
// 9.6 MB, bf16(dz_h) 6.4 MB, the per-tile sums 0.9 MB (≈52 MB; the
// f32 d_u the single-pass design kept was 38.5 MB an image).
// A block reads idx[b] itself; an out-of-range id writes NaN to that
// sample's outputs only.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (medmoe_torch/ops/_build.py).

#include "expert_fusion_passes.cuh"

#define ROW_TM 64     // rows of P a block of the row step
#define T_ROWS 8      // source rows a block of the transposed upsample, one a warp
#define T_COLS 256    // columns a block of the transposed upsample, 8 a lane
#define T_WIN 128     // destination rows the transposed upsample stages at once

// the products' tiles: 128 × 128, 8 warps of 64 × 32, a 4-slice ring
// (ActTile, u · W1: expert_fusion_passes.cuh)
using NkTile = gemm::Tile<128, 128, 64, 32, 4, gemm::kNK>;              // · W1ᵀ, · Wpᵀ
using WgTile = gemm::Tile<128, 128, 64, 32, 4, gemm::kKN, gemm::kKM>;   // xᵀ · dz

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
  int dx_start[MAX_SCALES + 1];   // pass 6 tiles, scale by scale
  int wg_start[MAX_SCALES + 2];   // pass 7 tiles: dW1, then dWp scale by scale
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
  float* lpart;                   // [B, S, ⌈H/128⌉, P] scratch: partial logits
  float* att;                     // [B, S, P] scratch: bf16(att32)
  float* row_part;                // [B, ⌈P/64⌉, 2, H] scratch: partial dw2, db1
  int P_out, K, E, H;
};

__device__ __forceinline__ void store4_bf16(bf16* dst, float4 v) {
  __align__(8) __nv_bfloat162 o[2] = {__floats2bfloat162_rn(v.x, v.y),
                                      __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(o);
}

// ---------------------------------------------------------------------------
// pass 1: u_s to scratch (P_s < P) and d_att_s; a warp a row, grid (⌈P/8⌉, B)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) bwd_u_kernel(BwdArgs a) { u_rows<true>(a); }

// ---------------------------------------------------------------------------
// pass 2: a_s = bf16(relu(u_s·W1 + b1)) and partial logits; grid (M tiles ×
// N tiles, S, B)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(gemm::kThreads, ActTile::MIN_BLOCKS) bwd_act_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  act_tile<true>(a, smem);
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
  const int tiles_n = cdiv(H, ActTile::BN);

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
// pass 4: d_u = att·d_out + bf16(dz_a)·W1ᵀ; grid (M tiles × N tiles, S, B)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(gemm::kThreads, NkTile::MIN_BLOCKS) bwd_du_kernel(BwdArgs a) {
  using Cfg = NkTile;
  extern __shared__ __align__(128) unsigned char smem[];
  const int E = a.E, H = a.H, P = a.P_out, S = a.n_scales;
  const int tiles_n = cdiv(E, Cfg::BN);
  const int mt = blockIdx.x / tiles_n, m0 = mt * Cfg::BM, n0 = (blockIdx.x % tiles_n) * Cfg::BN;
  const int s = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int e = a.idx[b];
  if (bad_expert(a, e)) return;
  const bf16* dz = a.act[s] + (size_t)b * P * H;
  const bf16* w1 = a.w1 + (size_t)e * E * H;

  auto load_a = [&](bf16* as, int k0) {  // bf16(dz_a) rows m0.., H contiguous
    for (int v = tid; v < Cfg::BM * (gemm::BK / 8); v += gemm::kThreads) {
      const int r = v >> 2, c = (v & 3) * 8, m = m0 + r, k = k0 + c;
      const bool ok = m < P && k < H;
      gemm::cp16(as + r * gemm::LDK + c, ok ? dz + (size_t)m * H + k : dz, ok);
    }
  };
  auto load_b = [&](bf16* bs, int k0) {  // W1 rows n0.. as stored: K-contiguous
    for (int v = tid; v < Cfg::BN * (gemm::BK / 8); v += gemm::kThreads) {
      const int n = v >> 2, c = (v & 3) * 8, k = k0 + c;
      const bool ok = n0 + n < E && k < H;
      gemm::cp16(bs + n * gemm::LDK + c, ok ? w1 + (size_t)(n0 + n) * H + k : w1, ok);
    }
  };
  float acc[Cfg::MI][Cfg::NI][4];
  gemm::mainloop<Cfg>(smem, H, load_a, load_b, acc);
  float* cs = reinterpret_cast<float*>(smem);
  gemm::store_tile<Cfg>(cs, acc);

  const bool ident = a.P[s] == P;
  const float* att = a.att + ((size_t)b * S + s) * P;
  const float* dout = a.dout + (size_t)b * P * E;
  const bf16* hs = a.h[s] + (size_t)b * P * E;
  bf16* dst = (ident ? a.dzh[s] : a.du[s]) + (size_t)b * P * E;
  for (int v = tid; v < Cfg::BM * (Cfg::BN / 4); v += gemm::kThreads) {
    const int r = v / (Cfg::BN / 4), c = (v % (Cfg::BN / 4)) * 4, m = m0 + r, n = n0 + c;
    float* cv = cs + r * Cfg::LDC + c;
    if (m >= P || n >= E) {
      *reinterpret_cast<float4*>(cv) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    const float at = att[m];
    const float4 g = *reinterpret_cast<const float4*>(dout + (size_t)m * E + n);
    float4 o = make_float4(__fadd_rn(__fmul_rn(at, g.x), cv[0]), __fadd_rn(__fmul_rn(at, g.y), cv[1]),
                           __fadd_rn(__fmul_rn(at, g.z), cv[2]), __fadd_rn(__fmul_rn(at, g.w), cv[3]));
    if (ident) {  // dz_h_0 = [h_0 > 0]·d_u, kept in f32 for the dbp sums
      const uint2 hv = *reinterpret_cast<const uint2*>(hs + (size_t)m * E + n);
      const bf16* hb = reinterpret_cast<const bf16*>(&hv);
      o.x = __bfloat162float(hb[0]) > 0.0f ? o.x : 0.0f;
      o.y = __bfloat162float(hb[1]) > 0.0f ? o.y : 0.0f;
      o.z = __bfloat162float(hb[2]) > 0.0f ? o.z : 0.0f;
      o.w = __bfloat162float(hb[3]) > 0.0f ? o.w : 0.0f;
      *reinterpret_cast<float4*>(cv) = o;
    }
    store4_bf16(dst + (size_t)m * E + n, o);
  }
  if (!ident) return;
  __syncthreads();
  if (tid < Cfg::BN && n0 + tid < E) {  // the tile's column sums, rows in order
    float sum = 0.0f;
    for (int r = 0; r < Cfg::BM; ++r) sum += cs[r * Cfg::LDC + tid];
    a.dbp_part[s][((size_t)b * a.n_part[s] + mt) * E + n0 + tid] = sum;
  }
}

// ---------------------------------------------------------------------------
// pass 5: dz_h_s = [h_s > 0]·Gᵀ·bf16(d_u_s), banded; grid (Σ_s blocks, B)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) bwd_tlerp_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* win = reinterpret_cast<bf16*>(smem);     // [T_WIN][T_COLS]
  float* red = reinterpret_cast<float*>(smem);   // [T_ROWS][T_COLS], after the last window
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int t = blockIdx.x, s = 0;
  while (s + 1 < a.n_scales && t >= a.t_blk[s + 1]) ++s;
  t -= a.t_blk[s];
  const int E = a.E, P = a.P_out, Ps = a.P[s];
  const int n_cc = cdiv(E, T_COLS), cc = t % n_cc, rb = t / n_cc, c0 = cc * T_COLS;
  if (bad_expert(a, a.idx[b])) return;
  const int i_lo = rb * T_ROWS, i_hi = i_lo + T_ROWS < Ps ? i_lo + T_ROWS : Ps;
  const int* st = a.t_start[s];
  const int* tr = a.t_row[s];
  const float* tw = a.t_w[s];
  // the union of the block's bands (each source row's entries increase in p)
  int p_lo = P, p_hi = 0;
  for (int i = i_lo; i < i_hi; ++i)
    if (st[i + 1] > st[i]) {
      p_lo = min(p_lo, tr[st[i]]);
      p_hi = max(p_hi, tr[st[i + 1] - 1] + 1);
    }
  const int i = i_lo + warp;
  const bool live = i < i_hi;
  int k = live ? st[i] : 0;
  const int k_end = live ? st[i + 1] : 0;
  const bf16* du = a.du[s] + (size_t)b * P * E;
  float acc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = 0.0f;

  for (int w0 = p_lo; w0 < p_hi; w0 += T_WIN) {
    const int nrow = p_hi - w0 < T_WIN ? p_hi - w0 : T_WIN;
    for (int v = tid; v < nrow * (T_COLS / 8); v += THREADS) {
      const int r = v / (T_COLS / 8), cv = (v % (T_COLS / 8)) * 8;
      const bool ok = c0 + cv < E;
      gemm::cp16(win + r * T_COLS + cv, ok ? du + (size_t)(w0 + r) * E + c0 + cv : du, ok);
    }
    gemm::commit();
    gemm::wait<0>();
    __syncthreads();
    for (; k < k_end && tr[k] < w0 + nrow; ++k) {
      float v[8];
      load8_bf16(win + (tr[k] - w0) * T_COLS + lane * 8, v);
      const float wt = tw[k];
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[q] += wt * v[q];
    }
    __syncthreads();
  }

  const int c = c0 + lane * 8;
  if (live && c < E) {
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
  for (int q = 0; q < 8; ++q) red[warp * T_COLS + lane * 8 + q] = acc[q];
  __syncthreads();
  if (c0 + tid < E) {  // the block's column sums, source rows in order
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < T_ROWS; ++w) sum += red[w * T_COLS + tid];
    a.dbp_part[s][((size_t)b * a.n_part[s] + rb) * E + c0 + tid] = sum;
  }
}

// ---------------------------------------------------------------------------
// pass 6: d_x_s = bf16(dz_h_s)·Wp[e]ᵀ; grid (Σ_s tiles, B)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(gemm::kThreads, NkTile::MIN_BLOCKS) bwd_dx_kernel(BwdArgs a) {
  using Cfg = NkTile;
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.y, tid = threadIdx.x;
  int t = blockIdx.x, s = 0;
  while (s + 1 < a.n_scales && t >= a.dx_start[s + 1]) ++s;
  t -= a.dx_start[s];
  const int E = a.E, Ps = a.P[s], D = a.D[s];
  const int tiles_n = cdiv(D, Cfg::BN);
  const int m0 = (t / tiles_n) * Cfg::BM, n0 = (t % tiles_n) * Cfg::BN;
  const int e = a.idx[b];
  bf16* dx = a.dx[s] + (size_t)b * Ps * D;
  if (bad_expert(a, e)) {  // out-of-range expert id: poison this tile of d_x
    for (int v = tid; v < Cfg::BM * Cfg::BN; v += gemm::kThreads) {
      const int m = m0 + v / Cfg::BN, n = n0 + v % Cfg::BN;
      if (m < Ps && n < D) dx[(size_t)m * D + n] = __float2bfloat16_rn(nan_f());
    }
    return;
  }
  const bf16* dz = a.dzh[s] + (size_t)b * Ps * E;
  const bf16* w = a.wp[s] + (size_t)e * D * E;
  auto load_a = [&](bf16* as, int k0) {  // bf16(dz_h) rows m0.., E contiguous
    for (int v = tid; v < Cfg::BM * (gemm::BK / 8); v += gemm::kThreads) {
      const int r = v >> 2, c = (v & 3) * 8, m = m0 + r, k = k0 + c;
      const bool ok = m < Ps && k < E;
      gemm::cp16(as + r * gemm::LDK + c, ok ? dz + (size_t)m * E + k : dz, ok);
    }
  };
  auto load_b = [&](bf16* bs, int k0) {  // Wp rows n0.. as stored: K-contiguous
    for (int v = tid; v < Cfg::BN * (gemm::BK / 8); v += gemm::kThreads) {
      const int n = v >> 2, c = (v & 3) * 8, k = k0 + c;
      const bool ok = n0 + n < D && k < E;
      gemm::cp16(bs + n * gemm::LDK + c, ok ? w + (size_t)(n0 + n) * E + k : w, ok);
    }
  };
  float acc[Cfg::MI][Cfg::NI][4];
  gemm::mainloop<Cfg>(smem, E, load_a, load_b, acc);
  float* cs = reinterpret_cast<float*>(smem);
  gemm::store_tile<Cfg>(cs, acc);
  for (int v = tid; v < Cfg::BM * (Cfg::BN / 8); v += gemm::kThreads) {
    const int r = v / (Cfg::BN / 8), c = (v % (Cfg::BN / 8)) * 8, m = m0 + r, n = n0 + c;
    if (m < Ps && n < D) store8_bf16(dx + (size_t)m * D + n, cs + r * Cfg::LDC + c);
  }
}

// ---------------------------------------------------------------------------
// pass 7: C = Aᵀ·B with A and B row-major over K; grid (Σ jobs' tiles, B)
//   dW1   = Σ_s u_sᵀ·bf16(dz_a_s)   (M = E, N = H, K = S·P, each scale's
//                                    K padded to a whole slice)
//   dWp_s = x_sᵀ·bf16(dz_h_s)      (M = D_s, N = E, K = P_s)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(gemm::kThreads, WgTile::MIN_BLOCKS) bwd_wgrad_kernel(BwdArgs a) {
  using Cfg = WgTile;
  extern __shared__ __align__(128) unsigned char smem[];
  const int E = a.E, H = a.H, P = a.P_out, S = a.n_scales;
  const int b = blockIdx.y, tid = threadIdx.x;
  int t = blockIdx.x, job = 0;  // 0: dW1; 1 + s: dWp of scale s
  while (job + 1 <= S && t >= a.wg_start[job + 1]) ++job;
  t -= a.wg_start[job];
  const int M = job == 0 ? E : a.D[job - 1];
  const int N = job == 0 ? H : E;
  float* out = job == 0 ? a.dw1 + (size_t)b * E * H : a.dwp[job - 1] + (size_t)b * M * E;
  const int tiles_n = cdiv(N, Cfg::BN);
  const int m0 = (t / tiles_n) * Cfg::BM, n0 = (t % tiles_n) * Cfg::BN;
  const int e = a.idx[b];
  if (bad_expert(a, e)) {
    for (int v = tid; v < Cfg::BM * (Cfg::BN / 4); v += gemm::kThreads) {
      const int m = m0 + v / (Cfg::BN / 4), n = n0 + (v % (Cfg::BN / 4)) * 4;
      if (m < M && n < N)
        *reinterpret_cast<float4*>(out + (size_t)m * N + n) = make_float4(nan_f(), nan_f(), nan_f(), nan_f());
    }
    return;
  }
  const int kpad = (P + gemm::BK - 1) / gemm::BK * gemm::BK;  // dW1: K of a scale
  const int Kd = job == 0 ? S * kpad : a.P[job - 1];

  // A [k][m] and B [k][n], both read along their rows: the source rows of
  // slice k0 (one scale's, for dW1) and how many of them there are
  auto rows_of = [&](int k0, const bf16*& asrc, const bf16*& bsrc, int& p0, int& np) {
    if (job == 0) {
      const int s = k0 / kpad;
      p0 = k0 - s * kpad;
      np = P;
      asrc = a.u[s] + (size_t)b * P * E;
      bsrc = a.act[s] + (size_t)b * P * H;
    } else {
      const int s = job - 1;
      p0 = k0;
      np = a.P[s];
      asrc = a.x[s] + (size_t)b * np * M;
      bsrc = a.dzh[s] + (size_t)b * np * E;
    }
  };
  auto load_a = [&](bf16* as, int k0) {
    const bf16* src;
    const bf16* unused;
    int p0, np;
    rows_of(k0, src, unused, p0, np);
    for (int v = tid; v < gemm::BK * (Cfg::BM / 8); v += gemm::kThreads) {
      const int kr = v / (Cfg::BM / 8), c = (v % (Cfg::BM / 8)) * 8, p = p0 + kr;
      const bool ok = p < np && m0 + c < M;
      gemm::cp16(as + kr * Cfg::LDM + c, ok ? src + (size_t)p * M + m0 + c : src, ok);
    }
  };
  auto load_b = [&](bf16* bs, int k0) {
    const bf16* unused;
    const bf16* src;
    int p0, np;
    rows_of(k0, unused, src, p0, np);
    for (int v = tid; v < gemm::BK * (Cfg::BN / 8); v += gemm::kThreads) {
      const int kr = v / (Cfg::BN / 8), c = (v % (Cfg::BN / 8)) * 8, p = p0 + kr;
      const bool ok = p < np && n0 + c < N;
      gemm::cp16(bs + kr * Cfg::LDN + c, ok ? src + (size_t)p * N + n0 + c : src, ok);
    }
  };
  float acc[Cfg::MI][Cfg::NI][4];
  gemm::mainloop<Cfg>(smem, Kd, load_a, load_b, acc);
  float* cs = reinterpret_cast<float*>(smem);
  gemm::store_tile<Cfg>(cs, acc);
  for (int v = tid; v < Cfg::BM * (Cfg::BN / 4); v += gemm::kThreads) {
    const int r = v / (Cfg::BN / 4), c = (v % (Cfg::BN / 4)) * 4, m = m0 + r, n = n0 + c;
    if (m < M && n < N)
      *reinterpret_cast<float4*>(out + (size_t)m * N + n) =
          *reinterpret_cast<const float4*>(cs + r * Cfg::LDC + c);
  }
}

// ---------------------------------------------------------------------------
// pass 8: per sample, the per-tile partial sums in tile order
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) bwd_reduce_kernel(BwdArgs a) {
  const int b = blockIdx.x;
  const bool bad = bad_expert(a, a.idx[b]);
  const int E = a.E, H = a.H;
  const int T = cdiv(a.P_out, ROW_TM);
  for (int c = threadIdx.x; c < H; c += THREADS) {
    float s2 = 0.0f, s1 = 0.0f;
    for (int t = 0; t < T && !bad; ++t) {
      const float* part = a.row_part + ((size_t)b * T + t) * 2 * H;
      s2 += part[c];
      s1 += part[H + c];
    }
    a.dw2[(size_t)b * H + c] = bad ? nan_f() : s2;
    a.db1[(size_t)b * H + c] = bad ? nan_f() : s1;
  }
  for (int s = 0; s < a.n_scales; ++s) {
    const int Ts = a.n_part[s];
    for (int c = threadIdx.x; c < E; c += THREADS) {
      float sum = 0.0f;
      for (int t = 0; t < Ts && !bad; ++t) sum += a.dbp_part[s][((size_t)b * Ts + t) * E + c];
      a.dbp[s][(size_t)b * E + c] = bad ? nan_f() : sum;
    }
  }
}

template <class Kernel>
static cudaError_t launch(Kernel k, dim3 grid, int smem, cudaStream_t st, const BwdArgs& a) {
  if (grid.x == 0) return cudaSuccess;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  k<<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

extern "C" {

// K2 for a chunk of B images, after K1's projection launch has written hs.
// parts[0..MAX_SCALES+1]: the partial-sum rows an image the caller's scratch
// holds, dbp_parts' of each scale, then lpart's logit tiles, then row_part's
// row-step tiles; fewer than these tiles write is rejected.
// Returns a cudaError_t: 0 when every launch was accepted.
int medmoe_expert_fusion_bwd(int n_scales, const void* const* xs, const void* const* wps,
                             const void* const* hs, void* const* us, void* const* dus,
                             void* const* acts, void* const* dzhs, void* const* dxs,
                             void* const* dwps, void* const* dbps, void* const* dbp_parts,
                             const void* const* t_starts, const void* const* t_rows,
                             const void* const* t_ws, const int* Ps, const int* Ds,
                             const int* parts, const void* w1, const void* b1, const void* w2,
                             const void* idx, const void* dout, void* dw1, void* db1, void* dw2,
                             void* datt, void* lpart, void* att, void* row_part, int B, int K,
                             int E, int H, int P, void* stream) {
  if (n_scales < 1 || n_scales > MAX_SCALES || E % 8 || H % 8 || H / 8 > THREADS || B < 1 ||
      B > 65535 || parts[MAX_SCALES] < cdiv(H, ActTile::BN) ||
      parts[MAX_SCALES + 1] < cdiv(P, ROW_TM))
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  int t_blk = 0, dx_tiles = 0;
  a.wg_start[0] = 0;
  a.wg_start[1] = cdiv(E, WgTile::BM) * cdiv(H, WgTile::BN);
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
    a.n_part[s] = ident ? cdiv(P, NkTile::BM) : cdiv(Ps[s], T_ROWS);
    if (parts[s] < a.n_part[s]) return (int)cudaErrorInvalidValue;
    a.t_blk[s] = t_blk;
    if (!ident) t_blk += cdiv(Ps[s], T_ROWS) * cdiv(E, T_COLS);
    a.dx_start[s] = dx_tiles;
    dx_tiles += cdiv(Ps[s], NkTile::BM) * cdiv(Ds[s], NkTile::BN);
    a.wg_start[s + 2] = a.wg_start[s + 1] + cdiv(Ds[s], WgTile::BM) * cdiv(E, WgTile::BN);
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
  a.K = K;
  a.E = E;
  a.H = H;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = n_scales;
  cudaError_t err;
  if ((err = launch(bwd_u_kernel, dim3(cdiv(P, 8), B), 0, st, a)) != cudaSuccess) return (int)err;
  if ((err = launch(bwd_act_kernel, dim3(cdiv(P, ActTile::BM) * cdiv(H, ActTile::BN), S, B),
                    ActTile::SMEM, st, a)) != cudaSuccess)
    return (int)err;
  if ((err = launch(bwd_row_kernel, dim3(cdiv(P, ROW_TM), B), 0, st, a)) != cudaSuccess)
    return (int)err;
  if ((err = launch(bwd_du_kernel, dim3(cdiv(P, NkTile::BM) * cdiv(E, NkTile::BN), S, B),
                    NkTile::SMEM, st, a)) != cudaSuccess)
    return (int)err;
  if ((err = launch(bwd_tlerp_kernel, dim3(t_blk, B), T_WIN * T_COLS * 2, st, a)) != cudaSuccess)
    return (int)err;
  if ((err = launch(bwd_dx_kernel, dim3(dx_tiles, B), NkTile::SMEM, st, a)) != cudaSuccess)
    return (int)err;
  if ((err = launch(bwd_wgrad_kernel, dim3(a.wg_start[n_scales + 1], B), WgTile::SMEM, st, a)) !=
      cudaSuccess)
    return (int)err;
  return (int)launch(bwd_reduce_kernel, dim3(B), 0, st, a);
}

const char* medmoe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
