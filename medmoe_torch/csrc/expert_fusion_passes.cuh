// The expert branch's forward chain, shared by the forward K1
// (expert_fusion.cu) and the recompute of it in the backward K2
// (expert_fusion_bwd.cu), so that K2 differentiates the forward K1 took: the
// same u, the same partial logits, summed in the same order.
//
//   u pass (u_rows): u_s = bf16(lerp of two h_s rows) to a scratch for each
//     scale with P_s < P (the identity scale's u is h_0, read in place), a
//     warp a row of P, 8 columns a lane; with kDatt also d_att_s = Σ_E
//     d_out·u_s (K2), d_out read once for all scales;
//   logit pass (act_tile): the attention MLP as a product on the GEMM core
//     (gemm_core.cuh), M = P, N = H, K = E, W1 as stored; the epilogue
//     forms bf16(relu(acc + b1)), two threads a row, 64 columns each in
//     order, the halves added after, and writes each 128-wide N tile's
//     partial logit Σ bf16(relu(·))·w2; with kKeepAct also a_s itself
//     (K2). The logits are the tiles' partials summed in tile order (K1's
//     combine, K2's row step).
//
// Args is the caller's argument struct; the passes read its fields h, u,
// P, n_scales, P_out, E, H, K, idx, w1, b1, w2 and lpart, and with the flags
// dout, datt and act.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_core.cuh"

typedef __nv_bfloat16 bf16;

#define MAX_SCALES 4
#define THREADS 256

// the logit product's tiles: 128 × 128, 8 warps of 64 × 32, a 4-slice ring
using ActTile = gemm::Tile<128, 128, 64, 32, 4, gemm::kKN>;

static __host__ __device__ __forceinline__ int cdiv(int n, int m) { return (n + m - 1) / m; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

template <class Args>
__device__ __forceinline__ bool bad_expert(const Args& a, int e) {
  return e < 0 || e >= a.K;
}

// Source rows and weight of output row p of a P_s → P linear upsample with
// integer ratio: the phase form of medmoe_tpu's interp_patches (offsets and
// weights in double, as numpy computes them, then the weight in f32). Once
// a row, not per element.
__device__ __forceinline__ void lerp_rows(int p, int Ps, int P, int& i0, int& i1, float& w) {
  const int r = P / Ps;
  const int q = p / r, ph = p - q * r;
  const double off = ((double)ph + 0.5) / (double)r - 0.5;
  const double c = floor(off);
  w = (float)(off - c);
  if (c < 0.0) {
    i0 = q > 0 ? q - 1 : 0;
    i1 = q;
  } else {
    i0 = q;
    i1 = q + 1 < Ps ? q + 1 : Ps - 1;
  }
}

// x0·(1-w) + x1·w in f32, two roundings and no fused multiply-add, as the
// JAX package's XLA path computes it
__device__ __forceinline__ float lerp(float x0, float x1, float w) {
  return __fadd_rn(__fmul_rn(x0, __fsub_rn(1.0f, w)), __fmul_rn(x1, w));
}

__device__ __forceinline__ void load8_bf16(const bf16* __restrict__ src, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int q = 0; q < 8; ++q) f[q] = __bfloat162float(e[q]);
}

__device__ __forceinline__ void store8_bf16(bf16* dst, const float* f) {
  __align__(16) bf16 o[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) o[q] = __float2bfloat16_rn(f[q]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The u pass for row p = blockIdx.x·8 + warp of sample b = blockIdx.y; grid
// (⌈P/8⌉, B), 256 threads.
template <bool kDatt, class Args>
__device__ __forceinline__ void u_rows(const Args& a) {
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = a.P_out, E = a.E, S = a.n_scales;
  const int p = blockIdx.x * 8 + warp;
  if (p >= P || bad_expert(a, a.idx[b])) return;
  int i0[MAX_SCALES], i1[MAX_SCALES];
  float w[MAX_SCALES], acc[MAX_SCALES];
#pragma unroll
  for (int s = 0; s < MAX_SCALES; ++s) {
    i0[s] = i1[s] = p;
    w[s] = acc[s] = 0.0f;
    if (s < S && a.P[s] != P) lerp_rows(p, a.P[s], P, i0[s], i1[s], w[s]);
  }
  for (int c = lane * 8; c < E; c += 256) {
    float g[8];
    if constexpr (kDatt) {
      const float* d = a.dout + ((size_t)b * P + p) * E;
      const float4 g0 = *reinterpret_cast<const float4*>(d + c);
      const float4 g1 = *reinterpret_cast<const float4*>(d + c + 4);
      g[0] = g0.x, g[1] = g0.y, g[2] = g0.z, g[3] = g0.w;
      g[4] = g1.x, g[5] = g1.y, g[6] = g1.z, g[7] = g1.w;
    }
#pragma unroll
    for (int s = 0; s < MAX_SCALES; ++s) {
      if (s >= S) break;
      const int Ps = a.P[s];
      if (!kDatt && Ps == P) continue;  // the identity scale's u is h_0
      const bf16* hs = a.h[s] + (size_t)b * Ps * E;
      float u[8];
      load8_bf16(hs + (size_t)i0[s] * E + c, u);
      if (Ps != P) {
        float x1[8];
        load8_bf16(hs + (size_t)i1[s] * E + c, x1);
#pragma unroll
        for (int q = 0; q < 8; ++q) u[q] = round_bf16(lerp(u[q], x1[q], w[s]));
        store8_bf16(a.u[s] + ((size_t)b * P + p) * E + c, u);
      }
      if constexpr (kDatt) {
        float part = 0.0f;
#pragma unroll
        for (int q = 0; q < 8; ++q) part += g[q] * u[q];
        acc[s] += part;
      }
    }
  }
  if constexpr (kDatt) {
#pragma unroll
    for (int s = 0; s < MAX_SCALES; ++s) {
      if (s >= S) break;
      const float v = warp_sum(acc[s]);
      if (lane == 0) a.datt[((size_t)b * S + s) * P + p] = v;
    }
  }
}

// The logit pass for one tile; grid (M tiles × N tiles, S, B), 256 threads,
// ActTile::SMEM bytes of dynamic shared memory.
template <bool kKeepAct, class Args>
__device__ __forceinline__ void act_tile(const Args& a, unsigned char* smem) {
  using Cfg = ActTile;
  const int E = a.E, H = a.H, P = a.P_out, S = a.n_scales;
  const int tiles_n = cdiv(H, Cfg::BN);
  const int nt = blockIdx.x % tiles_n, m0 = (blockIdx.x / tiles_n) * Cfg::BM, n0 = nt * Cfg::BN;
  const int s = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int e = a.idx[b];
  if (bad_expert(a, e)) return;
  const bf16* u = a.u[s] + (size_t)b * P * E;
  const bf16* w1 = a.w1 + (size_t)e * E * H;

  auto load_a = [&](bf16* as, int k0) {  // u rows m0.., E contiguous
    for (int v = tid; v < Cfg::BM * (gemm::BK / 8); v += gemm::kThreads) {
      const int r = v >> 2, c = (v & 3) * 8, m = m0 + r, k = k0 + c;
      const bool ok = m < P && k < E;
      gemm::cp16(as + r * gemm::LDK + c, ok ? u + (size_t)m * E + k : u, ok);
    }
  };
  auto load_b = [&](bf16* bs, int k0) {  // W1 rows k0.., H contiguous
    for (int v = tid; v < gemm::BK * (Cfg::BN / 8); v += gemm::kThreads) {
      const int kr = v / (Cfg::BN / 8), n = (v % (Cfg::BN / 8)) * 8, k = k0 + kr;
      const bool ok = k < E && n0 + n < H;
      gemm::cp16(bs + kr * Cfg::LDN + n, ok ? w1 + (size_t)k * H + n0 + n : w1, ok);
    }
  };
  float acc[Cfg::MI][Cfg::NI][4];
  gemm::mainloop<Cfg>(smem, E, load_a, load_b, acc);
  float* cs = reinterpret_cast<float*>(smem);
  gemm::store_tile<Cfg>(cs, acc);

  // two threads a row, 64 columns each, in order; the halves added after
  const float* b1 = a.b1 + (size_t)e * H;
  const float* w2 = a.w2 + (size_t)e * H;
  const int r = tid >> 1, half = tid & 1, m = m0 + r;
  float sum = 0.0f;
  for (int c = half * (Cfg::BN / 2); c < (half + 1) * (Cfg::BN / 2) && n0 + c < H; c += 8) {
    const int n = n0 + c;
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float x = cs[r * Cfg::LDC + c + q] + b1[n + q];
      v[q] = round_bf16(x > 0.0f ? x : 0.0f);
      sum += v[q] * w2[n + q];
    }
    if constexpr (kKeepAct) {
      if (m < P) store8_bf16(a.act[s] + ((size_t)b * P + m) * H + n, v);
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (half == 0 && m < P) a.lpart[(((size_t)b * S + s) * tiles_n + nt) * P + m] = sum;
}
