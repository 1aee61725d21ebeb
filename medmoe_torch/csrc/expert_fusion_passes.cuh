// The expert branch's forward chain, shared by the forward K1
// (expert_fusion.cu) and the recompute of it in the backward K2
// (expert_fusion_bwd.cu), so that K2 differentiates the forward K1 took: the
// same u, the same partial logits, summed in the same order.
//
//   u pass (u_rows): u_s = bf16(lerp of two h_s rows) to a scratch for each
//     scale with P_s < P (the identity scale's u is h_0, read in place), a
//     warp a row of P, 8 columns a lane; with kDatt also d_att_s = Σ_E
//     d_out·u_s (K2), d_out read once for all scales;
//   logit pass (act_tiles): the attention MLP as a product on the wgmma
//     core (wgmma_core.cuh), M = P, N = H, K = E: A = u_s (E contiguous),
//     B = W1[e] as stored ([E, H], H contiguous), both through TMA, one
//     persistent block an SM over (image, scale, 128-row tile, 192-wide
//     tile of H); the epilogue forms bf16(relu(acc + b1)) in the
//     accumulators' registers (a_s staged in a ring stage and written by
//     TMA) and each tile's partial logit Σ
//     bf16(relu(·))·w2, a row's sum in a fixed order: each thread its 48
//     columns of the row in order (8-column blocks j, then the pair), then
//     the quad's four lanes in order; with kKeepAct also a_s itself (K2).
//     The logits are the tiles' partials summed in tile order (K1's
//     combine, K2's row step).
//
// Args is the caller's argument struct; the passes read its fields h, u,
// P, n_scales, P_out, B, E, H, K, idx, b1, w2 and lpart, and with the flags
// dout, datt and act.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_core.cuh"

typedef __nv_bfloat16 bf16;

#define MAX_SCALES 4
#define THREADS 256

// the logit product's tiles: 128 rows of P by kActBN columns of H (H = 384
// is two); the partial logits come one per such tile
constexpr int kActBN = 192;
constexpr int kBox128Bytes = wg::kBK * wg::kBox128 * 2;  // a [64][64] bf16 box, 8 KB
constexpr int kRowBox = wg::kBM * 128;  // a [128 rows][128 bytes] box, 16 KB: three a stage

// the logit product's tensor maps: u_s of each scale [B][P][E] (h_0 at
// the identity scale) as A, [128 p][64 e] boxes; the bank W1 [K][E][H] as
// B, [64 e][64 h] boxes; both 128-byte swizzled, zeros past every edge
struct ActMaps {
  CUtensorMap u[MAX_SCALES];
  CUtensorMap w1;
  CUtensorMap act[MAX_SCALES];  // K2's a_s [B][P][H], stored in [128 p][64 h] boxes
};

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

// The consumers' kActBN-wide accumulator tile as bf16 through an output
// stage (wg::reserve): [128 rows][64 columns] boxes, 128-byte swizzled, as
// the TMA store reads them, to `map` at (n0, m0, b) (rows and columns past
// the map's dims are not stored, nor boxes at or past n_end); one thread
// stores and hands the stage back for all eight warps once TMA has read it.
// That thread waits for its stores before it exits (tma_store_wait<0,
// false>).
__device__ __forceinline__ void store_tile_bf16(const wg::Smem& s, wg::Ring& ring,
                                                const float (&acc)[kActBN / 2],
                                                const CUtensorMap* map, int n0, int n_end, int m0,
                                                int b) {
  const int cw = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int q = lane & 3, r0 = cw * 64 + warp * 16 + (lane >> 2);
  unsigned char* o = const_cast<unsigned char*>(wg::acquire(s, ring));
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < kActBN / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + (j / 8) * kRowBox + wg::sw128(r0 + 8 * h, j % 8) +
                                         4 * q) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  wg::fence_proxy_async();
  wg::consumer_sync();
  if (threadIdx.x == 128) {
    const uint32_t src = wg::smem_u32(o);
#pragma unroll
    for (int c = 0; c < kActBN / 64; ++c)
      if (n0 + 64 * c < n_end) wg::tma_store(map, src + c * kRowBox, n0 + 64 * c, m0, b);
    wg::tma_store_commit();
    wg::tma_store_wait<0, true>();
    wg::mbar_arrive(&s.empty[ring.stage], wg::kConsumers / 32);
  }
  ring.advance();
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

// The logit pass: one persistent block an SM (wg::kThreads threads,
// wg::kSmemBytes of dynamic shared memory) over the tiles (image, scale,
// 128-row tile of P, kActBN-wide tile of H), the tiles of H fastest. The
// producer and the consumers skip the same tiles: those of an image whose
// expert id is out of range (the combine or the row step poisons it).
template <bool kKeepAct, class Args>
__device__ __forceinline__ void act_tiles(const ActMaps& maps, const Args& a,
                                          unsigned char* smem_raw) {
  const wg::Smem s = wg::carve(smem_raw);
  const int E = a.E, H = a.H, P = a.P_out, S = a.n_scales;
  const int n_nt = cdiv(H, kActBN), n_mt = cdiv(P, wg::kBM);
  const int tiles = a.B * S * n_mt * n_nt, nk = cdiv(E, wg::kBK);
  wg::init_barriers(s);

  if (threadIdx.x < 128) {
    // producer: A = u_s rows m0.., B = W1[e] rows k0.., three [64 k][64 h]
    // boxes side by side along H
    wg::reg_dealloc<wg::kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int sc = 0; sc < S; ++sc) wg::prefetch_map(&maps.u[sc]);
      wg::prefetch_map(&maps.w1);
      wg::Ring ring;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int nt = tile % n_nt, mt = (tile / n_nt) % n_mt;
        const int sc = (tile / (n_nt * n_mt)) % S, b = tile / (n_nt * n_mt * S);
        const int e = a.idx[b];
        if (bad_expert(a, e)) continue;
        for (int kb = 0; kb < nk; ++kb) {
          uint64_t* full = &s.full[ring.stage];
          wg::mbar_wait(&s.empty[ring.stage], ring.phase ^ 1u);
          wg::mbar_expect_tx(full, wg::kABytes + kActBN * wg::kBK * 2);
          wg::tma_load(wg::stage_a(s, ring.stage), &maps.u[sc], full, kb * wg::kBK,
                       mt * wg::kBM, b);
#pragma unroll
          for (int c = 0; c < kActBN / wg::kBox128; ++c)
            wg::tma_load(wg::stage_b(s, ring.stage) + c * kBox128Bytes, &maps.w1, full,
                         nt * kActBN + c * wg::kBox128, kb * wg::kBK, e);
          ring.advance();
        }
        if constexpr (kKeepAct) wg::reserve(s, ring);  // the a_s tile's stage
      }
    }
  } else {
    wg::reg_alloc<wg::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1, ci = threadIdx.x - 128;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31, q = lane & 3;
    wg::Ring ring;
    float acc[kActBN / 2];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int nt = tile % n_nt, mt = (tile / n_nt) % n_mt;
      const int sc = (tile / (n_nt * n_mt)) % S, b = tile / (n_nt * n_mt * S);
      const int e = a.idx[b];
      if (bad_expert(a, e)) continue;
      wg::consume<kActBN, 0, 1>(
          acc, s, ring, nk,
          [&](int st, int ks) { return wg::desc_k128(wg::stage_a(s, st) + cw * 8192, ks); },
          [&](int st, int ks) { return wg::desc_mn128(wg::stage_b(s, st), ks); });

      // this thread's rows m (h = 0, 1) and columns n0 + 8j + 2q + (0, 1):
      // bf16(relu(acc + b1)) over the accumulators (a_s, for K2's output
      // tile) and its part of the row's partial logit
      const float* __restrict__ b1 = a.b1 + (size_t)e * H;
      const float* __restrict__ w2 = a.w2 + (size_t)e * H;
      const int n0 = nt * kActBN;
      float part[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kActBN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * q;
        if (n >= H) continue;  // H % 8 == 0: both columns or neither
        const float2 bb = *reinterpret_cast<const float2*>(b1 + n);
        const float2 ww = *reinterpret_cast<const float2*>(w2 + n);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& x0 = acc[4 * j + 2 * h];
          float& x1 = acc[4 * j + 2 * h + 1];
          x0 += bb.x;
          x1 += bb.y;
          x0 = round_bf16(x0 > 0.0f ? x0 : 0.0f);
          x1 = round_bf16(x1 > 0.0f ? x1 : 0.0f);
          part[h] += x0 * ww.x;
          part[h] += x1 * ww.y;
        }
      }
      if constexpr (kKeepAct) store_tile_bf16(s, ring, acc, &maps.act[sc], n0, H, mt * wg::kBM, b);
      // the quad's lanes in order
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sum = 0.0f;
#pragma unroll
        for (int l = 0; l < 4; ++l) sum += __shfl_sync(0xffffffffu, part[h], (lane & ~3) + l);
        const int m = mt * wg::kBM + cw * 64 + warp * 16 + (lane >> 2) + 8 * h;
        if (q == 0 && m < P) a.lpart[(((size_t)b * S + sc) * n_nt + nt) * P + m] = sum;
      }
    }
    if (kKeepAct && ci == 0) wg::tma_store_wait<0, false>();  // store_tile_bf16's
  }
}

// The logit product's tensor maps for a chunk of B images: u[s] [B][P][E]
// bf16 for each of the S scales, a_s act[s] [B][P][H] when given (K2), and
// the bank w1 [K][E][H]. False when the encoder refuses one.
static bool act_maps(ActMaps* m, const bf16* const* u, bf16* const* act, int S, const bf16* w1,
                     int B, int K, int E, int H, int P) {
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  for (int s = 0; s < S; ++s)
    if (!tensor_map(&m->u[s], u[s], E, P, B, (uint64_t)E * 2, (uint64_t)P * E * 2, wg::kBK,
                    wg::kBM, sw) ||
        (act != nullptr && !tensor_map(&m->act[s], act[s], H, P, B, (uint64_t)H * 2,
                                       (uint64_t)P * H * 2, wg::kBox128, wg::kBM, sw)))
      return false;
  return tensor_map(&m->w1, w1, H, E, K, (uint64_t)H * 2, (uint64_t)E * H * 2, wg::kBox128,
                    wg::kBK, sw);
}

// Launch a persistent wgmma-core kernel: min(tiles, SMs) blocks of
// wg::kThreads, `smem` bytes of dynamic shared memory
template <class Kernel, class... Args>
static cudaError_t launch_persistent(Kernel k, int tiles, int smem, cudaStream_t st,
                                     const Args&... args) {
  if (tiles <= 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  k<<<tiles < sms ? tiles : sms, wg::kThreads, smem, st>>>(args...);
  return cudaGetLastError();
}
