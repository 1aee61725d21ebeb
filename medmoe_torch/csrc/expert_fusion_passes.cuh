// The expert branch's forward chain, shared by the forward K1
// (expert_fusion.cu) and the recompute of it in the backward K2
// (expert_fusion_bwd.cu), so that K2 differentiates the forward K1 took: the
// same h, the same u, the same partial logits, summed in the same order.
//
//   projection (proj_tiles): h_s = bf16(relu(x_s·Wp[e,s] + bp[e,s])) as a
//     product on the wgmma core (wgmma_core.cuh), M = P_s, N = E, K = D_s:
//     A = x_s (D_s contiguous; D_s = 96 ends inside a 64-deep stage and
//     the map's zeros fill the rest), B = Wp[e,s] as stored ([D_s, E], E
//     contiguous), both through TMA, one persistent block an SM over
//     (scale, image, row tile, 192-wide tile of E), the heaviest scales
//     first; the epilogue forms bf16(relu(acc + bp)) in the accumulators'
//     registers and stages the tile in a ring stage. K2 stores every
//     scale's tile by TMA (h_s); K1 (kU) stores the identity scale's (h_0
//     is u_0) and, at a lerped scale, writes u_s = bf16(lerp(h_s))
//     straight from the staged tile and never stores h_s: its row tiles
//     step 126 rows (proj_row_tiles), so that each tile owns the u rows of
//     its middle h rows and holds both of their source rows;
//   logit pass (act_tiles): the attention MLP as a product on the wgmma
//     core, M = P, N = H, K = E: A = u_s (E contiguous),
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
// act_tiles' Args is the caller's argument struct; it reads the fields
// n_scales, P_out, B, E, H, K, idx, b1, w2 and lpart.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_core.cuh"

typedef __nv_bfloat16 bf16;

#define MAX_SCALES 4
#define THREADS 256

// the projection's and the logit product's tiles: 128 rows by kActBN
// columns (of E, 768 being four; of H, 384 being two); the partial logits
// come one per logit tile
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

// Offset c (−1 or 0) and weight w of phase ph of a linear upsample with
// integer ratio r: the phase form of medmoe_tpu's interp_patches (offsets
// and weights in double, as numpy computes them, then the weight in f32).
__device__ __forceinline__ void lerp_phase(int ph, int r, int& c, float& w) {
  const double off = ((double)ph + 0.5) / (double)r - 0.5;
  const double f = floor(off);
  w = (float)(off - f);
  c = (int)f;
}

// Source rows i0, i1 of output row p = q·r + ph of a P_s → P upsample, from
// its phase's offset c
__device__ __forceinline__ void lerp_src(int q, int c, int Ps, int& i0, int& i1) {
  if (c < 0) {
    i0 = q > 0 ? q - 1 : 0;
    i1 = q;
  } else {
    i0 = q;
    i1 = q + 1 < Ps ? q + 1 : Ps - 1;
  }
}

// Source rows and weight of output row p of a P_s → P upsample with integer
// ratio. Once a row, not per element.
__device__ __forceinline__ void lerp_rows(int p, int Ps, int P, int& i0, int& i1, float& w) {
  const int r = P / Ps, q = p / r;
  int c;
  lerp_phase(p - q * r, r, c, w);
  lerp_src(q, c, Ps, i0, i1);
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

// the same, streaming past L2 (evict-first): for a map written once and
// read again only after it has left L2
__device__ __forceinline__ void store8_bf16_cs(bf16* dst, const float* f) {
  __align__(16) bf16 o[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) o[q] = __float2bfloat16_rn(f[q]);
  __stcs(reinterpret_cast<uint4*>(dst), *reinterpret_cast<const uint4*>(o));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The consumers' kActBN-wide accumulator tile as bf16 into an output stage
// `o`: [128 rows][64 columns] boxes, 128-byte swizzled, as the TMA store
// reads them (column 8j + c of row r at (j / 8)·kRowBox + sw128(r, j % 8)
// + 2c).
__device__ __forceinline__ void stage_tile_bf16(unsigned char* o,
                                                const float (&acc)[kActBN / 2]) {
  const int cw = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int q = lane & 3, r0 = cw * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < kActBN / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + (j / 8) * kRowBox + wg::sw128(r0 + 8 * h, j % 8) +
                                         4 * q) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// The tile through an output stage (wg::reserve) to `map` at (n0, m0, b)
// (rows and columns past the map's dims are not stored, nor boxes at or
// past n_end); one thread stores and hands the stage back for all eight
// warps once TMA has read it. That thread waits for its stores before it
// exits (tma_store_wait<0, false>).
__device__ __forceinline__ void store_tile_bf16(const wg::Smem& s, wg::Ring& ring,
                                                const float (&acc)[kActBN / 2],
                                                const CUtensorMap* map, int n0, int n_end, int m0,
                                                int b) {
  unsigned char* o = const_cast<unsigned char*>(wg::acquire(s, ring));
  stage_tile_bf16(o, acc);
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

// ---------------------------------------------------------------------------
// The projection
// ---------------------------------------------------------------------------

// K1's row tiles at a lerped scale step kUStride = 126 rows: tile mt holds
// the 128 h rows from mt·126 and owns rows [lo, hi) = [mt·126 + 1,
// mt·126 + 127) (from row 0 in the first tile, to P_s in the last). It
// writes the u rows p of its own rows q = p / r, [lo·r, hi·r): each reads
// h rows q − 1..q + 1 (lerp_rows), rows of the same tile, and each u row is
// written once. Elsewhere (K2, K1's identity scale) the tiles step 128
// rows and each owns its rows. ops/expert_fusion.py (proj_row_tiles)
// models the same tiles.
constexpr int kUStride = wg::kBM - 2;

static __host__ __device__ __forceinline__ int proj_row_tiles(int Ps, bool halo) {
  return halo ? (Ps > 1 ? cdiv(Ps - 1, kUStride) : 1) : cdiv(Ps, wg::kBM);
}

// the projection's tensor maps: x_s [B][P_s][D_s] as A, [128 p][64 d]
// boxes; the banks Wp_s [K][D_s][E] as B, [64 d][64 e] boxes; h_s
// [B][P_s][E] stored in [128 p][64 e] boxes (K1: the identity scales'
// only, into their u); each 128-byte swizzled, zeros past every edge
struct ProjMaps {
  CUtensorMap x[MAX_SCALES];
  CUtensorMap wp[MAX_SCALES];
  CUtensorMap h[MAX_SCALES];
};

struct ProjArgs {
  const float* bp[MAX_SCALES];     // [K, E], rounded through bf16
  bf16* u[MAX_SCALES];             // K1: u_s [B, P, E] at a lerped scale
  const int* idx;                  // [B]
  int P[MAX_SCALES];
  int D[MAX_SCALES];
  int halo[MAX_SCALES];            // 1: K1 at a lerped scale (tiles step 126 rows, u written)
  int order[MAX_SCALES];           // the walk's scales, the largest ratio P / P_s first
  int tile_start[MAX_SCALES + 1];  // the walk's tiles, scale by scale in walk order
  int n_scales, P_out, B, K, E;
};

// Write u_s = bf16(lerp(h_s)) for the rows tile mt owns, from its h tile
// staged in `o` (stage_tile_bf16): 8 threads a u row, thread k of them its
// 16-byte vectors k, k + 8 and k + 16 (one in each [128][64] box of the
// stage), 32 rows at once, each row's source rows and weight worked out
// once for its three vectors, stepping from row to row without a divide;
// u streams past L2. Every value is the one K2's u pass computes from
// stored h_s (lerp_phase, lerp).
__device__ __forceinline__ void u_from_tile(const unsigned char* o, const ProjArgs& a, int sc,
                                            int b, int mt, int n0) {
  const int Ps = a.P[sc], P = a.P_out, r = P / Ps, E = a.E;
  const int m0 = mt * kUStride, lo = mt == 0 ? 0 : m0 + 1;
  const int end = (m0 + kUStride + 1 < Ps ? m0 + kUStride + 1 : Ps) * r;
  const int vpr = (E - n0 < kActBN ? E - n0 : kActBN) / 8;  // 16-byte vectors of a row
  const int k = threadIdx.x & 7, dq = 32 / r, dph = 32 - dq * r;
  int p = lo * r + (threadIdx.x - 128) / 8, q = p / r, ph = p - q * r;
  bf16* u = a.u[sc] + (size_t)b * P * E + n0 + 8 * k;
  for (; p < end; p += 32) {
    int c, i0, i1;
    float w;
    lerp_phase(ph, r, c, w);
    lerp_src(q, c, Ps, i0, i1);
#pragma unroll
    for (int j = 0; j < kActBN / 64; ++j) {
      if (k + 8 * j >= vpr) break;
      const uint4 v0 = *reinterpret_cast<const uint4*>(o + j * kRowBox + wg::sw128(i0 - m0, k));
      const uint4 v1 = *reinterpret_cast<const uint4*>(o + j * kRowBox + wg::sw128(i1 - m0, k));
      const bf16* x0 = reinterpret_cast<const bf16*>(&v0);
      const bf16* x1 = reinterpret_cast<const bf16*>(&v1);
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = lerp(__bfloat162float(x0[e]), __bfloat162float(x1[e]), w);
      store8_bf16_cs(u + (size_t)p * E + 64 * j, f);
    }
    q += dq;
    ph += dph;
    if (ph >= r) {
      ph -= r;
      ++q;
    }
  }
}

// The projection: one persistent block an SM (wg::kThreads threads,
// wg::kSmemBytes of dynamic shared memory) over the tiles (scale in walk
// order, image, row tile, kActBN-wide tile of E), the tiles of E fastest.
// The producer and the consumers skip the same tiles: those of an image
// whose expert id is out of range (K1's combine and K2's later passes
// poison it).
template <bool kU>
__device__ __forceinline__ void proj_tiles(const ProjMaps& maps, const ProjArgs& a,
                                           unsigned char* smem_raw) {
  const wg::Smem s = wg::carve(smem_raw);
  const int E = a.E, S = a.n_scales, n_nt = cdiv(E, kActBN), tiles = a.tile_start[S];
  auto decode = [&](int tile, int& sc, int& b, int& mt, int& nt) {
    int j = 0;
    while (j + 1 < S && tile >= a.tile_start[j + 1]) ++j;
    sc = a.order[j];
    const int t = tile - a.tile_start[j], per = proj_row_tiles(a.P[sc], a.halo[sc]) * n_nt;
    b = t / per;
    mt = (t % per) / n_nt;
    nt = t % n_nt;
  };
  wg::init_barriers(s);

  if (threadIdx.x < 128) {
    // producer: A = x_s rows m0.., B = Wp_s[e] rows k0.., three [64 d][64 e]
    // boxes side by side along E; then the tile's output stage
    wg::reg_dealloc<wg::kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int sc = 0; sc < S; ++sc) {
        wg::prefetch_map(&maps.x[sc]);
        wg::prefetch_map(&maps.wp[sc]);
      }
      wg::Ring ring;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int sc, b, mt, nt;
        decode(tile, sc, b, mt, nt);
        const int e = a.idx[b];
        if (bad_expert(a, e)) continue;
        const int m0 = mt * (a.halo[sc] ? kUStride : wg::kBM), nk = cdiv(a.D[sc], wg::kBK);
        for (int kb = 0; kb < nk; ++kb) {
          uint64_t* full = &s.full[ring.stage];
          wg::mbar_wait(&s.empty[ring.stage], ring.phase ^ 1u);
          wg::mbar_expect_tx(full, wg::kABytes + kActBN * wg::kBK * 2);
          wg::tma_load(wg::stage_a(s, ring.stage), &maps.x[sc], full, kb * wg::kBK, m0, b);
#pragma unroll
          for (int c = 0; c < kActBN / wg::kBox128; ++c)
            wg::tma_load(wg::stage_b(s, ring.stage) + c * kBox128Bytes, &maps.wp[sc], full,
                         nt * kActBN + c * wg::kBox128, kb * wg::kBK, e);
          ring.advance();
        }
        wg::reserve(s, ring);
      }
    }
  } else {
    wg::reg_alloc<wg::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1, ci = threadIdx.x - 128, q = threadIdx.x & 3;
    wg::Ring ring;
    float acc[kActBN / 2];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int sc, b, mt, nt;
      decode(tile, sc, b, mt, nt);
      const int e = a.idx[b];
      if (bad_expert(a, e)) continue;
      const bool halo = kU && a.halo[sc];
      const int m0 = mt * (halo ? kUStride : wg::kBM), n0 = nt * kActBN;
      wg::consume<kActBN, 0, 1>(
          acc, s, ring, cdiv(a.D[sc], wg::kBK),
          [&](int st, int ks) { return wg::desc_k128(wg::stage_a(s, st) + cw * 8192, ks); },
          [&](int st, int ks) { return wg::desc_mn128(wg::stage_b(s, st), ks); });
      // relu(acc + bp) in f32, rounded to bf16 as the tile is staged
      const float* __restrict__ bias = a.bp[sc] + (size_t)e * E;
#pragma unroll
      for (int j = 0; j < kActBN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * q;
        if (n >= E) continue;  // E % 8 == 0: both columns or neither
        const float2 bb = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x0 = acc[4 * j + 2 * h] + bb.x, x1 = acc[4 * j + 2 * h + 1] + bb.y;
          acc[4 * j + 2 * h] = x0 > 0.0f ? x0 : 0.0f;
          acc[4 * j + 2 * h + 1] = x1 > 0.0f ? x1 : 0.0f;
        }
      }
      if (!halo) {
        store_tile_bf16(s, ring, acc, &maps.h[sc], n0, E, m0, b);
        continue;
      }
      unsigned char* o = const_cast<unsigned char*>(wg::acquire(s, ring));
      stage_tile_bf16(o, acc);
      wg::consumer_sync();
      u_from_tile(o, a, sc, b, mt, n0);
      wg::consumer_sync();  // every thread has read the stage
      if (ci == 0) wg::mbar_arrive(&s.empty[ring.stage], wg::kConsumers / 32);
      ring.advance();
    }
    if (ci == 0) wg::tma_store_wait<0, false>();  // store_tile_bf16's
  }
}

// The projection's maps and walk for a chunk of B images: x_s, the banks
// Wp_s and biases bp_s of each scale; outs[s] receives h_s [B][P_s][E]
// (stored by TMA) or, with kU at a lerped scale, u_s [B][P][E]. The walk
// takes the scales by decreasing P / P_s where u is written (a tile of the
// coarsest scale writes the most rows), else in order. False when a shape
// or the encoder refuses.
static bool proj_setup(ProjMaps* m, ProjArgs* a, bool kU, int S, const void* const* xs,
                       const void* const* wps, const void* const* bps, void* const* outs,
                       const int* Ps, const int* Ds, const void* idx, int B, int K, int E,
                       int P) {
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const uint64_t e2 = (uint64_t)E * 2;
  int weight[MAX_SCALES];
  for (int s = 0; s < S; ++s) {
    if (Ds[s] % 8 || Ps[s] < 1 || P % Ps[s]) return false;
    const uint64_t Pq = Ps[s], D = Ds[s];
    a->bp[s] = static_cast<const float*>(bps[s]);
    a->halo[s] = kU && Ps[s] != P;
    a->u[s] = a->halo[s] ? static_cast<bf16*>(outs[s]) : nullptr;
    a->P[s] = Ps[s];
    a->D[s] = Ds[s];
    weight[s] = a->halo[s] ? P / Ps[s] : 0;
    if (!tensor_map(&m->x[s], xs[s], D, Pq, B, D * 2, Pq * D * 2, wg::kBK, wg::kBM, sw) ||
        !tensor_map(&m->wp[s], wps[s], E, D, K, e2, D * e2, wg::kBox128, wg::kBK, sw) ||
        (!a->halo[s] &&
         !tensor_map(&m->h[s], outs[s], E, Pq, B, e2, Pq * e2, wg::kBox128, wg::kBM, sw)))
      return false;
  }
  for (int s = 0; s < S; ++s) {  // a stable sort, heaviest first
    int j = s;
    while (j > 0 && weight[a->order[j - 1]] < weight[s]) {
      a->order[j] = a->order[j - 1];
      --j;
    }
    a->order[j] = s;
  }
  a->tile_start[0] = 0;
  for (int j = 0; j < S; ++j) {
    const int s = a->order[j];
    a->tile_start[j + 1] =
        a->tile_start[j] + B * proj_row_tiles(Ps[s], a->halo[s]) * cdiv(E, kActBN);
  }
  a->idx = static_cast<const int*>(idx);
  a->n_scales = S;
  a->P_out = P;
  a->B = B;
  a->K = K;
  a->E = E;
  return true;
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
