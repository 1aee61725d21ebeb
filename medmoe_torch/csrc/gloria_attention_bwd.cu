// GLoRIA word-region similarity, backward (K4a: d_ctx, K4b: d_words) —
// for sm_90a.
//
// Replace the Pallas TPU kernels `_dctx_kernel` and `_dwords_kernel`
// (driven by `_bwd_pallas`, chain `_cell_cotangents`) in
// medmoe_tpu/ops/pallas/gloria_attention.py. Both start from the per-pair
// scratch of the prologue in csrc/gloria_attention.cu: bf16(d_wei) [D, TP]
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
// Design. Every output is a sum over one batch axis, summed inside a block
// in a fixed order, without atomics:
//   K4a: one block per (image, 32-row tile of M) walks every caption in
//        order and keeps its [32, D] d_ctx tile (96 KB of f32 at D=768) in
//        registers; the caption's words and the pair's bf16(d_wei) stream
//        through shared memory (2 × 60 KB).
//   K4b: one block per (caption, share of the images) walks its images and
//        their M tiles in order and keeps the caption's [D, TP] d_words in
//        registers; a second launch sums the shares in order and adds c2·w.
// Products use WMMA bf16 16×16×16 tiles with f32 accumulators, as in the
// forward: the [32, 32] scores and d_a2 tiles over a quarter of D a warp,
// the row step 8 threads a row, no product behind a branch. The
// per-pair scratch is B_img·B_txt·D·TP bf16 (3.2 GB at B=256, D=768, TP=32)
// plus B_img·B_txt·4·TP f32, allocated by the wrapper.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (medmoe_torch/ops/_build.py).

#include "gloria_common.cuh"

#define MTB 32             // rows of M a tile
#define OLD2 (2 * TP + 8)  // K4a: [a2 | d_scores] bf16 operand
#define OLD3 (3 * TP + 8)  // K4b: [d_scores | hi(dnum·a2) | lo(dnum·a2)]

#define PARTS 4            // warps that share one [MTB, TP] product

// ctx tile, words, d_wei, the partial scores and d_a2 tiles, the bf16
// operand, the pair's vectors
static int bwd_smem_bytes(int D, int old) {
  const int r0 = round_up(MTB * (D + 8) * 2, 128);
  const int r1 = 2 * round_up(D * WLD * 2, 128);
  const int r2 = round_up(2 * PARTS * MTB * SLD * 4 + MTB * old * 2, 128);
  const int r3 = N_VECS * TP * 4;
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

__device__ __forceinline__ BwdSmem carve(unsigned char* smem, int D, int old) {
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
  p += round_up(2 * PARTS * MTB * SLD * 4 + MTB * old * 2, 128);
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

__device__ __forceinline__ void load_vecs(float* dst, const float* __restrict__ src) {
  if (threadIdx.x < N_VECS * TP) dst[threadIdx.x] = src[threadIdx.x];
}

// ---------------------------------------------------------------------------
// K4a: d_ctx [Bi, M, D] f32; grid (M tiles, Bi)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, 1)
dctx_kernel(GloriaArgs a, const bf16* __restrict__ dwei, const float* __restrict__ vecs,
            float* __restrict__ dctx) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, M = a.M;
  const BwdSmem s = carve(smem, D, OLD2);
  const int b = blockIdx.y, m0 = blockIdx.x * MTB;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int row = tid >> 3, q = tid & 7;  // the row step: 8 threads a row
  const int n_df = D / 16;

  load_ctx_tile(s.cs, a.ctx + (size_t)b * M * D, m0, MTB, M, D);

  // d_ctx tile [MTB, D]: warp owns column fragments warp + 8jj, both rows
  Acc acc[N_ACC];
#pragma unroll
  for (int j = 0; j < N_ACC; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int i = 0; i < a.Bt; ++i) {
    const size_t pair = (size_t)b * a.Bt + i;
    const int cap = a.cap[i];
    load_dt(s.ws, a.words + (size_t)i * D * TP, D);
    load_dt(s.dws, dwei + pair * D * TP, D);
    load_vecs(s.vec, vecs + pair * N_VECS * TP);
    cp_async_wait_sync();
    tile_products(s, D);
    __syncthreads();
    {
      float a2[4], dsc[4];
      row_cotangents(a, s, row, q, m0 + row < M, cap, a2, dsc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s.op[row * OLD2 + 4 * q + j] = __float2bfloat16_rn(a2[j]);
        s.op[row * OLD2 + TP + 4 * q + j] = __float2bfloat16_rn(dsc[j]);
      }
    }
    __syncthreads();
    // acc += [bf16(a2) | bf16(d_scores)] · [bf16(d_wei)ᵀ ; wᵀ]
#pragma unroll
    for (int k = 0; k < 2 * TP; k += 16) {
      FragA f0, f1;
      wmma::load_matrix_sync(f0, s.op + k, OLD2);
      wmma::load_matrix_sync(f1, s.op + 16 * OLD2 + k, OLD2);
      const bf16* bsrc = k < TP ? s.dws + k : s.ws + (k - TP);
#pragma unroll
      for (int jj = 0; jj < N_ACC / 2; ++jj) {
        const int df = min(warp + NWARPS * jj, n_df - 1);
        FragBT fb;
        wmma::load_matrix_sync(fb, bsrc + df * 16 * WLD, WLD);
        wmma::mma_sync(acc[2 * jj], f0, fb, acc[2 * jj]);
        wmma::mma_sync(acc[2 * jj + 1], f1, fb, acc[2 * jj + 1]);
      }
    }
    __syncthreads();
  }

  // the tile → shared memory (over words and d_wei) → rows < M of d_ctx
  float* out_s = reinterpret_cast<float*>(s.ws);  // [MTB][D + 4]
  const int old = D + 4;
#pragma unroll
  for (int jj = 0; jj < N_ACC / 2; ++jj) {
    const int df = warp + NWARPS * jj;
    if (df < n_df) {
      wmma::store_matrix_sync(out_s + df * 16, acc[2 * jj], old, wmma::mem_row_major);
      wmma::store_matrix_sync(out_s + 16 * old + df * 16, acc[2 * jj + 1], old,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  float* out = dctx + ((size_t)b * M + m0) * D;
  for (int v = tid; v < MTB * (D / 4); v += THREADS) {
    const int r = v / (D / 4), c = (v - r * (D / 4)) * 4;
    if (m0 + r < M)
      *reinterpret_cast<float4*>(out + (size_t)r * D + c) =
          *reinterpret_cast<const float4*>(out_s + r * old + c);
  }
}

// ---------------------------------------------------------------------------
// K4b: per-share partial d_words [n_split, Bt, D, TP] f32 and Σ c2
// [n_split, Bt, TP]; grid (Bt, n_split)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, 1)
dwords_kernel(GloriaArgs a, const bf16* __restrict__ dwei, const float* __restrict__ vecs,
              float* __restrict__ part, float* __restrict__ c2part, int n_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, M = a.M;
  const BwdSmem s = carve(smem, D, OLD3);
  const int i = blockIdx.x, split = blockIdx.y;
  const int b0 = (int)((long long)a.Bi * split / n_split);
  const int b1 = (int)((long long)a.Bi * (split + 1) / n_split);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int row = tid >> 3, q = tid & 7;  // the row step: 8 threads a row
  const int n_df = D / 16, tf = warp & 1;
  const int cap = a.cap[i];
  const int cld = D + 8;

  load_dt(s.ws, a.words + (size_t)i * D * TP, D);  // complete at the first wait

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
        load_dt(s.dws, dwei + pair * D * TP, D);
        load_vecs(s.vec, vecs + pair * N_VECS * TP);
      }
      load_ctx_tile(s.cs, ctx, m0, MTB, M, D);
      cp_async_wait_sync();
      if (m0 == 0 && tid < TP) c2sum += s.vec[V_C2 * TP + tid];
      tile_products(s, D);
      __syncthreads();
      {
        float a2[4], dsc[4];
        row_cotangents(a, s, row, q, m0 + row < M, cap, a2, dsc);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = 4 * q + j;
          const float x = s.vec[V_DNUM * TP + t] * a2[j];
          const bf16 hi = __float2bfloat16_rn(x);
          s.op[row * OLD3 + t] = __float2bfloat16_rn(dsc[j]);
          s.op[row * OLD3 + TP + t] = hi;
          s.op[row * OLD3 + 2 * TP + t] = __float2bfloat16_rn(x - __bfloat162float(hi));
        }
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

  float* out = part + ((size_t)split * a.Bt + i) * D * TP;
#pragma unroll
  for (int j = 0; j < N_ACC; ++j) {
    const int df = (warp >> 1) + 4 * j;
    if (df < n_df)
      wmma::store_matrix_sync(out + df * 16 * TP + tf * 16, acc[j], TP, wmma::mem_row_major);
  }
  if (tid < TP) c2part[((size_t)split * a.Bt + i) * TP + tid] = c2sum;
}

// d_words [Bt, D, T] = Σ_split part + (Σ_split c2)·w, in split order
__global__ void dwords_reduce_kernel(const float* __restrict__ part,
                                     const float* __restrict__ c2part,
                                     const bf16* __restrict__ words, float* __restrict__ dw,
                                     int Bt, int D, int T, int n_split) {
  const long long n = (long long)Bt * D * T;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x; v < n;
       v += (long long)gridDim.x * blockDim.x) {
    const int t = (int)(v % T);
    const long long id = v / T;
    const int d = (int)(id % D), i = (int)(id / D);
    float sum = 0.0f, c2 = 0.0f;
    for (int sp = 0; sp < n_split; ++sp) {
      sum += part[(((size_t)sp * Bt + i) * D + d) * TP + t];
      c2 += c2part[((size_t)sp * Bt + i) * TP + t];
    }
    dw[v] = sum + c2 * __bfloat162float(words[((size_t)i * D + d) * TP + t]);
  }
}

extern "C" {

// K4a: d_ctx [Bi, M, D] f32 from the prologue's scratch. Returns a
// cudaError_t: 0 when the launch was accepted.
int medmoe_gloria_dctx(const void* ctx, const void* words, const void* cap, int Bi, int Bt,
                       int M, int D, int T, float temp1, const void* dwei, const void* vecs,
                       void* dctx, void* stream) {
  if (!shapes_ok(Bi, Bt, M, D, T)) return (int)cudaErrorInvalidValue;
  const GloriaArgs a = make_args(ctx, words, cap, Bi, Bt, M, D, T, temp1, 0.0f, 0.0f);
  const int smem = bwd_smem_bytes(D, OLD2);
  cudaError_t err =
      cudaFuncSetAttribute(dctx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dctx_kernel<<<dim3((M + MTB - 1) / MTB, Bi), THREADS, smem,
                static_cast<cudaStream_t>(stream)>>>(a, static_cast<const bf16*>(dwei),
                                                     static_cast<const float*>(vecs),
                                                     static_cast<float*>(dctx));
  return (int)cudaGetLastError();
}

// K4b: d_words [Bt, D, T] f32, through the partial sums part
// [n_split, Bt, D, TP] and c2part [n_split, Bt, TP] (scratch).
int medmoe_gloria_dwords(const void* ctx, const void* words, const void* cap, int Bi, int Bt,
                         int M, int D, int T, float temp1, const void* dwei, const void* vecs,
                         void* part, void* c2part, int n_split, void* dw, void* stream) {
  if (!shapes_ok(Bi, Bt, M, D, T) || n_split < 1 || n_split > Bi || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  const GloriaArgs a = make_args(ctx, words, cap, Bi, Bt, M, D, T, temp1, 0.0f, 0.0f);
  const int smem = bwd_smem_bytes(D, OLD3);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaFuncSetAttribute(dwords_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dwords_kernel<<<dim3(Bt, n_split), THREADS, smem, st>>>(
      a, static_cast<const bf16*>(dwei), static_cast<const float*>(vecs),
      static_cast<float*>(part), static_cast<float*>(c2part), n_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)Bt * D * T;
  const int blocks = (int)((n + THREADS - 1) / THREADS < 65535 ? (n + THREADS - 1) / THREADS
                                                                 : 65535);
  dwords_reduce_kernel<<<blocks, THREADS, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(c2part),
      static_cast<const bf16*>(words), static_cast<float*>(dw), Bt, D, T, n_split);
  return (int)cudaGetLastError();
}

const char* medmoe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
