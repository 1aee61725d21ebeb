// Fused MedMoE expert branch, gather mode, forward — for sm_90a.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (driven by `_fwd_pallas`) in
// medmoe_tpu/ops/pallas/expert_fusion.py. What it computes, the rounding
// points, and why it is two launches: see the module docstring of
// medmoe_torch/ops/expert_fusion.py, which wraps it. In short, per sample b
// with expert e = idx[b]:
//   proj_kernel: h_s = bf16(relu(x_s·Wp[e,s] + bp[e,s]))      per scale s
//   attn_kernel: per 64-row tile of P, for every scale
//                u_s = bf16(lerp of two h_s rows)
//                logit_s = Σ_c bf16(relu(u_s·W1[e] + b1[e]))_c · w2[e]_c
//                att = bf16(softmax_s(logit)), out = Σ_s att_s·u_s (f32)
// Matrix products use WMMA bf16 16×16×16 tiles with f32 accumulators.
//
// Shapes the kernels take (the wrapper checks them): 1..MAX_SCALES scales,
// D_s % 8 == 0, E % 32 == 0, H % 16 == 0 and H <= 8·16·MAX_NF, P % P_s == 0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (medmoe_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define MAX_SCALES 4
#define THREADS 256

// projection tile: 64 rows of P_s × 128 columns of E, K in chunks of 32
#define PM 64
#define PN 128
#define PK 32
#define PX_LD (PK + 8)
#define PW_LD (PN + 8)
#define PC_LD (PN + 4)

// attention tile: 64 rows of P; W1 streamed in chunks of 32 rows of E
#define AM 64
#define AK 32
#define MAX_NF 3  // column fragments of H per warp

struct ProjArgs {
  const bf16* x[MAX_SCALES];   // [B, P_s, D_s]
  const bf16* wp[MAX_SCALES];  // [K, D_s, E]
  const float* bp[MAX_SCALES]; // [K, E], values rounded through bf16
  bf16* h[MAX_SCALES];         // [B, P_s, E] scratch
  int P[MAX_SCALES];
  int D[MAX_SCALES];
  int tile_start[MAX_SCALES + 1];
  int n_scales;
};

struct AttnArgs {
  const bf16* h[MAX_SCALES];   // [B, P_s, E]
  int P[MAX_SCALES];
  int n_scales;
  const bf16* w1;              // [K, E, H]
  const float* b1;             // [K, H], rounded through bf16
  const float* w2;             // [K, H], rounded through bf16
  float* out;                  // [B, P, E]
  int P_out;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gptr) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gptr));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// launch 1: per-scale projection h_s = bf16(relu(x_s·Wp[e,s] + bp[e,s]))
// grid (Σ_s tiles_s, B); 8 warps as 2 × 4, each a 32 × 32 output block
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
proj_kernel(ProjArgs a, const int* __restrict__ idx, int K, int E) {
  __shared__ __align__(128) bf16 xs[PM * PX_LD];
  __shared__ __align__(128) bf16 ws[PK * PW_LD];
  __shared__ __align__(128) float cs[PM * PC_LD];

  const int b = blockIdx.y;
  const int e = idx[b];
  if (e < 0 || e >= K) return;  // attn_kernel fills this sample with NaN

  int t = blockIdx.x;
  int s = 0;
  while (s + 1 < a.n_scales && t >= a.tile_start[s + 1]) ++s;
  t -= a.tile_start[s];
  const int P = a.P[s], D = a.D[s];
  const int tiles_n = (E + PN - 1) / PN;
  const int m0 = (t / tiles_n) * PM, n0 = (t % tiles_n) * PN;
  const bf16* x = a.x[s] + (size_t)b * P * D;
  const bf16* w = a.wp[s] + (size_t)e * D * E;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < D; k0 += PK) {
    {  // x tile: 64 rows × 32 columns = one 16-byte vector per thread
      const int r = tid >> 2, c = (tid & 3) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + r < P && k0 + c < D)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * D + k0 + c);
      *reinterpret_cast<uint4*>(xs + r * PX_LD + c) = v;
    }
    for (int i = tid; i < PK * PN / 8; i += THREADS) {  // Wp tile: 32 × 128
      const int r = i >> 4, c = (i & 15) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k0 + r < D && n0 + c < E)
        v = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * E + n0 + c);
      *reinterpret_cast<uint4*>(ws + r * PW_LD + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], xs + (wm * 32 + i * 16) * PX_LD + kk, PX_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], ws + kk * PW_LD + wn * 32 + j * 16, PW_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * PC_LD + wn * 32 + j * 16,
                              acc[i][j], PC_LD, wmma::mem_row_major);
  __syncthreads();

  const float* bias = a.bp[s] + (size_t)e * E;
  bf16* h = a.h[s] + (size_t)b * P * E;
  for (int i = tid; i < PM * PN / 8; i += THREADS) {
    const int r = i >> 4, c = (i & 15) * 8;
    if (m0 + r >= P || n0 + c >= E) continue;
    __align__(16) bf16 o[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float v = cs[r * PC_LD + c + q] + bias[n0 + c + q];
      o[q] = __float2bfloat16_rn(v > 0.0f ? v : 0.0f);
    }
    *reinterpret_cast<uint4*>(h + (size_t)(m0 + r) * E + n0 + c) =
        *reinterpret_cast<const uint4*>(o);
  }
}

// ---------------------------------------------------------------------------
// launch 2: upsample + cross-scale attention + combine
// ---------------------------------------------------------------------------

// Source rows and weight of output row p of a P_s → P linear upsample with
// integer ratio: the phase form of medmoe_tpu's interp_patches (offsets and
// weights in double, as numpy computes them, then the weight in f32).
__device__ __forceinline__ void lerp_rows(int p, int Ps, int P, int& i0, int& i1,
                                          float& w) {
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

// N (4 or 8) consecutive bf16 values → f32, as one 8- or 16-byte load
template <int N>
__device__ __forceinline__ void load_bf16(const bf16* __restrict__ src, float* f) {
  if (N == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int q = 0; q < 8; ++q) f[q] = __bfloat162float(e[q]);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q) f[q] = __bfloat162float(e[q]);
  }
}

// N consecutive u values of row p, columns [c, c+N), of one scale, in f32
// (already rounded to bf16)
template <int N>
__device__ __forceinline__ void load_u(const bf16* __restrict__ hs, int Ps, int P,
                                       int E, int p, int c, float* u) {
  if (Ps == P) {
    load_bf16<N>(hs + (size_t)p * E + c, u);
    return;
  }
  int i0, i1;
  float w;
  lerp_rows(p, Ps, P, i0, i1, w);
  float x1[N];
  load_bf16<N>(hs + (size_t)i0 * E + c, u);
  load_bf16<N>(hs + (size_t)i1 * E + c, x1);
#pragma unroll
  for (int q = 0; q < N; ++q) u[q] = round_bf16(lerp(u[q], x1[q], w));
}

__global__ void __launch_bounds__(THREADS)
attn_kernel(AttnArgs a, const int* __restrict__ idx, int K, int E, int H,
            int tile_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* us = reinterpret_cast<bf16*>(smem);           // [AM][E + 8]
  float* cs = reinterpret_cast<float*>(smem);         // [AM][H + 4], aliases us
  bf16* w1s = reinterpret_cast<bf16*>(smem + tile_bytes);  // 2 × [AK][H + 8]
  const int w1_bytes = ((2 * AK * (H + 8) * 2) + 127) / 128 * 128;
  float* logit = reinterpret_cast<float*>(smem + tile_bytes + w1_bytes);  // [S][AM]

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * AM;
  const int P = a.P_out;
  const int e = idx[b];
  const int tid = threadIdx.x, warp = tid >> 5;
  float* out = a.out + (size_t)b * P * E;

  if (e < 0 || e >= K) {  // out-of-range expert id: poison the sample
    for (int i = tid; i < AM * E; i += THREADS) {
      const int p = m0 + i / E;
      if (p < P) out[(size_t)p * E + i % E] = __int_as_float(0x7fc00000);
    }
    return;
  }

  const int uld = E + 8, wld = H + 8, cld = H + 4;
  const bf16* w1 = a.w1 + (size_t)e * E * H;
  const float* b1 = a.b1 + (size_t)e * H;
  const float* w2 = a.w2 + (size_t)e * H;
  const int n_cf = H / 16;   // column fragments of H, dealt round-robin to warps
  const int n_chunks = E / AK;
  const int w1_vecs = AK * H / 8;

  auto load_w1_chunk = [&](int chunk, int buf) {
    bf16* dst = w1s + buf * AK * wld;
    const bf16* src = w1 + (size_t)chunk * AK * H;
    for (int i = tid; i < w1_vecs; i += THREADS) {
      const int r = i / (H / 8), c = (i % (H / 8)) * 8;
      cp_async16(dst + r * wld + c, src + (size_t)r * H + c);
    }
    cp_async_commit();
  };

  for (int s = 0; s < a.n_scales; ++s) {
    load_w1_chunk(0, 0);

    // u tile of this scale → shared memory (rows past P are zero)
    const bf16* hs = a.h[s] + (size_t)b * a.P[s] * E;
    const int Ps = a.P[s];
    for (int i = tid; i < AM * (E / 8); i += THREADS) {
      const int r = i / (E / 8), c = (i % (E / 8)) * 8;
      const int p = m0 + r;
      __align__(16) bf16 o[8];
      if (p < P) {
        float u[8];
        load_u<8>(hs, Ps, P, E, p, c, u);
#pragma unroll
        for (int q = 0; q < 8; ++q) o[q] = __float2bfloat16_rn(u[q]);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) o[q] = __float2bfloat16_rn(0.0f);
      }
      *reinterpret_cast<uint4*>(us + r * uld + c) = *reinterpret_cast<const uint4*>(o);
    }

    // a_pre = u · W1[e]: [AM, E] × [E, H]; warp w owns column fragments
    // w, w + 8, w + 16 of H and all four 16-row fragments of the tile
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][MAX_NF];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < MAX_NF; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      if (chunk + 1 < n_chunks) {
        load_w1_chunk(chunk + 1, (chunk + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* wb = w1s + (chunk & 1) * AK * wld;
      if (warp < n_cf) {
#pragma unroll
        for (int kk = 0; kk < AK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            wmma::load_matrix_sync(fa[i], us + i * 16 * uld + chunk * AK + kk, uld);
#pragma unroll
          for (int j = 0; j < MAX_NF; ++j) {
            const int cf = warp + 8 * j;
            if (cf < n_cf) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
              wmma::load_matrix_sync(fb, wb + kk * wld + cf * 16, wld);
#pragma unroll
              for (int i = 0; i < 4; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
            }
          }
        }
      }
      __syncthreads();
    }

    // accumulators → shared memory (over the u tile, no longer read)
#pragma unroll
    for (int j = 0; j < MAX_NF; ++j) {
      const int cf = warp + 8 * j;
      if (cf < n_cf) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wmma::store_matrix_sync(cs + i * 16 * cld + cf * 16, acc[i][j], cld,
                                  wmma::mem_row_major);
      }
    }
    __syncthreads();

    // logit[row] = Σ_c bf16(relu(a_pre + b1))_c · w2_c: four threads a row,
    // each a stride-4 quarter of the columns, then a fixed-order shuffle sum
    {
      const int row = tid >> 2, part = tid & 3;
      float sum = 0.0f;
      for (int c = part; c < H; c += 4) {
        float v = cs[row * cld + c] + b1[c];
        v = round_bf16(v > 0.0f ? v : 0.0f);
        sum += v * w2[c];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) logit[s * AM + row] = sum;
    }
    __syncthreads();
  }

  // softmax over scales in f32, rounded to bf16 (in place of the logits)
  if (tid < AM) {
    float m = logit[tid];
    for (int s = 1; s < a.n_scales; ++s) m = fmaxf(m, logit[s * AM + tid]);
    float ex[MAX_SCALES];
    float z = 0.0f;
    for (int s = 0; s < a.n_scales; ++s) {
      ex[s] = expf(logit[s * AM + tid] - m);
      z += ex[s];
    }
    for (int s = 0; s < a.n_scales; ++s) logit[s * AM + tid] = round_bf16(ex[s] / z);
  }
  __syncthreads();

  // out = Σ_s att_s · u_s in f32, u recomputed from h_s; 4 columns a thread
  for (int i = tid; i < AM * (E / 4); i += THREADS) {
    const int r = i / (E / 4), c = (i % (E / 4)) * 4;
    const int p = m0 + r;
    if (p >= P) continue;
    float o[4];
    for (int s = 0; s < a.n_scales; ++s) {
      float u[4];
      load_u<4>(a.h[s] + (size_t)b * a.P[s] * E, a.P[s], P, E, p, c, u);
      const float att = logit[s * AM + r];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o[q] = s == 0 ? __fmul_rn(u[q], att) : __fadd_rn(o[q], __fmul_rn(u[q], att));
    }
    *reinterpret_cast<float4*>(out + (size_t)p * E + c) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

static int round_up(int n, int m) { return (n + m - 1) / m * m; }
static int imax(int a, int b) { return a > b ? a : b; }

extern "C" {

// The projection launch alone: h_s for every scale into `hs`. The forward
// below runs it first; the backward (csrc/expert_fusion_bwd.cu) recomputes
// its residuals with it, as the TPU backward recomputes its forward chain.
int medmoe_expert_fusion_proj(int n_scales, const void* const* xs, const void* const* wps,
                              const void* const* bps, void* const* hs, const int* Ps,
                              const int* Ds, const void* idx, int B, int K, int E,
                              void* stream) {
  if (n_scales < 1 || n_scales > MAX_SCALES || E % 32) return (int)cudaErrorInvalidValue;
  ProjArgs pa;
  int tiles = 0;
  for (int s = 0; s < n_scales; ++s) {
    if (Ds[s] % 8 || Ps[s] < 1) return (int)cudaErrorInvalidValue;
    pa.x[s] = static_cast<const bf16*>(xs[s]);
    pa.wp[s] = static_cast<const bf16*>(wps[s]);
    pa.bp[s] = static_cast<const float*>(bps[s]);
    pa.h[s] = static_cast<bf16*>(hs[s]);
    pa.P[s] = Ps[s];
    pa.D[s] = Ds[s];
    pa.tile_start[s] = tiles;
    tiles += ((Ps[s] + PM - 1) / PM) * ((E + PN - 1) / PN);
  }
  pa.tile_start[n_scales] = tiles;
  pa.n_scales = n_scales;
  proj_kernel<<<dim3(tiles, B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      pa, static_cast<const int*>(idx), K, E);
  return (int)cudaGetLastError();
}

// Returns a cudaError_t: 0 when both launches were accepted.
int medmoe_expert_fusion_fwd(int n_scales, const void* const* xs, const void* const* wps,
                             const void* const* bps, void* const* hs, const int* Ps,
                             const int* Ds, const void* w1, const void* b1, const void* w2,
                             const void* idx, void* out, int B, int K, int E, int H, int P,
                             void* stream) {
  if (n_scales < 1 || n_scales > MAX_SCALES || E % 32 || H % 16 || H > 8 * 16 * MAX_NF)
    return (int)cudaErrorInvalidValue;
  AttnArgs aa;
  for (int s = 0; s < n_scales; ++s) {
    if (Ps[s] < 1 || P % Ps[s]) return (int)cudaErrorInvalidValue;
    aa.h[s] = static_cast<const bf16*>(hs[s]);
    aa.P[s] = Ps[s];
  }
  aa.n_scales = n_scales;
  aa.w1 = static_cast<const bf16*>(w1);
  aa.b1 = static_cast<const float*>(b1);
  aa.w2 = static_cast<const float*>(w2);
  aa.out = static_cast<float*>(out);
  aa.P_out = P;

  int rc = medmoe_expert_fusion_proj(n_scales, xs, wps, bps, hs, Ps, Ds, idx, B, K, E, stream);
  if (rc != 0) return rc;

  const int tile_bytes = round_up(imax(AM * (E + 8) * 2, AM * (H + 4) * 4), 128);
  const int smem = tile_bytes + round_up(2 * AK * (H + 8) * 2, 128) + MAX_SCALES * AM * 4;
  cudaError_t err =
      cudaFuncSetAttribute(attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int* id = static_cast<const int*>(idx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  attn_kernel<<<dim3((P + AM - 1) / AM, B), THREADS, smem, st>>>(aa, id, K, E, H, tile_bytes);
  return (int)cudaGetLastError();
}

const char* medmoe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
