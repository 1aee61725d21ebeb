// Fused MedMoE expert branch, gather mode, forward (K1) — for sm_90a.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (driven by `_fwd_pallas`) in
// medmoe_tpu/ops/pallas/expert_fusion.py. What it computes and the rounding
// points: see the module docstring of medmoe_torch/ops/expert_fusion.py,
// which wraps it. Per sample b with expert e = idx[b], for each scale s:
//   h_s = bf16(relu(x_s·Wp[e,s] + bp[e,s])),  u_s = bf16(lerp of h_s)
//   logit_s = Σ_c bf16(relu(u_s·W1[e] + b1[e]))_c · w2[e]_c
//   att = bf16(softmax_s(logit)),  out = Σ_s att_s·u_s (f32)
//
// What bounds it on the H100: operations. At flagship shapes (P=3136,
// E=768, H=384, 4 scales) a sample takes ≈8.3 GFLOP, 90% of it the
// attention MLP (0.27 ms of bf16 tensor-core time at B=32), against ≈11 MB
// of inputs and output.
//
// Four passes over a chunk of images (the wrapper sizes the chunk and
// allocates h_s, u_s and the partial logits):
//   1. proj_kernel (WMMA tiles): h_s for every scale to a bf16 scratch;
//   2. fwd_u_kernel: u_s = bf16(lerp(h_s)) to a bf16 scratch for each scale
//      with P_s < P;
//   3. fwd_logit_kernel (wgmma core, wgmma_core.cuh: TMA-fed, warp-
//      specialised, persistent; M = P, N = H, K = E): each 192-wide N
//      tile's partial logits, a_s never stored;
//   4. fwd_combine_kernel (streaming, a warp a row of P): the partial
//      logits in tile order, the softmax over scales, out = Σ_s att_s·u_s.
// Passes 2 and 3 are K2's first two passes without d_att and a_s
// (expert_fusion_passes.cuh): the backward recomputes this very forward.
// Every sum runs in a fixed order, without atomics.
//
// A block reads idx[b] itself and offsets its weight pointers, in place of
// the TPU kernel's scalar-prefetch index maps; an out-of-range id writes NaN
// to that sample's output only.
//
// Shapes the kernels take (the wrapper checks them): 1..MAX_SCALES scales,
// D_s % 8 == 0, E % 32 == 0, H % 8 == 0, P % P_s == 0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (medmoe_torch/ops/_build.py).

#include "expert_fusion_passes.cuh"

#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

// projection tile: 64 rows of P_s × 128 columns of E, K in chunks of 32
#define PM 64
#define PN 128
#define PK 32
#define PX_LD (PK + 8)
#define PW_LD (PN + 8)
#define PC_LD (PN + 4)

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

struct FwdArgs {
  const bf16* h[MAX_SCALES];   // [B, P_s, E] projections (pass 1)
  bf16* u[MAX_SCALES];         // [B, P, E] u_s scratch (h_s itself at P_s = P)
  int P[MAX_SCALES];
  int n_scales;
  const bf16* w1;              // [K, E, H]
  const float* b1;             // [K, H], rounded through bf16
  const float* w2;             // [K, H], rounded through bf16
  const int* idx;              // [B]
  float* lpart;                // [B, S, ⌈H/kActBN⌉, P] scratch: partial logits
  float* out;                  // [B, P, E]
  int P_out, B, K, E, H;
};

// ---------------------------------------------------------------------------
// pass 1: per-scale projection h_s = bf16(relu(x_s·Wp[e,s] + bp[e,s]))
// grid (Σ_s tiles_s, B); 8 warps as 2 × 4, each a 32 × 32 output block
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
proj_kernel(ProjArgs a, const int* __restrict__ idx, int K, int E) {
  __shared__ __align__(128) bf16 xs[PM * PX_LD];
  __shared__ __align__(128) bf16 ws[PK * PW_LD];
  __shared__ __align__(128) float cs[PM * PC_LD];

  const int b = blockIdx.y;
  const int e = idx[b];
  if (e < 0 || e >= K) return;  // the combine fills this sample with NaN

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
// passes 2 and 3: u_s, and the partial logits (expert_fusion_passes.cuh)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) fwd_u_kernel(FwdArgs a) { u_rows<false>(a); }

__global__ void __launch_bounds__(wg::kThreads, 1)
fwd_logit_kernel(const __grid_constant__ ActMaps maps, FwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  act_tiles<false>(maps, a, smem_raw);
}

// ---------------------------------------------------------------------------
// pass 4: the logits in tile order (as K2's row step sums them), att =
// bf16(softmax over scales), out = Σ_s att_s·u_s in f32; a warp a row of P,
// 8 columns a lane, grid (⌈P/8⌉, B)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) fwd_combine_kernel(FwdArgs a) {
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = a.P_out, E = a.E, S = a.n_scales;
  const int p = blockIdx.x * 8 + warp;
  if (p >= P) return;
  float* out = a.out + ((size_t)b * P + p) * E;
  if (bad_expert(a, a.idx[b])) {  // out-of-range expert id: poison the sample
    for (int c = lane * 4; c < E; c += 128)
      *reinterpret_cast<float4*>(out + c) = make_float4(nan_f(), nan_f(), nan_f(), nan_f());
    return;
  }
  const int tiles_n = cdiv(a.H, kActBN);
  float l[MAX_SCALES], att[MAX_SCALES];
  float mx = -INFINITY;
#pragma unroll
  for (int s = 0; s < MAX_SCALES; ++s) {
    l[s] = 0.0f;
    if (s < S) {
      const float* lp = a.lpart + (((size_t)b * S + s) * tiles_n) * P + p;
      for (int t = 0; t < tiles_n; ++t) l[s] += lp[(size_t)t * P];
      mx = fmaxf(mx, l[s]);
    }
  }
  float z = 0.0f;
#pragma unroll
  for (int s = 0; s < MAX_SCALES; ++s) {
    att[s] = s < S ? expf(l[s] - mx) : 0.0f;
    z += att[s];
  }
#pragma unroll
  for (int s = 0; s < MAX_SCALES; ++s) att[s] = round_bf16(att[s] / z);

  for (int c = lane * 8; c < E; c += 256) {
    float o[8];
#pragma unroll
    for (int s = 0; s < MAX_SCALES; ++s) {
      if (s >= S) break;
      float u[8];
      load8_bf16(a.u[s] + ((size_t)b * P + p) * E + c, u);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        o[q] = s == 0 ? __fmul_rn(u[q], att[s]) : __fadd_rn(o[q], __fmul_rn(u[q], att[s]));
    }
    *reinterpret_cast<float4*>(out + c) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(out + c + 4) = make_float4(o[4], o[5], o[6], o[7]);
  }
}

template <class Kernel>
static cudaError_t launch(Kernel k, dim3 grid, int smem, cudaStream_t st, const FwdArgs& a) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  k<<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

extern "C" {

// The projection pass alone: h_s for every scale into `hs`. The forward
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

// K1 for a chunk of B images: the four passes, through the scratch hs
// [B, P_s, E] and us [B, P, E] bf16 (us[s] unused at P_s = P) and lpart
// [B, S, lpart_tiles, P] f32; fewer partial-logit tiles than ⌈H/kActBN⌉
// is rejected. Returns a cudaError_t: 0 when every launch was accepted.
int medmoe_expert_fusion_fwd(int n_scales, const void* const* xs, const void* const* wps,
                             const void* const* bps, void* const* hs, void* const* us,
                             const int* Ps, const int* Ds, const void* w1, const void* b1,
                             const void* w2, const void* idx, void* lpart, int lpart_tiles,
                             void* out, int B, int K, int E, int H, int P, void* stream) {
  if (n_scales < 1 || n_scales > MAX_SCALES || E % 32 || H < 8 || H % 8 || B < 1 ||
      B > 65535 || lpart_tiles < cdiv(H, kActBN))
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  for (int s = 0; s < n_scales; ++s) {
    if (Ps[s] < 1 || P % Ps[s]) return (int)cudaErrorInvalidValue;
    a.h[s] = static_cast<const bf16*>(hs[s]);
    a.u[s] = Ps[s] == P ? static_cast<bf16*>(hs[s]) : static_cast<bf16*>(us[s]);
    a.P[s] = Ps[s];
  }
  a.n_scales = n_scales;
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.idx = static_cast<const int*>(idx);
  a.lpart = static_cast<float*>(lpart);
  a.out = static_cast<float*>(out);
  a.P_out = P;
  a.B = B;
  a.K = K;
  a.E = E;
  a.H = H;

  int rc = medmoe_expert_fusion_proj(n_scales, xs, wps, bps, hs, Ps, Ds, idx, B, K, E, stream);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = launch(fwd_u_kernel, dim3(cdiv(P, 8), B), 0, st, a)) != cudaSuccess) return (int)err;
  ActMaps maps;
  if (!act_maps(&maps, a.u, nullptr, n_scales, a.w1, B, K, E, H, P)) return (int)cudaErrorInvalidValue;
  if ((err = launch_persistent(fwd_logit_kernel,
                               B * n_scales * cdiv(P, wg::kBM) * cdiv(H, kActBN),
                               wg::kSmemBytes, st, maps, a)) != cudaSuccess)
    return (int)err;
  return (int)launch(fwd_combine_kernel, dim3(cdiv(P, 8), B), 0, st, a);
}

const char* medmoe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
