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
// of inputs and output; around the products the passes stream u_s, 4.8 MB
// a flagship image and scale.
//
// Three passes over a chunk of images (the wrapper sizes the chunk and
// allocates u_s and the partial logits), the first two on the wgmma core
// (wgmma_core.cuh: TMA-fed, warp-specialised, persistent), both shared with
// K2 (expert_fusion_passes.cuh):
//   1. fwd_proj_kernel (M = P_s, N = E, K = D_s): h_0 of the identity scale
//      (which is u_0) stored by TMA, and at each lerped scale u_s =
//      bf16(lerp(h_s)) written from the epilogue's staged h tile, h_s never
//      stored (tiles of 128 rows stepping 126: each owns the u rows of its
//      middle h rows);
//   2. fwd_logit_kernel (M = P, N = H, K = E): each 192-wide N tile's
//      partial logits, a_s never stored;
//   3. fwd_combine_kernel (streaming, a warp a row of P): the partial
//      logits in tile order, the softmax over scales, out = Σ_s att_s·u_s.
// K2 recomputes this very forward: its projection is pass 1 storing h_s of
// every scale, its u pass computes the same u from it, and its logit
// product is pass 2 keeping a_s. Every sum runs in a fixed order, without
// atomics.
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

#include <stdint.h>

struct FwdArgs {
  bf16* u[MAX_SCALES];         // [B, P, E] u_s scratch (h_0 at the identity scale)
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
// pass 1: h_0 and u_s of the lerped scales; persistent
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(wg::kThreads, 1)
fwd_proj_kernel(const __grid_constant__ ProjMaps maps, const ProjArgs a) {
  extern __shared__ unsigned char smem_raw[];
  proj_tiles<true>(maps, a, smem_raw);
}

// ---------------------------------------------------------------------------
// pass 2: the partial logits; persistent
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(wg::kThreads, 1)
fwd_logit_kernel(const __grid_constant__ ActMaps maps, FwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  act_tiles<false>(maps, a, smem_raw);
}

// ---------------------------------------------------------------------------
// pass 3: the logits in tile order (as K2's row step sums them), att =
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

extern "C" {

// K1 for a chunk of B images: the three passes, through the scratch us
// [B, P, E] bf16 of every scale (h_0 at the identity scale) and lpart
// [B, S, lpart_tiles, P] f32; fewer partial-logit tiles than ⌈H/kActBN⌉
// is rejected. Returns a cudaError_t: 0 when every launch was accepted.
int medmoe_expert_fusion_fwd(int n_scales, const void* const* xs, const void* const* wps,
                             const void* const* bps, void* const* us, const int* Ps,
                             const int* Ds, const void* w1, const void* b1, const void* w2,
                             const void* idx, void* lpart, int lpart_tiles, void* out, int B,
                             int K, int E, int H, int P, void* stream) {
  if (n_scales < 1 || n_scales > MAX_SCALES || E % 32 || H < 8 || H % 8 || B < 1 ||
      B > 65535 || lpart_tiles < cdiv(H, kActBN))
    return (int)cudaErrorInvalidValue;
  ProjMaps pm;
  ProjArgs pa;
  if (!proj_setup(&pm, &pa, true, n_scales, xs, wps, bps, us, Ps, Ds, idx, B, K, E, P))
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  for (int s = 0; s < n_scales; ++s) a.u[s] = static_cast<bf16*>(us[s]);
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
  ActMaps maps;
  if (!act_maps(&maps, a.u, nullptr, n_scales, a.w1, B, K, E, H, P)) return (int)cudaErrorInvalidValue;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = launch_persistent(fwd_proj_kernel, pa.tile_start[n_scales], wg::kSmemBytes, st, pm,
                               pa)) != cudaSuccess)
    return (int)err;
  if ((err = launch_persistent(fwd_logit_kernel,
                               B * n_scales * cdiv(P, wg::kBM) * cdiv(H, kActBN),
                               wg::kSmemBytes, st, maps, a)) != cudaSuccess)
    return (int)err;
  fwd_combine_kernel<<<dim3(cdiv(P, 8), B), THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

const char* medmoe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
