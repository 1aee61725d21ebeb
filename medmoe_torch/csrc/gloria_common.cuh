// Shared pieces of the GLoRIA similarity kernels (gloria_attention.cu, K3
// and the backward's per-pair prologue; gloria_attention_bwd.cu, K4a and
// K4b), whose products run on the wgmma core of wgmma_core.cuh. See
// medmoe_torch/ops/gloria_attention.py for what they compute.
//
// Layouts the kernels take (the wrapper makes them), with the words of a
// caption padded to TPAD = 32·NT, NT = ⌈T/32⌉ word tiles of TP = 32:
//   ctx   [B_img, M, D] bf16, D contiguous (the local map's own layout)
//   words [B_txt, D, TPAD] bf16, word t < T at column t, zero past T
//   cap   [B_txt] int32
// Per-pair scratch written by the prologue and read by K4a/K4b:
//   dwei  [B_img·B_txt, D, TPAD] bf16   bf16(d_wei)
//   vecs  [B_img·B_txt, 4, TPAD] f32    Σ_m e, Σ_d bf16(d_wei)·wei, dnum, c2
//
// T <= 128 because K4a's first pass holds a caption's 2·TPAD columns in one
// 256-wide tile (and F1 of K3 and the prologue whole captions in one).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define THREADS 256
#define NWARPS 8
#define TP 32              // words of a word tile
#define MAX_NT 4           // word tiles of a caption: T <= MAX_NT·TP = 128
#define MAX_D 768          // widest D taken: the widest the kernels are tested at
#define NEG_INF_F -1e30f   // the JAX package's NEG_INF for masked words

enum { V_COLSUM = 0, V_S = 1, V_DNUM = 2, V_C2 = 3, N_VECS = 4 };

struct GloriaArgs {
  const bf16* ctx;
  const bf16* words;
  const int* cap;
  int Bi, Bt, M, D, T;
  int NT, TPAD;  // word tiles, and the words of a caption padded to 32·NT
  float temp1, temp2, temp3;
  float e_off;  // max(temp1, 0): temp1·a1 never exceeds it (0 <= a1 <= 1)
};

__host__ __device__ __forceinline__ int round_up(int n, int m) { return (n + m - 1) / m * m; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// v where bit k of bits is set, else +0 (a NaN or infinity too): a select
// without a predicate
__device__ __forceinline__ float keep(float v, uint32_t bits, int k) {
  return __int_as_float(__float_as_int(v) & -(int)(bits >> k & 1u));
}

// host side: the kernels' arguments, and the shapes every launch takes
static GloriaArgs make_args(const void* ctx, const void* words, const void* cap, int Bi, int Bt,
                            int M, int D, int T, float t1, float t2, float t3) {
  GloriaArgs a;
  a.ctx = static_cast<const bf16*>(ctx);
  a.words = static_cast<const bf16*>(words);
  a.cap = static_cast<const int*>(cap);
  a.Bi = Bi;
  a.Bt = Bt;
  a.M = M;
  a.D = D;
  a.T = T;
  a.NT = (T + TP - 1) / TP;
  a.TPAD = a.NT * TP;
  a.temp1 = t1;
  a.temp2 = t2;
  a.temp3 = t3;
  a.e_off = t1 > 0.0f ? t1 : 0.0f;
  return a;
}

static bool shapes_ok(int Bi, int Bt, int M, int D, int T) {
  return Bi >= 1 && Bt >= 1 && Bi <= 65535 && Bt <= 65535 && M >= 1 && D >= 16 &&
         D % 16 == 0 && D <= MAX_D && T >= 1 && T <= MAX_NT * TP;
}
