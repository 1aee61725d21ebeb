// Shared pieces of the GLoRIA similarity kernels (gloria_attention.cu, K3
// and the backward's per-pair prologue; gloria_attention_bwd.cu, K4a and
// K4b). See medmoe_torch/ops/gloria_attention.py for what they compute.
// The WMMA word-tile helpers below (load_dt, tile_times_dt, sum_parts,
// word_softmax4, word_softmax_tiles) serve K4b; the other kernels run on
// the GEMM core of gemm_core.cuh.
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
// T <= 32 (one word tile) runs K4b's single-tile code. Above it K4b walks
// the word tiles and recomputes the scores of every tile of a row for its
// softmax over all T words: right, not fast. T <= 128 because K4a's first
// pass holds a caption's 2·TPAD columns in one 256-wide tile (and K3's
// first pass a caption's TPAD in one 128-wide tile).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define THREADS 256
#define NWARPS 8
#define TP 32              // words of a word tile
#define MAX_NT 4           // word tiles of a caption: T <= MAX_NT·TP = 128
#define MAX_D 768          // widest D the accumulators and shared memory take
#define N_ACC 12           // (MAX_D / 16) · 2 accumulator fragments / 8 warps
#define WLD (TP + 8)       // leading dimension of a [D][TP] bf16 tile
#define SLD (TP + 4)       // leading dimension of a [rows][TP] f32 tile
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

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;

__host__ __device__ __forceinline__ int round_up(int n, int m) { return (n + m - 1) / m * m; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gptr));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// wait for every cp.async this thread issued, then for the whole block
__device__ __forceinline__ void cp_async_wait_sync() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// [rows][D] bf16 rows m0.. of one image's ctx → shared memory (ld D + 8),
// zero past M; asynchronous (cp.async), complete after cp_async_wait_sync
__device__ __forceinline__ void load_ctx_tile(bf16* cs, const bf16* __restrict__ ctx, int m0,
                                              int rows, int M, int D) {
  const int vecs = D / 8, cld = D + 8;
  for (int v = threadIdx.x; v < rows * vecs; v += THREADS) {
    const int r = v / vecs, c = (v - r * vecs) * 8;
    if (m0 + r < M)
      cp_async16(cs + r * cld + c, ctx + (size_t)(m0 + r) * D + c);
    else
      *reinterpret_cast<uint4*>(cs + r * cld + c) = make_uint4(0, 0, 0, 0);
  }
}

// one [D][TP] bf16 word tile (rows ld apart in src) → shared memory (ld
// WLD), asynchronous
__device__ __forceinline__ void load_dt(bf16* dst, const bf16* __restrict__ src, int D,
                                        int ld = TP) {
  for (int v = threadIdx.x; v < D * (TP / 8); v += THREADS) {
    const int d = v / (TP / 8), c = (v % (TP / 8)) * 8;
    cp_async16(dst + d * WLD + c, src + (size_t)d * ld + c);
  }
}

// A partial [32, TP] product of a 32-row tile, cs[32, D] · b[D, TP] (b
// in shared memory, ld WLD): the sum over the 16-wide steps of D that are
// `part` modulo `parts`, four independent 16×16 blocks a step, stored to
// out + part·32·SLD. The caller sums the `parts` partial tiles in order.
__device__ __forceinline__ void tile_times_dt(const bf16* cs, const bf16* b, int D, int part,
                                              int parts, float* out) {
  const int cld = D + 8, nk = D / 16;
  Acc s[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(s[i][j], 0.0f);
#pragma unroll 2
  for (int k = part; k < nk; k += parts) {
    FragA fa[2];
    FragB fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], cs + i * 16 * cld + k * 16, cld);
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], b + k * 16 * WLD + j * 16, WLD);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(s[i][j], fa[i], fb[j], s[i][j]);
  }
  float* o = out + part * 32 * SLD;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(o + i * 16 * SLD + j * 16, s[i][j], SLD, wmma::mem_row_major);
}

// Row r, words 4q..4q+3 of `parts` partial [32][SLD] tiles, summed in order
__device__ __forceinline__ void sum_parts(const float* p, int parts, int r, int q, float* v) {
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = 0.0f;
  for (int k = 0; k < parts; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(p + k * 32 * SLD + r * SLD + 4 * q);
    v[0] += x.x;
    v[1] += x.y;
    v[2] += x.z;
    v[3] += x.w;
  }
}

// sum over the 8 lanes that share a row (lanes 8k..8k+7 of a warp)
__device__ __forceinline__ float row_sum8(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Softmax over the words of one row of scores, 8 threads a row, words
// 4q..4q+3 in this thread: masked to t < cap with NEG_INF as in the JAX
// package, the padded words t >= T left out entirely.
__device__ __forceinline__ void word_softmax4(const float* score, int q, int cap, int T,
                                              float* a1) {
  float x[4], mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = 4 * q + j;
    x[j] = t >= T ? -INFINITY : (t < cap ? score[j] : NEG_INF_F);
    mx = fmaxf(mx, x[j]);
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float z = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[j] = expf(x[j] - mx);
    z += x[j];
  }
  z = row_sum8(z);
#pragma unroll
  for (int j = 0; j < 4; ++j) a1[j] = x[j] / z;
}

// The same softmax over the nt word tiles of a row (T > 32): words
// 32w + 4q + j in this thread, scores and a1 [MAX_NT][4].
__device__ __forceinline__ void word_softmax_tiles(const float (*score)[4], int nt, int q,
                                                   int cap, int T, float (*a1)[4]) {
  float mx = -INFINITY;
  for (int w = 0; w < nt; ++w)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = TP * w + 4 * q + j;
      a1[w][j] = t >= T ? -INFINITY : (t < cap ? score[w][j] : NEG_INF_F);
      mx = fmaxf(mx, a1[w][j]);
    }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float z = 0.0f;
  for (int w = 0; w < nt; ++w)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a1[w][j] = expf(a1[w][j] - mx);
      z += a1[w][j];
    }
  z = row_sum8(z);
  for (int w = 0; w < nt; ++w)
#pragma unroll
    for (int j = 0; j < 4; ++j) a1[w][j] /= z;
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
