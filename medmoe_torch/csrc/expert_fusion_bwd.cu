// Fused MedMoE expert branch, gather mode, backward — for sm_90a.
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
// Parameters arrive rounded through bf16 (biases as bf16 values in f32);
// attn_b2 cancels in the softmax and its gradient is exactly zero.
//
// What bounds it on the H100: operations. At B=32 and flagship shapes
// (P=3136, E=768, H=384, 4 scales) the products are ≈24.4 GFLOP a sample
// (a-recompute, d_u and dW1 ≈7.4 each; h_s, d_x and dWp ≈0.87 each),
// ≈0.78 TFLOP in all, against ≈0.56 GB of inputs and outputs: ≈0.79 ms of
// bf16 tensor-core time against ≈0.17 ms of memory time. Every product
// runs on the tensor cores (WMMA bf16 16×16×16, f32 accumulators).
//
// The TPU kernel keeps a whole sample's maps (≈36 MB) in VMEM, one grid
// step per sample; a Hopper block has 227 KB, so P is tiled and the sums
// over P are split into passes with a fixed order (no atomics):
//   1. bwd_row_kernel, one block per (sample, 64-row tile of P): the
//      forward recompute, the softmax backward, a_s (to a bf16 scratch,
//      then overwritten by bf16(dz_a)), per-tile partial sums of dw2/db1,
//      and d_u_s (to an f32 scratch) from a WMMA product with W1ᵀ;
//   2. bwd_proj_kernel, one block per (sample, scale, 64-row tile of P_s):
//      d_h gathered per source row from the ≤2r destination rows that read
//      it (no atomics), dz_h masked by h_s > 0 (to a bf16 scratch),
//      per-tile partial sums of dbp, and d_x by WMMA with Wpᵀ. The TPU
//      kernel's default arm recomputes h_pre for the mask; its
//      MEDMOE_EXPERT_BWD_HKEEP arm reads the kept h, equal in value, and
//      that is the arm ported here, so the projection runs once;
//   3. bwd_wgrad_kernel, one block per (sample, 64×128 output tile) of dW1
//      (K = S·P, u rebuilt by lerp on the fly) and of every dWp (K = P_s);
//   4. bwd_reduce_kernel: the per-tile partials summed in tile order.
// A block reads idx[b] itself; an out-of-range id writes NaN to that
// sample's outputs only.
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
#define TM 64        // rows of P (or P_s) per tile
#define AK 32        // W1 rows streamed per chunk in the recompute product
#define MAX_NF 3     // column fragments of H per warp in the recompute
#define CD_LD 68     // f32 staging tile [64][68]
#define PC_LD 132    // f32 staging tile [64][132]
#define WX_LD 40     // bf16 tile [rows][32 + 8]
#define WW_LD 136    // bf16 tile [32][128 + 8]
#define WA_LD 72     // bf16 tile [32][64 + 8]

struct BwdArgs {
  const bf16* x[MAX_SCALES];     // [B, P_s, D_s] pyramid
  const bf16* wp[MAX_SCALES];    // [K, D_s, E]
  const bf16* h[MAX_SCALES];     // [B, P_s, E] recomputed projections
  float* du[MAX_SCALES];         // [B, P, E] scratch
  bf16* act[MAX_SCALES];         // [B, P, H] scratch: a_s, then bf16(dz_a)
  bf16* dzh[MAX_SCALES];         // [B, P_s, E] scratch: bf16(dz_h)
  bf16* dx[MAX_SCALES];          // [B, P_s, D_s] out
  float* dwp[MAX_SCALES];        // [B, D_s, E] out
  float* dbp[MAX_SCALES];        // [B, E] out
  float* dbp_part[MAX_SCALES];   // [B, ceil(P_s/64), E] scratch
  int P[MAX_SCALES];
  int D[MAX_SCALES];
  int proj_start[MAX_SCALES + 1];  // row tiles of P_s, scale by scale
  int wg_start[MAX_SCALES + 2];    // wgrad tiles: dW1, then dWp scale by scale
  int n_scales;
  const bf16* w1;                // [K, E, H]
  const float* b1;               // [K, H], rounded through bf16
  const float* w2;               // [K, H], rounded through bf16
  const float* dout;             // [B, P, E]
  float* dw1;                    // [B, E, H] out
  float* db1;                    // [B, H] out
  float* dw2;                    // [B, H] out
  float* db1_part;               // [B, ceil(P/64), H] scratch
  float* dw2_part;               // [B, ceil(P/64), H] scratch
  int P_out, K, E, H;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gptr) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gptr));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Source rows and weight of output row p of a P_s → P linear upsample with
// integer ratio (the same phase form as csrc/expert_fusion.cu).
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

__device__ __forceinline__ float lerp(float x0, float x1, float w) {
  return __fadd_rn(__fmul_rn(x0, __fsub_rn(1.0f, w)), __fmul_rn(x1, w));
}

__device__ __forceinline__ void load8_bf16(const bf16* __restrict__ src, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int q = 0; q < 8; ++q) f[q] = __bfloat162float(e[q]);
}

// 8 consecutive u values of row p, columns [c, c+8), of one scale (bf16 values)
__device__ __forceinline__ void load_u8(const bf16* __restrict__ hs, int Ps, int P, int E,
                                        int p, int c, float* u) {
  if (Ps == P) {
    load8_bf16(hs + (size_t)p * E + c, u);
    return;
  }
  int i0, i1;
  float w;
  lerp_rows(p, Ps, P, i0, i1, w);
  float x1[8];
  load8_bf16(hs + (size_t)i0 * E + c, u);
  load8_bf16(hs + (size_t)i1 * E + c, x1);
#pragma unroll
  for (int q = 0; q < 8; ++q) u[q] = round_bf16(lerp(u[q], x1[q], w));
}

__device__ __forceinline__ void store8_bf16(bf16* dst, const float* f) {
  __align__(16) bf16 o[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) o[q] = __float2bfloat16_rn(f[q]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
}

static __host__ __device__ int round_up(int n, int m) { return (n + m - 1) / m * m; }
static __host__ __device__ int imax(int a, int b) { return a > b ? a : b; }

// shared-memory carve-up of bwd_row_kernel
struct RowSmem {
  int tile, w1s, phase1, dz, wch, cd, phase3, region, total;
  __host__ __device__ RowSmem(int E, int H) {
    tile = round_up(imax(TM * (E + 8) * 2, TM * (H + 4) * 4), 128);
    w1s = round_up(2 * AK * (H + 8) * 2, 128);
    phase1 = tile + w1s;
    dz = round_up(TM * (H + 8) * 2, 128);
    wch = round_up(64 * (H + 8) * 2, 128);
    cd = TM * CD_LD * 4;
    phase3 = dz + 2 * wch + cd;
    region = imax(phase1, phase3);
    total = region + 3 * MAX_SCALES * TM * 4 + 2 * H * 4;
  }
};

// ---------------------------------------------------------------------------
// pass 1: per (sample, 64-row tile of P)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
bwd_row_kernel(BwdArgs a, const int* __restrict__ idx) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int E = a.E, H = a.H, P = a.P_out;
  const RowSmem L(E, H);
  // phase 1
  bf16* us = reinterpret_cast<bf16*>(smem);                   // [TM][E + 8]
  float* cs = reinterpret_cast<float*>(smem);                 // [TM][H + 4]
  bf16* w1s = reinterpret_cast<bf16*>(smem + L.tile);         // 2 × [AK][H + 8]
  // phase 3
  bf16* dzs = reinterpret_cast<bf16*>(smem);                  // [TM][H + 8]
  bf16* wch = reinterpret_cast<bf16*>(smem + L.dz);           // 2 × [64][H + 8]
  float* cd = reinterpret_cast<float*>(smem + L.dz + 2 * L.wch);  // [TM][CD_LD]
  // kept across phases
  float* att = reinterpret_cast<float*>(smem + L.region);     // [S][TM]: logits, then bf16(att32)
  float* datt = att + MAX_SCALES * TM;                        // [S][TM]
  float* dl = datt + MAX_SCALES * TM;                         // [S][TM]
  float* col_w2 = dl + MAX_SCALES * TM;                       // [H]
  float* col_b1 = col_w2 + H;                                 // [H]

  const int b = blockIdx.y;
  const int tile = blockIdx.x, n_tiles = gridDim.x;
  const int m0 = tile * TM;
  const int rows = P - m0 < TM ? P - m0 : TM;
  const int e = idx[b];
  const int tid = threadIdx.x, warp = tid >> 5;
  float* part_w2 = a.dw2_part + ((size_t)b * n_tiles + tile) * H;
  float* part_b1 = a.db1_part + ((size_t)b * n_tiles + tile) * H;
  if (e < 0 || e >= a.K) {  // out-of-range expert id: the reduce pass writes NaN
    return;
  }

  const int uld = E + 8, wld = H + 8, cld = H + 4, dld = H + 8;
  const bf16* w1 = a.w1 + (size_t)e * E * H;
  const float* b1 = a.b1 + (size_t)e * H;
  const float* w2 = a.w2 + (size_t)e * H;
  const float* dout = a.dout + (size_t)b * P * E;
  const int n_cf = H / 16;
  const int n_chunks = E / AK;
  const int S = a.n_scales;

  auto load_w1_chunk = [&](int chunk, int buf) {
    bf16* dst = w1s + buf * AK * wld;
    const bf16* src = w1 + (size_t)chunk * AK * H;
    for (int i = tid; i < AK * H / 8; i += THREADS) {
      const int r = i / (H / 8), c = (i % (H / 8)) * 8;
      cp_async16(dst + r * wld + c, src + (size_t)r * H + c);
    }
    cp_async_commit();
  };

  // ---- phase 1: forward recompute, d_att, a_s → scratch, logits ----------
  for (int s = 0; s < S; ++s) {
    load_w1_chunk(0, 0);
    const bf16* hs = a.h[s] + (size_t)b * a.P[s] * E;
    const int Ps = a.P[s];
    for (int i = tid; i < TM * (E / 8); i += THREADS) {
      const int r = i / (E / 8), c = (i % (E / 8)) * 8;
      float u[8];
      if (r < rows) {
        load_u8(hs, Ps, P, E, m0 + r, c, u);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) u[q] = 0.0f;
      }
      store8_bf16(us + r * uld + c, u);
    }
    __syncthreads();

    // d_att_s[row] = Σ_c d_out·u: four threads a row, fixed-order sum
    {
      const int row = tid >> 2, part = tid & 3;
      float sum = 0.0f;
      if (row < rows) {
        const float* d = dout + (size_t)(m0 + row) * E;
        for (int c = part * 4; c < E; c += 16) {
          const float4 v = *reinterpret_cast<const float4*>(d + c);
          const bf16* uu = us + row * uld + c;
          sum += v.x * __bfloat162float(uu[0]) + v.y * __bfloat162float(uu[1]) +
                 v.z * __bfloat162float(uu[2]) + v.w * __bfloat162float(uu[3]);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) datt[s * TM + row] = sum;
    }

    // a_pre = u · W1[e]
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

    // a_s = bf16(relu(a_pre + b1)) → scratch (rows of P only)
    bf16* act = a.act[s] + ((size_t)b * P + m0) * H;
    for (int i = tid; i < rows * (H / 8); i += THREADS) {
      const int r = i / (H / 8), c = (i % (H / 8)) * 8;
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float x = cs[r * cld + c + q] + b1[c + q];
        v[q] = x > 0.0f ? x : 0.0f;
      }
      store8_bf16(act + (size_t)r * H + c, v);
    }
    // logit = Σ_c a·w2, as the forward kernel sums it
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
      if (part == 0) att[s * TM + row] = sum;
    }
    __syncthreads();
  }

  // ---- phase 2: softmax over scales and its backward, per row ------------
  if (tid < TM) {
    float m = att[tid];
    for (int s = 1; s < S; ++s) m = fmaxf(m, att[s * TM + tid]);
    float ex[MAX_SCALES];
    float z = 0.0f;
    for (int s = 0; s < S; ++s) {
      ex[s] = expf(att[s * TM + tid] - m);
      z += ex[s];
    }
    float inner = 0.0f;
    for (int s = 0; s < S; ++s) {
      ex[s] = ex[s] / z;                            // att32
      inner += ex[s] * datt[s * TM + tid];
    }
    for (int s = 0; s < S; ++s) {
      dl[s * TM + tid] = tid < rows ? ex[s] * (datt[s * TM + tid] - inner) : 0.0f;
      att[s * TM + tid] = round_bf16(ex[s]);
    }
  }
  for (int c = tid; c < H; c += THREADS) {
    col_w2[c] = 0.0f;
    col_b1[c] = 0.0f;
  }
  __syncthreads();

  // ---- phase 3: dz_a, partial dw2/db1, d_u = att·d_out + dz_a·W1ᵀ --------
  const int n_wch = E / 64;
  auto load_w1_rows = [&](int chunk, int buf) {   // W1[e][chunk·64 .. +64][:]
    bf16* dst = wch + buf * 64 * wld;
    const bf16* src = w1 + (size_t)chunk * 64 * H;
    for (int i = tid; i < 64 * (H / 8); i += THREADS) {
      const int r = i / (H / 8), c = (i % (H / 8)) * 8;
      cp_async16(dst + r * wld + c, src + (size_t)r * H + c);
    }
    cp_async_commit();
  };
  for (int s = 0; s < S; ++s) {
    load_w1_rows(0, 0);
    bf16* act = a.act[s] + ((size_t)b * P + m0) * H;
    for (int c = tid; c < H; c += THREADS) {
      const float w2c = w2[c];
      float sw2 = col_w2[c], sb1 = col_b1[c];
      for (int r = 0; r < TM; ++r) {
        bf16 zb = __float2bfloat16_rn(0.0f);
        if (r < rows) {
          const float av = __bfloat162float(act[(size_t)r * H + c]);
          const float d = dl[s * TM + r];
          sw2 += av * d;
          const float dz = av > 0.0f ? d * w2c : 0.0f;
          sb1 += dz;
          zb = __float2bfloat16_rn(dz);
          act[(size_t)r * H + c] = zb;
        }
        dzs[r * dld + c] = zb;
      }
      col_w2[c] = sw2;
      col_b1[c] = sb1;
    }

    float* du = a.du[s] + (size_t)b * P * E;
    const int rf = warp >> 1, cf0 = (warp & 1) * 2;
    for (int j = 0; j < n_wch; ++j) {
      if (j + 1 < n_wch) {
        load_w1_rows(j + 1, (j + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* wb = wch + (j & 1) * 64 * wld;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc2[2];
      wmma::fill_fragment(acc2[0], 0.0f);
      wmma::fill_fragment(acc2[1], 0.0f);
      for (int kk = 0; kk < H; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, dzs + rf * 16 * dld + kk, dld);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          // W1ᵀ: element (k = h, n = e) at wb[e·wld + h]
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, wb + (cf0 + q) * 16 * wld + kk, wld);
          wmma::mma_sync(acc2[q], fa, fb, acc2[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
        wmma::store_matrix_sync(cd + rf * 16 * CD_LD + (cf0 + q) * 16, acc2[q], CD_LD,
                                wmma::mem_row_major);
      __syncthreads();
      for (int i = tid; i < TM * 16; i += THREADS) {
        const int r = i >> 4, c = (i & 15) * 4;
        if (r >= rows) continue;
        const size_t off = (size_t)(m0 + r) * E + j * 64 + c;
        const float4 d = *reinterpret_cast<const float4*>(dout + off);
        const float at = att[s * TM + r];
        const float* g = cd + r * CD_LD + c;
        *reinterpret_cast<float4*>(du + off) =
            make_float4(at * d.x + g[0], at * d.y + g[1], at * d.z + g[2], at * d.w + g[3]);
      }
    }
    __syncthreads();
  }
  for (int c = tid; c < H; c += THREADS) {
    part_w2[c] = col_w2[c];
    part_b1[c] = col_b1[c];
  }
}

// ---------------------------------------------------------------------------
// pass 2: per (sample, scale, 64-row tile of P_s): dz_h, partial dbp, d_x
// ---------------------------------------------------------------------------
struct ProjSmem {
  int dzs, bt, cd, total;
  __host__ __device__ ProjSmem(int E) {
    dzs = round_up(TM * (E + 8) * 2, 128);
    bt = 64 * WX_LD * 2;
    cd = TM * CD_LD * 4;
    total = dzs + bt + cd;
  }
};

__global__ void __launch_bounds__(THREADS)
bwd_proj_kernel(BwdArgs a, const int* __restrict__ idx) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int E = a.E, P = a.P_out;
  const ProjSmem L(E);
  bf16* dzs = reinterpret_cast<bf16*>(smem);                     // [TM][E + 8]
  bf16* bt = reinterpret_cast<bf16*>(smem + L.dzs);              // [64][WX_LD]
  float* cd = reinterpret_cast<float*>(smem + L.dzs + L.bt);     // [TM][CD_LD]

  const int b = blockIdx.y;
  int t = blockIdx.x;
  int s = 0;
  while (s + 1 < a.n_scales && t >= a.proj_start[s + 1]) ++s;
  t -= a.proj_start[s];
  const int Ps = a.P[s], D = a.D[s];
  const int n_tiles = (Ps + TM - 1) / TM;
  const int i0 = t * TM;
  const int rows = Ps - i0 < TM ? Ps - i0 : TM;
  const int e = idx[b];
  const int tid = threadIdx.x, warp = tid >> 5;
  bf16* dx = a.dx[s] + ((size_t)b * Ps + i0) * D;
  float* part = a.dbp_part[s] + ((size_t)b * n_tiles + t) * E;
  if (e < 0 || e >= a.K) {  // out-of-range expert id: poison this tile's d_x
    for (int i = tid; i < rows * D; i += THREADS) dx[i] = __float2bfloat16_rn(nan_f());
    return;
  }
  const bf16* w = a.wp[s] + (size_t)e * D * E;
  const bf16* hs = a.h[s] + ((size_t)b * Ps + i0) * E;
  const float* du = a.du[s] + (size_t)b * P * E;
  bf16* dzh = a.dzh[s] + ((size_t)b * Ps + i0) * E;
  const int r_up = P / Ps;
  const int dld = E + 8;

  // ---- phase A: dz_h = [h_s > 0]·d_h, one column a thread, rows in order.
  // d_h is the transposed lerp of bf16(d_u): source row i gathers the
  // destination rows p ∈ [(i−1)r + r/2, (i+1)r + r/2) that read it, in
  // increasing p (no atomics); the rows the mask drops skip the gather
  for (int c = tid; c < E; c += THREADS) {
    float sum = 0.0f;
    for (int r = 0; r < TM; ++r) {
      float dz = 0.0f;
      if (r < rows && __bfloat162float(hs[(size_t)r * E + c]) > 0.0f) {
        const int row = i0 + r;
        if (Ps == P) {
          dz = du[(size_t)row * E + c];
        } else {
          const int lo = imax(0, (row - 1) * r_up + r_up / 2);
          const int hi_ = (row + 1) * r_up + r_up / 2;
          const int hi = hi_ < P ? hi_ : P;
          for (int p = lo; p < hi; ++p) {
            int j0, j1;
            float wt;
            lerp_rows(p, Ps, P, j0, j1, wt);
            if (j0 != row && j1 != row) continue;
            const float v = round_bf16(du[(size_t)p * E + c]);
            if (j0 == row) dz += (1.0f - wt) * v;
            if (j1 == row) dz += wt * v;
          }
        }
      }
      sum += dz;
      const bf16 zb = __float2bfloat16_rn(dz);
      dzs[r * dld + c] = zb;
      if (r < rows) dzh[(size_t)r * E + c] = zb;
    }
    part[c] = sum;
  }
  __syncthreads();

  // ---- phase B: d_x = bf16(dz_h) · Wpᵀ, 64 columns of D_s at a time ------
  const int rf = warp >> 1, cf0 = (warp & 1) * 2;
  for (int n0 = 0; n0 < D; n0 += 64) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc2[2];
    wmma::fill_fragment(acc2[0], 0.0f);
    wmma::fill_fragment(acc2[1], 0.0f);
    for (int k0 = 0; k0 < E; k0 += 32) {
      {  // Wp rows n0..n0+63, columns k0..k0+31: element (k, n) at bt[n·WX_LD + k]
        const int n = tid >> 2, c = (tid & 3) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (n0 + n < D) v = *reinterpret_cast<const uint4*>(w + (size_t)(n0 + n) * E + k0 + c);
        *reinterpret_cast<uint4*>(bt + n * WX_LD + c) = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 32; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, dzs + rf * 16 * dld + k0 + kk, dld);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, bt + (cf0 + q) * 16 * WX_LD + kk, WX_LD);
          wmma::mma_sync(acc2[q], fa, fb, acc2[q]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
      wmma::store_matrix_sync(cd + rf * 16 * CD_LD + (cf0 + q) * 16, acc2[q], CD_LD,
                              wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < TM * 8; i += THREADS) {
      const int r = i >> 3, c = (i & 7) * 8;
      if (r >= rows || n0 + c >= D) continue;
      store8_bf16(dx + (size_t)r * D + n0 + c, cd + r * CD_LD + c);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// pass 3: per (sample, 64×128 output tile): C[m, n] = Σ_k A[k, m]·B[k, n]
//   dW1  = Σ_s u_sᵀ·bf16(dz_a_s)   (A rebuilt by lerp from h_s, K = P per scale)
//   dWp_s = x_sᵀ·bf16(dz_h_s)      (K = P_s)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
bwd_wgrad_kernel(BwdArgs a, const int* __restrict__ idx) {
  __shared__ __align__(128) bf16 as[32 * WA_LD];
  __shared__ __align__(128) bf16 bs[32 * WW_LD];
  __shared__ __align__(128) float cs[TM * PC_LD];

  const int E = a.E, H = a.H, P = a.P_out;
  const int b = blockIdx.y;
  const int e = idx[b];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  int t = blockIdx.x;
  int job = 0;  // 0: dW1; 1 + s: dWp of scale s
  while (job + 1 <= a.n_scales && t >= a.wg_start[job + 1]) ++job;
  t -= a.wg_start[job];
  int M, N;
  float* out;
  if (job == 0) {
    M = E;
    N = H;
    out = a.dw1 + (size_t)b * E * H;
  } else {
    M = a.D[job - 1];
    N = E;
    out = a.dwp[job - 1] + (size_t)b * M * E;
  }
  const int tiles_n = (N + 127) / 128;
  const int m0 = (t / tiles_n) * 64, n0 = (t % tiles_n) * 128;

  if (e >= 0 && e < a.K) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    const int s_lo = job == 0 ? 0 : job - 1;
    const int s_hi = job == 0 ? a.n_scales : job;
    for (int s = s_lo; s < s_hi; ++s) {
      const int Ps = a.P[s];
      const int Kd = job == 0 ? P : Ps;
      const bf16* hs = a.h[s] + (size_t)b * Ps * E;
      const bf16* xsrc = a.x[s] + (size_t)b * Ps * M;
      const bf16* bsrc = job == 0 ? a.act[s] + (size_t)b * P * H
                                  : a.dzh[s] + (size_t)b * Ps * E;
      for (int k0 = 0; k0 < Kd; k0 += 32) {
        {  // A tile: rows k of the source, columns m0..m0+63, as [k][m]
          const int k = tid >> 3, m = (tid & 7) * 8;
          const int p = k0 + k;
          if (p < Kd && m0 + m < M) {
            if (job == 0) {
              float u[8];
              load_u8(hs, Ps, P, E, p, m0 + m, u);
              store8_bf16(as + k * WA_LD + m, u);
            } else {
              *reinterpret_cast<uint4*>(as + k * WA_LD + m) =
                  *reinterpret_cast<const uint4*>(xsrc + (size_t)p * M + m0 + m);
            }
          } else {
            *reinterpret_cast<uint4*>(as + k * WA_LD + m) = make_uint4(0, 0, 0, 0);
          }
        }
        for (int i = tid; i < 32 * 16; i += THREADS) {
          const int k = i >> 4, n = (i & 15) * 8;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (k0 + k < Kd && n0 + n < N)
            v = *reinterpret_cast<const uint4*>(bsrc + (size_t)(k0 + k) * N + n0 + n);
          *reinterpret_cast<uint4*>(bs + k * WW_LD + n) = v;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < 32; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(fa[i], as + kk * WA_LD + wm * 32 + i * 16, WA_LD);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(fb[j], bs + kk * WW_LD + wn * 32 + j * 16, WW_LD);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * PC_LD + wn * 32 + j * 16,
                                acc[i][j], PC_LD, wmma::mem_row_major);
    __syncthreads();
  }
  const bool bad = e < 0 || e >= a.K;
  for (int i = tid; i < TM * 32; i += THREADS) {
    const int r = i >> 5, c = (i & 31) * 4;
    if (m0 + r >= M || n0 + c >= N) continue;
    const float4 v = bad ? make_float4(nan_f(), nan_f(), nan_f(), nan_f())
                         : *reinterpret_cast<const float4*>(cs + r * PC_LD + c);
    *reinterpret_cast<float4*>(out + (size_t)(m0 + r) * N + n0 + c) = v;
  }
}

// ---------------------------------------------------------------------------
// pass 4: per sample, the per-tile partial sums in tile order
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
bwd_reduce_kernel(BwdArgs a, const int* __restrict__ idx) {
  const int b = blockIdx.x;
  const int e = idx[b];
  const bool bad = e < 0 || e >= a.K;
  const int E = a.E, H = a.H;
  const int T = (a.P_out + TM - 1) / TM;
  for (int c = threadIdx.x; c < H; c += THREADS) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int t = 0; t < T && !bad; ++t) {
      s1 += a.db1_part[((size_t)b * T + t) * H + c];
      s2 += a.dw2_part[((size_t)b * T + t) * H + c];
    }
    a.db1[(size_t)b * H + c] = bad ? nan_f() : s1;
    a.dw2[(size_t)b * H + c] = bad ? nan_f() : s2;
  }
  for (int s = 0; s < a.n_scales; ++s) {
    const int Ts = (a.P[s] + TM - 1) / TM;
    for (int c = threadIdx.x; c < E; c += THREADS) {
      float sum = 0.0f;
      for (int t = 0; t < Ts && !bad; ++t) sum += a.dbp_part[s][((size_t)b * Ts + t) * E + c];
      a.dbp[s][(size_t)b * E + c] = bad ? nan_f() : sum;
    }
  }
}

extern "C" {

// Returns a cudaError_t: 0 when all four launches were accepted (a shape
// whose shared memory exceeds a block's fails at cudaFuncSetAttribute).
int medmoe_expert_fusion_bwd(int n_scales, const void* const* xs, const void* const* wps,
                             const void* const* hs, void* const* dus,
                             void* const* acts, void* const* dzhs, void* const* dxs,
                             void* const* dwps, void* const* dbps, void* const* dbp_parts,
                             const int* Ps, const int* Ds, const void* w1, const void* b1,
                             const void* w2, const void* idx, const void* dout, void* dw1,
                             void* db1, void* dw2, void* db1_part, void* dw2_part, int B, int K,
                             int E, int H, int P, void* stream) {
  if (n_scales < 1 || n_scales > MAX_SCALES || E % 32 || H % 16 || H > 8 * 16 * MAX_NF)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  int proj_tiles = 0;
  a.wg_start[0] = 0;
  a.wg_start[1] = ((E + 63) / 64) * ((H + 127) / 128);
  for (int s = 0; s < n_scales; ++s) {
    if (Ds[s] % 8 || Ps[s] < 1 || P % Ps[s]) return (int)cudaErrorInvalidValue;
    a.x[s] = static_cast<const bf16*>(xs[s]);
    a.wp[s] = static_cast<const bf16*>(wps[s]);
    a.h[s] = static_cast<const bf16*>(hs[s]);
    a.du[s] = static_cast<float*>(dus[s]);
    a.act[s] = static_cast<bf16*>(acts[s]);
    a.dzh[s] = static_cast<bf16*>(dzhs[s]);
    a.dx[s] = static_cast<bf16*>(dxs[s]);
    a.dwp[s] = static_cast<float*>(dwps[s]);
    a.dbp[s] = static_cast<float*>(dbps[s]);
    a.dbp_part[s] = static_cast<float*>(dbp_parts[s]);
    a.P[s] = Ps[s];
    a.D[s] = Ds[s];
    a.proj_start[s] = proj_tiles;
    proj_tiles += (Ps[s] + TM - 1) / TM;
    a.wg_start[s + 2] = a.wg_start[s + 1] + ((Ds[s] + 63) / 64) * ((E + 127) / 128);
  }
  a.proj_start[n_scales] = proj_tiles;
  a.n_scales = n_scales;
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.dout = static_cast<const float*>(dout);
  a.dw1 = static_cast<float*>(dw1);
  a.db1 = static_cast<float*>(db1);
  a.dw2 = static_cast<float*>(dw2);
  a.db1_part = static_cast<float*>(db1_part);
  a.dw2_part = static_cast<float*>(dw2_part);
  a.P_out = P;
  a.K = K;
  a.E = E;
  a.H = H;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(idx);
  const int row_smem = RowSmem(E, H).total;
  cudaError_t err = cudaFuncSetAttribute(bwd_row_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, row_smem);
  if (err != cudaSuccess) return (int)err;
  bwd_row_kernel<<<dim3((P + TM - 1) / TM, B), THREADS, row_smem, st>>>(a, id);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int proj_smem = ProjSmem(E).total;
  err = cudaFuncSetAttribute(bwd_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             proj_smem);
  if (err != cudaSuccess) return (int)err;
  bwd_proj_kernel<<<dim3(proj_tiles, B), THREADS, proj_smem, st>>>(a, id);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  bwd_wgrad_kernel<<<dim3(a.wg_start[n_scales + 1], B), THREADS, 0, st>>>(a, id);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  bwd_reduce_kernel<<<B, THREADS, 0, st>>>(a, id);
  return (int)cudaGetLastError();
}

const char* medmoe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
