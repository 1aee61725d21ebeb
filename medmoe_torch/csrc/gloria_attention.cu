// GLoRIA word-region similarity, forward (K3) — for sm_90a.
//
// Replaces the Pallas TPU kernel `_sim_kernel` (driven by `_sim_forward`,
// forward chain `_cell_recompute`) in medmoe_tpu/ops/pallas/gloria_attention.py.
// For each (image b, caption i) pair, over the image's M = H·W regions:
//   scores[m,t] = Σ_d ctx[b,m,d]·words[i,d,t]              bf16 products, f32 sums
//   a1 = softmax_t(scores | t < cap_i),  a2 = softmax_m(temp1·a1)     f32
//   wei[d,t] = Σ_m ctx[b,m,d]·a2[m,t]                      f32 a2
//   cos[t] = ⟨w_t, wei_t⟩ / max(‖w_t‖·‖wei_t‖, 1e-8)
//   sim[b,i] = temp3 · log Σ_{t<cap_i} exp(temp2·cos[t])
//
// What bounds it on the H100: operations. Two products of 2·M·T·D per
// pair (7.89 TFLOP each at B=256 and flagship shapes, 16.0 ms of bf16
// tensor-core time) against 1.2 GB of ctx (0.37 ms of memory).
//
// Design. One block per pair, one pass over M in tiles of 32 rows, the
// next tile copied in (cp.async) while the block works on this one. The
// softmax over M needs no running maximum: 0 <= a1 <= 1, so temp1·a1 never
// exceeds e_off = max(temp1, 0), and e = exp(temp1·a1 - e_off) lies in
// [exp(-|temp1|), 1] (the wrapper takes |temp1| <= 80). The block sums the
// column sums Σ_m e and the unnormalised wei Σ_m ctx·e in one pass and
// divides at the end; a2 = e/Σe is the same function as the JAX softmax
// up to f32 rounding. The wei product runs on the tensor cores with f32 a2
// split into two bf16 parts, e = hi + lo: ctx is exactly bf16, so the two
// products give the f32 value to about 2^-16 relative. Both products use
// WMMA bf16 16×16×16 tiles with f32 accumulators: each warp forms the whole
// [32, 32] scores tile over an eighth of D (one fragment load a product),
// and the softmax over words runs 8 threads a row, all rows at once. The
// [D, T] wei accumulator (96 KB of f32 at D=768) lives in registers, 12
// fragments a warp, which leaves room for one caption a block, not
// several: blocks of one image are launched next to each other (grid x =
// caption), so its ctx (4.8 MB) is read from device memory about once and
// then from L2. No product sits behind a branch, so the compiler can
// interleave them (past D a fragment is repeated into an accumulator that
// is never stored).
//
// The backward's prologue (`medmoe_gloria_pair_cotangents`) is the same
// kernel with the TPU kernel's `_cell_cotangents` appended: it writes
// bf16(d_wei) and four per-word vectors for K4a/K4b
// (csrc/gloria_attention_bwd.cu).
//
// Captions of T > 32 words run in word tiles of 32 (csrc/gloria_common.cuh):
// the block walks the tiles and recomputes every tile's scores for the
// softmax over words, for correctness at GLoRIA's own caption lengths, not
// for speed. T <= 32 runs the single-tile code above.
//
// Shapes the kernels take (the wrapper checks them): T <= 128, D % 16 == 0,
// D <= 768, |temp1| <= 80.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (medmoe_torch/ops/_build.py).

#include "gloria_common.cuh"

#define MT 32  // rows of M a tile

__host__ __device__ static int tile_bytes(int D) { return round_up(MT * (D + 8) * 2, 128); }

// two ctx tiles (after the M loop: wei [D][TP] f32), words, the warps'
// partial score tiles, e hi, e lo, then partial sums and per-word values
static int pair_smem_bytes(int D) {
  const int r0 = 2 * tile_bytes(D) > D * TP * 4 ? 2 * tile_bytes(D) : round_up(D * TP * 4, 128);
  const int r1 = round_up(D * WLD * 2, 128);
  const int r2 = round_up(NWARPS * MT * SLD * 4 + 2 * MT * WLD * 2, 128);
  const int r3 = (4 * NWARPS + 8) * TP * 4;
  return r0 + r1 + r2 + r3;
}

// kMulti: T > 32. The block then walks the word tiles wt in order; for each
// it runs the M loop, forming at every M tile the scores of all word tiles
// (each tile's words reloaded from L2) for the rows' softmax over all T,
// and accumulating e and wei for tile wt's words only. Σ_t row spans all
// tiles, so the backward first sweeps every tile for it and then sweeps
// again to write d_wei. With kMulti false (T <= 32) nt is 1 and the code is
// the single-tile kernel.
template <bool kBwd, bool kMulti>
__global__ void __launch_bounds__(THREADS, 1)
pair_kernel(GloriaArgs a, float* __restrict__ sim, const float* __restrict__ g,
            bf16* __restrict__ dwei, float* __restrict__ vecs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, M = a.M, T = a.T;
  const int nt = kMulti ? a.NT : 1;
  const int tpad = kMulti ? a.TPAD : TP;
  const int cld = D + 8;
  const int tb = tile_bytes(D);
  bf16* cbuf[2] = {reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem + tb)};
  float* weis = reinterpret_cast<float*>(smem);  // [D][TP], after the M loop
  unsigned char* p = smem + (2 * tb > D * TP * 4 ? 2 * tb : round_up(D * TP * 4, 128));
  bf16* ws = reinterpret_cast<bf16*>(p);
  p += round_up(D * WLD * 2, 128);
  float* sc = reinterpret_cast<float*>(p);  // NWARPS partial [MT][SLD] score tiles
  bf16* eh = reinterpret_cast<bf16*>(p + NWARPS * MT * SLD * 4);
  bf16* el = eh + MT * WLD;
  float* red =
      reinterpret_cast<float*>(p + round_up(NWARPS * MT * SLD * 4 + 2 * MT * WLD * 2, 128));
  float* col = red + 4 * NWARPS * TP;  // 8 per-word arrays of TP

  const int i = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cap = a.cap[i];
  const bf16* ctx = a.ctx + (size_t)b * M * D;
  const bf16* words = a.words + (size_t)i * D * tpad;
  const size_t pair = (size_t)b * a.Bt + i;
  const int n_df = D / 16;
  const int tf = warp & 1;  // this warp's column fragment of wei
  const int n_tiles = (M + MT - 1) / MT;
  // the row step: 8 threads a row, words 4q..4q+3 of a word tile in this thread
  const int row = tid >> 3, q = tid & 7;
  float rowsum = 0.0f;  // Σ_t row over the word tiles swept so far (warp 0)
  const int sweeps = kBwd && kMulti ? 2 : 1;

  for (int sweep = 0; sweep < sweeps; ++sweep) {
    const bool write = kBwd && sweep == sweeps - 1;
    for (int wt = 0; wt < nt; ++wt) {
      const int t0 = wt * TP;  // this word tile's first word
      if (!kMulti) load_dt(ws, words, D);
      load_ctx_tile(cbuf[0], ctx, 0, MT, M, D);
      cp_async_commit();

      Acc acc[N_ACC];
#pragma unroll
      for (int j = 0; j < N_ACC; ++j) wmma::fill_fragment(acc[j], 0.0f);
      float colsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // Σ e over this thread's rows

      for (int t = 0; t < n_tiles; ++t) {
        const int m0 = t * MT;
        const bf16* cs = cbuf[t & 1];
        if (t + 1 < n_tiles) {  // the next tile, into the buffer freed at the end of t - 1
          load_ctx_tile(cbuf[(t + 1) & 1], ctx, m0 + MT, MT, M, D);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        float a1[4];
        if constexpr (!kMulti) {
          // scores [MT, TP]: each warp sums an eighth of the steps of D
          tile_times_dt(cs, ws, D, warp, NWARPS, sc);
          __syncthreads();
          float v[4];
          sum_parts(sc, NWARPS, row, q, v);
          word_softmax4(v, q, cap, T, a1);
        } else {
          float v[MAX_NT][4], a1t[MAX_NT][4];
          for (int w = 0; w < nt; ++w) {  // the scores of every word tile
            load_dt(ws, words + w * TP, D, tpad);
            cp_async_wait_sync();
            tile_times_dt(cs, ws, D, warp, NWARPS, sc);
            __syncthreads();
            sum_parts(sc, NWARPS, row, q, v[w]);
            __syncthreads();
          }
          word_softmax_tiles(v, nt, q, cap, T, a1t);
#pragma unroll
          for (int j = 0; j < 4; ++j) a1[j] = a1t[wt][j];
        }
        // e = exp(temp1·a1 - e_off) split into bf16 hi + lo
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int wc = 4 * q + j;
          const float e =
              (m0 + row < M && t0 + wc < T) ? expf(a.temp1 * a1[j] - a.e_off) : 0.0f;
          const bf16 hi = __float2bfloat16_rn(e);
          eh[row * WLD + wc] = hi;
          el[row * WLD + wc] = __float2bfloat16_rn(e - __bfloat162float(hi));
          colsum[j] += e;
        }
        __syncthreads();
        // wei[D, TP] += ctx_tileᵀ · (e_hi + e_lo); warp: column fragment tf,
        // row fragments (warp >> 1) + 4j, clamped to the last one past D
#pragma unroll
        for (int k = 0; k < MT; k += 16) {
          FragB bh, bl;
          wmma::load_matrix_sync(bh, eh + k * WLD + tf * 16, WLD);
          wmma::load_matrix_sync(bl, el + k * WLD + tf * 16, WLD);
#pragma unroll
          for (int g = 0; g < N_ACC; g += N_ACC / 3) {
            FragAT fa[N_ACC / 3];
#pragma unroll
            for (int u = 0; u < N_ACC / 3; ++u) {
              const int df = min((warp >> 1) + 4 * (g + u), n_df - 1);
              wmma::load_matrix_sync(fa[u], cs + k * cld + df * 16, cld);
            }
#pragma unroll
            for (int u = 0; u < N_ACC / 3; ++u) wmma::mma_sync(acc[g + u], fa[u], bh, acc[g + u]);
#pragma unroll
            for (int u = 0; u < N_ACC / 3; ++u) wmma::mma_sync(acc[g + u], fa[u], bl, acc[g + u]);
          }
        }
        __syncthreads();
      }
      if constexpr (kMulti) {  // this word tile's words, for the per-word sums below
        load_dt(ws, words + t0, D, tpad);
        cp_async_wait_sync();
      }

      // Σ_m e per word, and the unnormalised wei → shared memory
#pragma unroll
      for (int j = 0; j < 4; ++j) red[row * TP + 4 * q + j] = colsum[j];
#pragma unroll
      for (int j = 0; j < N_ACC; ++j) {
        const int df = (warp >> 1) + 4 * j;
        if (df < n_df)
          wmma::store_matrix_sync(weis + df * 16 * TP + tf * 16, acc[j], TP, wmma::mem_row_major);
      }
      __syncthreads();
      float* c_sum = col;  // Σ_m e
      if (tid < TP) {
        float s = 0.0f;
        for (int r = 0; r < MT; ++r) s += red[r * TP + tid];
        c_sum[tid] = s;
      }
      __syncthreads();

      // wei = Σ ctx·e / Σ e; per-word sums over D of w·wei, w², wei²
      const bool word = t0 + lane < T;
      float num = 0.0f, nw2 = 0.0f, nwei2 = 0.0f;
      for (int d = warp; d < D; d += NWARPS) {
        float v = 0.0f;
        if (word) v = weis[d * TP + lane] / c_sum[lane];
        weis[d * TP + lane] = v;
        const float wv = __bfloat162float(ws[d * WLD + lane]);
        num += wv * v;
        nw2 += wv * wv;
        nwei2 += v * v;
      }
      red[warp * TP + lane] = num;
      red[(NWARPS + warp) * TP + lane] = nw2;
      red[(2 * NWARPS + warp) * TP + lane] = nwei2;
      __syncthreads();

      float* c_dnum = col + TP;  // per-word coefficients of d_wei
      float* c_cw = col + 2 * TP;
      if (warp == 0) {
        float s_num = 0.0f, s_nw = 0.0f, s_nwei = 0.0f;
        for (int w = 0; w < NWARPS; ++w) {
          s_num += red[w * TP + lane];
          s_nw += red[(NWARPS + w) * TP + lane];
          s_nwei += red[(2 * NWARPS + w) * TP + lane];
        }
        const float nw = sqrtf(s_nw), nwei = sqrtf(s_nwei);
        const float den_raw = nw * nwei;
        const float den = fmaxf(den_raw, 1e-8f);
        const float cs_ = s_num / den;
        const float term = (word && t0 + lane < cap) ? expf(cs_ * a.temp2) : 0.0f;
        if (sweep == 0) rowsum += warp_sum(term);  // the word tiles in order
        if (write) {
          // _cell_cotangents: sim = temp3·log Σ row, row = exp(temp2·cos)
          const float gg = g[(size_t)b * a.Bt + i];
          const float dcos = gg * (a.temp2 * a.temp3) * term / rowsum;
          const float mask = den_raw > 1e-8f ? 1.0f : 0.0f;
          const float dnum = dcos / den;
          const float dden = -dcos * s_num / (den * den) * mask;
          const float dnwei = dden * nw, dnw = dden * nwei;
          c_dnum[lane] = dnum;
          c_cw[lane] = dnwei / fmaxf(nwei, 1e-20f);
          float* v = vecs + pair * N_VECS * tpad + t0;
          v[V_COLSUM * tpad + lane] = c_sum[lane];
          v[V_DNUM * tpad + lane] = dnum;
          v[V_C2 * tpad + lane] = dnw / fmaxf(nw, 1e-20f);
        }
      }
      if (write) {
        __syncthreads();
        // d_wei = dnum·w + dnwei/max(‖wei‖, 1e-20)·wei, kept as bf16 (the
        // rounding the cotangent products take); Σ_d bf16(d_wei)·wei per
        // word, which equals the softmax backward's Σ_m a2·d_a2
        bf16* dw = dwei + pair * D * tpad + t0;
        float s = 0.0f;
        for (int d = warp; d < D; d += NWARPS) {
          const float v = weis[d * TP + lane];
          const float wv = __bfloat162float(ws[d * WLD + lane]);
          const bf16 dq = __float2bfloat16_rn(c_dnum[lane] * wv + c_cw[lane] * v);
          dw[(size_t)d * tpad + lane] = dq;
          s += __bfloat162float(dq) * v;
        }
        red[warp * TP + lane] = s;
        __syncthreads();
        if (tid < TP) {
          float t = 0.0f;
          for (int w = 0; w < NWARPS; ++w) t += red[w * TP + tid];
          vecs[pair * N_VECS * tpad + V_S * tpad + t0 + tid] = t;
        }
      }
      if constexpr (kMulti) __syncthreads();  // smem is reused by the next word tile
    }
  }
  if (!kBwd && warp == 0 && lane == 0) sim[pair] = logf(rowsum) * a.temp3;
}

template <bool kBwd, bool kMulti>
static int launch_pair_nt(const GloriaArgs& a, float* sim, const float* g, bf16* dwei,
                          float* vecs, void* stream) {
  const int smem = pair_smem_bytes(a.D);
  cudaError_t err = cudaFuncSetAttribute(pair_kernel<kBwd, kMulti>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  pair_kernel<kBwd, kMulti><<<dim3(a.Bt, a.Bi), THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(a, sim, g, dwei, vecs);
  return (int)cudaGetLastError();
}

template <bool kBwd>
static int launch_pair(const GloriaArgs& a, float* sim, const float* g, bf16* dwei, float* vecs,
                       void* stream) {
  return a.NT == 1 ? launch_pair_nt<kBwd, false>(a, sim, g, dwei, vecs, stream)
                   : launch_pair_nt<kBwd, true>(a, sim, g, dwei, vecs, stream);
}

extern "C" {

// K3: out [Bi, Bt] f32. Returns a cudaError_t: 0 when the launch was accepted.
int medmoe_gloria_sim(const void* ctx, const void* words, const void* cap, int Bi, int Bt, int M,
                      int D, int T, float temp1, float temp2, float temp3, void* out,
                      void* stream) {
  if (!shapes_ok(Bi, Bt, M, D, T)) return (int)cudaErrorInvalidValue;
  const GloriaArgs a = make_args(ctx, words, cap, Bi, Bt, M, D, T, temp1, temp2, temp3);
  return launch_pair<false>(a, static_cast<float*>(out), nullptr, nullptr, nullptr, stream);
}

// The backward's prologue: the forward chain again, then the cotangents
// down to bf16(d_wei) [Bi·Bt, D, TPAD] and the per-word vectors
// [Bi·Bt, 4, TPAD] for the upstream cotangent g [Bi, Bt] f32.
int medmoe_gloria_pair_cotangents(const void* ctx, const void* words, const void* cap, int Bi,
                                  int Bt, int M, int D, int T, float temp1, float temp2,
                                  float temp3, const void* g, void* dwei, void* vecs,
                                  void* stream) {
  if (!shapes_ok(Bi, Bt, M, D, T)) return (int)cudaErrorInvalidValue;
  const GloriaArgs a = make_args(ctx, words, cap, Bi, Bt, M, D, T, temp1, temp2, temp3);
  return launch_pair<true>(a, nullptr, static_cast<const float*>(g), static_cast<bf16*>(dwei),
                           static_cast<float*>(vecs), stream);
}

const char* medmoe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
