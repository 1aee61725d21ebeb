// A tiled bf16 × bf16 → f32 matrix product for one block of 256 threads,
// for sm_90a: the core of the d_words product of K4b
// (gloria_attention_bwd.cu); its cp.async helpers also fill K2's
// transposed-upsample windows (expert_fusion_bwd.cu). K3, the backward's
// prologue, K4a and the expert branch's products (K1's logit product, K2's
// five) run on the wgmma core of wgmma_core.cuh instead; K4b is to follow
// them.
//
//   C[BM, BN] = A[BM, K] · B[K, BN], K in slices of BK = 32
//
// 8 warps in a WARPS_M × WARPS_N grid, each a WM × WN tile of
// mma.sync.m16n8k16 bf16 products with f32 accumulators in registers,
// their operands read from shared memory by ldmatrix (ldmatrix.trans for
// a B that is N-contiguous and an A that is M-contiguous). A ring of STAGES slices in shared memory is
// filled by 16-byte cp.async copies, so that the next slices load while
// the current one is multiplied. The caller's loaders fill one slice each
// (the strides, sources and masks are theirs; a masked chunk is filled
// with zeros); after the loop the caller's epilogue reads the f32 tile
// from shared memory (store_tile), where it replaces the ring.
//
// Shared memory rows are padded by 16 bytes (ld BK + 8 for [rows][BK]
// slices, BN + 8 for [BK][BN], BM + 8 for [BK][BM]), so the 8 rows an
// ldmatrix reads fall in 8 different bank groups.
//
// Each warp loads the fragments of the next 16-deep step (ldmatrix) before
// it issues the products of this one, across the slices' barriers too, so
// the tensor cores do not wait on shared memory.
//
// The main loop is mma.sync, which Hopper runs at a fraction of its
// tensor-core peak; wgmma_core.cuh is its successor (wgmma, a TMA ring,
// warp specialisation).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace gemm {

constexpr int kThreads = 256;
constexpr int BK = 32;
constexpr int LDK = BK + 8;  // ld of a [rows][BK] slice, in bf16

// Where a slice of B lies in shared memory: kKN as [BK][BN] (B is
// N-contiguous in device memory), kNK as [BN][BK] (B is K-contiguous).
enum BLayout { kKN, kNK };
// Where a slice of A lies: kMK as [BM][BK] (A is K-contiguous in device
// memory), kKM as [BK][BM] (A is M-contiguous: a transposed operand, such
// as xᵀ in a weight gradient xᵀ·dz)
enum ALayout { kMK, kKM };

template <int BM_, int BN_, int WM_, int WN_, int STAGES_, BLayout BL_, ALayout AL_ = kMK>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr BLayout BL = BL_;
  static constexpr ALayout AL = AL_;
  static constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
  static_assert(WARPS_M * WARPS_N == kThreads / 32, "8 warps a block");
  static constexpr int MI = WM / 16, NI = WN / 8;  // m16 and n8 tiles of a warp
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile in 16 × 16 steps");
  static constexpr int LDN = BN + 8;  // ld of a [BK][BN] slice
  static constexpr int LDM = BM + 8;  // ld of a [BK][BM] slice
  static constexpr int A_ELEMS = AL == kMK ? BM * LDK : BK * LDM;
  static constexpr int B_ELEMS = BL == kKN ? BK * LDN : BN * LDK;
  static constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
  static constexpr int LDC = BN + 4;  // ld of the f32 tile
  static constexpr int RING_BYTES = STAGES * STAGE_ELEMS * 2;
  static constexpr int C_BYTES = BM * LDC * 4;
  static constexpr int SMEM = RING_BYTES > C_BYTES ? RING_BYTES : C_BYTES;
  // blocks an SM holds: 2 while a thread's accumulators take at most 64
  // registers (then 128 a thread), else 1
  static constexpr int MIN_BLOCKS = MI * NI * 4 <= 64 ? 2 : 1;
  static_assert((A_ELEMS * 2) % 128 == 0 && (B_ELEMS * 2) % 128 == 0, "aligned slices");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronous; zeros (src not read) when !valid
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16×8] += a[16×16] · b[16×8], bf16 operands, f32 sums
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The K loop: acc = A · B over K (a multiple of 8 where an operand is
// K-contiguous; the loaders zero what lies past it). load_a(bf16* slice,
// int k0) fills A's slice of columns k0..k0+31 ([BM][LDK], or [BK][LDM]
// for kKM), load_b(bf16* slice, int k0) B's slice of rows k0..k0+31,
// both with cp16 only. Ends with the ring drained and the
// block synchronised, so the caller may overwrite it.
template <class Cfg, class LoadA, class LoadB>
__device__ __forceinline__ void mainloop(unsigned char* smem, int K, LoadA load_a, LoadB load_b,
                                         float (&acc)[Cfg::MI][Cfg::NI][4]) {
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const int nk = (K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp % Cfg::WARPS_M) * Cfg::WM, wn0 = (warp / Cfg::WARPS_M) * Cfg::WN;
#pragma unroll
  for (int i = 0; i < Cfg::MI; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

#pragma unroll
  for (int s = 0; s < Cfg::STAGES - 1; ++s) {
    if (s < nk) {
      load_a(ring + s * Cfg::STAGE_ELEMS, s * BK);
      load_b(ring + s * Cfg::STAGE_ELEMS + Cfg::A_ELEMS, s * BK);
    }
    commit();
  }
  // ldmatrix lane offsets: a kMK A [m][k] and a kNK B [n][k] by rows, a
  // kKM A [k][m] and a kKN B [k][n] transposed; the four 8×8 matrices of
  // an x4 load are a's (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
  // (m 8-15, k 8-15) and two n8 tiles of b: (k 0-7, n 0-7), (k 8-15,
  // n 0-7), then n 8-15
  const int a_row = Cfg::AL == kMK ? ((lane >> 3) & 1) * 8 + (lane & 7) : (lane >> 4) * 8 + (lane & 7);
  const int a_col = Cfg::AL == kMK ? (lane >> 4) * 8 : ((lane >> 3) & 1) * 8;
  const int b_k = Cfg::BL == kKN ? ((lane >> 3) & 1) * 8 + (lane & 7) : ((lane >> 3) & 1) * 8;
  const int b_n = Cfg::BL == kKN ? (lane >> 4) * 8 : (lane >> 4) * 8 + (lane & 7);

  // fragments of two 16-deep steps: the one multiplied and the next
  unsigned af[2][Cfg::MI][4], bfr[2][Cfg::NI][2];
  auto frags = [&](int buf, const __nv_bfloat16* as, int kk) {
    const __nv_bfloat16* bs = as + Cfg::A_ELEMS;
#pragma unroll
    for (int i = 0; i < Cfg::MI; ++i) {
      if constexpr (Cfg::AL == kMK)
        ldsm4(af[buf][i], as + (wm0 + i * 16 + a_row) * LDK + kk + a_col);
      else
        ldsm4_t(af[buf][i], as + (kk + a_row) * Cfg::LDM + wm0 + i * 16 + a_col);
    }
#pragma unroll
    for (int j2 = 0; j2 < Cfg::NI / 2; ++j2) {
      unsigned r[4];
      if constexpr (Cfg::BL == kKN)
        ldsm4_t(r, bs + (kk + b_k) * Cfg::LDN + wn0 + j2 * 16 + b_n);
      else
        ldsm4(r, bs + (wn0 + j2 * 16 + b_n) * LDK + kk + b_k);
      bfr[buf][2 * j2][0] = r[0];
      bfr[buf][2 * j2][1] = r[1];
      bfr[buf][2 * j2 + 1][0] = r[2];
      bfr[buf][2 * j2 + 1][1] = r[3];
    }
  };
  wait<Cfg::STAGES - 2>();
  __syncthreads();
  if (nk > 0) frags(0, ring, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int nx = kt + Cfg::STAGES - 1;
    if (nx < nk) {
      const int s = nx % Cfg::STAGES;
      load_a(ring + s * Cfg::STAGE_ELEMS, nx * BK);
      load_b(ring + s * Cfg::STAGE_ELEMS + Cfg::A_ELEMS, nx * BK);
    }
    commit();
    const __nv_bfloat16* as = ring + (kt % Cfg::STAGES) * Cfg::STAGE_ELEMS;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      if (ks == BK / 16 - 1) {  // the next slice: landed, and this one consumed
        wait<Cfg::STAGES - 2>();
        __syncthreads();
        if (kt + 1 < nk) frags((ks + 1) & 1, ring + ((kt + 1) % Cfg::STAGES) * Cfg::STAGE_ELEMS, 0);
      } else {
        frags((ks + 1) & 1, as, (ks + 1) * 16);
      }
#pragma unroll
      for (int i = 0; i < Cfg::MI; ++i)
#pragma unroll
        for (int j = 0; j < Cfg::NI; ++j)
          mma16816(acc[i][j], af[ks & 1][i], bfr[ks & 1][j][0], bfr[ks & 1][j][1]);
    }
  }
  wait<0>();
  __syncthreads();
}

// The accumulators → the f32 tile cs [BM][LDC] in shared memory (over the
// ring), then a block barrier: the epilogue may read any element.
template <class Cfg>
__device__ __forceinline__ void store_tile(float* cs, const float (&acc)[Cfg::MI][Cfg::NI][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp % Cfg::WARPS_M) * Cfg::WM, wn0 = (warp / Cfg::WARPS_M) * Cfg::WN;
#pragma unroll
  for (int i = 0; i < Cfg::MI; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::NI; ++j) {
      const int r = wm0 + i * 16 + (lane >> 2), c = wn0 + j * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(cs + r * Cfg::LDC + c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(cs + (r + 8) * Cfg::LDC + c) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
}

}  // namespace gemm
