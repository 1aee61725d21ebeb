// A Hopper matrix-product core for sm_90a: a TMA-fed ring of shared-memory
// stages, one producer warp, and two consumer warpgroups that multiply on
// wgmma with their accumulators in registers. The GLoRIA kernels K3 and
// the backward's prologue (gloria_attention.cu: sim_e_kernel,
// sim_wei_kernel) and K4a (gloria_attention_bwd.cu: dctx_z_kernel,
// dctx_gemm_kernel) run on it, and so do the expert branch's products:
// K1's and K2's projection and logit product (expert_fusion_passes.cuh:
// fwd_proj_kernel, bwd_proj_kernel, fwd_logit_kernel, bwd_act_kernel;
// expert_fusion_bwd.cu: bwd_du_kernel, bwd_dx_kernel, bwd_wgrad_kernel),
// and K4b's product (gloria_attention_bwd.cu: dwords_gemm_kernel).
//
// A block is 384 threads: warpgroup 0 is the producer, warpgroups 1 and 2
// the consumers. A block tile is kBM = 128 rows (64 a consumer warpgroup,
// one m64nNk16 wgmma per 16-deep step) by N columns (N = 192 or 256,
// N/2 f32 accumulators a thread). One block per SM walks the tiles of a
// launch (a persistent grid), so a tile's epilogue runs while the
// producer already loads the next tile's stages.
//
//   the ring     kStages stages of a kBK = 64 slice: A [128 rows][64 k]
//                (K-contiguous, 128-byte swizzle: one 128-byte row a row of
//                A), or A M-contiguous (read transposed), and B, up to 32
//                KB, in boxes of 32 or 64 bf16 rows (64- or 128-byte
//                swizzle); each stage has a full and an empty mbarrier;
//   producer     one thread waits on a stage's empty barrier, arms its full
//                barrier with the stage's bytes and starts the TMA loads
//                (cp.async.bulk.tensor through tensor maps the host built);
//   consumers    wait on the full barrier, start the stage's four wgmma
//                (operands read from shared memory through descriptors),
//                commit, wait for the previous stage's group and release
//                that stage (one arrival a warp), so a stage's products run
//                while the next stage's are queued;
//   registers    setmaxnreg moves registers from the producer (40 a
//                thread) to the consumers (232 a thread).
//
// A tile's K loop runs in order, with no atomics: its sums are the same on
// every run. The tensor maps are built per call on the host
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the library
// needs no -lcuda) and passed as __grid_constant__ kernel parameters.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

constexpr int kThreads = 384;      // producer warpgroup + two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kBM = 128;           // rows of a block tile
constexpr int kBK = 64;            // K of a stage
constexpr int kStages = 4;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kABytes = kBM * kBK * 2;          // 16 KB, 128-byte rows
constexpr int kBBytes = 32768;                  // the widest B slice of a stage
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kBox = 32;                        // bf16 of a 64-byte-swizzled box row
constexpr int kBox128 = 64;                     // bf16 of a 128-byte-swizzled box row
constexpr int kVecFloats = 256;                 // a tile's per-word vectors
// dynamic shared memory of a kernel on this core: the ring, the barriers,
// two buffers of per-word vectors, and slack to align the ring to 1 KB
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 2 * kVecFloats * 4 + 1024;

// shared-memory descriptor layouts (bits 62-63)
enum Swizzle : uint64_t { kSw128 = 1, kSw64 = 2 };

struct Smem {
  uint32_t ring;        // shared address of stage 0, 1 KB aligned
  unsigned char* base;  // the same, as a pointer
  uint64_t* full;
  uint64_t* empty;
  float* vecs;          // [2][kVecFloats]
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ Smem carve(unsigned char* raw) {
  Smem s;
  const uint32_t base = smem_u32(raw);
  unsigned char* ring = raw + (((base + 1023u) & ~1023u) - base);
  s.ring = smem_u32(ring);
  s.base = ring;
  s.full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  s.empty = s.full + kStages;
  s.vecs = reinterpret_cast<float*>(s.empty + kStages);
  return s;
}

__device__ __forceinline__ uint32_t stage_a(const Smem& s, int stage) {
  return s.ring + stage * kStageBytes;
}
__device__ __forceinline__ uint32_t stage_b(const Smem& s, int stage) {
  return s.ring + stage * kStageBytes + kABytes;
}

// --- mbarriers -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// wait until the phase of parity `parity` has completed. Every wait of
// these kernels ends within microseconds; one that has not ended after 2^24
// polls is a fault, and traps (the launch fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// --- TMA -------------------------------------------------------------------
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// one box of a rank-3 map at (c0, c1, c2), innermost first, to shared
// address dst; completes on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// one box from shared address src to a rank-3 map at (c0, c1, c2); the
// parts outside the map's dims are not written. In the bulk group of the
// issuing thread: commit, then wait until the box has been read
// (tma_store_wait<N, true>) before the stage is reused, or until it is
// written (tma_store_wait<0, false>) before the thread exits.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N, bool kRead>
__device__ __forceinline__ void tma_store_wait() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of this thread made visible to TMA (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- the ring's position ----------------------------------------------------
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// --- warpgroup matrix products ----------------------------------------------
// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle of the layout
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo, Swizzle sw) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) | (static_cast<uint64_t>(sw) << 62);
}
// A or B K-contiguous in rows of 128 bytes (one 64-deep slice, 128-byte
// swizzle): 8-row groups 1 KB apart; step ks of 16 is 32 bytes into the row
__device__ __forceinline__ uint64_t desc_k128(uint32_t tile, int ks) {
  return desc(tile + ks * 32, 16, 1024, kSw128);
}
// B K-contiguous in boxes of [rows][32 k] (64-byte swizzle): 8-row groups
// 512 bytes apart, box s2 of a stage at tile + s2·box_bytes
__device__ __forceinline__ uint64_t desc_k64(uint32_t tile, int ks, uint32_t box_bytes) {
  return desc(tile + (ks >> 1) * box_bytes + (ks & 1) * 32, 16, 512, kSw64);
}
// A M-contiguous or B N-contiguous in boxes of [64 k][32 m or n] (64-byte
// swizzle, 4 KB each, the boxes of a stage side by side along M or N): a
// 32-wide atom to the next is 4 KB (leading offset), 8 k-rows 512 bytes
// (stride offset); step ks of 16 rows is 1 KB
__device__ __forceinline__ uint64_t desc_mn64(uint32_t tile, int ks) {
  return desc(tile + ks * 1024, kBK * kBox * 2, 512, kSw64);
}
// A M-contiguous or B N-contiguous in boxes of [64 k][64 m or n] (128-byte
// swizzle, 8 KB each, side by side along M or N): a 64-wide atom to the
// next is 8 KB (leading offset), 8 k-rows 1 KB (stride offset); step ks of
// 16 rows is 2 KB
__device__ __forceinline__ uint64_t desc_mn128(uint32_t tile, int ks) {
  return desc(tile + ks * 2048, kBK * kBox128 * 2, 1024, kSw128);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of the accumulators
// across a wgmma wait
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
// the two consumer warpgroups (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// d[64 × N] += A[64 × 16] · B[16 × N], bf16 operands from shared memory
// (descriptors), f32 accumulators: register 4j + 2h + e of a thread is row
// 16·warp + lane/4 + 8h, column 8j + 2·(lane % 4) + e. TRANS_A: 0 for a
// K-contiguous A, 1 for an M-contiguous one; TRANS_B: 0 for a K-contiguous
// B, 1 for an N-contiguous one.
template <int N>
struct Mma;

template <>
struct Mma<256> {
  template <int TRANS_A, int TRANS_B>
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
  }
};

template <>
struct Mma<192> {
  template <int TRANS_A, int TRANS_B>
  static __device__ __forceinline__ void run(float (&d)[96], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
  }
};


// The consumers' K loop over one tile: acc = Σ over the tile's nk stages,
// in order, of the four 16-deep products desc_a(stage, ks) · desc_b(stage,
// ks); each stage is released to the producer once its products are done.
template <int N, int TRANS_A, int TRANS_B, class DescA, class DescB>
__device__ __forceinline__ void consume(float (&acc)[N / 2], const Smem& s, Ring& ring, int nk,
                                        DescA desc_a, DescB desc_b) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  const bool signal = (threadIdx.x & 31) == 0;
  int prev = -1;
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(&s.full[ring.stage], ring.phase);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
      Mma<N>::template run<TRANS_A, TRANS_B>(acc, desc_a(ring.stage, ks),
                                             desc_b(ring.stage, ks));
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0 && signal) mbar_arrive(&s.empty[prev]);
    prev = ring.stage;
    ring.advance();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (prev >= 0 && signal) mbar_arrive(&s.empty[prev]);
}

// One step of a butterfly sum over lanes `mask` apart: lanes whose `mask`
// bit is set keep (and add their partner's) v[H..2H), the others v[0..H);
// the kept sums move to v[0..H). Three steps (masks 16, 8, 4) sum a
// column over a warp's eight row-lanes of the accumulators.
template <int H, int V>
__device__ __forceinline__ void fold(float (&v)[V], int lane, int mask) {
  const bool upper = lane & mask;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float kept = upper ? v[i + H] : v[i];
    v[i] = kept + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// An epilogue operand the producer loaded into the ring as a stage of its
// own: wait for it (acquire) and, once the warp has read it, hand the
// stage back (release: one arrival a warp, as consume's)
__device__ __forceinline__ const unsigned char* acquire(const Smem& s, const Ring& ring) {
  mbar_wait(&s.full[ring.stage], ring.phase);
  return s.base + ring.stage * kStageBytes;
}
__device__ __forceinline__ void release(const Smem& s, Ring& ring) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&s.empty[ring.stage]);
  ring.advance();
}

// A stage that the consumers fill and TMA stores (an output stage): the
// producer reserves it with a plain arrival on its full barrier (no bytes),
// so that acquire sees it free
__device__ __forceinline__ void reserve(const Smem& s, Ring& ring) {
  mbar_wait(&s.empty[ring.stage], ring.phase ^ 1u);
  mbar_arrive(&s.full[ring.stage]);
  ring.advance();
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a 128-byte-swizzled
// box of 128-byte rows (TMA's SWIZZLE_128B, the box 1 KB aligned)
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// Barrier set-up by thread 0, before the roles split: a full barrier takes
// the producer's one arrival and the stage's bytes, an empty one an arrival
// from each of the eight consumer warps.
__device__ __forceinline__ void init_barriers(const Smem& s) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();
}

}  // namespace wg

// --- host: tensor maps ---------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A rank-3 tensor map, bf16 unless `type` says otherwise: dims d0
// (contiguous), d1, d2; byte strides s1, s2 of dims 1 and 2; boxes of
// [b2][b1][b0] (b2 = 1 unless given) with the given swizzle; what lies
// outside the dims is read as zeros. False when the encoder refuses it.
static bool tensor_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
                       uint64_t s1, uint64_t s2, uint32_t b0, uint32_t b1,
                       CUtensorMapSwizzle swizzle,
                       CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       uint32_t b2 = 1) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, b2};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// SMs of the current device: the persistent grids' width
static int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 1;
  return n;
}
