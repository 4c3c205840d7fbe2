// K2's vocab projection on Hopper tensor cores (topk_project.cu): a block
// holds 128 rows of bf16(h) resident in shared memory and streams a chunk of
// W_out's 128-column tiles past them, handing each tile's 128 x 128 f32
// products to the caller's epilogue in registers. With topk_project.cu it
// replaces the streamed W_out product of vidcap_tpu/ops/pallas_topk.py's
// _kernel, and the first version's wmma tile (now K3's own, in rollout.cu).
//
// What bounds it: the tensor cores (15.1 GFLOP at the bench shape, ~15 us);
// alone it takes about three times that, because the 8 row tiles each read
// W_out from L2 (131 MB a step) and every 32-deep partial sum waits to be
// promoted (PERF.md).
//
// What bounded the first version (a wmma tile kernel, 1,875 blocks of 64 rows
// x 128 columns): every block re-read and re-cast its 64 f32 rows of h (h
// read 125 times a step, ~235 MB of L2 reads), W_out came in 16 synchronous
// 32-deep steps, and the products went through shared memory to the
// epilogue. Here:
//  - h is cast to bf16 once a step (topk_project.cu's cast kernel) and its
//    128 rows come to shared memory once per block by TMA (H <= 512: up to
//    128 KB, eight boxes of 64 deep x 128 rows);
//  - W_out tiles (four 32-column slabs of 64 deep a stage) arrive by TMA
//    through a 4-stage mbarrier ring kept full by one thread of a producer
//    warpgroup, while two consumer warpgroups (64 rows each) run wgmma
//    m64n128k16 on them, with 32-deep partial sums promoted into f32
//    registers (hopper.cuh);
//  - the epilogue reads the accumulator registers directly.
// Rows past N and columns past Vp arrive as zeros (TMA fill); the epilogue
// masks them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace vidcap {

constexpr int kProjRows = 128;   // two consumer warpgroups x 64 rows
constexpr int kProjCols = kWgCols;   // 128 columns a vocab tile
constexpr int kProjStages = 4;
// 2 consumer warpgroups + 1 producer warpgroup (one thread issues the TMA
// loads; the warpgroup hands its registers to the consumers, whose
// accumulators, partial sums and running top-K need more than 168 a thread)
constexpr int kProjThreads = 384;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kProjATile = kProjRows * kDepthStep * 2;   // 16 KB
constexpr int kProjBTile = 4 * kSlabBytes;               // 16 KB

__host__ __device__ inline int proj_depth_steps(int H) {
  return (H + kDepthStep - 1) / kDepthStep;
}

inline size_t proj_smem(int H) {
  return (size_t)proj_depth_steps(H) * kProjATile +
         (size_t)kProjStages * kProjBTile + (2 * kProjStages + 1) * 8 + 1024;
}

struct ProjRing {
  unsigned char* a;   // resident rows: one 16 KB box per 64 of depth
  unsigned char* b;   // the ring of W_out stages
  uint64_t* a_full;
  uint64_t* full;
  uint64_t* empty;
};

// Lays out the block's shared memory and initialises the barriers; every
// thread of the block calls it (it ends with a barrier).
__device__ __forceinline__ ProjRing proj_ring(unsigned char* smem_raw, int H) {
  unsigned char* smem = smem_aligned(smem_raw);
  ProjRing r;
  r.a = smem;
  r.b = smem + proj_depth_steps(H) * kProjATile;
  r.a_full = reinterpret_cast<uint64_t*>(r.b + kProjStages * kProjBTile);
  r.full = r.a_full + 1;
  r.empty = r.full + kProjStages;
  if (threadIdx.x == 0) {
    mbar_init(r.a_full, 1);
    for (int s = 0; s < kProjStages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 8);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  return r;
}

// The producer (one thread): rows row0.. of h16 once, then for each vocab
// tile in [tile0, tile1) its H/64 depth stages of W_out.
__device__ __forceinline__ void proj_produce(const ProjRing& r,
                                             const CUtensorMap* th,
                                             const CUtensorMap* tw, int row0,
                                             int tile0, int tile1, int H) {
  const int steps = proj_depth_steps(H);
  mbar_expect_tx(r.a_full, steps * kProjATile);
  for (int ks = 0; ks < steps; ++ks)
    tma_load(r.a + ks * kProjATile, th, ks * kDepthStep, row0, r.a_full);
  int it = 0;
  for (int tile = tile0; tile < tile1; ++tile)
    for (int ks = 0; ks < steps; ++ks, ++it) {
      const int s = it % kProjStages, round = it / kProjStages;
      if (round > 0) mbar_wait(&r.empty[s], (round - 1) & 1);
      mbar_expect_tx(&r.full[s], kProjBTile);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        tma_load(r.b + s * kProjBTile + q * kSlabBytes, tw,
                 tile * kProjCols + q * kSlabCols, ks * kDepthStep, &r.full[s]);
    }
}

// A consumer warpgroup (`wg` = 0 or 1, rows 64 wg..): for each tile, the
// products acc = bf16(h rows) . W_out[:, tile columns], then epi(acc, tile).
template <typename Epi>
__device__ __forceinline__ void proj_consume(const ProjRing& r, int wg,
                                             int tile0, int tile1, int H,
                                             Epi& epi) {
  const int steps = proj_depth_steps(H);
  const int lane = threadIdx.x % 32;
  mbar_wait(r.a_full, 0);
  float acc[kAccRegs], part[kAccRegs];
  int it = 0;
  for (int tile = tile0; tile < tile1; ++tile) {
#pragma unroll
    for (int i = 0; i < kAccRegs; ++i) acc[i] = 0.f;
    for (int ks = 0; ks < steps; ++ks, ++it) {
      const int s = it % kProjStages;
      mbar_wait(&r.full[s], (it / kProjStages) & 1);
      mma_depth_step(acc, part,
                     smem_u32(r.a + ks * kProjATile + wg * 64 * 128),
                     smem_u32(r.b + s * kProjBTile));
      __syncwarp();
      if (lane == 0) mbar_arrive(&r.empty[s]);
    }
    epi(acc, tile);
  }
}

}  // namespace vidcap
