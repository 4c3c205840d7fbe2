// K2 topk_project: vocab projection + padding mask + per-row top-K + lse.
//
// Replaces vidcap_tpu/ops/pallas_topk.py::topk_project (_kernel,
// _merge_topk), which streams W_out through VMEM in tiles on one core and
// carries a running top-K and logsumexp from tile to tile.
//
// What bounds it on the H100: at the bench shape (N = B*K = 920, H = 512,
// Vp = 16,000) the product is 2*920*512*16000 = 15.1 GFLOP (~15 us at 989
// TFLOP/s bf16) against 16.4 MB of W_out (~4.9 us at 3.35 TB/s): bound by
// the tensor cores. The [N, Vp] logits (59 MB in f32) never reach memory.
// The first version (one block per 64-row x 128-column tile, 1,875 blocks,
// wmma, per-tile partials merged in a second pass) took ~21x the bound.
//
// Design, three launches on the caller's stream:
//  (a) cast_kernel: h16 = bf16(h), once a step (the TMA operand).
//  (b) chunk_kernel: the TPU kernel's running carry, re-thought for blocks.
//      Grid (128-row tiles) x (vocab chunks), with the chunk count chosen by
//      the wrapper so that the grid fills the SMs once (8 x 16 blocks at the
//      bench shape). A block owns one row tile and a contiguous chunk of
//      128-column vocab tiles; it runs the TMA + wgmma product of
//      projection.cuh over them (a producer warpgroup, two consumer
//      warpgroups that take its registers) and carries, per row, a running
//      max, exp-sum and top-K in registers across its chunk. The epilogue
//      works on the accumulator registers: the exact rounding chain
//      f32(bf16(bf16(acc) + bf16(b))), columns >= vocab_size at -1e30,
//      columns past Vp never candidates; the f32 exp-sum with exp2f (the
//      card's ex2; the lse it feeds is f32 and rounded nowhere). Each row's
//      columns are spread over the four lanes of a quad; a candidate below
//      the quad's K-th best so far costs one compare. At the chunk's end the
//      quad merges its maxima, sums and lists with shuffles and writes one
//      partial per (row, chunk): 16 a row at the bench shape, not 125.
//  (c) merge_kernel: a warp per row merges the chunks: lse = m + log(max(s,
//      1e-30)) and the global top-K, then writes (value - lse, column).
// Ties go to the smallest column everywhere (vidcap::before): within a lane
// (the first maximum of its columns is taken first), across a quad, and
// across chunks, so the result equals a stable descending sort of the row.
// What holds it back now: the epilogue runs after each tile's product on
// the same warpgroups, so it adds to the product's time instead of hiding
// under it, and the 128-row tiles re-read W_out from L2 8 times a step.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "hopper.cuh"
#include "projection.cuh"

using bf16 = __nv_bfloat16;
using namespace vidcap;

namespace {

constexpr int kMaxK = 8;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
cast_kernel(const float* __restrict__ h, bf16* __restrict__ h16, int n8) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v < n8)
    reinterpret_cast<uint4*>(h16)[v] = bf16x8(h + (size_t)v * 8);
}

// Warp-wide argmax in the (value desc, index asc) order over the lanes
// lane ^ o for the given offsets.
template <int First>
__device__ __forceinline__ void best_over(float& v, int& i) {
#pragma unroll
  for (int o = First; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// the highest of v over the four lanes of the quad (they share a row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// one level of the tree: pair (2i, 2i+1) into i, the left one on a tie
template <int W>
__device__ __forceinline__ void argmax_level(float (&v)[16], int (&p)[16]) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const bool right = v[2 * i + 1] > v[2 * i];
    v[i] = right ? v[2 * i + 1] : v[2 * i];
    p[i] = right ? p[2 * i + 1] : p[2 * i];
  }
}

// The largest of a lane's 32 values of row hh (acc[4i + 2hh + e], j = 2i + e
// in column order) and its j, the first one on a tie. A tree of depth 5:
// the epilogue runs two warps on each SM sub-partition, too few to hide a
// chain of 32 dependent compares.
__device__ __forceinline__ void lane_argmax(const float (&acc)[kAccRegs],
                                            int hh, float& best, int& at) {
  float v[16];
  int p[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float a = acc[4 * i + 2 * hh], b = acc[4 * i + 2 * hh + 1];
    v[i] = b > a ? b : a;
    p[i] = b > a ? 2 * i + 1 : 2 * i;
  }
  argmax_level<8>(v, p);
  argmax_level<4>(v, p);
  argmax_level<2>(v, p);
  argmax_level<1>(v, p);
  best = v[0];
  at = p[0];
}

// The largest of a lane's 32 values of row hh, by the same tree.
__device__ __forceinline__ float lane_max(const float (&acc)[kAccRegs],
                                          int hh) {
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    v[i] = fmaxf(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = fmaxf(v[2 * i], v[2 * i + 1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = fmaxf(v[2 * i], v[2 * i + 1]);
  return fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
}

// bf16 rounding of a pair of floats (one conversion instruction)
__device__ __forceinline__ float2 bf16r2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

constexpr float kLog2e = 1.4426950408889634f;

// A thread's running state for its two rows over the chunk: max, exp-sum
// relative to it, and its best candidates (value, column), best first. The
// list holds kMaxK slots; only the first K matter, and (thr_v, thr_i), the
// K-th, is the bar a new candidate has to clear in its list.
struct ChunkCarry {
  const float* b;
  int Vp, vocab, K;
  float m[2], s[2];
  float tv[2][kMaxK];
  int ti[2][kMaxK];
  float thr_v[2];
  int thr_i[2];

  __device__ void init() {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[hh] = -INFINITY;
      s[hh] = 0.f;
      thr_v[hh] = -INFINITY;
      thr_i[hh] = INT_MAX;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        tv[hh][j] = -INFINITY;
        ti[hh][j] = INT_MAX;
      }
    }
  }

  // (v, c) into row hh's sorted list (it clears the bar), then the new bar
  __device__ __forceinline__ void insert(int hh, float v, int c) {
    tv[hh][kMaxK - 1] = v;
    ti[hh][kMaxK - 1] = c;
#pragma unroll
    for (int j = kMaxK - 1; j > 0; --j)
      if (before(tv[hh][j], ti[hh][j], tv[hh][j - 1], ti[hh][j - 1])) {
        const float x = tv[hh][j];
        const int y = ti[hh][j];
        tv[hh][j] = tv[hh][j - 1];
        ti[hh][j] = ti[hh][j - 1];
        tv[hh][j - 1] = x;
        ti[hh][j - 1] = y;
      }
#pragma unroll
    for (int j = 0; j < kMaxK; ++j)
      if (j == K - 1) {
        thr_v[hh] = tv[hh][j];
        thr_i[hh] = ti[hh][j];
      }
  }

  // one vocab tile's products, in the accumulator registers; the lane's
  // column for acc[4i + 2hh + e] is col0 + 8i + e
  __device__ void operator()(float (&acc)[kAccRegs], int tile) {
    const int col0 = tile * kProjCols + frag_col(0);
    if ((tile + 1) * kProjCols <= vocab) {   // every column real, in vocab
#pragma unroll
      for (int i = 0; i < kAccRegs / 4; ++i) {
        const float2 bp = *reinterpret_cast<const float2*>(b + col0 + 8 * i);
        const float2 bb = bf16r2(bp.x, bp.y);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 x = bf16r2(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
          const float2 y = bf16r2(x.x + bb.x, x.y + bb.y);
          acc[4 * i + 2 * hh] = y.x;
          acc[4 * i + 2 * hh + 1] = y.y;
        }
      }
    } else {   // the ragged end: -1e30 past vocab_size, never a pick past Vp
#pragma unroll
      for (int i = 0; i < kAccRegs / 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * i + e;
          const float bb = col < Vp ? bf16r(b[col]) : 0.f;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float& x = acc[4 * i + 2 * hh + e];
            x = col >= Vp ? -INFINITY
                          : col < vocab ? bf16r(bf16r(x) + bb) : kNeg;
          }
        }
    }
    select(acc, col0);
  }

  // One tile's logits (acc, in the accumulator layout, columns past Vp at
  // -inf) into the running max, exp-sum and top-K of the thread's two rows;
  // `col0` is the lane's column of acc[0].
  __device__ void select(float (&acc)[kAccRegs], int col0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float mt = lane_max(acc, hh);
      const float mn = fmaxf(m[hh], mt);
      if (mn > -INFINITY) {   // the f32 exp-sum; exp2f is the card's ex2
        float part[4] = {
            m[hh] > -INFINITY ? s[hh] * exp2f((m[hh] - mn) * kLog2e) : 0.f,
            0.f, 0.f, 0.f};   // four sums in flight, not one chain
#pragma unroll
        for (int i = 0; i < kAccRegs / 4; ++i)
          part[i % 4] += exp2f((acc[4 * i + 2 * hh] - mn) * kLog2e) +
                         exp2f((acc[4 * i + 2 * hh + 1] - mn) * kLog2e);
        s[hh] = (part[0] + part[1]) + (part[2] + part[3]);
        m[hh] = mn;
      }
      // the lane's candidates that clear the bar, best first: each round
      // takes the best left (the first maximum: the smallest column) and
      // removes it; a lane whose tile maximum is below the bar has none.
      // The bar is the highest of the quad's K-th values: K of the row's
      // candidates reach it, so nothing below it is in the row's top-K.
      const float quad_bar = quad_max(thr_v[hh]);
      bool active = mt > -INFINITY && mt >= quad_bar;
      while (__any_sync(0xffffffffu, active)) {
        if (active) {
          float bv;
          int bj;
          lane_argmax(acc, hh, bv, bj);
          const int bc = col0 + 8 * (bj / 2) + (bj % 2);
          if (bv > -INFINITY && bv >= quad_bar &&
              before(bv, bc, thr_v[hh], thr_i[hh])) {
            insert(hh, bv, bc);
#pragma unroll
            for (int j = 0; j < kAccRegs / 2; ++j)
              if (j == bj) acc[4 * (j / 2) + 2 * hh + (j % 2)] = -INFINITY;
          } else {
            active = false;
          }
        }
      }
    }
  }

  // Merges the quad (the four lanes that share a row) and writes the
  // partials of the thread's rows row_base + frag_row(hh) for `chunk`.
  __device__ void flush(int row_base, int N, int chunk, int n_chunks,
                        float* __restrict__ cm, float* __restrict__ cs,
                        float* __restrict__ cv, int* __restrict__ ci) {
    const bool writer = threadIdx.x % 4 == 0;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row_base + frag_row(hh);
      const float mq = quad_max(m[hh]);
      float sq = m[hh] > -INFINITY ? s[hh] * expf(m[hh] - mq) : 0.f;
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      const size_t o = (size_t)row * n_chunks + chunk;
      if (writer && row < N) {
        cm[o] = mq;
        cs[o] = sq;
      }
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        float bv = tv[hh][0];
        int bi = ti[hh][0];
        best_over<2>(bv, bi);
        if (ti[hh][0] == bi) {   // taken: the lane's list moves up
#pragma unroll
          for (int j = 0; j < kMaxK - 1; ++j) {
            tv[hh][j] = tv[hh][j + 1];
            ti[hh][j] = ti[hh][j + 1];
          }
          tv[hh][kMaxK - 1] = -INFINITY;
          ti[hh][kMaxK - 1] = INT_MAX;
        }
        if (writer && row < N && k < K) {
          cv[o * K + k] = bv;
          ci[o * K + k] = bi;
        }
      }
    }
  }
};

__global__ void __launch_bounds__(kProjThreads, 1)
chunk_kernel(const __grid_constant__ CUtensorMap th,
             const __grid_constant__ CUtensorMap tw,
             const float* __restrict__ b, float* __restrict__ cm,
             float* __restrict__ cs, float* __restrict__ cv,
             int* __restrict__ ci, int N, int H, int Vp, int K, int vocab,
             int n_tiles, int tiles_per_chunk) {
  extern __shared__ unsigned char smem_raw[];
  const ProjRing ring = proj_ring(smem_raw, H);
  const int row0 = blockIdx.x * kProjRows, chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  const int tile0 = chunk * tiles_per_chunk;
  const int tile1 = min(tile0 + tiles_per_chunk, n_tiles);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {   // producer warpgroup
    regs_release<kProducerRegs>();
    if (threadIdx.x == 256)
      proj_produce(ring, &th, &tw, row0, tile0, tile1, H);
    return;
  }
  regs_claim<kConsumerRegs>();
  ChunkCarry carry;
  carry.b = b;
  carry.Vp = Vp;
  carry.vocab = vocab;
  carry.K = K;
  carry.init();
  proj_consume(ring, wg, tile0, tile1, H, carry);

  carry.flush(row0 + wg * 64, N, chunk, n_chunks, cm, cs, cv, ci);
}

// chunk_kernel for H > kProjMaxResident: the block's rows stream through
// the ring beside W_out (projection.cuh, proj_*_stream).
__global__ void __launch_bounds__(kProjThreads, 1)
chunk_stream_kernel(const __grid_constant__ CUtensorMap th,
                    const __grid_constant__ CUtensorMap tw,
                    const float* __restrict__ b, float* __restrict__ cm,
                    float* __restrict__ cs, float* __restrict__ cv,
                    int* __restrict__ ci, int N, int H, int Vp, int K,
                    int vocab, int n_tiles, int tiles_per_chunk) {
  extern __shared__ unsigned char smem_raw[];
  const ProjRing ring = proj_ring_stream(smem_raw);
  const int row0 = blockIdx.x * kProjRows, chunk = blockIdx.y;
  const int tile0 = chunk * tiles_per_chunk;
  const int tile1 = min(tile0 + tiles_per_chunk, n_tiles);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {   // producer warpgroup
    regs_release<kProducerRegs>();
    if (threadIdx.x == 256)
      proj_produce_stream(ring, &th, &tw, row0, tile0, tile1, H);
    return;
  }
  regs_claim<kConsumerRegs>();
  ChunkCarry carry;
  carry.b = b;
  carry.Vp = Vp;
  carry.vocab = vocab;
  carry.K = K;
  carry.init();
  proj_consume_stream(ring, wg, tile0, tile1, H, carry);
  carry.flush(row0 + wg * 64, N, chunk, gridDim.y, cm, cs, cv, ci);
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ cm, const float* __restrict__ cs,
             const float* __restrict__ cv, const int* __restrict__ ci,
             float* __restrict__ vals, int* __restrict__ idx, int N, int K,
             int n_chunks) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= N) return;
  const float* rm = cm + (size_t)row * n_chunks;
  const float* rs = cs + (size_t)row * n_chunks;
  float m = -INFINITY;
  for (int t = lane; t < n_chunks; t += 32) m = fmaxf(m, rm[t]);
  m = warp_max(m);
  float s = 0.f;
  for (int t = lane; t < n_chunks; t += 32)
    if (rm[t] > -INFINITY) s += rs[t] * expf(rm[t] - m);
  s = warp_sum(s);
  const float lse = m + logf(fmaxf(s, 1e-30f));

  const float* rv = cv + (size_t)row * n_chunks * K;
  const int* ri = ci + (size_t)row * n_chunks * K;
  const int total = n_chunks * K;
  float last_v = INFINITY;   // the previous pick; candidates come after it
  int last_i = -1;
  for (int k = 0; k < K; ++k) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int p = lane; p < total; p += 32) {
      const float x = rv[p];
      const int c = ri[p];
      if (before(last_v, last_i, x, c) && before(x, c, bv, bi)) {
        bv = x;
        bi = c;
      }
    }
    best_over<16>(bv, bi);
    if (lane == 0) {
      vals[(size_t)row * K + k] = bv - lse;
      idx[(size_t)row * K + k] = bi;
    }
    last_v = bv;
    last_i = bi;
  }
}

// ---- K2's int8 variant -------------------------------------------------------
//
// The beam step's projection with decode.int8_vocab_projection. It replaces
// vidcap_tpu/ops/int8_proj.py:int8_logits (:75, the quantization :58; XLA,
// no Pallas kernel), bf16(f32(h8 . W8) * (hscale * wscale) + bq), and the
// top-K and lse that the JAX package's beam takes of those logits, which
// here are K2's (vidcap_tpu/ops/pallas_topk.py:117: ChunkCarry, merge_kernel).
// Three launches, as K2's:
//  (a) quantize_kernel: a warp a row, hscale = max|h| / 127 and h8 =
//      clip(rint(h / max(hscale, 1e-8)), -127, 127), with IEEE division
//      (__fdiv_rn) and round-half-even (rintf), as jnp.round and torch.round;
//      h8 and hscale are left in the scratch (the wrapper can return them).
//  (b) chunk_s8_kernel: K2's grid of (128-row tile, vocab chunk) blocks. A
//      producer warpgroup (one thread issues the TMA loads; the warpgroup
//      gives its registers to the consumers) brings the block's 128 rows of
//      h8 once, in boxes of 128 bytes of depth (zeros past H and past N),
//      then streams W8 stored transposed [Vp, H] (K-major, as wgmma's s8
//      operands must be) in stages of 128 columns x 128 bytes (16 KB)
//      through an mbarrier ring, and each tile's 128 wscale and bq with it
//      (a side ring of 4 tiles). Two consumer warpgroups of 64 rows run
//      wgmma m64n128k32 s8 x s8 -> s32 from shared-memory descriptors: a
//      tile is H/32 k32 steps, one commit group a stage, and a stage goes
//      back to the producer as soon as its group has completed. The int32
//      sums are exact (|sum| <= 127^2 * H < 2^31), so nothing is promoted.
//      The epilogue reads the accumulator registers: the reference's
//      rounding chain with explicit _rn intrinsics, so that nvcc contracts
//      nothing into an FMA, then ChunkCarry's running max, exp-sum and
//      top-K (columns past Vp never candidates; ties to the smaller
//      column).
//  (c) merge_kernel, K2's.
// The ring holds two tiles' stages where shared memory allows (8 at H <=
// 512) and at least 4 (5 at H = 1024, fewer than a tile's 8: hence a
// commit group a stage, not a tile). Shared memory s8_smem(H) (mirrored in
// ops/int8_proj.py; ops/limits.py routes by it) is 197 KB at H = 512 and
// 213 KB at H = 1024; the kernel takes H up to 1152.
// What bounds it: 15.1 G int8 operations at the bench shape (N = 920, H =
// 512, Vp = 16,000: 7.6 us at 1,979 TOPS) against 8.2 MB of W8 (2.4 us at
// 3.35 TB/s). What held the mma.sync version back, and what this one does:
// mma.sync fed from padded shared rows by the warps themselves -> wgmma from
// TMA-filled swizzled tiles; W8 re-read from L2 by each of 15 64-row tiles
// (123 MB a step) -> 8 128-row tiles (65 MB); the epilogue after each
// tile's product on the same warps -> still so, and why: the 384-thread
// block (three warps on each SM sub-partition) gets 168 registers a thread
// from ptxas whatever setmaxnreg then grants, and a second set of 64
// accumulators on top of the 64 logits and the 40-register carry spills
// the set in flight, which serializes the wgmmas (a build with two sets
// spilled 872 bytes and ran about 2x slower on an H100: PERF.md); 64-column
// tiles halve the sets but double the select epilogue's fixed work a
// column (built, and slower on the same card). The ring holds two tiles'
// stages, so the next tile's loads are issued during the epilogue. What
// holds it back now: ChunkCarry::select, about 60% of the kernel, most of
// it the candidate loop (int8_no_topk, int8_no_select in the ablation);
// then the TMA stream of W8, most of the product's time even with no
// wgmma (int8_loads_only).

constexpr int kS8Rows = kProjRows;   // two consumer warpgroups x 64 rows
constexpr int kS8Box = 128;          // bytes of depth in a box and a stage
constexpr int kS8ATile = kS8Rows * kS8Box;   // 16 KB: one box of rows
constexpr int kS8BTile = kProjCols * kS8Box;   // 16 KB: one ring stage
constexpr int kS8MinStages = 4, kS8MaxStages = 8;
constexpr int kS8Side = 4;   // tiles of (wscale, bq) in the side ring
constexpr int kS8SideBytes = 2 * kProjCols * 4;   // 1 KB a tile
// alignment slack (smem_aligned), the side ring, 256 bytes of barriers
constexpr int kS8Fixed = 1024 + kS8Side * kS8SideBytes + 256;
constexpr int kS8SmemCap = 232448;   // what an H100 block may opt into
static_assert(2 * kS8MaxStages + 2 * kS8Side + 1 <= 256 / 8, "barriers");

__host__ __device__ inline int s8_depth_boxes(int H) {
  return (H + kS8Box - 1) / kS8Box;
}

// Ring stages at hidden width H: two tiles' worth, at least kS8MinStages
// and at most kS8MaxStages, as far as kS8SmemCap allows (< kS8MinStages:
// the kernel does not take H).
inline int s8_stages(int H) {
  const int fit =
      (kS8SmemCap - kS8Fixed - s8_depth_boxes(H) * kS8ATile) / kS8BTile;
  const int two_tiles = 2 * s8_depth_boxes(H);
  const int want = two_tiles < kS8MinStages   ? kS8MinStages
                   : two_tiles > kS8MaxStages ? kS8MaxStages
                                              : two_tiles;
  return want < fit ? want : fit;
}

inline size_t s8_smem(int H) {
  return kS8Fixed + (size_t)s8_depth_boxes(H) * kS8ATile +
         (size_t)s8_stages(H) * kS8BTile;
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ h, int8_t* __restrict__ h8,
                float* __restrict__ hs, int N, int H) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= N) return;
  const float* r = h + (size_t)row * H;
  float m = 0.f;
  for (int j = lane; j < H; j += 32) m = fmaxf(m, fabsf(r[j]));
  m = warp_max(m);
  const float scale = __fdiv_rn(m, 127.f);
  const float guard = fmaxf(scale, 1e-8f);
  for (int j = lane; j < H; j += 32)
    h8[(size_t)row * H + j] = static_cast<int8_t>(
        fminf(fmaxf(rintf(__fdiv_rn(r[j], guard)), -127.f), 127.f));
  if (lane == 0) hs[row] = scale;
}

struct S8Ring {
  unsigned char* a;   // the block's rows of h8: one 16 KB box a 128 deep
  unsigned char* b;   // the ring of W8 stages
  float* side;        // per side slot: wscale[128], then bq[128]
  uint64_t* bars;     // a_full, full[], empty[], side_full[], side_empty[]
  int boxes, stages;

  __device__ __forceinline__ uint64_t* a_full() const { return bars; }
  __device__ __forceinline__ uint64_t* full(int s) const { return bars + 1 + s; }
  __device__ __forceinline__ uint64_t* empty(int s) const {
    return bars + 1 + kS8MaxStages + s;
  }
  __device__ __forceinline__ uint64_t* side_full(int s) const {
    return bars + 1 + 2 * kS8MaxStages + s;
  }
  __device__ __forceinline__ uint64_t* side_empty(int s) const {
    return bars + 1 + 2 * kS8MaxStages + kS8Side + s;
  }
};

// Lays out the block's shared memory and initialises the barriers; every
// thread of the block calls it (it ends with a barrier).
__device__ __forceinline__ S8Ring s8_ring(unsigned char* smem_raw, int H,
                                          int stages) {
  S8Ring r;
  r.boxes = s8_depth_boxes(H);
  r.stages = stages;
  r.a = smem_aligned(smem_raw);
  r.b = r.a + r.boxes * kS8ATile;
  r.side = reinterpret_cast<float*>(r.b + stages * kS8BTile);
  r.bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(r.side) + kS8Side * kS8SideBytes);
  if (threadIdx.x == 0) {
    mbar_init(r.a_full(), 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), 8);   // one arrival per consumer warp
    }
    for (int s = 0; s < kS8Side; ++s) {
      mbar_init(r.side_full(s), 1);
      mbar_init(r.side_empty(s), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return r;
}

// The producer (one thread): rows row0.. of h8 once, then for each vocab
// tile in [tile0, tile1) its wscale and bq and its H/128 stages of W8.
__device__ __forceinline__ void s8_produce(const S8Ring& r,
                                           const CUtensorMap* th,
                                           const CUtensorMap* tw,
                                           const CUtensorMap* tws,
                                           const CUtensorMap* tbq, int row0,
                                           int tile0, int tile1) {
  mbar_expect_tx(r.a_full(), r.boxes * kS8ATile);
  for (int kb = 0; kb < r.boxes; ++kb)
    tma_load(r.a + kb * kS8ATile, th, kb * kS8Box, row0, r.a_full());
  int it = 0;
  for (int tile = tile0, n = 0; tile < tile1; ++tile, ++n) {
    const int sl = n % kS8Side;
    if (n >= kS8Side) mbar_wait(r.side_empty(sl), (n / kS8Side - 1) & 1);
    mbar_expect_tx(r.side_full(sl), kS8SideBytes);
    float* side = r.side + sl * 2 * kProjCols;
    tma_load(side, tws, tile * kProjCols, 0, r.side_full(sl));
    tma_load(side + kProjCols, tbq, tile * kProjCols, 0, r.side_full(sl));
    for (int kb = 0; kb < r.boxes; ++kb, ++it) {
      const int s = it % r.stages;
      if (it >= r.stages) mbar_wait(r.empty(s), (it / r.stages - 1) & 1);
      mbar_expect_tx(r.full(s), kS8BTile);
      tma_load(r.b + s * kS8BTile, tw, kb * kS8Box, tile * kProjCols,
               r.full(s));
    }
  }
}

// A consumer warpgroup's place in the ring: `it` stages issued, `rel`
// released (stages [rel, it) hold wgmma groups not known to be complete).
struct S8Pipe {
  S8Ring r;
  int wg, it, rel;

  // every stage before `upto` back to the producer (one arrival a warp)
  __device__ __forceinline__ void release(int upto) {
    for (; rel < upto; ++rel) {
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(r.empty(rel % r.stages));
    }
  }

  // stage `it` (depth box kb of its tile): wait until its slot is free of
  // the stage `stages` back and loaded, then its four k32 wgmmas, one group
  template <bool First>
  __device__ __forceinline__ void stage(int (&acc)[kAccRegs], int kb) {
    if (it - r.stages >= rel) {   // groups after that stage: stages - 1
      wgmma_wait_upto(r.stages - 1);
      release(it - r.stages + 1);
    }
    const int s = it % r.stages;
    mbar_wait(r.full(s), (it / r.stages) & 1);
    const uint32_t a = smem_u32(r.a + kb * kS8ATile + wg * 64 * kS8Box);
    const uint32_t b = smem_u32(r.b + s * kS8BTile);
    wgmma_fence();
    if constexpr (First)
      wgmma_s8_first(acc, desc_a(a), desc_a(b));
    else
      wgmma_s8(acc, desc_a(a), desc_a(b));
#pragma unroll
    for (int k = 1; k < kS8Box / 32; ++k)
      wgmma_s8(acc, desc_a(a + 32 * k), desc_a(b + 32 * k));
    wgmma_commit();
    ++it;
  }

  // a whole tile's product into acc, issued and left in flight
  __device__ __forceinline__ void issue(int (&acc)[kAccRegs]) {
    stage<true>(acc, 0);
    for (int kb = 1; kb < r.boxes; ++kb) stage<false>(acc, kb);
  }

  // wait for the tile's product and give its stages back
  __device__ __forceinline__ void finish() {
    wgmma_wait_upto(0);
    release(it);
  }
};

// The epilogue of tile `tile` (the n-th of the block) in acc: the
// reference's rounding chain, then the carry's running max, exp-sum and
// top-K; hsr the thread's two rows' hscale.
__device__ __forceinline__ void s8_epilogue(int (&acc)[kAccRegs], int tile,
                                            int n, const S8Ring& ring,
                                            const float (&hsr)[2],
                                            ChunkCarry& carry, int Vp) {
  fence_regs(acc);
  const int sl = n % kS8Side;
  mbar_wait(ring.side_full(sl), (n / kS8Side) & 1);
  const float* sw = ring.side + sl * 2 * kProjCols;
  // the reference's rounding chain; columns past Vp are never candidates
  const int col0 = tile * kProjCols + frag_col(0);
  float x[kAccRegs];
#pragma unroll
  for (int j = 0; j < kAccRegs / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = frag_col(j) + e;   // the column in the tile
      const bool in = tile * kProjCols + c < Vp;
      const float wsc = sw[c], bqc = sw[kProjCols + c];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 4 * j + 2 * hh + e;
        x[r] = in ? bf16r(__fadd_rn(
                        __fmul_rn((float)acc[r], __fmul_rn(hsr[hh], wsc)),
                        bqc))
                  : -INFINITY;
      }
    }
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(ring.side_empty(sl));
  carry.select(x, col0);
}

__global__ void __launch_bounds__(kProjThreads, 1)
chunk_s8_kernel(const __grid_constant__ CUtensorMap th,
                const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap tws,
                const __grid_constant__ CUtensorMap tbq,
                const float* __restrict__ hs, float* __restrict__ cm,
                float* __restrict__ cs, float* __restrict__ cv,
                int* __restrict__ ci, int N, int H, int Vp, int K,
                int stages, int n_tiles, int tiles_per_chunk) {
  extern __shared__ unsigned char smem_raw[];
  const S8Ring ring = s8_ring(smem_raw, H, stages);
  const int row0 = blockIdx.x * kS8Rows, chunk = blockIdx.y;
  const int tile0 = chunk * tiles_per_chunk;
  const int tile1 = min(tile0 + tiles_per_chunk, n_tiles);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {   // producer warpgroup
    regs_release<kProducerRegs>();
    if (threadIdx.x == 256)
      s8_produce(ring, &th, &tw, &tws, &tbq, row0, tile0, tile1);
    return;
  }
  regs_claim<kConsumerRegs>();
  ChunkCarry carry;
  carry.Vp = Vp;
  carry.K = K;
  carry.init();
  float hsr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + wg * 64 + frag_row(hh);
    hsr[hh] = row < N ? hs[row] : 0.f;
  }
  S8Pipe p{ring, wg, 0, 0};
  mbar_wait(ring.a_full(), 0);
  int acc[kAccRegs];
  for (int n = 0; n < tile1 - tile0; ++n) {
    p.issue(acc);
    p.finish();
    s8_epilogue(acc, tile0 + n, n, ring, hsr, carry, Vp);
  }
  carry.flush(row0 + wg * 64, N, chunk, gridDim.y, cm, cs, cv, ci);
}

}  // namespace

// Plain C entry point (loaded with ctypes). h [N, H] f32, w [H, Vp] bf16,
// b [Vp] f32; scratch h16 [N, H] bf16, cm/cs [N, n_chunks] f32, cv
// [N, n_chunks, K] f32, ci [N, n_chunks, K] i32, where chunk c covers the
// 128-column vocab tiles c * tiles_per_chunk.. and n_chunks * tiles_per_chunk
// >= ceil(Vp / 128); out vals [N, K] f32, idx [N, K] i32. Needs H % 32 == 0,
// Vp % 8 == 0, 1 <= K <= min(8, Vp); H up to kProjMaxResident keeps the
// rows resident (chunk_kernel), wider H streams them (chunk_stream_kernel).
// Returns the cudaError_t of the launches, or kTensorMapError + CUresult if a
// TMA map cannot be made (0 on success).
extern "C" int vidcap_topk_project(const void* h, const void* w, const void* b,
                                   void* h16, void* cm, void* cs, void* cv,
                                   void* ci, void* vals, void* idx, int N,
                                   int H, int Vp, int K, int vocab,
                                   int tiles_per_chunk, int n_chunks,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap th, tw;
  int err = make_tmap(&th, h16, H, N, H, kDepthStep, kProjRows);
  if (!err) err = make_tmap(&tw, w, Vp, H, Vp, kSlabCols, kDepthStep);
  if (err) return err;
  const bool streamed = H > kProjMaxResident;
  err = streamed ? allow_max_smem<chunk_stream_kernel>()
                 : allow_max_smem<chunk_kernel>();
  if (err) return err;
  const int n8 = N * H / 8;
  cast_kernel<<<(n8 + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(h), static_cast<bf16*>(h16), n8);
  const int n_tiles = (Vp + kProjCols - 1) / kProjCols;
  const dim3 grid((N + kProjRows - 1) / kProjRows, n_chunks);
  if (streamed)
    chunk_stream_kernel<<<grid, kProjThreads, proj_smem_stream(), s>>>(
        th, tw, static_cast<const float*>(b), static_cast<float*>(cm),
        static_cast<float*>(cs), static_cast<float*>(cv),
        static_cast<int*>(ci), N, H, Vp, K, vocab, n_tiles, tiles_per_chunk);
  else
    chunk_kernel<<<grid, kProjThreads, proj_smem(H), s>>>(
        th, tw, static_cast<const float*>(b), static_cast<float*>(cm),
        static_cast<float*>(cs), static_cast<float*>(cv),
        static_cast<int*>(ci), N, H, Vp, K, vocab, n_tiles, tiles_per_chunk);
  const int rows_per_block = kThreads / 32;
  merge_kernel<<<(N + rows_per_block - 1) / rows_per_block, kThreads, 0, s>>>(
      static_cast<const float*>(cm), static_cast<const float*>(cs),
      static_cast<const float*>(cv), static_cast<const int*>(ci),
      static_cast<float*>(vals), static_cast<int*>(idx), N, K, n_chunks);
  return (int)cudaGetLastError();
}

// Plain C entry point of the int8 variant. h [N, H] f32, w8t [Vp, H] s8
// (W8 transposed), ws [Vp] f32 (per-column scale), bq [Vp] f32 (the bias,
// -1e30 past the vocab); scratch h8 [N, H] s8 and hs [N] f32 (the
// quantized rows and their scales, as the reference computes them), cm/cs
// [N, n_chunks] f32, cv [N, n_chunks, K] f32, ci [N, n_chunks, K] i32 over
// 128-row tiles and 128-column vocab tiles as vidcap_topk_project's; out
// vals [N, K] f32, idx [N, K] i32. Needs H % 32 == 0 with s8_stages(H) >=
// kS8MinStages (H <= 1152), 1 <= K <= min(8, Vp), every pointer 16-byte
// aligned. Returns the cudaError_t of the launches, or kTensorMapError +
// CUresult if a TMA map cannot be made (0 on success).
extern "C" int vidcap_topk_project_int8(const void* h, const void* w8t,
                                        const void* ws, const void* bq,
                                        void* h8, void* hs, void* cm, void* cs,
                                        void* cv, void* ci, void* vals,
                                        void* idx, int N, int H, int Vp, int K,
                                        int tiles_per_chunk, int n_chunks,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int stages = s8_stages(H);
  if (H % 32 != 0 || stages < kS8MinStages)
    return (int)cudaErrorInvalidValue;
  constexpr CUtensorMapDataType kU8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const uint64_t vec = (Vp + 3) & ~3;   // one row; its stride 16-byte whole
  CUtensorMap th, tw, tws, tbq;
  int err = make_tmap(&th, h8, H, N, H, kS8Box, kS8Rows, kU8, 1);
  if (!err) err = make_tmap(&tw, w8t, H, Vp, H, kS8Box, kProjCols, kU8, 1);
  if (!err) err = make_tmap(&tws, ws, Vp, 1, vec, kProjCols, 1, kF32, 4);
  if (!err) err = make_tmap(&tbq, bq, Vp, 1, vec, kProjCols, 1, kF32, 4);
  if (err) return err;
  err = allow_max_smem<chunk_s8_kernel>();
  if (err) return err;
  const int rows_per_block = kThreads / 32;
  const int n_tiles = (Vp + kProjCols - 1) / kProjCols;
  quantize_kernel<<<(N + rows_per_block - 1) / rows_per_block, kThreads, 0,
                    s>>>(static_cast<const float*>(h), static_cast<int8_t*>(h8),
                         static_cast<float*>(hs), N, H);
  chunk_s8_kernel<<<dim3((N + kS8Rows - 1) / kS8Rows, n_chunks),
                    kProjThreads, s8_smem(H), s>>>(
      th, tw, tws, tbq, static_cast<const float*>(hs),
      static_cast<float*>(cm), static_cast<float*>(cs),
      static_cast<float*>(cv), static_cast<int*>(ci), N, H, Vp, K, stages,
      n_tiles, tiles_per_chunk);
  merge_kernel<<<(N + rows_per_block - 1) / rows_per_block, kThreads, 0, s>>>(
      static_cast<const float*>(cm), static_cast<const float*>(cs),
      static_cast<const float*>(cv), static_cast<const int*>(ci),
      static_cast<float*>(vals), static_cast<int*>(idx), N, K, n_chunks);
  return (int)cudaGetLastError();
}
