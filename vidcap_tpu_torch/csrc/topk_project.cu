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

  // merge the quad (the four lanes that share a row) and write the partials
  const bool writer = threadIdx.x % 4 == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + wg * 64 + frag_row(hh);
    const float mq = quad_max(carry.m[hh]);
    float sq = carry.m[hh] > -INFINITY ? carry.s[hh] * expf(carry.m[hh] - mq)
                                        : 0.f;
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    const size_t o = (size_t)row * n_chunks + chunk;
    if (writer && row < N) {
      cm[o] = mq;
      cs[o] = sq;
    }
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      float bv = carry.tv[hh][0];
      int bi = carry.ti[hh][0];
      best_over<2>(bv, bi);
      if (carry.ti[hh][0] == bi) {   // taken: the lane's list moves up
#pragma unroll
        for (int j = 0; j < kMaxK - 1; ++j) {
          carry.tv[hh][j] = carry.tv[hh][j + 1];
          carry.ti[hh][j] = carry.ti[hh][j + 1];
        }
        carry.tv[hh][kMaxK - 1] = -INFINITY;
        carry.ti[hh][kMaxK - 1] = INT_MAX;
      }
      if (writer && row < N && k < K) {
        cv[o * K + k] = bv;
        ci[o * K + k] = bi;
      }
    }
  }
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

}  // namespace

// Plain C entry point (loaded with ctypes). h [N, H] f32, w [H, Vp] bf16,
// b [Vp] f32; scratch h16 [N, H] bf16, cm/cs [N, n_chunks] f32, cv
// [N, n_chunks, K] f32, ci [N, n_chunks, K] i32, where chunk c covers the
// 128-column vocab tiles c * tiles_per_chunk.. and n_chunks * tiles_per_chunk
// >= ceil(Vp / 128); out vals [N, K] f32, idx [N, K] i32. Needs H % 32 == 0,
// H <= 512, Vp % 8 == 0, 1 <= K <= min(8, Vp). Returns the cudaError_t of
// the launches, or kTensorMapError + CUresult if a TMA map cannot be made
// (0 on success).
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
  err = allow_max_smem<chunk_kernel>();
  if (err) return err;
  const int n8 = N * H / 8;
  cast_kernel<<<(n8 + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(h), static_cast<bf16*>(h16), n8);
  const int n_tiles = (Vp + kProjCols - 1) / kProjCols;
  chunk_kernel<<<dim3((N + kProjRows - 1) / kProjRows, n_chunks),
                 kProjThreads, proj_smem(H), s>>>(
      th, tw, static_cast<const float*>(b), static_cast<float*>(cm),
      static_cast<float*>(cs), static_cast<float*>(cv), static_cast<int*>(ci),
      N, H, Vp, K, vocab, n_tiles, tiles_per_chunk);
  const int rows_per_block = kThreads / 32;
  merge_kernel<<<(N + rows_per_block - 1) / rows_per_block, kThreads, 0, s>>>(
      static_cast<const float*>(cm), static_cast<const float*>(cs),
      static_cast<const float*>(cv), static_cast<const int*>(ci),
      static_cast<float*>(vals), static_cast<int*>(idx), N, K, n_chunks);
  return (int)cudaGetLastError();
}
