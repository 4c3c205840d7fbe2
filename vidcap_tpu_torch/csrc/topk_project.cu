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
//
// Design, two launches on the caller's stream (blocks run in no order, so
// the TPU kernel's running carry becomes a second pass):
//  (a) tile_kernel: grid (64-row tiles) x (128-column vocab tiles). Each block
//      runs its bf16 tensor-core product (projection.cuh), applies the exact
//      rounding chain f32(bf16(bf16(acc) + bf16(b))), masks columns >=
//      vocab_size to -1e30, and writes per (row, tile) the max, sum exp(x -
//      max) and the tile's top-K (value, column). Row tiles vary fastest, so
//      the 15 blocks that share a W_out tile run together and read it from L2.
//  (b) merge_kernel: a warp per row merges the tiles: lse = m + log(max(s,
//      1e-30)) and the global top-K, then writes (value - lse, column).
// Ties go to the smallest column in both passes (vidcap::before), so the
// result equals a stable descending sort of the row.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "projection.cuh"

using bf16 = __nv_bfloat16;
using vidcap::before;
using vidcap::bf16r;

namespace {

constexpr int TM = vidcap::kProjRows, TN = vidcap::kProjCols;
constexpr int LDC = vidcap::kProjLdc;
constexpr int kThreads = vidcap::kProjThreads;

// Warp-wide argmax in the (value desc, index asc) order.
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
tile_kernel(const float* __restrict__ h, const bf16* __restrict__ w,
            const float* __restrict__ b, float* __restrict__ tmax,
            float* __restrict__ tsum, float* __restrict__ tv,
            int* __restrict__ ti, int N, int H, int Vp, int K, int vocab,
            int n_tiles) {
  __shared__ __align__(128) vidcap::ProjTile tile;
  const int row0 = blockIdx.x * TM, col0 = blockIdx.y * TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  vidcap::project_tile(h, w, N, H, Vp, row0, col0, tile);
  const float* Cs = tile.c;

  // epilogue: a warp per row, 4 columns per lane
  for (int r = warp; r < TM; r += blockDim.x / 32) {
    const int row = row0 + r;
    if (row >= N) break;
    float v[TN / 32];
    int ci[TN / 32];
#pragma unroll
    for (int q = 0; q < TN / 32; ++q) {
      const int col = col0 + lane + 32 * q;
      if (col < Vp) {
        const float x = bf16r(bf16r(Cs[r * LDC + lane + 32 * q]) + bf16r(b[col]));
        v[q] = col < vocab ? x : vidcap::kNeg;
        ci[q] = col;
      } else {   // past the ragged end: never a candidate
        v[q] = -INFINITY;
        ci[q] = INT_MAX;
      }
    }
    float mx = v[0];
#pragma unroll
    for (int q = 1; q < TN / 32; ++q) mx = fmaxf(mx, v[q]);
    mx = vidcap::warp_max(mx);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < TN / 32; ++q) s += expf(v[q] - mx);
    s = vidcap::warp_sum(s);
    const size_t o = (size_t)row * n_tiles + blockIdx.y;
    if (lane == 0) {
      tmax[o] = mx;
      tsum[o] = s;
    }
    for (int k = 0; k < K; ++k) {
      float bv = -INFINITY;
      int bi = INT_MAX;
#pragma unroll
      for (int q = 0; q < TN / 32; ++q)
        if (before(v[q], ci[q], bv, bi)) {
          bv = v[q];
          bi = ci[q];
        }
      warp_best(bv, bi);
#pragma unroll
      for (int q = 0; q < TN / 32; ++q)
        if (ci[q] == bi) {   // taken: drop it from later rounds
          v[q] = -INFINITY;
          ci[q] = INT_MAX;
        }
      if (lane == 0) {
        tv[o * K + k] = bv;
        ti[o * K + k] = bi;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ tmax, const float* __restrict__ tsum,
             const float* __restrict__ tv, const int* __restrict__ ti,
             float* __restrict__ vals, int* __restrict__ idx, int N, int K,
             int n_tiles) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= N) return;
  const float* rm = tmax + (size_t)row * n_tiles;
  const float* rs = tsum + (size_t)row * n_tiles;
  float m = -INFINITY;
  for (int t = lane; t < n_tiles; t += 32) m = fmaxf(m, rm[t]);
  m = vidcap::warp_max(m);
  float s = 0.f;
  for (int t = lane; t < n_tiles; t += 32) s += rs[t] * expf(rm[t] - m);
  s = vidcap::warp_sum(s);
  const float lse = m + logf(fmaxf(s, 1e-30f));

  const float* cv = tv + (size_t)row * n_tiles * K;
  const int* cidx = ti + (size_t)row * n_tiles * K;
  const int total = n_tiles * K;
  float last_v = INFINITY;   // the previous pick; candidates come after it
  int last_i = -1;
  for (int k = 0; k < K; ++k) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int p = lane; p < total; p += 32) {
      const float x = cv[p];
      const int c = cidx[p];
      if (before(last_v, last_i, x, c) && before(x, c, bv, bi)) {
        bv = x;
        bi = c;
      }
    }
    warp_best(bv, bi);
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
// b [Vp] f32; scratch tmax/tsum [N, n_tiles] f32, tv [N, n_tiles, K] f32,
// ti [N, n_tiles, K] i32 with n_tiles = ceil(Vp / 128); out vals [N, K] f32,
// idx [N, K] i32. Needs H % 32 == 0, Vp % 8 == 0, 1 <= K <= Vp. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int vidcap_topk_project(const void* h, const void* w, const void* b,
                                   void* tmax, void* tsum, void* tv, void* ti,
                                   void* vals, void* idx, int N, int H, int Vp,
                                   int K, int vocab, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (Vp + TN - 1) / TN;
  dim3 grid((N + TM - 1) / TM, n_tiles);
  tile_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(h), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<float*>(tmax),
      static_cast<float*>(tsum), static_cast<float*>(tv),
      static_cast<int*>(ti), N, H, Vp, K, vocab, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows_per_block = kThreads / 32;
  merge_kernel<<<(N + rows_per_block - 1) / rows_per_block, kThreads, 0, s>>>(
      static_cast<const float*>(tmax), static_cast<const float*>(tsum),
      static_cast<const float*>(tv), static_cast<const int*>(ti),
      static_cast<float*>(vals), static_cast<int*>(idx), N, K, n_tiles);
  return (int)cudaGetLastError();
}
