// The vocab projection tile shared by K2 (topk_project.cu) and K3
// (rollout.cu): one block of kProjThreads computes the f32 products
// acc[r, c] = bf16(h[row0 + r]) . W_out[:, col0 + c] of a 64-row x
// 128-column tile on bf16 tensor cores (wmma 16x16x16; h is cast to bf16 on
// load; each 32-deep partial sum goes into an f32 register sum,
// vidcap::promote) and leaves them in shared memory for the caller's
// epilogue. Rows past N and columns past Vp are zero.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "common.cuh"

namespace vidcap {

constexpr int kProjRows = 64, kProjCols = 128, kProjDepth = 32;
constexpr int kProjThreads = 256;
constexpr int kProjLdc = kProjCols + 4;   // padded row stride of the result

struct ProjTile {
  __align__(128) __nv_bfloat16 a[kProjRows * (kProjDepth + 8)];
  __align__(128) __nv_bfloat16 b[kProjDepth * (kProjCols + 8)];
  __align__(128) float c[kProjRows * kProjLdc];   // row r at c + r * kProjLdc
};

// Needs H % 32 == 0 and Vp % 8 == 0; all kProjThreads threads of the block
// call it. Ends with a barrier, so `tile.c` is ready on return.
__device__ __forceinline__ void project_tile(
    const float* __restrict__ h, const __nv_bfloat16* __restrict__ w, int N,
    int H, int Vp, int row0, int col0, ProjTile& tile) {
  namespace wmma = nvcuda::wmma;
  using bf16 = __nv_bfloat16;
  constexpr int TM = kProjRows, TN = kProjCols, TK = kProjDepth;
  constexpr int LDA = TK + 8, LDB = TN + 8, LDC = kProjLdc;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = warp % 4, wc = warp / 4;   // 16-row strip, 64-column half

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int k0 = 0; k0 < H; k0 += TK) {
    for (int i = tid; i < TM * TK; i += blockDim.x) {
      const int r = i / TK, kk = i % TK, row = row0 + r;
      const float v = row < N ? h[(size_t)row * H + k0 + kk] : 0.f;
      tile.a[r * LDA + kk] = __float2bfloat16_rn(v);
    }
    for (int i = tid; i < TK * TN / 8; i += blockDim.x) {
      const int r = i / (TN / 8), cc = (i % (TN / 8)) * 8, col = col0 + cc;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (col < Vp)   // Vp % 8 == 0: a vector is all in or all out
        v = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * Vp + col);
      *reinterpret_cast<uint4*>(tile.b + r * LDB + cc) = v;
    }
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> part[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wmma::fill_fragment(part[i], 0.f);
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, tile.a + (wr * 16) * LDA + kk, LDA);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, tile.b + kk * LDB + wc * 64 + i * 16, LDB);
        wmma::mma_sync(part[i], af, bfr, part[i]);
      }
    }
    promote(acc, part);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    wmma::store_matrix_sync(tile.c + (wr * 16) * LDC + wc * 64 + i * 16,
                            acc[i], LDC, wmma::mem_row_major);
  __syncthreads();
}

}  // namespace vidcap
