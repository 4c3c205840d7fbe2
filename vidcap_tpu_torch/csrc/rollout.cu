// K3 rollout: a whole greedy or Gumbel-max sampled rollout of max_len steps
// from one host call, for B rows (one hypothesis per video).
//
// Replaces vidcap_tpu/ops/pallas_decoder.py::pallas_rollout
// (_rollout_kernel), which runs the rollout as one launch whose sequential
// grid of max_len steps keeps h, c, the token and the finished flags in VMEM.
//
// What bounds it on the H100: at msvd_greedy width (B=32, E=H=A=512, T=26,
// Vp=12,032, 30 steps) the products are 2*32*30*(512*512 + 1536*2048 +
// 512*12032 + 2*26*512) = 18.4 GFLOP (~19 us at 989 TFLOP/s bf16), against
// ~22 MB of weights, keys/values and gathered rows counted once (~6.5 us at
// 3.35 TB/s): bound by the tensor cores. It still re-reads W_out and Wg
// from memory (mostly L2) every step, ~627 MB over a rollout.
//
// Design: one host call enqueues, per step t, six kernels on the caller's
// stream, with no host synchronisation between steps. The token, h, c
// (ping-pong buffers) and the finished flags live in device buffers, so
// step t's token feeds step t+1's embedding gather on the device, and the
// step index and the seed are kernel arguments.
//  (a) the recurrent step of recurrent.cuh with K=1 (shared with K1): the
//      bf16 packing of [emb; h] with the embedding rows gathered from the
//      bf16 table by each row's current token (vidcap::TableEmb), q on
//      tensor cores (TMA + wgmma), the attention (one block per row), and
//      the TMA + wgmma gate GEMM with promoted partial sums and the LSTM
//      update in its epilogue. Four kernels.
//  (b) select_tile_kernel: one block per (64-row tile, 128-column tile). The
//      product of project_tile below, then logits = f32(bf16(bf16(acc) +
//      bf16(b))), clean = logits * (1/temperature) with columns >= vocab at
//      -1e30, noisy = clean - log(-log(uni)) when sampling (the counter hash
//      of (row, column, seed, step) of pallas_decoder.py:216-230), and per
//      (row, tile) the max and exp-sum of clean and the best noisy value with
//      its clean value and column.
//  (c) finalize_kernel: a warp per row merges the tiles (lse, and the pick
//      with ties to the smallest column), writes token/logp/mask of step t
//      and updates the finished flag and the next token.
// K3's own projection tile (b) is still the first version's wmma tile, to
// be redesigned with the rest of K3.
// Built without --use_fast_math, so logf/expf are the accurate ones.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "common.cuh"
#include "recurrent.cuh"

using bf16 = __nv_bfloat16;
using namespace vidcap;

namespace {

constexpr int PAD = 0, BOS = 1, EOS = 2;   // data/vocab.py

// K3's projection tile: one block of kTileThreads computes the f32 products
// acc[r, c] = bf16(h[row0 + r]) . W_out[:, col0 + c] of a 64-row x
// 128-column tile on bf16 tensor cores (wmma 16x16x16; h is cast to bf16 on
// load; each 32-deep partial sum goes into an f32 register sum,
// vidcap::promote) and leaves them in shared memory. Rows past N and
// columns past Vp are zero.
constexpr int kTileRows = 64, kTileCols = 128, kTileDepth = 32;
constexpr int kTileThreads = 256;
constexpr int kTileLdc = kTileCols + 4;   // padded row stride of the result

struct ProjTile {
  __align__(128) __nv_bfloat16 a[kTileRows * (kTileDepth + 8)];
  __align__(128) __nv_bfloat16 b[kTileDepth * (kTileCols + 8)];
  __align__(128) float c[kTileRows * kTileLdc];   // row r at c + r * kTileLdc
};

// Needs H % 32 == 0 and Vp % 8 == 0; all kTileThreads threads of the block
// call it. Ends with a barrier, so `tile.c` is ready on return.
__device__ __forceinline__ void project_tile(
    const float* __restrict__ h, const __nv_bfloat16* __restrict__ w, int N,
    int H, int Vp, int row0, int col0, ProjTile& tile) {
  namespace wmma = nvcuda::wmma;
  constexpr int TM = kTileRows, TN = kTileCols, TK = kTileDepth;
  constexpr int LDA = TK + 8, LDB = TN + 8, LDC = kTileLdc;
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

// Gumbel-perturbed clean logit of pallas_decoder.py:216-230, bit for bit in
// uint32 arithmetic: clean - log(-log(uni)).
__device__ __forceinline__ float gumbel(float clean, unsigned row,
                                        unsigned col, unsigned seed,
                                        unsigned step) {
  unsigned x = (row * 0x9E3779B9u) ^ (col * 0x85EBCA6Bu) ^
               (seed * 0x27D4EB2Fu + step * 0x165667B1u);
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  const float uni = (float)(x >> 8) * (1.f / 16777216.f) + 1e-12f;
  return clean - logf(-logf(uni));
}

// Warp-wide best (noisy desc, column asc), carrying the clean value.
__device__ __forceinline__ void warp_pick(float& v, int& i, float& c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    const float oc = __shfl_xor_sync(0xffffffffu, c, o);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
      c = oc;
    }
  }
}

__global__ void init_kernel(int* __restrict__ tok, int* __restrict__ fin,
                            int N) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < N) {
    tok[r] = BOS;
    fin[r] = 0;
  }
}

__global__ void __launch_bounds__(kTileThreads)
select_tile_kernel(const float* __restrict__ h, const bf16* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ tmax,
                   float* __restrict__ tsum, float* __restrict__ tnoisy,
                   float* __restrict__ tclean, int* __restrict__ tcol, int N,
                   int H, int Vp, int vocab, int n_tiles, float inv_temp,
                   int sample, unsigned seed, unsigned step) {
  constexpr int TN = kTileCols, Q = TN / 32;
  __shared__ __align__(128) ProjTile tile;
  const int row0 = blockIdx.x * kTileRows, col0 = blockIdx.y * TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  project_tile(h, w, N, H, Vp, row0, col0, tile);

  // epilogue: a warp per row, Q columns per lane
  for (int r = warp; r < kTileRows; r += blockDim.x / 32) {
    const int row = row0 + r;
    if (row >= N) break;
    float cl[Q], nz[Q];
    int ci[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int col = col0 + lane + 32 * q;
      if (col < Vp) {
        const float x =
            bf16r(bf16r(tile.c[r * kTileLdc + lane + 32 * q]) + bf16r(b[col]));
        cl[q] = col < vocab ? x * inv_temp : kNeg;
        nz[q] = sample ? gumbel(cl[q], row, col, seed, step) : cl[q];
        ci[q] = col;
      } else {   // past the ragged end: never a candidate
        cl[q] = nz[q] = -INFINITY;
        ci[q] = INT_MAX;
      }
    }
    float mx = cl[0];
#pragma unroll
    for (int q = 1; q < Q; ++q) mx = fmaxf(mx, cl[q]);
    mx = warp_max(mx);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) s += expf(cl[q] - mx);
    s = warp_sum(s);
    float bv = -INFINITY, bc = 0.f;
    int bi = INT_MAX;
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if (before(nz[q], ci[q], bv, bi)) {
        bv = nz[q];
        bi = ci[q];
        bc = cl[q];
      }
    warp_pick(bv, bi, bc);
    if (lane == 0) {
      const size_t o = (size_t)row * n_tiles + blockIdx.y;
      tmax[o] = mx;
      tsum[o] = s;
      tnoisy[o] = bv;
      tclean[o] = bc;
      tcol[o] = bi;
    }
  }
}

__global__ void __launch_bounds__(256)
finalize_kernel(const float* __restrict__ tmax, const float* __restrict__ tsum,
                const float* __restrict__ tnoisy,
                const float* __restrict__ tclean, const int* __restrict__ tcol,
                int* __restrict__ tok, int* __restrict__ fin,
                int* __restrict__ out_tok, float* __restrict__ out_logp,
                float* __restrict__ out_mask, int N, int n_tiles, int L,
                int t) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= N) return;
  const size_t base = (size_t)row * n_tiles;
  float m = -INFINITY;
  for (int j = lane; j < n_tiles; j += 32) m = fmaxf(m, tmax[base + j]);
  m = warp_max(m);
  float s = 0.f;
  for (int j = lane; j < n_tiles; j += 32)
    s += tsum[base + j] * expf(tmax[base + j] - m);
  s = warp_sum(s);
  const float lse = m + logf(fmaxf(s, 1e-30f));
  float bv = -INFINITY, bc = 0.f;
  int bi = INT_MAX;
  for (int j = lane; j < n_tiles; j += 32)
    if (before(tnoisy[base + j], tcol[base + j], bv, bi)) {
      bv = tnoisy[base + j];
      bi = tcol[base + j];
      bc = tclean[base + j];
    }
  warp_pick(bv, bi, bc);
  if (lane == 0) {
    const bool done = fin[row] != 0;
    const int tk = done ? PAD : bi;
    const size_t o = (size_t)row * L + t;
    out_tok[o] = tk;
    out_logp[o] = done ? 0.f : bc - lse;
    out_mask[o] = done ? 0.f : 1.f;
    fin[row] = (done || tk == EOS) ? 1 : 0;
    tok[row] = tk;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Inputs: emb [Vp, E], keys
// [B, T, A], values [B, T, H], wq [H, A], wg [E+2H, 4H], w_out [H, Vp] bf16;
// fmask [B, T], h0/c0 [B, H], u [A], bg [4H], b_out [Vp] f32. Scratch:
// hbuf/cbuf [2, B, H] f32; xh [B, E+2H], q [B, A] bf16; tok/fin [B] i32;
// tmax/tsum/tnoisy/tclean [B, n_tiles] f32, tcol [B, n_tiles] i32 with
// n_tiles = ceil(Vp / 128). Outputs [B, max_len]: tokens i32, logp f32, mask
// f32. Needs E % 8 == 0, H, A multiples of 32 and Vp a multiple of 8.
// Returns the cudaError_t of the launches, or kTensorMapError + CUresult if
// a TMA map cannot be made (0 on success).
extern "C" int vidcap_rollout(
    const void* emb, const void* keys, const void* values, const void* fmask,
    const void* h0, const void* c0, const void* wq, const void* u,
    const void* wg, const void* bg, const void* w_out, const void* b_out,
    void* hbuf, void* cbuf, void* xh, void* q, void* tok, void* fin,
    void* tmax, void* tsum, void* tnoisy, void* tclean, void* tcol,
    void* out_tok, void* out_logp, void* out_mask, int B, int T, int E, int H,
    int A, int Vp, int vocab, int max_len, int sample, unsigned seed,
    float inv_temp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RecurrentMaps maps;
  int err = make_recurrent_maps(&maps, xh, wq, wg, B, E, H, A);
  if (err) return err;
  err = recurrent_setup();
  if (err) return err;
  const int n_tiles = (Vp + kTileCols - 1) / kTileCols;
  float* hb = static_cast<float*>(hbuf);
  float* cb = static_cast<float*>(cbuf);
  int* tk = static_cast<int*>(tok);
  int* fn = static_cast<int*>(fin);
  const size_t BH = (size_t)B * H;
  init_kernel<<<(B + 255) / 256, 256, 0, s>>>(tk, fn, B);
  for (int t = 0; t < max_len; ++t) {
    const float* h_cur = t == 0 ? static_cast<const float*>(h0)
                                : hb + ((t - 1) & 1) * BH;
    const float* c_cur = t == 0 ? static_cast<const float*>(c0)
                                : cb + ((t - 1) & 1) * BH;
    float* h_next = hb + (t & 1) * BH;
    float* c_next = cb + (t & 1) * BH;
    err = recurrent_step(
        maps, TableEmb{static_cast<const bf16*>(emb), tk}, h_cur, c_cur,
        static_cast<const bf16*>(keys), static_cast<const bf16*>(values),
        static_cast<const float*>(fmask), static_cast<const float*>(u),
        static_cast<const float*>(bg), static_cast<bf16*>(xh),
        static_cast<bf16*>(q), h_next, c_next, B, 1, T, E, H, A, s);
    if (err) return err;
    select_tile_kernel<<<dim3((B + kTileRows - 1) / kTileRows, n_tiles),
                         kTileThreads, 0, s>>>(
        h_next, static_cast<const bf16*>(w_out),
        static_cast<const float*>(b_out), static_cast<float*>(tmax),
        static_cast<float*>(tsum), static_cast<float*>(tnoisy),
        static_cast<float*>(tclean), static_cast<int*>(tcol), B, H, Vp, vocab,
        n_tiles, inv_temp, sample, seed, (unsigned)t);
    finalize_kernel<<<(B + 7) / 8, 256, 0, s>>>(
        static_cast<const float*>(tmax), static_cast<const float*>(tsum),
        static_cast<const float*>(tnoisy), static_cast<const float*>(tclean),
        static_cast<const int*>(tcol), tk, fn, static_cast<int*>(out_tok),
        static_cast<float*>(out_logp), static_cast<float*>(out_mask), B,
        n_tiles, max_len, t);
  }
  return (int)cudaGetLastError();
}
