// The recurrent core of one decode step, shared by K1 (beam_core.cu) and K3
// (rollout.cu): attention over per-video keys/values for the K rows of each
// video, then the gate GEMM with the LSTM update in its epilogue.
//
//  attention_kernel: one block per video. keys[b] and values[b] go to shared
//      memory once and serve all K rows of the video (the shared-keys layout
//      of step_beam), so they are read from device memory once per step. The
//      block computes q = bf16(h.Wq) for its K rows (Wq stays in L2), the
//      bf16 tanh scores, the masked f32 softmax over T and ctx f32[K, H].
//  gates_kernel: the [M, E+2H] x [E+2H, 4H] gate GEMM on bf16 tensor cores
//      (wmma 16x16x16, f32 accumulate), A fed from the embedding, ctx and h
//      and cast to bf16 on load (never concatenated in memory). Each 32-deep
//      partial sum is added to an f32 register sum (vidcap::promote): chained
//      over all 1536, the tensor cores' own f32 accumulation is ~6x less
//      accurate than an f32 GEMM, and the bf16 rounding of h' turns that into
//      decodes that part from the reference. Each block owns hidden columns
//      j0..j0+31 of all four gates, so the LSTM update runs in the epilogue
//      and the gates never reach memory. The embedding rows come from an
//      `Emb` source: dense f32 rows (K1) or a bf16 table gathered by each
//      row's token on the device (K3).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "common.cuh"

namespace vidcap {

constexpr int kMaxBeam = 8;
constexpr int kAttnThreads = 256;

// Shared memory of one attention block: keys/values (bf16), the bf16-rounded
// h rows, q, scores/attn and the frame mask (f32).
inline size_t attention_smem(int K, int T, int H, int A) {
  return (size_t)T * (A + H) * sizeof(__nv_bfloat16) +
         (size_t)(K * H + K * A + K * T + T) * sizeof(float);
}

__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const float* __restrict__ h,
                 const __nv_bfloat16* __restrict__ keys,
                 const __nv_bfloat16* __restrict__ values,
                 const float* __restrict__ fmask,
                 const __nv_bfloat16* __restrict__ wq,
                 const float* __restrict__ u, float* __restrict__ ctx, int K,
                 int T, int H, int A) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* keys_s = reinterpret_cast<bf16*>(smem);
  bf16* vals_s = keys_s + (size_t)T * A;
  float* h_s = reinterpret_cast<float*>(vals_s + (size_t)T * H);
  float* q_s = h_s + K * H;
  float* p_s = q_s + K * A;
  float* m_s = p_s + K * T;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;

  // keys/values of video b, 16 bytes per thread per load (A, H % 32 == 0)
  const uint4* ksrc = reinterpret_cast<const uint4*>(keys + (size_t)b * T * A);
  const uint4* vsrc =
      reinterpret_cast<const uint4*>(values + (size_t)b * T * H);
  uint4* kdst = reinterpret_cast<uint4*>(keys_s);
  uint4* vdst = reinterpret_cast<uint4*>(vals_s);
  for (int i = tid; i < T * A / 8; i += blockDim.x) kdst[i] = ksrc[i];
  for (int i = tid; i < T * H / 8; i += blockDim.x) vdst[i] = vsrc[i];
  for (int i = tid; i < K * H; i += blockDim.x)
    h_s[i] = bf16r(h[(size_t)b * K * H + i]);
  for (int t = tid; t < T; t += blockDim.x) m_s[t] = fmask[(size_t)b * T + t];
  __syncthreads();

  // q = bf16(bf16(h) . Wq), one column a per thread for all K rows; the sum
  // runs in chunks of 32 so its rounding error stays near a blocked GEMM's
  for (int a = tid; a < A; a += blockDim.x) {
    float acc[kMaxBeam];
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k) acc[k] = 0.f;
    for (int j0 = 0; j0 < H; j0 += 32) {
      float part[kMaxBeam];
#pragma unroll
      for (int k = 0; k < kMaxBeam; ++k) part[k] = 0.f;
      for (int j = j0; j < j0 + 32; ++j) {
        const float w = __bfloat162float(wq[(size_t)j * A + a]);
#pragma unroll
        for (int k = 0; k < kMaxBeam; ++k)
          if (k < K) part[k] += h_s[k * H + j] * w;
      }
#pragma unroll
      for (int k = 0; k < kMaxBeam; ++k) acc[k] += part[k];
    }
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k)
      if (k < K) q_s[k * A + a] = bf16r(acc[k]);
  }
  __syncthreads();

  // scores[k, t] = sum_a bf16(tanh(bf16(keys + q))) * bf16(u): a warp per (k, t)
  for (int p = warp; p < K * T; p += nwarps) {
    const int k = p / T, t = p % T;
    float s = 0.f;
    for (int a = lane; a < A; a += 32) {
      const float x = bf16r(__bfloat162float(keys_s[t * A + a]) + q_s[k * A + a]);
      s += bf16r(tanhf(x)) * bf16r(u[a]);
    }
    s = warp_sum(s);
    if (lane == 0) p_s[p] = m_s[t] > 0.f ? s : kNeg;
  }
  __syncthreads();

  // f32 softmax over T (all frames masked -> uniform, as in JAX), a warp per
  // row; attn is stored bf16-rounded for the context product
  for (int k = warp; k < K; k += nwarps) {
    float mx = -INFINITY;
    for (int t = lane; t < T; t += 32) mx = fmaxf(mx, p_s[k * T + t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < T; t += 32) sum += expf(p_s[k * T + t] - mx);
    sum = warp_sum(sum);
    for (int t = lane; t < T; t += 32)
      p_s[k * T + t] = bf16r(expf(p_s[k * T + t] - mx) / sum);
  }
  __syncthreads();

  // ctx[k, d] = sum_t attn[k, t] * values[t, d] in f32
  for (int d = tid; d < H; d += blockDim.x) {
    float acc[kMaxBeam];
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k) acc[k] = 0.f;
    for (int t = 0; t < T; ++t) {
      const float v = __bfloat162float(vals_s[t * H + d]);
#pragma unroll
      for (int k = 0; k < kMaxBeam; ++k)
        if (k < K) acc[k] += p_s[k * T + t] * v;
    }
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k)
      if (k < K) ctx[((size_t)b * K + k) * H + d] = acc[k];
  }
}

// Embedding rows of the gate GEMM's A operand: dense f32 rows [M, E] (K1).
struct DenseEmb {
  const float* emb;
  __device__ float operator()(int row, int k, int E) const {
    return emb[(size_t)row * E + k];
  }
};

// Embedding rows of the gate GEMM's A operand: row tok[r] of a bf16 table
// [Vp, E] for output row r (K3: the token chosen on the device last step).
struct TableEmb {
  const __nv_bfloat16* table;
  const int* tok;
  __device__ float operator()(int row, int k, int E) const {
    return __bfloat162float(table[(size_t)tok[row] * E + k]);
  }
};

// Gate GEMM tile: 64 rows x (4 gates x 32 hidden columns), k-step 32.
constexpr int kGateRows = 64, kGateHidden = 32, kGateThreads = 256;

inline dim3 gates_grid(int M, int H) {
  return dim3((M + kGateRows - 1) / kGateRows, H / kGateHidden);
}

template <typename Emb>
__global__ void __launch_bounds__(kGateThreads)
gates_kernel(Emb emb, const float* __restrict__ ctx,
             const float* __restrict__ h, const float* __restrict__ c,
             const __nv_bfloat16* __restrict__ wg,
             const float* __restrict__ bg, float* __restrict__ h_out,
             float* __restrict__ c_out, int M, int E, int H) {
  namespace wmma = nvcuda::wmma;
  using bf16 = __nv_bfloat16;
  constexpr int BM = kGateRows, BJ = kGateHidden, BN = 4 * BJ, BK = 32;
  constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;   // padded strides
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int row0 = blockIdx.x * BM, j0 = blockIdx.y * BJ;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = warp % 4, wc = warp / 4;   // 16-row strip, 64-column half
  const int Kt = E + 2 * H;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int k0 = 0; k0 < Kt; k0 += BK) {
    // A = bf16([emb; ctx; h]) rows row0.., columns k0..k0+31
    for (int i = tid; i < BM * BK; i += blockDim.x) {
      const int r = i / BK, kk = i % BK;
      const int row = row0 + r, kc = k0 + kk;
      float v = 0.f;
      if (row < M && kc < Kt) {
        if (kc < E) v = emb(row, kc, E);
        else if (kc < E + H) v = ctx[(size_t)row * H + (kc - E)];
        else v = h[(size_t)row * H + (kc - E - H)];
      }
      As[r * LDA + kk] = __float2bfloat16_rn(v);
    }
    // B = Wg rows k0..k0+31, columns g*H + j0 + (0..31) of each gate g
    for (int i = tid; i < BK * BN / 8; i += blockDim.x) {
      const int r = i / (BN / 8), cc = (i % (BN / 8)) * 8;
      const int g = cc / BJ, jj = cc % BJ, kc = k0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (kc < Kt)
        v = *reinterpret_cast<const uint4*>(wg + (size_t)kc * 4 * H +
                                            (size_t)g * H + j0 + jj);
      *reinterpret_cast<uint4*>(Bs + r * LDB + cc) = v;
    }
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> part[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wmma::fill_fragment(part[i], 0.f);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, As + (wr * 16) * LDA + kk, LDA);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, Bs + kk * LDB + wc * 64 + i * 16, LDB);
        wmma::mma_sync(part[i], af, bfr, part[i]);
      }
    }
    promote(acc, part);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    wmma::store_matrix_sync(Cs + (wr * 16) * LDC + wc * 64 + i * 16, acc[i],
                            LDC, wmma::mem_row_major);
  __syncthreads();

  // LSTM update: gate order i, f, g, o; forget gate sigma(f + 1)
  for (int i = tid; i < BM * BJ; i += blockDim.x) {
    const int r = i / BJ, jj = i % BJ, row = row0 + r, j = j0 + jj;
    if (row >= M) continue;
    const float gi = Cs[r * LDC + 0 * BJ + jj] + bg[j];
    const float gf = Cs[r * LDC + 1 * BJ + jj] + bg[H + j];
    const float gg = Cs[r * LDC + 2 * BJ + jj] + bg[2 * H + j];
    const float go = Cs[r * LDC + 3 * BJ + jj] + bg[3 * H + j];
    const size_t o = (size_t)row * H + j;
    const float cn = sigmoidf(gf + 1.f) * c[o] + sigmoidf(gi) * tanhf(gg);
    c_out[o] = cn;
    h_out[o] = sigmoidf(go) * tanhf(cn);
  }
}

}  // namespace vidcap
