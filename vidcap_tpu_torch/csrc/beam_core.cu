// K1 beam_core: one beam step's recurrent core for B videos x K beams.
//
// Replaces vidcap_tpu/ops/pallas_beam_core.py::beam_core (_beam_core_kernel),
// which runs the whole step as one VMEM-resident block on the TPU.
//
// What bounds it on the H100: at the bench shape (B=184, K=5, E=H=A=512,
// T=26) the gate GEMM is 2*920*1536*2048 = 5.8 GFLOP (~5.9 us at 989 TFLOP/s
// bf16) and the bytes are ~26 MB (Wg 6.3 MB, keys+values 9.8 MB, h/c/emb in,
// h/c out; ~7.8 us at 3.35 TB/s): close to balanced, slightly bytes-bound.
//
// Design, two launches on the caller's stream:
//  (a) attention_kernel: one block per video. keys[b] and values[b] go to
//      shared memory once and serve all K beams (the shared-keys layout of
//      step_beam), so they are read from device memory once per step. The
//      block computes q = bf16(h.Wq) for its K rows (Wq stays in L2), the
//      bf16 tanh scores, the masked f32 softmax over T and ctx f32[K, H].
//  (b) gates_kernel: the [B*K, E+2H] x [E+2H, 4H] gate GEMM on bf16 tensor
//      cores (wmma 16x16x16, f32 accumulate), A fed from the emb/ctx/h
//      pointers and cast to bf16 on load (never concatenated in memory).
//      Each 32-deep partial sum is added to an f32 register sum
//      (vidcap::promote): chained over all 1536, the tensor cores' own f32
//      accumulation is ~6x less accurate than an f32 GEMM, and the bf16
//      rounding of h' turns that into beams that part from the reference.
//      Each block owns hidden columns j0..j0+31 of all four gates, so the
//      LSTM update runs in the epilogue and the gates never reach memory.
// Simple and synchronous: no cp.async/TMA pipelining and no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using bf16 = __nv_bfloat16;
using vidcap::bf16r;

namespace {

constexpr int kMaxBeam = 8;
constexpr int kAttnThreads = 256;

// Shared memory of one attention block: keys/values (bf16), the bf16-rounded
// h rows, q, scores/attn and the frame mask (f32).
size_t attention_smem(int K, int T, int H, int A) {
  return (size_t)T * (A + H) * sizeof(bf16) +
         (size_t)(K * H + K * A + K * T + T) * sizeof(float);
}

__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const float* __restrict__ h, const bf16* __restrict__ keys,
                 const bf16* __restrict__ values,
                 const float* __restrict__ fmask, const bf16* __restrict__ wq,
                 const float* __restrict__ u, float* __restrict__ ctx,
                 int K, int T, int H, int A) {
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
    s = vidcap::warp_sum(s);
    if (lane == 0) p_s[p] = m_s[t] > 0.f ? s : vidcap::kNeg;
  }
  __syncthreads();

  // f32 softmax over T (all frames masked -> uniform, as in JAX), a warp per
  // beam; attn is stored bf16-rounded for the context product
  for (int k = warp; k < K; k += nwarps) {
    float mx = -INFINITY;
    for (int t = lane; t < T; t += 32) mx = fmaxf(mx, p_s[k * T + t]);
    mx = vidcap::warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < T; t += 32) sum += expf(p_s[k * T + t] - mx);
    sum = vidcap::warp_sum(sum);
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

// Gate GEMM tile: 64 rows x (4 gates x 32 hidden columns), k-step 32.
constexpr int BM = 64, BJ = 32, BN = 4 * BJ, BK = 32;
constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;   // padded strides

__global__ void __launch_bounds__(256)
gates_kernel(const float* __restrict__ emb, const float* __restrict__ ctx,
             const float* __restrict__ h, const float* __restrict__ c,
             const bf16* __restrict__ wg, const float* __restrict__ bg,
             float* __restrict__ h_out, float* __restrict__ c_out,
             int M, int E, int H) {
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
        if (kc < E) v = emb[(size_t)row * E + kc];
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
    vidcap::promote(acc, part);
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
    const float cn =
        vidcap::sigmoidf(gf + 1.f) * c[o] + vidcap::sigmoidf(gi) * tanhf(gg);
    c_out[o] = cn;
    h_out[o] = vidcap::sigmoidf(go) * tanhf(cn);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Shapes: emb [B*K, E], h/c/ctx/
// h_out/c_out [B*K, H] f32; keys [B, T, A], values [B, T, H] bf16; fmask
// [B, T] f32; wq [H, A] bf16; u [A] f32; wg [E+2H, 4H] bf16; bg [4H] f32.
// Needs K <= 8 and H, A multiples of 32. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int vidcap_beam_core(const void* emb, const void* h, const void* c,
                                const void* keys, const void* values,
                                const void* fmask, const void* wq,
                                const void* u, const void* wg, const void* bg,
                                void* ctx, void* h_out, void* c_out, int B,
                                int K, int T, int E, int H, int A,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = attention_smem(K, T, H, A);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_kernel<<<B, kAttnThreads, smem, s>>>(
      static_cast<const float*>(h), static_cast<const bf16*>(keys),
      static_cast<const bf16*>(values), static_cast<const float*>(fmask),
      static_cast<const bf16*>(wq), static_cast<const float*>(u),
      static_cast<float*>(ctx), K, T, H, A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int M = B * K;
  dim3 grid((M + BM - 1) / BM, H / BJ);
  gates_kernel<<<grid, 256, 0, s>>>(
      static_cast<const float*>(emb), static_cast<const float*>(ctx),
      static_cast<const float*>(h), static_cast<const float*>(c),
      static_cast<const bf16*>(wg), static_cast<const float*>(bg),
      static_cast<float*>(h_out), static_cast<float*>(c_out), M, E, H);
  return (int)cudaGetLastError();
}
