// The recurrent core of one beam step, K1 (beam_core.cu): the part of
// vidcap_tpu/ops/pallas_beam_core.py's _beam_core_kernel before the vocab
// projection. For M = B*K rows (video-major, K rows per video),
//
//   xh = bf16([emb; ctx; h]) [M, E+2H],  q = bf16(bf16(h) . Wq)
//   ctx = attention over the video's keys/values with q
//   gates = xh . Wg + bg,  c' = sig(f+1) c + sig(i) tanh(g),  h' = sig(o) tanh(c')
//
// What bounded the first version on the H100 was not bytes or tensor-core
// operations but latency: each attention block computed q over 512 serial L2
// reads of Wq per column (all of Wq read by every block, ~94 MB of L2 reads a
// beam step), and the gate GEMM ran wmma tiles over 48 synchronous 32-deep
// steps with its A operand cast element by element from f32. This design,
// four kernels on the caller's stream:
//
//  pack_kernel: writes the emb and h columns of xh in bf16, 16 bytes a
//      thread, from the dense f32 embedding rows of the beam's tokens.
//  rec_gemm_kernel<QEpilogue>: q = bf16(xh[:, E+H:] . Wq) on tensor cores
//      (wgmma, TMA ring), over 128-row tiles, so Wq is read once per row
//      tile and not once per video.
//  attention_kernel: one block per video; keys[b], values[b] and its q rows
//      go to shared memory by bulk copies (TMA), once for all K rows. Scores
//      a warp per frame from 16-byte vectors of keys, q and u (each key
//      vector serves the K rows), the masked f32 softmax over T, ctx in f32;
//      it writes the ctx columns of xh, so the gate GEMM's A operand is
//      whole bf16 in memory: the single rounding of [emb; ctx; h] the
//      reference makes, done once.
//  rec_gemm_kernel<GateEpilogue>: the [M, E+2H] x [E+2H, 4H] gate GEMM.
//      Both operands by TMA through a 4-stage mbarrier ring filled by a
//      producer warp; two consumer warpgroups run wgmma on 64 rows each,
//      32-deep partial sums promoted into f32 registers (hopper.cuh,
//      mma_depth_step). Each block owns hidden columns j0..j0+31 of all four
//      gates (four Wg slabs a stage), so the LSTM update runs in the epilogue
//      straight from the accumulator registers and the gates never reach
//      memory.
// What holds it back now (PERF.md): the attention's scores, ~12M
// bf16(tanh) a beam step in f32 at full accuracy, on 184 blocks over 132
// SMs; the two products re-read Wq and Wg from L2 once per 128-row tile and
// wait for each 32-deep partial sum to be promoted.
// K3 (rollout.cu) computes the same arithmetic for one row per video inside
// its persistent kernel and does not launch these.
// Needs E % 8 == 0, H % 32 == 0, A % 32 == 0 and K <= kMaxBeam.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "hopper.cuh"

namespace vidcap {

constexpr int kMaxBeam = 8;
constexpr int kAttnThreads = 512;
constexpr int kPackThreads = 256;

// xh[:, 0:E] = bf16(emb), xh[:, E+H:E+2H] = bf16(h) from the dense f32
// rows emb [M, E] and h [M, H]; one 8-wide vector a thread.
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const float* emb, const float* __restrict__ h,
            __nv_bfloat16* __restrict__ xh, int M, int E, int H) {
  const int per_row = (E + H) / 8;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= M * per_row) return;
  const int row = v / per_row, c8 = (v % per_row) * 8;
  __nv_bfloat16* dst = xh + (size_t)row * (E + 2 * H);
  if (c8 < E)
    *reinterpret_cast<uint4*>(dst + c8) = bf16x8(emb + (size_t)row * E + c8);
  else
    *reinterpret_cast<uint4*>(dst + H + c8) =
        bf16x8(h + (size_t)row * H + (c8 - E));
}

// Shared memory of one attention block: keys/values, the block's q rows and
// bf16(u) (bf16), scores/attn and the frame mask (f32).
inline size_t attention_smem(int K, int T, int H, int A) {
  return (size_t)(T * (A + H) + K * A + A) * sizeof(__nv_bfloat16) +
         (size_t)(K * T + T) * sizeof(float);
}

__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ keys,
                 const __nv_bfloat16* __restrict__ values,
                 const float* __restrict__ fmask, const float* __restrict__ u,
                 __nv_bfloat16* __restrict__ xh, int K, int T, int E, int H,
                 int A) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* keys_s = reinterpret_cast<bf16*>(smem);
  bf16* vals_s = keys_s + (size_t)T * A;
  bf16* q_s = vals_s + (size_t)T * H;
  bf16* u_s = q_s + K * A;
  float* p_s = reinterpret_cast<float*>(u_s + A);
  float* m_s = p_s + K * T;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  const int A8 = A / 8;

  // keys/values of video b and its K q rows (each contiguous) by three bulk
  // copies, while the threads fetch bf16(u) and the frame mask
  __shared__ uint64_t loaded;
  if (tid == 0) {
    mbar_init(&loaded, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t kb = T * A * 2, vb = T * H * 2, qb = K * A * 2;
    mbar_expect_tx(&loaded, kb + vb + qb);
    bulk_load(keys_s, keys + (size_t)b * T * A, kb, &loaded);
    bulk_load(vals_s, values + (size_t)b * T * H, vb, &loaded);
    bulk_load(q_s, q + (size_t)b * K * A, qb, &loaded);
  }
  for (int a = tid; a < A; a += blockDim.x) u_s[a] = __float2bfloat16_rn(u[a]);
  for (int t = tid; t < T; t += blockDim.x) m_s[t] = fmask[(size_t)b * T + t];
  __syncthreads();
  mbar_wait(&loaded, 0);
  const uint4* k4 = reinterpret_cast<const uint4*>(keys_s);
  const uint4* q4 = reinterpret_cast<const uint4*>(q_s);

  // scores[k, t] = sum_a bf16(tanh(bf16(keys + q))) * bf16(u): a warp per
  // frame t for all K rows (each key vector loaded once for the K rows, K
  // independent sums), eight columns a lane per step
  const uint4* u4 = reinterpret_cast<const uint4*>(u_s);
  for (int t = warp; t < T; t += nwarps) {
    float s[kMaxBeam];
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k) s[k] = 0.f;
    for (int a8 = lane; a8 < A8; a8 += 32) {
      const uint4 kv = k4[t * A8 + a8], uv = u4[a8];
      float kf[8], uf[8];
      unpack8(kv, kf);
      unpack8(uv, uf);
#pragma unroll
      for (int k = 0; k < kMaxBeam; ++k) {
        if (k >= K) break;
        float qf[8];
        unpack8(q4[k * A8 + a8], qf);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[k] += bf16r(tanhf(bf16r(kf[j] + qf[j]))) * uf[j];
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k) {
      if (k >= K) break;
      const float v = warp_sum(s[k]);
      if (lane == 0) p_s[k * T + t] = m_s[t] > 0.f ? v : kNeg;
    }
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

  // ctx[k, d] = sum_t attn[k, t] * values[t, d] in f32, two columns a
  // thread; written as bf16 into the ctx columns of xh
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(vals_s);
  for (int d2 = tid; d2 < H / 2; d2 += blockDim.x) {
    float a0[kMaxBeam], a1[kMaxBeam];
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k) a0[k] = a1[k] = 0.f;
    for (int t = 0; t < T; ++t) {
      const float2 v = __bfloat1622float2(v2[t * (H / 2) + d2]);
#pragma unroll
      for (int k = 0; k < kMaxBeam; ++k)
        if (k < K) {
          a0[k] += p_s[k * T + t] * v.x;
          a1[k] += p_s[k * T + t] * v.y;
        }
    }
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k)
      if (k < K)
        *reinterpret_cast<unsigned*>(
            xh + ((size_t)b * K + k) * (E + 2 * H) + E + 2 * d2) =
            pack2(a0[k], a1[k]);
  }
}

// ---- the tensor-core products: q and the gates -----------------------------

constexpr int kGemmRows = 128;   // two consumer warpgroups x 64 rows
constexpr int kGemmStages = 4;
constexpr int kGemmThreads = 288;   // 2 consumer warpgroups + 1 producer warp
constexpr int kGemmATile = kGemmRows * kDepthStep * 2;   // 16 KB
constexpr int kGemmBTile = 4 * kSlabBytes;               // 16 KB
constexpr size_t kGemmSmem =
    (size_t)kGemmStages * (kGemmATile + kGemmBTile) + 2 * kGemmStages * 8 +
    1024;

// q = bf16(acc) into q [M, A]; the block's columns start at blockIdx.y * 128.
struct QEpilogue {
  __nv_bfloat16* q;
  int M, A;
  __device__ void operator()(const float (&acc)[kAccRegs], int row0) const {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + frag_row(hh);
      if (row >= M) continue;
#pragma unroll
      for (int i = 0; i < kAccRegs / 4; ++i) {
        const int col = blockIdx.y * kWgCols + frag_col(i);
        if (col < A)
          *reinterpret_cast<unsigned*>(q + (size_t)row * A + col) =
              pack2(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
      }
    }
  }
};

// The LSTM update of hidden columns j0 = blockIdx.y * 32 .. j0 + 31: slab g
// of the accumulator holds gate g (i, f, g, o) of those columns.
struct GateEpilogue {
  const float* c;
  const float* bg;
  float* h_out;
  float* c_out;
  int M, H;
  __device__ void operator()(const float (&acc)[kAccRegs], int row0) const {
    const int j0 = blockIdx.y * kSlabCols;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + frag_row(hh);
      if (row >= M) continue;
#pragma unroll
      for (int jc = 0; jc < 4; ++jc) {
        const int j = j0 + frag_col(jc);
        const size_t o = (size_t)row * H + j;
        const float2 cp = *reinterpret_cast<const float2*>(c + o);
        float cn[2], hn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 2 * hh + e;
          const float gi = acc[4 * (0 + jc) + r] + bg[j + e];
          const float gf = acc[4 * (4 + jc) + r] + bg[H + j + e];
          const float gg = acc[4 * (8 + jc) + r] + bg[2 * H + j + e];
          const float go = acc[4 * (12 + jc) + r] + bg[3 * H + j + e];
          cn[e] = sigmoidf(gf + 1.f) * (e ? cp.y : cp.x) +
                  sigmoidf(gi) * tanhf(gg);
          hn[e] = sigmoidf(go) * tanhf(cn[e]);
        }
        *reinterpret_cast<float2*>(c_out + o) = make_float2(cn[0], cn[1]);
        *reinterpret_cast<float2*>(h_out + o) = make_float2(hn[0], hn[1]);
      }
    }
  }
};

// out[rows, cols] = A . B with A [M, depth] K-major (map `ta`, boxes 64 deep
// x 128 rows) and B [depth, *] (map `tb`, 32-column slabs). Block (x, y)
// takes rows 128x.. and the four slabs whose first columns are
// y * col_tile + s * slab_stride (s = 0..3); `epi` consumes the 64 x 128
// accumulators of each consumer warpgroup.
template <typename Epi>
__global__ void __launch_bounds__(kGemmThreads, 1)
rec_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb, int depth,
                int col_tile, int slab_stride, Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  unsigned char* a_s = smem;
  unsigned char* b_s = smem + kGemmStages * kGemmATile;
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + kGemmStages * kGemmBTile);
  uint64_t* empty = full + kGemmStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kGemmRows;
  const int n_steps = (depth + kDepthStep - 1) / kDepthStep;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {   // producer
    if (lane == 0) {
      const int col0 = blockIdx.y * col_tile;
      for (int ks = 0; ks < n_steps; ++ks) {
        const int s = ks % kGemmStages, r = ks / kGemmStages;
        if (r > 0) mbar_wait(&empty[s], (r - 1) & 1);
        mbar_expect_tx(&full[s], kGemmATile + kGemmBTile);
        tma_load(a_s + s * kGemmATile, &ta, ks * kDepthStep, row0, &full[s]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          tma_load(b_s + s * kGemmBTile + q * kSlabBytes, &tb,
                   col0 + q * slab_stride, ks * kDepthStep, &full[s]);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;   // consumer warpgroup: rows 64 wg..
  float acc[kAccRegs], part[kAccRegs];
#pragma unroll
  for (int i = 0; i < kAccRegs; ++i) acc[i] = 0.f;
  for (int ks = 0; ks < n_steps; ++ks) {
    const int s = ks % kGemmStages;
    mbar_wait(&full[s], (ks / kGemmStages) & 1);
    mma_depth_step(acc, part,
                   smem_u32(a_s + s * kGemmATile + wg * 64 * 128),
                   smem_u32(b_s + s * kGemmBTile));
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  epi(acc, row0 + wg * 64);
}

// The four TMA maps of one recurrent step; made once per call on the host.
struct RecurrentMaps {
  CUtensorMap q_a, q_b, g_a, g_b;
};

// xh bf16 [M, E+2H], wq bf16 [H, A], wg bf16 [E+2H, 4H]. Returns 0 or an
// error code (kTensorMapError + CUresult).
inline int make_recurrent_maps(RecurrentMaps* m, const void* xh,
                               const void* wq, const void* wg, int M, int E,
                               int H, int A) {
  const int D = E + 2 * H;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(xh);
  int err = make_tmap(&m->q_a, x + E + H, H, M, D, kDepthStep, kGemmRows);
  if (!err) err = make_tmap(&m->q_b, wq, A, H, A, kSlabCols, kDepthStep);
  if (!err) err = make_tmap(&m->g_a, x, D, M, D, kDepthStep, kGemmRows);
  if (!err) err = make_tmap(&m->g_b, wg, 4 * H, D, 4 * H, kSlabCols, kDepthStep);
  return err;
}

// Allow the kernels' dynamic shared memory past 48 KB.
inline int recurrent_setup() {
  int err = allow_max_smem<attention_kernel>();
  if (!err) err = allow_max_smem<rec_gemm_kernel<QEpilogue>>();
  if (!err) err = allow_max_smem<rec_gemm_kernel<GateEpilogue>>();
  return err;
}

// One recurrent step for M = B*K rows: xh and q are scratch; h' and c' are
// written to h_out, c_out (which must not alias h, c). Returns the
// cudaError_t of the launches.
inline int recurrent_step(const RecurrentMaps& m, const float* emb,
                          const float* h, const float* c,
                          const __nv_bfloat16* keys,
                          const __nv_bfloat16* values, const float* fmask,
                          const float* u, const float* bg, __nv_bfloat16* xh,
                          __nv_bfloat16* q, float* h_out, float* c_out, int B,
                          int K, int T, int E, int H, int A, cudaStream_t s) {
  const int M = B * K;
  const int vecs = M * (E + H) / 8;
  pack_kernel<<<(vecs + kPackThreads - 1) / kPackThreads, kPackThreads, 0, s>>>(
      emb, h, xh, M, E, H);
  const int row_tiles = (M + kGemmRows - 1) / kGemmRows;
  rec_gemm_kernel<QEpilogue><<<dim3(row_tiles, (A + kWgCols - 1) / kWgCols),
                               kGemmThreads, kGemmSmem, s>>>(
      m.q_a, m.q_b, H, kWgCols, kSlabCols, QEpilogue{q, M, A});
  attention_kernel<<<B, kAttnThreads, attention_smem(K, T, H, A), s>>>(
      q, keys, values, fmask, u, xh, K, T, E, H, A);
  rec_gemm_kernel<GateEpilogue><<<dim3(row_tiles, H / kSlabCols),
                                  kGemmThreads, kGemmSmem, s>>>(
      m.g_a, m.g_b, E + 2 * H, kSlabCols, H,
      GateEpilogue{c, bg, h_out, c_out, M, H});
  return (int)cudaGetLastError();
}

}  // namespace vidcap
