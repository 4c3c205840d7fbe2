// K5 moe: the data movement around the routed experts' grouped GEMMs of the
// language-model decoder (models/lm_decoder.py::MoE), in three entry points:
//
//   vidcap_moe_dispatch  each token's experts sel [N, k] -> the expert-sorted
//                        copy of x's rows, each expert's token count and the
//                        int32 group ends, each slot's flat pair and each
//                        pair's slot (a stable counting sort: three launches)
//   vidcap_silu_mul      bf16(bf16(silu(gate)) * up) of [gate | up]
//   vidcap_moe_combine   h + bf16(bf16(sum_j bf16(w_j) * y[slot_j]) + shared)
//
// Replaces no TPU kernel: the JAX package has no mixture of experts. It
// replaces the PyTorch passes of ops/moe.py's plain versions: a stable
// argsort, bincount (which reads the ids' min and max on the host), cumsum
// and a row gather on the way in; a strided elementwise pass of two ops on
// the halves of gate_up; a second argsort, a gather, a batched GEMV and two
// adds on the way out.
//
// What bounds it on the H100: bytes. At the decode's 5,120 rows (k 6, H
// 2,048, I 1,408) the dispatch writes the 126 MB sorted copy and reads x
// (21 MB), the activation reads gate_up (173 MB) and writes 87 MB, the
// combine reads y (126 MB), shared and h and writes h' (21 MB each): ~600 MB,
// 0.18 ms a layer at 3.35 TB/s. Each kernel reads and writes its tensors
// once, in 16-byte vectors, with one warp (dispatch) or one thread (the
// others) per 8 columns of a row.
//
// Arithmetic: the dispatch moves bits and counts integers, so its outputs
// are exactly the plain version's (a stable sort of the ids is unique). The
// activation computes as PyTorch's CUDA silu and mul do: f32, x / (1 +
// expf(-x)) with IEEE division, rounded to bf16, times up in f32, rounded.
// The combine sums the k products in f32 in the order j = 0..k-1 (the bf16
// products are exact in f32), then rounds where the plain version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

using bf16 = __nv_bfloat16;
using namespace vidcap;

namespace {

constexpr int kTile = 1024;      // flat pairs a block of the sort, a thread each
constexpr int kWarps = kTile / 32;
constexpr int kMaxExperts = 256; // the sort's per-warp histograms in 32 KB
constexpr int kCopyWarps = 8;    // pairs a block of the scatter, a warp each

// Per block of kTile flat pairs: each pair's rank among the block's earlier
// pairs of its expert (__match_any_sync within a warp, then the earlier
// warps' counts), and the block's count of each expert. Ids outside [0, E)
// are left out of both.
__global__ void moe_hist_kernel(const long long* __restrict__ sel, int M,
                                int E, int* __restrict__ rank,
                                int* __restrict__ bcount) {
  __shared__ int whist[kWarps * kMaxExperts];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < kWarps * E; i += kTile) whist[i] = 0;
  __syncthreads();
  const int i = blockIdx.x * kTile + tid;
  long long id = i < M ? sel[i] : -1;
  const int e = (id >= 0 && id < E) ? static_cast<int>(id) : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, e);
  const int before = __popc(peers & ((1u << lane) - 1u));
  if (e >= 0 && before == 0) whist[warp * E + e] = __popc(peers);
  __syncthreads();
  for (int x = tid; x < E; x += kTile) {     // exclusive scan over the warps
    int run = 0;
#pragma unroll 8
    for (int w = 0; w < kWarps; ++w) {
      const int c = whist[w * E + x];
      whist[w * E + x] = run;
      run += c;
    }
    bcount[blockIdx.x * E + x] = run;
  }
  __syncthreads();
  if (e >= 0) rank[i] = whist[warp * E + e] + before;
}

// One block of kMaxExperts threads, a thread an expert: the expert's count
// (int64, as bincount) and group end (int32, as cumsum), and each sort
// block's first slot of the expert, base[b][e] = the expert's start + its
// pairs in blocks before b.
__global__ void moe_scan_kernel(const int* __restrict__ bcount, int nb, int E,
                                int* __restrict__ base,
                                long long* __restrict__ counts,
                                int* __restrict__ offs) {
  __shared__ int start[kMaxExperts];
  const int x = threadIdx.x;
  int total = 0;
  if (x < E) {
#pragma unroll 8
    for (int b = 0; b < nb; ++b) total += bcount[b * E + x];
  }
  start[x] = total;
  __syncthreads();
  if (x == 0) {
    int run = 0;
    for (int j = 0; j < E; ++j) {
      const int c = start[j];
      start[j] = run;
      run += c;
    }
  }
  __syncthreads();
  if (x >= E) return;
  int run = start[x];
  counts[x] = total;
  offs[x] = run + total;
#pragma unroll 8
  for (int b = 0; b < nb; ++b) {
    const int c = bcount[b * E + x];
    base[b * E + x] = run;
    run += c;
  }
}

// A warp a flat pair i = token * k + j: its slot, order[slot] = i,
// slots[i] = slot, and the token's row of x into xs[slot] (H / 8 vectors).
__global__ void moe_scatter_kernel(const long long* __restrict__ sel,
                                   const uint4* __restrict__ x,
                                   const int* __restrict__ rank,
                                   const int* __restrict__ base, int M, int k,
                                   int E, int H8,
                                   long long* __restrict__ order,
                                   int* __restrict__ slots,
                                   uint4* __restrict__ xs) {
  const int i = blockIdx.x * kCopyWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= M) return;
  const long long id = sel[i];
  if (id < 0 || id >= E) return;
  const int slot = base[(i / kTile) * E + static_cast<int>(id)] + rank[i];
  if (lane == 0) {
    order[slot] = i;
    slots[i] = slot;
  }
  const uint4* src = x + static_cast<size_t>(i / k) * H8;
  uint4* dst = xs + static_cast<size_t>(slot) * H8;
#pragma unroll 4
  for (int c = lane; c < H8; c += 32) dst[c] = src[c];
}

// Rows of [gate | up] (2I wide) -> [R, I]: a thread 8 columns of a row,
// rows in chunks of kSiluRows a block.
constexpr int kSiluRows = 8;

__global__ void silu_mul_kernel(const uint4* __restrict__ gate_up, int R,
                                int I8, uint4* __restrict__ out) {
  const int r0 = blockIdx.x * kSiluRows;
  const int rows = min(kSiluRows, R - r0);
  for (int t = threadIdx.x; t < rows * I8; t += blockDim.x) {
    const int r = r0 + t / I8, c = t % I8;
    const uint4 gv = gate_up[static_cast<size_t>(r) * 2 * I8 + c];
    const uint4 uv = gate_up[static_cast<size_t>(r) * 2 * I8 + I8 + c];
    float g[8], u[8];
    unpack8(gv, g);
    unpack8(uv, u);
    float o[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float s = bf16r(g[q] / (1.0f + expf(-g[q])));
      o[q] = s * u[q];
    }
    out[static_cast<size_t>(r) * I8 + c] =
        make_uint4(pack2(o[0], o[1]), pack2(o[2], o[3]), pack2(o[4], o[5]),
                   pack2(o[6], o[7]));
  }
}

// A block a token: its k rows of y through the slot table, weighted by
// bf16(w), summed in f32 (j = 0..k-1), rounded; + shared, rounded; h +
// that, rounded. A thread 8 columns.
__global__ void moe_combine_kernel(const uint4* __restrict__ y,
                                   const int* __restrict__ slots,
                                   const float* __restrict__ w,
                                   const uint4* __restrict__ shared,
                                   const uint4* __restrict__ h, int k, int H8,
                                   uint4* __restrict__ out) {
  const int n = blockIdx.x;
  for (int c = threadIdx.x; c < H8; c += blockDim.x) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < k; ++j) {
      const int slot = slots[n * k + j];
      const float wj = bf16r(w[n * k + j]);
      float v[8];
      unpack8(y[static_cast<size_t>(slot) * H8 + c], v);
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[q] += wj * v[q];
    }
    float s[8], r[8];
    unpack8(shared[static_cast<size_t>(n) * H8 + c], s);
    unpack8(h[static_cast<size_t>(n) * H8 + c], r);
#pragma unroll
    for (int q = 0; q < 8; ++q) r[q] += bf16r(bf16r(acc[q]) + s[q]);
    out[static_cast<size_t>(n) * H8 + c] =
        make_uint4(pack2(r[0], r[1]), pack2(r[2], r[3]), pack2(r[4], r[5]),
                   pack2(r[6], r[7]));
  }
}

int threads_for(int H8) {
  const int t = (H8 + 31) / 32 * 32;
  return t < 256 ? t : 256;
}

}  // namespace

// Shapes: sel [N, k] int64 (ids in [0, E)); x [N, H] bf16; scratch rank
// [N*k], bcount and base [ceil(N*k / 1024), E] int32; outputs order [N*k]
// int64, slots [N*k] int32, counts [E] int64, offs [E] int32, xs [N*k, H]
// bf16. Needs 1 <= E <= 256 and H % 8 == 0. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int vidcap_moe_dispatch(const void* sel, const void* x, void* rank,
                                   void* bcount, void* base, void* order,
                                   void* slots, void* counts, void* offs,
                                   void* xs, int N, int k, int E, int H,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = N * k, nb = (M + kTile - 1) / kTile;
  if (M == 0) return 0;
  moe_hist_kernel<<<nb, kTile, 0, s>>>(static_cast<const long long*>(sel), M,
                                       E, static_cast<int*>(rank),
                                       static_cast<int*>(bcount));
  int err = cudaGetLastError();
  if (err) return err;
  moe_scan_kernel<<<1, kMaxExperts, 0, s>>>(
      static_cast<const int*>(bcount), nb, E, static_cast<int*>(base),
      static_cast<long long*>(counts), static_cast<int*>(offs));
  err = cudaGetLastError();
  if (err) return err;
  moe_scatter_kernel<<<(M + kCopyWarps - 1) / kCopyWarps, 32 * kCopyWarps, 0,
                       s>>>(
      static_cast<const long long*>(sel), static_cast<const uint4*>(x),
      static_cast<const int*>(rank), static_cast<const int*>(base), M, k, E,
      H / 8, static_cast<long long*>(order), static_cast<int*>(slots),
      static_cast<uint4*>(xs));
  return cudaGetLastError();
}

// gate_up [R, 2I] bf16 -> out [R, I] bf16; needs I % 8 == 0.
extern "C" int vidcap_silu_mul(const void* gate_up, void* out, int R, int I,
                               void* stream) {
  if (R == 0) return 0;
  silu_mul_kernel<<<(R + kSiluRows - 1) / kSiluRows, 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(gate_up), R, I / 8, static_cast<uint4*>(out));
  return cudaGetLastError();
}

// y [N*k, H] bf16 (expert-sorted rows); slots [N*k] int32 (each flat pair's
// row of y); w [N, k] f32; shared, h, out [N, H] bf16; needs H % 8 == 0.
extern "C" int vidcap_moe_combine(const void* y, const void* slots,
                                  const void* w, const void* shared,
                                  const void* h, void* out, int N, int k,
                                  int H, void* stream) {
  if (N == 0) return 0;
  moe_combine_kernel<<<N, threads_for(H / 8), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(y), static_cast<const int*>(slots),
      static_cast<const float*>(w), static_cast<const uint4*>(shared),
      static_cast<const uint4*>(h), k, H / 8, static_cast<uint4*>(out));
  return cudaGetLastError();
}
