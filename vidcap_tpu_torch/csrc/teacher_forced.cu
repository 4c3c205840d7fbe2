// K4 teacher_forced: the teacher-forced pass of the one-layer attention
// decoder (CaptionDecoder.xe_logits), forward and backward.
//
// Replaces no Pallas kernel: the JAX package leaves this scan body
// (vidcap_tpu/models/decoder.py:313, differentiated by jax.grad) to XLA,
// which fuses its rounding chain. The port's PyTorch loop ran that chain as
// ~60 small kernels a timestep forward and about twice that backward; here a
// timestep is two kernels between the two f32 products each way, and the
// output projection runs once for all timesteps (ops/teacher_forced.py has
// the host loop that sequences them, the products in torch.matmul, and the
// plain version).
//
// What bounds it on the H100 at scst_cider's shape (B=32, L=30, T=26,
// E=H=A=512, Vp=12,032): the products stay f32 on the FFMA pipes (67
// TFLOP/s): forward 2*960*(512*512 + 1536*2048 + 512*12032) = 18.4 GFLOP,
// backward twice that (the operands' and the weights' cotangents): 0.27 +
// 0.55 ms at the f32 peak. The bytes (the f32 logits and their cotangent,
// 46 MB each, the weights) are ~0.03 ms each way. What it meets first is
// latency: 30 dependent timesteps of four launches each way, each a few
// microseconds of work on 32 rows. So the design keeps the timestep to two
// small kernels between cuBLAS's two products, splits each row's attention
// over four blocks of 1,024 threads, and moves everything that does not
// depend on the recurrence out of it: the output projection and its
// cotangent's product as one product over all 960 rows, the weight
// gradients as one kernel each that rounds every timestep's product before
// the f32 sum (prefetching the next timestep's rows while it computes).
// Kernels, each on the caller's stream, none allocating:
//   round_kernel     f32 -> bf16-valued f32 (each weight once a pass)
//   attn_fwd_kernel  four blocks a row: q = bf16(q_raw), the scores, the mask,
//                    the softmax, ctx, and the gate product's operand
//                    bf16([emb; ctx; h])
//   lstm_fwd_kernel  gates + b, the LSTM update, bf16(h') for the products
//                    (the next q product's rows, and the projection's)
//   logits_kernel    bf16(bf16(P) + bf16(b_out)), padding columns -1e30
//   logits_bwd_kernel the cotangent masked and rounded as rnd's backward
//   lstm_bwd_kernel  the LSTM update's backward, the hidden cotangent summed
//                    in the plain loop's order
//   attn_bwd_kernel  four blocks a row: the attention's backward, the keys'
//                    and values' cotangents accumulated in bf16 as autograd
//                    accumulates a bf16 tensor's
//   colsum_kernel    per column: sum over rows, rounded if asked, summed over
//                    timesteps last to first (bias and u gradients)
//   wgrad_kernel     sum over timesteps, last to first, of bf16(X_t^T Y_t):
//                    each timestep's weight gradient rounded before the f32
//                    sum, as the cast of the weight at each timestep makes
//                    autograd round it
// Every forward rounding point of the plain loop is kept, and every cotangent
// rounding its casts' backward applies. Products stay f32 (FFMA); sums run
// in another order than cuBLAS's, so a value next to a bf16 rounding boundary
// may land one ulp apart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

using bf16 = __nv_bfloat16;
using namespace vidcap;

namespace {

constexpr int kThreads = 256;

// torch's sigmoid_backward and tanh_backward on the output y
__device__ __forceinline__ float sigmoid_bwd(float g, float y) {
  return g * (1.f - y) * y;
}
__device__ __forceinline__ float tanh_bwd(float g, float y) {
  return g * (1.f - y * y);
}

__global__ void round_kernel(const float* __restrict__ src,
                             float* __restrict__ dst, long n) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    dst[i] = bf16r(src[i]);
}

// The eight bf16 at p (16-byte aligned) as floats.
__device__ __forceinline__ void ld8(const bf16* p, float (&f)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

// The attention kernels: a row b is kSplit blocks of kAttn threads, block s
// owning a slice of the columns (H / kSplit of ctx and of the values' and
// h's cotangents, A / kSplit of the keys' and q's, E / kSplit of emb); the
// per-frame values each slice needs (the scores, the softmax and its
// backward) are computed by every block of the row. A warp a frame for the
// dot products over A or H (8 columns a lane a load); then column pairs a
// thread, the frames split over the groups of threads the pairs leave
// (kAttn / pairs groups, their partial sums added in group order).
constexpr int kAttn = 1024, kSplit = 4, kPart = 2 * kAttn;

__device__ __forceinline__ int slice0(int n, int s) {
  return s * (n / kSplit);
}

// Shared: q[A], bf16(u)[A], the scores then bf16(attn)[T], the groups'
// partial sums of the slice of ctx[kPart].
__global__ void __launch_bounds__(kAttn)
attn_fwd_kernel(const float* __restrict__ qraw, const bf16* __restrict__ keys,
                const bf16* __restrict__ values,
                const float* __restrict__ fmask, const float* __restrict__ u,
                const float* __restrict__ emb, const float* __restrict__ rh,
                float* __restrict__ xh, float* __restrict__ attn, int T,
                int E, int H, int A, int emb_row) {
  extern __shared__ float sm[];
  float* q = sm;
  float* ru = q + A;
  float* sc = ru + A;
  float* part = sc + T;
  const int b = blockIdx.x, s = blockIdx.y, tid = threadIdx.x,
            lane = tid & 31, warp = tid >> 5;
  for (int a = tid; a < A; a += kAttn) {
    q[a] = bf16r(qraw[(long)b * A + a]);
    ru[a] = bf16r(u[a]);
  }
  __syncthreads();
  const bf16* kb = keys + (long)b * T * A;
  for (int t = warp; t < T; t += kAttn / 32) {
    float acc = 0.f;
    for (int a0 = lane * 8; a0 < A; a0 += 256) {
      float k[8];
      ld8(kb + (long)t * A + a0, k);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc = fmaf(bf16r(tanhf(bf16r(k[j] + q[a0 + j]))), ru[a0 + j], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) sc[t] = fmask[(long)b * T + t] > 0.f ? acc : kNeg;
  }
  __syncthreads();
  if (warp == 0) {   // the softmax over frames, f32
    float m = -INFINITY;
    for (int t = lane; t < T; t += 32) m = fmaxf(m, sc[t]);
    m = warp_max(m);
    float sum = 0.f;
    for (int t = lane; t < T; t += 32) sum += expf(sc[t] - m);
    sum = warp_sum(sum);
    __syncwarp();
    for (int t = lane; t < T; t += 32) {
      const float p = expf(sc[t] - m) / sum;
      if (s == 0) attn[(long)b * T + t] = p;
      sc[t] = bf16r(p);
    }
  }
  __syncthreads();
  // ctx = Σ_T bf16(attn)·values on the slice d0..d0+Hs
  const int Hs = H / kSplit, d0 = slice0(H, s);
  const int pairs = Hs / 2, groups = kAttn / pairs,
            per = (T + groups - 1) / groups;
  const int p = tid % pairs, g = tid / pairs;
  const __nv_bfloat162* vb =
      reinterpret_cast<const __nv_bfloat162*>(values + (long)b * T * H + d0) +
      p;
  if (g < groups) {
    float c0 = 0.f, c1 = 0.f;
    for (int t = g * per; t < min(T, (g + 1) * per); ++t) {
      const float2 v = __bfloat1622float2(vb[(long)t * (H / 2)]);
      c0 = fmaf(sc[t], v.x, c0);
      c1 = fmaf(sc[t], v.y, c1);
    }
    part[g * Hs + 2 * p] = c0;
    part[g * Hs + 2 * p + 1] = c1;
  }
  __syncthreads();
  float* x = xh + (long)b * (E + 2 * H);
  for (int d = tid; d < Hs; d += kAttn) {
    float c = part[d];
    for (int k = 1; k < groups; ++k) c += part[k * Hs + d];
    x[E + d0 + d] = bf16r(c);
    x[E + H + d0 + d] = rh[(long)b * H + d0 + d];   // already bf16-valued
  }
  const int e1 = s == kSplit - 1 ? E : slice0(E, s + 1);
  for (int e = slice0(E, s) + tid; e < e1; e += kAttn)
    x[e] = bf16r(emb[(long)b * emb_row + e]);
}

// gates = g + bias (i, f, g, o); c' = σ(f+1)·c + σ(i)·tanh(g);
// h' = σ(o)·tanh(c'). Each product and sum rounded on its own, as the plain
// loop's separate kernels round them.
struct Gates {
  float si, sf, tg, so, c, nc, tc;
};

__device__ __forceinline__ Gates lstm_gates(const float* g, const float* bias,
                                            const float* c, int b, int j,
                                            int H) {
  const float* gr = g + (long)b * 4 * H;
  Gates r;
  r.si = sigmoidf(gr[j] + bias[j]);
  r.sf = sigmoidf((gr[H + j] + bias[H + j]) + 1.f);
  r.tg = tanhf(gr[2 * H + j] + bias[2 * H + j]);
  r.so = sigmoidf(gr[3 * H + j] + bias[3 * H + j]);
  r.c = c[(long)b * H + j];
  r.nc = __fadd_rn(__fmul_rn(r.sf, r.c), __fmul_rn(r.si, r.tg));
  r.tc = tanhf(r.nc);
  return r;
}

__global__ void lstm_fwd_kernel(const float* __restrict__ g,
                                const float* __restrict__ bias,
                                const float* __restrict__ c,
                                float* __restrict__ c_out,
                                float* __restrict__ rh_out,
                                float* __restrict__ ho_out, int B, int H,
                                int ho_row) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H) return;
  const int b = i / H, j = i % H;
  const Gates r = lstm_gates(g, bias, c, b, j, H);
  const float h = bf16r(__fmul_rn(r.so, r.tc));
  c_out[i] = r.nc;
  rh_out[i] = h;
  ho_out[(long)b * ho_row + j] = h;
}

// In place on the f32 product P [N, Vp] (4 columns a thread).
__global__ void logits_kernel(float* __restrict__ p,
                              const float* __restrict__ b_out, long n4,
                              int Vp, int vocab) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 v = reinterpret_cast<float4*>(p)[i];
    const int col = (int)((i * 4) % Vp);
    float* e = &v.x;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      e[k] = col + k < vocab ? bf16r(bf16r(e[k]) + bf16r(b_out[col + k]))
                             : kNeg;
    reinterpret_cast<float4*>(p)[i] = v;
  }
}

__global__ void logits_bwd_kernel(const float* __restrict__ dl,
                                  float* __restrict__ dp, long n4, int Vp,
                                  int vocab) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 v = reinterpret_cast<const float4*>(dl)[i];
    const int col = (int)((i * 4) % Vp);
    float* e = &v.x;
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = col + k < vocab ? bf16r(e[k]) : 0.f;
    reinterpret_cast<float4*>(dp)[i] = v;
  }
}

// The LSTM update's backward at one timestep. The hidden cotangent is the
// plain loop's sum: (bf16(ga) + gc) + bf16(dhl), ga the q product's raw
// cotangent and gc the gate operand's h slice from the next timestep (both
// absent at the last), dhl the logits' raw cotangent of h'.
__global__ void lstm_bwd_kernel(const float* __restrict__ g,
                                const float* __restrict__ bias,
                                const float* __restrict__ c,
                                const float* __restrict__ dhl,
                                const float* __restrict__ ga,
                                const float* __restrict__ gc,
                                const float* __restrict__ dc_next,
                                float* __restrict__ dg,
                                float* __restrict__ dc_out, int B, int H,
                                int dhl_row) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H) return;
  const int b = i / H, j = i % H;
  const Gates r = lstm_gates(g, bias, c, b, j, H);
  float dh = bf16r(dhl[(long)b * dhl_row + j]);
  if (ga != nullptr) dh = __fadd_rn(__fadd_rn(bf16r(ga[i]), gc[i]), dh);
  const float d_so = __fmul_rn(dh, r.tc);
  float dnc = tanh_bwd(__fmul_rn(dh, r.so), r.tc);
  if (dc_next != nullptr) dnc = __fadd_rn(dnc, dc_next[i]);
  const float d_sf = __fmul_rn(dnc, r.c);
  const float d_si = __fmul_rn(dnc, r.tg);
  const float d_tg = __fmul_rn(dnc, r.si);
  dc_out[i] = __fmul_rn(dnc, r.sf);
  float* d = dg + (long)b * 4 * H;
  d[j] = sigmoid_bwd(d_si, r.si);
  d[H + j] = sigmoid_bwd(d_sf, r.sf);
  d[2 * H + j] = tanh_bwd(d_tg, r.tg);
  d[3 * H + j] = sigmoid_bwd(d_so, r.so);
}

// The attention's backward at one timestep, from the gate operand's raw
// cotangent dxh [B, E+2H], a row kSplit blocks as the forward. Writes
// bf16(dxh)'s emb and h slices (d_emb, gc), accumulates the keys' and
// values' cotangents in bf16 (dk, dv; written, not added to, at the first
// timestep it runs: the last), and writes d q_raw = bf16(Σ_T d(keys+q))
// (dq) and the row's share Σ_T dscores·s of u's cotangent (pu). Shared:
// d ctx[H], q and bf16(u) of the slice[A / kSplit each], attn[T],
// bf16(attn)[T], d attn then d scores[T], the groups' partial sums of dq
// and pu[2 kPart].
__global__ void __launch_bounds__(kAttn)
attn_bwd_kernel(const float* __restrict__ dxh, const bf16* __restrict__ keys,
                const bf16* __restrict__ values,
                const float* __restrict__ fmask, const float* __restrict__ u,
                const float* __restrict__ qraw,
                const float* __restrict__ attn, float* __restrict__ d_emb,
                float* __restrict__ gc, bf16* __restrict__ dk,
                bf16* __restrict__ dv, float* __restrict__ dq,
                float* __restrict__ pu, int T, int E, int H, int A,
                int emb_row, int first) {
  extern __shared__ float sm[];
  const int As = A / kSplit, Hs = H / kSplit;
  float* dctx = sm;
  float* q = dctx + H;
  float* ru = q + As;
  float* at = ru + As;
  float* ra = at + T;
  float* da = ra + T;
  float* part = da + T;
  const int b = blockIdx.x, s = blockIdx.y, tid = threadIdx.x,
            lane = tid & 31, warp = tid >> 5;
  const int a0 = slice0(A, s), d0 = slice0(H, s);
  const float* gr = dxh + (long)b * (E + 2 * H);
  const int e1 = s == kSplit - 1 ? E : slice0(E, s + 1);
  for (int e = slice0(E, s) + tid; e < e1; e += kAttn)
    d_emb[(long)b * emb_row + e] = bf16r(gr[e]);
  for (int d = tid; d < H; d += kAttn) dctx[d] = bf16r(gr[E + d]);
  for (int d = tid; d < Hs; d += kAttn)
    gc[(long)b * H + d0 + d] = bf16r(gr[E + H + d0 + d]);
  for (int a = tid; a < As; a += kAttn) {
    q[a] = bf16r(qraw[(long)b * A + a0 + a]);
    ru[a] = bf16r(u[a0 + a]);
  }
  for (int t = tid; t < T; t += kAttn) {
    const float p = attn[(long)b * T + t];
    at[t] = p;
    ra[t] = bf16r(p);
  }
  __syncthreads();
  const bf16* vb = values + (long)b * T * H;
  for (int t = warp; t < T; t += kAttn / 32) {   // bf16(d ctx·values)
    float acc = 0.f;
    for (int c0 = lane * 8; c0 < H; c0 += 256) {
      float v[8];
      ld8(vb + (long)t * H + c0, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = fmaf(dctx[c0 + j], v[j], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) da[t] = bf16r(acc);
  }
  // d values += bf16(bf16(attn)·d ctx) on the slice, a pair a thread and
  // frame
  __nv_bfloat162* dvb =
      reinterpret_cast<__nv_bfloat162*>(dv + (long)b * T * H + d0);
  for (int i = tid; i < T * (Hs / 2); i += kAttn) {
    const int t = i / (Hs / 2), p = i % (Hs / 2);
    __nv_bfloat162* o = dvb + (long)t * (H / 2) + p;
    const float2 old = first ? make_float2(0.f, 0.f) : __bfloat1622float2(*o);
    *o = __floats2bfloat162_rn(old.x + bf16r(ra[t] * dctx[d0 + 2 * p]),
                               old.y + bf16r(ra[t] * dctx[d0 + 2 * p + 1]));
  }
  __syncthreads();
  if (warp == 0) {   // the softmax's backward, then the frame mask's
    float dot = 0.f;
    for (int t = lane; t < T; t += 32) dot = fmaf(da[t], at[t], dot);
    dot = warp_sum(dot);
    __syncwarp();
    for (int t = lane; t < T; t += 32) {
      const float v = __fmul_rn(at[t], __fsub_rn(da[t], dot));
      da[t] = fmask[(long)b * T + t] > 0.f ? v : 0.f;
    }
  }
  __syncthreads();
  // through the tanh to keys + q on the slice: pair p, frames of group g
  const int pairs = As / 2, groups = kAttn / pairs,
            per = (T + groups - 1) / groups;
  const int p = tid % pairs, g = tid / pairs;
  const __nv_bfloat162* kb =
      reinterpret_cast<const __nv_bfloat162*>(keys + (long)b * T * A + a0) + p;
  __nv_bfloat162* dkb =
      reinterpret_cast<__nv_bfloat162*>(dk + (long)b * T * A + a0) + p;
  if (g < groups) {
    const float q0 = q[2 * p], q1 = q[2 * p + 1];
    const float u0 = ru[2 * p], u1 = ru[2 * p + 1];
    float sq0 = 0.f, sq1 = 0.f, su0 = 0.f, su1 = 0.f;
    for (int t = g * per; t < min(T, (g + 1) * per); ++t) {
      const long i = (long)t * (A / 2);
      const float2 k = __bfloat1622float2(kb[i]);
      const float th0 = tanhf(bf16r(k.x + q0)), th1 = tanhf(bf16r(k.y + q1));
      const float e0 = bf16r(tanh_bwd(bf16r(__fmul_rn(da[t], u0)), th0));
      const float e1 = bf16r(tanh_bwd(bf16r(__fmul_rn(da[t], u1)), th1));
      const float2 old =
          first ? make_float2(0.f, 0.f) : __bfloat1622float2(dkb[i]);
      dkb[i] = __floats2bfloat162_rn(old.x + e0, old.y + e1);
      sq0 += e0;
      sq1 += e1;
      su0 = fmaf(da[t], bf16r(th0), su0);
      su1 = fmaf(da[t], bf16r(th1), su1);
    }
    part[g * As + 2 * p] = sq0;
    part[g * As + 2 * p + 1] = sq1;
    part[kPart + g * As + 2 * p] = su0;
    part[kPart + g * As + 2 * p + 1] = su1;
  }
  __syncthreads();
  for (int a = tid; a < As; a += kAttn) {
    float sq = part[a], su = part[kPart + a];
    for (int k = 1; k < groups; ++k) {
      sq += part[k * As + a];
      su += part[kPart + k * As + a];
    }
    dq[(long)b * A + a0 + a] = bf16r(sq);
    pu[(long)b * A + a0 + a] = su;
  }
}

// out[n] = Σ_{t = L-1..0} r(Σ_{b<B} Y(t, b, n)), r = bf16 rounding or none.
// A block 32 columns x 32 timesteps: each thread one (t, column) sum, then
// the timesteps of each chunk of 32, last first, added by its first row.
__global__ void __launch_bounds__(1024)
colsum_kernel(const float* __restrict__ y, int yt, int yb,
              float* __restrict__ out, int L, int B, int N, int round) {
  __shared__ float part[32][33];
  const int n = blockIdx.x * 32 + threadIdx.x, tl = threadIdx.y;
  float acc = 0.f;
  for (int base = (L - 1) / 32 * 32; base >= 0; base -= 32) {
    const int t = base + tl;
    float s = 0.f;
    if (t < L && n < N) {
      const float* p = y + (long)t * yt + n;
      for (int b = 0; b < B; ++b) s += p[(long)b * yb];
      if (round) s = bf16r(s);
    }
    part[tl][threadIdx.x] = s;
    __syncthreads();
    if (tl == 0)
      for (int k = min(31, L - 1 - base); k >= 0; --k)
        acc += part[k][threadIdx.x];
    __syncthreads();
  }
  if (tl == 0 && n < N) out[n] = acc;
}

// out[M, N] = Σ_{t = L-1..0} bf16(Σ_{b<B} X(t, b, m) · Y(t, b, n)): a tile
// of 16R x 16R a block of 256 threads, R x R a thread (R = 4 for the wide
// weights, 2 for narrow ones, whose 64-wide tiles would leave SMs idle; a
// 128-wide tile, 8 x 8 a thread, measured slower: one block an SM).
// The rows go through shared memory 32 at a time (a stage: a timestep's
// rows, last timestep first); each thread fetches the next stage into
// registers while the block computes on this one.
constexpr int kRows = 32;

template <int R, int PER>
__device__ __forceinline__ void wgrad_fetch(
    const float* __restrict__ x, int xt, int xb, const float* __restrict__ y,
    int yt, int yb, int t, int b0, int B, int m0, int n0, int M, int N,
    float (&xr)[PER], float (&yr)[PER]) {
  constexpr int TILE = 16 * R;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * kThreads, r = i / TILE, col = i % TILE;
    const long row = b0 + r;
    const bool in = row < B;
    xr[k] = in && m0 + col < M ? x[(long)t * xt + row * xb + m0 + col] : 0.f;
    yr[k] = in && n0 + col < N ? y[(long)t * yt + row * yb + n0 + col] : 0.f;
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const float* __restrict__ x, int xt, int xb,
             const float* __restrict__ y, int yt, int yb,
             float* __restrict__ out, int L, int B, int M, int N) {
  constexpr int TILE = 16 * R, PER = kRows * TILE / kThreads;
  using Vec = typename std::conditional<R == 4, float4, float2>::type;
  __shared__ __align__(16) float xs[kRows][TILE];
  __shared__ __align__(16) float ys[kRows][TILE];
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int chunks = (B + kRows - 1) / kRows, stages = L * chunks;
  float xr[PER], yr[PER];
  float acc[R][R] = {}, p[R][R] = {};
  wgrad_fetch<R, PER>(x, xt, xb, y, yt, yb, L - 1, 0, B, m0, n0, M, N, xr,
                      yr);
  for (int st = 0; st < stages; ++st) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = threadIdx.x + k * kThreads;
      xs[i / TILE][i % TILE] = xr[k];
      ys[i / TILE][i % TILE] = yr[k];
    }
    __syncthreads();
    if (st + 1 < stages)
      wgrad_fetch<R, PER>(x, xt, xb, y, yt, yb, L - 1 - (st + 1) / chunks,
                          ((st + 1) % chunks) * kRows, B, m0, n0, M, N, xr,
                          yr);
    // rows past B were fetched as zeros: they add nothing
#pragma unroll 8
    for (int r = 0; r < kRows; ++r) {
      const Vec a = *reinterpret_cast<const Vec*>(&xs[r][ty * R]);
      const Vec c = *reinterpret_cast<const Vec*>(&ys[r][tx * R]);
      const float* av = reinterpret_cast<const float*>(&a);
      const float* cv = reinterpret_cast<const float*>(&c);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) p[i][j] = fmaf(av[i], cv[j], p[i][j]);
    }
    if (st % chunks == chunks - 1) {   // a timestep's product: round, add
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          acc[i][j] += bf16r(p[i][j]);
          p[i][j] = 0.f;
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int m = m0 + ty * R + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (n0 + tx * R + j < N) out[(long)m * N + n0 + tx * R + j] = acc[i][j];
  }
}

// (bf16(ga) + gc): h0's cotangent after the first timestep's backward
__global__ void dh0_kernel(const float* __restrict__ ga,
                           const float* __restrict__ gc,
                           float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __fadd_rn(bf16r(ga[i]), gc[i]);
}

int blocks(long n) { return (int)((n + kThreads - 1) / kThreads); }

int grid_for(long n) {   // grid-stride kernels: at most 8 blocks an SM
  const long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 1056 ? (b < 1 ? 1 : b) : 1056);
}

int attn_fwd_smem(int T, int A) {
  return (int)sizeof(float) * (2 * A + T + kPart);
}

int attn_bwd_smem(int T, int H, int A) {
  return (int)sizeof(float) * (H + 2 * (A / kSplit) + 3 * T + 2 * kPart);
}

}  // namespace

// Plain C entry points (loaded with ctypes); pointers, then ints, then the
// stream. Each returns the cudaError_t of its launch (0 on success). The
// attention kernels' shared memory, 4 * (2A + T + kPart) and 4 * (H + A / 2
// + 3T + 2 kPart) bytes, stays within the 48 KB a block takes without opting
// in at the widths ops/limits.py lets through (H, A <= 2,048, multiples of
// 8; T <= 512).
extern "C" int vidcap_teacher_forced_round(const void* src, void* dst, int n,
                                           void* stream) {
  round_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (float*)dst, n);
  return (int)cudaGetLastError();
}

extern "C" int vidcap_teacher_forced_attn_fwd(
    const void* qraw, const void* keys, const void* values, const void* fmask,
    const void* u, const void* emb, const void* rh, void* xh, void* attn,
    int B, int T, int E, int H, int A, int emb_row, void* stream) {
  attn_fwd_kernel<<<dim3(B, kSplit), kAttn, attn_fwd_smem(T, A),
                    (cudaStream_t)stream>>>(
      (const float*)qraw, (const bf16*)keys, (const bf16*)values,
      (const float*)fmask, (const float*)u, (const float*)emb,
      (const float*)rh, (float*)xh, (float*)attn, T, E, H, A, emb_row);
  return (int)cudaGetLastError();
}

extern "C" int vidcap_teacher_forced_lstm_fwd(const void* g, const void* bias,
                                              const void* c, void* c_out,
                                              void* rh_out, void* ho_out,
                                              int B, int H, int ho_row,
                                              void* stream) {
  lstm_fwd_kernel<<<blocks((long)B * H), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)bias, (const float*)c, (float*)c_out,
      (float*)rh_out, (float*)ho_out, B, H, ho_row);
  return (int)cudaGetLastError();
}

extern "C" int vidcap_teacher_forced_logits(void* p, const void* b_out, int N,
                                            int Vp, int vocab, void* stream) {
  const long n4 = (long)N * Vp / 4;
  logits_kernel<<<grid_for(n4), kThreads, 0, (cudaStream_t)stream>>>(
      (float*)p, (const float*)b_out, n4, Vp, vocab);
  return (int)cudaGetLastError();
}

extern "C" int vidcap_teacher_forced_logits_bwd(const void* dl, void* dp,
                                                int N, int Vp, int vocab,
                                                void* stream) {
  const long n4 = (long)N * Vp / 4;
  logits_bwd_kernel<<<grid_for(n4), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dl, (float*)dp, n4, Vp, vocab);
  return (int)cudaGetLastError();
}

extern "C" int vidcap_teacher_forced_lstm_bwd(
    const void* g, const void* bias, const void* c, const void* dhl,
    const void* ga, const void* gc, const void* dc_next, void* dg,
    void* dc_out, int B, int H, int dhl_row, void* stream) {
  lstm_bwd_kernel<<<blocks((long)B * H), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)bias, (const float*)c,
      (const float*)dhl, (const float*)ga, (const float*)gc,
      (const float*)dc_next, (float*)dg, (float*)dc_out, B, H, dhl_row);
  return (int)cudaGetLastError();
}

extern "C" int vidcap_teacher_forced_attn_bwd(
    const void* dxh, const void* keys, const void* values, const void* fmask,
    const void* u, const void* qraw, const void* attn, void* d_emb, void* gc,
    void* dk, void* dv, void* dq, void* pu, int B, int T, int E, int H,
    int A, int emb_row, int first, void* stream) {
  attn_bwd_kernel<<<dim3(B, kSplit), kAttn, attn_bwd_smem(T, H, A),
                    (cudaStream_t)stream>>>(
      (const float*)dxh, (const bf16*)keys, (const bf16*)values,
      (const float*)fmask, (const float*)u, (const float*)qraw,
      (const float*)attn, (float*)d_emb, (float*)gc, (bf16*)dk, (bf16*)dv,
      (float*)dq, (float*)pu, T, E, H, A, emb_row, first);
  return (int)cudaGetLastError();
}

extern "C" int vidcap_teacher_forced_colsum(const void* y, void* out, int yt,
                                            int yb, int L, int B, int N,
                                            int round, void* stream) {
  colsum_kernel<<<(N + 31) / 32, dim3(32, 32), 0, (cudaStream_t)stream>>>(
      (const float*)y, yt, yb, (float*)out, L, B, N, round);
  return (int)cudaGetLastError();
}

extern "C" int vidcap_teacher_forced_wgrad(const void* x, const void* y,
                                           void* out, int xt, int xb, int yt,
                                           int yb, int L, int B, int M,
                                           int N, void* stream) {
  // 64-wide tiles where they give the card's SMs a block each, else 32
  const cudaStream_t st = (cudaStream_t)stream;
  if ((long)((M + 63) / 64) * ((N + 63) / 64) >= 132)
    wgrad_kernel<4><<<dim3((N + 63) / 64, (M + 63) / 64), kThreads, 0, st>>>(
        (const float*)x, xt, xb, (const float*)y, yt, yb, (float*)out, L, B,
        M, N);
  else
    wgrad_kernel<2><<<dim3((N + 31) / 32, (M + 31) / 32), kThreads, 0, st>>>(
        (const float*)x, xt, xb, (const float*)y, yt, yb, (float*)out, L, B,
        M, N);
  return (int)cudaGetLastError();
}

extern "C" int vidcap_teacher_forced_dh0(const void* ga, const void* gc,
                                         void* out, int n, void* stream) {
  dh0_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ga, (const float*)gc, (float*)out, n);
  return (int)cudaGetLastError();
}
