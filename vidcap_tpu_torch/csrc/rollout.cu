// K3 rollout: a whole greedy or Gumbel-max sampled rollout of max_len steps
// as one persistent kernel, for up to 32 rows (one hypothesis per video).
//
// Replaces vidcap_tpu/ops/pallas_decoder.py::pallas_rollout
// (_rollout_kernel), which runs the rollout as one launch whose sequential
// grid of max_len steps keeps h, c, the token and the finished flags in VMEM
// and, with resident_wout=True, W_out too.
//
// What bounds it on the H100: at msvd_greedy width (B=32, E=H=A=512, T=26,
// Vp=12,032, 30 steps) the products are 2*32*30*(512*512 + 1536*2048 +
// 512*12032 + 2*26*512) = 18.4 GFLOP (~19 us at 989 TFLOP/s bf16), against
// ~22 MB of weights, keys/values and gathered rows counted once (~6.5 us at
// 3.35 TB/s). Each step is a chain of three dependent stages (attention ->
// gates -> projection and pick) of ~0.6 GFLOP and ~20 MB of weights, so what
// bounds a step is latency: the weights' trip from memory and the hand-offs
// between the stages.
//
// Design: one cooperative launch of one block per SM (132 on the H100); the
// blocks stay resident for the whole rollout and meet at grid barriers.
//  - Weights stay in shared memory. A block holds a contiguous slice of
//    W_out's columns (Vp/132 rounded up to 8: 96 at Vp=12,032, 128 at
//    16,000), four hidden columns of all four gates of Wg (16 gate columns,
//    so the LSTM update runs in the block) and a slice of Wq's columns. Each
//    slice is kept as 8-column panels, k rows of 16 bytes, so that ldmatrix
//    reads 8 rows of a panel conflict-free. W_out and Wq come in once by TMA
//    (boxes of 8 columns x up to 256 rows); Wg by 8-byte loads, because a
//    block's 4 columns of a gate are 8 bytes and TMA moves at least 16. In
//    the resident mode the weights are read from device memory once per
//    rollout: (H*Vp + (E+2H)*4H + H*A)*2 bytes, 19.1 MB at msvd_greedy
//    width. In the streamed mode (resident=0) W_out is not kept: each block
//    streams its slice from L2 every step through a 3-stage TMA ring (64
//    deep x up to 128 columns a stage); Wg and Wq stay resident.
//  - The products run on mma.sync m16n8k16 (bf16, f32 accumulate): with 32
//    rows an M of 16 leaves no tile empty, where wgmma's M of 64 would be
//    half empty, and at ~0.6 GFLOP a step the tensor-core rate is not the
//    limit. Each 32 of depth is summed by the tensor cores from zero and
//    added to an f32 register sum (vidcap::promote), as in K1.
//  - c (the block's 4 hidden columns), the token and the finished flags
//    never leave shared memory. Blocks hand each other bf16 [emb; ctx]
//    (xh), bf16(h') (h16), q, the pick partials and the pick keys through
//    global buffers, read with ld_cg after a barrier (hopper.cuh).
// A step, three grid barriers:
//  (a) block r for row r (r < B): the token of step t-1 from the row's pick
//      key (below; PAD once finished), its embedding row, and
//      attention_kernel's arithmetic (recurrent.cuh) for one row; writes
//      bf16([emb; ctx]) into xh. At the same time block B + r merges row
//      r's per-block partials of step t-1 in block order (lse, and the pick
//      with ties to the smallest column) and writes token/logp/mask of step
//      t-1. Both blocks keep the row's finished flag.
//  (b) gates, every block with hidden columns: [xh, bf16(h)] . Wg over its
//      16 gate columns, the depth split over the 8 warps (xh from L2 into
//      registers, bf16(h) from shared memory), summed in warp order, then
//      the LSTM (GateEpilogue's arithmetic) into c and bf16(h') -> h16.
//  (c) projection, every block: h16 -> shared memory; its W_out slice's
//      logits = f32(bf16(bf16(acc) + bf16(b))), clean = logits/temperature
//      (columns >= vocab at -1e30), noisy = clean - log(-log(uni)) when
//      sampling (the counter hash of pallas_decoder.py:216-230), and per row
//      the max and exp-sum of clean and the best (noisy, clean, column):
//      one partial per (row, block), and the best as an atomicMax on the
//      row's pick key (order-free, so runs repeat), which gives the token
//      one load away. In the same pass bf16(h') . Wq gives the next q.
// Step 0's q comes from a prologue; the last step's merge runs after the
// last barrier. 1 + 3 * max_len barriers in all.
// What holds it back (PERF.md, scripts/torch_kernel_ablate.py rollout): a
// step is ~18 us on the H100 against ~0.6 us of bound, spent in four
// dependent phases of one or two L2 round trips and a few microseconds of
// arithmetic each (the attention's full-accuracy tanhf the largest), and
// three grid barriers of ~1 us.
// Built without --use_fast_math, so logf/expf/tanhf are the accurate ones.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "hopper.cuh"

using bf16 = __nv_bfloat16;
using namespace vidcap;

namespace {

constexpr int PAD = 0, BOS = 1, EOS = 2;   // data/vocab.py
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kRows = 32;        // rows of one launch: two m16 tiles
constexpr int kHid = 4;          // hidden columns of a block: 16 gate columns
constexpr int kPassCols = 128;   // W_out columns of one pass: 16 panels
constexpr int kMaxNt = 4;        // n8 tiles a warp holds in one pass
constexpr int kStages = 3;       // streamed W_out ring
constexpr int kGateBatch = 4;    // 32-deep chunks of xh a warp loads at once
constexpr int kPanelRow = 16;    // bytes of one k row of an 8-column panel
constexpr int kRedBytes = kWarps * kRows * 4 * kHid * 4;   // gate partials
constexpr int kMaxGrid = 256;    // blocks of a launch: partials a row
constexpr int kValFrames = 32;   // frames of values loaded ahead

struct Dims {
  int B, T, E, H, A, Vp, vocab, L, row0;
  int nc;          // W_out columns a block holds (multiple of 8)
  int qc;          // Wq columns a block holds (multiple of 8)
  int kd;          // depth of a streamed ring stage / W_out TMA box rows
  int box_rows;    // rows of a resident TMA box (divides H, <= 256)
  int resident, sample;
  float inv_temp;
};

// Byte offsets of the shared-memory regions (each 128-byte aligned) from
// the 1024-aligned base.
struct Smem {
  uint32_t wout, wg, wq, bout, r, c, part, p, bar, total;
};

__host__ __device__ inline uint32_t up128(uint32_t x) {
  return (x + 127u) & ~127u;
}

// Mirrored by vidcap_tpu_torch/ops/rollout.py::rollout_smem_bytes.
inline Smem smem_layout(const Dims& d) {
  const uint32_t D = d.E + 2 * d.H;
  const uint32_t pass = d.nc < kPassCols ? d.nc : kPassCols;
  const uint32_t wout = d.resident ? (uint32_t)d.nc * d.H * 2
                                   : (uint32_t)kStages * pass * d.kd * 2;
  const uint32_t rbytes = (uint32_t)kRows * (d.H + 8) * 2;
  Smem s;
  s.wout = 0;
  s.wg = s.wout + up128(wout);
  s.wq = s.wg + up128(2 * D * kPanelRow);
  s.bout = s.wq + up128((uint32_t)d.qc * d.H * 2);
  s.r = s.bout + up128((uint32_t)d.nc * 4);
  s.c = s.r + up128(rbytes > (uint32_t)kRedBytes ? rbytes : kRedBytes);
  s.part = s.c + up128(kRows * kHid * 4);
  s.p = s.part + up128(4 * kRows * 5 * 4);
  s.bar = s.p + up128(d.T * 4);
  s.total = s.bar + up128(8 * (1 + kStages)) + 1024;   // + base alignment
  return s;
}

// ---- mma.sync and ldmatrix -------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The B fragments of two k16 steps of an 8-column panel (rows of 16 bytes;
// lane l gives the address of row l of the 32): {b0, b1} of the first step,
// {b0, b1} of the second.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d = a . b (+ d unless `first`): A 16x16 row-major, B 16x8, f32 accumulate.
// Fragments (g = lane / 4, c = lane % 4): a = rows g, g+8 x depth 2c, 2c+8;
// b0, b1 = depth 2c, 2c+8 x column g; d = rows g, g+8 x columns 2c, 2c+1.
// Not volatile: a pure function of registers, which the compiler may
// schedule between the (volatile, ordered) shared-memory loads, so that the
// products of several tiles and chunks are in flight at once.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1, bool first) {
  const float z = 0.f;
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(first ? z : d[0]), "f"(first ? z : d[1]), "f"(first ? z : d[2]),
        "f"(first ? z : d[3]));
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

// The pick (noisy desc, column asc) as one unsigned key whose largest value
// is the pick, for atomicMax: the noisy value's bits made order-preserving
// (-0 taken as +0, as the float comparison does), then the column
// reversed. atomicMax is order-free, so the pick is the same in every run.
__device__ __forceinline__ unsigned long long pick_key(float noisy, int col) {
  const unsigned u = __float_as_uint(noisy + 0.f);
  const unsigned o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)o << 32) | (0xFFFFFFFFu - (unsigned)col);
}

// A running pick over columns: max m and exp-sum s of clean (s relative to
// m), and the best (noisy desc, column asc) with its clean value.
struct Pick {
  float m, s, bv, bc;
  int bi;
  __device__ void init() {
    m = -INFINITY;
    s = 0.f;
    bv = -INFINITY;
    bc = 0.f;
    bi = INT_MAX;
  }
  // fold in another partial (the order of folds is fixed: runs repeat)
  __device__ void merge(float om, float os, float obv, float obc, int obi) {
    const float mn = fmaxf(m, om);
    if (mn > -INFINITY)
      s = (m > -INFINITY ? s * expf(m - mn) : 0.f) +
          (om > -INFINITY ? os * expf(om - mn) : 0.f);
    m = mn;
    if (before(obv, obi, bv, bi)) {
      bv = obv;
      bi = obi;
      bc = obc;
    }
  }
  // fold in with the lane `o` away (xor)
  __device__ void merge_lane(int o) {
    const float om = __shfl_xor_sync(0xffffffffu, m, o);
    const float os = __shfl_xor_sync(0xffffffffu, s, o);
    const float obv = __shfl_xor_sync(0xffffffffu, bv, o);
    const float obc = __shfl_xor_sync(0xffffffffu, bc, o);
    const int obi = __shfl_xor_sync(0xffffffffu, bi, o);
    merge(om, os, obv, obc, obi);
  }
};

struct Params {
  // inputs (read-only for the whole launch)
  const bf16 *emb, *keys, *values, *wq, *wg, *w_out;
  const float *fmask, *h0, *c0, *u, *bg, *b_out;
  // the sampling seed: the low word of a device int64, written before the
  // launch (a captured launch reads each replay's own); unread when greedy
  const unsigned* seed;
  // handed between blocks (written and read inside the launch)
  bf16* xh;    // [B, E+H]: bf16 [emb; ctx]
  bf16* h16;   // [B, H]: bf16(h')
  bf16* q;     // [B, A]
  float *pm, *ps, *pn, *pc;   // [B, grid] partials: max, exp-sum, best
  int* pi;                    //   noisy, its clean value, its column
  // [2, B] per row, the step's pick as one atomicMax key (pick_key); the
  // buffer of step t is t & 1
  unsigned long long* pick;
  // outputs [B, L]
  int* out_tok;
  float *out_logp, *out_mask;
  Dims d;
  Smem s;
};

// 8-column weight panels in shared memory: panel j's row k (absolute
// depth) at base + j * stride + (k - k_off) * 16.
struct Panels {
  uint32_t base, stride;
  int n, k_off;
};

// acc[i] += the products of R's rows (the warp's m16 tile: `a_addr` is the
// lane's ldmatrix address at depth 0) and tile ng + 4i of a pass, over depth
// k0..k0+kd. The pass's tiles are p0's panels, then p1's (at most 16 in
// all). Per 32 of depth every load is issued first, then the products.
__device__ __forceinline__ void chunk_product(float (&acc)[kMaxNt][4],
                                              uint32_t a_addr, int k0, int kd,
                                              const Panels& p0,
                                              const Panels& p1, int ng) {
  const int lane = threadIdx.x % 32, n = p0.n + p1.n;
#pragma unroll 2
  for (int k = k0; k < k0 + kd; k += 32) {
    uint32_t a0[4], a1[4], b[kMaxNt][4];
    ldsm_x4(a0, a_addr + k * 2);
    ldsm_x4(a1, a_addr + (k + 16) * 2);
#pragma unroll
    for (int i = 0; i < kMaxNt; ++i) {
      const int j = ng + 4 * i;
      if (j >= n) continue;
      const Panels& p = j < p0.n ? p0 : p1;
      ldsm_x4_t(b[i], p.base + (j < p0.n ? j : j - p0.n) * p.stride +
                          (k - p.k_off + lane) * kPanelRow);
    }
    float part[kMaxNt][4];
#pragma unroll
    for (int i = 0; i < kMaxNt; ++i)
      if (ng + 4 * i < n) mma16816(part[i], a0, b[i][0], b[i][1], true);
#pragma unroll
    for (int i = 0; i < kMaxNt; ++i)
      if (ng + 4 * i < n) mma16816(part[i], a1, b[i][2], b[i][3], false);
#pragma unroll
    for (int i = 0; i < kMaxNt; ++i)
      if (ng + 4 * i < n) promote(acc[i], part[i]);
  }
}

// Where row `row` of Wg's depth (row < E + H: the xh part) sits in the gate
// panels. The gate GEMM gives thread (g, c) of a warp depth 8c..8c+7 of a
// 32-deep chunk of xh in one 16-byte load; those eight are the depths the
// mma fragments expect at 2c, 2c+1, 2c+8, 2c+9 of the chunk's first k16
// step (8c..8c+3) and of its second (8c+4..8c+7). Wg's rows are laid out
// in that order, so every product of the chunk is the same; only the
// tensor cores' grouping of the 32 products into two 16-deep sums differs.
__device__ __forceinline__ int gate_row(int row) {
  const int p = row % 32, c = p / 8, h2 = (p / 4) % 2, hi = (p / 2) % 2;
  return row - p + 16 * h2 + 2 * c + 8 * hi + p % 2;
}

// The block's state and shared memory.
struct Block {
  const Params& p;
  unsigned char* base;
  int grid, lane, warp, mt, ng;
  int col0, ncols;   // W_out columns [col0, col0 + ncols)
  int q0, nq;        // Wq columns [q0, q0 + nq)
  int j0;            // hidden columns j0..j0+3, or -1
  unsigned seed;     // the sampling seed (0 when greedy)
  unsigned ring_n;   // streamed ring stages consumed so far
  uint64_t* bar;     // [0] weights loaded, [1..] ring stages full

  __device__ uint32_t r_addr(int mrow_tile) const {   // lane's ldmatrix A row
    return smem_u32(base + p.s.r) +
           ((mrow_tile * 16 + (lane & 15)) * (p.d.H + 8) + (lane >> 4) * 8) * 2;
  }
  __device__ bf16* r_row(int row) const {
    return reinterpret_cast<bf16*>(base + p.s.r) + (size_t)row * (p.d.H + 8);
  }
};

// Prologue: barriers, the weights' loads, c0, bf16(h0) into R.
__device__ void prologue(Block& k, const CUtensorMap* tw,
                         const CUtensorMap* tq) {
  const Dims& d = k.p.d;
  const int tid = threadIdx.x, D = d.E + 2 * d.H;
  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(&k.bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    const int np = k.ncols / 8, nqp = k.nq / 8;
    const uint32_t bytes =
        (d.resident ? np : 0) * d.H * kPanelRow + nqp * d.H * kPanelRow;
    mbar_expect_tx(&k.bar[0], bytes);   // 0 bytes: the arrival completes it
    for (int j = 0; j < nqp; ++j)
      for (int r = 0; r < d.H; r += d.box_rows)
        tma_load(k.base + k.p.s.wq + (j * d.H + r) * kPanelRow, tq,
                 k.q0 + 8 * j, r, &k.bar[0]);
    if (d.resident)
      for (int j = 0; j < np; ++j)
        for (int r = 0; r < d.H; r += d.box_rows)
          tma_load(k.base + k.p.s.wout + (j * d.H + r) * kPanelRow, tw,
                   k.col0 + 8 * j, r, &k.bar[0]);
  }
  if (k.j0 >= 0) {
    // Wg's 4 columns of each gate, 8 bytes a load, into two panels:
    // [i | f] and [g | o] (columns 4g.. of panel g / 2 hold gate g). The
    // rows of xh's depth (< E + H) go to the panel rows gate_row() gives,
    // the order in which the gate GEMM takes xh.
    uint2* wg_s = reinterpret_cast<uint2*>(k.base + k.p.s.wg);
    for (int i = tid; i < D * 4; i += kThreads) {
      const int row = i / 4, g = i % 4;
      const int at = row < d.E + d.H ? gate_row(row) : row;
      wg_s[((g / 2) * D + at) * 2 + g % 2] = __ldg(reinterpret_cast<const uint2*>(
          k.p.wg + (size_t)row * 4 * d.H + g * d.H + k.j0));
    }
    float* c_s = reinterpret_cast<float*>(k.base + k.p.s.c);
    for (int i = tid; i < kRows * kHid; i += kThreads) {
      const int row = i / kHid, j = i % kHid;
      c_s[i] = row < d.B ? k.p.c0[(size_t)row * d.H + k.j0 + j] : 0.f;
    }
  }
  float* bout = reinterpret_cast<float*>(k.base + k.p.s.bout);
  for (int i = tid; i < k.ncols; i += kThreads) bout[i] = k.p.b_out[k.col0 + i];
  if (tid == 0 && (int)blockIdx.x < d.B) {   // both steps' pick keys of the row
    k.p.pick[blockIdx.x] = 0ull;
    k.p.pick[d.B + blockIdx.x] = 0ull;
  }
  const int H8 = d.H / 8;
  for (int i = tid; i < kRows * H8; i += kThreads) {
    const int row = i / H8, k8 = i % H8;
    *reinterpret_cast<uint4*>(k.r_row(row) + 8 * k8) =
        row < d.B ? bf16x8(k.p.h0 + (size_t)row * d.H + 8 * k8)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  mbar_wait(&k.bar[0], 0);
}

// q = bf16(acc) of the pass's tiles p0.n.. (Wq panels from `first`) into
// q [B, A].
__device__ void q_epilogue(const Block& k, const float (&acc)[kMaxNt][4],
                           int np, int nq, int first) {
  const Dims& d = k.p.d;
  const int g = k.lane / 4, c = k.lane % 4;
#pragma unroll
  for (int i = 0; i < kMaxNt; ++i) {
    const int j = k.ng + 4 * i - np;
    if (j < 0 || j >= nq) continue;
    const int col = k.q0 + (first + j) * 8 + 2 * c;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = k.mt * 16 + g + 8 * hh;
      if (row < d.B)
        *reinterpret_cast<unsigned*>(k.p.q + (size_t)row * d.A + col) =
            pack2(acc[i][2 * hh], acc[i][2 * hh + 1]);
    }
  }
}

// The block's Wq panels from `first` on, 16 a pass: q = bf16(R . Wq).
__device__ void q_pass(Block& k, int first) {
  const Dims& d = k.p.d;
  const uint32_t wq = smem_u32(k.base + k.p.s.wq);
  for (int p0 = first; p0 < k.nq / 8; p0 += kPassCols / 8) {
    const int nq = min(k.nq / 8 - p0, kPassCols / 8);
    float acc[kMaxNt][4] = {};
    chunk_product(acc, k.r_addr(k.mt), 0, d.H, Panels{0, 0, 0, 0},
                  Panels{wq + p0 * d.H * kPanelRow, (uint32_t)d.H * kPanelRow,
                         nq, 0},
                  k.ng);
    q_epilogue(k, acc, 0, nq, p0);
  }
}

// Fold a pass's products into the thread's two rows' picks. Sampling is a
// template argument: as a run-time select the compiler computes the noise
// (two logf a column) in greedy rollouts too.
template <bool kSample>
__device__ void pick_epilogue(const Block& k, const float (&acc)[kMaxNt][4],
                              int pass_col0, int np, unsigned step,
                              Pick (&pk)[2]) {
  const Dims& d = k.p.d;
  const int g = k.lane / 4, c = k.lane % 4;
  const float* bout = reinterpret_cast<const float*>(k.base + k.p.s.bout);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = k.mt * 16 + g + 8 * hh;
    float x[kMaxNt][2];
    float mt = -INFINITY;
#pragma unroll
    for (int i = 0; i < kMaxNt; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[i][e] = -INFINITY;
        if (k.ng + 4 * i >= np) continue;
        const int col = pass_col0 + (k.ng + 4 * i) * 8 + 2 * c + e;
        const float v = bf16r(bf16r(acc[i][2 * hh + e]) + bf16r(bout[col - k.col0]));
        const float cl = col < d.vocab ? v * d.inv_temp : kNeg;
        const float nz =
            kSample ? gumbel(cl, d.row0 + row, col, k.seed, step) : cl;
        x[i][e] = cl;
        mt = fmaxf(mt, cl);
        if (before(nz, col, pk[hh].bv, pk[hh].bi)) {
          pk[hh].bv = nz;
          pk[hh].bi = col;
          pk[hh].bc = cl;
        }
      }
    if (mt > -INFINITY) {
      const float mn = fmaxf(pk[hh].m, mt);
      float s = pk[hh].m > -INFINITY ? pk[hh].s * expf(pk[hh].m - mn) : 0.f;
#pragma unroll
      for (int i = 0; i < kMaxNt; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (x[i][e] > -INFINITY) s += expf(x[i][e] - mn);
      pk[hh].s = s;
      pk[hh].m = mn;
    }
  }
}

// (c) the projection and pick of step `step` over the block's W_out
// columns, one partial per (row, block); with `with_q`, the next step's q
// too: the Wq panels ride in the last W_out pass where it has room (they
// share its A operand), the rest in passes of their own.
__device__ void project(Block& k, const CUtensorMap* tw, unsigned step,
                        bool with_q) {
  const Dims& d = k.p.d;
  Pick pk[2];
  pk[0].init();
  pk[1].init();
  const uint32_t a_addr = k.r_addr(k.mt);
  const uint32_t wq = smem_u32(k.base + k.p.s.wq), hrow = d.H * kPanelRow;
  const int nqp = with_q ? k.nq / 8 : 0;
  int q_done = 0;
  for (int c0 = 0; c0 < k.ncols; c0 += kPassCols) {
    const int np = min(k.ncols - c0, kPassCols) / 8;
    const int nq = c0 + kPassCols >= k.ncols ? min(nqp, kPassCols / 8 - np) : 0;
    const Panels q{wq, hrow, nq, 0};
    float acc[kMaxNt][4] = {};
    if (d.resident) {
      chunk_product(acc, a_addr, 0, d.H,
                    Panels{smem_u32(k.base + k.p.s.wout) + c0 / 8 * hrow, hrow,
                           np, 0},
                    q, k.ng);
    } else {   // the block's slice from L2, kd deep a stage
      const int nk = d.H / d.kd;
      const uint32_t stage = (uint32_t)np * d.kd * kPanelRow;
      auto issue = [&](int ci) {
        const unsigned n = k.ring_n + ci, slot = n % kStages;
        mbar_expect_tx(&k.bar[1 + slot], stage);
        for (int j = 0; j < np; ++j)
          tma_load(k.base + k.p.s.wout + slot * stage + j * d.kd * kPanelRow,
                   tw, k.col0 + c0 + 8 * j, ci * d.kd, &k.bar[1 + slot]);
      };
      if (threadIdx.x == 0)
        for (int ci = 0; ci < kStages - 1 && ci < nk; ++ci) issue(ci);
      for (int ci = 0; ci < nk; ++ci) {
        // the slot refilled held stage ci - 1, which every warp has left
        if (threadIdx.x == 0 && ci + kStages - 1 < nk) issue(ci + kStages - 1);
        const unsigned n = k.ring_n + ci;
        mbar_wait(&k.bar[1 + n % kStages], (n / kStages) & 1);
        chunk_product(acc, a_addr, ci * d.kd, d.kd,
                      Panels{smem_u32(k.base + k.p.s.wout) +
                                 (n % kStages) * stage,
                             (uint32_t)d.kd * kPanelRow, np, ci * d.kd},
                      q, k.ng);
        __syncthreads();
      }
      k.ring_n += nk;
    }
    if (d.sample)
      pick_epilogue<true>(k, acc, k.col0 + c0, np, step, pk);
    else
      pick_epilogue<false>(k, acc, k.col0 + c0, np, step, pk);
    q_epilogue(k, acc, np, nq, 0);
    q_done = nq;
  }
  if (q_done < nqp) q_pass(k, q_done);
  // the quad's four lanes share a row; then the four column groups of the
  // row's m16 tile, in order, into one partial per row
  float* part = reinterpret_cast<float*>(k.base + k.p.s.part);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    pk[hh].merge_lane(1);
    pk[hh].merge_lane(2);
    if (k.lane % 4 == 0) {
      const int row = k.mt * 16 + k.lane / 4 + 8 * hh;
      float* o = part + (k.ng * kRows + row) * 5;
      o[0] = pk[hh].m;
      o[1] = pk[hh].s;
      o[2] = pk[hh].bv;
      o[3] = pk[hh].bc;
      reinterpret_cast<int*>(o)[4] = pk[hh].bi;
    }
  }
  __syncthreads();
  const int row = threadIdx.x;
  if (row < d.B) {
    Pick r;
    r.init();
    for (int ng = 0; ng < 4; ++ng) {
      const float* o = part + (ng * kRows + row) * 5;
      r.merge(o[0], o[1], o[2], o[3], reinterpret_cast<const int*>(o)[4]);
    }
    const size_t o = (size_t)row * k.grid + blockIdx.x;
    k.p.pm[o] = r.m;
    k.p.ps[o] = r.s;
    k.p.pn[o] = r.bv;
    k.p.pc[o] = r.bc;
    k.p.pi[o] = r.bi;
    if (r.bi != INT_MAX)
      atomicMax(k.p.pick + (step & 1) * d.B + row, pick_key(r.bv, r.bi));
  }
}

// h16 (bf16(h') of every row, written by the gate phase) into R.
__device__ void load_h(Block& k) {
  const Dims& d = k.p.d;
  const int H8 = d.H / 8, n = kRows * H8;
  for (int i0 = threadIdx.x; i0 < n; i0 += 8 * kThreads) {
    uint4 v[8];   // eight independent loads in flight, then the stores
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * kThreads, row = i / H8;
      v[j] = make_uint4(0u, 0u, 0u, 0u);
      if (i < n && row < d.B)
        v[j] = ld_cg(reinterpret_cast<const uint4*>(k.p.h16 + (size_t)i * 8));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * kThreads;
      if (i < n)
        *reinterpret_cast<uint4*>(k.r_row(i / H8) + 8 * (i % H8)) = v[j];
    }
  }
  __syncthreads();
}

// (a) on block B + row: merge row `row`'s partials of step t - 1 (t > 0)
// in block order into its lse and pick, and write token/logp/mask of step
// t - 1. The pick is the one the row's attention block read from the
// atomic key; each of the two blocks keeps the row's finished flag. One
// warp, every load of a lane in flight at once.
__device__ void merge_step(Block& k, int row, int t, int* fin_s) {
  const Dims& d = k.p.d;
  if (k.warp != 0) return;
  const size_t base = (size_t)row * k.grid;
  float vm[kMaxGrid / 32], vs[kMaxGrid / 32], vn[kMaxGrid / 32],
      vc[kMaxGrid / 32];
  int vi[kMaxGrid / 32];
#pragma unroll
  for (int i = 0; i < kMaxGrid / 32; ++i) {
    const int j = k.lane + 32 * i;
    vm[i] = vn[i] = -INFINITY;
    vs[i] = vc[i] = 0.f;
    vi[i] = INT_MAX;
    if (j < k.grid) {
      vm[i] = ld_cg(k.p.pm + base + j);
      vs[i] = ld_cg(k.p.ps + base + j);
      vn[i] = ld_cg(k.p.pn + base + j);
      vc[i] = ld_cg(k.p.pc + base + j);
      vi[i] = ld_cg(k.p.pi + base + j);
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kMaxGrid / 32; ++i) m = fmaxf(m, vm[i]);
  m = warp_max(m);
  float s = 0.f, bv = -INFINITY, bc = 0.f;
  int bi = INT_MAX;
#pragma unroll
  for (int i = 0; i < kMaxGrid / 32; ++i) {
    if (vm[i] > -INFINITY) s += vs[i] * expf(vm[i] - m);
    if (before(vn[i], vi[i], bv, bi)) {
      bv = vn[i];
      bi = vi[i];
      bc = vc[i];
    }
  }
  s = warp_sum(s);
  const float lse = m + logf(fmaxf(s, 1e-30f));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    const float oc = __shfl_xor_sync(0xffffffffu, bc, o);
    if (before(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
      bc = oc;
    }
  }
  if (k.lane == 0) {
    const bool done = *fin_s != 0;
    const int tk = done ? PAD : bi;
    const size_t o = (size_t)row * d.L + t - 1;
    k.p.out_tok[o] = tk;
    k.p.out_logp[o] = done ? 0.f : bc - lse;
    k.p.out_mask[o] = done ? 0.f : 1.f;
    *fin_s = (done || tk == EOS) ? 1 : 0;
  }
}

// (a) on block `row`: the token of step t - 1 (the row's atomic pick key,
// PAD once finished), its embedding row and the attention
// (attention_kernel's arithmetic with K = 1), into xh[row]. q, bf16(u) and
// the keys of the warp's first four frames are loaded before the key, the
// values after it, so that their trips from L2 overlap. Indices are clamped
// into the row: a load is never out of bounds, whatever the compiler does
// with the guard of its use.
__device__ void attend(Block& k, int row, int t_step, int* tok_s, int* fin_s) {
  const Dims& d = k.p.d;
  const int tid = threadIdx.x, KG = d.E + d.H, A8 = d.A / 8, T = d.T;
  const uint4* q4 = reinterpret_cast<const uint4*>(k.p.q + (size_t)row * d.A);
  const uint4* k4 =
      reinterpret_cast<const uint4*>(k.p.keys + (size_t)row * T * d.A);
  // the lane's eight-column vectors a8 = lane, lane + 32 (A <= 512) of q
  // and bf16(u), as bf16; the keys of frames t0, t0 + 8, t0 + 16, t0 + 24
  uint4 qv[2], uv[2], kv[4][2];
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int a8 = min(k.lane + 32 * v, A8 - 1);
    qv[v] = ld_cg(q4 + a8);
    uv[v] = bf16x8(k.p.u + 8 * a8);
  }
  auto load_keys = [&](int t0) {
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int v = 0; v < 2; ++v)
        kv[f][v] = __ldg(k4 + min(t0 + f * kWarps, T - 1) * A8 +
                         min(k.lane + 32 * v, A8 - 1));
  };
  load_keys(k.warp);
  if (t_step > 0 && tid == 0) {   // the token of step t - 1
    const unsigned long long key =
        ld_cg(k.p.pick + ((t_step - 1) & 1) * d.B + row);
    const bool done = *fin_s != 0;
    const int tk = done ? PAD : (int)(0xFFFFFFFFu - (unsigned)key);
    *fin_s = (done || tk == EOS) ? 1 : 0;
    *tok_s = tk;
    k.p.pick[(t_step & 1) * d.B + row] = 0ull;   // this step's key starts at 0
  }
  __syncthreads();
  const int tok = *tok_s;
  bf16* x = k.p.xh + (size_t)row * KG;
  // the embedding row's first 256 vectors, loaded now and stored last
  const uint4* e4 = reinterpret_cast<const uint4*>(k.p.emb + (size_t)tok * d.E);
  const uint4 ev = __ldg(e4 + min(tid, d.E / 8 - 1));
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(
      k.p.values + (size_t)row * T * d.H);
  const int d2 = tid;   // the thread's columns 2 d2, 2 d2 + 1 (H <= 512)
  __nv_bfloat162 vv[kValFrames];
#pragma unroll
  for (int t = 0; t < kValFrames; ++t)
    vv[t] = __ldg(v2 + min(t, T - 1) * (d.H / 2) + min(d2, d.H / 2 - 1));
  float* p_s = reinterpret_cast<float*>(k.base + k.p.s.p);
  // scores[t] = sum_a bf16(tanh(bf16(keys + q))) * bf16(u): a warp per
  // frame, four frames' keys in flight at once
  for (int t0 = k.warp; t0 < T; t0 += 4 * kWarps) {
    if (t0 != k.warp) load_keys(t0);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int t = t0 + f * kWarps;
      if (t >= T) break;
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        if (k.lane + 32 * v >= A8) break;
        float kf[8], qf[8], uf[8];
        unpack8(kv[f][v], kf);
        unpack8(qv[v], qf);
        unpack8(uv[v], uf);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s += bf16r(tanhf(bf16r(kf[j] + qf[j]))) * uf[j];
      }
      s = warp_sum(s);
      if (k.lane == 0) p_s[t] = k.p.fmask[(size_t)row * T + t] > 0.f ? s : kNeg;
    }
  }
  __syncthreads();
  // f32 softmax over T (all frames masked -> uniform), bf16-rounded
  if (k.warp == 0) {
    float mx = -INFINITY;
    for (int t = k.lane; t < T; t += 32) mx = fmaxf(mx, p_s[t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = k.lane; t < T; t += 32) sum += expf(p_s[t] - mx);
    sum = warp_sum(sum);
    __syncwarp();
    for (int t = k.lane; t < T; t += 32) p_s[t] = bf16r(expf(p_s[t] - mx) / sum);
  }
  __syncthreads();
  // ctx[d] = sum_t attn[t] * values[t, d] in f32, two columns a thread
  if (d2 < d.H / 2) {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int t = 0; t < kValFrames; ++t)
      if (t < T) {
        const float2 v = __bfloat1622float2(vv[t]);
        a0 += p_s[t] * v.x;
        a1 += p_s[t] * v.y;
      }
    for (int t = kValFrames; t < T; ++t) {
      const float2 v = __bfloat1622float2(__ldg(v2 + t * (d.H / 2) + d2));
      a0 += p_s[t] * v.x;
      a1 += p_s[t] * v.y;
    }
    *reinterpret_cast<unsigned*>(x + d.E + 2 * d2) = pack2(a0, a1);
  }
  if (tid < d.E / 8) reinterpret_cast<uint4*>(x)[tid] = ev;
  for (int v = tid + kThreads; v < d.E / 8; v += kThreads)
    reinterpret_cast<uint4*>(x)[v] = __ldg(e4 + v);
}

// (b) the gate GEMM of the block's 16 gate columns and the LSTM update.
__device__ void gates(Block& k) {
  const Dims& d = k.p.d;
  const int KG = d.E + d.H, n_ch = (KG + d.H) / 32;
  const int g = k.lane / 4, c = k.lane % 4, D = KG + d.H;
  const uint32_t wg = smem_u32(k.base + k.p.s.wg);
  float acc[2][2][4] = {};   // [m16 tile][n8 panel]
  // 32-deep chunks w, w + 8, ...: xh's from L2 into registers, a batch of
  // 16-byte loads in flight at once (thread (g, c) takes depth 8c..8c+7 of
  // rows g and g + 8, which gate_row() matches to the fragments' depth
  // order); bf16(h)'s from R by ldmatrix
  for (int ch0 = k.warp; ch0 < n_ch; ch0 += kWarps * kGateBatch) {
    uint4 x[kGateBatch][2][2];   // [chunk][m16 tile][row g, g + 8]
#pragma unroll
    for (int b = 0; b < kGateBatch; ++b) {
      const int kc = (ch0 + b * kWarps) * 32;
      if (kc >= KG) continue;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r8 = 0; r8 < 2; ++r8) {
          const int row = mt * 16 + g + 8 * r8;
          x[b][mt][r8] = make_uint4(0u, 0u, 0u, 0u);
          if (row < d.B)
            x[b][mt][r8] = ld_cg(reinterpret_cast<const uint4*>(
                k.p.xh + (size_t)row * KG + kc + 8 * c));
        }
    }
#pragma unroll
    for (int b = 0; b < kGateBatch; ++b) {
      const int kc = (ch0 + b * kWarps) * 32;
      if (kc >= D) continue;
      uint32_t a[2][2][4], bf[2][4];   // [k16][m16 tile], [n8 panel]
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (kc < KG) {
          const uint4& lo = x[b][mt][0];
          const uint4& hi = x[b][mt][1];
          a[0][mt][0] = lo.x;
          a[0][mt][1] = hi.x;
          a[0][mt][2] = lo.y;
          a[0][mt][3] = hi.y;
          a[1][mt][0] = lo.z;
          a[1][mt][1] = hi.z;
          a[1][mt][2] = lo.w;
          a[1][mt][3] = hi.w;
        } else {
          ldsm_x4(a[0][mt], k.r_addr(mt) + (kc - KG) * 2);
          ldsm_x4(a[1][mt], k.r_addr(mt) + (kc + 16 - KG) * 2);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        ldsm_x4_t(bf[nt], wg + (nt * D + kc + k.lane) * kPanelRow);
      float part[2][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma16816(part[mt][nt], a[0][mt], bf[nt][0], bf[nt][1], true);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma16816(part[mt][nt], a[1][mt], bf[nt][2], bf[nt][3], false);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) promote(acc[mt][nt], part[mt][nt]);
    }
  }
  __syncthreads();   // R is read no more this step: it takes the partials
  float* red = reinterpret_cast<float*>(k.base + k.p.s.r);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int row = mt * 16 + g + 8 * (f >> 1);
        red[(k.warp * kRows + row) * 16 + nt * 8 + 2 * c + (f & 1)] =
            acc[mt][nt][f];
      }
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < kRows * kHid) {
    const int row = tid / kHid, j = tid % kHid;
    if (row < d.B) {
      float gs[4] = {0.f, 0.f, 0.f, 0.f};   // i, f, g, o in warp order
      for (int w = 0; w < kWarps; ++w)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          gs[q] += red[(w * kRows + row) * 16 + q * 4 + j];
      const int jj = k.j0 + j;
      const float gi = gs[0] + k.p.bg[jj], gf = gs[1] + k.p.bg[d.H + jj];
      const float gg = gs[2] + k.p.bg[2 * d.H + jj];
      const float go = gs[3] + k.p.bg[3 * d.H + jj];
      float* c_s = reinterpret_cast<float*>(k.base + k.p.s.c);
      const float cn = sigmoidf(gf + 1.f) * c_s[tid] + sigmoidf(gi) * tanhf(gg);
      c_s[tid] = cn;
      k.p.h16[(size_t)row * d.H + jj] =
          __float2bfloat16_rn(sigmoidf(go) * tanhf(cn));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
rollout_kernel(const __grid_constant__ Params p,
               const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap tq) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int tok_s, fin_s;
  const Dims& d = p.d;
  Block k{p, smem_aligned(smem_raw)};
  k.grid = gridDim.x;
  k.lane = threadIdx.x % 32;
  k.warp = threadIdx.x / 32;
  k.mt = k.warp & 1;
  k.ng = k.warp >> 1;
  k.col0 = blockIdx.x * d.nc;
  k.ncols = max(0, min(d.nc, d.Vp - k.col0));
  k.q0 = blockIdx.x * d.qc;
  k.nq = max(0, min(d.qc, d.A - k.q0));
  k.j0 = (int)blockIdx.x < d.H / kHid ? (int)blockIdx.x * kHid : -1;
  k.seed = d.sample ? *p.seed : 0u;
  k.ring_n = 0;
  k.bar = reinterpret_cast<uint64_t*>(k.base + p.s.bar);
  const int row = blockIdx.x;   // attention of row `row`, merge of row - B
  if (threadIdx.x == 0) {
    tok_s = BOS;
    fin_s = 0;
  }
  prologue(k, &tw, &tq);
  q_pass(k, 0);
  grid_barrier();
  for (int t = 0; t < d.L; ++t) {
    if (row < d.B) attend(k, row, t, &tok_s, &fin_s);   // (a)
    else if (row < 2 * d.B && t > 0) merge_step(k, row - d.B, t, &fin_s);
    grid_barrier();
    if (k.j0 >= 0) gates(k);   // (b)
    grid_barrier();
    load_h(k);   // (c)
    project(k, &tw, (unsigned)t, t + 1 < d.L);   // and the next q
    grid_barrier();
  }
  if (row >= d.B && row < 2 * d.B) merge_step(k, row - d.B, d.L, &fin_s);
}

}  // namespace

// The largest dynamic shared memory a block of the current device may take
// (cudaDevAttrMaxSharedMemoryPerBlockOptin) and its SM count; 0 or a
// cudaError_t.
extern "C" int vidcap_rollout_limits(int* smem_optin, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

// Plain C entry point (loaded with ctypes): one rollout of B <= 32 rows on
// `grid` blocks (the SM count). Inputs: emb [Vp, E], keys [B, T, A], values
// [B, T, H], wq [H, A], wg [E+2H, 4H], w_out [H, Vp] bf16; fmask [B, T],
// h0/c0 [B, H], u [A], bg [4H], b_out [Vp] f32. Scratch: xh [B, E+H], h16
// [B, H], q [B, A] bf16; pm/ps/pn/pc [B, grid] f32, pi [B, grid] i32;
// pick [2, B] u64.
// Outputs [B, max_len]: tokens i32, logp f32, mask f32. row0 is the first
// row's index in the hash of the Gumbel noise; seed points at the sampling
// seed on the device (its low 32 bits; may be null when sample is 0). nc,
// qc: the W_out and Wq columns a block holds (multiples of 8, nc * grid >=
// Vp, qc * grid >= A).
// Needs E, H, A multiples of 32 and at most 512 (H, A), Vp a multiple of 8,
// H <= 4 * grid and 2 * B <= grid <= 256. Returns the
// cudaError_t of the launch (cudaErrorCooperativeLaunchTooLarge if the
// blocks cannot all be resident, cudaErrorInvalidValue if the shared memory
// does not fit), or kTensorMapError + CUresult if a TMA map cannot be made.
extern "C" int vidcap_rollout(
    const void* emb, const void* keys, const void* values, const void* fmask,
    const void* h0, const void* c0, const void* wq, const void* u,
    const void* wg, const void* bg, const void* w_out, const void* b_out,
    void* xh, void* h16, void* q, void* pm, void* ps, void* pn, void* pc,
    void* pi, void* pick, void* out_tok, void* out_logp, void* out_mask,
    int B, int T,
    int E, int H, int A, int Vp, int vocab, int max_len, int row0, int grid,
    int nc, int qc, int resident, int sample, const void* seed,
    float inv_temp, void* stream) {
  Params p;
  p.emb = static_cast<const bf16*>(emb);
  p.keys = static_cast<const bf16*>(keys);
  p.values = static_cast<const bf16*>(values);
  p.wq = static_cast<const bf16*>(wq);
  p.wg = static_cast<const bf16*>(wg);
  p.w_out = static_cast<const bf16*>(w_out);
  p.fmask = static_cast<const float*>(fmask);
  p.h0 = static_cast<const float*>(h0);
  p.c0 = static_cast<const float*>(c0);
  p.u = static_cast<const float*>(u);
  p.bg = static_cast<const float*>(bg);
  p.b_out = static_cast<const float*>(b_out);
  p.xh = static_cast<bf16*>(xh);
  p.h16 = static_cast<bf16*>(h16);
  p.q = static_cast<bf16*>(q);
  p.pm = static_cast<float*>(pm);
  p.ps = static_cast<float*>(ps);
  p.pn = static_cast<float*>(pn);
  p.pc = static_cast<float*>(pc);
  p.pi = static_cast<int*>(pi);
  p.pick = static_cast<unsigned long long*>(pick);
  p.out_tok = static_cast<int*>(out_tok);
  p.out_logp = static_cast<float*>(out_logp);
  p.out_mask = static_cast<float*>(out_mask);
  p.seed = static_cast<const unsigned*>(seed);
  Dims& d = p.d;
  d = Dims{B, T, E, H, A, Vp, vocab, max_len, row0, nc, qc,
           H % 64 == 0 ? 64 : 32, 0, resident, sample, inv_temp};
  d.box_rows = H % 256 == 0 ? 256 : H % 128 == 0 ? 128 : H % 64 == 0 ? 64 : 32;
  p.s = smem_layout(d);
  if (B < 1 || B > kRows || grid < 2 * B || grid > kMaxGrid ||
      (sample && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err) return err;
  if (p.s.total + 2 * sizeof(int) > (uint32_t)optin)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tw, tq;
  err = make_tmap(&tw, w_out, Vp, H, Vp, 8, resident ? d.box_rows : d.kd);
  if (!err) err = make_tmap(&tq, wq, A, H, A, 8, d.box_rows);
  if (!err) err = allow_max_smem<rollout_kernel>();
  if (err) return err;
  void* args[] = {&p, &tw, &tq};
  return cooperative_launch(rollout_kernel, grid, kThreads, p.s.total,
                            static_cast<cudaStream_t>(stream), args);
}
