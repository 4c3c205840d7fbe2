// Hopper building blocks shared by the tensor-core kernels: mbarriers, TMA
// tile loads, wgmma on shared-memory descriptors, and the host-side encoding
// of TMA tensor maps.
//
// The operand layouts every product here uses (bf16, f32 accumulate):
//  A, K-major (rows of the activations, depth contiguous): TMA boxes of
//     64 deep x R rows with 128-byte swizzle, so row r of a box sits at
//     r * 128 bytes. One wgmma takes 64 rows x 16 deep; the k16 steps of a
//     box start 32 bytes apart.
//  B, MN-major (a weight [depth, width] in its own row-major layout, width
//     contiguous): TMA boxes of 32 columns x 64 deep with 64-byte swizzle,
//     4 KB each, "slabs". A 128-wide wgmma B operand is four slabs laid one
//     after another (LBO = 4 KB between 32-column atoms, SBO = 512 bytes
//     between groups of 8 depth rows); the k16 steps start 1 KB apart. A slab
//     may come from any 32 columns of the weight, so one product can take
//     the four LSTM gates' columns j0..j0+31 side by side.
// Rows and columns past a tensor's edge arrive as zeros (TMA's
// out-of-bounds fill), so ragged edges need no masking in the product.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "common.cuh"

namespace vidcap {

constexpr int kDepthStep = 64;                      // depth of one ring stage
constexpr int kSlabCols = 32;                       // columns of one B slab
constexpr int kSlabBytes = kDepthStep * kSlabCols * 2;   // 4 KB
constexpr int kWgCols = 4 * kSlabCols;              // N of one wgmma: 128
constexpr int kAccRegs = kWgCols / 2;               // f32 accumulators/thread

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed (the n-th completion
// of a barrier has parity n & 1).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ---- TMA -------------------------------------------------------------------

// Copy the box at (c0 innermost, c1) of `map` into shared memory at `dst`;
// completion adds the box's bytes to `bar`'s transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Copy `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into
// shared memory; completion adds them to `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- warpgroup register budgets --------------------------------------------

// A producer warpgroup gives registers back so that the consumer warpgroups
// of its block can hold their accumulators; all four warps call these.
template <int N>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ uint64_t desc_a(uint32_t addr) {   // K-major, 128B
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {   // MN-major, 64B
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (256ull << 16) | (32ull << 32) |
         (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of `d` across an asynchronous wgmma.
__device__ __forceinline__ void fence_regs(float (&d)[kAccRegs]) {
#pragma unroll
  for (int i = 0; i < kAccRegs; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A[64 x 16] . B[16 x 128]; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_128(float (&d)[kAccRegs], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// acc += A[64 rows x 64 deep] . B[64 deep x 128] for one warpgroup: `a` is
// the first of its 64 rows in a K-major box, `b` the first of four slabs.
// Each 32 of depth (two k16 wgmmas) is summed by the tensor cores into
// `part`, then added to `acc` in f32 (vidcap::promote): chained over a deep
// product the tensor cores' own accumulation is several times less exact
// than an f32 sum, and the bf16 roundings downstream turn that into decodes
// that part from the reference.
__device__ __forceinline__ void mma_depth_step(float (&acc)[kAccRegs],
                                               float (&part)[kAccRegs],
                                               uint32_t a, uint32_t b) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    wgmma_fence();
    wgmma_128(part, desc_a(a + (2 * p) * 32), desc_b(b + (2 * p) * 1024), 0);
    wgmma_128(part, desc_a(a + (2 * p + 1) * 32),
              desc_b(b + (2 * p + 1) * 1024), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
    promote(acc, part);
  }
}

// Where accumulator register acc[4*i + 2*hh + e] of a thread lies in the
// warpgroup's 64 x 128 tile: row (warp % 4) * 16 + lane / 4 + 8 * hh,
// column i * 8 + (lane % 4) * 2 + e.
__device__ __forceinline__ int frag_row(int hh) {
  return ((threadIdx.x / 32) % 4) * 16 + (threadIdx.x % 32) / 4 + 8 * hh;
}
__device__ __forceinline__ int frag_col(int i) {
  return i * 8 + (threadIdx.x % 4) * 2;
}

// The dynamic shared memory base rounded up to 1024 bytes (the 128-byte
// swizzle's period); launches ask for 1 KB more than they use.
__device__ __forceinline__ unsigned char* smem_aligned(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// ---- host: TMA tensor maps -------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which these libraries do not link
// (they link the CUDA runtime only), so it is looked up with dlopen in the
// libcuda the process has loaded. (The host helpers with a function-local
// static are `static`: an inline function's static would be one object
// across all the kernel libraries of the process, which each need their
// own.)
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// Error code the entry points return when a tensor map cannot be made (not
// a cudaError_t; those stay below 1000).
constexpr int kTensorMapError = 1000;

// Let `kernel` take as much dynamic shared memory as the card allows; the
// launches ask for what they use. Once per process and kernel (on the
// device current at the first call).
template <auto kernel>
static int allow_max_smem() {
  static int err = [] {
    int dev = 0, max_optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&max_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncAttributes attr;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess)   // static shared memory counts against the limit
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_optin - (int)attr.sharedSizeBytes);
    return (int)e;
  }();
  return err;
}

// A 2-D bf16 tensor map: `cols` innermost (contiguous), `rows` outer with
// `row_elems` elements from one row to the next; boxes of box_cols x
// box_rows; 128-byte swizzle for A operands (box_cols = 64), 64-byte for B
// slabs (box_cols = 32). Needs base and row stride 16-byte aligned.
inline int make_tmap(CUtensorMap* map, const void* base, uint64_t cols,
                     uint64_t rows, uint64_t row_elems, uint32_t box_cols,
                     uint32_t box_rows) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return kTensorMapError;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_elems * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

}  // namespace vidcap
