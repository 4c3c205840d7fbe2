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
// Design, two launches on the caller's stream, both from recurrent.cuh:
//  (a) attention_kernel: one block per video; keys[b] and values[b] are read
//      once per step for all K beams.
//  (b) gates_kernel: the [B*K, E+2H] x [E+2H, 4H] gate GEMM on bf16 tensor
//      cores with promoted 32-deep partial sums and the LSTM update in its
//      epilogue; the embedding rows are dense f32 rows (vidcap::DenseEmb).
// Simple and synchronous: no cp.async/TMA pipelining and no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "recurrent.cuh"

using bf16 = __nv_bfloat16;
using namespace vidcap;

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
  gates_kernel<<<gates_grid(M, H), kGateThreads, 0, s>>>(
      DenseEmb{static_cast<const float*>(emb)}, static_cast<const float*>(ctx),
      static_cast<const float*>(h), static_cast<const float*>(c),
      static_cast<const bf16*>(wg), static_cast<const float*>(bg),
      static_cast<float*>(h_out), static_cast<float*>(c_out), M, E, H);
  return (int)cudaGetLastError();
}
