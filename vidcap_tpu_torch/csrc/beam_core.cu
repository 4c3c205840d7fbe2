// K1 beam_core: one beam step's recurrent core for B videos x K beams.
//
// Replaces vidcap_tpu/ops/pallas_beam_core.py::beam_core (_beam_core_kernel),
// which runs the whole step as one VMEM-resident block on the TPU.
//
// What bounds it on the H100: at the bench shape (B=184, K=5, E=H=A=512,
// T=26) the products are 2*920*(1536*2048 + 512*512 + 26*1024) = 6.3 GFLOP
// (~6.4 us at 989 TFLOP/s bf16) and the bytes ~26 MB (Wg 6.3 MB,
// keys+values 9.8 MB, h/c/emb in, h/c out; ~7.8 us at 3.35 TB/s): close to
// balanced, slightly bytes-bound. The first version took ~47x that, on
// latency (recurrent.cuh says where).
//
// Design, four kernels on the caller's stream, all from recurrent.cuh: the
// bf16 packing of emb and h into the gate GEMM's A operand xh; q on tensor
// cores (TMA + wgmma) over 128-row tiles; the attention, one block per video
// reading keys[b] and values[b] once for all K beams and writing ctx into
// xh; the gate GEMM, TMA + wgmma through a 4-stage mbarrier ring with a
// producer warp and two consumer warpgroups, promoted 32-deep partial sums
// and the LSTM update in its epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "recurrent.cuh"

using bf16 = __nv_bfloat16;
using namespace vidcap;

// Plain C entry point (loaded with ctypes). Shapes: emb [B*K, E], h/c/
// h_out/c_out [B*K, H] f32; keys [B, T, A], values [B, T, H] bf16; fmask
// [B, T] f32; wq [H, A] bf16; u [A] f32; wg [E+2H, 4H] bf16; bg [4H] f32;
// scratch xh [B*K, E+2H] and q [B*K, A] bf16. Needs K <= 8, E % 8 == 0 and
// H, A multiples of 32. Returns the cudaError_t of the launches, or
// kTensorMapError + CUresult if a TMA map cannot be made (0 on success).
extern "C" int vidcap_beam_core(const void* emb, const void* h, const void* c,
                                const void* keys, const void* values,
                                const void* fmask, const void* wq,
                                const void* u, const void* wg, const void* bg,
                                void* xh, void* q, void* h_out, void* c_out,
                                int B, int K, int T, int E, int H, int A,
                                void* stream) {
  RecurrentMaps maps;
  int err = make_recurrent_maps(&maps, xh, wq, wg, B * K, E, H, A);
  if (err) return err;
  err = recurrent_setup();
  if (err) return err;
  return recurrent_step(
      maps, static_cast<const float*>(emb), static_cast<const float*>(h), static_cast<const float*>(c),
      static_cast<const bf16*>(keys), static_cast<const bf16*>(values),
      static_cast<const float*>(fmask), static_cast<const float*>(u),
      static_cast<const float*>(bg), static_cast<bf16*>(xh),
      static_cast<bf16*>(q), static_cast<float*>(h_out),
      static_cast<float*>(c_out), B, K, T, E, H, A,
      static_cast<cudaStream_t>(stream));
}
