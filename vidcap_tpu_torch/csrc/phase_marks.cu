// Phase marks of a training step: one-thread kernels that do nothing.
// utils/profiling.py::phase launches one at the start of each phase of the
// step on the current stream, so a CUDA graph of the step records them and
// every replay runs them; a device trace then splits the step's time at the
// marks. Their names are the phases' (profiling.PHASES, in this order),
// then the language-model decoder's layer marks (profiling.LM_MARKS).
#include <cuda_runtime.h>

extern "C" __global__ void vidcap_phase_rollout() {}
extern "C" __global__ void vidcap_phase_reward() {}
extern "C" __global__ void vidcap_phase_loss() {}
extern "C" __global__ void vidcap_phase_backward() {}
extern "C" __global__ void vidcap_phase_update() {}
extern "C" __global__ void vidcap_phase_end() {}
extern "C" __global__ void vidcap_phase_lm_attn() {}
extern "C" __global__ void vidcap_phase_lm_mlp() {}
extern "C" __global__ void vidcap_phase_lm_moe() {}
extern "C" __global__ void vidcap_phase_lm_head() {}

// Launch mark `which` (its index in profiling.PHASES + LM_MARKS) on `stream`; returns
// the launch's cudaError_t.
extern "C" int vidcap_phase_marks(int which, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: vidcap_phase_rollout<<<1, 1, 0, s>>>(); break;
    case 1: vidcap_phase_reward<<<1, 1, 0, s>>>(); break;
    case 2: vidcap_phase_loss<<<1, 1, 0, s>>>(); break;
    case 3: vidcap_phase_backward<<<1, 1, 0, s>>>(); break;
    case 4: vidcap_phase_update<<<1, 1, 0, s>>>(); break;
    case 5: vidcap_phase_end<<<1, 1, 0, s>>>(); break;
    case 6: vidcap_phase_lm_attn<<<1, 1, 0, s>>>(); break;
    case 7: vidcap_phase_lm_mlp<<<1, 1, 0, s>>>(); break;
    case 8: vidcap_phase_lm_moe<<<1, 1, 0, s>>>(); break;
    case 9: vidcap_phase_lm_head<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
