#!/usr/bin/env python3
"""Where K1's and K2's time goes, by ablation, on one NVIDIA GPU.

    python3 scripts/torch_kernel_ablate.py

Builds copies of ``vidcap_tpu_torch/csrc`` with one part of a kernel taken
out (each copy under ``build/ablate/<variant>/`` in the checkout), runs each
variant 20 times at ``msrvtt_attn_beam5`` width (K1: B=184, K=5, T=26,
E=H=A=512; K2: N=920, H=512, Vp=16,000, K=5) on the same seeded inputs, and
prints one JSON object: per variant, the device time of each kernel (µs a
launch, from ``torch.profiler``) and the card (``nvidia-smi`` name and power
limit). The variants compute wrong results on purpose; only their times
mean anything. The difference to ``*_full`` is what the removed part costs
where the rest of the kernel does not hide it.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from vidcap_tpu_torch.ops import _build  # noqa: E402
from vidcap_tpu_torch.ops.topk_project import chunk_layout  # noqa: E402

# the promotion of each 32-deep partial sum, replaced by one chain of four
# k16 wgmmas into the accumulator
NO_PROMOTION = ("hopper.cuh", """#pragma unroll
  for (int p = 0; p < 2; ++p) {
    wgmma_fence();""", """  if (true) {
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_128(acc, desc_a(a + k * 32), desc_b(b + k * 1024), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    return;
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    wgmma_fence();""")
EPILOGUE = "  __device__ void operator()(float (&acc)[kAccRegs], int tile) {\n"
TOPK = "      bool active = mt > -INFINITY"
TANH = "s[k] += bf16r(tanhf(bf16r(kf[j] + qf[j]))) * uf[j];"
SCORES = "  for (int t = warp; t < T; t += nwarps) {\n    float s[kMaxBeam];"
SOFTMAX = "  for (int k = warp; k < K; k += nwarps) {\n    float mx = -INFINITY;"
CTX = "  for (int d2 = tid; d2 < H / 2; d2 += blockDim.x) {"
# a loop bound the compiler cannot see through (K >= 1 at run time)
SKIP_SCORES = ("recurrent.cuh", SCORES, SCORES.replace("t < T", "t < (K < 0 ? T : 0)"))
SKIP_SOFTMAX = ("recurrent.cuh", SOFTMAX, SOFTMAX.replace("k < K", "k < (K < 0 ? K : 0)"))
SKIP_CTX = ("recurrent.cuh", CTX, CTX.replace("d2 < H / 2", "d2 < (K < 0 ? H / 2 : 0)"))

VARIANTS = {
    "topk_project": {
        "k2_full": [],
        "k2_no_epilogue": [("topk_project.cu", EPILOGUE, EPILOGUE + (
            "    if (vocab != -1) { m[0] = fmaxf(m[0], acc[0] + acc[63]); "
            "return; }\n"))],
        "k2_no_topk": [("topk_project.cu", TOPK, "if (Vp > 0) continue;\n" + TOPK)],
        "k2_no_promotion": [NO_PROMOTION],
    },
    "beam_core": {
        "k1_full": [],
        "k1_no_tanh": [("recurrent.cuh", TANH,
                        "s[k] += bf16r(bf16r(kf[j] + qf[j])) * uf[j];")],
        "k1_no_scores": [SKIP_SCORES],
        "k1_loads_only": [SKIP_SCORES, SKIP_SOFTMAX, SKIP_CTX],
        "k1_no_promotion": [NO_PROMOTION],
    },
}


def build(name: str, source: str, patches) -> ctypes.CDLL:
    d = os.path.join(REPO, "build", "ablate", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    for fn, old, new in patches:
        path = os.path.join(d, fn)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f"{name}: the code to take out is not in {fn}")
        with open(path, "w") as f:
            f.write(text.replace(old, new, 1))
    so = os.path.join(d, "kernel.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                    os.path.join(d, f"{source}.cu")], check=True)
    return ctypes.CDLL(so)


def device_us(call, n: int = 20) -> dict:
    for _ in range(3):
        if call() != 0:
            raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    return {e.key[:48]: e.self_device_time_total / n
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    g = np.random.default_rng(2)
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device="cuda")
    e = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt, device="cuda")
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    # K2 at msrvtt_attn_beam5 width
    N, H, VP, K = 920, 512, 16_000, 5
    h, w, b = (t(np.tanh(g.normal(size=(N, H)))),
               t(g.normal(size=(H, VP)) / np.sqrt(H), bf),
               t(g.normal(size=VP) * 0.1))
    per, nch = chunk_layout(N, VP, torch.cuda.get_device_properties(0)
                            .multi_processor_count)
    k2_out = (e(N, H, dt=bf), e(N, nch), e(N, nch), e(N, nch, K),
              e(N, nch, K, dt=torch.int32), e(N, K), e(N, K, dt=torch.int32))
    # K1 at the same width
    B, T, E, A = 184, 26, 512, 512
    k1_in = (t(g.normal(size=(B * K, E)) * 0.2),
             t(np.tanh(g.normal(size=(B * K, H)))), t(g.normal(size=(B * K, H))),
             t(g.normal(size=(B, T, A)), bf), t(g.normal(size=(B, T, H)), bf),
             t(np.ones((B, T), np.float32)),
             t(g.normal(size=(H, A)) / np.sqrt(H), bf), t(g.normal(size=A) * 0.05),
             t(g.uniform(-1, 1, (E + 2 * H, 4 * H)) * 0.05, bf),
             t(g.normal(size=4 * H) * 0.1))
    k1_out = (e(B * K, E + 2 * H, dt=bf), e(B * K, A, dt=bf), e(B * K, H),
              e(B * K, H))
    out = {}
    for source, variants in VARIANTS.items():
        for name, patches in variants.items():
            lib = build(name, source, patches)
            fn = getattr(lib, f"vidcap_{source}")
            fn.restype = ctypes.c_int
            if source == "topk_project":
                fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                               + [ctypes.c_void_p])
                ptrs = [x.data_ptr() for x in (h, w, b, *k2_out)]
                call = lambda: fn(*ptrs, N, H, VP, K, VP, per, nch, stream)
            else:
                fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                               + [ctypes.c_void_p])
                ptrs = [x.data_ptr() for x in (*k1_in, *k1_out)]
                call = lambda: fn(*ptrs, B, K, T, E, H, A, stream)
            out[name] = device_us(call)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "device_us_per_launch": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
