#!/usr/bin/env python3
"""Where K1's, K2's, K2-int8's and K3's time goes, by ablation, on one
NVIDIA GPU.

    python3 scripts/torch_kernel_ablate.py [beam_core] [topk_project]
        [topk_project_int8] [rollout]

Builds copies of ``vidcap_tpu_torch/csrc`` with one part of a kernel taken
out, or one design choice changed (each copy under
``build/ablate/<variant>/`` in the checkout), and runs each variant 20
times, after half a second of warm-up calls (the card idles while a variant
builds), at ``msrvtt_attn_beam5`` width (K1: B=184, K=5, T=26, E=H=A=512;
K2 and K2-int8: N=920, H=512, Vp=16,000, K=5) and K3's greedy rollout at
``msvd_greedy`` width (B=32, T=26, E=H=A=512, Vp=12,032, 30 steps, W_out
resident) on the same seeded inputs. Prints one JSON object: per variant,
the device time of each kernel (µs a launch, from ``torch.profiler``; K1's,
K2's and K2-int8's read twice, the second time under ``again`` after every
variant is built) and the card (``nvidia-smi`` name and power limit). The
variants compute wrong results on purpose; only their times mean anything.
The difference to ``*_full`` is what the removed part costs where the rest
of the kernel does not hide it. ``k3_phase_clocks`` is the whole K3 with
each block's cycles in each phase and barrier wait counted (clock64). With
kernel names as arguments, only their variants run; a variant whose code
is not in the sources is reported as skipped (run from a copy of another
commit, the script reads that commit's kernels). K2-int8's report its
three launches (``quantize_kernel``, ``chunk_s8_kernel``,
``merge_kernel``); their anchors are matched up to whitespace.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from vidcap_tpu_torch.ops import _build  # noqa: E402
from vidcap_tpu_torch.ops.int8_proj import Int8Projection  # noqa: E402
from vidcap_tpu_torch.ops.int8_proj import TILE_ROWS as INT8_ROWS  # noqa: E402
from vidcap_tpu_torch.ops.rollout import RolloutWeights, rollout  # noqa: E402
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
# K2-int8's epilogue: the reference's rounding chain of one accumulator, and
# the call of ChunkCarry::select on a tile's logits; SINK keeps every logit
# live (their maximum into the carry) so that the chain is not dropped
CHAIN = ("x[r] = in ? bf16r(__fadd_rn( __fmul_rn((float)acc[r], "
         "__fmul_rn(hsr[hh], wsc)), bqc)) : -INFINITY;")
SELECT = "carry.select(x, col0);"
SINK = ("{ float t_ = x[0]; for (int j_ = 1; j_ < (int)(sizeof(x) / 4); "
        "++j_) t_ = fmaxf(t_, x[j_]); carry.m[0] = fmaxf(carry.m[0], t_); }")
# K2-int8's stage without its wgmmas (behind a test the compiler cannot see
# through: the ring has boxes at run time); the TMA stream, the barriers and
# the empty commit groups stay
S8_MMA = "    if constexpr (First)\n      wgmma_s8_first("
NO_S8_MMA = ("topk_project.cu", S8_MMA,
             "    if (r.boxes < 0)\n    if constexpr (First)\n      wgmma_s8_first(")
S8_MMA_REST = "    for (int k = 1; k < kS8Box / 32; ++k)\n      wgmma_s8("
NO_S8_MMA_REST = ("topk_project.cu", S8_MMA_REST,
                  S8_MMA_REST.replace("k < kS8Box / 32", "k < (r.boxes < 0 ? kS8Box / 32 : 1)"))

TANH = "s[k] += bf16r(tanhf(bf16r(kf[j] + qf[j]))) * uf[j];"
SCORES = "  for (int t = warp; t < T; t += nwarps) {\n    float s[kMaxBeam];"
SOFTMAX = "  for (int k = warp; k < K; k += nwarps) {\n    float mx = -INFINITY;"
CTX = "  for (int d2 = tid; d2 < H / 2; d2 += blockDim.x) {"
# a loop bound the compiler cannot see through (K >= 1 at run time)
SKIP_SCORES = ("recurrent.cuh", SCORES, SCORES.replace("t < T", "t < (K < 0 ? T : 0)"))
SKIP_SOFTMAX = ("recurrent.cuh", SOFTMAX, SOFTMAX.replace("k < K", "k < (K < 0 ? K : 0)"))
SKIP_CTX = ("recurrent.cuh", CTX, CTX.replace("d2 < H / 2", "d2 < (K < 0 ? H / 2 : 0)"))
# K3: a phase of the persistent kernel skipped behind a test the compiler
# cannot see through (max_len >= 1 at run time); every grid barrier stays


def k3_skip(call: str) -> tuple:
    body = call.lstrip()
    new = (body.replace("if (", "if (d.L < 0 && ", 1) if body.startswith("if (")
           else "if (d.L < 0) " + body)
    return ("rollout.cu", call, call.replace(body, new))


ATTEND = "    if (row < d.B) attend(k, row, t, &tok_s, &fin_s);   // (a)\n"
MERGE = ("    else if (row < 2 * d.B && t > 0) merge_step(k, row - d.B, t, "
         "&fin_s);\n")
K3_MERGE = ("rollout.cu", MERGE, MERGE.replace("t > 0)", "t > 0 && d.L < 0)"))
K3_ATTEND = ("rollout.cu", ATTEND, ATTEND.replace(
    "attend(", "{ if (d.L < 0) attend(").replace(";", "; }", 1))
K3_GATES = k3_skip("    if (k.j0 >= 0) gates(k);   // (b)")
K3_LOAD_H = k3_skip("    load_h(k);   // (c)")
PROJECT = "    project(k, &tw, (unsigned)t, t + 1 < d.L);   // and the next q"
K3_PROJECT = k3_skip(PROJECT)
K3_Q = ("rollout.cu", PROJECT, PROJECT.replace("t + 1 < d.L)", "d.L < 0)"))
BARRIER = "  cooperative_groups::this_grid().sync();\n"
# K3's step loop, and a copy that counts each block's cycles (clock64) in
# each phase and barrier wait, summed over the steps of the last launch
K3_LOOP = """  for (int t = 0; t < d.L; ++t) {
""" + ATTEND + MERGE + """    grid_barrier();
    if (k.j0 >= 0) gates(k);   // (b)
    grid_barrier();
    load_h(k);   // (c)
""" + PROJECT + """
    grid_barrier();
  }
"""
K3_PHASES = ("attention", "barrier_a", "gates", "barrier_b", "load_h",
             "projection", "barrier_c")
K3_CLOCKED = ("rollout.cu", K3_LOOP, """  long long clk[8] = {};
  long long t0 = clock64();
  auto lap = [&](int i) {
    __syncthreads();
    const long long t1 = clock64();
    clk[i] += t1 - t0;
    t0 = t1;
  };
  for (int t = 0; t < d.L; ++t) {
    if (row < d.B) attend(k, row, t, &tok_s, &fin_s);
    else if (row < 2 * d.B && t > 0) merge_step(k, row - d.B, t, &fin_s);
    lap(0);
    grid_barrier();
    lap(1);
    if (k.j0 >= 0) gates(k);
    lap(2);
    grid_barrier();
    lap(3);
    load_h(k);
    lap(4);
    project(k, &tw, (unsigned)t, t + 1 < d.L);
    lap(5);
    grid_barrier();
    lap(6);
  }
  if (threadIdx.x == 0)
    for (int i = 0; i < 7; ++i) g_clk[blockIdx.x * 8 + i] = clk[i];
""")
K3_CLOCK_BUF = ("rollout.cu", "using namespace vidcap;\n", """using namespace vidcap;

__device__ long long g_clk[256 * 8];
""")
K3_CLOCK_READ = ("rollout.cu", "}  // namespace\n", """}  // namespace

extern "C" int vidcap_rollout_clocks(void* dst, int* khz) {
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(khz, cudaDevAttrClockRate, dev);
  return (int)cudaMemcpyFromSymbol(dst, g_clk, sizeof(g_clk));
}
""")

# K3 with each block's cycles in the parts of its attention, gate and
# projection phases counted (clock64 between block-wide barriers)
K3_SUB_PARTS = ("attention_token", "attention_scores", "attention_softmax",
                "attention_ctx_emb", "projection_product",
                "projection_epilogue", "projection_partials",
                "gates_product", "gates_lstm")
K3_SUB = [
    ("rollout.cu", "using namespace vidcap;\n", """using namespace vidcap;

__device__ long long g_sub[256 * 16];
__device__ __forceinline__ void sub_lap(int i) {
  __shared__ long long last;
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long now = clock64();
    if (i >= 0) g_sub[blockIdx.x * 16 + i] += now - last;
    last = now;
  }
  __syncthreads();
}
"""),
    ("rollout.cu", "int* tok_s, int* fin_s) {\n",
     "int* tok_s, int* fin_s) {\n  sub_lap(-1);\n"),
    ("rollout.cu", "  const int tok = *tok_s;\n",
     "  const int tok = *tok_s;\n  sub_lap(0);\n"),
    ("rollout.cu", "  // f32 softmax over T", "  sub_lap(1);\n  // f32 softmax over T"),
    ("rollout.cu", "  // ctx[d] = sum_t", "  sub_lap(2);\n  // ctx[d] = sum_t"),
    ("rollout.cu", "    reinterpret_cast<uint4*>(x)[v] = __ldg(e4 + v);\n}",
     "    reinterpret_cast<uint4*>(x)[v] = __ldg(e4 + v);\n  sub_lap(3);\n}"),
    ("rollout.cu", "                        bool with_q) {\n",
     "                        bool with_q) {\n  sub_lap(-1);\n"),
    ("rollout.cu", "    if (d.sample)\n      pick_epilogue",
     "    sub_lap(4);\n    if (d.sample)\n      pick_epilogue"),
    ("rollout.cu", "  if (q_done < nqp) q_pass(k, q_done);\n",
     "  if (q_done < nqp) q_pass(k, q_done);\n  sub_lap(5);\n"),
    ("rollout.cu", "pick_key(r.bv, r.bi));\n  }\n}",
     "pick_key(r.bv, r.bi));\n  }\n  sub_lap(6);\n}"),
    ("rollout.cu", "__device__ void gates(Block& k) {\n",
     "__device__ void gates(Block& k) {\n  sub_lap(-1);\n"),
    ("rollout.cu", "  __syncthreads();   // R is read no more",
     "  sub_lap(7);\n  __syncthreads();   // R is read no more"),
    ("rollout.cu", "tanhf(cn));\n    }\n  }\n}", "tanhf(cn));\n    }\n  }\n  sub_lap(8);\n}"),
    ("rollout.cu", "}  // namespace\n", """}  // namespace

extern "C" int vidcap_rollout_sub(void* dst, int reset, int* khz) {
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(khz, cudaDevAttrClockRate, dev);
  if (reset) {
    static long long zero[256 * 16];
    return (int)cudaMemcpyToSymbol(g_sub, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(dst, g_sub, sizeof(g_sub));
}
"""),
]


VARIANTS = {
    "topk_project": {
        "k2_full": [],
        "k2_no_epilogue": [("topk_project.cu", EPILOGUE, EPILOGUE + (
            "    if (vocab != -1) { m[0] = fmaxf(m[0], acc[0] + acc[63]); "
            "return; }\n"))],
        "k2_no_topk": [("topk_project.cu", TOPK, "if (Vp > 0) continue;\n" + TOPK)],
        "k2_no_promotion": [NO_PROMOTION],
    },
    "topk_project_int8": {
        "int8_full": [],
        "int8_no_topk": [("topk_project.cu", TOPK,
                          "if (Vp > 0) continue;\n" + TOPK)],
        "int8_no_select": [("topk_project.cu", SELECT, SINK)],
        "int8_product_only": [("topk_project.cu", CHAIN, "x[r] = (float)acc[r];"),
                              ("topk_project.cu", SELECT, SINK)],
        "int8_loads_only": [("topk_project.cu", CHAIN, "x[r] = (float)acc[r];"),
                            ("topk_project.cu", SELECT, SINK), NO_S8_MMA,
                            NO_S8_MMA_REST],
    },
    "beam_core": {
        "k1_full": [],
        "k1_no_tanh": [("recurrent.cuh", TANH,
                        "s[k] += bf16r(bf16r(kf[j] + qf[j])) * uf[j];")],
        "k1_no_scores": [SKIP_SCORES],
        "k1_loads_only": [SKIP_SCORES, SKIP_SOFTMAX, SKIP_CTX],
        "k1_no_promotion": [NO_PROMOTION],
    },
    "rollout": {
        "k3_full": [],
        "k3_phase_clocks": [K3_CLOCKED, K3_CLOCK_BUF, K3_CLOCK_READ],
        "k3_part_clocks": K3_SUB,
        "k3_barriers_twice": [("hopper.cuh", BARRIER, BARRIER * 2)],
        "k3_no_merge": [K3_MERGE],
        "k3_no_attention": [K3_ATTEND],
        "k3_no_gates": [K3_GATES],
        "k3_no_load_h": [K3_LOAD_H],
        "k3_no_projection": [K3_PROJECT],
        "k3_no_pick_epilogue": [("rollout.cu", "    if (d.sample)\n      pick_epilogue",
                                 "    if (d.L < 0) {} else if (d.sample)\n      pick_epilogue")],
        "k3_no_q": [K3_Q],   # the projection without the next q
        "k3_barriers_only": [K3_ATTEND, K3_GATES, K3_LOAD_H, K3_PROJECT],
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
        if old in text:
            text = text.replace(old, new, 1)
        else:   # the anchor up to whitespace
            pat = r"\s+".join(map(re.escape, old.split()))
            text, n = re.subn(pat, lambda _: new, text, count=1)
            if n != 1:
                raise LookupError(f"the code to change is not in {fn}")
        with open(path, "w") as f:
            f.write(text)
    so = os.path.join(d, "kernel.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                    os.path.join(d, f"{_build._source(source)}.cu")],
                   check=True)
    return ctypes.CDLL(so)


def device_us(call, n: int = 20, warm_s: float = 0.5) -> dict:
    """µs a launch of each kernel over ``n`` calls, after ``warm_s`` seconds
    of calls: the card idles while a variant builds, and its clocks take a
    while to rise again."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_s:
        for _ in range(3):
            if call() != 0:
                raise RuntimeError("launch failed")
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    # over the launches the profiler recorded (it has dropped some)
    return {e.key[:48]: e.self_device_time_total / e.count
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def k3_sub_us(lib, call, steps: int) -> dict:
    """One more launch with the part counters at 0: per part, the mean and
    the largest over the blocks that ran it, µs per step at the card's top
    SM clock."""
    clk = np.zeros(256 * 16, np.int64)
    khz = ctypes.c_int()
    lib.vidcap_rollout_sub.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p]
    torch.cuda.synchronize()
    if lib.vidcap_rollout_sub(None, 1, ctypes.byref(khz)) != 0 or call() != 0:
        raise RuntimeError("resetting the part clocks failed")
    torch.cuda.synchronize()
    if lib.vidcap_rollout_sub(clk.ctypes.data, 0, ctypes.byref(khz)) != 0:
        raise RuntimeError("reading the part clocks failed")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    us = clk.reshape(256, 16)[:sms] / (khz.value * 1e-3) / steps
    out = {}
    for i, part in enumerate(K3_SUB_PARTS):
        ran = us[:, i][us[:, i] > 0]
        out[part] = {"mean": float(ran.mean()) if len(ran) else 0.0,
                     "max": float(ran.max()) if len(ran) else 0.0}
    return out


def k3_phase_us(lib, steps: int) -> dict:
    """Per phase of K3's step: the mean and the largest over the blocks of
    the cycles a block spent in it, per step, in µs at the card's top SM
    clock (cudaDevAttrClockRate)."""
    clk = np.zeros(256 * 8, np.int64)
    khz = ctypes.c_int()
    lib.vidcap_rollout_clocks.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    if lib.vidcap_rollout_clocks(clk.ctypes.data, ctypes.byref(khz)) != 0:
        raise RuntimeError("reading the phase clocks failed")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    us = clk.reshape(256, 8)[:sms] / (khz.value * 1e-3) / steps
    return {"sm_clock_mhz": khz.value / 1e3, **{
        p: {"mean": float(us[:, i].mean()), "max": float(us[:, i].max())}
        for i, p in enumerate(K3_PHASES)}}


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
    # K2-int8 on the same rows, W_out quantized (its scratch as the wrapper's)
    proj = Int8Projection.from_dense(types.SimpleNamespace(
        kernel=t(g.normal(size=(H, VP)) / np.sqrt(H)), bias=b), VP)
    per8, nch8 = chunk_layout(N, VP, torch.cuda.get_device_properties(0)
                              .multi_processor_count, INT8_ROWS)
    k28_io = (h, proj.w8t, proj.wscale, proj.bq, e(N, H, dt=torch.int8), e(N),
              e(N, nch8), e(N, nch8), e(N, nch8, K),
              e(N, nch8, K, dt=torch.int32), e(N, K), e(N, K, dt=torch.int32))
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
    # K3 at msvd_greedy width, through its wrapper with the variant's entry
    BG, VG, L = 32, 12_032, 30
    w3 = RolloutWeights(
        emb=t(g.normal(size=(VG, E)) * 0.3, bf),
        wq=t(g.normal(size=(H, A)) / np.sqrt(H), bf), u=t(g.normal(size=A) * 0.05),
        wg=t(g.uniform(-1, 1, (E + 2 * H, 4 * H)) * 0.05, bf),
        bg=t(g.normal(size=4 * H) * 0.1),
        w_out=t(g.normal(size=(H, VG)) / np.sqrt(H), bf),
        b_out=t(g.normal(size=VG) * 0.1), vocab_size=12_000)
    k3_in = (t(g.normal(size=(BG, T, A)), bf), t(g.normal(size=(BG, T, H)), bf),
             t(np.ones((BG, T), np.float32)), t(np.tanh(g.normal(size=(BG, H)))),
             t(g.normal(size=(BG, H))))
    rollout(w3, *k3_in, L)   # builds the kernel, sets its entry's types
    out, again = {}, []
    only = sys.argv[1:] or list(VARIANTS)
    for source, variants in VARIANTS.items():
        if source not in only:
            continue
        for name, patches in variants.items():
            try:
                lib = build(name, source, patches)
            except LookupError as ex:   # another version of the kernel
                out[name] = {"skipped": str(ex)}
                continue
            fn = getattr(lib, f"vidcap_{source}")
            fn.restype = ctypes.c_int
            if source == "rollout":
                fn.argtypes = _build._fns["rollout"].argtypes
                _build._fns["rollout"] = fn   # the wrapper launches the variant
                call = lambda: rollout(w3, *k3_in, L) and 0
            elif source == "topk_project_int8":
                fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                               + [ctypes.c_void_p])
                ptrs = [x.data_ptr() for x in k28_io]
                call = lambda fn=fn, ptrs=ptrs: fn(*ptrs, N, H, VP, K, per8,
                                                   nch8, stream)
            elif source == "topk_project":
                fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                               + [ctypes.c_void_p])
                ptrs = [x.data_ptr() for x in (h, w, b, *k2_out)]
                call = lambda fn=fn, ptrs=ptrs: fn(*ptrs, N, H, VP, K, VP,
                                                   per, nch, stream)
            else:
                fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                               + [ctypes.c_void_p])
                ptrs = [x.data_ptr() for x in (*k1_in, *k1_out)]
                call = lambda fn=fn, ptrs=ptrs: fn(*ptrs, B, K, T, E, H, A,
                                                   stream)
            if source != "rollout":
                again.append((name, call))
            out[name] = device_us(call)
            if name == "k3_phase_clocks":
                out[name]["phase_us_per_step"] = k3_phase_us(lib, L)
            if name == "k3_part_clocks":
                out[name]["part_us_per_step"] = k3_sub_us(lib, call, L)
    # every K1/K2/K2-int8 variant once more, built, one after another:
    # the spread between the two readings
    for name, call in again:
        out[name]["again"] = device_us(call)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "device_us_per_launch": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
