#!/usr/bin/env python3
"""Where one train step of the PyTorch port spends its time, XE and SCST,
and the end-to-end steps through the IRv2 backbone.

    python3 scripts/torch_profile_train.py [--stages xe,scst] [--steps 5]
        [--preset scst_cider] [--feature-bank] [--steps-per-dispatch K]
        [--eager-body]
    python3 scripts/torch_profile_train.py --preset e2e_scst_multitask \
        --stages scst --steps 3        # the composed step on pixels
    python3 scripts/torch_profile_train.py --preset e2e_irv2 --stages e2e

Runs on one NVIDIA GPU (no CPU fallback). Builds the Hopper kernels, makes
the seeded model of the preset (``scst_cider``: E = H = A = 512, D = 1536,
T = 26, vocab 12,000 padded to 12,032, B = 32, max_len 30, the attribute
head at 0.2, ``scst_xe_mix`` 0.1; ``msrvtt_attn_beam5``: vocab 16,000,
B = 64, no attribute head; the e2e presets: IRv2 at full width, B = 8,
26 frames of 299 × 299 pixels) and a synthetic corpus over the preset's
vocab (64 videos of N(0,1) features, or with the backbone 16 videos of
uniform pixels in [-1, 1]; 5 captions each of 5-29 words from a 300-word
pool). For each stage it dispatches the step as the train loop
does (train/steps.py: one CUDA graph a dispatch, captured at the first;
``--feature-bank`` gathers the features from the device bank,
``--steps-per-dispatch K`` with it runs K steps a dispatch), or with
``--eager-body`` calls the step body eagerly on a batch uploaded from
pageable memory (the loop before the graphs). One dispatch first (the
warm-up and the capture), then ``--steps`` timed dispatches on the host
clock (each ends in a synchronize), then one profiled with
``torch.profiler``. It prints, per stage and a step: the median time and
steps/s, the device-busy time of the profiled dispatch and its ratio to the
median time (the busy share; the profiler slows the host, so the profiled
dispatch's own wall time is printed apart), the device kernels and the
host's top-level profiler events, K3's device time and share (SCST), the
device time by kernel family (convolution, elementwise, K3, GEMM, other),
the peak device memory of the timed steps, the launch counts, and the card
(``nvidia-smi`` name and power limit).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vidcap_tpu_torch.config import get_preset  # noqa: E402
from vidcap_tpu_torch.data.loader import CaptionDataset  # noqa: E402
from vidcap_tpu_torch.data.pipeline import DeterministicBatcher  # noqa: E402
from vidcap_tpu_torch.data.vocab import SPECIALS, Vocab  # noqa: E402
from vidcap_tpu_torch.models.model import (create_model,  # noqa: E402
                                           init_params)
from vidcap_tpu_torch.ops import _build  # noqa: E402
from vidcap_tpu_torch.train.loop import (batch_to_device,  # noqa: E402
                                         batch_to_device_dict)
from vidcap_tpu_torch.train.scst import make_scst_step_body  # noqa: E402
from vidcap_tpu_torch.train.state import create_train_state  # noqa: E402
from vidcap_tpu_torch.train.steps import (draw_seeds,  # noqa: E402
                                          make_banked_multistep,
                                          make_banked_step, make_step,
                                          make_xe_step_body)

def corpus(cfg) -> CaptionDataset:
    g = np.random.default_rng(0)
    vocab = cfg.data.vocab_size
    words = SPECIALS + [f"w{i}" for i in range(vocab - len(SPECIALS))]
    pool = g.integers(4, vocab, 300)
    n = 16 if cfg.model.use_backbone else 64
    ids = [f"video{i}" for i in range(n)]
    caps = {v: [" ".join(words[int(t)] for t in g.choice(
        pool, int(g.integers(5, 30)))) for _ in range(5)] for v in ids}
    if cfg.model.use_backbone:
        S = cfg.data.frame_size
        feats = g.random((n, cfg.data.num_frames, S, S, 3),
                         dtype=np.float32) * 2 - 1
    else:
        feats = g.normal(size=(n, cfg.data.num_frames,
                               cfg.data.feature_dim)).astype(np.float32)
    return CaptionDataset(feats, ids, caps, cfg.data,
                          vocab=Vocab({w: i for i, w in enumerate(words)},
                                      words))


# kernel-name fragments of each family (cuDNN's convolution kernels,
# cuBLAS's and CUTLASS's GEMMs, the host-device copies, PyTorch's
# elementwise, reduction, concatenation and pooling kernels)
FAMILIES = (("k3", ("rollout_kernel",)),
            ("conv", ("conv", "cudnn", "implicit_gemm", "fprop", "dgrad",
                      "wgrad")),
            ("gemm", ("gemm", "cublas", "cutlass")),
            ("copy", ("Memcpy", "Memset")),
            ("elementwise", ("elementwise", "reduce_kernel",
                             "CatArrayBatchedCopy", "copy_", "max_pool",
                             "avg_pool", "index")))


def by_family(by_kernel) -> dict:
    """Device ms a step by kernel family (the first family whose fragment
    the name holds), the rest as "other"."""
    out = {name: 0.0 for name, _ in FAMILIES}
    out["other"] = 0.0
    for key, (ms, _) in by_kernel.items():
        low = key.lower()
        fam = next((name for name, frags in FAMILIES
                    if any(f.lower() in low for f in frags)), "other")
        out[fam] += ms
    return out


def run_stage(stage: str, args, ds, base) -> dict:
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, stage=stage))
    model = init_params(create_model(cfg, ds.vocab.size),
                        cfg.train.seed).cuda()
    state = create_train_state(cfg, model)
    it = DeterministicBatcher(ds, cfg.train.batch_size, seed=0)
    body = (make_scst_step_body(cfg, ds) if stage == "scst"
            else make_xe_step_body(cfg))     # xe, e2e
    bank, k = args.feature_bank, args.steps_per_dispatch
    k = k if bank and not args.eager_body else 1
    if args.eager_body:
        def one():
            seed = {"seed": draw_seeds(state, 1)} if stage == "scst" else {}
            return body(state, {**batch_to_device(next(it), "cuda"), **seed})
    else:
        if not bank:
            fn = make_step(body, "cuda")
        elif k > 1:
            fn, _ = make_banked_multistep(body, ds, k, device="cuda")
        else:
            fn, _ = make_banked_step(body, ds, device="cuda")

        def one():
            ds_ = [batch_to_device_dict(next(it), bank) for _ in range(k)]
            return fn(state, ds_[0] if k == 1 else {
                key: np.stack([d[key] for d in ds_]) for key in ds_[0]})

    torch.cuda.reset_peak_memory_stats()    # the graph's pool counts too
    one()                                   # warm-up and capture
    torch.cuda.synchronize()
    _build.reset_counts()
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / k)
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3 / k
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            # summed by the name's first 60 characters: kernels that share
            # them (the elementwise templates) all count
            ms, n = by_kernel.get(e.key[:60], (0.0, 0.0))
            by_kernel[e.key[:60]] = (ms + e.self_device_time_total / 1e3 / k,
                                     n + e.count / k)
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    wall_ms = float(np.median(walls))
    how = ("eager body" if args.eager_body else "banked" if bank
           else "captured")
    out = {"stage": stage, "preset": base.name, "batch": cfg.train.batch_size,
           "dispatch": how, "steps_per_dispatch": k,
           "step_ms": wall_ms, "step_ms_each": walls,
           "steps_per_s": 1e3 / wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "profiled_wall_ms": profiled_wall_ms,
           "device_kernels": sum(n for key, (_, n) in by_kernel.items()
                                 if not key.startswith(("Memcpy", "Memset"))),
           # the host events of the profiled dispatch that have no parent
           # event (operators, autograd functions, runtime calls), a step
           "host_ops": sum(1 for e in prof.events() if e.cpu_parent is None
                           and e.device_type == DeviceType.CPU) / k,
           "launches": launches, "peak_memory_bytes": peak,
           "device_ms_by_family": by_family(by_kernel),
           "top_device_ms": dict(sorted(by_kernel.items(),
                                        key=lambda kv: -kv[1][0])[:10])}
    if stage == "scst":
        k3 = sum(ms for key, (ms, _) in by_kernel.items()
                 if "rollout_kernel" in key)
        out["k3_ms"] = k3
        out["k3_share"] = k3 / wall_ms
        out["rollout_w_out"] = ("resident" if body.rollout_resident
                                else "streamed")
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--stages", default="xe,scst")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--preset", default="scst_cider")
    p.add_argument("--feature-bank", action="store_true")
    p.add_argument("--steps-per-dispatch", type=int, default=1)
    p.add_argument("--eager-body", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    cfg = get_preset(args.preset)
    ds = corpus(cfg)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    for stage in args.stages.split(","):
        print(json.dumps({"card": card, **run_stage(stage, args, ds, cfg)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
