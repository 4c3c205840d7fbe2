#!/usr/bin/env python3
"""Where one train step of the PyTorch port spends its time, XE and SCST.

    python3 scripts/torch_profile_train.py [--stages xe,scst] [--steps 5]

Runs on one NVIDIA GPU (no CPU fallback). Builds the Hopper kernels, makes
the seeded model of preset ``scst_cider`` (E = H = A = 512, D = 1536, T = 26,
vocab 12,000 padded to 12,032, B = 32, max_len 30, the attribute head at
0.2, ``scst_xe_mix`` 0.1) and a synthetic corpus over that vocab (64 videos
of N(0,1) features, 5 captions each of 5-29 words from a 300-word pool),
then for each stage takes one warm-up step and ``--steps`` timed steps on
the host clock (each ends in a synchronize), the SCST ones with CUDA events
around the two K3 rollouts, and profiles one more step with
``torch.profiler``. It prints, per stage: the median step time and steps/s,
K3's share of the SCST step, the device-busy time of the profiled step and
its ratio to the median step time (the busy share; the profiler slows the
host, so the profiled step's own wall time is printed apart), the device
kernels and the host's top-level profiler events of that step, the
launch counts, and the card (``nvidia-smi`` name and power limit).
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
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vidcap_tpu_torch.config import get_preset  # noqa: E402
from vidcap_tpu_torch.data.loader import CaptionDataset  # noqa: E402
from vidcap_tpu_torch.data.pipeline import DeterministicBatcher  # noqa: E402
from vidcap_tpu_torch.data.vocab import SPECIALS, Vocab  # noqa: E402
from vidcap_tpu_torch.models.model import (create_model,  # noqa: E402
                                           init_params)
from vidcap_tpu_torch.ops import _build  # noqa: E402
from vidcap_tpu_torch.train.loop import batch_to_device  # noqa: E402
from vidcap_tpu_torch.train.scst import make_scst_step_body  # noqa: E402
from vidcap_tpu_torch.train.state import create_train_state  # noqa: E402
from vidcap_tpu_torch.train.steps import make_xe_step_body  # noqa: E402

VOCAB = 12_000


def corpus(cfg) -> CaptionDataset:
    g = np.random.default_rng(0)
    words = SPECIALS + [f"w{i}" for i in range(VOCAB - len(SPECIALS))]
    pool = g.integers(4, VOCAB, 300)
    ids = [f"video{i}" for i in range(64)]
    caps = {v: [" ".join(words[int(t)] for t in g.choice(
        pool, int(g.integers(5, 30)))) for _ in range(5)] for v in ids}
    feats = g.normal(size=(64, cfg.data.num_frames, cfg.data.feature_dim))
    return CaptionDataset(feats.astype(np.float32), ids, caps, cfg.data,
                          vocab=Vocab({w: i for i, w in enumerate(words)},
                                      words))


def run_stage(stage: str, steps: int, ds, base) -> dict:
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, stage=stage))
    model = init_params(create_model(cfg, ds.vocab.size),
                        cfg.train.seed).cuda()
    state = create_train_state(cfg, model)
    it = DeterministicBatcher(ds, cfg.train.batch_size, seed=0)
    scst = make_scst_step_body(cfg, ds) if stage == "scst" else None
    xe = make_xe_step_body(cfg)

    def one(k3_ms=None):
        nonlocal state
        batch = batch_to_device(next(it), "cuda")
        if scst is None:
            state, m = xe(state, batch)
        else:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            sample, greedy = scst.rollouts(state, batch)
            ev[1].record()
            state, m = scst.update(state, batch, sample, greedy)
            if k3_ms is not None:
                torch.cuda.synchronize()
                k3_ms.append(ev[0].elapsed_time(ev[1]))
        return m

    one()                                               # warm-up
    torch.cuda.synchronize()
    _build.reset_counts()
    walls, k3 = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        one(k3)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_build.launch_counts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key[:60]] = (e.self_device_time_total / 1e3, e.count)
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    wall_ms = float(np.median(walls))
    out = {"stage": stage, "preset": base.name, "batch": cfg.train.batch_size,
           "step_ms": wall_ms, "step_ms_each": walls,
           "steps_per_s": 1e3 / wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "profiled_wall_ms": profiled_wall_ms,
           "device_kernels": sum(n for k, (_, n) in by_kernel.items()
                                 if not k.startswith(("Memcpy", "Memset"))),
           # the host events of the profiled step that have no parent
           # event (operators, autograd functions, runtime calls)
           "host_ops": sum(1 for e in prof.events() if e.cpu_parent is None),
           "launches": launches,
           "top_device_ms": dict(sorted(by_kernel.items(),
                                        key=lambda kv: -kv[1][0])[:10])}
    if k3:
        out["k3_rollouts_ms"] = float(np.median(k3))
        out["k3_share"] = out["k3_rollouts_ms"] / wall_ms
        out["rollout_w_out"] = ("resident" if scst.rollout_resident
                                else "streamed")
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--stages", default="xe,scst")
    p.add_argument("--steps", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    cfg = get_preset("scst_cider")
    ds = corpus(cfg)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    for stage in args.stages.split(","):
        print(json.dumps({"card": card, **run_stage(stage, args.steps, ds,
                                                    cfg)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
