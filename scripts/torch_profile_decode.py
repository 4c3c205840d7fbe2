#!/usr/bin/env python3
"""Where one decode of the PyTorch port spends its device time.

    python3 scripts/torch_profile_decode.py [--method beam|greedy|sample]

Runs on one NVIDIA GPU (no CPU fallback). Builds the Hopper kernels, makes
``Captioner`` with seeded random weights for the method's preset and
decodes a batch of synthetic features: beam-5 under ``msrvtt_attn_beam5``
with vocab 16,000 and 184 videos (the bench's batch, ``bench.py:38``);
greedy under ``msvd_greedy`` and sampled under ``scst_cider`` (seed 1) with
vocab 12,000 and 32 videos (``train.batch_size``). After a warm-up it times
five unprofiled decodes of one input on the host clock, then profiles one
more decode of that same input with ``torch.profiler``. It prints the
device time by kernel, the device-busy time of the profiled decode, the
median wall time of the unprofiled ones (the profiler slows the host, so
its own wall time is printed apart), their ratio as the device-busy share,
and the card (``nvidia-smi`` name and power limit).
"""
from __future__ import annotations

import argparse
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
from vidcap_tpu_torch.data.vocab import SPECIALS, Vocab  # noqa: E402
from vidcap_tpu_torch.inference import Captioner  # noqa: E402
from vidcap_tpu_torch.ops import _build  # noqa: E402

# method → (preset, batch, vocab)
RUNS = {"beam": ("msrvtt_attn_beam5", 184, 16_000),
        "greedy": ("msvd_greedy", 32, 12_000),
        "sample": ("scst_cider", 32, 12_000)}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--method", choices=sorted(RUNS), default="beam")
    method = p.parse_args().method
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    preset, B, V = RUNS[method]
    cfg = get_preset(preset)
    words = SPECIALS + [f"w{i}" for i in range(V - len(SPECIALS))]
    T, D = cfg.data.num_frames, cfg.data.feature_dim
    g = np.random.default_rng(0)
    feats = [g.normal(size=(B, T, D)).astype(np.float32) for _ in range(2)]
    ids = [f"video{i}" for i in range(B)]
    cap = Captioner.from_checkpoint(cfg, CaptionDataset(
        feats[0], ids, {v: [] for v in ids}, cfg.data,
        vocab=Vocab({w: i for i, w in enumerate(words)}, words)), seed=1)
    decode = lambda f: cap.decode_batch(f, method=method)
    decode(feats[0])                                 # warm-up
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        decode(feats[1])
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls))
    steps0 = cap.decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode(feats[1])
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key[:60]] = (e.self_device_time_total / 1e3, e.count)
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "card": card, "method": method, "preset": preset, "batch": B,
        "steps": cap.decode_steps - steps0, "device_busy_ms": busy_ms,
        "wall_ms": wall_ms, "wall_ms_each": walls,
        "profiled_wall_ms": profiled_wall_ms,
        "device_busy_share": busy_ms / wall_ms,
        "top_device_ms": dict(sorted(by_kernel.items(),
                                     key=lambda kv: -kv[1][0])[:8])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
