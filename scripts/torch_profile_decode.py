#!/usr/bin/env python3
"""Where one beam-5 decode of the PyTorch port spends its device time.

    python3 scripts/torch_profile_decode.py

Runs on one NVIDIA GPU (no CPU fallback). Builds the Hopper kernels, makes
``Captioner`` for preset ``msrvtt_attn_beam5`` with vocab 16,000 and seeded
random weights, and decodes 184 videos of synthetic features (the bench's
batch, ``bench.py:38``). After a warm-up it times five unprofiled decodes of
one input on the host clock, then profiles one more decode of that same
input with ``torch.profiler``. It prints the device time by kernel, the
device-busy time of the profiled decode, the median wall time of the
unprofiled ones (the profiler slows the host, so its own wall time is
printed apart), their ratio as the device-busy share, and the card
(``nvidia-smi`` name and power limit).
"""
from __future__ import annotations

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

B = 184


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    cfg = get_preset("msrvtt_attn_beam5")
    V = 16_000
    words = SPECIALS + [f"w{i}" for i in range(V - len(SPECIALS))]
    T, D = cfg.data.num_frames, cfg.data.feature_dim
    g = np.random.default_rng(0)
    feats = [g.normal(size=(B, T, D)).astype(np.float32) for _ in range(2)]
    ids = [f"video{i}" for i in range(B)]
    cap = Captioner.from_checkpoint(cfg, CaptionDataset(
        feats[0], ids, {v: [] for v in ids}, cfg.data,
        vocab=Vocab({w: i for i, w in enumerate(words)}, words)))
    cap.decode_batch(feats[0])                       # warm-up
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        cap.decode_batch(feats[1])
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls))
    steps0 = cap.decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cap.decode_batch(feats[1])
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
        "card": card, "batch": B, "beam": 5,
        "steps": cap.decode_steps - steps0, "device_busy_ms": busy_ms,
        "wall_ms": wall_ms, "wall_ms_each": walls,
        "profiled_wall_ms": profiled_wall_ms,
        "device_busy_share": busy_ms / wall_ms,
        "top_device_ms": dict(sorted(by_kernel.items(),
                                     key=lambda kv: -kv[1][0])[:8])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
