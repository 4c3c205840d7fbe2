#!/usr/bin/env python3
"""Where a served batch's time goes in the port's stdin server.

    python3 scripts/torch_profile_serve.py

Runs on one NVIDIA GPU (no CPU fallback). Builds the Hopper kernels, makes
``Captioner`` with seeded random weights under ``msrvtt_attn_beam5`` (beam
5, vocab 16,000) and serves 100 ``.npy`` files of 1-40 frames through
``serving.CaptionServer`` in process, as ``serve --batch 32 --max-wait-ms
50 --pipeline-depth 1`` does: the paths written at once into a pipe after
the warmup, three runs of one server. Each run times, on the host clock,
every file load (the main thread), every decode (the worker; the decode
ends with its tokens on the host) and every batch's last output line,
from the moment the paths are written. It prints per run and batch: the
end of its loads, the start and end of its decode, its last line; the sum
of the loads and of the decodes; the captions/s; and the card
(``nvidia-smi`` name and power limit).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vidcap_tpu_torch.config import get_preset  # noqa: E402
from vidcap_tpu_torch.data.loader import CaptionDataset  # noqa: E402
from vidcap_tpu_torch.data.vocab import SPECIALS, Vocab  # noqa: E402
from vidcap_tpu_torch.inference import Captioner  # noqa: E402
from vidcap_tpu_torch.ops import _build  # noqa: E402
from vidcap_tpu_torch.serving import CaptionServer  # noqa: E402

FILES, B, RUNS = 100, 32, 3


def serve_once(server, paths):
    """One run: (t0, loads, decodes, line times), times from perf_counter."""
    loads, decodes, lines = [], [], []
    load, decode = server._loader, server.captioner.decode_batch

    def timed_load(path):
        feats = load(path)
        loads.append(time.perf_counter())
        return feats

    def timed_decode(*a, **k):
        t = time.perf_counter()
        toks = decode(*a, **k)
        decodes.append((t, time.perf_counter()))
        return toks

    class Lines:
        def write(self, s):
            if "\t" in s:
                lines.append(time.perf_counter())

        def flush(self):
            pass

    server._load_features = timed_load
    server.captioner.decode_batch = timed_decode
    r, w = os.pipe()
    rf, wf = os.fdopen(r), os.fdopen(w, "w")
    th = threading.Thread(target=server.run, args=(rf, Lines()),
                          kwargs={"warmup": False})
    th.start()
    t0 = time.perf_counter()
    wf.write("\n".join(paths) + "\n")
    wf.flush()
    while len(lines) < len(paths) and th.is_alive():
        time.sleep(0.001)
    wf.close()
    th.join()
    del server.captioner.decode_batch
    if len(lines) != len(paths):
        raise RuntimeError(f"served {len(lines)} of {len(paths)}")
    return t0, loads, decodes, lines


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_serve: no CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    cfg = get_preset("msrvtt_attn_beam5")
    T, D = cfg.data.num_frames, cfg.data.feature_dim
    words = SPECIALS + [f"w{i}" for i in range(16_000 - len(SPECIALS))]
    vocab = Vocab({w: i for i, w in enumerate(words)}, words)
    cap = Captioner.from_checkpoint(cfg, CaptionDataset(
        np.zeros((1, T, D), np.float32), ["x"], {"x": []}, cfg.data,
        vocab=vocab))
    server = CaptionServer(cfg, cap, batch_size=B, method="beam",
                           max_wait_ms=50, pipeline_depth=1)
    g = np.random.default_rng(12)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, n in enumerate(g.integers(1, 41, FILES)):
            paths.append(os.path.join(tmp, f"v{i:03d}.npy"))
            np.save(paths[-1], g.normal(size=(int(n), D)).astype(np.float32))
        t = time.perf_counter()
        server.warmup()
        out["warmup_s"] = time.perf_counter() - t
        for run in range(RUNS):
            t0, loads, decodes, lines = serve_once(server, paths)
            ms = lambda x: round((x - t0) * 1e3, 3)
            out[f"run{run}"] = dict(
                batches=[dict(loads_done_ms=ms(loads[min(i + B, FILES) - 1]),
                              decode_ms=[ms(a), ms(z)],
                              last_line_ms=ms(lines[min(i + B, FILES) - 1]))
                         for i, (a, z) in zip(range(0, FILES, B), decodes)],
                first_load_ms=ms(loads[0]),
                decode_sum_ms=sum((z - a) * 1e3 for a, z in decodes),
                captions_per_s=FILES / (lines[-1] - t0))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
