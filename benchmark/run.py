#!/usr/bin/env python3
"""Benchmark of vidcap_tpu_torch, the PyTorch and CUDA port, on NVIDIA
GPUs: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace 0|1

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` (the
card's name, the count used, the peak device memory, its power limit; with
``--trace 1`` the busy and traced seconds), the traced run's
``breakdown``, and last ``compared``: each number the check compared,
with its limit. The same comparisons are the last lines of standard error.

Exits 2 without a CUDA device (or fewer than the cell asks for), never
falling back to the CPU, and 3 when JAX or the JAX package is loaded.
Build caches live in ``build/`` inside the checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
os.environ["USE_FLAX"] = "0"
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")

from benchmark import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    start_wall = common.process_start_wall()

    import torch
    cell = common.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"[bench] no CUDA device for {args.workload} (needs "
              f"{cell['chips']}, sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0})",
              file=sys.stderr)
        return 2
    from benchmark import harness
    r = harness.execute(args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda:0", cell=cell,
                        start_wall=start_wall)
    found = common.forbidden_modules()
    if found:
        print(f"[bench] JAX or the JAX package is loaded: {found}",
              file=sys.stderr)
        return 3
    e2e, layer = common.cell_metrics(args.workload)
    if args.trace:
        metrics = harness.layer_metrics(r, layer)
    else:
        metrics = {m["name"]: {"value": (r.setup_s if m["name"] == "setup_s"
                                         else r.e2e[m["name"]]),
                               "unit": m["unit"]} for m in e2e}
    checks = harness.verdict(r)
    correct = all(ok for *_, ok in checks)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": r.peak_bytes,
              "power_limit_w": common.power_limit_w()}
    out = {"correct": correct, "attempted": r.attempted, "failed": r.failed,
           "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = r.tracer.busy_s()
        device["window_s"] = r.tracer.window_s
        out["breakdown"] = r.tracer.breakdown(r.spans)
    out["compared"] = {n: {"value": v, "limit": lim} for n, v, lim, _ in
                       checks}
    print(f"[bench] {args.workload} seed {args.seed}: set-up {r.setup_s:.2f} "
          f"s, window {r.data.get('window_s', 0):.2f} s, profiler stop "
          f"{r.data.get('profiler_stop_s', 0):.2f} s, check "
          f"{r.data.get('check_s', 0):.2f} s, whole run "
          f"{time.time() - start_wall:.2f} s; {r.data.get('summary', '')}",
          file=sys.stderr)
    for n, v, lim, ok in checks:
        print(f"[bench] {n} {v} limit {lim} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
