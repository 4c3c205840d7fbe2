#!/usr/bin/env python3
"""The readings that set the language-model decode cell's limits, on the
card at the cell's own size: the sound program's numbers on many seeds,
and two controls that must fail.

    python3 benchmark/tools/lm_control.py --workload <cell> --seeds 1,2 \
        --seconds 10 [--control fp8|top5]

``fp8``: the routed experts' grouped products computed in float8 (e4m3):
each product's operands rounded to e4m3 at a scale that maps their
largest magnitude (the activations' whole, each expert's weight) to 448.
``top5``: one routed expert a token left out (top-5 of the published 6).
The reference stays the sound one. Prints one JSON line a seed: the
compared numbers and the check's record. The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import common, harness, lm_program  # noqa: E402

E4M3_MAX = 448.0


def e4m3(x: torch.Tensor, dims) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at a scale of its largest magnitude
    over ``dims`` (mapped to 448), back in its dtype."""
    s = x.abs().amax(dim=dims, keepdim=True).float().clamp_min(1e-30) \
        / E4M3_MAX
    return (x.float() / s).to(torch.float8_e4m3fn).float().mul(s).to(x.dtype)


def install(control: str) -> None:
    from vidcap_tpu_torch.models import lm_decoder as lm
    if control == "fp8":
        real = lm.grouped_mm
        lm.grouped_mm = lambda x, w, offs: real(
            e4m3(x, (0, 1)), e4m3(w, (1, 2)), offs)
    elif control == "top5":
        make = lm_program.captioner

        def captioner(r):
            cap, W = make(r)
            for m in cap.model.modules():
                if isinstance(m, (lm.MoE, lm.Router)):
                    m.cfg = dataclasses.replace(
                        m.cfg, num_experts_per_tok=m.cfg.num_experts_per_tok
                        - 1)
            return cap, W

        lm_program.captioner = captioner


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", choices=("fp8", "top5"), default=None)
    args = ap.parse_args()
    if args.control:
        install(args.control)
    cell = common.load_cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.time()
        r = harness.execute(cell["name"], seed, args.seconds, False,
                            "cuda:0", cell=cell)
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "control": args.control, "numbers": r.numbers,
                          "check": r.data.get("check"), "e2e": r.e2e,
                          "peak_bytes": r.peak_bytes,
                          "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
