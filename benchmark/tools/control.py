#!/usr/bin/env python3
"""The readings that set a cell's limits, on the card at the cell's own
size: the sound program's numbers on many seeds, and the control's.

    python3 benchmark/tools/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--control]

For the decode cells the control is the program's own lower-precision
path, the int8 vocab projection (``decode.int8_vocab_projection``); for
the training cell it is the reference computed in float8 (e4m3) in the
program's place (``benchmark/tools/scst_control.py``), with the faults of
``--fault``. Prints one JSON line a seed: the compared numbers and the
check's summary. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import common, harness  # noqa: E402

INT8 = ["decode.int8_vocab_projection=true"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True,
                    help="a cell's name or the path of its .json file")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args()
    cell = common.load_cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.time()
        if cell["traffic"] == "scst_train" and (args.control or args.fault):
            from benchmark.tools import scst_control
            numbers, data = scst_control.run(cell, seed, args.fault,
                                              control=args.control)
        else:
            r = harness.execute(cell["name"], seed, args.seconds, False,
                                "cuda:0", cell=cell,
                                program_overrides=INT8 if args.control
                                else None)
            numbers, data = r.numbers, {k: v for k, v in r.data.items()
                                        if k in ("check", "check_steps",
                                                 "calls", "steps")}
            numbers["e2e"] = r.e2e
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "fault": args.fault,
                          "numbers": numbers, "data": data,
                          "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
