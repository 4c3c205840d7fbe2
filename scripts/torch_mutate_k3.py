#!/usr/bin/env python3
"""Mutation check m3 of K3 on one NVIDIA GPU: does phase 6 of chip_smoke.py
catch a pick that breaks cross-block ties the wrong way?

    python3 scripts/torch_mutate_k3.py

Copies ``vidcap_tpu_torch/`` and ``chip_smoke.py`` into a temporary
directory (removed at the end) and there orders K3's cross-block ties to
the larger column: the atomic pick key's column order and the merge's
block-order comparisons (``csrc/rollout.cu``). Then runs
``chip_smoke.phase_k3()`` once from the checkout (the sound kernel, which
must pass) and once from the copy (which must fail, on the all-equal-logits
check). Prints each run's exit code and its verdict; exits 0 when both come
out as they must.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MUTATIONS = [
    ("(0xFFFFFFFFu - (unsigned)col);", "(unsigned)col;"),
    ("(int)(0xFFFFFFFFu - (unsigned)key);", "(int)(unsigned)key;"),
    ("    if (before(vn[i], vi[i], bv, bi)) {",
     "    if (vn[i] > bv || (vn[i] == bv && vi[i] > bi)) {"),
    ("    if (before(ov, oi, bv, bi)) {\n      bv = ov;\n      bi = oi;\n"
     "      bc = oc;",
     "    if (ov > bv || (ov == bv && oi > bi)) {\n      bv = ov;\n"
     "      bi = oi;\n      bc = oc;"),
]
PHASE6 = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as cs; "
          "torch.backends.cuda.matmul.allow_tf32 = False; cs.phase_k3(); "
          "print('phase 6 passed')")


def mutate(mut: str) -> None:
    """The port and chip_smoke.py copied into ``mut``, K3's ties reversed."""
    shutil.copytree(os.path.join(REPO, "vidcap_tpu_torch"),
                    os.path.join(mut, "vidcap_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), mut)
    path = os.path.join(mut, "vidcap_tpu_torch", "csrc", "rollout.cu")
    with open(path) as f:
        src = f.read()
    for old, new in MUTATIONS:
        if src.count(old) != 1:
            raise RuntimeError(f"the code to mutate is not in rollout.cu: {old}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)


def main() -> int:
    verdicts = {}
    with tempfile.TemporaryDirectory(prefix="mut3-") as mut:
        mutate(mut)
        for name, cwd in (("sound", REPO), ("m3", mut)):
            r = subprocess.run([sys.executable, "-c", PHASE6], cwd=cwd,
                               capture_output=True, text=True, timeout=900,
                               env={**os.environ, "PYTHONPATH": cwd})
            lines = [ln[:600] for ln in (r.stdout + r.stderr).splitlines()
                     if "passed" in ln or "FAIL" in ln]
            verdicts[name] = r.returncode
            print(name, "exit", r.returncode, lines, flush=True)
    return 0 if verdicts == {"sound": 0, "m3": 1} else 1


if __name__ == "__main__":
    sys.exit(main())
