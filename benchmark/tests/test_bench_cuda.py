"""On the card: each cell runs from the checkout through ``run.py`` and
comes out correct. Skips without a CUDA device (decided in the test)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import common


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  common.manifest()["workloads"]])
def test_cell_runs_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2**31 + 99), "--seconds", "3", "--trace", "0"],
        cwd=common.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def test_no_card_exits_without_a_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         common.manifest()["workloads"][0]["name"], "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=common.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
