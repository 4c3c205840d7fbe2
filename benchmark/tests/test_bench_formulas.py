"""The frozen FLOP and byte formulas reproduce the kernel table's bounds
at K1, K2 and K3's shapes (PERF.md: K1 26.1 MB, 0.00778 ms; K2 15.1
GFLOP, 0.01524 ms; K3 18.4 GFLOP and 22.0 MB, 0.01863 ms)."""
from __future__ import annotations

import pytest

from benchmark import flops

E = H = A = 512
T, B, K = 26, 184, 5


def test_k1_bytes_bound():
    nbytes = flops.k1_bytes(B * K, B, E, H, A, T)
    assert nbytes / 1e6 == pytest.approx(26.1, abs=0.05)
    assert flops.bound_s(flops.k1_flops(B * K, E, H, A, T), nbytes) * 1e3 \
        == pytest.approx(0.00778, abs=5e-6)


def test_k2_operations_bound():
    ops = flops.k2_flops(B * K, H, 16000)
    assert ops / 1e9 == pytest.approx(15.1, abs=0.05)
    assert flops.bound_s(ops, flops.k2_bytes(B * K, H, 16000, K)) * 1e3 \
        == pytest.approx(0.01524, abs=5e-6)


def test_k3_operations_and_bytes():
    args = (32, 30, E, H, A, T, 12032)
    assert flops.k3_flops(*args) / 1e9 == pytest.approx(18.4, abs=0.05)
    assert flops.k3_bytes(*args) / 1e6 == pytest.approx(22.0, abs=0.05)
    assert flops.bound_s(flops.k3_flops(*args), flops.k3_bytes(*args)) \
        * 1e3 == pytest.approx(0.01863, abs=5e-6)


def test_model_flops():
    # a decode of 184 videos at 30 steps: 920 rows x 30 x 23.3 MFLOP
    d = flops.beam_decode_flops(B, K, 30, 1536, E, H, A, T, 16000)
    assert d / 1e12 == pytest.approx(0.652, abs=0.01)
    s = flops.scst_step_flops(32, 30, 1536, E, H, A, T, 12032, 400)
    assert s / 1e9 == pytest.approx(134.5, abs=0.5)
