"""K5: the data movement around a mixture of experts' grouped GEMMs, as
Hopper kernels (csrc/moe.cu), and their plain PyTorch versions.

For N tokens of width H, each routed to k of E experts (``sel`` i64[N, k],
weights ``w`` f32[N, k]), the N·k flat pairs (token n's j-th expert is pair
n·k + j) are sorted by expert into slots:

    dispatch  order[slot] = pair, stable (ascending pair within an expert);
              counts[e], offs[e] = Σ counts[:e+1] (int32, the group ends);
              xs[slot] = x[order[slot] // k]
    silu_mul  bf16(bf16(silu(gate)) · up) of [gate | up]
    combine   h + bf16(bf16(Σ_j bf16(w[n, j]) · y[slot of (n, j)]) + shared)
              (f32 sum; without h, the plain version returns the inner sum)

The kernels compute the same: the dispatch bit for bit (a stable sort of
the ids is unique), silu_mul bit for bit (PyTorch's f32 arithmetic and two
roundings), the combine to one bf16 ulp (its f32 sum runs j = 0..k-1, the
batched product's in cuBLAS's order). Nothing reads a count on the host:
``torch.bincount`` on the card copies the ids' min and max to the host, the
kernels count on the card.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; it never falls back. The caller decides by
``ops/limits.py::moe_takes`` / ``silu_mul_takes`` which shapes go to the
kernels (``models/decoding.py::moe_kernels``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.ops.limits import moe_takes, silu_mul_takes

TILE = 1024   # flat pairs a block of the sort (csrc/moe.cu kTile)


@dataclasses.dataclass
class Dispatch:
    """The tokens sorted by expert: ``order`` i64[N·k] (each slot's flat
    pair), ``counts`` i64[E], ``offs`` i32[E] (each group's end slot, on
    the tokens' device), ``x`` [N·k, H] (the rows in slot order), and, from
    the kernel, ``slots`` i32[N·k] (each pair's slot; None from the plain
    version, whose combine sorts ``order`` back)."""

    order: torch.Tensor
    counts: torch.Tensor
    offs: torch.Tensor
    x: torch.Tensor
    slots: Optional[torch.Tensor] = None


def moe_dispatch_plain(sel: torch.Tensor, x: torch.Tensor,
                       experts: int) -> Dispatch:
    """The dispatch in PyTorch: a stable argsort of the flat ids, bincount
    and cumsum, and the rows gathered in that order."""
    k = sel.shape[1]
    flat = sel.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=experts)
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    return Dispatch(order, counts, offs, x[order // k])


def silu_mul_plain(gate_up: torch.Tensor) -> torch.Tensor:
    """bf16(bf16(silu(gate)) · up) of [gate | up] on the last axis (each
    op computes in f32 and rounds to the inputs' dtype)."""
    g, u = gate_up.chunk(2, dim=-1)
    return F.silu(g) * u


def moe_combine_plain(y: torch.Tensor, d: Dispatch, w: torch.Tensor,
                      shared: torch.Tensor,
                      h: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each token's k outputs back in its pairs' order, their sum weighted
    by the weights rounded to y's dtype (one batched product, f32 sums),
    plus ``shared``, plus ``h`` where given."""
    N, k = w.shape
    y = y[torch.argsort(d.order)].view(N, k, -1)
    routed = torch.bmm(w.to(y.dtype)[:, None, :], y)[:, 0]
    out = routed + shared
    return out if h is None else h + out


def _aligned(kernel: str, *named) -> None:
    for t, name in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must start on 16 bytes")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def moe_dispatch(sel: torch.Tensor, x: torch.Tensor,
                 experts: int) -> Dispatch:
    """sel i64[N, k] (ids in [0, experts)), x bf16[N, H] → :class:`Dispatch`
    with ``slots``; three launches (histogram, scan, scatter) counted as
    one ``moe_dispatch``."""
    if not x.is_cuda:
        return moe_dispatch_plain(sel, x, experts)
    N, H = x.shape
    k = sel.shape[1]
    if not moe_takes(k, experts, H):
        raise ValueError(f"moe_dispatch: k {k} of {experts} experts at "
                         f"hidden {H} (k 1..8, experts 1..256, hidden a "
                         "multiple of 8)")
    _build.require("moe_dispatch", ((sel, "sel", torch.int64, (N, k)),
                                    (x, "x", torch.bfloat16, (N, H))))
    _aligned("moe_dispatch", (x, "x"))
    M = N * k
    nb = -(-M // TILE)
    buf, (rank, bcount, base) = _build.scratch(
        x.device, (4 * M, 4 * nb * experts, 4 * nb * experts))
    dev = x.device
    order = torch.empty(M, dtype=torch.int64, device=dev)
    slots = torch.empty(M, dtype=torch.int32, device=dev)
    counts = torch.empty(experts, dtype=torch.int64, device=dev)
    offs = torch.empty(experts, dtype=torch.int32, device=dev)
    xs = torch.empty(M, H, dtype=x.dtype, device=dev)
    err = _build.entry("moe_dispatch", 10, 4)(
        sel.data_ptr(), x.data_ptr(), rank, bcount, base, order.data_ptr(),
        slots.data_ptr(), counts.data_ptr(), offs.data_ptr(), xs.data_ptr(),
        N, k, experts, H, _stream(x))
    _build.check(err, "moe_dispatch")
    _build.count_launch("moe_dispatch")
    return Dispatch(order, counts, offs, xs, slots)


def silu_mul(gate_up: torch.Tensor) -> torch.Tensor:
    """gate_up bf16[R, 2I] → bf16[R, I] (:func:`silu_mul_plain`)."""
    if not gate_up.is_cuda:
        return silu_mul_plain(gate_up)
    R, I2 = gate_up.shape
    if I2 % 2 or not silu_mul_takes(I2 // 2):
        raise ValueError(f"silu_mul: width {I2} must be twice a multiple "
                         "of 8")
    _build.require("silu_mul", ((gate_up, "gate_up", torch.bfloat16,
                                 (R, I2)),))
    _aligned("silu_mul", (gate_up, "gate_up"))
    out = torch.empty(R, I2 // 2, dtype=gate_up.dtype, device=gate_up.device)
    err = _build.entry("silu_mul", 2, 2)(gate_up.data_ptr(), out.data_ptr(),
                                         R, I2 // 2, _stream(gate_up))
    _build.check(err, "silu_mul")
    _build.count_launch("silu_mul")
    return out


def moe_combine(y: torch.Tensor, d: Dispatch, w: torch.Tensor,
                shared: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """y bf16[N·k, H] (rows in slot order), the dispatch's ``slots``, w
    f32[N, k], shared and h bf16[N, H] → h' bf16[N, H]
    (:func:`moe_combine_plain` with ``h``)."""
    if not y.is_cuda:
        return moe_combine_plain(y, d, w, shared, h)
    N, k = w.shape
    H = y.shape[1]
    if d.slots is None:
        raise ValueError("moe_combine: needs the kernel's dispatch (slots)")
    if not moe_takes(k, d.counts.numel(), H):
        raise ValueError(f"moe_combine: k {k} at hidden {H} (k 1..8, hidden "
                         "a multiple of 8)")
    bf16 = torch.bfloat16
    _build.require("moe_combine", (
        (y, "y", bf16, (N * k, H)), (d.slots, "slots", torch.int32, (N * k,)),
        (w, "w", torch.float32, (N, k)), (shared, "shared", bf16, (N, H)),
        (h, "h", bf16, (N, H))))
    _aligned("moe_combine", (y, "y"), (shared, "shared"), (h, "h"))
    out = torch.empty_like(h)
    err = _build.entry("moe_combine", 6, 3)(
        y.data_ptr(), d.slots.data_ptr(), w.data_ptr(), shared.data_ptr(),
        h.data_ptr(), out.data_ptr(), N, k, H, _stream(y))
    _build.check(err, "moe_combine")
    _build.count_launch("moe_combine")
    return out
