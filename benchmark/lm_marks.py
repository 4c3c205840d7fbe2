"""Readings of the language-model decoder's phase marks in a ``--trace 1``
run: the program launches ``vidcap_phase_lm_attn`` before each layer's
attention, ``vidcap_phase_lm_mlp`` or ``vidcap_phase_lm_moe`` before its
dense MLP or its experts, and ``vidcap_phase_lm_head`` before each step's
head, on the device stream, while tracing is on
(``models/lm_decoder.py``). A phase runs from its mark to the next mark.

A decode step is the 2·layers marks before an ``lm_head`` mark; the
prefill's marks, which no ``lm_head`` closes, count in no step. Each
reader returns None without such marks (a program that launches none).
``events`` are (name, start, end) of device activity in seconds.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

from benchmark import inside

MARK = re.compile(r"\bvidcap_phase_(lm_[a-z]+)")
# the products' kernels: cuBLAS (sm90_xmma, nvjet), CUTLASS (grouped)
GEMM = re.compile(r"(?i)gemm|nvjet|cutlass|xmma")


def moe_phases(events: Sequence[tuple], layers: int
               ) -> List[List[Tuple[float, float]]]:
    """Each whole decode step's expert phases: (start, end) from each
    ``lm_moe`` mark to the mark after it."""
    marks = sorted((a, m.group(1)) for n, a, _ in events
                   if (m := MARK.search(n)))
    steps, since = [], []
    for a, name in marks:
        if name != "lm_head":
            since.append((a, name))
            continue
        own = since[-2 * layers:] + [(a, name)]
        if len(own) == 2 * layers + 1:
            steps.append([(x, y) for (x, nx), (y, _) in zip(own, own[1:])
                          if nx == "lm_moe"])
        since = []
    return steps


def moe_seconds(events: Sequence[tuple], layers: int
                ) -> Optional[Tuple[float, float, int]]:
    """(device-busy seconds in the steps' expert phases, of them the
    seconds of product kernels, whole steps); None without steps."""
    steps = moe_phases(events, layers)
    if not steps:
        return None
    busy = inside.merge((a, b) for n, a, b in events
                        if not inside.HTOD.search(n))
    gemm = inside.merge((a, b) for n, a, b in events if GEMM.search(n))
    ivs = [iv for step in steps for iv in step]
    return (sum(inside.covered(busy, a, b) for a, b in ivs),
            sum(inside.covered(gemm, a, b) for a, b in ivs), len(steps))


def read(r) -> Optional[Tuple[float, float, int]]:
    """:func:`moe_seconds` of the traced slice, once a run."""
    if r.tracer is None:
        return None
    if not hasattr(r.tracer, "_lm_moe"):
        r.tracer._lm_moe = moe_seconds(r.tracer.in_slice(),
                                       r.cfg["num_hidden_layers"])
    return r.tracer._lm_moe
