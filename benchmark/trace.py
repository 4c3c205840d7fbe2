"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` (CUPTI) over
a fixed count of whole decodes or steps, kept in memory, and its reduction
to device-busy time, device time by kernel name and idle gaps named by the
benchmark's own spans.

The profiler records the card's activity only (kernels, copies, sets), so
the host pays little for it. A spin kernel launched right after a
synchronise at a known host time ties the device clock to
``time.perf_counter``. Busy time is the union of the device intervals
inside the slice; an idle gap is named by the innermost benchmark span
that covers its middle on the host, or "no benchmark span".
"""
from __future__ import annotations

import collections
import re
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

MARKER = "spin_kernel"


def _events(prof) -> List[Tuple[str, float, float]]:
    """(name, start us, duration us) of every device activity."""
    out = []
    dev = torch.autograd.DeviceType.CUDA
    try:
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != dev:
                continue
            if hasattr(e, "start_ns"):
                out.append((e.name(), e.start_ns() / 1e3,
                            e.duration_ns() / 1e3))
            else:
                out.append((e.name(), float(e.start_us()),
                            float(e.duration_us())))
    except AttributeError:
        for e in prof.events():
            if e.device_type == dev:
                out.append((e.name, float(e.time_range.start),
                            float(e.time_range.elapsed_us())))
    return out


class Trace:
    """Profile the card between :meth:`start` and :meth:`stop`; the slice
    that counts is set by :meth:`mark_start` / :meth:`mark_end` (host
    ``perf_counter`` after a synchronise)."""

    def __init__(self):
        self.prof = None
        self.t_marker = None
        self.s0 = self.s1 = None
        self.events: List[Tuple[str, float, float]] = []

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.t_marker = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def mark_start(self) -> None:
        torch.cuda.synchronize()
        self.s0 = time.perf_counter()

    def mark_end(self) -> None:
        torch.cuda.synchronize()
        self.s1 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.prof.stop()
        events = _events(self.prof)
        self.prof = None
        marks = [e for e in events if MARKER in e[0]]
        if not marks:
            raise RuntimeError("the profiler recorded no marker kernel: no "
                               "device activity was traced")
        # host seconds of device time 0
        off = self.t_marker - marks[0][1] / 1e6
        self.events = [(n, off + s / 1e6, d / 1e6) for n, s, d in events
                       if MARKER not in n]

    # ------------------------------------------------------------ reduction

    def in_slice(self) -> List[Tuple[str, float, float]]:
        """(name, start s, end s) of device activity clipped to the slice."""
        if getattr(self, "_slice", None) is not None:
            return self._slice
        out = []
        for n, s, d in self.events:
            a, b = max(s, self.s0), min(s + d, self.s1)
            if b > a:
                out.append((n, a, b))
        self._slice = out
        return out

    @property
    def window_s(self) -> float:
        return self.s1 - self.s0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        iv = sorted((a, b) for _, a, b in self.in_slice())
        merged: List[List[float]] = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def by_name(self) -> Dict[str, float]:
        """Device seconds by activity name inside the slice."""
        acc: Dict[str, float] = collections.defaultdict(float)
        for n, a, b in self.in_slice():
            acc[n] += b - a
        return dict(acc)

    def device_s(self, pattern: str) -> float:
        """Device seconds inside the slice of activities whose name matches
        the regular expression ``pattern``."""
        rx = re.compile(pattern)
        return sum(b - a for n, a, b in self.in_slice() if rx.search(n))

    def idle_gaps(self, spans) -> Dict[str, float]:
        """Idle device seconds inside the slice, by the innermost
        benchmark span covering each gap's middle on the host."""
        acc: Dict[str, float] = collections.defaultdict(float)
        edges = [self.s0] + [x for iv in self.busy_intervals() for x in iv] \
            + [self.s1]
        inside = [(n, t0, t1) for n, _, t0, t1 in spans.items
                  if t1 >= self.s0 and t0 <= self.s1]
        names = [n for n, _, _ in inside]
        t0 = np.array([a for _, a, _ in inside])
        t1 = np.array([b for _, _, b in inside])
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            cover = np.flatnonzero((t0 <= mid) & (mid <= t1)) \
                if inside else []
            name = (names[cover[np.argmin(t1[cover] - t0[cover])]]
                    if len(cover) else "no benchmark span")
            acc[name] += b - a
        return dict(acc)

    def breakdown(self, spans) -> Dict[str, list]:
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.by_name()),
                "idle_gaps": top(self.idle_gaps(spans))}
