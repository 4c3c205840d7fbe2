"""Readings from inside the program for the per-layer metrics of a
``--trace 1`` run: the program's own spans (``vidcap_tpu_torch/utils/
profiling.py::spans``, recorded while the traced slice's profiler runs)
and the training step's phase marks (the kernels ``vidcap_phase_<phase>``
a CUDA graph of the step replays), set against the slice's device
activity. Spans and device activity share ``time.perf_counter``: the
spans are taken on it, and ``trace.py`` ties the device clock to it with
one spin kernel. That tie sets device times early by the spin kernel's
launch latency (0.1–0.6 ms on the H100), so ``sync_idle`` measures on the
device's clock alone, and ``host_lead_ms`` reads only what stands far
above that error.

Each reader returns None where it finds nothing to read: outside a traced
run, and with a program that records no spans or launches no marks.
The arithmetic takes plain lists, so that the tests can pin it:
``events`` are (name, start, end) of device activity, ``spans`` the
program's (name, id, parent, thread, t0, t1), times in seconds.
"""
from __future__ import annotations

import bisect
import re
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

MARK = re.compile(r"\bvidcap_phase_([a-z]+)")
# host-to-device copies: the loader's staging, on its own stream
HTOD = re.compile(r"HtoD")
DTOH = re.compile(r"DtoH")
# the program's spans that each wait for one device-to-host copy
READS = ("beam.exit_check", "captioner.download")
PHASES = ("rollout", "reward", "loss", "backward", "update")

Interval = Tuple[float, float]


def program_spans(r) -> Optional[list]:
    """The program's spans that lie inside the traced slice, or None
    outside a traced run or where the program keeps no span store."""
    if r.tracer is None:
        return None
    try:
        from vidcap_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    s0, s1 = r.tracer.s0, r.tracer.s1
    return [s for s in read() if s0 <= s[4] and s[5] <= s1]


def named(spans: Sequence[tuple], name: str) -> List[tuple]:
    return [s for s in spans if s[0] == name]


def merge(intervals) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(merged: List[Interval], lo: float, hi: float) -> float:
    """Seconds of [lo, hi) that the merged intervals cover."""
    i = max(bisect.bisect_right(merged, (lo, float("inf"))) - 1, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < hi:
        a, b = merged[i]
        total += max(0.0, min(b, hi) - max(a, lo))
        i += 1
    return total


# ------------------------------------------------------------- the decode

def upload_ms(spans: Sequence[tuple]) -> Optional[float]:
    """The ``captioner.upload`` spans' seconds over the ``captioner.decode``
    spans' count, in ms a decode."""
    decodes = len(named(spans, "captioner.decode"))
    if not decodes:
        return None
    return sum(s[5] - s[4] for s in named(spans, "captioner.upload")) \
        / decodes * 1e3


def idle_after(ends: Sequence[float], busy: List[Interval],
               s1: float) -> float:
    """Device-idle seconds from each time in ``ends`` to the next device
    activity (or the slice's end ``s1``); none where other activity runs
    on past that time. ``busy``: merged device intervals."""
    starts = [a for a, _ in busy]
    total = 0.0
    for e in ends:
        i = bisect.bisect_right(starts, e)
        if i and busy[i - 1][1] > e:
            continue
        nxt = starts[i] if i < len(starts) else s1
        total += max(0.0, min(nxt, s1) - e)
    return total


def sync_idle(spans: Sequence[tuple], events: Sequence[tuple], s0: float,
              s1: float) -> Optional[float]:
    """The device idle after each host read of the decode loop's finish
    test (a ``beam.exit_check`` span), in % of the slice: from the end of
    the device-to-host copy that the read waits for to the next device
    activity, both on the device's clock. Each read of the program (an
    exit check or a ``captioner.download``) waits for one such copy, so
    the reads in host order and the copies in device order pair one to
    one; None where their counts differ."""
    reads = sorted((s[5], s[0]) for s in spans if s[0] in READS)
    copies = sorted((a, b) for n, a, b in events if DTOH.search(n))
    if s1 <= s0 or len(copies) != len(reads) or not any(
            name == "beam.exit_check" for _, name in reads):
        return None
    busy = merge((a, b) for _, a, b in events)
    ends = [b for (_, name), (_, b) in zip(reads, copies)
            if name == "beam.exit_check"]
    return idle_after(ends, busy, s1) / (s1 - s0) * 100


# ------------------------------------------------------- the training step

def marks(events: Sequence[tuple]) -> List[Tuple[float, str]]:
    """(start, phase) of each phase mark, in device order."""
    return sorted((a, m.group(1)) for n, a, _ in events
                  if (m := MARK.search(n)))


def whole_steps(events: Sequence[tuple]) -> List[List[Tuple[float, str]]]:
    """The marks of each step whose first ``rollout`` mark and whose
    ``end`` mark both lie in ``events``: a step runs from the first
    rollout mark after an end mark (or the slice's start) to the next end
    mark. Marks before a step's rollout or after the last end belong to
    steps the slice's edges cut, and are left out."""
    out, cur = [], None
    for a, phase in marks(events):
        if cur is None:
            if phase == "rollout":
                cur = [(a, phase)]
            continue
        cur.append((a, phase))
        if phase == "end":
            out.append(cur)
            cur = None
    return out


def phase_seconds(events: Sequence[tuple]) -> Tuple[Dict[str, float], int]:
    """(device-busy seconds by phase, summed over the whole steps; the
    number of whole steps). A phase's time is the union of the device
    activity other than host-to-device copies from its mark to the next
    mark; the interval after ``end`` (between steps) counts nowhere."""
    steps = whole_steps(events)
    busy = merge((a, b) for n, a, b in events if not HTOD.search(n))
    acc = dict.fromkeys(PHASES, 0.0)
    for step in steps:
        for (a, phase), (b, _) in zip(step, step[1:]):
            acc[phase] = acc.get(phase, 0.0) + covered(busy, a, b)
    return acc, len(steps)


def phase_ms(r, phase: str) -> Optional[float]:
    """The traced slice's device-busy ms a whole step in ``phase``; None
    without marks in the slice."""
    if r.tracer is None:
        return None
    cached = getattr(r.tracer, "_inside_phases", None)
    if cached is None:
        cached = r.tracer._inside_phases = phase_seconds(r.tracer.in_slice())
    acc, n = cached
    return acc[phase] / n * 1e3 if n else None


def host_lead_ms(events: Sequence[tuple], spans: Sequence[tuple]
                 ) -> Optional[float]:
    """The median over the whole steps j of the device start of step j's
    first ``rollout`` mark less the host end of the j-th
    ``dispatch.replay`` span, in ms: how far the host's launch of a step
    runs ahead of the card's start of it."""
    steps = whole_steps(events)
    replays = sorted(s[5] for s in named(spans, "dispatch.replay"))
    leads = [step[0][0] - t1 for step, t1 in zip(steps, replays)]
    return statistics.median(leads) * 1e3 if leads else None
