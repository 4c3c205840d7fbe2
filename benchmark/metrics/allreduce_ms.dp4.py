"""Trainer, across the cards: rank 0's exposed all-reduce, the device time
of its NCCL kernels in the traced slice that no other activity of its card
overlaps, over the traced steps, in ms a step."""
from benchmark import inside

NCCL = "nccl"


def read(r):
    steps = r.params.get("trace_units")
    if r.tracer is None or not steps:
        return None
    ev = r.tracer.in_slice()
    comm = inside.merge((a, b) for n, a, b in ev if NCCL in n.lower())
    if not comm:
        return None
    other = inside.merge((a, b) for n, a, b in ev if NCCL not in n.lower())
    exposed = sum((b - a) - inside.covered(other, a, b) for a, b in comm)
    return exposed / steps * 1e3
