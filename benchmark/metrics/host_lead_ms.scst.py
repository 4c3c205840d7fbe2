"""Trainer: the median over the traced slice's whole steps of the card's
start of step j (its ``vidcap_phase_rollout`` mark) less the host's end
of the j-th ``dispatch.replay`` span (the graph's launch), in ms: how far
the host runs ahead of the card."""
from benchmark import inside


def read(r):
    spans = inside.program_spans(r)
    if not spans:
        return None
    return inside.host_lead_ms(r.tracer.in_slice(), spans)
