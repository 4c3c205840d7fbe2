"""Experts: the device's busy time (the union of its activity, less
host-to-device copies) in the expert layers' phases of each whole decode
step of the traced slice, from each ``vidcap_phase_lm_moe`` mark to the
next mark (``lm_marks.moe_seconds``), in ms a step."""
from benchmark import lm_marks


def read(r):
    got = lm_marks.read(r)
    return got[0] / got[2] * 1e3 if got else None
