"""Trainer: the device's busy time (the union of its activity, less the
loader's host-to-device copies) in the traced slice from the
``vidcap_phase_backward`` mark (autograd's backward pass) to the next
mark, over the whole steps in the slice, in ms a step
(``benchmark/inside.py::phase_seconds``)."""
from benchmark import inside


def read(r):
    return inside.phase_ms(r, "backward")
