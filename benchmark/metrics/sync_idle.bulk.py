"""Decode loop: the device's idle time in the traced slice after each of
the program's ``beam.exit_check`` spans (the host read of the beam loop's
finish test): from the end of the device-to-host copy the read waits for
to the next device activity, on the device's clock
(``benchmark/inside.py::sync_idle``), in % of the slice."""
from benchmark import inside


def read(r):
    spans = inside.program_spans(r)
    if not spans:
        return None
    return inside.sync_idle(spans, r.tracer.in_slice(), r.tracer.s0,
                            r.tracer.s1)
