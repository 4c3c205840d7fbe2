"""The device: the share of the traced slice in which no operation ran on
the card (one less the union of its kernels', copies' and sets' intervals
over the slice), in %."""


def read(r):
    if r.tracer is None or not r.tracer.window_s:
        return None
    return (1 - r.tracer.busy_s() / r.tracer.window_s) * 100
