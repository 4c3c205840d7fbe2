"""Trainer: the share of the traced slice's device time spent in
PyTorch's own elementwise and reduction kernels (names holding
``elementwise_kernel`` or ``reduce_kernel``), in %."""

KERNELS = r"elementwise_kernel|reduce_kernel"


def read(r):
    if r.tracer is None:
        return None
    total = sum(r.tracer.by_name().values())
    return r.tracer.device_s(KERNELS) / total * 100 if total else None
