"""K3 ``rollout``: the least time its operations and bytes allow
(``flops.k3_flops``, ``flops.k3_bytes``: a whole rollout of the batch's
rows over ``max_len`` steps), over its device time a launch in the traced
slice (``rollout_kernel``, over the launches the program counted), in %
of that roofline."""
from benchmark import flops, weights

KERNELS = r"\brollout_kernel\b"


def read(r):
    n = (r.data.get("trace_launches") or {}).get("rollout", 0)
    if r.tracer is None or not n:
        return None
    t = r.tracer.device_s(KERNELS) / n
    if t <= 0:
        return None
    s, B = weights.sizes(r.cfg), r.data["batch"]
    rows = min(B, 32)   # a launch takes at most 32 rows
    args = (rows, s["L"], s["E"], s["H"], s["A"], s["T"], s["Vp"])
    return flops.bound_s(flops.k3_flops(*args), flops.k3_bytes(*args)) \
        / t * 100
