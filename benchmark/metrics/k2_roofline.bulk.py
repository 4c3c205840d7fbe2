"""K2 ``topk_project``: the least time its operations allow at the H100's
bf16 peak (the vocab projection, ``flops.k2_flops``; it is bound by
operations), over its device time a launch in the traced slice (the
kernels of ``csrc/topk_project.cu`` it launches, over the launches the
program counted), in % of that roofline."""
from benchmark import flops, weights

KERNELS = r"\b(cast_kernel|chunk_kernel|merge_kernel)\b"


def read(r):
    n = (r.data.get("trace_launches") or {}).get("topk_project", 0)
    if r.tracer is None or not n:
        return None
    t = r.tracer.device_s(KERNELS) / n
    if t <= 0:
        return None
    s, B, K = weights.sizes(r.cfg), r.data["batch"], r.data["beam"]
    bound = flops.bound_s(flops.k2_flops(B * K, s["H"], s["Vp"]),
                          flops.k2_bytes(B * K, s["H"], s["Vp"], K))
    return bound / t * 100
