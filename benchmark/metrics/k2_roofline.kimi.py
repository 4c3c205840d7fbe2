"""K2 ``topk_project`` at the head (hidden 2,048, vocab 163,840, its rows
streamed through the ring): the least time its operations allow at the
H100's bf16 peak (``flops_kimi.k2_flops``; it is bound by operations) over
its device time a launch in the traced slice (the kernels of
``csrc/topk_project.cu`` it launches, over the launches the program
counted), in % of that roofline."""
from benchmark import flops, flops_kimi

KERNELS = r"\b(cast_kernel|chunk_kernel|chunk_stream_kernel|merge_kernel)\b"


def read(r):
    n = (r.data.get("trace_launches") or {}).get("topk_project", 0)
    if r.tracer is None or not n:
        return None
    t = r.tracer.device_s(KERNELS) / n
    if t <= 0:
        return None
    rows, K = r.data["batch"] * r.data["beam"], r.data["beam"]
    bound = flops.bound_s(flops_kimi.k2_flops(rows, r.cfg),
                          flops_kimi.k2_bytes(rows, r.cfg, K))
    return bound / t * 100
