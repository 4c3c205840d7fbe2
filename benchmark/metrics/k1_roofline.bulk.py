"""K1 ``beam_core``: the least time its bytes allow at the H100's HBM
bandwidth (every input once, ``flops.k1_bytes``; it is bound by bytes),
over its device time a launch in the traced slice (the kernels of
``csrc/recurrent.cuh`` it launches, over the launches the program
counted), in % of that roofline."""
from benchmark import flops, weights

KERNELS = r"\b(pack_kernel|attention_kernel|rec_gemm_kernel)\b"


def read(r):
    n = (r.data.get("trace_launches") or {}).get("beam_core", 0)
    if r.tracer is None or not n:
        return None
    t = r.tracer.device_s(KERNELS) / n
    if t <= 0:
        return None
    s, B, K = weights.sizes(r.cfg), r.data["batch"], r.data["beam"]
    bound = flops.bound_s(
        flops.k1_flops(B * K, s["E"], s["H"], s["A"], s["T"]),
        flops.k1_bytes(B * K, B, s["E"], s["H"], s["A"], s["T"]))
    return bound / t * 100
