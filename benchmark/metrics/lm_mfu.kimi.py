"""The whole decode: the model FLOPs of the window's decodes
(``flops_kimi.decode_flops``: the prefill of each video, then each step of
each beam at the steps a decode ran) over the window's wall time at the
H100's bf16 peak, in %."""
from benchmark import flops, flops_kimi


def read(r):
    calls = r.data.get("calls")
    if not calls:
        return None
    steps = round(r.data["steps"] / calls)
    total = calls * flops_kimi.decode_flops(r.cfg, r.data["batch"],
                                            r.data["beam"], steps)
    return total / (r.data["window_s"] * flops.PEAK_BF16) * 100
