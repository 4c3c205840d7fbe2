"""The whole decode: the model FLOPs of the window's decodes
(``flops.init_flops_per_video`` a video a call, ``flops.
step_flops_per_row`` for every beam of every video at each step the
decodes ran) over the window's wall time at the H100's bf16 peak, in %."""
from benchmark import flops, weights


def read(r):
    if not r.data.get("calls"):
        return None
    s, B, K = weights.sizes(r.cfg), r.data["batch"], r.data["beam"]
    total = (r.data["calls"] * B * flops.init_flops_per_video(
        s["D"], s["H"], s["A"], s["T"])
        + r.data["steps"] * B * K * flops.step_flops_per_row(
            s["E"], s["H"], s["A"], s["T"], s["Vp"]))
    return total / (r.data["window_s"] * flops.PEAK_BF16) * 100
