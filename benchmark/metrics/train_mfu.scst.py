"""The whole step: the model FLOPs of the window's steps
(``flops.scst_step_flops``) over the window's wall time at the H100's
bf16 peak, in %."""
from benchmark import flops, weights


def read(r):
    if not r.data.get("steps"):
        return None
    s = weights.sizes(r.cfg)
    per = flops.scst_step_flops(r.data["batch"], s["L"], s["D"], s["E"],
                                s["H"], s["A"], s["T"], s["Vp"], s["NA"])
    return r.data["steps"] * per / (r.data["window_s"] * flops.PEAK_BF16) \
        * 100
