"""Experts: the routed and shared experts' products of the traced slice's
whole decode steps (``flops_kimi.moe_flops_per_step``: every row's
``num_experts_per_tok`` routed experts and its shared experts, in every
expert layer) over the device time of the product kernels in the expert
phases (``lm_marks.GEMM``: the grouped GEMMs, the shared experts' and the
router's products), in % of the H100's bf16 peak."""
from benchmark import flops, flops_kimi, lm_marks


def read(r):
    got = lm_marks.read(r)
    if not got or got[1] <= 0:
        return None
    rows = r.data["batch"] * r.data["beam"]
    work = flops_kimi.moe_flops_per_step(r.cfg, rows) * got[2]
    return work / (got[1] * flops.PEAK_BF16) * 100
