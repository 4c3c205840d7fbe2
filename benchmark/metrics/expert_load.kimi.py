"""Experts: the load on the busiest expert, the most tokens an expert took
over the mean (tokens × experts a token ÷ experts), for each expert layer
of each decode step of the traced slice (the program's counter
``lm.expert_tokens``, kept only while tracing is on; the prefills'
counts, of another total, left out), averaged over them; 1.0 is an even
load."""


def read(r):
    counts = r.data.get("expert_tokens")
    if not counts:
        return None
    c = r.cfg
    slots = r.data["batch"] * r.data["beam"] * c["num_experts_per_tok"]
    mean = slots / c["n_routed_experts"]
    loads = [float(v.max()) / mean for _, v in counts if int(v.sum()) == slots]
    return sum(loads) / len(loads) if loads else None
