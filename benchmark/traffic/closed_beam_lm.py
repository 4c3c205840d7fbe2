"""Closed-loop bulk captioning through a language-model decoder:
back-to-back ``Captioner.decode_batch`` calls (beam search) on batches of
distinct videos, each call's features taken in turn from a seeded pool of
host batches, so that every call uploads new data, as ``closed_beam``
does for the LSTM.

Parameters (the cell's ``traffic_params``): ``batch`` videos a call,
``beam_width``, ``pool_batches``, ``warm_decodes`` decodes before the
window, ``trace_units`` decodes profiled in a ``--trace 1`` run,
``check_rows`` rows the reference judges, ``margin``.

End to end: ``captions_per_s``, the captions the window's calls returned
over the window. A ``--trace 1`` run profiles ``trace_units`` more decodes
after the window, with the program's counter of tokens an expert kept for
``expert_load``. The check (``lm_program.judge``): ``check_rows`` of the
window's rows, drawn from the seed, and the longest; one more decode of
each pool batch they came from, recording each step's tokens, lineage,
experts and top-5 log-probs, taken before the program is freed; each
judged row found as a path of that decode; then the reference's full
forward of each through the experts the program chose on that path; and
every returned row well formed.
"""
from __future__ import annotations

import time

import numpy as np

from benchmark import corpus, lm_program
from benchmark import program as bc

TOP = 5   # the log-probs compared at each position


def run(r) -> None:
    p, c = r.params, r.cfg
    B, K = p["batch"], p["beam_width"]
    T, D = c["num_frames"], c["feature_dim"]
    cap, W = lm_program.captioner(r)
    pool = [corpus.features(B, T, D, r.seed, r.device, salt=i + 1)
            for i in range(p["pool_batches"])]
    cap.warmup("beam", B, K)
    for i in range(p["warm_decodes"]):
        cap.decode_batch(pool[i % len(pool)], method="beam", beam_width=K)
    calls0, steps0 = cap.decode_calls, cap.decode_steps
    outs = []
    r.window_started()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < r.seconds:
        feats = pool[len(outs) % len(pool)]
        with r.spans.span("captioner.decode_batch"):
            outs.append(cap.decode_batch(feats, method="beam",
                                         beam_width=K))
    window = time.perf_counter() - t0
    n = len(outs)
    r.e2e["captions_per_s"] = n * B / window
    r.data.update(window_s=window, calls=cap.decode_calls - calls0,
                  steps=cap.decode_steps - steps0, batch=B, beam=K)
    r.data["summary"] = (f"{n} decodes of {B} videos, "
                         f"{r.data['steps'] / n:.2f} steps a decode, "
                         f"{r.e2e['captions_per_s']:.2f} captions/s")
    if r.trace:
        _traced_slice(r, cap, pool, K)
    r.attempted = n * B

    # the check's rows, and the program's record of them
    t_check = time.perf_counter()
    toks = np.stack(outs).reshape(n * B, -1)
    r.numbers["malformed_rows"] = float(bc.malformed(toks, c["vocab_size"]))
    rng = np.random.default_rng(np.random.SeedSequence([r.seed, 0x4C4D43]))
    flat = rng.choice(n * B, size=min(p["check_rows"], n * B), replace=False)
    lengths = bc.lengths(toks)
    flat = np.unique(np.append(flat, int(np.argmax(lengths))))
    where = [((i // B) % len(pool), i % B) for i in flat]
    recs = {pb: lm_program.record_decode(cap, pool[pb], K, TOP)
            for pb in sorted({pb for pb, _ in where})}
    prog = lm_program.program_side(recs, where, toks[flat], lengths[flat], T)
    feats = np.stack([pool[pb][b] for pb, b in where])
    r.memory_peak()
    del cap, recs
    r.free()
    judged = lm_program.judge(c, W, feats, toks[flat], lengths[flat], prog,
                              p["margin"], r.device)
    r.data["check"] = {"rows": len(flat), **judged.pop("record")}
    r.numbers.update(judged)
    r.failed = int(r.numbers["malformed_rows"])
    r.data["check_s"] = time.perf_counter() - t_check


def _traced_slice(r, cap, pool, K) -> None:
    """After the window: the profiler over ``trace_units`` whole decodes,
    and the program's expert counter over them."""
    from vidcap_tpu_torch.utils import profiling
    launches0 = bc.launches()
    profiling.clear()
    r.start_slice()
    for i in range(r.params["trace_units"]):
        with r.spans.span("captioner.decode_batch"):
            cap.decode_batch(pool[i % len(pool)], method="beam",
                             beam_width=K)
    r.data["trace_launches"] = bc.launches_since(launches0)
    r.end_slice()
    read = getattr(profiling, "counters", None)
    r.data["expert_tokens"] = read("lm.expert_tokens") if read else None
