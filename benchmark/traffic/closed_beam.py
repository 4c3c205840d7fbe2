"""Closed-loop bulk captioning: back-to-back ``Captioner.decode_batch``
calls (beam search) on batches of distinct videos, each call's features
taken in turn from a seeded pool of host batches, so that every call
uploads new data.

Parameters (the cell's ``traffic_params``): ``batch`` videos a call,
``beam_width``, ``pool_batches`` host batches in the pool,
``warm_decodes`` decodes of pool batches before the window, ``trace_units``
decodes profiled in a ``--trace 1`` run, ``check_rows`` rows the reference
judges.

End to end: ``captions_per_s``, the captions the window's calls returned
over the window. A ``--trace 1`` run measures the same window, then
profiles ``trace_units`` more decodes after it (``_traced_slice``), so
that neither the profiler nor the spans inside a decode reach the
window's numbers. The check: a sample of the window's rows, drawn from
the seed and with the longest caption in it, judged token by token
(``reference/decode_check.py``); and every returned row well formed.
"""
from __future__ import annotations

import time

import numpy as np

from benchmark import corpus, weights
from benchmark import program as bc


def run(r) -> None:
    p = r.params
    B, K = p["batch"], p["beam_width"]
    cap, W = bc.captioner(r)
    s = weights.sizes(r.cfg)
    pool = [corpus.features(B, s["T"], s["D"], r.seed, r.device, salt=i + 1)
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
    r.memory_peak()
    del cap
    r.free()

    # the check: rows of the window's calls, the longest among them
    t_check = time.perf_counter()
    toks = np.stack(outs)                                  # [n, B, L]
    r.numbers["malformed_rows"] = float(bc.malformed(toks.reshape(
        n * B, -1), s["V"]))
    rng = np.random.default_rng(np.random.SeedSequence([r.seed, 0x43484B]))
    flat = rng.choice(n * B, size=min(p["check_rows"], n * B), replace=False)
    lengths = bc.lengths(toks.reshape(n * B, -1))
    flat = np.unique(np.append(flat, int(np.argmax(lengths))))
    call, row = flat // B, flat % B
    feats = np.stack([pool[c % len(pool)][b] for c, b in zip(call, row)])
    r.numbers.update(bc.judge(r, W, feats, toks[call, row], K))
    r.failed = int(r.numbers["malformed_rows"])
    r.data["check_s"] = time.perf_counter() - t_check


def _traced_slice(r, cap, pool, K) -> None:
    """After the window, with the spans inside a decode installed: the
    profiler over ``trace_units`` whole decodes of pool batches. The
    window's metrics never see the profiler or those spans."""
    bc.inner_spans(r)
    launches0 = bc.launches()
    r.start_slice()
    for i in range(r.params["trace_units"]):
        with r.spans.span("captioner.decode_batch"):
            cap.decode_batch(pool[i % len(pool)], method="beam",
                             beam_width=K)
    r.data["trace_launches"] = bc.launches_since(launches0)
    r.end_slice()
