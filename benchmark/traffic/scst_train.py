"""SCST training steps back to back, as ``train/loop.py::train`` dispatches
them for the configuration: ``make_scst_step_body`` (its reward tables
built at set-up) under ``make_step`` (one CUDA graph a step on the card),
batches from the port's ``DeterministicBatcher`` staged by the loop's own
``_stage`` (pinned buffers, a copy on a side stream, one worker thread). No
validation, no checkpoints, no log reads.

The corpus (``corpus.captions``) and its features are made from the seed
and given to the port as an in-memory ``CaptionDataset``. Parameters (the
cell's ``traffic_params``): ``corpus`` (the generator's parameters),
``max_steps`` (the optimizer's tables), ``check_steps`` (3), and
``trace_units`` steps profiled in a ``--trace 1`` run.

Set-up builds one train state, drives it through the first
``check_steps`` steps through the window's own call and feed, keeping each
step's loss, batch and rollout tokens, the first gradient as the
optimizer holds it after one step, and the parameters after the last;
the window continues with the same state. End to end:
``train_videos_per_s``, the batch rows of the window's completed steps
over the window. A ``--trace 1`` run measures the same window, then
profiles ``trace_units`` more steps after it.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np
import torch

from benchmark import corpus, weights
from benchmark import program as bc

B1 = 0.9


def run(r) -> None:
    from vidcap_tpu_torch.data.loader import CaptionDataset
    from vidcap_tpu_torch.data.pipeline import DeterministicBatcher
    from vidcap_tpu_torch.models.model import create_model
    from vidcap_tpu_torch.train.loop import _stage
    from vidcap_tpu_torch.train.scst import make_scst_step_body
    from vidcap_tpu_torch.train.state import create_train_state
    from vidcap_tpu_torch.train.steps import make_step
    p, dev = r.params, r.device
    s = weights.sizes(r.cfg)
    cfg = r.program_config()
    t = [time.perf_counter()]
    caps = corpus.captions(p["corpus"], r.seed)
    feats = corpus.features(len(caps), s["T"], s["D"], r.seed, dev, salt=1)
    t.append(time.perf_counter())
    ds = CaptionDataset(feats, list(caps), caps, cfg.data)
    t.append(time.perf_counter())
    if ds.vocab.size != s["V"]:
        raise RuntimeError(f"the corpus fills {ds.vocab.size} vocabulary "
                           f"entries, the configuration {s['V']}")
    W0 = weights.make(r.cfg, r.seed, dev)
    model = create_model(cfg, vocab_size=ds.vocab.size).to(dev)
    weights.load_into(model, W0)
    model.train()
    state = create_train_state(cfg, model, seed=r.seed,
                               num_steps=p["max_steps"])
    body = make_scst_step_body(cfg, ds)
    t.append(time.perf_counter())
    kept: Dict[str, torch.Tensor] = {}
    rollouts = body.rollouts

    def keep_rollouts(*a, **k):
        sample, greedy = rollouts(*a, **k)
        kept["sample"], kept["greedy"] = sample.tokens, greedy.tokens
        return sample, greedy

    body.rollouts = keep_rollouts

    def step_body(st, batch):
        st, m = body(st, batch)
        return st, {**m, "bench_sample": kept["sample"],
                    "bench_greedy": kept["greedy"]}

    step_body.seeds_per_step = body.seeds_per_step
    step_fn = make_step(step_body, dev)

    it = DeterministicBatcher(ds, cfg.train.batch_size, seed=r.seed)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    pool = ThreadPoolExecutor(max_workers=1)

    def staged_batch():
        with r.spans.span("loader.stage"):
            return _stage(it, 1, False, dev, side, None, 1)

    def take(fut):
        with r.spans.span("loader.wait"):
            batch, ev, _ = fut.result()
        if ev is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(ev)
            for v in batch.values():
                v.record_stream(cur)
        return batch

    B = cfg.train.batch_size
    staged = pool.submit(staged_batch)
    steps = []
    g1 = d3 = None
    try:
        for i in range(p["check_steps"]):
            batch = take(staged)
            state, m = step_fn(state, batch)
            staged = pool.submit(staged_batch)
            r.sync()
            steps.append({k: batch[k].cpu().numpy() for k in
                          ("video_idx", "tokens", "attributes")})
            steps[-1].update(loss=float(m["loss"]),
                             sample=m["bench_sample"].cpu().numpy(),
                             greedy=m["bench_greedy"].cpu().numpy())
            if i == 0:
                g1 = {n: float((mu / (1 - B1)).norm())
                      for n, mu in state.opt_state["mu"].items()}
        d3 = {n: float((q.detach() - W0[n]).norm())
              for n, q in state.params.items()}
        t.append(time.perf_counter())
        r.data["summary"] = (
            "set-up: corpus and features {:.2f} s, dataset {:.2f} s, "
            "model and reward tables {:.2f} s (tables {:.2f} s, {} "
            "counter), first steps {:.2f} s".format(
                t[1] - t[0], t[2] - t[1], t[3] - t[2], body.tables_seconds,
                body.tables.counter, t[4] - t[3]))

        n_steps = 0
        r.window_started()
        t0 = time.perf_counter()
        while state.step < p["max_steps"] and \
                time.perf_counter() - t0 < r.seconds:
            batch = take(staged)
            with r.spans.span("trainer.dispatch"):
                state, m = step_fn(state, batch)
            staged = pool.submit(staged_batch)
            n_steps += 1
        r.sync()
        window = time.perf_counter() - t0
        if r.trace:
            # after the window: the profiler over trace_units more steps
            launches0 = bc.launches()
            r.start_slice()
            for _ in range(p["trace_units"]):
                batch = take(staged)
                with r.spans.span("trainer.dispatch"):
                    state, m = step_fn(state, batch)
                staged = pool.submit(staged_batch)
            r.sync()
            r.data["trace_launches"] = bc.launches_since(launches0)
            r.end_slice()
    finally:
        pool.shutdown(wait=True)
    r.e2e["train_videos_per_s"] = n_steps * B / window
    r.data.update(window_s=window, steps=n_steps, batch=B)
    r.attempted = n_steps * B
    r.memory_peak()
    del state, step_fn, body, model, kept, m, batch
    r.free()
    t_check = time.perf_counter()
    _check(r, caps, feats, W0, steps, g1, d3)
    r.data["check_s"] = time.perf_counter() - t_check


def _check(r, caps, feats, W0, steps, g1, d3) -> None:
    from benchmark.reference import decode_check
    from benchmark.reference import model as refm
    from benchmark.reference import scst as ref
    from benchmark.reference.captions import Corpus
    dev, c = r.device, r.cfg
    refm.full_f32()
    cd = getattr(torch, c["compute_dtype"])
    corp = Corpus(caps, c["vocab_size"], c["min_word_count"],
                  c["max_caption_len"], c["num_attributes"])
    W = {n: t.detach().clone().requires_grad_(True) for n, t in W0.items()}
    adam = ref.Adam(W, c["scst_learning_rate"])
    unmatched = attr_rows = 0
    loss_gap = greedy_gap = -np.inf
    g_ref = None
    for i, st in enumerate(steps):
        vidx = st["video_idx"]
        for row, v in zip(st["tokens"].tolist(), vidx):
            unmatched += row not in corp.encoded[corp.video_ids[int(v)]]
        attrs = corp.attributes[vidx]
        attr_rows += int((st["attributes"] != attrs).any(1).sum())
        f = torch.as_tensor(feats[vidx], device=dev)
        Wd = {n: w.detach() for n, w in W.items()}
        gaps = decode_check.token_gaps(
            Wd, feats[vidx], np.ones((len(vidx), feats.shape[1]), np.float32),
            st["greedy"], 1, c["vocab_size"], cd, dev)
        greedy_gap = max(greedy_gap, float(gaps[np.isfinite(gaps)].max()))
        total, parts = ref.loss(
            W, corp, f, vidx, torch.as_tensor(st["tokens"], device=dev),
            torch.as_tensor(st["sample"], device=dev),
            torch.as_tensor(st["greedy"], device=dev),
            torch.as_tensor(attrs, device=dev), c, cd)
        t = float(total.detach())
        loss_gap = max(loss_gap, abs(st["loss"] - t) / max(abs(t), 1e-6))
        g = ref.clipped_grads(W, total, c["grad_clip_norm"])
        if i == 0:
            g_ref = {n: float(x.norm()) for n, x in g.items()}
        adam.update(W, g)
        r.data.setdefault("check_steps", []).append(
            {"program_loss": st["loss"], "reference_loss": t,
             **{k: float(v.detach()) for k, v in parts.items()}})
    med_g = float(np.median(list(g_ref.values())))
    grad_gap = max(abs(g1[n] - g_ref[n]) / max(g_ref[n], med_g)
                   for n in g_ref)
    d_ref = {n: float((W[n].detach() - W0[n]).norm()) for n in W}
    moved = [n for n in W if g_ref[n] >= 1e-3 * med_g]
    med_d = float(np.median([d_ref[n] for n in moved]))
    change_gap = max(abs(d3[n] - d_ref[n]) / max(d_ref[n], med_d)
                     for n in moved)
    r.data["summary"] = r.data.get("summary", "") + (
        "; left out of the change (reference gradient under 1e-3 of the "
        "median leaf's): {}".format(sorted(set(W) - set(moved)) or "none"))
    r.numbers.update(loss_gap=loss_gap, grad_leaf_gap=grad_gap,
                     change_leaf_gap=change_gap, greedy_gap=greedy_gap,
                     batch_rows_unmatched=float(unmatched),
                     attribute_rows_unmatched=float(attr_rows))
    r.failed = 0
