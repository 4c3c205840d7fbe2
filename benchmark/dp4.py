"""One rank of the data-parallel SCST cell (``traffic/scst_train_dp4.py``),
run by ``vidcap_tpu_torch/parallel/distributed.py::spawn`` in a process of
its own (rank r on card r, NCCL; gloo on the CPU in the tests).

Every rank builds what ``train --sharded`` builds at a data axis of the
world: the corpus and features from the seed, the same weights, a train
state, the SCST body with its reward tables, the step of
``make_sharded_step`` (one CUDA graph a step with the gradient all-reduce
inside), and batches from one ``DeterministicBatcher`` of the global batch
whose rows ``train/loop.py::_stage`` takes for the rank (a wrapper of the
body's ``rollouts`` keeps the rank's rollouts, as ``scst_train`` does). The
ranks run the
first ``check_steps`` steps with a host read after each, keeping (rank 0,
gathered over the ranks) the global batch and rollouts; then
``pace_steps`` steps that rank 0 times to fix the window's step count,
which it sends to the others, so that no step of the window waits for a
host decision; then the window; then, in a ``--trace 1`` run, the traced
steps, profiled on rank 0 alone. Rank 0 returns what the run reports, the
reference's check done on it.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from benchmark import corpus, harness, weights
from benchmark import program as bc

B1 = 0.9


def _gather(x: torch.Tensor, world: int) -> np.ndarray:
    """Every rank's rows of ``x``, in rank order (the global batch's)."""
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts).cpu().numpy()


def worker(rank: int, world: int, name: str, cell: Dict, seed: int,
           seconds: float, trace: bool, start_wall: float) -> Dict:
    from vidcap_tpu_torch.data.loader import CaptionDataset
    from vidcap_tpu_torch.data.pipeline import DeterministicBatcher
    from vidcap_tpu_torch.models.model import create_model
    from vidcap_tpu_torch.parallel.mesh import make_mesh
    from vidcap_tpu_torch.parallel.sharding import (make_sharded_step,
                                                    place_state)
    from vidcap_tpu_torch.train.loop import _stage
    from vidcap_tpu_torch.train.scst import make_scst_step_body
    from vidcap_tpu_torch.train.state import create_train_state
    dev = (torch.device("cuda", rank) if dist.get_backend() == "nccl"
           else torch.device("cpu"))
    lead = rank == 0
    p = cell["traffic_params"]
    B = p["rows_per_rank"] * world
    r = harness.Run(name, seed, seconds, trace and lead, dev, cell=cell,
                    program_overrides=[f"train.batch_size={B}"],
                    start_wall=start_wall)
    mesh = make_mesh(None, num_data=world, num_model=1, device=dev)
    s = weights.sizes(r.cfg)
    cfg = r.program_config()
    caps = corpus.captions(p["corpus"], seed)
    feats = corpus.features(len(caps), s["T"], s["D"], seed, dev, salt=1)
    ds = CaptionDataset(feats, list(caps), caps, cfg.data)
    W0 = weights.make(r.cfg, seed, dev)
    model = create_model(cfg, vocab_size=ds.vocab.size).to(dev)
    weights.load_into(model, W0)
    model.train()
    state = create_train_state(cfg, model, seed=seed,
                               num_steps=p["max_steps"])
    body = make_scst_step_body(cfg, ds)
    kept = {}
    rollouts = body.rollouts

    def keep_rollouts(*a, **k):
        sample, greedy = rollouts(*a, **k)
        kept["sample"], kept["greedy"] = sample.tokens, greedy.tokens
        return sample, greedy

    body.rollouts = keep_rollouts
    # the step train --sharded runs; ``kept`` holds the rank's rollouts of
    # the last step (on the card the captured graph's tensors, which each
    # replay refills)
    step_fn, dp = make_sharded_step(mesh, body)
    place_state(state, mesh, dp)
    it = DeterministicBatcher(ds, B, seed=seed)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    pool = ThreadPoolExecutor(max_workers=1)
    staged = pool.submit(_stage, it, 1, False, dev, side, mesh, 1)

    def take():
        nonlocal staged
        batch, ev, _ = staged.result()
        if ev is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(ev)
            for v in batch.values():
                v.record_stream(cur)
        staged = pool.submit(_stage, it, 1, False, dev, side, mesh, 1)
        return batch

    steps, g1 = [], None
    try:
        for i in range(p["check_steps"]):
            batch = take()
            state, m = step_fn(state, batch)
            rows = {k: _gather(batch[k], world)
                    for k in ("video_idx", "tokens", "attributes")}
            rows.update(loss=float(m["loss"]),
                        sample=_gather(kept["sample"], world),
                        greedy=_gather(kept["greedy"], world))
            steps.append(rows)
            if i == 0:
                g1 = {n: float((mu / (1 - B1)).norm())
                      for n, mu in state.opt_state["mu"].items()}
        d3 = {n: float((q.detach() - W0[n]).norm())
              for n, q in state.params.items()}
        # the window's step count, from rank 0's pace
        r.sync()
        t0 = time.perf_counter()
        for _ in range(p["pace_steps"]):
            state, m = step_fn(state, take())
        r.sync()
        pace = (time.perf_counter() - t0) / p["pace_steps"]
        n_steps = [max(1, round(seconds / pace))]
        dist.broadcast_object_list(n_steps, src=0)
        n_steps = n_steps[0]
        if lead:
            r.window_started()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            batch = take()
            with r.spans.span("trainer.dispatch"):
                state, m = step_fn(state, batch)
        r.sync()
        window = time.perf_counter() - t0
        if trace:
            launches0 = bc.launches()
            if lead:
                r.start_slice()
            for _ in range(p["trace_units"]):
                batch = take()
                with r.spans.span("trainer.dispatch"):
                    state, m = step_fn(state, batch)
            r.sync()
            r.data["trace_launches"] = bc.launches_since(launches0)
            if lead:
                r.end_slice()
        gap = torch.zeros((), device=dev)
        for q in state.params.values():
            q0 = q.detach().clone()
            dist.broadcast(q0, src=0)
            gap = torch.maximum(gap, (q.detach() - q0).abs().max())
        dist.all_reduce(gap, op=dist.ReduceOp.MAX)
        r.numbers["rank_param_gap"] = float(gap)
    finally:
        pool.shutdown(wait=True)
    r.e2e["train_videos_per_s"] = n_steps * B / window
    r.data.update(window_s=window, steps=n_steps, batch=B, ranks=world,
                  pace_s=pace)
    r.attempted = n_steps * B
    r.memory_peak()
    del state, step_fn, body, model, kept, m, batch
    r.free()
    if not lead:
        return {}
    from benchmark.traffic import scst_train
    t_check = time.perf_counter()
    scst_train._check(r, caps, feats, W0, steps, g1, d3)
    r.data["check_s"] = time.perf_counter() - t_check
    r.data["summary"] = (f"{world} ranks x {p['rows_per_rank']} rows, "
                         f"{n_steps} steps, pace {pace * 1e3:.2f} ms a step; "
                         + r.data.get("summary", ""))
    return {"setup_s": r.setup_s, "e2e": r.e2e, "data": r.data,
            "numbers": r.numbers, "tracer": r.tracer,
            "spans": r.spans.items, "peak_bytes": r.peak_bytes,
            "attempted": r.attempted, "failed": r.failed}
