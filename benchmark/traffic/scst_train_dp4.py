"""Data-parallel SCST training on the cell's cards, as ``train --sharded``
runs it at a data axis of the world: one process a card
(``parallel/distributed.py::spawn``), ``rows_per_rank`` rows a rank, the
gradient all-reduce inside each rank's captured step (``benchmark/dp4.py``
runs a rank).

Parameters (the cell's ``traffic_params``): ``rows_per_rank``, ``corpus``,
``max_steps``, ``check_steps`` (3), ``pace_steps`` (the steps that fix the
window's count), ``trace_units`` steps profiled on rank 0 in a ``--trace
1`` run, ``spawn_timeout_s``.

End to end: ``train_videos_per_s``, all ranks' rows of the window's steps
over rank 0's window. Set-up runs from this process's start to rank 0's
first timed step. The check: rank 0's first ``check_steps`` steps against
the reference over the whole global batch (``scst_train._check``: the
loss, the first gradient, the change after the steps, the greedy
rollouts), and ``rank_param_gap``, the largest difference of any
parameter between a rank and rank 0 after the window.
"""
from __future__ import annotations


def run(r) -> None:
    from benchmark import dp4
    from vidcap_tpu_torch.parallel.distributed import spawn
    out = spawn(dp4.worker, r.cell["chips"],
                args=(r.name, r.cell, r.seed, r.seconds, r.trace,
                      r.start_wall),
                device="cpu" if r.device.type == "cpu" else "cuda",
                timeout=r.params["spawn_timeout_s"])[0]
    r.setup_s = out["setup_s"]
    r.e2e, r.data, r.numbers = out["e2e"], out["data"], out["numbers"]
    r.tracer = out["tracer"]
    r.spans.items = out["spans"]
    r.peak_bytes = out["peak_bytes"]
    r.attempted, r.failed = out["attempted"], out["failed"]
