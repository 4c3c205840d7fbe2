"""One run of one cell, without the look for a card: set-up, the measured
window, the traced slice, the per-layer readers, and the comparison that
decides ``correct``. ``run.py`` adds the look for a card and prints.

A cell's file (``workloads/<name>.json``) names its configuration, its
traffic kind (``traffic/<kind>.py``), the traffic's parameters and the
limit of each number its check compares. The traffic module's ``run(r)``
builds the program's objects, calls :meth:`Run.window_started` at the
first timed call, fills ``r.e2e``, ``r.data`` and ``r.numbers``; in a
``--trace 1`` run profiles a fixed count of further calls after the window
(:meth:`Run.start_slice`, :meth:`Run.end_slice`); and runs the reference
once :meth:`Run.memory_peak` has been read.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from benchmark import common


def program_config(bench_cfg: Dict, extra: Optional[List[str]] = None):
    """The program's ``Config``: the preset the configuration file names,
    with each of the file's numbers set where the program keeps it (a
    no-op at the published sizes; tests shrink the widths this way), and
    ``extra`` overrides ``section.field=value`` (the control's switch)."""
    from vidcap_tpu_torch.config import apply_overrides, get_preset
    where = bench_cfg["program_keys"]
    items = [f"{where[k]}={str(v).lower() if isinstance(v, bool) else v}"
             for k, v in bench_cfg.items() if k in where]
    return apply_overrides(get_preset(bench_cfg["preset"]),
                           items + list(extra or ()))


class Run:
    def __init__(self, cell_name: str, seed: int, seconds: float,
                 trace: bool, device, cell: Optional[Dict] = None,
                 program_overrides: Optional[List[str]] = None,
                 start_wall: Optional[float] = None):
        self.name = cell_name
        self.cell = cell or common.load_cell(cell_name)
        self.cfg = self.cell["cfg"]
        self.params = self.cell["traffic_params"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.program_overrides = program_overrides or []
        self.start_wall = start_wall or time.time()
        self.setup_s: Optional[float] = None
        self.spans = common.Spans()
        self.tracer = None          # trace.Trace of a --trace 1 run
        self.e2e: Dict[str, float] = {}
        self.data: Dict = {}        # what the per-layer readers read
        self.numbers: Dict[str, float] = {}   # what the check compares
        self.attempted = 0
        self.failed = 0
        self.peak_bytes: Optional[int] = None

    def program_config(self):
        return program_config(self.cfg, self.program_overrides)

    def window_started(self) -> None:
        """Set-up ends here: process start to the first timed call."""
        self.setup_s = time.time() - self.start_wall

    def memory_peak(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.peak_bytes = int(torch.cuda.max_memory_allocated(
                self.device))
        else:
            self.peak_bytes = 0

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start_slice(self) -> None:
        """Start the profiler and the traced slice (after the window)."""
        from benchmark.trace import Trace
        self.tracer = Trace()
        self.tracer.start()
        self.tracer.mark_start()

    def end_slice(self) -> None:
        """Close the traced slice and stop the profiler."""
        t0 = time.perf_counter()
        self.tracer.mark_end()
        self.tracer.stop()
        self.data["profiler_stop_s"] = time.perf_counter() - t0


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device, cell: Optional[Dict] = None,
            program_overrides: Optional[List[str]] = None,
            start_wall: Optional[float] = None) -> Run:
    r = Run(cell_name, seed, seconds, trace, device, cell,
            program_overrides, start_wall)
    traffic = common.load_module(common.traffic_file(r.cell["traffic"]))
    traffic.run(r)
    return r


def verdict(r: Run) -> List[tuple]:
    """(name, value, limit, ok) of each compared number, the cell's limits
    from its file: a number passes at or below its limit."""
    out = []
    for name, limit in r.cell["limits"].items():
        v = r.numbers.get(name)
        out.append((name, v, limit, v is not None and v <= limit))
    return out


def layer_metrics(r: Run, entries: List[Dict]) -> Dict[str, Dict]:
    """The per-layer metrics whose readers find something to read."""
    out = {}
    for m in entries:
        reader = common.load_module(common.metric_file(m["name"]))
        v = reader.read(r)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
