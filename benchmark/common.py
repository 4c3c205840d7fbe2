"""Shared pieces of the benchmark: where its files are, how a cell, a
configuration and a per-layer metric are found by name, the
card's identity, and the guard against JAX in the process.

Nothing here imports the program (``vidcap_tpu_torch``) or the reference.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")

# top-level module names that may not be in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vidcap_tpu")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return load_json(MANIFEST)


def cell_file(name: str) -> str:
    return os.path.join(HERE, "workloads", f"{name}.json")


def config_file(name: str) -> str:
    return os.path.join(HERE, "configs", f"{name}.json")


def traffic_file(kind: str) -> str:
    return os.path.join(HERE, "traffic", f"{kind}.py")


def metric_file(name: str) -> str:
    return os.path.join(HERE, "metrics", f"{name}.py")


def load_module(path: str):
    """A benchmark file by path (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + os.path.basename(path)[:-3].replace(".", "_")
        .replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str) -> Dict:
    """A cell's file (by the cell's name, or a path ending in ``.json``),
    with its configuration's file under ``"cfg"``."""
    cell = load_json(name if name.endswith(".json") else cell_file(name))
    cell["cfg"] = load_json(config_file(cell["config"]))
    return cell


def cells_of(traffic: str) -> List[str]:
    """The names of the manifest's cells of one traffic kind."""
    return [w["name"] for w in manifest()["workloads"]
            if w["traffic"] == traffic]


def cell_metrics(name: str, man: Optional[Dict] = None):
    """(end-to-end metric entries, per-layer metric entries) of cell
    ``name`` in the manifest: an entry without ``workloads`` applies to
    every cell that reports the end-to-end metric it moves."""
    man = man or manifest()
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def process_start_wall() -> float:
    """The wall-clock time (``time.time()``) at which this process started,
    from ``/proc`` (10 ms resolution)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])   # field 22, counted after the name
    tick = os.sysconf("SC_CLK_TCK")
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + start_ticks / tick


def power_limit_w() -> Optional[float]:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def forbidden_modules() -> List[str]:
    """Whole top-level names of ``sys.modules`` that are JAX's or the JAX
    package's (``vidcap_tpu_torch`` is not ``vidcap_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


class Spans:
    """In-memory spans of the benchmark's own files around calls into the
    program's layers: (name, thread id, start, end) on ``perf_counter``."""

    def __init__(self):
        self.items: List[tuple] = []

    def add(self, name: str, t0: float, t1: float) -> None:
        self.items.append((name, threading.get_ident(), t0, t1))

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter())
