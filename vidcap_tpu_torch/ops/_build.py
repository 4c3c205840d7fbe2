"""Build the Hopper kernels in ``vidcap_tpu_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``build/vidcap_tpu_torch/<name>-<hash>.so`` at the root of the
checkout, keyed by a hash of the sources and the flags, then loaded with
``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/vidcap_tpu_torch/<name>-<hash>.so csrc/<name>.cu

Nothing here runs at import: the CPU-only test environment has no ``nvcc``.
:func:`build_all` starts one ``nvcc`` per source, all at once. A kernel's
source is ``csrc/<name>.cu`` unless :data:`SOURCES` names another: K2's int8
variant ``topk_project_int8`` lives in ``topk_project.cu`` beside K2 and has
its own entry point and launch count, and K5's three (:data:`MOE`) live in
``moe.cu``, each with its own. :data:`MARKS`, the training step's
phase marks (``utils/profiling.py::phase``), is built and loaded the same
way and counts no launches.

The launch counts are process-wide on purpose: a run reads them to show that
its decode went through the kernels. Each wrapper counts a launch with
:func:`count_launch` where it launches its kernel and nowhere else; K2 and
K2-int8, whose rows take a candidate count K, are counted by K as well
(:data:`launches_by_k`: the slot-blocking beam runs them at the beam width,
the finished pool at the width + 1). Under CUDA-graph capture a wrapper runs
once and the graph launches its kernels at every replay: :func:`counted`
takes the capture's counts back out, and the replayer adds them with
:func:`add_counts` at each replay (train/steps.py). :func:`reset_counts`,
:func:`counted` and :func:`add_counts` treat both tallies alike.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "vidcap_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
MOE = ("moe_dispatch", "silu_mul", "moe_combine")   # K5, csrc/moe.cu
KERNELS = ("beam_core", "topk_project", "topk_project_int8", "rollout",
           "teacher_forced") + MOE
SOURCES = {"topk_project_int8": "topk_project",   # kernel → its csrc/*.cu
           **{name: "moe" for name in MOE}}
MARKS = "phase_marks"    # csrc/phase_marks.cu: empty kernels, not counted

launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}
launches_by_k: Dict[Tuple[str, int], int] = {}   # (kernel, K) → launches
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def count_launch(name: str, k: Optional[int] = None) -> None:
    """One launch of kernel ``name`` (at ``k`` candidates a row, where its
    wrapper takes a K)."""
    launch_counts[name] += 1
    if k is not None:
        launches_by_k[name, k] = launches_by_k.get((name, k), 0) + 1


def reset_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    launches_by_k.clear()


def counted(fn: Callable[[], object]) -> Tuple[object, Dict]:
    """Run ``fn`` and return (its result, the launches its wrappers
    counted: by name, and by (name, K) where counted by K), those launches
    taken back out of :data:`launch_counts` and :data:`launches_by_k`."""
    before, before_k = dict(launch_counts), dict(launches_by_k)
    try:
        out = fn()
        delta = {k: launch_counts[k] - before[k] for k in before}
        delta.update({key: n - before_k.get(key, 0)
                      for key, n in launches_by_k.items()
                      if n != before_k.get(key, 0)})
        return out, delta
    finally:
        launch_counts.update(before)
        launches_by_k.clear()
        launches_by_k.update(before_k)


def add_counts(delta: Dict) -> None:
    """Add a delta of :func:`counted` back (a captured graph's replay)."""
    for key, n in delta.items():
        if isinstance(key, tuple):
            launches_by_k[key] = launches_by_k.get(key, 0) + n
        else:
            launch_counts[key] += n


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "Hopper kernels are built from source on first use")
    return nvcc


def _source(name: str) -> str:
    return SOURCES.get(name, name)


def _so_path(name: str) -> str:
    name = _source(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source unless its library is built; returns
    (target, tmp, process) or None."""
    so = _so_path(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{_source(name)}.cu")]
    return so, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)


def build_all(names: Iterable[str] = KERNELS + (MARKS,)) -> None:
    """Compile every named kernel that is not built yet, in parallel (one
    nvcc a source); by default every kernel and the phase marks."""
    sources = dict.fromkeys(_source(n) for n in names)
    jobs = [(n, j) for n in sources if (j := _start(n)) is not None]
    errors = []
    for name, (so, tmp, proc) in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for csrc/{name}.cu:\n{out}")
        else:
            os.replace(tmp, so)   # atomic: a concurrent loader sees all or none
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    src = _source(name)
    if src not in _libs:
        build_all([src])
        _libs[src] = ctypes.CDLL(_so_path(src))
    return _libs[src]


def entry(name: str, n_ptrs: int, n_ints: int, tail: Sequence = (),
          part: str = ""):
    """The C entry point ``vidcap_<name>`` of kernel ``name`` (with a
    ``part``, ``vidcap_<name>_<part>``: one of the several entry points of a
    kernel built of several launches, K4's), its argument types set once:
    ``n_ptrs`` pointers, ``n_ints`` ints, then ``tail`` (ctypes types), then
    the stream; returns an int error code."""
    symbol = f"{name}_{part}" if part else name
    if symbol not in _fns:
        fn = getattr(load(name), f"vidcap_{symbol}")
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + list(tail) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return _fns[symbol]


def require(kernel: str, specs) -> None:
    """Raise ValueError unless each (tensor, name, dtype, shape) of ``specs``
    is a contiguous CUDA tensor of that dtype and shape. The passing test is
    kept cheap (``is`` for the dtype, no tuple copies): it runs on every
    launch of a decode loop."""
    for t, name, dt, shape in specs:
        if t.is_cuda and t.dtype is dt and t.shape == shape \
                and t.is_contiguous():
            continue
        raise ValueError(f"{kernel}: {name} must be a contiguous CUDA {dt} "
                         f"tensor of shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}"
                         + ("" if t.is_contiguous() else ", not contiguous"))


def scratch(device, nbytes: Sequence[int]) -> Tuple["torch.Tensor", List[int]]:
    """One device allocation carved into parts of ``nbytes`` (each start
    256-byte aligned): (the tensor, which must outlive the launches, and
    the parts' addresses). One allocation instead of one per buffer keeps
    the wrappers' host time down."""
    import torch
    starts, total = [], 0
    for n in nbytes:
        starts.append(total)
        total += -(-n // 256) * 256
    buf = torch.empty(max(total, 1), dtype=torch.uint8, device=device)
    return buf, [buf.data_ptr() + o for o in starts]


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        what = (f"TMA tensor map failed (CUresult {err - 1000})"
                if err >= 1000 else f"CUDA launch failed with cudaError_t {err}")
        raise RuntimeError(f"{name}: {what}")
