"""Build the Hopper kernels in ``vidcap_tpu_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``build/vidcap_tpu_torch/<name>-<hash>.so`` at the root of the
checkout, keyed by a hash of the sources and the flags, then loaded with
``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/vidcap_tpu_torch/<name>-<hash>.so csrc/<name>.cu

Nothing here runs at import: the CPU-only test environment has no ``nvcc``.
:func:`build_all` starts one ``nvcc`` per source, all at once.

The launch counts are process-wide on purpose: a run reads them to show that
its decode went through the kernels. Each wrapper adds one where it launches
its kernel and nowhere else. Under CUDA-graph capture a wrapper runs once
and the graph launches its kernels at every replay: :func:`counted` takes
the capture's counts back out, and the replayer adds them with
:func:`add_counts` at each replay (train/steps.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "vidcap_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
KERNELS = ("beam_core", "topk_project", "rollout")

launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def reset_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def counted(fn: Callable[[], object]) -> Tuple[object, Dict[str, int]]:
    """Run ``fn`` and return (its result, the launches its wrappers
    counted), those launches taken back out of :data:`launch_counts`."""
    before = dict(launch_counts)
    try:
        out = fn()
        return out, {k: launch_counts[k] - before[k] for k in before}
    finally:
        launch_counts.update(before)


def add_counts(delta: Dict[str, int]) -> None:
    for name, n in delta.items():
        launch_counts[name] += n


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "Hopper kernels are built from source on first use")
    return nvcc


def _so_path(name: str) -> str:
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
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    return so, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)


def build_all(names: Iterable[str] = KERNELS) -> None:
    """Compile every named kernel that is not built yet, in parallel."""
    jobs = [(n, j) for n in names if (j := _start(n)) is not None]
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
    if name not in _libs:
        build_all([name])
        _libs[name] = ctypes.CDLL(_so_path(name))
    return _libs[name]


def entry(name: str, n_ptrs: int, n_ints: int, tail: Sequence = ()):
    """The C entry point ``vidcap_<name>`` of kernel ``name``, its argument
    types set once: ``n_ptrs`` pointers, ``n_ints`` ints, then ``tail``
    (ctypes types), then the stream; returns an int error code."""
    if name not in _fns:
        fn = getattr(load(name), f"vidcap_{name}")
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + list(tail) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


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
