"""ctypes bindings for the native host library (``csrc/host/vidcap_native.cpp``),
as ``vidcap_tpu/native.py`` binds the JAX package's copy.

On first use the source is compiled with

    g++ -O3 -fPIC -shared -std=c++17 -o build/vidcap_tpu_torch/vidcap_native-<hash>.so

at the root of the checkout, keyed by a hash of the source and the flags as
``ops/_build.py`` keys the kernels (no ``-march=native``: the library must
load on any x86-64 host the checkout reaches), compiled to a temporary name
and moved into place, so that processes building at once each load a whole
library. Where no ``g++`` is found the module prints one stderr line and the
wrappers return what their callers take as "use Python": the tokenizer and
n-gram counter in Python (``data/vocab.py::ptb_tokenize``,
``objectives/reward_tables.py::_ref_entries_plain``) compute the same
values. The library speeds up the host side of the data and reward-table
pipeline: PTB tokenization, and the per-reference n-gram counting and
hashing behind the device CIDEr tables.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "host", "vidcap_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "vidcap_tpu_torch")
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_tried = False

_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_f32p = ctypes.POINTER(ctypes.c_float)


def so_path() -> str:
    """The library's path under :data:`BUILD_DIR`, keyed by the source and
    the flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"vidcap_native-{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run([gxx, *GXX_FLAGS, SOURCE, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)   # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        so = so_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        print(f"[vidcap] native lib unavailable ({e}); using python fallbacks",
              file=sys.stderr)
        return None
    lib.vc_ngram_hash.argtypes = [_i32p, ctypes.c_int, _u32p, _u32p]
    lib.vc_ngram_hash.restype = None
    lib.vc_ref_ngrams.argtypes = [_i32p, ctypes.c_int, ctypes.c_int, _u32p,
                                  _u32p, _f32p, _i32p, ctypes.c_int]
    lib.vc_ref_ngrams.restype = ctypes.c_int
    lib.vc_tokenize.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.c_int]
    lib.vc_tokenize.restype = ctypes.c_int
    lib.vc_encode_batch.argtypes = [_i32p, _i32p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int32, _i32p, _f32p]
    lib.vc_encode_batch.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the library is built and loaded (building it on first call)."""
    return _load() is not None


def ngram_hash(tokens: Sequence[int], order: int) -> Tuple[int, int]:
    """The (lo, hi) key of an n-gram of ``order`` tokens, as
    ``ops/ngram_hash.py::host_ngram_key`` computes it (which runs where the
    library does not)."""
    lib = _load()
    if lib is None:
        from vidcap_tpu_torch.ops.ngram_hash import host_ngram_key
        return host_ngram_key(tokens, order)
    arr = np.ascontiguousarray(tokens, np.int32)
    if arr.shape != (order,) or not 1 <= order <= 4:
        raise ValueError(f"ngram_hash: {arr.size} tokens for an n-gram of "
                         f"order {order} (1..4)")
    lo, hi = ctypes.c_uint32(), ctypes.c_uint32()
    lib.vc_ngram_hash(arr.ctypes.data_as(_i32p), order, ctypes.byref(lo),
                      ctypes.byref(hi))
    return lo.value, hi.value


def ref_ngrams(tokens: Sequence[int], max_order: int = 4
               ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]]:
    """The unique n-grams of orders 1..``max_order`` of one reference as
    (key_lo u32, key_hi u32, tf f32, order i32) arrays, in the library's
    order; None where the library is unavailable (the caller counts in
    Python)."""
    lib = _load()
    if lib is None:
        return None
    if not 1 <= max_order <= 4:
        raise ValueError(f"ref_ngrams: max_order {max_order} (1..4)")
    arr = np.ascontiguousarray(tokens, np.int32)
    cap = max(4 * max(len(arr), 1), 16)
    lo = np.zeros(cap, np.uint32)
    hi = np.zeros(cap, np.uint32)
    tf = np.zeros(cap, np.float32)
    order = np.zeros(cap, np.int32)
    n = lib.vc_ref_ngrams(arr.ctypes.data_as(_i32p), len(arr), max_order,
                          lo.ctypes.data_as(_u32p), hi.ctypes.data_as(_u32p),
                          tf.ctypes.data_as(_f32p),
                          order.ctypes.data_as(_i32p), cap)
    if n < 0:
        return None
    return lo[:n], hi[:n], tf[:n], order[:n]


def tokenize(text: str) -> Optional[List[str]]:
    """PTB tokens of ``text``, as ``data/vocab.py::ptb_tokenize`` gives
    them; None where the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode("utf-8", "ignore")
    buf = ctypes.create_string_buffer(4 * len(raw) + 16)
    lib.vc_tokenize(raw, buf, len(buf))
    s = buf.value.decode("utf-8", "ignore")
    return s.split(" ") if s else []
