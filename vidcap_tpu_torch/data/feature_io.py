"""Precomputed-feature file IO for the PyTorch package.

The canonical container is ``.npy`` (``np.load``; ids travel in the sibling
``_ids.json``). The ``.h5`` and ``.tfrecord`` containers that the JAX package
also reads are not ported yet (ROADMAP Queue 1, "feature containers"): a file
in either format raises ``NotImplementedError`` rather than being skipped.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

FORMATS = ("npy", "h5", "tfrecord")
_EXTS = {"npy": ".npy", "h5": ".h5", "tfrecord": ".tfrecord"}
_NOT_PORTED = ("the {fmt} feature container is not ported to vidcap_tpu_torch "
               "yet (ROADMAP Queue 1, 'feature containers'); convert {path} "
               "to .npy")


def resolve_feature_path(base: str) -> str:
    """``base`` (no extension) → the existing feature file, trying npy, h5,
    tfrecord in that order. Raises FileNotFoundError listing all candidates."""
    found = [base + _EXTS[fmt] for fmt in FORMATS
             if os.path.exists(base + _EXTS[fmt])]
    if not found:
        raise FileNotFoundError(
            "no feature file found; tried "
            + ", ".join(base + _EXTS[f] for f in FORMATS))
    if len(found) > 1:
        import sys
        print(f"[vidcap] WARNING: {len(found)} feature containers exist for "
              f"{base} ({', '.join(os.path.basename(p) for p in found)}); "
              f"loading {os.path.basename(found[0])} — delete the stale one "
              "if a re-extract changed formats", file=sys.stderr)
    return found[0]


def load_features(path: str, video_ids: Optional[Sequence[str]] = None,
                  ) -> Tuple[np.ndarray, Optional[List[str]]]:
    """Read a feature file. Returns (features [N, ...], embedded_ids or None);
    ``.npy`` embeds no ids."""
    del video_ids   # only embedding containers reorder by id
    if path.endswith(".npy"):
        return np.load(path), None
    for fmt, exts in (("h5", (".h5", ".hdf5")), ("tfrecord", (".tfrecord",))):
        if path.endswith(exts):
            raise NotImplementedError(_NOT_PORTED.format(fmt=fmt, path=path))
    raise ValueError(f"unrecognized feature file extension: {path}")
