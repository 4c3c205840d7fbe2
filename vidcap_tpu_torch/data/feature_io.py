"""Precomputed-feature file IO: .npy / .h5 / .tfrecord, as
``vidcap_tpu/data/feature_io.py`` (a copy, so the PyTorch package imports
nothing of the JAX one). One writer and one reader per format, all giving
the same in-memory contract:

    features : f32[N, T, D]  (or uint8 frames [N, T, S, S, 3])
    video_ids: list[str] | None  (embedded ids, when the format carries them)

``.npy`` stores the array alone (ids travel in the sibling ``_ids.json``).
``.h5`` takes both layouts found in the wild: one "features" dataset (and an
optional "video_ids"), or one dataset per video keyed by its id.
``.tfrecord`` is one tf.train.Example per video (float_list "features" or
bytes "features_u8", int64_list "shape", bytes "video_id"), read and written
through TensorFlow's own record codec.

h5py and tensorflow import inside the functions that need them; where one
is missing, reading or writing its format raises ImportError naming the
format.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

FORMATS = ("npy", "h5", "tfrecord")
_EXTS = {"npy": ".npy", "h5": ".h5", "tfrecord": ".tfrecord"}


def resolve_feature_path(base: str) -> str:
    """``base`` (no extension) → the existing feature file, trying npy, h5,
    tfrecord in that order. Raises FileNotFoundError listing all candidates.
    When MORE THAN ONE container exists (e.g. a re-extract in a different
    format left the old file behind) the preference is announced loudly —
    silently training on the stale one is the failure mode to avoid."""
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


def _require(module: str, fmt: str):
    """Import ``module`` for the ``fmt`` container, or raise ImportError
    saying which format needs it."""
    import importlib
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"the {fmt} feature container needs the {module!r} package, "
            f"which is not installed ({e}); use the npy container") from e


# ------------------------------------------------------------------ writers

def save_features(base: str, features: np.ndarray,
                  video_ids: Sequence[str], fmt: str = "npy") -> str:
    """Write ``features`` [N, ...] under ``base`` + format extension.

    npy stores the array alone (ids travel in the sibling _ids.json, as the
    extract CLI writes); h5/tfrecord additionally embed the ids, matching how
    reference-era tools keyed those containers."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown feature format {fmt!r}; use one of {FORMATS}")
    features = np.asarray(features)
    if len(video_ids) != features.shape[0]:
        raise ValueError(
            f"{features.shape[0]} feature rows but {len(video_ids)} video ids")
    path = base + _EXTS[fmt]
    if fmt == "npy":
        np.save(path, features)
    elif fmt == "h5":
        h5py = _require("h5py", "h5")
        with h5py.File(path, "w") as f:
            f.create_dataset("features", data=features)
            f.create_dataset(
                "video_ids",
                data=np.asarray([v.encode() for v in video_ids], dtype=object),
                dtype=h5py.string_dtype())
    else:  # tfrecord
        tf = _require("tensorflow", "tfrecord")
        with tf.io.TFRecordWriter(path) as w:
            for vid, row in zip(video_ids, features):
                fields = {
                    "video_id": tf.train.Feature(
                        bytes_list=tf.train.BytesList(value=[vid.encode()])),
                    "shape": tf.train.Feature(
                        int64_list=tf.train.Int64List(value=list(row.shape))),
                }
                if row.dtype == np.uint8:   # raw frames: keep bytes, not floats
                    fields["features_u8"] = tf.train.Feature(
                        bytes_list=tf.train.BytesList(value=[row.tobytes()]))
                else:
                    fields["features"] = tf.train.Feature(
                        float_list=tf.train.FloatList(
                            value=np.asarray(row, np.float32).ravel()))
                w.write(tf.train.Example(
                    features=tf.train.Features(feature=fields)
                ).SerializeToString())
    return path


# ------------------------------------------------------------------ readers

def load_features(path: str, video_ids: Optional[Sequence[str]] = None,
                  ) -> Tuple[np.ndarray, Optional[List[str]]]:
    """Read a feature file of any supported format.

    Returns (features [N, ...], embedded_ids or None). When the container
    embeds ids AND ``video_ids`` is given, rows are reordered to match
    ``video_ids`` (h5-by-id and tfrecord files carry no guaranteed order)."""
    if path.endswith(".npy"):
        return np.load(path), None
    if path.endswith((".h5", ".hdf5")):
        return _load_h5(path, video_ids)
    if path.endswith(".tfrecord"):
        return _load_tfrecord(path, video_ids)
    raise ValueError(f"unrecognized feature file extension: {path}")


def _reorder(features: np.ndarray, embedded: List[str],
             video_ids: Optional[Sequence[str]],
             ) -> Tuple[np.ndarray, List[str]]:
    if video_ids is None or list(video_ids) == embedded:
        return features, embedded
    index = {v: i for i, v in enumerate(embedded)}
    missing = [v for v in video_ids if v not in index]
    if missing:
        raise KeyError(
            f"{len(missing)} video id(s) absent from the feature file "
            f"(e.g. {missing[0]!r})")
    sel = np.asarray([index[v] for v in video_ids])
    return features[sel], list(video_ids)


def _load_h5(path: str, video_ids: Optional[Sequence[str]],
             ) -> Tuple[np.ndarray, Optional[List[str]]]:
    h5py = _require("h5py", "h5")
    with h5py.File(path, "r") as f:
        if "features" in f:
            feats = np.asarray(f["features"])
            if "video_ids" in f:
                ids = [v.decode() if isinstance(v, bytes) else str(v)
                       for v in f["video_ids"][...]]
                return _reorder(feats, ids, video_ids)
            return feats, None
        # per-video-dataset layout: every key is a video id
        keys = list(f.keys())
        order = list(video_ids) if video_ids is not None else sorted(keys)
        missing = [v for v in order if v not in f]
        if missing:
            raise KeyError(
                f"{len(missing)} video id(s) absent from {path} "
                f"(e.g. {missing[0]!r})")
        feats = np.stack([np.asarray(f[v]) for v in order])
        return feats, order


def _load_tfrecord(path: str, video_ids: Optional[Sequence[str]],
                   ) -> Tuple[np.ndarray, Optional[List[str]]]:
    tf = _require("tensorflow", "tfrecord")
    ids: List[str] = []
    rows: List[np.ndarray] = []
    for rec in tf.data.TFRecordDataset(path):
        ex = tf.train.Example.FromString(bytes(rec.numpy()))
        feat = ex.features.feature
        shape = tuple(feat["shape"].int64_list.value)
        if feat["features_u8"].bytes_list.value:     # raw uint8 frames
            row = np.frombuffer(
                feat["features_u8"].bytes_list.value[0], np.uint8)
        else:
            row = np.asarray(feat["features"].float_list.value, np.float32)
        rows.append(row.reshape(shape) if shape else row)
        if not feat["video_id"].bytes_list.value:
            # fabricating an id here would silently mispair rows with captions
            raise ValueError(
                f"record {len(ids)} in {path} has no video_id field")
        ids.append(feat["video_id"].bytes_list.value[0].decode())
    if not rows:
        raise ValueError(f"no records in {path}")
    return _reorder(np.stack(rows), ids, video_ids)
