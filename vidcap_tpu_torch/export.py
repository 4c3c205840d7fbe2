"""Decoder export: a self-contained serving artifact, the port's counterpart
of ``vidcap_tpu/export.py``.

The JAX package's artifact is a StableHLO graph (``jax.export``) with the
weights baked in. The port's decode cannot be traced that way: K1–K3 are
ctypes calls into libraries built from ``csrc/`` (``ops/_build.py``), the
beam loop reads ``finished.all()`` on the host at every step
(``models/decoding.py``), and a ``torch.export`` program would still need
this package's kernels at load. So the port's artifact is a format of its
own, **weights + vocab + meta**, and :class:`ExportedCaptioner` rebuilds the
decode from this package's code: no checkpoint, no dataset and no preset at
load, and the same kernels as live serving on the card.

Layout of an export directory:
    weights.npz   ``convert.save_weights``: "/"-joined Flax parameter paths,
                  so the JAX package loads the same file
    vocab.json    ``Vocab.save``
    meta.json     the reference's keys (schema, method, beam_width,
                  batch_size with None for batch-polymorphic, num_frames,
                  feature_dim, max_len, vocab_size, platforms, preset_hint),
                  ``"format": "vidcap_tpu_torch"``, and the model, data and
                  decode config sections (``dataclasses.asdict``) that
                  rebuild the model without a preset

The decode method, beam width and batch are frozen at export: a request for
another is an error, not a silent decode with the artifact's.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence

import numpy as np

from vidcap_tpu_torch.config import (Config, DataConfig, DecodeConfig,
                                     ModelConfig)
from vidcap_tpu_torch.convert import load_weights, save_weights
from vidcap_tpu_torch.data.vocab import Vocab
from vidcap_tpu_torch.inference import Captioner, resolve_device
from vidcap_tpu_torch.models.model import create_model

EXPORT_SCHEMA = 1
FORMAT = "vidcap_tpu_torch"
PLATFORMS = ("cuda", "cpu")
_WEIGHTS_NAME = "weights.npz"
_VOCAB_NAME = "vocab.json"
_META_NAME = "meta.json"
_JAX_BYTES_NAME = "decoder.jaxexp"   # the JAX package's serialized graph


def export_decoder(captioner: Captioner, out_dir: str, *,
                   batch_size: Optional[int] = 32, method: str = "greedy",
                   beam_width: int = 5,
                   platforms: Optional[Sequence[str]] = None) -> dict:
    """Write ``captioner``'s decode as an artifact for one batch size, or for
    any (``batch_size`` None or 0: batch-polymorphic, each call decodes
    exactly its rows). ``platforms``: the devices the artifact may load on,
    "cuda" and/or "cpu" (default: the captioner's). Sampling is excluded:
    export greedy or beam. Returns the meta dict (also in
    ``out_dir/meta.json``)."""
    if method not in ("greedy", "beam"):
        raise ValueError(f"exportable methods are greedy/beam, got {method!r}")
    cfg: Config = captioner.cfg
    if cfg.model.use_backbone:
        raise ValueError("export serves feature-mode decode; run `extract` "
                         "first for pixel inputs")
    plats = list(platforms) if platforms else [captioner.device.type]
    bad = [p for p in plats if p not in PLATFORMS]
    if bad:
        raise ValueError(f"platforms {bad}: a vidcap_tpu_torch artifact runs "
                         f"on {'/'.join(PLATFORMS)} (a TPU artifact is the "
                         "JAX package's `python -m vidcap_tpu export`)")
    vocab = captioner.dataset.vocab
    decode = dataclasses.replace(cfg.decode, method=method,
                                 beam_width=beam_width)
    os.makedirs(out_dir, exist_ok=True)
    save_weights(captioner.model, os.path.join(out_dir, _WEIGHTS_NAME))
    vocab.save(os.path.join(out_dir, _VOCAB_NAME))
    meta = {
        "schema": EXPORT_SCHEMA,
        "format": FORMAT,
        "method": method,
        "beam_width": beam_width if method == "beam" else None,
        "batch_size": batch_size or None,   # None ⇒ batch-polymorphic
        "num_frames": cfg.data.num_frames,
        "feature_dim": cfg.data.feature_dim,
        "max_len": cfg.decode.max_len,
        "vocab_size": vocab.size,
        "platforms": plats,
        "preset_hint": getattr(cfg, "name", None),
        "model": dataclasses.asdict(cfg.model),
        "data": dataclasses.asdict(cfg.data),
        "decode": dataclasses.asdict(decode),
    }
    with open(os.path.join(out_dir, _META_NAME), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class _VocabOnly:
    """Stand-in for CaptionDataset: serving only reads ``.vocab``."""

    def __init__(self, vocab: Vocab):
        self.vocab = vocab


class ExportedCaptioner(Captioner):
    """Run an :func:`export_decoder` artifact: features → caption strings.

    A ``Captioner`` on the artifact's weights and configuration, so serving
    (``CaptionServer``, ``BatchingCaptioner``) and the CLI's report run off
    it unchanged. Fixed-batch artifacts zero-pad (mask-0 rows) up to the
    exported batch size and refuse larger inputs (``caption`` chunks them);
    batch-polymorphic artifacts (batch_size None) decode every N as it is.
    """

    def __init__(self, cfg: Config, model, vocab: Vocab, meta: dict, device):
        super().__init__(cfg, model, _VocabOnly(vocab), device)
        self.vocab = vocab
        self.meta = meta
        bs = meta["batch_size"]
        self.batch_size = int(bs) if bs else None   # None ⇒ batch-polymorphic
        self.num_frames = int(meta["num_frames"])
        self.feature_dim = int(meta["feature_dim"])

    def check_config(self, cfg: Config) -> None:
        """Raise if ``cfg``'s feature shape disagrees with the artifact's:
        the serving pad/mask path sizes batches from the config."""
        want = (cfg.data.num_frames, cfg.data.feature_dim)
        have = (self.num_frames, self.feature_dim)
        if want != have:
            raise ValueError(f"preset expects features {want}, artifact was "
                             f"exported for {have}")

    @classmethod
    def load(cls, export_dir: str, device: Optional[str] = None
             ) -> "ExportedCaptioner":
        """The artifact in ``export_dir`` on ``device`` (None: the card),
        which must be one of the artifact's platforms."""
        if (os.path.exists(os.path.join(export_dir, _JAX_BYTES_NAME))
                and not os.path.exists(os.path.join(export_dir,
                                                    _WEIGHTS_NAME))):
            raise FileNotFoundError(
                f"no {_WEIGHTS_NAME} in {export_dir!r}: it is an artifact of "
                f"the JAX package ({_JAX_BYTES_NAME}, a StableHLO graph), "
                "which vidcap_tpu_torch does not run; export with `python -m "
                "vidcap_tpu_torch export` (weights + vocab + meta)")
        with open(os.path.join(export_dir, _META_NAME)) as f:
            meta = json.load(f)
        if meta.get("schema") != EXPORT_SCHEMA or meta.get("format") != FORMAT:
            raise ValueError(f"export schema {meta.get('schema')!r}, format "
                             f"{meta.get('format')!r} not supported (expected "
                             f"{EXPORT_SCHEMA}, {FORMAT!r})")
        dev = resolve_device(device)
        if dev.type not in meta["platforms"]:
            raise ValueError(f"artifact was exported for {meta['platforms']},"
                             f" not {dev.type}")
        cfg = Config(name=meta["preset_hint"] or "default",
                     model=ModelConfig(**meta["model"]),
                     data=DataConfig(**meta["data"]),
                     decode=DecodeConfig(**meta["decode"]))
        vocab = Vocab.load(os.path.join(export_dir, _VOCAB_NAME))
        model = load_weights(create_model(cfg, vocab_size=vocab.size),
                             os.path.join(export_dir, _WEIGHTS_NAME))
        return cls(cfg, model.to(dev).eval(), vocab, meta, dev)

    # ------------------------------------------------------------ decoding

    def decode_batch(self, feats: np.ndarray, method: Optional[str] = None,
                     beam_width: Optional[int] = None,
                     frame_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """feats f32[N, T, D] (N ≤ exported batch) → token ids i32[N, L].

        ``method``/``beam_width`` exist for the serving stack, which passes
        them through: the decode is frozen at export, so they are VALIDATED
        against the artifact, not honored."""
        if method is not None and method != self.meta["method"]:
            raise ValueError(f"artifact was exported with method="
                             f"{self.meta['method']!r}, not {method!r}")
        if (self.meta["method"] == "beam" and beam_width is not None
                and beam_width != self.meta["beam_width"]):
            raise ValueError(f"artifact beam_width is "
                             f"{self.meta['beam_width']}, not {beam_width}")
        if feats.ndim != 3:
            # e.g. [N, T, S, S, 3] frames of a pixel-mode preset
            raise ValueError(
                f"exported decoders consume [N, T, D] FEATURES, got shape "
                f"{feats.shape}; pixel inputs must go through `extract` "
                "first (export serves feature-mode decode)")
        N, T, D = feats.shape
        if (T, D) != (self.num_frames, self.feature_dim):
            raise ValueError(f"features [{T},{D}] don't match exported "
                             f"[{self.num_frames},{self.feature_dim}]")
        decode = lambda f, m: Captioner.decode_batch(
            self, f, method=self.meta["method"],
            beam_width=self.meta["beam_width"] or 5, frame_mask=m)
        B = self.batch_size
        if B is None:                    # polymorphic: exact shape, no padding
            return decode(feats, None if frame_mask is None
                          else np.asarray(frame_mask, np.float32))
        if N > B:
            raise ValueError(f"batch {N} exceeds exported size {B}; chunk "
                             f"inputs or use caption()")
        fb = np.zeros((B, T, D), np.float32)
        mb = np.zeros((B, T), np.float32)
        fb[:N] = feats
        mb[:N] = 1.0 if frame_mask is None else frame_mask
        return decode(fb, mb)[:N]

    def caption(self, feats: np.ndarray) -> List[str]:
        """feats f32[N, T, D] for any N → N caption strings (chunked)."""
        out: List[str] = []
        step = self.batch_size or feats.shape[0] or 1
        for i in range(0, feats.shape[0], step):
            toks = self.decode_batch(feats[i:i + step])
            out.extend(self.vocab.decode_str(row) for row in toks)
        return out
