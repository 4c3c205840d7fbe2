"""Input loading shared by ``caption --inputs`` and, once it is ported, the
server (ROADMAP Queue 1 item 10): a path → per-frame features, and a list of
variable-length feature arrays → one fixed-shape batch with its frame mask.
As ``vidcap_tpu/serving.py``'s ``_FeatureLoader`` and ``_pad_batch``.

Raw video files need the frame decoder and the IRv2 backbone, which are not
ported yet (ROADMAP Queue 1 item 11): a video path raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import List

import numpy as np

from vidcap_tpu_torch.config import Config

_VIDEO_EXTS = (".mp4", ".avi", ".mkv", ".webm", ".mov")


class _FeatureLoader:
    """path → f32[T', D] features from a ``.npy`` file of [T', D]."""

    def __init__(self, cfg: Config):
        self.cfg = cfg

    def __call__(self, path: str) -> np.ndarray:
        if path.lower().endswith(_VIDEO_EXTS):
            raise NotImplementedError(
                f"{path}: captioning raw video needs the frame decoder and "
                "the end-to-end IRv2 backbone, not ported to vidcap_tpu_torch "
                "yet (ROADMAP Queue 1 item 11); pass per-frame .npy features")
        feats = np.load(path)
        if feats.ndim != 2:
            raise ValueError(f"{path}: expected [T, D] features, "
                             f"got {feats.shape}")
        D = self.cfg.data.feature_dim
        if feats.shape[1] != D:
            raise ValueError(f"{path}: feature dim {feats.shape[1]} != "
                             f"configured {D}")
        return feats.astype(np.float32)


def _pad_batch(cfg: Config, feats: List[np.ndarray], batch_size: int):
    """Zero-pad a list of [T', D] feature arrays into one fixed-shape
    (batch f32[B, T, D], frame_mask f32[B, T]) pair. Inputs longer than
    ``cfg.data.num_frames`` are cut to it. The mask marks the real frames,
    so attention and the pooled decoder init ignore the padding; the filler
    rows past ``len(feats)`` keep an all-zero mask."""
    T, D = cfg.data.num_frames, cfg.data.feature_dim
    batch = np.zeros((batch_size, T, D), np.float32)
    mask = np.zeros((batch_size, T), np.float32)
    for i, f in enumerate(feats):
        t = min(f.shape[0], T)
        batch[i, :t] = f[:t]
        mask[i, :t] = 1.0
    return batch, mask
