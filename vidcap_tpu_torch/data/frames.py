"""Frame decode, sampling and preprocessing, and feature extraction, as
``vidcap_tpu/data/frames.py``.

* Host: video file decode through OpenCV (cv2), gated: without cv2 a video
  raises the reference's ``RuntimeError``; everything else works.
* Device: frame sampling (an index gather), resize and normalization run on
  the frames' device, so the e2e path uploads raw uint8 frames once.

The resize is ``jax.image.resize(..., "bilinear")``'s, antialiased when it
downscales: per spatial axis a weight matrix (a triangle kernel widened by
the scale, weights renormalised at the borders), built on the host in f32 as
``jax/_src/image/scale.py`` builds it and applied as two contractions.
``F.interpolate(antialias=True)`` is not guaranteed to match it.
"""
from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Callable, List

import numpy as np
import torch

from vidcap_tpu_torch.config import Config

VIDEO_EXTS = (".mp4", ".avi", ".mkv", ".webm", ".mov")


def uniform_frame_indices(total: int, num: int) -> np.ndarray:
    """``num`` evenly spaced indices into ``total`` frames (half to even)."""
    if total <= 0:
        return np.zeros((num,), np.int64)
    return np.linspace(0, max(total - 1, 0), num).round().astype(np.int64)


def _device_indices(t_in: int, num: int) -> np.ndarray:
    """``round(jnp.linspace(0, t_in - 1, num))`` as XLA computes it in f32
    (``i · (stop · (1 / (num - 1)))``, the last point exactly ``stop``),
    half to even, clipped."""
    stop = np.float32(t_in - 1.0)
    pts = np.zeros((num,), np.float32)
    if num > 1:
        pts = np.arange(num, dtype=np.float32) * (
            stop * (np.float32(1) / np.float32(num - 1)))
        pts[-1] = stop
    return np.clip(np.round(pts).astype(np.int32), 0, t_in - 1)


def sample_frames_device(frames: torch.Tensor, num_frames: int
                         ) -> torch.Tensor:
    """[T_in, ...] → uniformly sampled [num_frames, ...], a gather on the
    frames' device."""
    idx = _device_indices(frames.shape[0], num_frames)
    return frames.index_select(0, torch.as_tensor(idx, dtype=torch.int64,
                                                  device=frames.device))


@lru_cache(maxsize=16)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """f32[in_size, out_size]: ``jax.image.resize``'s bilinear weights along
    one axis (antialiased when downscaling)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) * inv_scale - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(in_size - 0.5))
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def preprocess_frames(frames_u8: torch.Tensor, out_size: int = 299
                      ) -> torch.Tensor:
    """uint8[T, H, W, 3] → f32[T, out, out, 3] in [-1, 1] (the IRv2
    convention), on the frames' device."""
    x = frames_u8.float() / 255.0
    _, H, W, _ = x.shape
    if H != out_size:
        wh = torch.as_tensor(resize_weights(H, out_size), device=x.device)
        x = torch.einsum("thwc,ho->towc", x, wh)
    if W != out_size:
        ww = torch.as_tensor(resize_weights(W, out_size), device=x.device)
        x = torch.einsum("thwc,wo->thoc", x, ww)
    return x * 2.0 - 1.0


def decode_video_frames(path: str, num_frames: int) -> np.ndarray:
    """Decode a video file and sample ``num_frames`` uniformly →
    uint8[num_frames, H, W, 3] (RGB), through OpenCV on the host."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "video decode requires OpenCV (cv2); precomputed-feature mode works "
            "without it") from e
    cap = cv2.VideoCapture(path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    # the frame count is a container hint: where it is missing, decode
    # everything and sample after
    want = (set(uniform_frame_indices(total, num_frames).tolist())
            if total > 0 else None)
    frames: List[np.ndarray] = []
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if want is None or i in want:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        i += 1
    cap.release()
    if not frames:
        raise RuntimeError(f"no frames decoded from {path}")
    if want is None and len(frames) > num_frames:
        idx = uniform_frame_indices(len(frames), num_frames)
        frames = [frames[j] for j in idx.tolist()]
    while len(frames) < num_frames:      # short or corrupt videos: repeat last
        frames.append(frames[-1])
    return np.stack(frames[:num_frames])


def make_video_encoder(cfg: Config, device, backbone=None
                       ) -> Callable[[np.ndarray], np.ndarray]:
    """``encode_video(frames_u8) → f32[T, D]``: one video's uint8 frames
    uploaded to ``device``, preprocessed there and run through the IRv2
    backbone (``backbone``, else a full-width one from
    ``load_backbone_params``: ImageNet weights where the file exists).
    ``device`` None means the card. Shared by ``extract``, the server's
    video inputs and the chip smoke."""
    from vidcap_tpu_torch.inference import resolve_device
    from vidcap_tpu_torch.models import backbone as backbone_mod
    device = resolve_device(device)
    if backbone is None:
        backbone = backbone_mod.load_backbone_params(
            backbone_mod.InceptionResNetV2(), cfg)
    backbone = backbone.to(device).eval()

    @torch.inference_mode()
    def encode_video(frames_u8: np.ndarray) -> np.ndarray:
        x = preprocess_frames(torch.as_tensor(np.asarray(frames_u8),
                                              device=device),
                              cfg.data.frame_size)
        return backbone(x).cpu().numpy()
    return encode_video


def extract_features_for_dir(cfg: Config, video_dir: str, split: str = "train",
                             fmt: str = "npy", device=None) -> str:
    """Decode every video in ``video_dir``, run the backbone, and write
    ``{data_dir}/{dataset}_{split}_feats.{fmt}`` and its ids json. ``fmt``:
    npy, h5 or tfrecord. Returns the features' path."""
    from vidcap_tpu_torch.data.feature_io import save_features
    files = sorted(f for f in os.listdir(video_dir)
                   if f.lower().endswith(VIDEO_EXTS))
    if not files:
        raise FileNotFoundError(f"no videos in {video_dir}")
    encode_video = make_video_encoder(cfg, device)
    feats, ids = [], []
    for f in files:
        frames = decode_video_frames(os.path.join(video_dir, f),
                                     cfg.data.num_frames)
        feats.append(encode_video(frames))
        ids.append(os.path.splitext(f)[0])
    os.makedirs(cfg.data.data_dir, exist_ok=True)
    base = os.path.join(cfg.data.data_dir, f"{cfg.data.dataset}_{split}")
    path = save_features(base + "_feats", np.stack(feats), ids, fmt=fmt)
    with open(base + "_ids.json", "w") as fp:
        json.dump(ids, fp)
    print(f"[vidcap] wrote {len(ids)} feature rows → {path}")
    return path
