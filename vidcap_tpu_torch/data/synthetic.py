"""Synthetic dataset fixture (SURVEY.md §7 PR1: "runs with zero real data").

Generates a learnable toy corpus: each video belongs to one of C latent clusters;
its features are a noisy cluster code and its captions are short templated sentences
about that cluster. A correct model drives XE loss down and CIDEr up, which lets
train/SCST/eval integration tests assert real learning signals without MSVD/MSR-VTT
assets on disk.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

_SUBJECTS = ["a man", "a woman", "a dog", "a cat", "a child", "a group of people",
             "a bird", "a car", "a monkey", "a chef"]
_VERBS = ["is playing", "is running", "is cooking", "is jumping", "is singing",
          "is driving", "is eating", "is dancing", "is riding", "is talking"]
_OBJECTS = ["in the park", "on the street", "in a kitchen", "on a stage",
            "near the river", "in the snow", "on a field", "at home",
            "in the city", "on a bike"]


def make_synthetic_corpus(
    num_videos: int = 64,
    num_frames: int = 8,
    feature_dim: int = 64,
    captions_per_video: int = 3,
    seed: int = 0,
    pixels: bool = False,
    frame_size: int = 64,
) -> Dict[str, object]:
    """Return dict with features [N,T,D], video_ids, and {video_id: [caption strs]}.

    pixels=True (e2e mode, SURVEY.md §3.5): features are raw frames
    f32[N, T, S, S, 3] in [-1, 1] instead of precomputed vectors — the latent
    cluster/verb/object codes are painted as solid color patches at fixed
    locations, so a CNN backbone can recover them and the corpus stays
    learnable end-to-end through pixels."""
    rng = np.random.default_rng(seed)
    n_clusters = len(_SUBJECTS)
    clusters = rng.integers(0, n_clusters, size=num_videos)
    verbs = rng.integers(0, len(_VERBS), size=num_videos)
    objs = rng.integers(0, len(_OBJECTS), size=num_videos)

    if pixels:
        S = frame_size
        feats = rng.normal(0, 0.05, size=(num_videos, num_frames, S, S, 3)
                           ).astype(np.float32)
        third = max(S // 3, 1)

        def paint(img, slot, code, n_codes):
            # patch column position encodes the code value; row encodes the slot
            x0 = (code * S) // n_codes
            x1 = max(x0 + third // 2, x0 + 2)
            r0, r1 = slot * third, (slot + 1) * third
            img[:, r0:r1, min(x0, S - 2):min(x1, S), :] += np.asarray(
                [1.0 if slot == 0 else -0.5,
                 1.0 if slot == 1 else -0.5,
                 1.0 if slot == 2 else -0.5], np.float32)

        for i in range(num_videos):
            paint(feats[i], 0, int(clusters[i]), n_clusters)
            paint(feats[i], 1, int(verbs[i]), len(_VERBS))
            paint(feats[i], 2, int(objs[i]), len(_OBJECTS))
        feats = np.clip(feats, -1.0, 1.0)
    else:
        # feature = [subject code | verb code | object code | noise], tiled over frames
        feats = rng.normal(0, 0.1, size=(num_videos, num_frames, feature_dim)).astype(np.float32)
        for i in range(num_videos):
            feats[i, :, clusters[i] % feature_dim] += 2.0
            feats[i, :, (n_clusters + verbs[i]) % feature_dim] += 2.0
            feats[i, :, (n_clusters + len(_VERBS) + objs[i]) % feature_dim] += 2.0

    video_ids = [f"vid{i:04d}" for i in range(num_videos)]
    captions: Dict[str, List[str]] = {}
    for i, vid in enumerate(video_ids):
        base = f"{_SUBJECTS[clusters[i]]} {_VERBS[verbs[i]]} {_OBJECTS[objs[i]]}"
        caps = [base]
        for _ in range(captions_per_video - 1):
            # paraphrase: same subject/verb, occasionally drop the object phrase
            if rng.random() < 0.5:
                caps.append(f"{_SUBJECTS[clusters[i]]} {_VERBS[verbs[i]]}")
            else:
                caps.append(base)
        captions[vid] = caps

    return {"features": feats, "video_ids": video_ids, "captions": captions}
