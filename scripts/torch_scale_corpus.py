"""Generate a synthetic MSR-VTT-scale corpus in the ``from_files`` layout:
the port's copy of ``scripts/make_scale_corpus.py``, with the same
arguments and defaults, writing the same files byte for byte
(tests/test_torch_scst_lift.py), its vocab built by
``vidcap_tpu_torch/data/vocab.py``. The at-scale staged training run
(scripts/torch_scale_run.py) needs production dims — thousands of videos, a
~16k vocab, real caption lengths — with no real data available offline.

Design (learnable at scale, like data/synthetic.py but production-sized):
  * C latent clusters; each owns an EXCLUSIVE pool of ``pool`` lexicon words
    (C × pool ≈ 16k distinct words) and a deterministic template verb.
  * a video's features are its cluster's random code tiled over T frames
    + noise — recoverable by the video encoder.
  * each caption: "a <subject> is <verb> <w_i ... w_{i+L}>" where the w's are
    a CONTIGUOUS window of the cluster pool (random offset per caption), so
    references of one video overlap heavily in n-grams (CIDEr has signal) and
    every pool word clears the min-count vocab threshold.
Writes: {out}/msrvtt_{split}_feats.npy/_ids.json, msrvtt_captions.json,
msrvtt_vocab.json — exactly what ``CaptionDataset.from_files`` consumes.

Usage: python scripts/torch_scale_corpus.py --out /path/to/data \
          [--train 5000 --val 500 --clusters 500 --pool 32]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_SUBJECTS = ["man", "woman", "dog", "cat", "child", "group", "bird", "car",
             "monkey", "chef", "player", "girl", "boy", "horse", "band",
             "robot"]
_VERBS = ["playing", "running", "cooking", "jumping", "singing", "driving",
          "eating", "dancing", "riding", "talking", "walking", "swimming",
          "drawing", "fighting", "surfing", "cleaning"]


def make_scale_corpus(num_videos: int, num_frames: int = 26,
                      feature_dim: int = 1536, clusters: int = 500,
                      pool: int = 32, window: int = 8,
                      captions_per_video: int = 20, seed: int = 0,
                      noise: float = 0.3, code_seed: int = 1234):
    rng = np.random.default_rng(seed)
    # cluster codes: unit-norm random directions scaled up — linearly
    # separable. Drawn from a DEDICATED generator (code_seed) so every split
    # shares the same cluster→feature mapping; the per-split `seed` only
    # varies video membership, noise, and caption windows (per-split codes
    # would make the val split unlearnable).
    codes = np.random.default_rng(code_seed).normal(
        size=(clusters, feature_dim)).astype(np.float32)
    codes *= 2.0 / np.linalg.norm(codes, axis=1, keepdims=True)

    cluster_of = rng.integers(0, clusters, size=num_videos)
    feats = (codes[cluster_of][:, None, :]
             + rng.normal(0, noise, size=(num_videos, num_frames, feature_dim)
                          ).astype(np.float32))

    video_ids = [f"video{i}" for i in range(num_videos)]
    captions = {}
    for i, vid in enumerate(video_ids):
        c = int(cluster_of[i])
        subj = _SUBJECTS[c % len(_SUBJECTS)]
        verb = _VERBS[(c // len(_SUBJECTS)) % len(_VERBS)]
        caps = []
        for _ in range(captions_per_video):
            off = int(rng.integers(0, pool - window + 1))
            words = [f"w{c * pool + off + j:05d}" for j in range(window)]
            caps.append(f"a {subj} is {verb} " + " ".join(words))
        captions[vid] = caps
    return feats.astype(np.float32), video_ids, captions


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--train", type=int, default=5000)
    ap.add_argument("--val", type=int, default=500)
    ap.add_argument("--clusters", type=int, default=500)
    ap.add_argument("--pool", type=int, default=32)
    ap.add_argument("--frames", type=int, default=26)
    ap.add_argument("--dim", type=int, default=1536)
    ap.add_argument("--caps-per-video", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    all_captions = {}
    # one generator, contiguous id ranges per split (val videos are UNSEEN but
    # share the cluster structure — a held-out split in the real sense)
    for split, n, seed in (("train", args.train, args.seed),
                           ("val", args.val, args.seed + 1)):
        feats, ids, caps = make_scale_corpus(
            n, num_frames=args.frames, feature_dim=args.dim,
            clusters=args.clusters, pool=args.pool,
            captions_per_video=args.caps_per_video, seed=seed)
        ids = [f"{split}_{v}" for v in ids]
        caps = {f"{split}_{k}": v for k, v in caps.items()}
        np.save(os.path.join(args.out, f"msrvtt_{split}_feats.npy"), feats)
        with open(os.path.join(args.out, f"msrvtt_{split}_ids.json"), "w") as f:
            json.dump(ids, f)
        all_captions.update(caps)
        print(f"[corpus] {split}: {n} videos, feats {feats.shape}",
              file=sys.stderr)

    with open(os.path.join(args.out, "msrvtt_captions.json"), "w") as f:
        json.dump(all_captions, f)

    from vidcap_tpu_torch.data.vocab import build_vocab
    train_caps = [c for v, caps in all_captions.items()
                  if v.startswith("train_") for c in caps]
    vocab = build_vocab(train_caps, min_count=2)
    vocab.save(os.path.join(args.out, "msrvtt_vocab.json"))
    print(f"[corpus] vocab size {vocab.size}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
