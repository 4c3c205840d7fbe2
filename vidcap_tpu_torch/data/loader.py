"""Caption dataset and per-video batching for the PyTorch package.

Aligned numpy arrays of precomputed per-frame CNN features and tokenized,
padded captions, with the vocab and the multitask attribute targets. Batches
are fixed-shape numpy structs; the caller moves them to its device. Raw-frame
files (end-to-end mode) are not ported yet (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from vidcap_tpu_torch.config import DataConfig
from vidcap_tpu_torch.data.attributes import mine_attributes
from vidcap_tpu_torch.data.feature_io import load_features, resolve_feature_path
from vidcap_tpu_torch.data.synthetic import make_synthetic_corpus
from vidcap_tpu_torch.data.vocab import Vocab, build_vocab


def _load_split_array(d: str, name: str, split: str, suffix: str):
    """Read ``{d}/{name}_{split}{suffix}.npy`` and its ``_ids.json``."""
    path = resolve_feature_path(os.path.join(d, f"{name}_{split}{suffix}"))
    ids_path = os.path.join(d, f"{name}_{split}_ids.json")
    arr, _ = load_features(path)
    if not os.path.exists(ids_path):
        raise FileNotFoundError(
            f"{ids_path} is required alongside {path} (.npy embeds no video "
            "ids)")
    with open(ids_path) as f:
        video_ids = json.load(f)
    return arr, video_ids


@dataclasses.dataclass
class Batch:
    """One fixed-shape batch.

    features : f32[B, T, D]   per-frame CNN features
    tokens   : i32[B, L]      caption token ids, <eos>-terminated, <pad>-padded
    mask     : f32[B, L]      1.0 where tokens is a real token (incl. <eos>)
    attributes: f32[B, K]     multi-hot attribute targets
    video_idx: i32[B]         index into the dataset's video table
    """

    features: np.ndarray
    tokens: np.ndarray
    mask: np.ndarray
    attributes: np.ndarray
    video_idx: np.ndarray


class CaptionDataset:
    """Aligned (video features, caption) pairs with vocab + attribute targets."""

    def __init__(
        self,
        features: np.ndarray,            # [N, T, D]
        video_ids: List[str],
        video_captions: Dict[str, List[str]],
        cfg: DataConfig,
        vocab: Optional[Vocab] = None,
    ):
        self.cfg = cfg
        self.features = np.asarray(features, dtype=np.float32)
        self.video_ids = list(video_ids)
        self.video_captions = video_captions
        self._vid_index = {v: i for i, v in enumerate(self.video_ids)}

        all_caps = [c for caps in video_captions.values() for c in caps]
        self.vocab = vocab or build_vocab(
            all_caps, min_count=cfg.min_word_count, max_size=cfg.vocab_size
        )

        self.attr_words, attr_targets = mine_attributes(
            video_captions, cfg.num_attributes
        )
        self.attributes = np.stack(
            [attr_targets[v] for v in self.video_ids]
        ).astype(np.float32)  # [N, K]

        tok_rows, vid_rows = [], []
        for vid, caps in video_captions.items():
            vi = self._vid_index[vid]
            for c in caps:
                tok_rows.append(self.vocab.encode_caption(c, cfg.max_caption_len))
                vid_rows.append(vi)
        if not tok_rows:  # caption-less split (decode-only eval): keep 2-D shape
            tok_rows = np.zeros((0, cfg.max_caption_len), dtype=np.int32)
        self.tokens = np.asarray(tok_rows, dtype=np.int32)          # [M, L]
        self.caption_video_idx = np.asarray(vid_rows, dtype=np.int32)  # [M]
        self.mask = (self.tokens != 0).astype(np.float32)

    # ------------------------------------------------------------------ factories

    @classmethod
    def synthetic(cls, cfg: DataConfig, num_videos: int = 64, seed: int = 0
                  ) -> "CaptionDataset":
        corpus = make_synthetic_corpus(
            num_videos=num_videos,
            num_frames=cfg.num_frames,
            feature_dim=cfg.feature_dim,
            seed=seed,
        )
        return cls(corpus["features"], corpus["video_ids"], corpus["captions"], cfg)

    @classmethod
    def from_files(cls, cfg: DataConfig, split: str = "train") -> "CaptionDataset":
        """Load precomputed features + captions from disk:

          {data_dir}/{dataset}_{split}_feats.npy   f32[N, T, D]
          {data_dir}/{dataset}_{split}_ids.json    ["video1", ...]
          {data_dir}/{dataset}_captions.json       {"video1": ["a man ...", ...]}
          {data_dir}/{dataset}_vocab.json          (optional, else built here)
        """
        d, name = cfg.data_dir, cfg.dataset
        feats, video_ids = _load_split_array(d, name, split, "_feats")
        with open(os.path.join(d, f"{name}_captions.json")) as f:
            all_captions = json.load(f)
        missing = [v for v in video_ids if v not in all_captions]
        if missing:
            import sys
            print(f"[vidcap] {name}_{split}: {len(missing)} video(s) have no "
                  f"captions (e.g. {missing[0]!r}); loading with empty "
                  f"reference lists", file=sys.stderr)
        captions = {v: all_captions.get(v, []) for v in video_ids}
        vocab_path = os.path.join(d, f"{name}_vocab.json")
        vocab = Vocab.load(vocab_path) if os.path.exists(vocab_path) else None
        return cls(feats, video_ids, captions, cfg, vocab=vocab)

    # ------------------------------------------------------------------ iteration

    @property
    def num_videos(self) -> int:
        return len(self.video_ids)

    @property
    def num_captions(self) -> int:
        return self.tokens.shape[0]

    def video_batches(self, batch_size: int) -> Iterator[Batch]:
        """Deterministic per-video batches for inference/eval; the last batch is
        padded by repeating the final video (callers slice with ``video_idx``)."""
        n = self.num_videos
        for start in range(0, n, batch_size):
            sel = np.arange(start, min(start + batch_size, n))
            if len(sel) < batch_size:
                sel = np.concatenate(
                    [sel, np.full(batch_size - len(sel), sel[-1], dtype=sel.dtype)]
                )
            if self.tokens.shape[0] == 0:
                tokens = np.zeros((batch_size, self.cfg.max_caption_len),
                                  dtype=np.int32)
                mask = np.zeros_like(tokens, dtype=np.float32)
            else:
                first = self.caption_video_idx == sel[:, None]  # [B, M]
                cap_rows = np.argmax(first, axis=1)
                tokens, mask = self.tokens[cap_rows], self.mask[cap_rows]
            yield Batch(
                features=self.features[sel],
                tokens=tokens,
                mask=mask,
                attributes=self.attributes[sel],
                video_idx=sel.astype(np.int32),
            )
