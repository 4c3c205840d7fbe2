"""Inference API of the PyTorch package: weights → decode a dataset, greedy,
sampled or beam.

Runs on the card unless the caller asks for the CPU (``device="cpu"``). With
no card and no such request it raises; it never carries on on the CPU.
Greedy and sampled decode run through K3 (``ops/rollout.py``), beam through
K1 and K2.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from vidcap_tpu_torch.config import Config
from vidcap_tpu_torch.convert import load_weights
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.models.decoding import (BeamWeights, beam_decode,
                                              fused_beam_step, tile_recurrent,
                                              use_finished_pool)
from vidcap_tpu_torch.models.model import (VidCapModel, create_model,
                                           init_params)
from vidcap_tpu_torch.ops.rollout import RolloutWeights, model_rollout


class NoDeviceError(RuntimeError):
    """The card was asked for (or implied) and none is visible."""


def resolve_device(device: Optional[str]) -> torch.device:
    """``None`` means the card. Raises when the card is asked for (or
    implied) and none is visible."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device is visible; vidcap_tpu_torch runs on the GPU "
            "unless asked for the CPU (device='cpu', CLI --device cpu)")
    return dev


class Captioner:
    """A model with its decode weights prepared once for the kernels."""

    def __init__(self, cfg: Config, model: VidCapModel,
                 dataset: CaptionDataset, device: torch.device,
                 seed: Optional[int] = None):
        self.cfg = cfg
        self.model = model
        self.dataset = dataset
        self.device = device
        self.max_len = cfg.decode.max_len
        self.seed = seed              # None → wall-clock-seeded sampling
        self._sample_calls = 0        # makes successive sample seeds differ
        self._beam_weights: Optional[BeamWeights] = None
        self._rollout_weights: Optional[RolloutWeights] = None
        self.decode_calls = 0   # decode_batch calls run so far
        self.decode_steps = 0   # decode steps run so far, any method (early
        #   exit ends some beam decodes; a greedy/sample rollout runs max_len)

    @classmethod
    def from_checkpoint(cls, cfg: Config, dataset: CaptionDataset,
                        weights: Optional[str] = None,
                        device: Optional[str] = None,
                        seed: Optional[int] = None) -> "Captioner":
        """``weights``: a ``.npz`` of "/"-joined Flax paths (convert.py), or
        None for the seeded init (``cfg.train.seed``). ``seed`` makes
        sampled decodes reproducible."""
        dev = resolve_device(device)
        model = init_params(create_model(cfg, vocab_size=dataset.vocab.size),
                            seed=cfg.train.seed)
        if weights:
            load_weights(model, weights)
        return cls(cfg, model.to(dev).eval(), dataset, dev, seed=seed)

    def _sample_seed(self, seed: Optional[int]) -> int:
        """The caller's seed; else one derived from ``self.seed`` and a
        per-captioner call counter (distinct and reproducible); else the
        wall clock."""
        if seed is not None:
            return seed
        if self.seed is not None:
            self._sample_calls += 1
            return (self.seed * 1000003 + self._sample_calls) % (1 << 31)
        return time.time_ns() % (1 << 31)

    @torch.inference_mode()
    def decode_batch(self, feats: np.ndarray, method: str = "beam",
                     beam_width: int = 5, temperature: float = 1.0,
                     seed: Optional[int] = None,
                     frame_mask: Optional[np.ndarray] = None,
                     nbest: int = 1) -> np.ndarray:
        """feats f32[B, T, D] → token ids i32[B, L]; with nbest > 1 (beam
        only) the nbest best hypotheses per video, i32[B, nbest, L], best
        first. ``temperature`` and ``seed`` apply to method="sample"."""
        if method not in ("greedy", "sample", "beam"):
            raise ValueError(f"unknown decode method {method!r}")
        if nbest > 1 and method != "beam":
            raise ValueError(f"nbest={nbest} requires method='beam' "
                             "(greedy/sample decode one hypothesis)")
        if frame_mask is None:
            frame_mask = np.ones(feats.shape[:2], np.float32)
        f = torch.as_tensor(np.asarray(feats, np.float32), device=self.device)
        m = torch.as_tensor(np.asarray(frame_mask, np.float32),
                            device=self.device)
        if method == "beam":
            return self._beam(f, m, beam_width, nbest)
        if self._rollout_weights is None:
            self._rollout_weights = RolloutWeights.from_model(self.model)
        sample = method == "sample"
        r = model_rollout(self.model, f, m, self.max_len, sample=sample,
                          seed=self._sample_seed(seed) if sample else 0,
                          temperature=temperature if sample else 1.0,
                          weights=self._rollout_weights)
        self.decode_calls += 1
        self.decode_steps += self.max_len
        return r.tokens.cpu().numpy()

    def _beam(self, f: torch.Tensor, m: torch.Tensor, beam_width: int,
              nbest: int) -> np.ndarray:
        if self.cfg.decode.int8_vocab_projection:
            raise NotImplementedError(
                "decode.int8_vocab_projection is not ported to "
                "vidcap_tpu_torch yet (ROADMAP Queue 1 item 9)")
        if use_finished_pool(self.cfg.decode):
            raise NotImplementedError(
                "the finished-hypothesis beam pool (length_penalty != 0 or "
                "finished_pool='on') is not ported to vidcap_tpu_torch yet "
                "(ROADMAP Queue 1 item 3, 'beam_decode_pool')")
        K = beam_width
        if not 1 <= nbest <= K:
            raise ValueError(f"nbest={nbest} must be in [1, beam_width={K}] "
                             "— the beam only carries K hypotheses")
        if self._beam_weights is None:
            self._beam_weights = BeamWeights.from_model(self.model)
        B = f.shape[0]
        state = tile_recurrent(self.model.init_state(f, m), K)
        step = fused_beam_step(self._beam_weights, K)

        def counted_step(st, tok):
            self.decode_steps += 1
            return step(st, tok)

        toks, _ = beam_decode(
            counted_step, state, batch=B,
            max_len=self.max_len, beam_width=K,
            length_penalty=self.cfg.decode.length_penalty,
            early_exit=self.cfg.decode.early_exit, return_all=nbest > 1)
        self.decode_calls += 1
        toks = toks[:, :nbest] if nbest > 1 else toks
        return toks.cpu().numpy()

    def caption_dataset(self, method: str = "beam", beam_width: int = 5,
                        temperature: float = 1.0, batch_size: int = 32,
                        nbest: int = 1) -> Dict[str, List[str]]:
        """Decode every video in the dataset → {video_id: [caption, ...]}
        (the nbest hypotheses best-first, or just the winner)."""
        results: Dict[str, List[str]] = {}
        vocab = self.dataset.vocab
        for batch in self.dataset.video_batches(batch_size):
            toks = self.decode_batch(batch.features, method=method,
                                     beam_width=beam_width,
                                     temperature=temperature, nbest=nbest)
            for row, vidx in zip(toks, batch.video_idx):
                vid = self.dataset.video_ids[int(vidx)]
                if vid not in results:   # padded tail rows repeat the last video
                    results[vid] = ([vocab.decode_str(r) for r in row]
                                    if nbest > 1 else [vocab.decode_str(row)])
        return results
