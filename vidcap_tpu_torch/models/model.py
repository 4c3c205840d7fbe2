"""Top-level model: (the optional IRv2 backbone) → caption decoder +
multitask attribute head, one parameter tree named as the Flax tree of
``vidcap_tpu/models/model.py`` (``backbone/...``, ``decoder/...``,
``attr_head/...``; see convert.py).

In feature mode the inputs are precomputed per-frame features f32[B, T, D].
With ``model.use_backbone`` (the end-to-end presets) they may be frame pixels
f32[B, T, S, S, 3], which ``encode_features`` runs through the backbone
(models/backbone.py); features that are already encoded pass unchanged."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from vidcap_tpu_torch.config import Config
from vidcap_tpu_torch.models import backbone as backbone_mod
from vidcap_tpu_torch.models.decoding import (VocabProjection,
                                              module_beam_step,
                                              tile_recurrent)
from vidcap_tpu_torch.models.decoder import (CaptionDecoder, DecoderState,
                                             Dense, Dropout, dtype_of)
from vidcap_tpu_torch.models.heads import AttributeHead


def padded_vocab_size(cfg: Config, vocab_size: int) -> int:
    """Vocab padded to a multiple of 128, never below the preset's padding."""
    return max(cfg.data.padded_vocab, ((vocab_size + 127) // 128) * 128)


class VidCapModel(nn.Module):
    # greedy and sampled decodes have their own loops (and K3); the beam's
    # surface (``decoder``, ``init_beam``, ``beam_step``, ``feature_dtype``)
    # is the one the Captioner calls on every decoder family
    beam_only = False

    def __init__(self, cfg: Config, vocab_size: int):
        super().__init__()
        self.cfg = cfg
        self.vocab_size = vocab_size
        if cfg.model.use_backbone:
            # looked up at call time, so that tests can shrink the backbone
            self.backbone = backbone_mod.InceptionResNetV2(
                compute_dtype=dtype_of(cfg.model.compute_dtype),
                remat_every=cfg.model.backbone_remat_every)
        self.decoder = CaptionDecoder(
            cfg.model, vocab_size=vocab_size,
            padded_vocab=padded_vocab_size(cfg, vocab_size),
            feature_dim=cfg.data.feature_dim)
        self.attr_head = AttributeHead(cfg.data.num_attributes,
                                       cfg.model.hidden_dim,
                                       dtype_of(cfg.model.compute_dtype))

    def encode_features(self, inputs: torch.Tensor) -> torch.Tensor:
        """Pixels [B, T, H, W, 3] → the backbone's features f32[B, T, D]
        (with ``use_backbone``); features [B, T, D] → themselves."""
        if self.cfg.model.use_backbone and inputs.ndim == 5:
            B, T = inputs.shape[:2]
            feats = self.backbone(inputs.reshape((B * T,) + inputs.shape[2:]))
            return feats.reshape(B, T, -1)
        return inputs

    def init_state(self, inputs: torch.Tensor,
                   frame_mask: Optional[torch.Tensor] = None) -> DecoderState:
        return self.decoder.init_state(self.encode_features(inputs),
                                       frame_mask)

    def step(self, state: DecoderState, token: torch.Tensor):
        return self.decoder.step(state, token)

    @property
    def feature_dtype(self) -> torch.dtype:
        """The dtype the first operation on the features rounds them to."""
        return self.decoder.feat_proj.compute_dtype

    def init_beam(self, inputs: torch.Tensor, frame_mask: torch.Tensor,
                  beam_width: int, max_len: int) -> DecoderState:
        """The beam's state: h/c tiled to B·K rows (``max_len`` unused)."""
        return tile_recurrent(self.init_state(inputs, frame_mask),
                              beam_width)

    def beam_step(self, proj: VocabProjection, beam_width: int,
                  candidates: int):
        """The beam step through the modules (K1 takes the other route)."""
        return module_beam_step(self, beam_width, proj, candidates)

    def step_beam(self, state: DecoderState, token: torch.Tensor,
                  beam_width: int):
        return self.decoder.step_beam(state, token, beam_width)

    def step_beam_hidden(self, state: DecoderState, token: torch.Tensor,
                         beam_width: int):
        return self.decoder.step_beam_hidden(state, token, beam_width)

    def xe_logits(self, inputs: torch.Tensor,
                  frame_mask: Optional[torch.Tensor],
                  teacher_inputs: torch.Tensor,
                  dropout: Optional[Dropout] = None) -> torch.Tensor:
        return self.decoder.xe_logits(self.encode_features(inputs),
                                      frame_mask, teacher_inputs, dropout)

    def attribute_logits(self, inputs: torch.Tensor,
                         frame_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """The multitask head on the masked-mean-pooled projected features:
        f32[B, num_attributes]."""
        feats = self.encode_features(inputs)
        if frame_mask is None:
            frame_mask = torch.ones(feats.shape[:2], device=feats.device)
        return self.attr_head(self.decoder.encode_video(feats, frame_mask))


def create_model(cfg: Config, vocab_size: int) -> VidCapModel:
    return VidCapModel(cfg, vocab_size)


def truncated_normal(rng: np.random.Generator, shape, std: float
                      ) -> np.ndarray:
    """Normal truncated to ±2 (resampled), rescaled so the result has
    standard deviation ``std`` — Flax's ``truncated_normal`` convention."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return x * (std / 0.87962566103423978)


@torch.no_grad()
def init_params(model: VidCapModel, seed: int = 0) -> VidCapModel:
    """Fill every parameter in place from a numpy seed, with the Flax
    initializer kinds: Dense kernels lecun-normal (truncated, std
    1/sqrt(fan_in)) and zero biases, the embedding normal with std
    1/sqrt(features), LSTM kernels glorot-uniform with zero bias, and the
    attention vector ``u`` normal(0.05); the backbone's as
    ``backbone.init_backbone``. The draws differ from JAX's."""
    rng = np.random.default_rng(seed)
    if model.cfg.model.use_backbone:
        backbone_mod.init_backbone(model.backbone, rng)
    for mod in model.modules():
        if isinstance(mod, Dense):
            mod.kernel.copy_(torch.from_numpy(truncated_normal(
                rng, tuple(mod.kernel.shape),
                1.0 / np.sqrt(mod.kernel.shape[0]))))
            if mod.bias is not None:
                mod.bias.zero_()
    dec = model.decoder
    num, feat = dec.embed.embedding.shape
    dec.embed.embedding.copy_(torch.from_numpy(
        rng.normal(0.0, 1.0 / np.sqrt(feat), (num, feat))))
    for cell in dec.cells:
        fan_in, fan_out = cell.w.shape
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        cell.w.copy_(torch.from_numpy(rng.uniform(-lim, lim, (fan_in, fan_out))))
        cell.b.zero_()
    if dec.cfg.use_attention:
        dec.attention.u.copy_(torch.from_numpy(
            rng.normal(0.0, 0.05, tuple(dec.attention.u.shape))))
    return model
