"""Masked sequence cross-entropy, as ``vidcap_tpu/objectives/xe.py``:
teacher-forced XE over <bos>-shifted inputs, summed over the real tokens
(incl. <eos>) and divided by their count in the batch."""
from __future__ import annotations

from typing import Tuple

import torch

from vidcap_tpu_torch.data.vocab import BOS


def shift_right(tokens: torch.Tensor, bos: int = BOS) -> torch.Tensor:
    """[w0, w1, ...] → [<bos>, w0, w1, ...] (the last dropped): the
    teacher-forcing inputs."""
    return torch.cat([torch.full_like(tokens[:, :1], bos), tokens[:, :-1]],
                     dim=1)


def _token_logp(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, targets.long()[..., None])[..., 0]


def masked_xe_loss(logits: torch.Tensor, targets: torch.Tensor,
                   mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits f32[B, L, V], targets int[B, L], mask f32[B, L] → (loss,
    token count)."""
    denom = torch.clamp(mask.sum(), min=1.0)
    return -(_token_logp(logits, targets) * mask).sum() / denom, denom


def sequence_logprob(logits: torch.Tensor, tokens: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Per-sequence sum of the tokens' log-probs under ``logits``: f32[B]."""
    return (_token_logp(logits, tokens) * mask).sum(dim=-1)
