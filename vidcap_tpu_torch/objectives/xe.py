"""Masked sequence cross-entropy, as ``vidcap_tpu/objectives/xe.py``:
teacher-forced XE over <bos>-shifted inputs, summed over the real tokens
(incl. <eos>) and divided by their count in the batch. Under a mesh the
count is the global batch's (``denom``) and the log-softmax may run over a
vocab split across ranks (``vocab``: parallel/sharding.py::VocabShard)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from vidcap_tpu_torch.data.vocab import BOS


def shift_right(tokens: torch.Tensor, bos: int = BOS) -> torch.Tensor:
    """[w0, w1, ...] → [<bos>, w0, w1, ...] (the last dropped): the
    teacher-forcing inputs."""
    return torch.cat([torch.full_like(tokens[:, :1], bos), tokens[:, :-1]],
                     dim=1)


def token_logp(logits: torch.Tensor, targets: torch.Tensor,
               vocab=None) -> torch.Tensor:
    """log_softmax(logits)[targets]; ``vocab``: the logits are this rank's
    columns of a vocab split over the model axis."""
    if vocab is not None:
        return vocab.token_logp(logits, targets)
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, targets.long()[..., None])[..., 0]



def masked_xe_loss(logits: torch.Tensor, targets: torch.Tensor,
                   mask: torch.Tensor, vocab=None,
                   denom: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits f32[B, L, V], targets int[B, L], mask f32[B, L] → (loss,
    token count). ``denom``: the count to divide by (a data-parallel rank's
    share of the global mean divides by the global count), by default
    this batch's; ``vocab``: as :func:`token_logp`."""
    if denom is None:
        denom = torch.clamp(mask.sum(), min=1.0)
    return -(token_logp(logits, targets, vocab) * mask).sum() / denom, denom


def sequence_logprob(logits: torch.Tensor, tokens: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Per-sequence sum of the tokens' log-probs under ``logits``: f32[B]."""
    return (token_logp(logits, tokens) * mask).sum(dim=-1)
