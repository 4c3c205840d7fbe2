"""The decoder step's arithmetic that the decoder's modules
(``models/decoder.py``) and the kernels' plain versions share: the rounding
to the compute dtype, the masked frames' score, the LSTM update and the
attention of K beams over their video's frames.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG = -1e30


def rnd(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round ``x`` to ``dtype`` and return it as float32 (no-op for f32)."""
    return x.to(dtype).float() if dtype != torch.float32 else x.float()


def lstm_update(gates: torch.Tensor, c: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 gates [N, 4H] (i, f, g, o) and c [N, H] → (h', c')."""
    i, f, g, o = gates.chunk(4, dim=-1)
    new_c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(new_c), new_c


def attention_beam(q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
                   frame_mask: torch.Tensor, u: torch.Tensor,
                   cd: torch.dtype) -> torch.Tensor:
    """Per-video attention shared by K beams. q f32[B, K, A] (already rounded
    to ``cd``); keys [B, T, A], values [B, T, H]; frame_mask f32[B, T] →
    ctx f32[B, K, H]."""
    s = rnd(torch.tanh(rnd(keys.float()[:, None] + q[:, :, None], cd)), cd)
    scores = torch.einsum("bkta,a->bkt", s, rnd(u, cd))
    scores = torch.where(frame_mask[:, None, :] > 0, scores,
                         torch.full_like(scores, NEG))
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bkt,btd->bkd", rnd(attn, cd), values.float())
