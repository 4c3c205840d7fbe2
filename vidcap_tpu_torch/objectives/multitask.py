"""Multitask attribute BCE, as ``vidcap_tpu/objectives/multitask.py``:
sigmoid binary cross-entropy between the attribute head's logits and the
mined multi-hot targets (Optax's ``sigmoid_binary_cross_entropy``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def attribute_bce_loss(logits: torch.Tensor, targets: torch.Tensor
                       ) -> torch.Tensor:
    """logits f32[B, K], targets f32[B, K] in {0, 1} → scalar mean BCE."""
    return (-targets * F.logsigmoid(logits)
            - (1.0 - targets) * F.logsigmoid(-logits)).mean()
