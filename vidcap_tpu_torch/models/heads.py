"""Multitask attribute head: an MLP over the masked-mean-pooled encoded
features → multi-hot attribute logits (``VidCapModel.attribute_logits``),
trained by the attribute BCE (objectives/multitask.py)."""
from __future__ import annotations

import torch
from torch import nn

from vidcap_tpu_torch.models.decoder import Dense


class AttributeHead(nn.Module):
    def __init__(self, num_attributes: int, hidden_dim: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(hidden_dim, hidden_dim, compute_dtype)
        self.fc2 = Dense(hidden_dim, num_attributes, compute_dtype)

    def forward(self, encoded: torch.Tensor) -> torch.Tensor:
        """encoded f32[B, H] → logits f32[B, num_attributes]."""
        return self.fc2(torch.relu(self.fc1(encoded)))
