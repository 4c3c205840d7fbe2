"""SCST / REINFORCE policy-gradient loss, as ``vidcap_tpu/objectives/scst.py``:

  loss = -Σ_b (r(sample_b) - r(greedy_b)) · Σ_t log π(w_bt) / (sampled tokens)

with the greedy rollout as the self-critical baseline. The rewards come from
integer tokens, so the advantage is a constant; the gradient flows only
through the sampled tokens' log-probs (train/scst.py's re-score).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from vidcap_tpu_torch.models.decoding import Rollout


def scst_loss(sample: Rollout, reward_sample: torch.Tensor,
              reward_greedy: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """sample: the sampled rollout, its logp carrying gradients; rewards
    f32[B]. Returns (loss, metrics)."""
    advantage = (reward_sample - reward_greedy).detach()          # [B]
    seq_logp = (sample.logp * sample.mask).sum(-1)                # [B]
    ntok = torch.clamp(sample.mask.sum(), min=1.0)
    loss = -(advantage * seq_logp).sum() / ntok
    metrics = {
        "pg_loss": loss,
        "reward_sample": reward_sample.mean(),
        "reward_greedy": reward_greedy.mean(),
        "advantage_mean": advantage.mean(),
        # jnp.std: the population standard deviation
        "advantage_std": advantage.std(correction=0),
    }
    return loss, metrics
