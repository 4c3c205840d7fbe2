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
from vidcap_tpu_torch.parallel.mesh import ONE_RANK


def scst_loss(sample: Rollout, reward_sample: torch.Tensor,
              reward_greedy: torch.Tensor, dp=ONE_RANK
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """sample: the sampled rollout, its logp carrying gradients; rewards
    f32[B]. Returns (loss, metrics). ``dp`` (parallel/mesh.py::OneRank, or
    parallel/sharding.py::DataParallel for a rank of a mesh): the loss and
    the means are this rank's shares of the global batch's, the
    sampled-token count and the standard deviation global."""
    advantage = (reward_sample - reward_greedy).detach()          # [B]
    seq_logp = (sample.logp * sample.mask).sum(-1)                # [B]
    ntok = torch.clamp(dp.sum(sample.mask.sum()), min=1.0)
    loss = -(advantage * seq_logp).sum() / ntok
    n = advantage.shape[0] * dp.nd
    mean = dp.sum(advantage.sum()) / n
    metrics = {
        "pg_loss": loss,
        "reward_sample": reward_sample.mean() / dp.nd,
        "reward_greedy": reward_greedy.mean() / dp.nd,
        "advantage_mean": advantage.mean() / dp.nd,
        # jnp.std: the population standard deviation, over the global batch
        "advantage_std": torch.sqrt(
            dp.sum(((advantage - mean) ** 2).sum()) / n),
    }
    return loss, metrics
