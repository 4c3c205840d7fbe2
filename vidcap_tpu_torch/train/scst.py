"""SCST train step: a sampled rollout and the greedy baseline, both on K3,
the device CIDEr reward, the policy-gradient loss from a teacher-forced
re-score, the XE anchor and the attribute BCE, and the update.

The branch of ``vidcap_tpu/train/scst.py`` this ports is its kernel branch
(``model.use_pallas_decoder``, ``:93-103``), the route the port's
``Captioner`` takes for every greedy and sampled decode: both rollouts are
forward-only calls of ``ops/rollout.py::model_rollout``, which launches K3
(csrc/rollout.cu) for CUDA tensors and runs its plain version only for CPU
tensors. The JAX package's other routes, the fused XLA ``dual_rollout``
(``train.scst_fused_rollouts``) and the separate XLA sample/greedy scans,
are not ported: on the card SCST's rollouts always run on K3, whatever
those flags say. The gradient comes from one differentiable teacher-forced
re-score of the sampled tokens, the same recurrence on the same fixed
tokens, so it equals backpropagation through the sampling loop.

The step is two parts: :meth:`ScstStep.rollouts` (the two K3 rollouts,
forward only) and :meth:`ScstStep.update`, the differentiable rest, which
takes the two rollouts as inputs; tests feed both packages the same
rollouts.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from vidcap_tpu_torch.config import Config
from vidcap_tpu_torch.models.decoding import Rollout
from vidcap_tpu_torch.objectives.multitask import attribute_bce_loss
from vidcap_tpu_torch.objectives.reward import scst_reward
from vidcap_tpu_torch.objectives.reward_tables import (RewardTables,
                                                       tables_from_dataset)
from vidcap_tpu_torch.objectives.scst import scst_loss
from vidcap_tpu_torch.objectives.xe import masked_xe_loss, shift_right
from vidcap_tpu_torch.ops.rollout import (RolloutWeights, model_rollout,
                                          resident_mode)
from vidcap_tpu_torch.train.state import TrainState
from vidcap_tpu_torch.train.steps import (Batch, Metrics, apply_loss,
                                          refuse_unported)


class ScstStep:
    """``step(state, batch, seed=None) → (state, metrics)``. ``seed`` is
    K3's sampling seed; None draws it from ``state.generator``."""

    def __init__(self, cfg: Config, tables: RewardTables):
        refuse_unported(cfg)
        self.cfg = cfg
        self.tables = tables
        t = cfg.train
        self.bleu_mix = t.bleu_mix if t.scst_reward == "cider_bleu" else 0.0
        # K3's W_out mode in the last step's rollouts (ops/rollout.py)
        self.rollout_resident: Optional[bool] = None

    def _tables(self, device) -> RewardTables:
        if self.tables.ref_tf.device != device:
            self.tables = self.tables.to(device)
        return self.tables

    def rollouts(self, state: TrainState, batch: Batch,
                 seed: Optional[int] = None) -> Tuple[Rollout, Rollout]:
        """(sampled at ``decode.temperature``, greedy): forward only, on the
        features without gradient; the weights cast once for both."""
        if seed is None:
            seed = int(torch.randint(0, 2**31 - 1, (1,),
                                     generator=state.generator))
        model, d = state.model, self.cfg.decode
        feats = model.encode_features(batch["features"]).detach()
        w = RolloutWeights.from_model(model)
        self.rollout_resident = resident_mode(w, feats.shape[1], feats.device)
        sample = model_rollout(model, feats, None, d.max_len, sample=True,
                               seed=seed, temperature=d.temperature,
                               weights=w, resident_wout=self.rollout_resident)
        greedy = model_rollout(model, feats, None, d.max_len, weights=w,
                               resident_wout=self.rollout_resident)
        return sample, greedy

    def rewards(self, batch: Batch, sample: Rollout, greedy: Rollout
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        tables = self._tables(sample.tokens.device)
        vidx = batch["video_idx"]
        return (scst_reward(tables, vidx, sample.tokens, sample.mask,
                            self.bleu_mix),
                scst_reward(tables, vidx, greedy.tokens, greedy.mask,
                            self.bleu_mix))

    def loss(self, model, batch: Batch, sample: Rollout, greedy: Rollout,
             rewards: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, Metrics]:
        """The differentiable part: the re-score of the sampled tokens
        (temperature-scaled log-probs of the emitted tokens, masked), the
        PG loss against the greedy baseline, ``scst_xe_mix`` · the XE anchor
        on the ground-truth captions, ``attribute_loss_weight`` · BCE."""
        t = self.cfg.train
        feats = model.encode_features(batch["features"])
        logits = model.xe_logits(feats, None, shift_right(sample.tokens))
        logp_all = torch.log_softmax(
            logits / max(self.cfg.decode.temperature, 1e-6), dim=-1)
        logp = logp_all.gather(-1, sample.tokens.long()[..., None])[..., 0]
        rescored = Rollout(tokens=sample.tokens, logp=logp * sample.mask,
                           mask=sample.mask)
        r_s, r_g = rewards if rewards is not None else self.rewards(
            batch, sample, greedy)
        loss, metrics = scst_loss(rescored, r_s, r_g)
        if t.scst_xe_mix > 0:
            # the XE anchor keeps the policy tied to the data distribution
            # while the PG term optimizes CIDEr
            gt = model.xe_logits(feats, None, shift_right(batch["tokens"]))
            xe, _ = masked_xe_loss(gt, batch["tokens"], batch["mask"])
            loss = loss + t.scst_xe_mix * xe
            metrics["xe_anchor"] = xe
        if t.attribute_loss_weight > 0:
            bce = attribute_bce_loss(model.attribute_logits(feats),
                                     batch["attributes"])
            loss = loss + t.attribute_loss_weight * bce
            metrics["attr_loss"] = bce
        metrics["loss"] = loss
        return loss, metrics

    def update(self, state: TrainState, batch: Batch, sample: Rollout,
               greedy: Rollout) -> Tuple[TrainState, Metrics]:
        return apply_loss(state, *self.loss(state.model, batch, sample,
                                            greedy))

    def __call__(self, state: TrainState, batch: Batch,
                 seed: Optional[int] = None) -> Tuple[TrainState, Metrics]:
        sample, greedy = self.rollouts(state, batch, seed)
        return self.update(state, batch, sample, greedy)


def make_scst_step_body(cfg: Config, dataset=None,
                        tables: Optional[RewardTables] = None) -> ScstStep:
    """The SCST step; the reward tables come from ``dataset`` (built on the
    host once) unless given."""
    if tables is None:
        if dataset is None:
            raise ValueError("make_scst_step_body needs a dataset or tables")
        tables = tables_from_dataset(dataset)
    return ScstStep(cfg, tables)
