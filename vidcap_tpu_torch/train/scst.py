"""SCST train step: a sampled rollout and the greedy baseline, the device
CIDEr reward, the policy-gradient loss from a teacher-forced re-score, the
XE anchor and the attribute BCE, and the update.

The rollouts are two forward-only calls of
``models/decoding.py::model_rollout`` on the route the port's ``Captioner``
takes (``models/decoding.py::route``), whatever
``train.scst_fused_rollouts`` says: K3 for the one-layer bf16 attention
decoder, as the JAX package's kernel branch (``model.use_pallas_decoder``,
``vidcap_tpu/train/scst.py:93-103``), else the module loops with no early
exit, where the JAX package runs its XLA rollouts (``dual_rollout`` or the
separate scans). The sampled noise is K3's counter hash (JAX's threefry
cannot be matched) and its seed a device int64, as K3 reads it. The
gradient comes from one differentiable teacher-forced re-score of the
sampled tokens, the same recurrence on the same fixed tokens, so it equals
backpropagation through the sampling loop.

The step encodes its inputs once (``model.encode_features``: the IRv2
backbone on pixels with ``model.use_backbone``, the identity on features),
as the reference does: the two K3 rollouts take the detached view, and the
PG re-score, the XE anchor and the attribute head share the one
differentiable encode, so that each of their gradients reaches the
backbone through it. The step is two parts: :meth:`ScstStep.rollouts` (the
two K3 rollouts, forward only) and :meth:`ScstStep.update`, the
differentiable rest, which takes the two rollouts as inputs; tests feed
both packages the same rollouts. The sampling seed is drawn on the host
from the state's generator and reaches K3 as a device int64, so that a captured step (train/steps.py)
samples each replay with its own seed. ``train.grad_accum`` splits the step
into microbatches, each with its rollouts and its seed, as the JAX
package's ``accum_grads``.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from vidcap_tpu_torch.config import Config
from vidcap_tpu_torch.models import decoding
from vidcap_tpu_torch.models.decoding import (KernelWeights, Rollout,
                                              model_rollout)
from vidcap_tpu_torch.objectives.multitask import attribute_bce_loss
from vidcap_tpu_torch.objectives.reward import scst_reward
from vidcap_tpu_torch.objectives.reward_tables import (RewardTables,
                                                       tables_from_dataset)
from vidcap_tpu_torch.objectives.scst import scst_loss
from vidcap_tpu_torch.objectives.xe import (masked_xe_loss, shift_right,
                                            token_logp)
from vidcap_tpu_torch.parallel.mesh import ONE_RANK
from vidcap_tpu_torch.train.state import TrainState
from vidcap_tpu_torch.train.steps import (Batch, Grads, Metrics,
                                          add_grads, apply_grads, apply_loss,
                                          draw_seeds, grads_of,
                                          micro_batches)
from vidcap_tpu_torch.utils import profiling


class ScstStep:
    """``step(state, batch, seed=None) → (state, metrics)``. The step's K3
    sampling seeds (one a microbatch, ``train.grad_accum``) come from
    ``seed``, else from ``batch["seed"]`` (int64[grad_accum]: the captured
    step's device buffer), else from ``state.generator``.
    :meth:`body` is the step itself, which reads nothing on the host."""

    def __init__(self, cfg: Config, tables: RewardTables):
        self.cfg = cfg
        self.tables = tables
        t = cfg.train
        self.bleu_mix = t.bleu_mix if t.scst_reward == "cider_bleu" else 0.0
        self.accum = max(1, t.grad_accum)
        self.seeds_per_step = self.accum   # the dispatch draws them
        # the step's collectives: one process's, or a rank's of a mesh
        # (parallel/sharding.py::make_sharded_step)
        self.dp = ONE_RANK
        # K3's W_out mode in the last step's rollouts (ops/rollout.py)
        self.rollout_resident: Optional[bool] = None
        # host seconds make_scst_step_body took to build the tables
        self.tables_seconds: Optional[float] = None

    def _tables(self, device) -> RewardTables:
        if self.tables.ref_tf.device != device:
            self.tables = self.tables.to(device)
        return self.tables

    def rollouts(self, state: TrainState, batch: Batch, seed=None,
                 feats: Optional[torch.Tensor] = None
                 ) -> Tuple[Rollout, Rollout]:
        """(sampled at ``decode.temperature``, greedy): forward only, on the
        features without gradient (``feats``, the step's encode, else the
        batch's encoded here); the weights cast once for both. ``seed``: an
        int or an int64 scalar tensor; None takes the batch's first, else
        draws one from ``state.generator``."""
        if seed is None:
            seed = (batch["seed"][0] if "seed" in batch
                    else draw_seeds(state, 1)[0])
        model, d = state.model, self.cfg.decode
        if feats is None:
            feats = model.encode_features(batch["features"])
        feats = feats.detach()
        if torch.is_tensor(seed):
            seed = seed.to(feats.device)
        # a rank's rows draw the noise one process draws for them
        row0 = self.dp.row0(feats.shape[0])
        r = decoding.route(model.decoder, d, "sample", 1, feats.shape[1],
                           feats.device)
        w = None
        if r.recurrent:
            vocab = self.dp.vocab
            w = KernelWeights(model.decoder, vocab.full(model)
                              if vocab is not None else None).rollout()
            self.rollout_resident = r.resident
        roll = lambda **k: model_rollout(model, r, w, feats, None, d.max_len,
                                         model.decoder.step, early_exit=False,
                                         **k)
        return (roll(sample=True, seed=seed, temperature=d.temperature,
                     row0=row0),
                roll(sample=False, seed=0, temperature=1.0, row0=0))

    def rewards(self, batch: Batch, sample: Rollout, greedy: Rollout
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        tables = self._tables(sample.tokens.device)
        vidx = batch["video_idx"]
        return (scst_reward(tables, vidx, sample.tokens, sample.mask,
                            self.bleu_mix),
                scst_reward(tables, vidx, greedy.tokens, greedy.mask,
                            self.bleu_mix))

    def pieces(self, model, batch: Batch, sample: Rollout, greedy: Rollout,
               rewards: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               *, feats: torch.Tensor):
        """The differentiable part in pieces: (PG loss, XE anchor, its
        token count, BCE, the PG metrics); the XE anchor and its count are
        None without ``scst_xe_mix``, the BCE None without
        ``attribute_loss_weight``. The PG loss is from the re-score of the
        sampled tokens (temperature-scaled log-probs of the emitted tokens,
        masked) against the greedy baseline. ``feats``: the step's
        differentiable encode (``model.encode_features``), which all three
        terms read."""
        t, dp = self.cfg.train, self.dp
        vocab = dp.vocab
        logits = model.xe_logits(feats, None, shift_right(sample.tokens))
        logp = token_logp(logits / max(self.cfg.decode.temperature, 1e-6),
                          sample.tokens, vocab)
        rescored = Rollout(tokens=sample.tokens, logp=logp * sample.mask,
                           mask=sample.mask)
        if rewards is None:
            profiling.phase("reward", sample.tokens)
            rewards = self.rewards(batch, sample, greedy)
            profiling.phase("loss", sample.tokens)
        r_s, r_g = rewards
        pg, metrics = scst_loss(rescored, r_s, r_g, dp)
        xe = ntok = bce = None
        if t.scst_xe_mix > 0:
            # the XE anchor keeps the policy tied to the data distribution
            # while the PG term optimizes CIDEr
            gt = model.xe_logits(feats, None, shift_right(batch["tokens"]))
            # a microbatch's anchor over its own count (accum_grads
            # weights it), else over the global batch's
            denom = (None if self.accum > 1 else torch.clamp(
                dp.sum(batch["mask"].sum()), min=1.0))
            xe, ntok = masked_xe_loss(gt, batch["tokens"], batch["mask"],
                                      vocab, denom)
        if t.attribute_loss_weight > 0:
            bce = attribute_bce_loss(model.attribute_logits(feats),
                                     batch["attributes"])
            if self.accum == 1:
                bce = bce / dp.nd
        return pg, xe, ntok, bce, metrics

    def loss(self, model, batch: Batch, sample: Rollout, greedy: Rollout,
             rewards: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             *, feats: torch.Tensor) -> Tuple[torch.Tensor, Metrics]:
        """The differentiable part: the PG loss, ``scst_xe_mix`` · the XE
        anchor on the ground-truth captions, ``attribute_loss_weight`` ·
        BCE."""
        t = self.cfg.train
        loss, xe, _, bce, metrics = self.pieces(model, batch, sample, greedy,
                                                rewards, feats=feats)
        if xe is not None:
            loss = loss + t.scst_xe_mix * xe
            metrics["xe_anchor"] = xe
        if bce is not None:
            loss = loss + t.attribute_loss_weight * bce
            metrics["attr_loss"] = bce
        metrics["loss"] = loss
        return loss, metrics

    def update(self, state: TrainState, batch: Batch, sample: Rollout,
               greedy: Rollout, feats: Optional[torch.Tensor] = None
               ) -> Tuple[TrainState, Metrics]:
        """The loss and the update; ``feats``: the step's encode, else the
        batch's encoded here."""
        if feats is None:
            feats = state.model.encode_features(batch["features"])
        return apply_loss(state, *self.loss(state.model, batch, sample,
                                            greedy, feats=feats), dp=self.dp)

    def accum_grads(self, state: TrainState, batch: Batch
                    ) -> Tuple[Grads, Metrics]:
        """``train.grad_accum`` = K microbatches (JAX ``accum_grads``), each
        with its own rollouts at its own seed: the PG term by 1/K, each
        normalized by its own sampled-token count (K SCST steps sharing one
        update); the XE anchor by token count over the batch's, exact; the
        BCE by 1/K, exact; the PG metrics averaged over the microbatches.
        On a mesh, this rank's shares (the counts global, the BCE over the
        data ranks too) of each global microbatch: its rows of microbatch m
        are its share of the global batch's (parallel/sharding.py::
        shard_batch), so they sample the one process's noise."""
        t, K, dp = self.cfg.train, self.accum, self.dp
        n_total = torch.clamp(dp.sum(batch["mask"].sum()), min=1.0)
        shares = K * dp.nd
        grads, loss, xe_num, bce_sum, m_sum = None, 0.0, 0.0, 0.0, None
        for m, mb in enumerate(micro_batches(batch, K)):
            # one encode a microbatch: the rollouts' view and the loss's
            profiling.phase("rollout", mb["features"])
            feats = state.model.encode_features(mb["features"])
            sample, greedy = self.rollouts(state, mb, batch["seed"][m],
                                           feats=feats)
            profiling.phase("loss", sample.tokens)
            pg, xe, ntok, bce, metrics = self.pieces(state.model, mb,
                                                     sample, greedy,
                                                     feats=feats)
            c = pg / K
            if xe is not None:
                c = c + t.scst_xe_mix * xe * ntok / n_total
                xe_num = xe_num + (xe * ntok).detach()
            if bce is not None:
                c = c + t.attribute_loss_weight * bce / shares
                bce_sum = bce_sum + bce.detach()
            grads = add_grads(grads, grads_of(state, c))
            loss = loss + c.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
            m_sum = metrics if m_sum is None else {
                k: m_sum[k] + v for k, v in metrics.items()}
        # row means over equal microbatches average exactly;
        # advantage_std is a mean of the microbatches' (logging only)
        metrics = {k: v / K for k, v in m_sum.items()}
        if t.scst_xe_mix > 0:
            metrics["xe_anchor"] = xe_num / n_total
        if t.attribute_loss_weight > 0:
            metrics["attr_loss"] = bce_sum / shares
        metrics["loss"] = loss
        return grads, metrics

    def body(self, state: TrainState, batch: Batch
             ) -> Tuple[TrainState, Metrics]:
        """One step on a batch that brings its seeds (``batch["seed"]``,
        int64[grad_accum]). Its phase marks (``utils/profiling.py::
        phase``), a microbatch's repeated for each: rollout, loss after the
        rollouts, reward, loss after the reward, backward; then update and
        end."""
        if self.accum == 1:
            profiling.phase("rollout", batch["features"])
            feats = state.model.encode_features(batch["features"])
            sample, greedy = self.rollouts(state, batch, batch["seed"][0],
                                           feats=feats)
            profiling.phase("loss", sample.tokens)
            return self.update(state, batch, sample, greedy, feats=feats)
        return apply_grads(state, *self.accum_grads(state, batch),
                           dp=self.dp)

    def __call__(self, state: TrainState, batch: Batch,
                 seed=None) -> Tuple[TrainState, Metrics]:
        if seed is not None:
            batch = {**batch, "seed": torch.as_tensor(
                seed, dtype=torch.int64).reshape(-1)}
        elif "seed" not in batch:
            batch = {**batch, "seed": draw_seeds(state, self.accum)}
        return self.body(state, batch)


def make_scst_step_body(cfg: Config, dataset=None,
                        tables: Optional[RewardTables] = None) -> ScstStep:
    """The SCST step; the reward tables come from ``dataset`` (built on the
    host once, timed in ``tables_seconds``) unless given."""
    seconds = None
    if tables is None:
        if dataset is None:
            raise ValueError("make_scst_step_body needs a dataset or tables")
        t0 = time.perf_counter()
        tables = tables_from_dataset(dataset)
        seconds = time.perf_counter() - t0
    step = ScstStep(cfg, tables)
    step.tables_seconds = seconds
    return step
