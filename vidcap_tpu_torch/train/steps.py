"""Train steps: forward, loss, gradients by autograd, the optimizer update.

``make_xe_step_body`` is the cross-entropy stage of
``vidcap_tpu/train/steps.py`` (XE plus ``attribute_loss_weight`` · BCE).
The gradients come from plain PyTorch autograd on the model's modules, as
the JAX package takes them from XLA: it runs no backward kernel. The step
updates the state in place and returns it with its metrics (device
scalars; read them only where the host needs them).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from vidcap_tpu_torch.config import Config
from vidcap_tpu_torch.objectives.multitask import attribute_bce_loss
from vidcap_tpu_torch.objectives.xe import masked_xe_loss, shift_right
from vidcap_tpu_torch.train.state import TrainState, optax_global_norm

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]
StepFn = Callable[[TrainState, Batch], Tuple[TrainState, Metrics]]


def refuse_unported(cfg: Config) -> None:
    """Raise for the step options the port does not have yet."""
    if cfg.train.grad_accum > 1:
        raise NotImplementedError(
            f"train.grad_accum={cfg.train.grad_accum} (microbatched "
            "gradients) is not ported to vidcap_tpu_torch yet (ROADMAP "
            "Queue 1 item 11)")


def apply_loss(state: TrainState, loss: torch.Tensor, metrics: Metrics
               ) -> Tuple[TrainState, Metrics]:
    """Gradients of ``loss`` by autograd (zeros for parameters it does not
    reach, as JAX gives), ``grad_norm`` before the clip, the update."""
    params = state.params
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = optax_global_norm(grads)
    return state.apply_gradients(grads), metrics


def xe_losses(cfg: Config, model, batch: Batch) -> Tuple[torch.Tensor,
                                                          Metrics]:
    """The XE stage's total loss and its pieces: the token-mean XE, the
    token count, and the attribute BCE when its weight is > 0. One encode
    feeds both heads."""
    attr_w = cfg.train.attribute_loss_weight
    feats = model.encode_features(batch["features"])
    logits = model.xe_logits(feats, None, shift_right(batch["tokens"]))
    xe, ntok = masked_xe_loss(logits, batch["tokens"], batch["mask"])
    metrics = {"xe_loss": xe, "tokens": ntok}
    total = xe
    if attr_w > 0:
        bce = attribute_bce_loss(model.attribute_logits(feats),
                                 batch["attributes"])
        total = total + attr_w * bce
        metrics["attr_loss"] = bce
    metrics["loss"] = total
    return total, metrics


def make_xe_step_body(cfg: Config) -> StepFn:
    """The cross-entropy step: ``body(state, batch) → (state, metrics)``;
    the batch is a dict of tensors on the model's device (features,
    tokens, mask, attributes, video_idx)."""
    refuse_unported(cfg)

    def body(state: TrainState, batch: Batch):
        return apply_loss(state, *xe_losses(cfg, state.model, batch))
    return body
