"""Train state and optimizer, with the arithmetic of
``vidcap_tpu/train/state.py``'s Optax chain written out by hand:

  clip_by_global_norm(grad_clip_norm) → adam | adamw(schedule, weight_decay)

* the clip leaves the gradients as they are when their global norm is below
  the limit, else takes ``(g / norm) · limit`` (``torch.nn.utils.
  clip_grad_norm_`` would add 1e-6 to the norm);
* Adam: ``μ = (1-b1)·g + b1·μ``, ``ν = (1-b2)·g² + b2·ν``, bias-corrected by
  ``1 - b^count`` after the count is incremented, and the update
  ``μ̂ / (sqrt(ν̂) + eps)`` (eps outside the square root);
* AdamW adds ``weight_decay · param`` to that update (decoupled decay), then
  both scale by ``-lr(count)`` with the count before the increment.

Randomness is explicit: one CPU ``torch.Generator`` in the state, saved and
restored with the checkpoint (train/checkpoint.py).
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch

from vidcap_tpu_torch.config import Config

Schedule = Callable[[int], float]
_f32 = np.float32


def make_lr_schedule(t) -> Schedule:
    """count → learning rate from a TrainConfig, as Optax computes it in
    f32: optional linear warmup to ``learning_rate``, then constant, cosine
    decay (to ``lr_decay_rate·lr`` over ``lr_decay_steps``, default
    ``num_steps``) or smooth exponential decay (×``lr_decay_rate`` every
    ``lr_decay_steps``). The decay clock starts when the warmup ends."""
    peak = t.learning_rate
    decay_steps = t.lr_decay_steps if t.lr_decay_steps > 0 else t.num_steps
    if t.lr_schedule == "constant":
        def base(count):
            return _f32(peak)
    elif t.lr_schedule == "cosine":
        if not decay_steps > 0:
            raise ValueError(f"cosine schedule needs decay steps > 0, got "
                             f"{decay_steps}")
        alpha, keep = _f32(t.lr_decay_rate), _f32(1 - t.lr_decay_rate)

        def base(count):
            c = _f32(min(count, decay_steps))
            cos = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * c
                                                / _f32(decay_steps)))
            return _f32(peak) * (keep * cos + alpha)
    elif t.lr_schedule == "exponential":
        def base(count):
            if decay_steps <= 0 or t.lr_decay_rate == 0 or count <= 0:
                return _f32(peak)
            p = _f32(count) / _f32(decay_steps)
            return _f32(peak) * np.power(_f32(t.lr_decay_rate), p)
    else:
        raise ValueError(f"unknown lr_schedule {t.lr_schedule!r}; "
                         "use constant | cosine | exponential")
    if t.warmup_steps <= 0:
        return lambda count: float(base(count))
    w = t.warmup_steps

    def schedule(count):
        if count >= w:
            return float(base(count - w))
        frac = _f32(1) - _f32(min(max(count, 0), w)) / _f32(w)
        return float((_f32(0) - _f32(peak)) * frac + _f32(peak))
    return schedule


B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults


def optax_global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ_leaves Σ x²) of a gradient dict, the leaves in name order
    (the Flax tree's order)."""
    return torch.sqrt(sum(torch.sum(grads[k] * grads[k])
                          for k in sorted(grads)))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The Optax chain of the module docstring. State: ``{"count": int,
    "mu": {name: f32}, "nu": {name: f32}}``."""

    schedule: Schedule
    grad_clip_norm: float
    weight_decay: float = 0.0

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def clip(self, grads: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        norm = optax_global_norm(grads)
        limit = self.grad_clip_norm
        return {k: torch.where(norm < limit, g, g / norm * limit)
                for k, g in grads.items()}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], opt_state: Dict) -> None:
        """One step, in place: the parameters and ``opt_state``."""
        grads = self.clip(grads)
        lr = self.schedule(opt_state["count"])
        count = opt_state["count"] + 1
        # f32 scalars, as Optax computes them
        bc1 = float(_f32(1) - _f32(B1) ** _f32(count))
        bc2 = float(_f32(1) - _f32(B2) ** _f32(count))
        for k, p in params.items():
            g = grads[k]
            mu = (1 - B1) * g + B1 * opt_state["mu"][k]
            nu = (1 - B2) * (g * g) + B2 * opt_state["nu"][k]
            opt_state["mu"][k], opt_state["nu"][k] = mu, nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            if self.weight_decay > 0:
                u = u + self.weight_decay * p
            p.copy_(p + u * (-lr))
        opt_state["count"] = count


def make_optimizer(cfg: Config) -> Optimizer:
    t = cfg.train
    if t.stage == "scst":
        # policy-gradient fine-tuning needs a much smaller rate than XE; the
        # implicit /20 default is announced so that configs written against
        # "learning_rate IS the SCST rate" are not retuned in silence
        if t.scst_learning_rate is not None:
            lr = t.scst_learning_rate
        else:
            lr = t.learning_rate / 20.0
            print(f"[vidcap] SCST stage: scst_learning_rate unset — using "
                  f"learning_rate/20 = {lr:g} (set train.scst_learning_rate "
                  f"to override)", file=sys.stderr)
        t = dataclasses.replace(t, learning_rate=lr)
    through_cnn = t.stage == "e2e" or (t.stage == "scst"
                                       and cfg.model.use_backbone)
    if through_cnn:
        raise NotImplementedError(
            f"stage {t.stage!r} through the CNN backbone (and its "
            "backbone_lr_scale group) is not ported to vidcap_tpu_torch yet "
            "(ROADMAP Queue 1 item 11)")
    return Optimizer(make_lr_schedule(t), t.grad_clip_norm, t.weight_decay)


@dataclasses.dataclass
class TrainState:
    """step; the model, whose parameters the optimizer updates in place;
    the optimizer state; the generator every random draw of training takes
    from (the SCST sampling seed); the optimizer."""

    step: int
    model: torch.nn.Module
    opt_state: Dict
    generator: torch.Generator
    tx: Optimizer

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def apply_gradients(self, grads: Dict[str, torch.Tensor]
                        ) -> "TrainState":
        self.tx.update(self.params, grads, self.opt_state)
        self.step += 1
        return self


def create_train_state(cfg: Config, model: torch.nn.Module,
                       seed: Optional[int] = None) -> TrainState:
    tx = make_optimizer(cfg)
    gen = torch.Generator().manual_seed(seed if seed is not None
                                        else cfg.train.seed)
    return TrainState(step=0, model=model,
                      opt_state=tx.init(dict(model.named_parameters())),
                      generator=gen, tx=tx)
