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
  both scale by ``-lr(count)`` with the count before the increment;
* a stage that trains through the CNN backbone (``e2e``, or ``scst`` with
  ``model.use_backbone``) with ``backbone_lr_scale`` ≠ 1 gives the
  backbone's parameters the learning rate ``lr(count) · scale``, computed as
  Optax computes the reference's ``multi_transform`` group: the clip stays
  global, each group's Adam state is elementwise, so only the rate differs.

The update reads nothing on the host, so that a CUDA graph can replay it:
the count is a device int64, the learning rate and both bias corrections
come from tables of every count the stage can reach (built on the host once,
in the f32 arithmetic above, and gathered by the device count), and the
moments and parameters are written in place.

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


def scaled_schedule(t, scale: float) -> Schedule:
    """The backbone group's rate, ``schedule · scale``, in the reference's
    arithmetic: a constant schedule (no warmup) is a Python float there, so
    the product is taken in f64 and rounded once; a callable one returns f32
    and the scale is cast to f32 before the product."""
    base = make_lr_schedule(t)
    if t.lr_schedule == "constant" and t.warmup_steps <= 0:
        return lambda count: float(_f32(t.learning_rate * scale))
    return lambda count: float(_f32(base(count)) * _f32(scale))


B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults


def optax_global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ_leaves Σ x²) of a gradient dict, the leaves in name order
    (the Flax tree's order)."""
    return torch.sqrt(sum(torch.sum(grads[k] * grads[k])
                          for k in sorted(grads)))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The Optax chain of the module docstring for up to ``num_steps``
    updates. State: ``{"count": i64 scalar, "mu": {name: f32}, "nu": {name:
    f32}, "table": f32[4, num_steps + 1]}`` on the parameters' device; row
    c of the table is (lr(c), 1 - b1^(c+1), 1 - b2^(c+1), the backbone
    group's lr(c)). Without ``backbone_schedule`` every parameter takes
    ``schedule``."""

    schedule: Schedule
    grad_clip_norm: float
    weight_decay: float = 0.0
    num_steps: int = 0
    backbone_schedule: Optional[Schedule] = None

    def table(self, device) -> torch.Tensor:
        bb = self.backbone_schedule or self.schedule
        rows = []
        for c in range(self.num_steps + 1):
            n = _f32(c + 1)   # the count after the increment
            rows.append((self.schedule(c), _f32(1) - _f32(B1) ** n,
                         _f32(1) - _f32(B2) ** n, bb(c)))
        return torch.tensor(np.asarray(rows, np.float32).T, device=device)

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        device = next(iter(params.values())).device
        return {"count": torch.zeros((), dtype=torch.int64, device=device),
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()},
                "table": self.table(device)}

    @staticmethod
    @torch.no_grad()
    def reset(opt_state: Dict) -> None:
        """Back to the state of :meth:`init`, in place."""
        opt_state["count"].zero_()
        for m in ("mu", "nu"):
            for t in opt_state[m].values():
                t.zero_()

    @torch.no_grad()
    def clip(self, grads: Dict[str, torch.Tensor],
             norm: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """``norm``: the gradient's global norm where the caller has it
        (a rank holding part of the gradient), else computed here."""
        if norm is None:
            norm = optax_global_norm(grads)
        limit = self.grad_clip_norm
        return {k: torch.where(norm < limit, g, g / norm * limit)
                for k, g in grads.items()}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], opt_state: Dict,
               norm: Optional[torch.Tensor] = None) -> None:
        """One step, in place: the parameters and ``opt_state``; ``norm``:
        as :meth:`clip`."""
        grads = self.clip(grads, norm)
        row = opt_state["table"].index_select(1, opt_state["count"].view(1))
        lr_rest, bc1, bc2, lr_bb = row[0, 0], row[1, 0], row[2, 0], row[3, 0]
        for k, p in params.items():
            lr = lr_bb if k.startswith("backbone.") else lr_rest
            g = grads[k]
            mu, nu = opt_state["mu"][k], opt_state["nu"][k]
            mu.copy_((1 - B1) * g + B1 * mu)
            nu.copy_((1 - B2) * (g * g) + B2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            if self.weight_decay > 0:
                u = u + self.weight_decay * p
            p.copy_(p + u * (-lr))
        opt_state["count"].add_(1)


def make_optimizer(cfg: Config, num_steps: Optional[int] = None
                   ) -> Optimizer:
    """The stage's optimizer, its tables long enough for ``num_steps``
    updates (default ``cfg.train.num_steps``; the schedule's own horizon
    stays ``cfg.train``'s)."""
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
    # any stage that fine-tunes through the CNN gets the scaled backbone
    # rate: the plain e2e stage, and SCST with use_backbone (the composed
    # e2e_scst_multitask)
    through_cnn = t.stage == "e2e" or (t.stage == "scst"
                                       and cfg.model.use_backbone)
    bb = (scaled_schedule(t, t.backbone_lr_scale)
          if through_cnn and t.backbone_lr_scale != 1.0 else None)
    return Optimizer(make_lr_schedule(t), t.grad_clip_norm, t.weight_decay,
                     max(num_steps or 0, t.num_steps), bb)


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

    def apply_gradients(self, grads: Dict[str, torch.Tensor],
                        norm: Optional[torch.Tensor] = None
                        ) -> "TrainState":
        if self.step >= self.tx.num_steps:
            # the count is at most the step; a later row does not exist
            raise ValueError(f"step {self.step}: the optimizer's tables end "
                             f"at {self.tx.num_steps} updates")
        self.tx.update(self.params, grads, self.opt_state, norm)
        self.step += 1
        return self


def create_train_state(cfg: Config, model: torch.nn.Module,
                       seed: Optional[int] = None,
                       num_steps: Optional[int] = None) -> TrainState:
    """``num_steps``: the step the stage runs to, where it is past
    ``cfg.train.num_steps``."""
    tx = make_optimizer(cfg, num_steps)
    gen = torch.Generator().manual_seed(seed if seed is not None
                                        else cfg.train.seed)
    return TrainState(step=0, model=model,
                      opt_state=tx.init(dict(model.named_parameters())),
                      generator=gen, tx=tx)
