"""Train steps: forward, loss, gradients by autograd, the optimizer update,
and their dispatch.

``make_xe_step_body`` is the cross-entropy stage of
``vidcap_tpu/train/steps.py`` (XE plus ``attribute_loss_weight`` · BCE),
with ``train.grad_accum`` microbatches weighted so that their summed
gradient equals the full batch's (``accum_grads``). It is also the ``e2e``
stage: on pixel batches the inputs go through the IRv2 backbone once a
(micro)batch, and the XE head and the attribute head share that encode. The gradients come from
plain PyTorch autograd on the model's modules, as the JAX package takes them
from XLA: it runs no backward kernel. A step body updates the state in place
and returns it with its metrics (device scalars), and reads nothing on the
host.

The dispatch is the counterpart of the JAX package's ``jax.jit``: on the
card every step is a CUDA graph, captured on the first call and replayed
after (:class:`Captured`); on the CPU the body runs eagerly. ``make_step``
dispatches one step a call; ``make_banked_step`` gathers features and
attributes from a device-resident bank by ``video_idx``
(``train.device_feature_bank``); ``make_banked_multistep`` advances K steps
a call (``train.steps_per_dispatch``), one graph of K steps on the card.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vidcap_tpu_torch.config import Config
from vidcap_tpu_torch.models.decoder import Dropout
from vidcap_tpu_torch.objectives.multitask import attribute_bce_loss
from vidcap_tpu_torch.objectives.xe import masked_xe_loss, shift_right
from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.parallel.mesh import ONE_RANK
from vidcap_tpu_torch.train.state import TrainState
from vidcap_tpu_torch.utils import profiling

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]
StepFn = Callable[[TrainState, Batch], Tuple[TrainState, Metrics]]
Grads = Dict[str, torch.Tensor]


def grads_of(state: TrainState, loss: torch.Tensor) -> Grads:
    """d loss / d parameters by autograd (zeros for parameters it does not
    reach, as JAX gives), after the ``backward`` phase mark."""
    profiling.phase("backward", loss)
    params = state.params
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grads)}


def apply_grads(state: TrainState, grads: Grads, metrics: Metrics,
                dp=ONE_RANK) -> Tuple[TrainState, Metrics]:
    """``grad_norm`` before the clip, then the update. ``dp``
    (parallel/sharding.py::DataParallel on a mesh): ``grads`` and
    ``metrics`` are this rank's shares, summed over the data axis here (the
    gradients in one all-reduce) before the norm and the update. The
    ``update`` phase mark comes first, the ``end`` mark last."""
    like = next(iter(grads.values()))
    profiling.phase("update", like)
    grads = dp.reduce_grads(grads)
    metrics = dp.reduce_metrics({k: v.detach() for k, v in metrics.items()})
    metrics["grad_norm"] = norm = dp.global_norm(grads)
    state = state.apply_gradients(grads, norm)
    profiling.phase("end", like)
    return state, metrics


def apply_loss(state: TrainState, loss: torch.Tensor, metrics: Metrics,
               dp=ONE_RANK) -> Tuple[TrainState, Metrics]:
    """The gradients of ``loss``, ``grad_norm`` before the clip, the
    update (``dp``: as :func:`apply_grads`)."""
    return apply_grads(state, grads_of(state, loss), metrics, dp)


def micro_batches(batch: Batch, accum: int) -> List[Batch]:
    """The batch split into ``accum`` equal microbatches along the rows."""
    B = batch["tokens"].shape[0]
    if B % accum:
        raise ValueError(
            f"batch size {B} is not divisible by grad_accum {accum}")
    return [{k: v if k == "seed" else v[m * (B // accum):(m + 1)
                                        * (B // accum)]
             for k, v in batch.items()} for m in range(accum)]


def add_grads(total: Optional[Grads], grads: Grads) -> Grads:
    return grads if total is None else {k: total[k] + g
                                        for k, g in grads.items()}


def dropout_of(cfg: Config, batch: Batch, row0: int) -> Optional[Dropout]:
    """The training instance's dropout (``model.dropout_rate`` > 0) at the
    step's seed, ``batch["seed"][0]``, for rows from global row ``row0``;
    None at rate 0."""
    rate = cfg.model.dropout_rate
    return Dropout(rate, batch["seed"][0], row0) if rate > 0 else None


def xe_pieces(cfg: Config, model, batch: Batch, row0: int = 0,
              vocab=None, denom: Optional[torch.Tensor] = None):
    """(token-mean XE, token count, attribute BCE or None): one encode feeds
    both heads. ``row0``: the global row of the batch's first row (the
    dropout masks' key); ``vocab``, ``denom``: as ``masked_xe_loss``."""
    feats = model.encode_features(batch["features"])
    logits = model.xe_logits(feats, None, shift_right(batch["tokens"]),
                             dropout_of(cfg, batch, row0))
    xe, ntok = masked_xe_loss(logits, batch["tokens"], batch["mask"], vocab,
                              denom)
    bce = None
    if cfg.train.attribute_loss_weight > 0:
        bce = attribute_bce_loss(model.attribute_logits(feats),
                                 batch["attributes"])
    return xe, ntok, bce


def xe_losses(cfg: Config, model, batch: Batch, dp=ONE_RANK
              ) -> Tuple[torch.Tensor, Metrics]:
    """The XE stage's total loss and its pieces: the token-mean XE, the
    token count, and the attribute BCE when its weight is > 0. ``dp``: on a
    mesh, this rank's share of the global batch's (XE over the global
    token count, BCE over the data ranks)."""
    n_global = torch.clamp(dp.sum(batch["mask"].sum()), min=1.0)
    xe, ntok, bce = xe_pieces(cfg, model, batch,
                              dp.row0(batch["tokens"].shape[0]), dp.vocab,
                              n_global)
    metrics = {"xe_loss": xe, "tokens": ntok}
    total = xe
    if bce is not None:
        bce = bce / dp.nd
        total = total + cfg.train.attribute_loss_weight * bce
        metrics["attr_loss"] = bce
    metrics["loss"] = total
    return total, metrics


def accum_grads(cfg: Config, state: TrainState, batch: Batch, dp=ONE_RANK
                ) -> Tuple[Grads, Metrics]:
    """``train.grad_accum`` = K microbatches, their gradients summed so
    that the sum equals the full-batch gradient (JAX ``accum_grads``): each
    microbatch's XE weighted by its token count over the batch's, its BCE
    (a row mean over equal microbatches) by 1/K. Only one microbatch's
    activations are alive at a time. The dropout masks are keyed by each
    row's place in the batch, so each microbatch draws its own. ``dp``: on
    a mesh this rank's share, as :func:`xe_losses`; its rows of microbatch
    m are its share of the global batch's microbatch m
    (parallel/sharding.py::shard_batch)."""
    accum, attr_w = cfg.train.grad_accum, cfg.train.attribute_loss_weight
    micro = micro_batches(batch, accum)
    rows = batch["tokens"].shape[0] // accum   # this rank's, a microbatch
    shares = accum * dp.nd
    n_total = torch.clamp(dp.sum(batch["mask"].sum()), min=1.0)
    grads, xe_num, ntok, bce_sum = None, 0.0, 0.0, 0.0
    for m, mb in enumerate(micro):
        xe, nt, bce = xe_pieces(cfg, state.model, mb,
                                m * rows * dp.nd + dp.row0(rows), dp.vocab)
        c = xe * nt / n_total
        if bce is not None:
            c = c + attr_w * bce / shares
            bce_sum = bce_sum + bce.detach()
        grads = add_grads(grads, grads_of(state, c))
        xe_num = xe_num + (xe * nt).detach()
        ntok = ntok + nt
    xe_mean = xe_num / n_total          # == the full-batch masked XE
    metrics = {"xe_loss": xe_mean, "tokens": dp.sum(ntok)}
    total = xe_mean
    if attr_w > 0:
        bce_mean = bce_sum / shares     # == the full-batch row mean
        total = total + attr_w * bce_mean
        metrics["attr_loss"] = bce_mean
    metrics["loss"] = total
    return grads, metrics


def xe_grads(cfg: Config, state: TrainState, batch: Batch, dp=ONE_RANK
             ) -> Tuple[Grads, Metrics]:
    """The XE step's gradients and metrics, microbatched when
    ``train.grad_accum`` > 1 (``dp``: this rank's shares on a mesh)."""
    if cfg.train.grad_accum > 1:
        return accum_grads(cfg, state, batch, dp)
    loss, metrics = xe_losses(cfg, state.model, batch, dp)
    return grads_of(state, loss), metrics


class XeStep:
    """The cross-entropy step: ``body(state, batch) → (state, metrics)``;
    the batch is a dict of tensors on the model's device (features,
    tokens, mask, attributes, video_idx, and with dropout its seed, which
    the dispatch draws: one a step). ``dp``: the step's collectives, one
    process's unless ``parallel/sharding.py::make_sharded_step`` sets a
    mesh's."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.dp = ONE_RANK
        self.seeds_per_step = 1 if cfg.model.dropout_rate > 0 else 0

    def __call__(self, state: TrainState, batch: Batch):
        return apply_grads(state, *xe_grads(self.cfg, state, batch, self.dp),
                           dp=self.dp)


def make_xe_step_body(cfg: Config) -> XeStep:
    """The cross-entropy step (:class:`XeStep`)."""
    return XeStep(cfg)


# ---------------------------------------------------------------- dispatch

def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    opt = state.opt_state
    return (list(state.params.values()) + list(opt["mu"].values())
            + list(opt["nu"].values()) + [opt["count"]])


class Captured:
    """``run(state, static) → metrics`` as one CUDA graph: the counterpart
    of ``jax.jit`` with the state donated. ``run`` advances the state by
    ``steps`` steps in place and reads its inputs from the tensors of
    ``static``, which the caller refills before each :meth:`replay`.

    Before the capture ``run`` is called once eagerly on a side stream, so
    that what it sets up lazily (the kernels' libraries, the reward tables
    on the card, cuBLAS's workspace) exists before the capture; the
    parameters, the moments and the count are then written back, so that
    the warm-up leaves no trace in the trajectory (the generator is not
    read: the caller draws the seeds). On pixel batches the warm-up is also
    where cuDNN picks its convolution algorithms and the backbone's
    recomputed blocks first run, so the capture records their steady
    kernels. Its kernel launches are not counted.
    The capture's own launches are taken back out of the counts and added
    at each replay. Nothing falls back to the eager step: a capture or a
    replay that fails raises."""

    def __init__(self, run: Callable[[TrainState, Batch], Metrics],
                 state: TrainState, static: Batch, steps: int):
        self.steps = steps
        step0 = state.step
        saved = [t.clone() for t in _state_tensors(state)]
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            _build.counted(lambda: run(state, static))
        cur.wait_stream(side)
        with torch.no_grad():
            for t, s in zip(_state_tensors(state), saved):
                t.copy_(s)
        del saved
        state.step = step0
        self.graph = torch.cuda.CUDAGraph()

        def capture():
            # on the warm-up's stream: the parameters' gradient accumulators
            # the warm-up made are on it
            with torch.cuda.graph(self.graph, stream=side):
                return run(state, static)
        self.out, self.launches = _build.counted(capture)
        state.step = step0

    def replay(self, state: TrainState) -> Metrics:
        """Run the graph once; the metrics it returns are overwritten by
        the next replay."""
        self.graph.replay()
        state.step += self.steps
        _build.add_counts(self.launches)
        return self.out


def _build_banks(dataset, banks=None, device=None) -> Dict[str, torch.Tensor]:
    """The whole feature and attribute tensors on ``device``, once (shared
    by ``make_banked_step`` and ``make_banked_multistep``: the banks exist
    on the device once)."""
    feats = dataset.features
    if feats.ndim != 3:
        raise ValueError(
            "device_feature_bank requires feature-mode inputs [N, T, D]; "
            f"got ndim={feats.ndim} (pixel/e2e datasets are too large to "
            "bank)")
    if banks is None:
        banks = {"features": torch.as_tensor(np.asarray(feats, np.float32),
                                             device=device),
                 "attributes": torch.as_tensor(
                     np.asarray(dataset.attributes, np.float32),
                     device=device)}
    return banks


def _banked_apply(body: StepFn, banks: Dict[str, torch.Tensor]) -> StepFn:
    """``body`` with features and attributes gathered from the banks by
    ``video_idx``: the one place the gather lives, so the tail's single
    steps and a chunk's steps cannot diverge."""
    def banked(state: TrainState, batch: Batch):
        b = dict(batch)
        vidx = batch["video_idx"]
        b["features"] = banks["features"].index_select(0, vidx)
        b["attributes"] = banks["attributes"].index_select(0, vidx)
        return body(state, b)
    banked.seeds_per_step = getattr(body, "seeds_per_step", 0)
    return banked


def draw_seeds(state: TrainState, n: int) -> torch.Tensor:
    """n sampling seeds from the state's generator, int64[n] on the host:
    the same values, in the same order, as n draws of one."""
    return torch.randint(0, 2**31 - 1, (n,), generator=state.generator)


class _Dispatch:
    """``fn(state, batch) → (state, metrics)`` for ``k`` steps a call
    (``batch`` and the metrics with a leading [k] axis when k > 1). The
    batch's tensors may sit on the host or the device; the caller keeps
    their order. A body with ``seeds_per_step`` (SCST) gets that many
    seeds a step, drawn here from ``state.generator`` unless the batch
    brings them."""

    def __init__(self, body: StepFn, device, k: int = 1):
        self.body = body
        self.device = torch.device(device)
        self.k = k
        self.seeds = getattr(body, "seeds_per_step", 0)
        self.graph: Optional[Captured] = None
        self.static: Optional[Batch] = None

    def _run(self, state: TrainState, batch: Batch) -> Metrics:
        if self.k == 1:
            return self.body(state, batch)[1]
        ms = [self.body(state, {key: v[j] for key, v in batch.items()})[1]
              for j in range(self.k)]
        return {key: torch.stack([m[key] for m in ms]) for key in ms[0]}

    def _inputs(self, state: TrainState, batch: Batch) -> Batch:
        """The batch with its seeds, on the device: on the card the static
        tensors the graph reads, refilled."""
        batch = {key: torch.as_tensor(v) for key, v in batch.items()}
        if self.seeds and "seed" not in batch:
            s = draw_seeds(state, self.k * self.seeds)
            batch["seed"] = s.view(self.k, self.seeds) if self.k > 1 else s
        if self.device.type != "cuda":
            return {key: v.to(self.device) for key, v in batch.items()}
        if self.static is None:
            self.static = {key: torch.empty(v.shape, dtype=v.dtype,
                                            device=self.device)
                           for key, v in batch.items()}
        for key, v in batch.items():
            self.static[key].copy_(v, non_blocking=True)
        return self.static

    def __call__(self, state: TrainState, batch: Batch
                 ) -> Tuple[TrainState, Metrics]:
        """While tracing is on, the spans ``dispatch.inputs`` (the seeds
        and the copies into the static batch) and ``dispatch.replay`` (the
        graph's replay, on the CPU the body), ``id`` the state's step."""
        step = state.step
        with profiling.annotate("dispatch.inputs", step):
            batch = self._inputs(state, batch)
        if self.device.type != "cuda":
            with profiling.annotate("dispatch.replay", step):
                return state, self._run(state, batch)
        if self.graph is None:
            self.graph = Captured(self._run, state, batch, self.k)
        with profiling.annotate("dispatch.replay", step):
            return state, self.graph.replay(state)


def make_step(body: StepFn, device) -> StepFn:
    """One step a call: on the card one CUDA graph replay (captured on the
    first call), on the CPU the body itself. The batch brings features and
    attributes."""
    return _Dispatch(body, device)


def make_banked_step(body: StepFn, dataset, banks=None, device=None
                     ) -> Tuple[StepFn, Dict[str, torch.Tensor]]:
    """``body`` with the features and attributes of the whole dataset
    resident on ``device`` (``train.device_feature_bank``): each step
    gathers its rows by ``video_idx``, so the batch carries only tokens,
    mask and indices. The same rows as the loader slices on the host, so
    the same numbers. Returns ``(step_fn, banks)``."""
    banks = _build_banks(dataset, banks, device)
    return _Dispatch(_banked_apply(body, banks), device), banks


def make_banked_multistep(body: StepFn, dataset, k: int, banks=None,
                          device=None
                          ) -> Tuple[StepFn, Dict[str, torch.Tensor]]:
    """K banked steps a call (``train.steps_per_dispatch``): ``step_fn(
    state, batches)`` takes the K batches stacked along a leading axis and
    returns each metric as [K], step j's in slot j. On the card the K steps
    are one graph, so the host dispatches once a chunk. The same body on the
    same batch stream in the same order as K single steps, so the same
    numbers."""
    banks = _build_banks(dataset, banks, device)
    return _Dispatch(_banked_apply(body, banks), device, k), banks
