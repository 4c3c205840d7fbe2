"""One training stage on one device, as ``vidcap_tpu/train/loop.py``'s
``train()``: the model from the seeded init, an exact mid-stage resume or a
cross-stage one (xe → scst: parameters restored, optimizer fresh), the
deterministic batch stream, logging and the checkpoint cadence.

Runs on the card unless the caller asks for the CPU. Not ported, each
raising ``NotImplementedError`` with its ROADMAP item: the mesh, the device
feature bank and multi-step dispatch, prefetch, and periodic validation with
best-checkpoint selection (it needs the metrics package).
"""
from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from vidcap_tpu_torch.config import Config
from vidcap_tpu_torch.data.loader import Batch, CaptionDataset
from vidcap_tpu_torch.data.pipeline import DeterministicBatcher
from vidcap_tpu_torch.inference import resolve_device
from vidcap_tpu_torch.models.model import create_model, init_params
from vidcap_tpu_torch.ops._build import launch_counts
from vidcap_tpu_torch.train.checkpoint import CheckpointManager
from vidcap_tpu_torch.train.scst import make_scst_step_body
from vidcap_tpu_torch.train.state import TrainState, create_train_state
from vidcap_tpu_torch.train.steps import make_xe_step_body
from vidcap_tpu_torch.utils.logging import MetricsLogger


def batch_to_device(batch: Batch, device) -> Dict[str, torch.Tensor]:
    """Batch → the dict of tensors a step consumes, on ``device``."""
    return {k: torch.as_tensor(getattr(batch, k), device=device)
            for k in ("features", "tokens", "mask", "attributes",
                      "video_idx")}


def _refuse_unported(cfg: Config, num_steps: int, mesh) -> None:
    t = cfg.train
    if mesh is not None:
        raise NotImplementedError(
            "multi-device training (the mesh) is not ported to "
            "vidcap_tpu_torch yet (ROADMAP Queue 1 item 12)")
    if t.device_feature_bank or t.steps_per_dispatch > 1:
        raise NotImplementedError(
            "train.device_feature_bank and train.steps_per_dispatch > 1 are "
            "not ported to vidcap_tpu_torch yet (ROADMAP Queue 1 item 12)")
    if t.prefetch_depth > 0:
        raise NotImplementedError(
            "train.prefetch_depth > 0 (background prefetch) is not ported to "
            "vidcap_tpu_torch yet (ROADMAP Queue 1 item 12)")
    if 0 < t.eval_every <= num_steps:
        raise NotImplementedError(
            f"periodic validation (train.eval_every={t.eval_every} within "
            f"{num_steps} steps) and best-checkpoint selection need the "
            "metrics package, not ported to vidcap_tpu_torch yet (ROADMAP "
            "Queue 1 item 4 remainder, 'eval'); set train.eval_every=0 "
            "(CLI --eval-every 0)")


def _salted(gen: torch.Generator, salt: int) -> torch.Generator:
    """A generator seeded from one draw of ``gen`` and ``salt``: repeated
    fine-tuning runs off one checkpoint draw independent streams."""
    drawn = int(torch.randint(0, 2**62, (1,), generator=gen))
    seed = np.random.SeedSequence([drawn, salt]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed) >> 1)


def train(cfg: Config, dataset: Optional[CaptionDataset] = None,
          num_steps: Optional[int] = None,
          logger: Optional[MetricsLogger] = None, resume: bool = False,
          device: Optional[str] = None, mesh=None) -> TrainState:
    """Run one stage (``cfg.train.stage``: "xe" or "scst") up to step
    ``num_steps`` (default ``cfg.train.num_steps``; counts are cumulative
    over stages); returns the final TrainState. Ends with one stderr line:
    the stage, the steps run, the device, K3's W_out mode (SCST) and the
    kernel launches of this call."""
    t = cfg.train
    num_steps = num_steps or t.num_steps
    _refuse_unported(cfg, num_steps, mesh)
    dev = resolve_device(device)
    dataset = dataset or CaptionDataset.synthetic(cfg.data)
    logger = logger or MetricsLogger()

    model = init_params(create_model(cfg, vocab_size=dataset.vocab.size),
                        seed=t.seed).to(dev)
    state = create_train_state(cfg, model)
    ckpt = CheckpointManager(t.checkpoint_dir)
    iter_state = None
    if resume and ckpt.latest_step() is not None:
        saved = ckpt.saved_stage()
        if saved is not None and saved != t.stage:
            # never carry the previous objective's optimizer moments across
            # a stage change, even where the structures match (xe → scst)
            print(f"[vidcap] resuming across stages ({saved} → {t.stage}): "
                  "params restored, optimizer re-initialised",
                  file=sys.stderr)
            state, iter_state = ckpt.restore_params_only(state,
                                                         with_iter=True)
            if t.rng_salt:
                # mid-stage (exact) resume never takes this branch
                state.generator = _salted(state.generator, t.rng_salt)
        else:
            state, iter_state = ckpt.restore(state, with_iter=True)

    if t.stage == "xe":
        step_fn = make_xe_step_body(cfg)
    elif t.stage == "scst":
        step_fn = make_scst_step_body(cfg, dataset)
    else:
        raise ValueError(f"unknown stage {t.stage!r}")

    start = state.step
    launches0 = dict(launch_counts)
    it = DeterministicBatcher(dataset, t.batch_size, state=iter_state,
                              seed=t.seed)
    t_last, s_last = time.time(), start
    for i in range(start, num_steps):
        batch = batch_to_device(next(it), dev)
        state, metrics = step_fn(state, batch)
        if (t.log_every > 0 and (i + 1) % t.log_every == 0) \
                or i + 1 == num_steps:
            now = time.time()
            metrics["steps_per_sec"] = (i + 1 - s_last) / max(now - t_last,
                                                              1e-9)
            t_last, s_last = now, i + 1
            logger.log(i + 1, metrics)
        if (t.checkpoint_every > 0 and (i + 1) % t.checkpoint_every == 0) \
                or i + 1 == num_steps:
            ckpt.save(state, iter_state=it.state, stage=t.stage)

    mode = ""
    if getattr(step_fn, "rollout_resident", None) is not None \
            and dev.type == "cuda":
        mode = "; rollout W_out " + ("resident" if step_fn.rollout_resident
                                     else "streamed")
    launches = {k: v - launches0[k] for k, v in launch_counts.items()}
    print(f"[vidcap] {t.stage}: {max(num_steps - start, 0)} steps on {dev}"
          f"{mode}; kernel launches {json.dumps(launches)}", file=sys.stderr)
    return state
