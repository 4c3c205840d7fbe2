"""SCST quality lift on held-out videos, the port's copy of
``scripts/scst_lift_experiment.py``.

XE is deliberately under-trained (40 steps: an entropic policy), then SCST
optimizes CIDEr against the greedy baseline for 300 steps; val CIDEr is
greedy-decoded on 64 held-out videos from the same generative process
(``make_synthetic_corpus(seed + 1000)``, the train vocab) after each phase.
The configuration is the reference's, frozen: ``synthetic_tiny``, batch 16,
seed 0, ``scst_learning_rate=3e-4``, ``scst_xe_mix=0.05``, 128 train
videos, the batches in the order of the reference's ``dataset.batches``.

On the card the steps are the trainer's captured steps (one CUDA graph a
step: ``train/steps.py``), the SCST step with K3's two rollouts inside, and
validation decodes greedy through K3. Weights are the port's seeded init,
or ``weights=`` (a Flax parameter tree of numpy arrays, e.g. the JAX
package's ``init_params``, through ``convert.from_flax``, or an ``.npz``).

    python scripts/torch_scst_lift.py [xe_steps] [scst_steps] [--device cpu]

prints one JSON line: {"xe_steps", "scst_steps", "val_cider_xe",
"val_cider_scst", "lift", "final_reward_sample"}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Iterator, List, Mapping, Optional, Tuple, Union

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from vidcap_tpu_torch.config import Config, get_preset  # noqa: E402
from vidcap_tpu_torch.convert import from_flax, load_weights  # noqa: E402
from vidcap_tpu_torch.data.loader import CaptionDataset  # noqa: E402
from vidcap_tpu_torch.data.synthetic import make_synthetic_corpus  # noqa: E402
from vidcap_tpu_torch.inference import Captioner, resolve_device  # noqa: E402
from vidcap_tpu_torch.metrics.evaluate import evaluate_captions  # noqa: E402
from vidcap_tpu_torch.models.model import create_model, init_params  # noqa: E402
from vidcap_tpu_torch.train.loop import batch_to_device_dict  # noqa: E402
from vidcap_tpu_torch.train.scst import make_scst_step_body  # noqa: E402
from vidcap_tpu_torch.train.state import TrainState, create_train_state  # noqa: E402
from vidcap_tpu_torch.train.steps import make_step, make_xe_step_body  # noqa: E402

TRAIN_VIDEOS, VAL_VIDEOS = 128, 64
Weights = Union[None, str, Mapping]


def lift_config(seed: int = 0) -> Config:
    base = get_preset("synthetic_tiny")
    return dataclasses.replace(base, train=dataclasses.replace(
        base.train, batch_size=16, seed=seed,
        # SCST hygiene: small PG rate, an XE anchor keeps fluency
        scst_learning_rate=3e-4, scst_xe_mix=0.05))


def datasets(cfg: Config, seed: int) -> Tuple[CaptionDataset, CaptionDataset]:
    """(the 128 train videos, the 64 held-out ones with the train vocab)."""
    train_ds = CaptionDataset.synthetic(cfg.data, num_videos=TRAIN_VIDEOS,
                                        seed=seed)
    corpus = make_synthetic_corpus(
        num_videos=VAL_VIDEOS, num_frames=cfg.data.num_frames,
        feature_dim=cfg.data.feature_dim, seed=seed + 1000)
    val_ds = CaptionDataset(corpus["features"], corpus["video_ids"],
                            corpus["captions"], cfg.data,
                            vocab=train_ds.vocab)
    return train_ds, val_ds


def val_cider(cfg: Config, val_ds: CaptionDataset, state: TrainState
              ) -> float:
    """Greedy val CIDEr of the state's parameters as they are now."""
    model = state.model
    model.eval()
    try:
        results = Captioner.from_state(cfg, val_ds, state).caption_dataset(
            method="greedy", batch_size=cfg.train.batch_size)
    finally:
        model.train()
    refs = {v: val_ds.video_captions[v] for v in results}
    return float(evaluate_captions(refs, results)["CIDEr"])


@dataclasses.dataclass
class XePhase:
    cfg: Config
    train_ds: CaptionDataset
    val_ds: CaptionDataset
    state: TrainState
    batches: Iterator
    device: object
    losses: List[float]


def xe_phase(xe_steps: int = 40, seed: int = 0, device=None,
             weights: Weights = None) -> XePhase:
    """The XE steps from the seeded init (or ``weights``), each step's
    loss read back."""
    cfg = lift_config(seed)
    dev = resolve_device(device)
    train_ds, val_ds = datasets(cfg, seed)
    model = create_model(cfg, vocab_size=train_ds.vocab.size)
    if weights is None:
        init_params(model, seed=seed)
    elif isinstance(weights, str):
        load_weights(model, weights)
    else:
        from_flax(model, weights)
    state = create_train_state(cfg, model.to(dev), num_steps=xe_steps)
    step = make_step(make_xe_step_body(cfg), dev)
    it = train_ds.batches(cfg.train.batch_size, seed=seed)
    losses = []
    for _ in range(xe_steps):
        state, m = step(state, batch_to_device_dict(next(it)))
        losses.append(float(m["loss"]))
    return XePhase(cfg, train_ds, val_ds, state, it, dev, losses)


def build(xe_steps: int = 40, scst_steps: int = 300, seed: int = 0,
          device=None, weights: Weights = None
          ) -> Tuple[float, float, float]:
    """XE(xe_steps) → val CIDEr → SCST(scst_steps) → val CIDEr. Returns
    (cider after XE, cider after SCST, the last SCST step's
    reward_sample)."""
    xe = xe_phase(xe_steps, seed, device, weights)
    cider_xe = val_cider(xe.cfg, xe.val_ds, xe.state)
    scst_cfg = dataclasses.replace(
        xe.cfg, train=dataclasses.replace(xe.cfg.train, stage="scst"))
    state = create_train_state(scst_cfg, xe.state.model, seed=seed,
                               num_steps=scst_steps)
    step = make_step(make_scst_step_body(scst_cfg, xe.train_ds), xe.device)
    reward = float("nan")
    for i in range(scst_steps):
        state, m = step(state, batch_to_device_dict(next(xe.batches)))
        if i == scst_steps - 1:
            reward = float(m["reward_sample"])
    return cider_xe, val_cider(scst_cfg, xe.val_ds, state), reward


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("xe_steps", nargs="?", type=int, default=40)
    ap.add_argument("scst_steps", nargs="?", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu to run without a card (default: the card)")
    args = ap.parse_args(argv)
    xe, scst, reward = build(args.xe_steps, args.scst_steps, args.seed,
                             args.device)
    print(json.dumps({"xe_steps": args.xe_steps,
                      "scst_steps": args.scst_steps,
                      "val_cider_xe": round(xe, 4),
                      "val_cider_scst": round(scst, 4),
                      "lift": round(scst - xe, 4),
                      "final_reward_sample": round(reward, 4)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
