"""``dryrun_multigpu(n)``: the port's counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``. One XE step (with the attribute head) and one SCST
step (K3's plain version for both rollouts, the device CIDEr reward, the
policy-gradient backward) of ``synthetic_tiny``, on n gloo processes on the
CPU over a data × model mesh (model 2 when n is even, the vocab seam), each
from the same seeded init and batch as one process; prints and returns the
relative loss deltas against that one process.

    python -m vidcap_tpu_torch.parallel.dryrun 4
"""
from __future__ import annotations

import dataclasses
import json
import sys
from typing import Dict, Optional

import torch

from vidcap_tpu_torch.config import apply_overrides, get_preset
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.data.pipeline import DeterministicBatcher
from vidcap_tpu_torch.models.model import create_model, init_params
from vidcap_tpu_torch.parallel.distributed import spawn
from vidcap_tpu_torch.parallel.mesh import make_mesh
from vidcap_tpu_torch.parallel.sharding import (make_sharded_step,
                                                place_state, shard_batch)
from vidcap_tpu_torch.train.loop import batch_to_device_dict
from vidcap_tpu_torch.train.scst import make_scst_step_body
from vidcap_tpu_torch.train.state import create_train_state
from vidcap_tpu_torch.train.steps import make_step, make_xe_step_body

BATCH_PER_DATA_RANK = 2


def _setup(num_data: int):
    cfg = get_preset("synthetic_tiny")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=BATCH_PER_DATA_RANK * num_data,
        attribute_loss_weight=0.1,
        scst_learning_rate=cfg.train.learning_rate / 20))
    return cfg, CaptionDataset.synthetic(cfg.data, num_videos=16)


def _losses(num_data: int, mesh=None) -> Dict[str, float]:
    """One XE and one SCST step from the seeded init: their losses, on this
    process alone (``mesh`` None) or as a rank of ``mesh``."""
    cfg, ds = _setup(num_data)
    batch = batch_to_device_dict(next(DeterministicBatcher(
        ds, cfg.train.batch_size, seed=0)))
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    out = {}
    for stage in ("xe", "scst"):
        scfg = apply_overrides(cfg, [f"train.stage={stage}"])
        model = init_params(create_model(scfg, ds.vocab.size), seed=0)
        state = create_train_state(scfg, model)
        body = (make_xe_step_body(scfg) if stage == "xe"
                else make_scst_step_body(scfg, ds))
        if mesh is None:
            step = make_step(body, "cpu")
        else:
            step, dp = make_sharded_step(mesh, body)
            place_state(state, mesh, dp)
        _, metrics = step(state, dict(batch))
        out[stage] = float(metrics["loss"])
    return out


def _rank(rank: int, world: int, num_data: int, num_model: int
          ) -> Optional[Dict[str, float]]:
    torch.set_num_threads(1)
    mesh = make_mesh(None, num_data=num_data, num_model=num_model)
    out = _losses(num_data, mesh)
    return out if rank == 0 else None


def dryrun_multigpu(n: int, timeout: float = 240.0) -> Dict[str, float]:
    """Run the two steps over ``n`` gloo processes (data n/2 × model 2 when
    n is even, else data n) and in this process; print and return
    {"xe_delta", "scst_delta", the losses, the mesh}. Raises where a delta
    passes 1e-3, the reference's bound."""
    num_model = 2 if n % 2 == 0 and n > 1 else 1
    num_data = n // num_model
    sharded = spawn(_rank, n, (num_data, num_model), timeout=timeout)[0]
    single = _losses(num_data)
    out = {"mesh": {"data": num_data, "model": num_model}}
    for k in ("xe", "scst"):
        out[f"{k}_loss"] = sharded[k]
        out[f"{k}_single"] = single[k]
        out[f"{k}_delta"] = (abs(sharded[k] - single[k])
                             / max(abs(single[k]), 1e-9))
    print(json.dumps(out), flush=True)
    for k in ("xe", "scst"):
        if not out[f"{k}_delta"] < 1e-3:
            raise AssertionError(f"sharded {k} loss {sharded[k]} != one "
                                 f"process {single[k]}")
    return out


if __name__ == "__main__":
    dryrun_multigpu(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
