"""Worker of tests/test_torch_parallel.py: runs in the processes that
``vidcap_tpu_torch.parallel.distributed.spawn`` starts (gloo on the CPU),
and in the test process itself for the one-process reference. Imports torch
and the port only (no JAX), so that a worker starts in a second or two.

``run_case`` takes 3 steps of one body (XE, banked XE, SCST, SCST in 2
microbatches, e2e on the tiny backbone, XE with dropout, in one batch and
in 2 microbatches) in f32 from given
weights, on this process alone or as a rank of a mesh, and returns per step
the loss and the metrics, the raw gradients before the first update (summed
over the data axis), the parameters after the last (the seam's shards
gathered) and the SCST step's rollouts, one (sampled, greedy) pair a
microbatch in order (this rank's rows). Given ``rollouts`` (such a list of
the whole batch's), the SCST step takes those instead of its own, each rank
its rows, so that it can be held against another package fed the same.
``decode`` runs greedy and beam captions (the finished pool and the int8
projection too) through ``Captioner`` with and without a mesh.
"""

import contextlib

import numpy as np
import torch

from vidcap_tpu_torch.config import apply_overrides, get_preset
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.data.pipeline import DeterministicBatcher
from vidcap_tpu_torch.inference import Captioner
from vidcap_tpu_torch.models import backbone as bb
from vidcap_tpu_torch.models.decoding import Rollout
from vidcap_tpu_torch.models.model import create_model, init_params
from vidcap_tpu_torch.parallel.mesh import make_mesh
from vidcap_tpu_torch.parallel.sharding import (full_tensors,
                                                make_sharded_banked_step,
                                                make_sharded_step,
                                                place_state, shard_batch)
from vidcap_tpu_torch.train.loop import batch_to_device_dict
from vidcap_tpu_torch.train.scst import make_scst_step_body
from vidcap_tpu_torch.train.state import create_train_state
from vidcap_tpu_torch.train.steps import (make_banked_step, make_step,
                                          make_xe_step_body)

F32 = ["model.compute_dtype=float32", "train.attribute_loss_weight=0.2",
       "train.batch_size=4"]
TINY_BACKBONE = dict(width_mult=0.0625, depth=(1, 1, 1))
CASES = {
    "xe": F32,
    "xe_banked": F32 + ["train.device_feature_bank=true"],
    "scst": F32 + ["train.stage=scst", "train.scst_xe_mix=0.1",
                   "train.scst_learning_rate=1e-4"],
    "scst_accum": F32 + ["train.stage=scst", "train.scst_xe_mix=0.1",
                         "train.scst_learning_rate=1e-4",
                         "train.grad_accum=2"],
    "e2e": F32 + ["train.stage=e2e", "data.num_frames=2",
                  "data.frame_size=75", "data.feature_dim=96",
                  "model.use_backbone=true", "train.batch_size=2"],
    "xe_dropout": F32 + ["model.dropout_rate=0.3"],
    "xe_dropout_accum": F32 + ["model.dropout_rate=0.3",
                               "train.grad_accum=2"],
}
STEPS = 3
ROLLOUT_FIELDS = ("tokens", "logp", "mask")


def case_setup(name):
    cfg = apply_overrides(get_preset("synthetic_tiny"), CASES[name])
    pixels = cfg.model.use_backbone
    ds = CaptionDataset.synthetic(cfg.data, num_videos=16 if pixels else 64,
                                  pixels=pixels)
    return cfg, ds


@contextlib.contextmanager
def tiny_backbone():
    """The port's ``InceptionResNetV2`` at the tiny width and depth, in
    f32 (restored after)."""
    orig = bb.InceptionResNetV2
    bb.InceptionResNetV2 = lambda **kw: orig(
        **{**TINY_BACKBONE, "compute_dtype": torch.float32, **kw})
    try:
        yield
    finally:
        bb.InceptionResNetV2 = orig


def run_case(name, weights=None, mesh=None, rollouts=None):
    """The case on the tiny backbone."""
    with tiny_backbone():
        return _run_case(name, weights, mesh, rollouts)


def _rows(r, mesh):
    """This rank's rows of a rollout of the whole (micro)batch."""
    if mesh is None:
        return r
    b = len(r["tokens"]) // mesh.num_data
    return {f: v[mesh.data_index * b:(mesh.data_index + 1) * b]
            for f, v in r.items()}


def _run_case(name, weights, mesh, given):
    cfg, ds = case_setup(name)
    model = init_params(create_model(cfg, ds.vocab.size), seed=0)
    if weights is not None:
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(torch.as_tensor(weights[k]))
    state = create_train_state(cfg, model)
    t = cfg.train
    body = (make_scst_step_body(cfg, ds) if t.stage == "scst"
            else make_xe_step_body(cfg))
    bank = t.device_feature_bank
    if mesh is None:
        step = (make_banked_step(body, ds, device="cpu")[0] if bank
                else make_step(body, "cpu"))
    else:
        if bank:
            step, _, dp = make_sharded_banked_step(mesh, body, ds)
        else:
            step, dp = make_sharded_step(mesh, body)
        place_state(state, mesh, dp)
    out = {"metrics": [], "grads": None, "rollouts": []}
    apply = state.apply_gradients

    def recorded(grads, norm=None):
        if out["grads"] is None:
            out["grads"] = {k: g.detach().clone().numpy()
                            for k, g in grads.items()}
        return apply(grads, norm)
    state.apply_gradients = recorded
    if t.stage == "scst":
        rollouts, calls = body.rollouts, iter(given or ())

        def kept(*a, **k):
            if given is None:
                pair = rollouts(*a, **k)
            else:
                pair = tuple(Rollout(*(torch.as_tensor(_rows(r, mesh)[f])
                                       for f in ROLLOUT_FIELDS))
                             for r in next(calls))
            out["rollouts"].append(tuple(
                {f: getattr(r, f).numpy().copy() for f in ROLLOUT_FIELDS}
                for r in pair))
            return pair
        body.rollouts = kept
    it = DeterministicBatcher(ds, t.batch_size, seed=0)
    for _ in range(STEPS):
        b = batch_to_device_dict(next(it), bank)
        if mesh is not None:
            b = shard_batch(b, mesh, max(1, t.grad_accum))
        state, m = step(state, b)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    full = full_tensors(state, mesh) if mesh is not None else None
    params = full[0] if full is not None else state.params
    out["params"] = {k: v.detach().numpy().copy() for k, v in params.items()}
    return out


def rank_steps(rank, world, num_data, num_model, names, weights=None,
               rollouts=None, decodes=False):
    """As a rank of a data × model mesh: every case in ``names`` from the
    seeded init, and every case of ``weights`` ({name: weights}) under
    "jax_<name>", its SCST rollouts from ``rollouts`` ({name: rollouts});
    with ``decodes`` the decodes too (:func:`decode` on the data axis). The
    grads of a seam's shard are this rank's, so the results are returned
    by rank."""
    torch.set_num_threads(1)
    mesh = make_mesh(None, num_data=num_data, num_model=num_model)
    out = {n: run_case(n, None, mesh) for n in names}
    out.update({f"jax_{n}": run_case(n, w, mesh, (rollouts or {}).get(n))
                for n, w in (weights or {}).items()})
    if decodes:
        out["decode"] = decode(make_mesh(None, num_data=world,
                                         num_model=1))
    return out


DECODES = {
    "greedy": ("greedy", []),
    "beam": ("beam", []),
    "beam_pool": ("beam", ["decode.finished_pool=on"]),
    "beam_int8": ("beam", ["decode.int8_vocab_projection=true"]),
}


def decode_inputs(B=8, seed=5):
    cfg = get_preset("synthetic_tiny")
    g = np.random.default_rng(seed)
    feats = g.normal(size=(B, cfg.data.num_frames, cfg.data.feature_dim)
                     ).astype(np.float32)
    mask = np.ones((B, cfg.data.num_frames), np.float32)
    mask[0, 1:] = 0.0          # one real frame
    mask[B - 1, 3:] = 0.0
    return feats, mask


def decode(mesh=None):
    """{name: tokens} of :data:`DECODES` through ``Captioner`` (bf16, the
    preset's decoder: the kernels' route, their plain versions here), with
    frame masks, and the sampled decode, which stays on this rank."""
    feats, mask = decode_inputs()
    out = {}
    for name, (method, over) in DECODES.items():
        cfg = apply_overrides(get_preset("synthetic_tiny"), over)
        ds = CaptionDataset.synthetic(cfg.data, num_videos=4)
        model = init_params(create_model(cfg, ds.vocab.size), seed=1).eval()
        cap = Captioner(cfg, model, ds, torch.device("cpu"), seed=3,
                        mesh=mesh)
        out[name] = cap.decode_batch(feats, method=method, beam_width=3,
                                     frame_mask=mask)
        if name == "greedy":
            out["sample"] = cap.decode_batch(feats, method="sample",
                                             frame_mask=mask)
            out["sharded_compiled"] = sorted(map(str, cap._sharded))
    return out

