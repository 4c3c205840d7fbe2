"""One training stage on one device, as ``vidcap_tpu/train/loop.py``'s
``train()``: the model from the seeded init, an exact mid-stage resume or a
cross-stage one (xe → scst or xe → e2e: parameters restored, the stage's
optimizer fresh, with its backbone group where it trains through the CNN), the
deterministic batch stream, logging, the checkpoint cadence, and periodic
validation that keeps the best-CIDEr state under ``{checkpoint_dir}/best``.

The dispatch is the JAX loop's: with ``train.device_feature_bank`` the
features stay on the device and a batch carries tokens, mask and indices;
with ``train.steps_per_dispatch`` = K (bank mode) one call advances K steps,
with a log row per step and checkpoints and validation at the chunk
boundaries that cross their cadence; ``train.prefetch_depth`` draws batches
ahead on a thread; one worker stages the next dispatch's batches (pinned
host buffers, a copy on a side stream) while the card runs the current one.
On the card every step is a CUDA graph (train/steps.py). Runs on the card
unless the caller asks for the CPU.

With a ``mesh`` (parallel/mesh.py: ``train --sharded``) this process is one
rank: it draws the same global batches as every rank and steps on its rows,
the gradients summed over the data axis inside the step
(parallel/sharding.py), its state replicated or, on a model axis > 1,
split at the vocab seam; K steps a dispatch fall back to one (the
reference's notice). Rank 0 logs and writes the checkpoints (the seam's
shards gathered first), every rank restores, and validation decodes each
batch split over the data axis.
"""
from __future__ import annotations

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from vidcap_tpu_torch.config import Config
from vidcap_tpu_torch.data.loader import Batch, CaptionDataset
from vidcap_tpu_torch.data.pipeline import (DeterministicBatcher,
                                            PrefetchBatcher)
from vidcap_tpu_torch.inference import Captioner, resolve_device
from vidcap_tpu_torch.metrics.evaluate import evaluate_captions
from vidcap_tpu_torch.models.model import create_model, init_params
from vidcap_tpu_torch.ops._build import launch_counts
from vidcap_tpu_torch.parallel.sharding import (full_model, full_tensors,
                                                make_sharded_banked_step,
                                                make_sharded_step,
                                                place_state, shard_batch)
from vidcap_tpu_torch.train.checkpoint import CheckpointManager
from vidcap_tpu_torch.train.scst import make_scst_step_body
from vidcap_tpu_torch.train.state import TrainState, create_train_state
from vidcap_tpu_torch.train.steps import (make_banked_multistep,
                                          make_banked_step, make_step,
                                          make_xe_step_body)
from vidcap_tpu_torch.utils.logging import MetricsLogger


def batch_to_device(batch: Batch, device) -> Dict[str, torch.Tensor]:
    """Batch → the dict of tensors a step consumes, on ``device``."""
    return {k: torch.as_tensor(getattr(batch, k), device=device)
            for k in ("features", "tokens", "mask", "attributes",
                      "video_idx")}


def batch_to_device_dict(batch: Batch, bank_mode: bool = False
                         ) -> Dict[str, np.ndarray]:
    """Batch → the dict a dispatched step consumes. In feature-bank mode
    features and attributes stay home: the step gathers them on the device
    by ``video_idx``."""
    d = {"tokens": batch.tokens, "mask": batch.mask,
         "video_idx": batch.video_idx}
    if not bank_mode:
        d["features"] = batch.features
        d["attributes"] = batch.attributes
    return d


def _stage(it, n: int, bank_mode: bool, dev: torch.device, stream,
           mesh=None, accum: int = 1):
    """Draw the next dispatch's n batches (stacked along a leading axis when
    n > 1; this rank's rows of each on a ``mesh``, as ``shard_batch`` takes
    them for ``accum`` microbatches) and start their upload:
    on the card from pinned host buffers, non-blocking on ``stream``.
    Returns (the tensors, the event the step waits on or None, the
    iterator's state after these batches)."""
    ds = [batch_to_device_dict(next(it), bank_mode) for _ in range(n)]
    if mesh is not None:
        ds = [shard_batch(d, mesh, accum) for d in ds]
    it_state = it.state
    d = ds[0] if n == 1 else {k: np.stack([b[k] for b in ds]) for k in ds[0]}
    if dev.type != "cuda":
        return {k: torch.as_tensor(v) for k, v in d.items()}, None, it_state
    with torch.cuda.stream(stream):
        out = {k: torch.as_tensor(v).pin_memory().to(dev, non_blocking=True)
               for k, v in d.items()}
        ev = torch.cuda.Event()
        ev.record(stream)
    return out, ev, it_state


def _crossed(cadence: int, a: int, b: int) -> bool:
    """Whether steps a+1..b reach a multiple of ``cadence`` (> 0)."""
    return cadence > 0 and b // cadence > a // cadence


def _subset_dataset(dataset: CaptionDataset, max_videos: int
                    ) -> CaptionDataset:
    """The first ``max_videos`` videos of a dataset, with its vocab."""
    n = min(max_videos, dataset.num_videos)
    if n == dataset.num_videos:
        return dataset
    ids = dataset.video_ids[:n]
    return CaptionDataset(
        dataset.features[:n], ids,
        {v: dataset.video_captions[v] for v in ids},
        dataset.cfg, vocab=dataset.vocab)


def run_validation(cfg: Config, captioner: Captioner,
                   val_dataset: CaptionDataset) -> Dict[str, float]:
    """Decode the val split with ``cfg.train.eval_method`` in batches of
    ``cfg.train.batch_size`` and score the videos that have references:
    {'CIDEr': ..., 'Bleu_4': ..., ...}."""
    results = captioner.caption_dataset(
        method=cfg.train.eval_method, batch_size=cfg.train.batch_size,
        beam_width=cfg.decode.beam_width,
        device_bank=cfg.train.device_feature_bank)
    refs = {v: val_dataset.video_captions[v] for v in results
            if val_dataset.video_captions.get(v)}  # empty list = no refs
    return evaluate_captions(refs, {v: results[v] for v in refs})


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
          device: Optional[str] = None, mesh=None,
          val_dataset: Optional[CaptionDataset] = None) -> TrainState:
    """Run one stage (``cfg.train.stage``: "xe", "e2e" or "scst") up to step
    ``num_steps`` (default ``cfg.train.num_steps``; counts are cumulative
    over stages); returns the final TrainState. Ends with one stderr line:
    the stage, the steps run, the device, K3's W_out mode (SCST) and the
    kernel launches of this call, validation's included. SCST first prints
    the reward tables' build seconds and which counter built them.

    Every ``cfg.train.eval_every`` steps the val split (``val_dataset``, or
    without one the first 200 videos of ``dataset``) is decoded and scored,
    and a state whose CIDEr beats every earlier one is saved under
    ``{checkpoint_dir}/best``.

    ``mesh``: this process is one rank of it (module docstring); the
    device is the mesh's."""
    t = cfg.train
    num_steps = num_steps or t.num_steps
    dev = mesh.device if mesh is not None else resolve_device(device)
    lead = mesh is None or mesh.rank == 0
    dataset = dataset or CaptionDataset.synthetic(cfg.data)
    logger = (logger or MetricsLogger()) if lead else MetricsLogger(
        quiet=True)
    if mesh is not None and t.batch_size % mesh.num_data:
        raise ValueError(f"batch_size {t.batch_size} must divide evenly "
                         f"over the {mesh.num_data}-way 'data' mesh axis")

    model = init_params(create_model(cfg, vocab_size=dataset.vocab.size),
                        seed=t.seed).to(dev)
    state = create_train_state(cfg, model, num_steps=num_steps)
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

    if t.stage in ("xe", "e2e"):
        # e2e is the XE body through the backbone's shared encode
        body = make_xe_step_body(cfg)
    elif t.stage == "scst":
        body = make_scst_step_body(cfg, dataset)
        if lead:
            print(f"[vidcap] scst: reward tables of {dataset.num_videos} "
                  f"videos built in {body.tables_seconds:.2f} s by the "
                  f"{body.tables.counter} counter", file=sys.stderr)
    else:
        raise ValueError(f"unknown stage {t.stage!r}")
    # feature-mode inputs only (pixel datasets are too large to bank)
    bank_mode = t.device_feature_bank and dataset.features.ndim == 3
    if t.device_feature_bank and not bank_mode:
        print("[vidcap] device_feature_bank ignored (custom step or "
              "pixel-mode inputs)", file=sys.stderr)
    k_dispatch = (max(1, t.steps_per_dispatch)
                  if bank_mode and mesh is None else 1)
    if t.steps_per_dispatch > 1 and k_dispatch == 1 and lead:
        print("[vidcap] steps_per_dispatch ignored — multi-step dispatch "
              "requires the device feature bank (--feature-bank, "
              "feature-mode inputs) and a single device", file=sys.stderr)
    chunk_fn = None
    if mesh is not None:
        if bank_mode:
            step_fn, _, dp = make_sharded_banked_step(mesh, body,
                                                      dataset)
        else:
            step_fn, dp = make_sharded_step(mesh, body)
        place_state(state, mesh, dp)
    elif bank_mode:
        banks = None
        if k_dispatch > 1:
            chunk_fn, banks = make_banked_multistep(body, dataset, k_dispatch,
                                                    device=dev)
        # the (< K)-step tail takes single steps on the same banks
        step_fn, _ = make_banked_step(body, dataset, banks=banks,
                                      device=dev)
    else:
        step_fn = make_step(body, dev)

    def save(manager: CheckpointManager, **kw) -> None:
        """Rank 0 writes (the seam's shards gathered by every rank first);
        every rank waits for the file."""
        if mesh is None:
            manager.save(state, **kw)
            return
        tensors = full_tensors(state, mesh)
        if lead:
            manager.save(state, tensors=tensors, **kw)
        dist.barrier()

    eval_every = t.eval_every
    eval_on_train = val_dataset is None
    val = val_dataset
    if eval_on_train and eval_every > 0:
        # selection by training fit is overfit-prone, and decoding the
        # whole train split at every cadence stalls the loop: a capped
        # subset, and every eval row marked
        val = _subset_dataset(dataset, max_videos=200)
        print(f"[vidcap] no val split — periodic eval scores a "
              f"{val.num_videos}-video TRAIN subset; 'best' checkpoint "
              f"selection reflects training fit, not held-out quality",
              file=sys.stderr)
    best_ckpt = captioner = replica = None
    best_cider = -1.0

    def maybe_eval(step_no: int) -> None:
        nonlocal best_ckpt, best_cider, captioner, replica
        t0 = time.perf_counter()
        # one captioner (its feature bank is kept), whose kernels' cast
        # weights are those of the parameters as they are now; on a mesh
        # every rank decodes its rows of each batch, on the whole vocab
        if mesh is not None:
            replica = full_model(state, mesh, replica)
        if captioner is None:
            captioner = Captioner.from_state(cfg, val, state, mesh=mesh,
                                             model=replica)
        captioner.reload_weights()
        captioner.model.eval()
        try:
            scores = run_validation(cfg, captioner, val)
        finally:
            captioner.model.train()
        record = {f"eval_{k}": v for k, v in scores.items()}
        if eval_on_train:
            record["eval_on_train_fallback"] = 1.0
        record["val_seconds"] = time.perf_counter() - t0
        logger.log(step_no, record)
        if scores["CIDEr"] > best_cider:
            best_cider = scores["CIDEr"]
            if best_ckpt is None:
                best_ckpt = CheckpointManager(
                    os.path.join(t.checkpoint_dir, "best"), max_to_keep=1)
            save(best_ckpt, stage=t.stage)

    start = state.step
    launches0 = dict(launch_counts)
    it = DeterministicBatcher(dataset, t.batch_size, state=iter_state,
                              seed=t.seed)
    if t.prefetch_depth > 0:
        it = PrefetchBatcher(it, depth=t.prefetch_depth)
    # the dispatches: chunks of K steps, then single steps for the tail
    units = [k_dispatch] * ((num_steps - start) // k_dispatch) if \
        chunk_fn is not None else []
    units += [1] * (num_steps - start - sum(units))
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    # one worker: batch order and the iterator's state stay sequential
    pool = ThreadPoolExecutor(max_workers=1)
    stage = lambda n: pool.submit(_stage, it, n, bank_mode, dev, side, mesh,
                                  max(1, t.grad_accum))
    staged = stage(units[0]) if units else None
    t_last, s_last = time.time(), start
    try:
        for u, n in enumerate(units):
            batch, ev, it_state = staged.result()
            if ev is not None:
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(ev)
                for v in batch.values():
                    v.record_stream(cur)
            t0 = time.time()
            state, metrics = (chunk_fn if n > 1 else step_fn)(state, batch)
            # the next batches ride to the card while it runs this dispatch
            staged = stage(units[u + 1]) if u + 1 < len(units) else None
            a, b = state.step - n, state.step
            if n > 1:
                # one host read a chunk; a row per step at the chunk's rate
                host = {k: v.tolist() for k, v in metrics.items()}
                sps = n / max(time.time() - t0, 1e-9)
                for j in range(n):
                    g = a + j + 1
                    if (t.log_every > 0 and g % t.log_every == 0) \
                            or g == num_steps:
                        logger.log(g, {**{k: v[j] for k, v in host.items()},
                                       "steps_per_sec": sps})
                t_last, s_last = time.time(), b
            elif (t.log_every > 0 and b % t.log_every == 0) \
                    or b == num_steps:
                now = time.time()
                metrics = {**metrics, "steps_per_sec": (b - s_last)
                           / max(now - t_last, 1e-9)}
                t_last, s_last = now, b
                logger.log(b, metrics)
            if _crossed(t.checkpoint_every, a, b) or b == num_steps:
                save(ckpt, iter_state=it_state, stage=t.stage)
            if _crossed(eval_every, a, b):
                maybe_eval(b)
    finally:
        pool.shutdown(wait=True)
        if isinstance(it, PrefetchBatcher):
            it.close()

    mode = ""
    if getattr(body, "rollout_resident", None) is not None \
            and dev.type == "cuda":
        mode = "; rollout W_out " + ("resident" if body.rollout_resident
                                     else "streamed")
    launches = {k: v - launches0[k] for k, v in launch_counts.items()}
    if lead:
        on = (f" on {dev}" if mesh is None else f" on {dev} (rank 0 of a "
              f"data {mesh.num_data} x model {mesh.num_model} mesh)")
        print(f"[vidcap] {t.stage}: {max(num_steps - start, 0)} steps{on}"
              f"{mode}; kernel launches {json.dumps(launches)}",
              file=sys.stderr)
    return state
