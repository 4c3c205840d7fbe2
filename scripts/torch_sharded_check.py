#!/usr/bin/env python3
"""Phase 17 of chip_smoke.py at a world of every visible card: the sharded
train steps and decodes of the PyTorch port over NCCL, one process a card,
against one card.

    python3 scripts/torch_sharded_check.py [--out report.json]

For each mesh (data W, and data W/2 × model 2 when W is even) the sharded
XE (banked) and SCST steps at scst_cider width, B=32 a step, captured
(chip_smoke.sharded_steps); on data W the sharded beam at
msrvtt_attn_beam5 width (B=184) and greedy at msvd_greedy width (B=32)
(chip_smoke.sharded_decodes). The one-card references run in this process
on card 0 first: the steps, each decode of the whole batch, and each
decode of the batch as W row blocks (what the ranks decode). Prints one
JSON object (and writes it to ``--out`` where given): per mesh
and stage the loss against one card, the largest parameter difference
after the compared steps, K3's launches and ms a step; per decode the
rows identical to one card's decode of the same row blocks and of the
whole batch, where the rows part from the whole batch's decode how near
the two captions are under the f32 model (``split_margins``), captions/s
and the launches; the card's name and power limit. Then the
CLI from one command on every card: ``train --sharded`` (synthetic_tiny,
XE then SCST with validation, then ``--resume`` one more step) and ``serve
--sharded`` over stdin, each checked for its stage lines, checkpoints and
captions. Exits 1 when a loss is not finite or parts from one card by more
than LOSS_RTOL, when a SCST step does not launch K3 twice, when a decode's
tokens differ from one card's decode of the same row blocks, or when a CLI
run fails.
With one card it runs phase 17 (a) and (b) at a world of one, and the CLI
runs print the reference's notice and run on that card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from vidcap_tpu_torch.parallel import distributed  # noqa: E402
from vidcap_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

# each rank's rows go through the same bf16 arithmetic as on one card, but
# cuBLAS may pick other kernels for its smaller row count, so a rounding
# may land apart: the bound is loose enough for that and tight enough for a
# wrong normalization (a mean of per-rank means, a missing all-reduce: ×W
# off). A decode has no such slack: a rank decodes its row block as one
# card decodes that block (the same kernels, the same K2 vocab split).
LOSS_RTOL = 1e-2


def meshes(world: int):
    out = [(world, 1)]
    if world % 2 == 0 and world > 1:
        out.append((world // 2, 2))
    return out


def summary(run: dict) -> dict:
    return {k: v for k, v in run.items() if k not in ("state", "loss")} | {
        "loss": run["loss"].tolist()}


def _rank(rank: int, world: int):
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for nd, nm in meshes(world):
        mesh = make_mesh(None, num_data=nd, num_model=nm)
        for stage in ("xe", "scst"):
            out[f"data {nd} x model {nm} {stage}"] = cs.sharded_steps(mesh,
                                                                       stage)
    out["decodes"] = cs.sharded_decodes(make_mesh(None, num_data=world,
                                                  num_model=1))
    return out if rank == 0 else None


def split_margins(name: str, whole: list, blocks: list) -> dict:
    """Where the decode in row blocks and the decode of the whole batch
    part: how close the two captions are under the f32 plain model on this
    card (the seeded weights, teacher-forced). For each parted row, the
    log-prob gap at the first token where they split (the margin that
    decided it) and the gap of their whole captions, in nats; beside them,
    the typical margin, the median top-1 − top-2 gap along the whole-batch
    captions of the first input. A near-tie is a split gap far below the
    typical margin."""
    from vidcap_tpu_torch.data.vocab import EOS
    from vidcap_tpu_torch.inference import Captioner
    from vidcap_tpu_torch.models.model import create_model
    from vidcap_tpu_torch.objectives.xe import shift_right
    setup = {n: rest for n, *rest in cs.sharded_decode_setup()}
    preset, vocab, _, inputs = setup[name]
    cfg = cs.get_preset(preset)
    ids = [f"video{i}" for i in range(inputs[0].shape[0])]
    ds = cs.CaptionDataset(inputs[0], ids, {v: [] for v in ids}, cfg.data,
                           vocab=cs.vocab_of(vocab))
    seeded = Captioner.from_checkpoint(cfg, ds).model
    model = create_model(cs.replaced(cfg, "model", compute_dtype="float32"),
                         vocab_size=seeded.vocab_size).cuda().eval()
    model.load_state_dict(seeded.state_dict())

    def logp(feats, toks):
        with torch.no_grad():
            enc = model.encode_features(torch.as_tensor(feats).cuda())
            t = torch.as_tensor(toks).long().cuda()
            return torch.log_softmax(model.xe_logits(
                enc, None, shift_right(t)).float(), -1), t

    def real(t):
        eos = (t == EOS).int()
        return (torch.cumsum(eos, 1) - eos) == 0

    split, whole_gap = [], []
    for f, a, b in zip(inputs, whole, blocks):
        rows = np.flatnonzero((a != b).any(1))
        if not len(rows):
            continue
        la, ta = logp(f[rows], a[rows])
        lb, tb = logp(f[rows], b[rows])
        at = (ta != tb).int().argmax(1)
        r = torch.arange(len(rows), device=at.device)
        split += (la[r, at, ta[r, at]] - la[r, at, tb[r, at]]).abs().tolist()
        sa = (la.gather(-1, ta[..., None])[..., 0] * real(ta)).sum(1)
        sb = (lb.gather(-1, tb[..., None])[..., 0] * real(tb)).sum(1)
        whole_gap += (sa - sb).abs().tolist()
    l0, t0 = logp(inputs[0], whole[0])
    top2 = l0.topk(2, -1).values
    typical = (top2[..., 0] - top2[..., 1])[real(t0)].median().item()
    q = lambda x: dict(median=float(np.median(x)), max=float(np.max(x)),
                       min=float(np.min(x))) if x else None
    return dict(parted_rows=len(split), split_gap_nats=q(split),
                caption_gap_nats=q(whole_gap),
                typical_top2_margin_nats=typical)


def cli_runs(world: int) -> tuple:
    """``train --sharded`` and ``serve --sharded`` from one command each, in
    a temporary directory: (readings, problems)."""
    env = {**os.environ, "PYTHONPATH": REPO}
    out, problems = {}, []
    mesh = f"rank 0 of a data {world} x model 1 mesh" if world > 1 else ""

    def run(args, **kw):
        r = subprocess.run([sys.executable, "-m", "vidcap_tpu_torch", *args],
                           cwd=tmp, env=env, capture_output=True, text=True,
                           timeout=600, **kw)
        if r.returncode:
            problems.append(f"{args[0]} {args[-1]}: rc {r.returncode}: "
                            f"{r.stderr[-2000:]}")
        return r
    with tempfile.TemporaryDirectory() as tmp:
        train = ["train", "--preset", "synthetic_tiny", "--stages", "xe,scst",
                 "--eval-every", "2", "--log-every", "1", "--sharded"]
        r = run(train + ["--steps", "2,2"])
        lines = [x for x in r.stderr.splitlines() if "steps on" in x]
        r2 = run(train + ["--steps", "2,3", "--resume"])
        lines += [x for x in r2.stderr.splitlines() if "steps on" in x]
        out["train_stage_lines"] = lines
        ckpts = sorted(os.listdir(os.path.join(tmp, "checkpoints")))
        out["checkpoints"] = ckpts
        if len(lines) != 4 or not all(mesh in x for x in lines) \
                or "ckpt_5.pt" not in ckpts or "best" not in ckpts:
            problems.append(f"train --sharded: {out}")
        import numpy as np
        from vidcap_tpu_torch.config import get_preset
        from vidcap_tpu_torch.convert import save_weights
        from vidcap_tpu_torch.data.loader import CaptionDataset
        from vidcap_tpu_torch.models.model import create_model, init_params
        cfg = get_preset("synthetic_tiny")
        ds = CaptionDataset.synthetic(cfg.data)
        save_weights(init_params(create_model(cfg, ds.vocab.size)),
                     os.path.join(tmp, "w.npz"))
        g = np.random.default_rng(0)
        paths = []
        for i in range(12):
            paths.append(os.path.join(tmp, f"f{i}.npy"))
            np.save(paths[-1], g.normal(size=(6, cfg.data.feature_dim))
                    .astype(np.float32))
        served = {}
        for flag in ([], ["--sharded"]):
            r = run(["serve", "--preset", "synthetic_tiny", "--weights",
                     "w.npz", "--batch", "8", "--method", "beam"] + flag,
                    input="\n".join(paths) + "\n")
            served[bool(flag)] = r.stdout
            out["serve_stderr_tail" if flag else "serve_one_card_tail"] = \
                r.stderr.splitlines()[-2:]
        out["serve_lines"] = len(served[True].splitlines())
        if served[True] != served[False] or out["serve_lines"] != 12:
            problems.append(f"serve --sharded: {out}")
    return out, problems


def main(out: Optional[str] = None) -> int:
    if not torch.cuda.is_available():
        print("torch_sharded_check: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    world = torch.cuda.device_count()
    card = cs.gpu_line()
    one = {stage: cs.sharded_steps(None, stage) for stage in ("xe", "scst")}
    one_dec = cs.sharded_decodes(None)
    one_blocks = cs.sharded_decodes(None, blocks=world)
    if world > 1:
        got = distributed.spawn(_rank, world, device="cuda",
                                timeout=800)[0]
    else:
        distributed.init_group("cuda:0")
        try:
            got = _rank(0, 1)
        finally:
            distributed.shutdown()
    report, problems = {"card": card, "world": world}, []
    for name, run in got.items():
        if name == "decodes":
            continue
        stage = name.rsplit(" ", 1)[1]
        ref = one[stage]
        rel = float((run["loss"] - ref["loss"]).abs().max()
                    / ref["loss"].abs().max())
        dp = max(float((run["state"][k] - ref["state"][k]).abs().max())
                 for k in ref["state"])
        report[name] = summary(run) | dict(
            loss_one_card=ref["loss"].tolist(), loss_rel_diff=rel,
            max_param_diff=dp, ms_a_step_one_card=ref["ms_a_step"])
        k3 = run["launches"]["rollout"]
        if (not torch.isfinite(run["loss"]).all() or rel > LOSS_RTOL
                or k3 != (2 * cs.SHARD_STEPS if stage == "scst" else 0)):
            problems.append(f"{name}: {report[name]}")
    rows = lambda a, b: float(np.mean([(x == y).all(1).mean()
                                       for x, y in zip(a, b)]))
    for name, dec in got["decodes"].items():
        ref = one_dec[name]
        same = rows(dec["tokens"], one_blocks[name]["tokens"])
        report[name] = dict(
            identical_rows_to_one_card_same_blocks=same,
            identical_rows_to_one_card_whole_batch=rows(dec["tokens"],
                                                        ref["tokens"]),
            captions_per_s=dec["captions_per_s"],
            captions_per_s_one_card=ref["captions_per_s"],
            launches_rank0=dec["launches"], kernels=list(dec["kernels"]),
            parted_from_the_whole_batch=split_margins(
                name, ref["tokens"], dec["tokens"]))
        if same != 1.0:
            problems.append(f"{name}: {report[name]}")
    report["cli"], p = cli_runs(world)
    problems += p
    report["problems"] = problems
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 1 if problems else 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the JSON here")
    sys.exit(main(ap.parse_args().out))
