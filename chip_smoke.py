#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``vidcap_tpu_torch``).

    python3 chip_smoke.py      # from the root of a checkout; one NVIDIA GPU

Builds the Hopper kernels from ``vidcap_tpu_torch/csrc`` with nvcc, holds
each against its plain PyTorch version at the shapes of its path, and drives
the port's three paths with seeded random weights, showing with the launch
counts that each went through its kernels: beam-5 captioning under preset
``msrvtt_attn_beam5`` (vocab 16,000, 184 videos of synthetic features)
through K1 and K2; greedy (``msvd_greedy``) and sampled (``scst_cider``)
captioning (vocab 12,000, 32 videos) through K3; and the staged XE → SCST
training of ``scst_cider`` (B=32, vocab 12,000), whose SCST step runs its
sampled and greedy rollouts on K3. Phases:

  1 card, versions, kernel build    6 K3 rollout vs plain (greedy, sampled,
  2 K1 beam_core vs plain             seeded and raised-<eos> weights; W_out
                                      resident and streamed; all-equal
                                      logits; runs repeat; kernels per
                                      rollout; a vocab too wide to keep)
  3 K2 topk_project vs plain        7 greedy/sample end to end: Captioner
  4 beam end to end: Captioner,     8 CLI: caption --preset msvd_greedy and
    kernels vs plain                  sample --preset scst_cider
  5 CLI: caption (beam)             9 an SCST step at scst_cider width: K3
                                      vs plain rollouts, times
                                   10 CLI: train --stages xe,scst, --resume
  then the kernels line (one JSON object)

Any failed check exits non-zero. The last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``. Without a CUDA device
it exits 2 and prints no result. Imports torch and numpy, never JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from vidcap_tpu_torch.config import get_preset
from vidcap_tpu_torch.convert import save_weights
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.data.vocab import BOS, EOS, PAD, SPECIALS, Vocab
from vidcap_tpu_torch.inference import Captioner
from vidcap_tpu_torch.models.decoder import NEG, DecoderState
from vidcap_tpu_torch.models.decoding import (beam_decode, fused_beam_step,
                                              tile_recurrent)
from vidcap_tpu_torch.models.model import create_model, init_params
from vidcap_tpu_torch.objectives.xe import shift_right
from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.ops.beam_core import beam_core, beam_core_plain
from vidcap_tpu_torch.ops.rollout import (RolloutWeights, replay_plain,
                                          rollout, rollout_plain, step_plain)
from vidcap_tpu_torch.ops.topk_project import topk_project, topk_project_plain
from vidcap_tpu_torch.data.pipeline import DeterministicBatcher
from vidcap_tpu_torch.models.decoding import Rollout
from vidcap_tpu_torch.train.loop import batch_to_device
from vidcap_tpu_torch.train.scst import make_scst_step_body
from vidcap_tpu_torch.train.state import (create_train_state,
                                          optax_global_norm)
from vidcap_tpu_torch.train.steps import apply_loss

PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor FLOP/s (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
B, K, T, E, H, A, D = 184, 5, 26, 512, 512, 512, 1536   # bench.py:38 shapes
VP = 16_000
# h'/c', kernel vs plain: a sum next to a bf16 rounding boundary (q, tanh
# input/output) may round one ulp apart in another sum order. About 3x the
# largest error measured on the card (PERF.md); it cannot tell a coarse
# gate-GEMM accumulation from a right one, phase 4's row check does.
K1_TOL = 3e-3
# Phase 4: the share of beam rows the kernel path keeps identical to the
# plain path, pooled over the trials, may fall this far below the lowest
# trial's plain CPU-vs-card share (the floor another summation order alone
# reaches). Set from the floor's spread over seeds and the reading of a
# gate GEMM without promoted partial sums (PERF.md Findings).
ROW_SLACK = 0.05
# K3 at msvd_greedy width: batch 32 (train.batch_size and the default
# caption_dataset batch), vocab 12,000 padded to 12,032, 30 steps
BG, VOCAB_G, VG, L = 32, 12_000, 12_032, 30
# K3, kernel vs plain along the kernel's own tokens, in logit units (times
# 1/temperature): a h' difference within K1_TOL moves a bf16-rounded logit
# by a bf16 ulp or two (0.008-0.016 at |logit| ~ 1). Where the plain top-2
# margin is wider the picks must agree; the log-probs agree within it.
K3_LOGIT_TOL = 0.03
# K3's W_out modes (rollout(..., resident_wout=...)), both held in phase 6
K3_MODES = {"resident": True, "streamed": False}
# the rollouts held: greedy, and sampled at seeds 1, 2 and temperatures 1, 0.7
K3_RUNS = (("greedy", False, 0, 1.0), ("sample_s1_t1", True, 1, 1.0),
           ("sample_s1_t0.7", True, 1, 0.7), ("sample_s2_t1", True, 2, 1.0),
           ("sample_s2_t0.7", True, 2, 0.7))
# Phase 9: the SCST step's rewards and loss pieces, kernel rollouts vs plain
# ones on the rows where they are identical: the same code on the same
# tokens, so only the card's reductions may reorder (1e-5 relative); two
# runs of the step at one seed, the same (the embedding's gradient sums by
# index, whose order the card may change: 1e-6 relative).
SCST_TOL, REPEAT_TOL = 1e-5, 1e-6
SCST_STEPS = 5   # timed steps after one warm-up
REPO = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"chip_smoke FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def gpu_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    from CUDA events (weights stay warm in the 50 MB L2)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def plain_beam_step(w, k):
    """``fused_beam_step`` with the plain versions, for the comparison."""
    def step(st, tok):
        h, c = beam_core_plain(w.embedding[tok], st.h[0], st.c[0], st.keys,
                               st.values, st.frame_mask, w.wq, w.u, w.wg,
                               w.bg, k)
        logp, idx = topk_project_plain(h, w.w_out, w.b_out, k, w.vocab_size)
        return (DecoderState(h[None], c[None], st.keys, st.values,
                             st.frame_mask), logp, idx)
    return step


def phase_k1():
    g = np.random.default_rng(1)
    dev = "cuda"
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=dev)
    mask = np.ones((B, T), np.float32)
    for b, n in enumerate(g.integers(1, T + 1, B)):
        mask[b, n:] = 0.0        # masked tail frames
    mask[3] = 0.0                # one video with no real frame
    x = dict(
        emb=t(g.normal(size=(B * K, E)) * 0.2),
        h=t(np.tanh(g.normal(size=(B * K, H)))),
        c=t(g.normal(size=(B * K, H))),
        keys=t(g.normal(size=(B, T, A)), torch.bfloat16),
        values=t(g.normal(size=(B, T, H)), torch.bfloat16),
        frame_mask=t(mask),
        wq=t(g.normal(size=(H, A)) / np.sqrt(H), torch.bfloat16),
        u=t(g.normal(size=A) * 0.05),
        wg=t(g.uniform(-1, 1, (E + 2 * H, 4 * H)) * np.sqrt(6 / (E + 6 * H)),
             torch.bfloat16),
        bg=t(g.normal(size=4 * H) * 0.1))
    hk, ck = beam_core(**x, beam_width=K)
    hp, cp = beam_core_plain(**x, beam_width=K)
    torch.cuda.synchronize()
    if not (torch.isfinite(hk).all() and torch.isfinite(ck).all()):
        fail("K1 beam_core returned non-finite values")
    err = max((hk - hp).abs().max().item(), (ck - cp).abs().max().item())
    if err > K1_TOL:
        fail(f"K1 beam_core vs plain: max |err| {err} > {K1_TOL}")
    a16 = torch.cat([x["emb"], x["h"], x["h"]], 1).bfloat16()
    lib = time_ms(lambda: torch.matmul(a16, x["wg"]))
    rows = B * K
    nbytes = (rows * (E + 4 * H) * 4 + B * T * (A + H) * 2 + B * T * 4
              + H * A * 2 + A * 4 + (E + 2 * H) * 4 * H * 2 + 4 * H * 4)
    flops = 2 * rows * ((E + 2 * H) * 4 * H + H * A + T * A + T * H)
    b_ms, b_by = bound(nbytes, flops)
    return dict(name="beam_core", route="cuda",
                source="vidcap_tpu_torch/csrc/beam_core.cu",
                replaces="vidcap_tpu/ops/pallas_beam_core.py:103",
                max_abs_err=err,
                ms=time_ms(lambda: beam_core(**x, beam_width=K)),
                plain_ms=time_ms(lambda: beam_core_plain(**x, beam_width=K),
                                 iters=5),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib)


def check_topk(h, w, b, k, vocab, got=None):
    """K2's result (``got``, else a launch on these inputs) against the plain
    version: values within one bf16 ulp of the row's largest |logit| (+1e-4
    for the f32 lse); where the k-th and (k+1)-th logits are further apart
    than that, the index sets equal. Returns (max |err|, exact-row
    fraction)."""
    vk, ik = got if got is not None else topk_project(h, w, b, k, vocab)
    vp, ip = topk_project_plain(h, w, b, k, vocab)
    vp1, _ = topk_project_plain(h, w, b, k + 1, vocab)
    torch.cuda.synchronize()
    logits = h.bfloat16().float() @ w.float()
    tol = bf16_ulp(logits.abs().amax(1)) + 1e-4
    err = (vk - vp).abs()
    if not torch.isfinite(vk).all() or (err > tol[:, None]).any():
        fail(f"K2 topk_project (k={k}, vocab={vocab}) vs plain: max |err| "
             f"{err.max().item()} beyond one bf16 ulp of the logit")
    clear = vp1[:, k - 1] - vp1[:, k] > tol
    same = (ik.sort(1).values == ip.sort(1).values).all(1)
    if not same[clear].all():
        fail(f"K2 topk_project (k={k}, vocab={vocab}): top-k index sets "
             f"differ on {(~same[clear]).sum().item()} rows with a clear gap")
    if (ik >= vocab).any() and vocab >= k:
        fail("K2 topk_project returned a padding column")
    return err.max().item(), (ik == ip).all(1).float().mean().item()


def phase_k2():
    g = np.random.default_rng(2)
    n = B * K
    h = torch.tensor(np.tanh(g.normal(size=(n, H))), dtype=torch.float32,
                     device="cuda")
    w = torch.tensor(g.normal(size=(H, VP)) / np.sqrt(H), dtype=torch.bfloat16,
                     device="cuda")
    b = torch.tensor(g.normal(size=VP) * 0.1, dtype=torch.float32,
                     device="cuda")
    errs, exact_rows = [], {}
    for k, vocab in ((5, VP), (6, VP), (5, 15_000)):
        e, x = check_topk(h, w, b, k, vocab)
        errs.append(e)
        exact_rows[f"k{k}_v{vocab}"] = x
    wd, bd = w.clone(), b.clone()
    wd[:, 1::2], bd[1::2] = wd[:, 0::2], bd[0::2]   # duplicated columns tie
    e, x = check_topk(h, wd, bd, 5, VP)
    errs.append(e)
    exact_rows["duplicate_columns"] = x
    _, iz = topk_project(torch.zeros_like(h), torch.zeros_like(w),
                         torch.zeros_like(b), 5, VP)
    if not (iz.cpu() == torch.arange(5, dtype=torch.int32)).all():
        fail("K2 topk_project: all-equal logits must give columns 0..4")
    h16 = h.bfloat16()
    nbytes = n * H * 4 + H * VP * 2 + VP * 4 + n * K * 8
    b_ms, b_by = bound(nbytes, 2 * n * H * VP)
    return dict(name="topk_project", route="cuda",
                source="vidcap_tpu_torch/csrc/topk_project.cu",
                replaces="vidcap_tpu/ops/pallas_topk.py:117",
                max_abs_err=max(errs),
                ms=time_ms(lambda: topk_project(h, w, b, K, VP)),
                plain_ms=time_ms(lambda: topk_project_plain(h, w, b, K, VP),
                                 iters=5),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(lambda: torch.matmul(h16, w))), exact_rows


def phase_end_to_end():
    cfg = get_preset("msrvtt_attn_beam5")
    vocab = vocab_of(VP)
    g = np.random.default_rng(0)
    trials = [g.normal(size=(B, T, D)).astype(np.float32) for _ in range(3)]
    ids = [f"video{i}" for i in range(B)]
    ds = CaptionDataset(trials[0], ids, {v: [] for v in ids}, cfg.data,
                        vocab=vocab)
    cap = Captioner.from_checkpoint(cfg, ds)          # seeded random weights

    # ---- the main path: counts at 0 just before, read just after
    _build.reset_counts()
    cap.decode_steps = 0
    first = cap.decode_batch(trials[0], beam_width=K)     # warm-up
    dts = []
    for f in trials:
        t0 = time.perf_counter()
        toks = cap.decode_batch(f, beam_width=K)
        dts.append(time.perf_counter() - t0)
    launches = dict(_build.launch_counts)
    steps = cap.decode_steps
    if not 4 <= steps <= 4 * cfg.decode.max_len:
        fail(f"main path ran {steps} beam steps for 4 decodes")
    if launches != {"beam_core": steps, "topk_project": steps, "rollout": 0}:
        fail(f"beam path: launches {launches} for {steps} steps")
    if toks.shape != (B, cfg.decode.max_len) or not (
            (toks >= 0) & (toks < VP)).all():
        fail(f"bad token array {toks.shape}")
    if not np.array_equal(first, cap.decode_batch(trials[0], beam_width=K)):
        fail("two decodes of the same input differ")
    paths = compare_paths(cap, trials)

    # what early exit's host read of finished.all() per step costs: these
    # weights emit no <eos>, so without it the decode gives the same tokens
    no_exit = Captioner(dataclasses.replace(cfg, decode=dataclasses.replace(
        cfg.decode, early_exit=False)), cap.model, ds, cap.device)
    dts_sync, dts_free = [], []
    for f in trials:
        for c, dt in ((cap, dts_sync), (no_exit, dts_free)):
            t0 = time.perf_counter()
            toks = c.decode_batch(f, beam_width=K)
            dt.append(time.perf_counter() - t0)
            if c is cap:
                ref = toks
        if not np.array_equal(toks, ref):
            fail("the decode without early exit gave other tokens")
    return dict(captions_per_s=B / float(np.median(dts)),
                trial_captions_per_s=[B / d for d in dts],
                decode_steps=steps, launches=launches,
                captions_per_s_early_exit_read=B / float(np.median(dts_sync)),
                captions_per_s_no_early_exit=B / float(np.median(dts_free)),
                **paths)


def compare_paths(cap, trials):
    """(a) Step by step along the kernel path's own beam on the first
    trial: each step's K1 and K2 against the plain versions on the same
    state and tokens, with the tolerances of phases 2 and 3. (b) For each
    trial, the whole decode through the kernels and through the plain
    versions, from the same state. Random weights leave near-ties of one
    bf16 ulp in every step, so two right implementations that sum in
    different orders part after a few steps. The noise floor is measured,
    not assumed: the same plain code on the CPU against itself on the card,
    per trial. The kernel path's share of rows identical to the plain path,
    pooled over the trials, must reach the lowest trial's floor less
    ``ROW_SLACK``, and the best scores must stay within 0.01 nats in the
    median row. Every reading is computed before any check fails, and a
    failure prints them all."""
    cfg = cap.cfg
    w = cap._beam_weights
    w_cpu = dataclasses.replace(w, **{
        f.name: getattr(w, f.name).cpu() for f in dataclasses.fields(w)
        if isinstance(getattr(w, f.name), torch.Tensor)})
    kstep, pstep = fused_beam_step(w, K), plain_beam_step(w, K)
    cstep = plain_beam_step(w_cpu, K)
    worst = {"h_c": 0.0, "logp": 0.0}

    def checked_step(st, tok):
        st_k, lk, ik = kstep(st, tok)
        st_p, _, _ = pstep(st, tok)
        worst["h_c"] = max(worst["h_c"], (st_k.h - st_p.h).abs().max().item(),
                           (st_k.c - st_p.c).abs().max().item())
        e, _ = check_topk(st_k.h[0], w.w_out, w.b_out, K, w.vocab_size,
                          got=(lk, ik))
        worst["logp"] = max(worst["logp"], e)
        return st_k, lk, ik

    def decode(step, state):
        return beam_decode(step, state, batch=B, max_len=cfg.decode.max_len,
                           beam_width=K, early_exit=cfg.decode.early_exit)

    same, floors, score_err, diff_at = [], [], [], []
    with torch.inference_mode():
        for i, feats in enumerate(trials):
            st = tile_recurrent(cap.model.init_state(
                torch.tensor(feats, device="cuda")), K)
            st_cpu = DecoderState(*(getattr(st, fl.name).cpu()
                                    for fl in dataclasses.fields(st)))
            tk, sk = decode(kstep, st)
            tp, sp = decode(pstep, st)
            tc = decode(cstep, st_cpu)[0].cuda()
            if not torch.isfinite(sk).all():
                fail("non-finite beam scores")
            if i == 0:
                if not torch.equal(decode(checked_step, st)[0], tk):
                    fail("the checked decode differs from the kernel decode")
                if not np.array_equal(tk.cpu().numpy(),
                                      cap.decode_batch(feats, beam_width=K)):
                    fail("Captioner.decode_batch differs from the fused "
                         "beam_decode")
            row_same = (tk == tp).all(1)
            same.append(row_same.float().mean().item())
            floors.append((tc == tp).all(1).float().mean().item())
            score_err.append((sk - sp).abs())
            diff_at.append((tk != tp).int().argmax(1).float()[~row_same])
    score_err, diff_at = torch.cat(score_err), torch.cat(diff_at)
    out = dict(step_h_c_max_abs_err=worst["h_c"],
               step_logp_max_abs_err=worst["logp"],
               identical_rows=float(np.mean(same)),
               identical_rows_by_trial=same,
               identical_rows_plain_cpu_vs_card_by_trial=floors,
               first_divergence_median_step=(diff_at.median().item()
                                             if len(diff_at) else None),
               score_median_abs_err=score_err.median().item(),
               score_max_abs_err=score_err.max().item())
    problems = []
    if worst["h_c"] > K1_TOL:
        problems.append(f"a decode step's K1 vs plain |err| {worst['h_c']} "
                        f"> {K1_TOL}")
    if out["identical_rows"] < min(floors) - ROW_SLACK:
        problems.append(f"kernel vs plain decode: {out['identical_rows']} of "
                        f"the rows identical, below the lowest plain "
                        f"CPU-vs-card floor {min(floors)} less {ROW_SLACK}")
    if out["score_median_abs_err"] > 0.01:
        problems.append(f"kernel vs plain decode: median best-score |err| "
                        f"{out['score_median_abs_err']} > 0.01")
    if problems:
        fail("; ".join(problems) + " | " + json.dumps(out))
    return out


def vocab_of(n: int) -> Vocab:
    words = SPECIALS + [f"w{i}" for i in range(n - len(SPECIALS))]
    return Vocab({w: i for i, w in enumerate(words)}, words)


def run_cli(cmd, preset: str, vocab: int, tmp: str, never=()):
    """``python -m vidcap_tpu_torch <cmd> --preset <preset>`` with seeded
    random weights on the synthetic fallback corpus, the output bias of the
    tokens ``never`` at -30 so that they are never picked: checks one
    non-empty caption per video and returns (captions, method, decodes,
    steps, launches, K3's W_out mode or None) from the stderr line."""
    cfg = get_preset(preset)
    weights = os.path.join(tmp, f"{preset}.npz")
    model = init_params(create_model(cfg, vocab), cfg.train.seed)
    with torch.no_grad():
        model.decoder.out_proj.bias[list(never)] = -30.0
    save_weights(model, weights)
    caps = os.path.join(tmp, f"{preset}.json")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [REPO, os.environ.get("PYTHONPATH")]))}
    r = subprocess.run(
        [sys.executable, "-m", "vidcap_tpu_torch", *cmd, "--preset", preset,
         "--weights", weights, "--out", caps],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        fail(f"CLI {cmd} exited {r.returncode}: {r.stderr[-2000:]}")
    with open(caps) as fh:
        results = json.load(fh)
    if not results or not all(isinstance(c, list) and len(c) == 1 and c[0]
                              for c in results.values()):
        fail(f"CLI {cmd}: every video needs one non-empty caption")
    line = re.findall(r"\] (\w+): (\d+) decodes, (\d+) steps on [^;]*"
                      r"(?:; rollout W_out (\w+))?; kernel launches (\{.*\})",
                      r.stderr)
    if not line:
        fail(f"CLI {cmd} printed no launch counts: {r.stderr[-2000:]}")
    method, decodes, steps, mode, launches = line[-1]
    return (results, method, int(decodes), int(steps), json.loads(launches),
            mode or None)


def phase_cli():
    with tempfile.TemporaryDirectory() as tmp:
        results, method, _, steps, launches, _ = run_cli(
            ["caption"], "msrvtt_attn_beam5", VP, tmp)
    if method != "beam" or steps < 1 or launches != {
            "beam_core": steps, "topk_project": steps, "rollout": 0}:
        fail(f"CLI: {method} {steps} steps but launches {launches}")
    return dict(videos=len(results), steps=steps, launches=launches)


def eos_raised(w, args, sample: bool):
    """A copy of ``w`` whose b_out[<eos>] is raised, from the plain step 0 at
    temperature 1: greedy, by the 40th percentile over rows of the gap from
    the top logit to <eos>'s, so that about 40% of the rows end at once;
    sampled, by the median raise that gives <eos> a probability of 0.05, so
    that rows end at spread-out steps. Either way some rows end before
    max_len and some do not (the phase checks and reports the share)."""
    keys, values, fmask, h0, c0 = args
    bos = torch.full((h0.shape[0],), BOS, dtype=torch.long, device=h0.device)
    _, _, clean = step_plain(w, h0, c0, bos, keys, values, fmask, 1.0)
    eos = clean[:, EOS].clone()
    clean[:, EOS] = NEG
    if sample:
        by = (np.log(0.05 / 0.95) + torch.logsumexp(clean, -1) - eos).median()
    else:
        by = torch.quantile(clean.max(-1).values - eos, 0.4)
    b = w.b_out.clone()
    b[EOS] += by.item()
    return dataclasses.replace(w, b_out=b), by.item()


def check_rollout(tk, lk, mk, pick, margin, logp_ref, tol):
    """The kernel's rollout against the plain replay along its tokens:
    returns (a list of problems, max |logp err| on live steps, the share of
    live steps whose plain margin is clear)."""
    problems = []
    live = mk > 0
    clear = live & (margin > tol)
    if not torch.equal(tk[clear].long(), pick[clear]):
        problems.append(f"{(tk[clear].long() != pick[clear]).sum().item()} "
                        "clear-margin picks differ from the plain pick")
    err = (lk - logp_ref)[live].abs().max().item()
    if not err <= tol:
        problems.append(f"logp |err| {err} > {tol}")
    ended = torch.cumsum((tk == EOS).int(), 1) - (tk == EOS).int() > 0
    if not torch.equal(live, ~ended):
        problems.append("mask is not 1 up to and including the first <eos>")
    if not ((tk[ended] == PAD).all() and (lk[ended] == 0).all()):
        problems.append("PAD and logp 0 do not follow <eos>")
    if not ((lk[live] <= 1e-5).all() and torch.isfinite(lk).all()
            and ((tk >= 0) & (tk < VOCAB_G)).all()):
        problems.append("non-finite or positive logp, or a padding column")
    return problems, err, clear.float().sum().item() / live.float().sum().item()


def kernels_per_rollout(w, args, length: int) -> int:
    """Device kernels one rollout of ``length`` steps enqueues, counted by
    torch.profiler (copies and fills are not kernels and the wrapper makes
    none)."""
    from torch.profiler import ProfilerActivity, profile
    rollout(w, *args, length)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rollout(w, *args, length)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset")))


def phase_k3():
    """K3 at msvd_greedy width, greedy and sampled, on the seeded weights
    and on raised-<eos> copies, in both W_out modes (resident, streamed):
    (a) each rollout replayed through the plain step along the kernel's
    tokens; (b) the share of rows identical to the plain rollout on the
    card, pooled per run over both weight sets, against the plain-on-CPU-
    vs-card floor less ROW_SLACK, as compare_paths does; (c) finish
    semantics, and some rows ending before max_len on the raised copies;
    (d) each rollout run twice gives the same tokens and log-probs; (e) all
    logits equal (W_out = 0, b_out constant): greedy takes column 0 at every
    step, sampled what the plain version takes, logp = -log(vocab); (f) one
    rollout is at most two device kernels, as many at L = 8 as at L = 30;
    (g) a resident W_out of 65,536 columns is refused (and streams); (h)
    times of both modes and the bound."""
    cfg = get_preset("msvd_greedy")
    model = init_params(create_model(cfg, VOCAB_G), cfg.train.seed)
    model = model.cuda().eval()
    w = RolloutWeights.from_model(model)
    g = np.random.default_rng(3)
    mask = np.ones((BG, T), np.float32)
    for b, n in enumerate(g.integers(1, T + 1, BG)):
        mask[b, n:] = 0.0        # masked tail frames
    mask[3] = 0.0                # one video with no real frame
    with torch.inference_mode():
        st = model.init_state(
            torch.tensor(g.normal(size=(BG, T, D)), dtype=torch.float32,
                         device="cuda"), torch.tensor(mask, device="cuda"))
    args = (st.keys, st.values, st.frame_mask, st.h[0].contiguous(),
            st.c[0].contiguous())
    raised = {False: eos_raised(w, args, False),
              True: eos_raised(w, args, True)}
    cpu = lambda x: dataclasses.replace(x, **{
        f.name: getattr(x, f.name).cpu() for f in dataclasses.fields(x)
        if isinstance(getattr(x, f.name), torch.Tensor)})
    args_cpu = tuple(a.cpu() for a in args)
    problems, errs, clear, floors = [], [], [], {}
    same = {m: {} for m in K3_MODES}
    ended = {m: {} for m in K3_MODES}
    for name, sample, seed, temp in K3_RUNS:
        tol = K3_LOGIT_TOL / temp
        rows_same, rows_floor = {m: [] for m in K3_MODES}, []
        for wname, wt in (("seeded", w), ("raised", raised[sample][0])):
            run = (L, sample, seed, temp)
            tp, _, _ = rollout_plain(wt, *args, *run)
            tc, _, _ = rollout_plain(cpu(wt), *args_cpu, *run)
            rows_floor.append((tc.cuda() == tp).all(1))
            for mode, resident in K3_MODES.items():
                tk, lk, mk = rollout(wt, *args, *run, resident_wout=resident)
                tk2, lk2, _ = rollout(wt, *args, *run, resident_wout=resident)
                torch.cuda.synchronize()
                if not (torch.equal(tk, tk2) and torch.equal(lk, lk2)):
                    problems.append(f"{name} {wname} {mode}: two runs differ")
                pick, margin, logp_ref = replay_plain(wt, *args, tk, sample,
                                                      seed, temp)
                p, err, c = check_rollout(tk, lk, mk, pick, margin, logp_ref,
                                          tol)
                problems += [f"{name} {wname} {mode}: {x}" for x in p]
                errs.append(err)
                clear.append(c)
                rows_same[mode].append((tk == tp).all(1))
                if wname == "raised":
                    ended[mode][name] = (tk == EOS).any(1).float().mean().item()
        for mode in K3_MODES:
            same[mode][name] = torch.cat(rows_same[mode]).float().mean().item()
        floors[name] = torch.cat(rows_floor).float().mean().item()
    pooled = {m: float(np.mean(list(same[m].values()))) for m in K3_MODES}
    for mode in K3_MODES:
        if pooled[mode] < min(floors.values()) - ROW_SLACK:
            problems.append(f"kernel vs plain rollouts, {mode}: "
                            f"{pooled[mode]} of the rows identical, below the "
                            f"lowest plain CPU-vs-card floor "
                            f"{min(floors.values())} less {ROW_SLACK}")
        for kind in ("greedy", "sample"):
            share = [v for k, v in ended[mode].items() if k.startswith(kind)]
            if not 0 < float(np.mean(share)) < 1:
                problems.append(f"raised-<eos> {kind} {mode}: share of rows "
                                f"ending {share}: need some to end and some "
                                "not")
    # (e) all logits equal
    flat = dataclasses.replace(w, w_out=torch.zeros_like(w.w_out),
                               b_out=torch.full_like(w.b_out, 0.5))
    flat_logp = -float(np.log(VOCAB_G))
    for mode, resident in K3_MODES.items():
        for sample in (False, True):
            tk, lk, _ = rollout(flat, *args, L, sample, 1, 1.0,
                                resident_wout=resident)
            tp, _, _ = rollout_plain(flat, *args, L, sample, 1, 1.0)
            if not sample and not (tk == 0).all():
                problems.append(f"all-equal logits, greedy {mode}: picks "
                                f"{tk.unique().tolist()[:8]}, not column 0")
            if sample and not torch.equal(tk, tp):
                problems.append(f"all-equal logits, sampled {mode}: "
                                f"{(tk != tp).sum().item()} picks differ from "
                                "the plain version's")
            if not torch.allclose(lk, torch.full_like(lk, flat_logp),
                                  rtol=0, atol=1e-4):
                problems.append(f"all-equal logits, {mode}: logp "
                                f"{lk.min().item()}..{lk.max().item()}, not "
                                f"{flat_logp}")
    # (f) kernels per rollout
    kernels = {n: kernels_per_rollout(w, args, n) for n in (L, 8)}
    if not 1 <= kernels[L] == kernels[8] <= 2:
        problems.append(f"device kernels per rollout {kernels} (L = {L}, 8):"
                        " need the same count, at most 2")
    # (g) a vocab too wide for a resident W_out
    wide_vp = 65_536
    gw = torch.Generator("cuda").manual_seed(5)
    randn = lambda *shape: torch.randn(*shape, generator=gw, device="cuda")
    wide = dataclasses.replace(
        w, emb=(randn(wide_vp, w.emb.shape[1]) * 0.1).bfloat16(),
        w_out=(randn(w.w_out.shape[0], wide_vp) * 0.05).bfloat16(),
        b_out=torch.zeros(wide_vp, device="cuda"), vocab_size=wide_vp)
    try:
        rollout(wide, *args, L)
        problems.append(f"resident_wout=True at Vp={wide_vp} did not raise")
    except ValueError as e:
        if "resident_wout=False" not in str(e):
            problems.append(f"Vp={wide_vp}: the error names no "
                            f"resident_wout=False: {e}")
    tw, _, _ = rollout(wide, *args, L, resident_wout=False)
    if not ((tw >= 0) & (tw < wide_vp)).all():
        problems.append(f"streamed rollout at Vp={wide_vp}: bad tokens")
    out = dict(max_abs_logp_err=max(errs), clear_step_share_min=min(clear),
               identical_rows=pooled, identical_rows_by_run=same,
               identical_rows_plain_cpu_vs_card_by_run=floors,
               raised_eos_by={"greedy": raised[False][1],
                              "sample": raised[True][1]},
               raised_eos_rows_ended=ended,
               kernels_per_rollout_by_length=kernels)
    if problems:
        fail("K3 rollout: " + "; ".join(problems) + " | " + json.dumps(out))

    # (h) the bound: every product once per row and step; the weights, the
    # attention keys/values, h0/c0 and the gathered embedding rows read once
    # per launch (one launch is one rollout), the outputs written once
    E_, H_, A_ = w.emb.shape[1], args[3].shape[1], args[0].shape[2]
    flops = 2 * BG * L * (H_ * A_ + (E_ + 2 * H_) * 4 * H_ + H_ * VG
                          + T * A_ + T * H_)
    nbytes = (BG * L * E_ * 2 + H_ * A_ * 2 + A_ * 4 + (E_ + 2 * H_) * 4 * H_
              * 2 + 4 * H_ * 4 + H_ * VG * 2 + VG * 4 + BG * T * (A_ + H_) * 2
              + BG * T * 4 + 2 * BG * H_ * 4 + BG * L * 12)
    b_ms, b_by = bound(nbytes, flops)
    h16 = args[3].bfloat16()
    times = dict(
        ms=time_ms(lambda: rollout(w, *args, L), iters=5),
        sample_ms=time_ms(lambda: rollout(w, *args, L, True, 1, 1.0), iters=5),
        streamed_ms=time_ms(lambda: rollout(w, *args, L, resident_wout=False),
                            iters=5),
        streamed_sample_ms=time_ms(lambda: rollout(
            w, *args, L, True, 1, 1.0, resident_wout=False), iters=5),
        plain_ms=time_ms(lambda: rollout_plain(w, *args, L), iters=2, reps=3),
        matmul_h_wout_ms=time_ms(lambda: torch.matmul(h16, w.w_out)))
    k3 = dict(name="rollout", route="cuda",
              source="vidcap_tpu_torch/csrc/rollout.cu",
              replaces="vidcap_tpu/ops/pallas_decoder.py:338",
              max_abs_err=out["max_abs_logp_err"], ms=times["ms"],
              plain_ms=times["plain_ms"], bound_ms=b_ms, bound_by=b_by,
              library_ms=None, mode="resident",
              kernels_per_rollout=kernels[L])
    return k3, dict(out, **times, bound_flops=flops, bound_bytes=nbytes)


def phase_rollout_end_to_end():
    """Captioner greedy (msvd_greedy) and sampled (scst_cider, seed 1) at
    B=32 on three distinct inputs, each path with the counts at 0 just
    before it and read just after: one rollout launch per decode, no K1/K2
    launch; the same seed twice gives the same tokens, two seeds others."""
    g = np.random.default_rng(4)
    trials = [g.normal(size=(BG, T, D)).astype(np.float32) for _ in range(3)]
    ids = [f"video{i}" for i in range(BG)]
    out = {}
    for preset, method in (("msvd_greedy", "greedy"), ("scst_cider", "sample")):
        cfg = get_preset(preset)
        cap = Captioner.from_checkpoint(cfg, CaptionDataset(
            trials[0], ids, {v: [] for v in ids}, cfg.data,
            vocab=vocab_of(VOCAB_G)), seed=1)
        _build.reset_counts()
        cap.decode_calls = 0
        dts = []
        for f in trials:
            t0 = time.perf_counter()
            toks = cap.decode_batch(f, method=method)
            dts.append(time.perf_counter() - t0)
        launches, decodes = dict(_build.launch_counts), cap.decode_calls
        if launches != {"beam_core": 0, "topk_project": 0,
                        "rollout": decodes} or decodes != 3:
            fail(f"{method} path: launches {launches} for {decodes} decodes")
        if toks.shape != (BG, L) or not ((toks >= 0) & (toks < VOCAB_G)).all():
            fail(f"{method}: bad token array {toks.shape}")
        again = [cap.decode_batch(trials[0], method=method, seed=s)
                 for s in (7, 7, 8)]
        if not np.array_equal(again[0], again[1]):
            fail(f"{method}: two decodes of the same input and seed differ")
        if method == "sample" and np.array_equal(again[0], again[2]):
            fail("sample: two seeds gave the same tokens")
        if cap.rollout_resident is not True:
            fail(f"{method}: the Captioner did not keep W_out resident")
        out[method] = dict(captions_per_s=BG / float(np.median(dts)),
                           trial_captions_per_s=[BG / d for d in dts],
                           decodes=decodes, launches=launches)
    return out


def phase_cli_rollout():
    """Over the fallback corpus' 43 words a random-weight rollout may emit
    <eos> at once, an empty caption: the weights never pick PAD, BOS or
    <eos>, so every caption has max_len words."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for cmd, preset in ((["caption"], "msvd_greedy"),
                            (["sample", "--seed", "1"], "scst_cider")):
            results, method, decodes, steps, launches, mode = run_cli(
                cmd, preset, VOCAB_G, tmp, never=(PAD, BOS, EOS))
            if method != ("sample" if cmd[0] == "sample" else "greedy") or \
                    decodes < 1 or steps != decodes * L or launches != {
                        "beam_core": 0, "topk_project": 0,
                        "rollout": decodes} or mode != "resident":
                fail(f"CLI {cmd}: {method}, {decodes} decodes, {steps} steps,"
                     f" launches {launches}, W_out {mode}")
            out[" ".join(cmd)] = dict(preset=preset, videos=len(results),
                                      decodes=decodes, launches=launches,
                                      w_out=mode)
    return out


def scst_dataset(cfg, model, g):
    """64 videos of N(0,1) features, 5 captions each (up to 29 words, then
    <eos>), over the 12,000-word vocab: caption 0 of a video is a prefix of
    the plain greedy rollout of the seeded model on it, the others mix its
    words with words of a 300-word pool, so that references share n-grams
    and both rollouts earn rewards above 0."""
    n = 64
    feats = g.normal(size=(n, T, D)).astype(np.float32)
    vocab = vocab_of(VOCAB_G)
    with torch.inference_mode():
        st = model.init_state(torch.tensor(feats, device="cuda"))
        toks, _, _ = rollout_plain(RolloutWeights.from_model(model), st.keys,
                                   st.values, st.frame_mask, st.h[0], st.c[0],
                                   L)
    toks = toks.cpu().numpy()
    pool = g.integers(4, VOCAB_G, 300)
    ids = [f"video{i}" for i in range(n)]
    captions = {}
    for i, v in enumerate(ids):
        own = [t for t in toks[i] if t >= 4] or [int(pool[0])]
        caps = [own[:int(g.integers(8, 30))]]
        for _ in range(4):
            k = int(g.integers(5, 30))
            caps.append([int(own[j % len(own)]) if g.random() < 0.4
                         else int(g.choice(pool)) for j in range(k)])
        captions[v] = [" ".join(vocab.id_to_word[t] for t in c)
                       for c in caps]
    return CaptionDataset(feats, ids, captions, cfg.data, vocab=vocab)


def plain_rollouts(state, batch, seed: int, cfg):
    """The SCST step's two rollouts through the plain version on the card,
    as ``ScstStep.rollouts`` takes them through K3."""
    model, d = state.model, cfg.decode
    with torch.inference_mode():
        st = model.init_state(batch["features"])
        w = RolloutWeights.from_model(model)
        args = (w, st.keys, st.values, st.frame_mask, st.h[0].contiguous(),
                st.c[0].contiguous(), d.max_len)
        return (Rollout(*rollout_plain(*args, True, seed, d.temperature)),
                Rollout(*rollout_plain(*args)))


def loss_pieces(step, state, batch, sample, greedy, rows):
    """The step's differentiable part on ``rows`` of the batch, without the
    update: (rewards, metrics with the gradient norm)."""
    sub = {k: v[rows] for k, v in batch.items()}
    pick = lambda r: Rollout(r.tokens[rows], r.logp[rows], r.mask[rows])
    s, gr = pick(sample), pick(greedy)
    rewards = step.rewards(sub, s, gr)
    loss, m = step.loss(state.model, sub, s, gr, rewards)
    params = state.params
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    m["grad_norm"] = optax_global_norm({k: g for k, g in zip(params, grads)
                                        if g is not None})
    return rewards, {k: float(v.detach()) for k, v in m.items()}


def phase_scst(row_floor: float):
    """One SCST step at scst_cider width (B=32, vocab 12,000) on the seeded
    weights: the rollouts through K3 (2 launches) and through the plain
    version from the same state and seed; the kernel's rows identical to the
    plain ones on at least ``row_floor`` of them (phase 6's floor), pooled;
    on identical rows the rewards and the loss pieces of both paths within
    SCST_TOL; K3's log-probs of the sampled tokens against the
    differentiable re-score's within K3_LOGIT_TOL / temperature; the loss
    and gradient norm finite, the parameters changed, two runs at one seed
    the same. Then the step's time: whole (host clock, synchronized), K3's
    share (CUDA events around the two rollouts), the reward, the re-score +
    backward + update; medians of SCST_STEPS steps after one warm-up, the
    counts at 0 before them and read after."""
    cfg = get_preset("scst_cider")
    seed = 12345
    fresh = lambda: create_train_state(cfg, init_params(
        create_model(cfg, VOCAB_G), cfg.train.seed).cuda())
    state = fresh()
    ds = scst_dataset(cfg, state.model, np.random.default_rng(9))
    step = make_scst_step_body(cfg, ds)
    batches = DeterministicBatcher(ds, cfg.train.batch_size, seed=0)
    batch = batch_to_device(next(batches), "cuda")
    problems = []

    _build.reset_counts()
    sample, greedy = step.rollouts(state, batch, seed)
    torch.cuda.synchronize()
    one_step = dict(_build.launch_counts)
    if one_step != {"beam_core": 0, "topk_project": 0, "rollout": 2}:
        problems.append(f"one SCST step's rollouts launched {one_step}")
    if step.rollout_resident is not True:
        problems.append("the SCST step did not keep W_out resident")
    ps, pg = plain_rollouts(state, batch, seed, cfg)
    same_s = (sample.tokens == ps.tokens).all(1)
    same_g = (greedy.tokens == pg.tokens).all(1)
    identical = torch.cat([same_s, same_g]).float().mean().item()
    if identical < row_floor:
        problems.append(f"{identical} of the rollout rows identical to the "
                        f"plain path, below phase 6's floor {row_floor}")
    rows = same_s & same_g
    r_k, m_k = loss_pieces(step, state, batch, sample, greedy, rows)
    r_p, m_p = loss_pieces(step, state, batch, ps, pg, rows)
    for a, b in zip(r_k, r_p):
        if not torch.allclose(a, b, rtol=SCST_TOL, atol=SCST_TOL):
            problems.append("rewards differ on identical rows")
    for k in ("pg_loss", "xe_anchor", "attr_loss", "loss", "grad_norm",
              "reward_sample", "reward_greedy"):
        if not abs(m_k[k] - m_p[k]) <= SCST_TOL * max(abs(m_p[k]), 1e-6):
            problems.append(f"{k}: kernel path {m_k[k]}, plain {m_p[k]}")
    # the kernel's log-probs against the differentiable re-score's
    with torch.no_grad():
        logits = state.model.xe_logits(batch["features"], None,
                                       shift_right(sample.tokens))
        rescored = torch.log_softmax(logits / cfg.decode.temperature, -1) \
            .gather(-1, sample.tokens.long()[..., None])[..., 0]
    live = sample.mask > 0
    logp_err = (rescored - sample.logp)[live].abs().max().item()
    if not logp_err <= K3_LOGIT_TOL / cfg.decode.temperature:
        problems.append(f"K3 logp vs the re-score's: |err| {logp_err}")
    before = {k: p.detach().clone() for k, p in state.params.items()}
    state, m = step.update(state, batch, sample, greedy)
    m = {k: float(v) for k, v in m.items()}
    if not all(np.isfinite(v) for v in m.values()):
        problems.append(f"non-finite metrics {m}")
    if all(torch.equal(p, before[k]) for k, p in state.params.items()):
        problems.append("the step changed no parameter")
    twin, m2 = step(fresh(), batch, seed)
    m2 = {k: float(v) for k, v in m2.items()}
    for k in m:
        if not abs(m[k] - m2[k]) <= REPEAT_TOL * max(abs(m[k]), 1e-6):
            problems.append(f"two runs at one seed: {k} {m[k]} vs {m2[k]}")
    param_repeat = max((p - twin.params[k]).abs().max().item()
                       for k, p in state.params.items())
    if not param_repeat <= REPEAT_TOL:
        problems.append(f"two runs at one seed: parameters {param_repeat} "
                        "apart")

    # ---- the main path, timed: the counts at 0 just before, read just after
    _build.reset_counts()
    times = {"step_ms": [], "rollouts_ms": [], "reward_ms": [],
             "rescore_backward_update_ms": []}
    for i in range(1 + SCST_STEPS):
        b = batch_to_device(next(batches), "cuda")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        s, gr = step.rollouts(state, b)
        ev[1].record()
        rewards = step.rewards(b, s, gr)
        ev[2].record()
        state, mi = apply_loss(state, *step.loss(state.model, b, s, gr,
                                                 rewards))
        ev[3].record()
        torch.cuda.synchronize()
        if i:
            times["step_ms"].append((time.perf_counter() - t0) * 1e3)
            for k, (a, z) in zip(list(times)[1:], ((0, 1), (1, 2), (2, 3))):
                times[k].append(ev[a].elapsed_time(ev[z]))
        if not all(torch.isfinite(v) for v in mi.values()):
            problems.append(f"step {i}: non-finite metrics")
    launches = dict(_build.launch_counts)
    if launches != {"beam_core": 0, "topk_project": 0,
                    "rollout": 2 * (1 + SCST_STEPS)}:
        problems.append(f"{1 + SCST_STEPS} SCST steps launched {launches}")
    med = {k: float(np.median(v)) for k, v in times.items()}
    out = dict(identical_rows=identical, identical_rows_floor=row_floor,
               rows_compared=int(rows.sum().item()),
               kernel_path=m_k, plain_path=m_p, logp_vs_rescore=logp_err,
               step_metrics=m, repeat_param_max_abs_diff=param_repeat,
               launches=launches, **med,
               k3_share=med["rollouts_ms"] / med["step_ms"],
               steps_per_s=1e3 / med["step_ms"], trials=times)
    if problems:
        fail("SCST step: " + "; ".join(problems) + " | " + json.dumps(out))
    return ds, out


def phase_cli_train(ds):
    """``train --preset scst_cider --stages xe,scst --steps 3,3`` on phase
    9's dataset written as the preset's msrvtt files (vocab 12,000 → Vp
    12,032), then ``--resume --steps 3,4``: 3 XE rows, then 3 SCST rows,
    all finite; the stage lines report 0 launches during XE and 6 rollout
    launches (2 a step) during SCST, W_out resident; stage.json reads scst;
    the resume runs exactly one more SCST step (2 launches)."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [REPO, os.environ.get("PYTHONPATH")]))}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        np.save(os.path.join(data, "msrvtt_train_feats.npy"), ds.features)
        with open(os.path.join(data, "msrvtt_train_ids.json"), "w") as f:
            json.dump(ds.video_ids, f)
        with open(os.path.join(data, "msrvtt_captions.json"), "w") as f:
            json.dump(ds.video_captions, f)
        ds.vocab.save(os.path.join(data, "msrvtt_vocab.json"))
        line = re.compile(r"\[vidcap\] (\w+): (\d+) steps on (\S+?)"
                          r"(?:; rollout W_out (\w+))?; kernel launches "
                          r"(\{.*\})")
        for steps, resume, want in (
                ("3,3", [], [("xe", 3, 0), ("scst", 3, 6)]),
                ("3,4", ["--resume"], [("xe", 0, 0), ("scst", 1, 2)])):
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "vidcap_tpu_torch", "train",
                 "--preset", "scst_cider", "--stages", "xe,scst", "--steps",
                 steps, "--eval-every", "0", "--log-every", "1",
                 "--set", f"data.data_dir={data}", "--log-file", "log.jsonl",
                 *resume], cwd=tmp, env=env, capture_output=True, text=True,
                timeout=600)
            wall = time.perf_counter() - t0
            if r.returncode != 0:
                fail(f"CLI train {steps} {resume} exited {r.returncode}: "
                     f"{r.stderr[-3000:]}")
            got = [(st, int(n), mode or None, json.loads(lc))
                   for st, n, _, mode, lc in line.findall(r.stderr)]
            # (stage, steps, K3's W_out mode, launches) for each stage line
            ok = got == [(st, n, "resident" if st == "scst" and n else None,
                          {"beam_core": 0, "topk_project": 0, "rollout": k3})
                         for st, n, k3 in want]
            if not ok:
                fail(f"CLI train {steps} {resume}: stage lines {got}, want "
                     f"{want}: {r.stderr[-3000:]}")
            out[f"steps {steps}{' resume' if resume else ''}"] = dict(
                stages=got, wall_s=wall)
        with open(os.path.join(tmp, "log.jsonl")) as f:
            rows = [json.loads(x) for x in f]
        kinds = ["xe" if "xe_loss" in r else "scst" if "pg_loss" in r
                 else "?" for r in rows]
        finite = all(np.isfinite(v) for r in rows for v in r.values()
                     if isinstance(v, float))
        with open(os.path.join(tmp, "checkpoints", "stage.json")) as f:
            stages = json.load(f)
        if [r["step"] for r in rows] != list(range(1, 8)) or kinds != \
                ["xe"] * 3 + ["scst"] * 4 or not finite:
            fail(f"CLI train: log rows {[(r['step'], k) for r, k in zip(rows, kinds)]}"
                 f", finite {finite}")
        if stages.get("7") != "scst" or stages.get("6") != "scst":
            fail(f"CLI train: stage.json {stages}")
        out["rows"] = [{k: r[k] for k in ("step", "loss", "grad_norm")
                        if k in r} for r in rows]
        out["stage_json"] = stages
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the "
              "GPU only", file=sys.stderr)
        return 2
    # the plain versions' f32 products run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"phase 1 card: {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} | kernels "
          f"built in {build_s:.1f} s", flush=True)

    k1 = phase_k1()
    print(f"phase 2 K1 beam_core B={B} K={K} T={T} E=H=A={H}: " + json.dumps(
        {**{k: k1[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                               "bound_ms", "bound_by")},
         "tolerance": K1_TOL}), flush=True)
    k2, exact_rows = phase_k2()
    print(f"phase 3 K2 topk_project N={B * K} H={H} Vp={VP}: " + json.dumps(
        {**{k: k2[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                               "bound_ms", "bound_by")},
         "tolerance": "one bf16 ulp of the row's largest |logit| + 1e-4",
         "exact_rows": exact_rows}), flush=True)

    e2e = phase_end_to_end()
    print(f"phase 4 end to end msrvtt_attn_beam5 B={B} beam {K} on {card}: "
          + json.dumps(e2e), flush=True)

    cli = phase_cli()
    print("phase 5 CLI caption --preset msrvtt_attn_beam5: " + json.dumps(cli),
          flush=True)

    k3, k3_out = phase_k3()
    print(f"phase 6 K3 rollout B={BG} T={T} E=H=A={H} Vp={VG} L={L}: "
          + json.dumps({**k3_out, "tolerance": f"{K3_LOGIT_TOL} / "
                        "temperature (logit units)"}), flush=True)
    roll = phase_rollout_end_to_end()
    print(f"phase 7 end to end greedy msvd_greedy / sample scst_cider B={BG} "
          f"on {card}: " + json.dumps(roll), flush=True)
    print("phase 8 CLI caption --preset msvd_greedy, sample --preset "
          "scst_cider: " + json.dumps(phase_cli_rollout()), flush=True)
    row_floor = min(k3_out["identical_rows_plain_cpu_vs_card_by_run"]
                    .values()) - ROW_SLACK
    ds, scst = phase_scst(row_floor)
    print(f"phase 9 SCST step scst_cider B={BG} Vp={VG} L={L} on {card}: "
          + json.dumps({**scst, "tolerance": {
              "loss_pieces_and_rewards": SCST_TOL, "repeat": REPEAT_TOL,
              "logp_vs_rescore": f"{K3_LOGIT_TOL} / temperature"}}),
          flush=True)
    print("phase 10 CLI train --preset scst_cider --stages xe,scst: "
          + json.dumps(phase_cli_train(ds)), flush=True)

    # max_abs_err is the max |err| against the plain version (K3: of the
    # log-probs along the kernel's tokens), ms the kernel's time; bound_ms
    # alone is computed, not measured. K3's launches are those of its main
    # paths: phase 7's greedy and sampled decodes and phase 9's SCST steps.
    k3["launches"] = (sum(r["launches"]["rollout"] for r in roll.values())
                      + scst["launches"]["rollout"])
    print(json.dumps({"kernels": [dict(k, launches=e2e["launches"][k["name"]])
                                  for k in (k1, k2)] + [k3]}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
