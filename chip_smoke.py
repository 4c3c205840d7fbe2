#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``vidcap_tpu_torch``).

    python3 chip_smoke.py      # from the root of a checkout; one NVIDIA GPU

Builds the Hopper kernels from ``vidcap_tpu_torch/csrc`` with nvcc, holds
each against its plain PyTorch version at the shapes of the main path,
drives the main path (beam-5 captioning under preset ``msrvtt_attn_beam5``,
vocab 16,000, 184 videos of synthetic features, seeded random weights)
through ``Captioner`` and the ``caption`` CLI, and shows with the launch
counts that the decode went through both kernels. Phases:

  1 card, versions, kernel build    4 end to end: Captioner, kernels vs plain
  2 K1 beam_core vs plain           5 CLI: python -m vidcap_tpu_torch caption
  3 K2 topk_project vs plain        6 the kernels line (one JSON object)

Any failed check exits non-zero. The last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``. Without a CUDA device
it exits 2 and prints no result. Imports torch and numpy, never JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from vidcap_tpu_torch.config import get_preset
from vidcap_tpu_torch.convert import save_weights
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.data.vocab import SPECIALS, Vocab
from vidcap_tpu_torch.inference import Captioner
from vidcap_tpu_torch.models.decoder import DecoderState
from vidcap_tpu_torch.models.decoding import (beam_decode, fused_beam_step,
                                              tile_recurrent)
from vidcap_tpu_torch.models.model import create_model, init_params
from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.ops.beam_core import beam_core, beam_core_plain
from vidcap_tpu_torch.ops.topk_project import topk_project, topk_project_plain

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
    words = SPECIALS + [f"w{i}" for i in range(VP - len(SPECIALS))]
    vocab = Vocab({w: i for i, w in enumerate(words)}, words)
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
    for name, n in launches.items():
        if n != steps:
            fail(f"main path: {name} launched {n} times for {steps} steps")
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


def phase_cli():
    cfg = get_preset("msrvtt_attn_beam5")
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "W.npz")
        save_weights(init_params(create_model(cfg, VP), cfg.train.seed),
                     weights)
        caps = os.path.join(tmp, "caps.json")
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            filter(None, [REPO, os.environ.get("PYTHONPATH")]))}
        r = subprocess.run(
            [sys.executable, "-m", "vidcap_tpu_torch", "caption", "--preset",
             "msrvtt_attn_beam5", "--weights", weights, "--out", caps],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            fail(f"CLI exited {r.returncode}: {r.stderr[-2000:]}")
        with open(caps) as fh:
            results = json.load(fh)
    if not results or not all(isinstance(c, list) and len(c) == 1 and c[0]
                              for c in results.values()):
        fail("CLI: every video needs one non-empty caption")
    line = [ln for ln in r.stderr.splitlines() if "kernel launches" in ln]
    if not line:
        fail(f"CLI printed no launch counts: {r.stderr[-2000:]}")
    steps = int(line[-1].split("] ")[1].split(" beam steps")[0])
    launches = json.loads(line[-1].split("kernel launches ")[1])
    if steps < 1 or any(n != steps for n in launches.values()):
        fail(f"CLI: {steps} steps but launches {launches}")
    return dict(videos=len(results), steps=steps, launches=launches)


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

    # max_abs_err is the max |err| against the plain version, ms the
    # kernel's time; bound_ms alone is computed, not measured
    print(json.dumps({"kernels": [dict(k, launches=e2e["launches"][k["name"]])
                                  for k in (k1, k2)]}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
