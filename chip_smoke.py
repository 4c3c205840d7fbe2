#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``vidcap_tpu_torch``).

    python3 chip_smoke.py      # from the root of a checkout; one NVIDIA GPU

Builds the Hopper kernels from ``vidcap_tpu_torch/csrc`` with nvcc, holds
each against its plain PyTorch version at the shapes of its path, and drives
the port's three paths with seeded random weights, showing with the launch
counts that each went through its kernels: beam-5 captioning under preset
``msrvtt_attn_beam5`` (vocab 16,000, 184 videos of synthetic features)
through K1 and K2; greedy (``msvd_greedy``) and sampled (``scst_cider``)
captioning (vocab 12,000, 32 videos) through K3; the staged XE → SCST
training of ``scst_cider`` (B=32, vocab 12,000), whose SCST step runs its
sampled and greedy rollouts on K3 and whose validation decodes on K3; and
the offline path at ``msrvtt_attn_beam5``'s width (``prepare`` → ``train``
with validation through K1 and K2 and a best checkpoint → ``caption
--checkpoint-dir best/ --inputs`` → ``eval``); serving (``serve`` over stdin
and HTTP, beam through K1/K2 and greedy through K3) and export (``export``,
``caption``/``serve --from-export``); the trainer's dispatch (every step a
CUDA graph, the feature bank, K steps a dispatch); end to end from pixels
(the IRv2 backbone at full width inside the ``e2e_scst_multitask`` and
``e2e_irv2`` steps, whose SCST rollouts run on K3, the CLI on frame files,
the video encoder); the rest of the decode surface (K2's int8 variant, the
int8 and finished-pool beams through K1 with K2-int8 or K2 at K+1, the
decoders no kernel covers through their modules, ``info``). Phases:

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
                                   10 CLI: train --stages xe,scst
                                      --eval-every 3 (validation on K3),
                                      --resume
                                   11 the offline path at msrvtt_attn_beam5
                                      width: prepare, train with validation
                                      on K1/K2, caption --checkpoint-dir
                                      best/ --inputs, eval
                                   12 serve: stdin and HTTP (beam, K1/K2),
                                      stdin greedy (K3), each caption equal
                                      to the in-process decode
                                   13 export (beam B=32, greedy
                                      polymorphic), caption --from-export
                                      (split, --inputs), serve --from-export
                                      equal to the live decodes; refusals
                                   14 the trainer's dispatch at scst_cider
                                      width, 6,513-video bank: captured ==
                                      eager, step times, the CLI end state
                                      and a resume across K
                                   15 end to end from pixels: preprocess
                                      and the full-width backbone vs the
                                      CPU, the composed step at B=8
                                      (captured == eager, one encode and
                                      2 K3 launches a step, times, memory),
                                      two e2e steps, the CLI train /
                                      resume / caption on frame files,
                                      encode_video
                                   16 the rest of the decode surface:
                                      K2-int8 vs plain at N=920 (H=512,
                                      K=5 and 6; H=1024), the int8
                                      and pool beams at B=184 (launches,
                                      rows vs the CPU, captions/s), the
                                      decoders no kernel covers (2 layers,
                                      no attention, f32) at B=32, a
                                      two-layer SCST step captured ==
                                      eager, the CLI (info, int8 and pool
                                      captions, an int8 export)
                                   17 more than one GPU at a world of one
                                      over NCCL: the sharded XE (banked)
                                      and SCST steps captured against one
                                      card, the sharded beam B=184 and
                                      greedy B=32 decodes, dropout in the
                                      captured XE step, the shapes the
                                      kernels refuse (beam 9, pool beam 8,
                                      hidden 1024: K1 refuses it, K2
                                      streams its rows) and the int8 beam
                                      at hidden 1024 (K1 and K2-int8 once
                                      a step) at B=184
                                   18 the SCST lift (synthetic_tiny, 40
                                      XE and 300 SCST captured steps, K3
                                      2 a SCST step): held-out val CIDEr
                                      up by more than 0.1
                                   19 K2 at Kimi-VL-A3B's head: N=5120,
                                      H=2048 (rows streamed), Vp=163,840,
                                      K=5 vs plain, times
                                   20 K4 teacher_forced at scst_cider's
                                      shape (B=32, T=26, L=30, Vp=12,032):
                                      forward and backward vs plain, the
                                      times of each against the plain
                                      version, the module loop and the
                                      bound
                                   21 K5 moe at Kimi-VL-A3B's experts
                                      (k 6 of 64, H 2,048, I 1,408) on
                                      5,120 and 26,624 rows: dispatch,
                                      silu_mul and combine vs plain, their
                                      times and byte bounds; one expert
                                      layer on K5 and on the plain path
                                   22 Kimi-VL-A3B's decoder cut to 4
                                      layers, beam 5 of 1,024 videos
                                      through Captioner: K5's launches a
                                      layer and step, the route's list;
                                      the decode with K5 off
  then the kernels line (one JSON object)

``python3 chip_smoke.py --k2-wide`` runs phases 1 and 19 alone,
``python3 chip_smoke.py --k4`` phases 1 and 20, ``--k5`` phases 1, 21
and 22. Phases 9, 10, 14, 15 and 18 also count K4's launches in their
training steps: 2 an XE step (forward, backward), 4 a SCST step (the
re-score and the XE anchor).

Phase 1 also requires the native host library (``vidcap_tpu_torch/
native.py``, built with g++), and phase 14 tables counted by it. Any
failed check exits non-zero. The last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``. Without a CUDA device
it exits 2 and prints no result. Imports torch and numpy, never JAX.
"""
from __future__ import annotations

import atexit
import copy
import dataclasses
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

from vidcap_tpu_torch import native
from vidcap_tpu_torch.config import get_preset
from vidcap_tpu_torch.convert import save_weights
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.data.vocab import BOS, EOS, PAD, SPECIALS, Vocab
from vidcap_tpu_torch.inference import Captioner
from vidcap_tpu_torch.models.decoder import NEG, DecoderState
from vidcap_tpu_torch.models import decoding
from vidcap_tpu_torch.models.decoding import (KernelWeights, Route,
                                              beam_decode, beam_decode_pool,
                                              fused_beam_step,
                                              module_beam_step,
                                              tile_recurrent)
from vidcap_tpu_torch.models.model import create_model, init_params
from vidcap_tpu_torch.objectives.xe import shift_right, token_logp
from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.ops.beam_core import beam_core, beam_core_plain
from vidcap_tpu_torch.ops.int8_proj import (Int8Projection,
                                            int8_logits_plain,
                                            int8_topk_project_plain,
                                            quantize_rows, topk_project_int8)
from vidcap_tpu_torch.ops.rollout import (replay_plain, rollout,
                                          rollout_plain, step_plain)
from vidcap_tpu_torch.ops.teacher_forced import (teacher_forced,
                                                 teacher_forced_plain)
from vidcap_tpu_torch.ops.topk_project import topk_project, topk_project_plain
from vidcap_tpu_torch.data.pipeline import DeterministicBatcher
from vidcap_tpu_torch.models.decoding import Rollout
from vidcap_tpu_torch.objectives.reward_tables import tables_from_dataset
from vidcap_tpu_torch.train.loop import batch_to_device, batch_to_device_dict
from vidcap_tpu_torch.train.scst import make_scst_step_body
from vidcap_tpu_torch.train.state import (create_train_state,
                                          optax_global_norm)
from vidcap_tpu_torch.utils.meminfo import param_census
from vidcap_tpu_torch.train.steps import (_build_banks, apply_loss,
                                          draw_seeds, make_banked_multistep,
                                          make_banked_step, make_step,
                                          make_xe_step_body)

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
# K4 vs plain at scst_cider's shape (tests/test_torch_cuda.py says why):
# the logits within two bf16 ulps of the largest |logit|, the loss within
# TF_LOSS_TOL relative, each leaf's gradient within TF_GRAD_TOL (L2,
# relative); about 3x the largest errors measured on the card (PERF.md)
TF_LOSS_TOL, TF_GRAD_TOL = 1e-5, 0.01
PEAK_F32 = 67e12   # H100 SXM f32 FLOP/s off the tensor cores (data sheet)
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


def counts(**launched) -> dict:
    """Every kernel's launch count: ``launched``'s, 0 for the others."""
    return {k: launched.get(k, 0) for k in _build.KERNELS}


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def plain_beam_step(w, k, n=None):
    """``fused_beam_step`` with the plain versions (K1's, then K2's or
    K2-int8's with ``n`` candidates a row, default ``k``), for the
    comparison."""
    n = n or k

    def step(st, tok):
        h, c = beam_core_plain(w.embedding[tok], st.h[0], st.c[0], st.keys,
                               st.values, st.frame_mask, w.wq, w.u, w.wg,
                               w.bg, k)
        p = w.proj
        logp, idx = (int8_topk_project_plain(h, p.int8, n) if p.int8
                     else topk_project_plain(h, p.w_out, p.b_out, n,
                                             p.vocab_size))
        return (DecoderState(h[None], c[None], st.keys, st.values,
                             st.frame_mask), logp, idx)
    return step


def beam_weights(cap):
    """K1's weights of ``cap``'s last beam decode, with its projection."""
    p = cap._vocab_proj
    return cap._weights.beam(Route("beam_core", p.kernel, p.int8 is not None,
                                   None))


def moved(x, device):
    """``x`` with every tensor in it (a dataclass's fields, nested ones too)
    on ``device``."""
    if torch.is_tensor(x):
        return x.to(device)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: moved(getattr(x, f.name),
                                                       device)
                                         for f in dataclasses.fields(x)})
    return x


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


def phase_k2_wide():
    """K2 at Kimi-VL-A3B's head, the beam-5 step of 1,024 videos: h
    f32[5120, 2048] (past 512 the rows stream through the ring beside
    W_out), W_out bf16[2048, 163840], K=5, against the plain version."""
    g = torch.Generator(device="cuda").manual_seed(19)
    n, hid, vp, k = 5120, 2048, 163_840, 5
    h = torch.randn(n, hid, generator=g, device="cuda")
    w = (torch.randn(hid, vp, generator=g, device="cuda") * 0.02).bfloat16()
    b = torch.zeros(vp, device="cuda")
    err, exact = check_topk(h, w, b, k, vp)
    b_ms, b_by = bound(n * hid * 4 + hid * vp * 2 + vp * 4 + n * k * 8,
                       2 * n * hid * vp)
    h16 = h.bfloat16()
    return dict(max_abs_err=err, exact_rows=exact,
                ms=time_ms(lambda: topk_project(h, w, b, k, vp), iters=5),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(lambda: torch.matmul(h16, w), iters=5),
                plain_ms=time_ms(lambda: topk_project_plain(h, w, b, k, vp),
                                 iters=1, reps=3))


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
    if launches != counts(beam_core=steps, topk_project=steps):
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
                **paths), cap, trials


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
    w = beam_weights(cap)
    kstep, pstep = fused_beam_step(w, K), plain_beam_step(w, K)
    cstep = plain_beam_step(moved(w, "cpu"), K)
    worst = {"h_c": 0.0, "logp": 0.0}

    def checked_step(st, tok):
        st_k, lk, ik = kstep(st, tok)
        st_p, _, _ = pstep(st, tok)
        worst["h_c"] = max(worst["h_c"], (st_k.h - st_p.h).abs().max().item(),
                           (st_k.c - st_p.c).abs().max().item())
        e, _ = check_topk(st_k.h[0], w.proj.w_out, w.proj.b_out, K,
                          w.proj.vocab_size,
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
    if method != "beam" or steps < 1 or launches != counts(
            beam_core=steps, topk_project=steps):
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
    w = KernelWeights(model.decoder).rollout()
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
        if launches != counts(rollout=decodes) or decodes != 3:
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
                    decodes < 1 or steps != decodes * L or launches != \
                    counts(rollout=decodes) or mode != "resident":
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
        toks, _, _ = rollout_plain(KernelWeights(model.decoder).rollout(),
                                   st.keys, st.values, st.frame_mask,
                                   st.h[0], st.c[0], L)
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
        w = KernelWeights(model.decoder).rollout()
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
    loss, m = step.loss(state.model, sub, s, gr, rewards,
                        feats=state.model.encode_features(sub["features"]))
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
    if one_step != counts(rollout=2):
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
        state, mi = apply_loss(state, *step.loss(
            state.model, b, s, gr, rewards,
            feats=state.model.encode_features(b["features"])))
        ev[3].record()
        torch.cuda.synchronize()
        if i:
            times["step_ms"].append((time.perf_counter() - t0) * 1e3)
            for k, (a, z) in zip(list(times)[1:], ((0, 1), (1, 2), (2, 3))):
                times[k].append(ev[a].elapsed_time(ev[z]))
        if not all(torch.isfinite(v) for v in mi.values()):
            problems.append(f"step {i}: non-finite metrics")
    launches = dict(_build.launch_counts)
    if launches != counts(rollout=2 * (1 + SCST_STEPS),
                          teacher_forced=4 * (1 + SCST_STEPS)):
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
    """``train --preset scst_cider --stages xe,scst --steps 3,3
    --eval-every 3`` on phase 9's dataset written as the preset's msrvtt
    files (vocab 12,000 → Vp 12,032; no val split, so validation greedy-
    decodes the 64 train videos, 2 K3 launches of 32 rows), then ``--resume
    --steps 3,4``: 3 XE rows, then 3 SCST rows, all finite, and eval rows at
    steps 3 and 6 flagged as the train-subset fallback; the stage lines
    report 2 rollout launches during XE (validation) and 8 during SCST (2 a
    step and validation), W_out resident; best/ holds one checkpoint;
    stage.json reads scst; the resume runs exactly one more SCST step (2
    launches) and no validation."""
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
                ("3,3", [], [("xe", 3, 2, 6), ("scst", 3, 8, 12)]),
                ("3,4", ["--resume"], [("xe", 0, 0, 0),
                                       ("scst", 1, 2, 4)])):
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "vidcap_tpu_torch", "train",
                 "--preset", "scst_cider", "--stages", "xe,scst", "--steps",
                 steps, "--eval-every", "3", "--log-every", "1",
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
                          counts(rollout=k3, teacher_forced=k4))
                         for st, n, k3, k4 in want]
            if not ok:
                fail(f"CLI train {steps} {resume}: stage lines {got}, want "
                     f"{want}: {r.stderr[-3000:]}")
            out[f"steps {steps}{' resume' if resume else ''}"] = dict(
                stages=got, wall_s=wall)
        with open(os.path.join(tmp, "log.jsonl")) as f:
            rows = [json.loads(x) for x in f]
        evals = [r for r in rows if "eval_CIDEr" in r]
        rows = [r for r in rows if "eval_CIDEr" not in r]
        kinds = ["xe" if "xe_loss" in r else "scst" if "pg_loss" in r
                 else "?" for r in rows]
        finite = all(np.isfinite(v) for r in rows + evals
                     for v in r.values() if isinstance(v, float))
        with open(os.path.join(tmp, "checkpoints", "stage.json")) as f:
            stages = json.load(f)
        if [r["step"] for r in rows] != list(range(1, 8)) or kinds != \
                ["xe"] * 3 + ["scst"] * 4 or not finite:
            fail(f"CLI train: log rows {[(r['step'], k) for r, k in zip(rows, kinds)]}"
                 f", finite {finite}")
        best = [f for f in os.listdir(os.path.join(tmp, "checkpoints",
                                                   "best"))
                if f.startswith("ckpt_")]
        if [r["step"] for r in evals] != [3, 6] or len(best) != 1 or not all(
                r.get("eval_on_train_fallback") == 1.0 for r in evals):
            fail(f"CLI train: eval rows {evals}, best/ {best}")
        out["eval_rows"] = evals
        # K3 launches of validation: those of the stage lines less the SCST
        # steps' two a step
        out["validation_rollout_launches"] = sum(
            lc["rollout"] - (2 * n if st == "scst" else 0)
            for run in out.values() if isinstance(run, dict)
            for st, n, _, lc in run.get("stages", []))
        if stages.get("7") != "scst" or stages.get("6") != "scst":
            fail(f"CLI train: stage.json {stages}")
        out["rows"] = [{k: r[k] for k in ("step", "loss", "grad_norm")
                        if k in r} for r in rows]
        out["stage_json"] = stages
    return out


# Phase 11: the offline path at msrvtt_attn_beam5's width. 300 MSR-VTT
# videos (train 200, val 50, test 50) of 20 captions each; every word of a
# 16,000-word made-up pool twice or more in train, so that the vocab (capped
# at the preset's 16,000 with the specials) gives Vp = 16,000 as in phase 4.
OFF_SPLITS = (("train", 200), ("validate", 50), ("test", 50))
OFF_CAPTIONS, OFF_WORDS, OFF_POOL = 20, 12, 16_000


def made_up_words(n: int):
    """n distinct lower-case letter strings ('qa', 'qb', ...)."""
    out = []
    for i in range(n):
        w = ""
        while True:
            w = chr(97 + i % 26) + w
            i //= 26
            if not i:
                break
        out.append("q" + w)
    return out


def offline_annotations(g):
    """MSR-VTT videodatainfo json: the train captions hold every pool word
    twice (shuffled), the rest of their words and the other splits' draw
    from the pool."""
    pool = np.array(made_up_words(OFF_POOL))
    n_train = OFF_SPLITS[0][1] * OFF_CAPTIONS
    slots = np.concatenate([np.repeat(np.arange(OFF_POOL), 2),
                            g.integers(0, OFF_POOL,
                                       n_train * OFF_WORDS - 2 * OFF_POOL)])
    train_words = pool[g.permutation(slots)].reshape(n_train, OFF_WORDS)
    videos, sentences, k = [], [], 0
    for split, n in OFF_SPLITS:
        for _ in range(n):
            vid = f"video{len(videos)}"
            videos.append({"video_id": vid, "split": split})
            for _ in range(OFF_CAPTIONS):
                if split == "train":
                    words = train_words[k]
                    k += 1
                else:
                    words = pool[g.integers(0, OFF_POOL,
                                            int(g.integers(6, 16)))]
                sentences.append({"video_id": vid,
                                  "caption": " ".join(words)})
    return {"videos": videos, "sentences": sentences}


def run_port(args, cwd: str, what: str, phase: int = 11):
    """``python -m vidcap_tpu_torch <args>`` in ``cwd``: (completed process,
    wall seconds); fails the phase on a nonzero exit."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [REPO, os.environ.get("PYTHONPATH")]))}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "vidcap_tpu_torch", *args],
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        fail(f"phase {phase} {what} exited {r.returncode}: "
             f"{r.stderr[-3000:]}")
    return r, time.perf_counter() - t0


def phase_offline(row_floor: float):
    """prepare → train with validation on K1/K2 → caption --checkpoint-dir
    best/ --inputs → eval, through the CLI at msrvtt_attn_beam5's width
    (E=H=A=512, D=1536, T=26, train B=64, beam 5, Vp=16,000), with seeded
    data and a seeded init:
    (1) the annotations; (2) ``prepare``, then N(0,1) features for the three
    splits; (3) ``train --stages xe --steps 4 --eval-every 2 --set
    train.eval_method=beam``: eval rows at steps 2 and 4 from the val split
    (no fallback flag), one checkpoint under best/, K1 and K2 launched (as
    many K1 as K2) and no K3; (4) ``caption --inputs`` of 50 .npy files of
    1-40 frames (the test videos): 50 keys, equal to an in-process decode of
    the same padded batch through K1/K2 on the card, and the kernel rows
    equal to the plain path's on at least ``row_floor`` of them (phase 4's
    floor), four in-process decodes the same; (5) ``eval --refs`` and ``eval --split test``: the 7 scores
    finite, the same from both, equal to the in-process evaluate_captions
    within 1e-9. Times: the XE step (log rows of steps 2 and 4, whose
    intervals hold no validation), each validation, the CLI calls, and the
    captions/s of the --inputs loading and decode in process: cold (the
    first, as the CLI pays it) and warm (the median of three more)."""
    from vidcap_tpu_torch.metrics.evaluate import evaluate_captions
    from vidcap_tpu_torch.serving import _FeatureLoader, _pad_batch
    cfg = get_preset("msrvtt_attn_beam5")
    g = np.random.default_rng(11)
    out, walls = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        ann = os.path.join(tmp, "videodatainfo.json")
        with open(ann, "w") as f:
            json.dump(offline_annotations(g), f)
        common = ["--preset", "msrvtt_attn_beam5", "--set",
                  f"data.data_dir={data}"]
        _, walls["prepare_s"] = run_port(["prepare", *common, ann], tmp,
                                         "prepare")
        vocab = Vocab.load(os.path.join(data, "msrvtt_vocab.json"))
        if vocab.size != VP:
            fail(f"phase 11: prepared vocab {vocab.size}, want {VP}")
        ids = {}
        for split in ("train", "val", "test"):
            with open(os.path.join(data, f"msrvtt_{split}_ids.json")) as f:
                ids[split] = json.load(f)
            np.save(os.path.join(data, f"msrvtt_{split}_feats.npy"),
                    g.normal(size=(len(ids[split]), T, D))
                    .astype(np.float32))

        # ---- train with validation through K1/K2
        r, walls["train_s"] = run_port(
            ["train", *common, "--stages", "xe", "--steps", "4",
             "--eval-every", "2", "--log-every", "1", "--set",
             "train.eval_method=beam", "--log-file", "log.jsonl"], tmp,
            "train")
        stage = re.findall(r"\[vidcap\] xe: 4 steps on cuda\S*; kernel "
                           r"launches (\{.*\})", r.stderr)
        train_launches = json.loads(stage[-1]) if stage else None
        with open(os.path.join(tmp, "log.jsonl")) as f:
            rows = [json.loads(x) for x in f]
        evals = {x["step"]: x for x in rows if "eval_CIDEr" in x}
        steps = {x["step"]: x for x in rows if "xe_loss" in x}
        best_dir = os.path.join(tmp, "checkpoints", "best")
        best = sorted(f for f in os.listdir(best_dir)
                      if f.startswith("ckpt_"))
        if not train_launches or train_launches["rollout"] != 0 or \
                not train_launches["beam_core"] > 0 or \
                train_launches["beam_core"] != \
                train_launches["topk_project"]:
            fail(f"phase 11 train: stage line launches {train_launches}: "
                 f"{r.stderr[-2000:]}")
        if sorted(evals) != [2, 4] or any(
                "eval_on_train_fallback" in x for x in evals.values()) or \
                "TRAIN subset" in r.stderr or len(best) != 1 or \
                sorted(steps) != [1, 2, 3, 4] or not all(
                np.isfinite(v) for x in rows for v in x.values()
                if isinstance(v, float)):
            fail(f"phase 11 train: eval rows {evals}, best/ {best}, rows "
                 f"{sorted(steps)}: {r.stderr[-2000:]}")

        # ---- caption --inputs from best/ through K1/K2
        inputs = os.path.join(tmp, "inputs")
        os.makedirs(inputs)
        frames = g.integers(1, 41, len(ids["test"]))
        for v, n in zip(ids["test"], frames):
            np.save(os.path.join(inputs, f"{v}.npy"),
                    g.normal(size=(int(n), D)).astype(np.float32))
        r, walls["caption_inputs_s"] = run_port(
            ["caption", *common, "--checkpoint-dir", best_dir, "--inputs",
             inputs, "--out", "caps.json"], tmp, "caption --inputs")
        line = re.findall(r"\] beam: (\d+) decodes, (\d+) steps on cuda\S*; "
                          r"kernel launches (\{.*\})", r.stderr)
        with open(os.path.join(tmp, "caps.json")) as f:
            caps = json.load(f)
        if not line or sorted(caps) != sorted(ids["test"]):
            fail(f"phase 11 caption --inputs: {len(caps)} keys, line "
                 f"{line}: {r.stderr[-2000:]}")
        caption_launches = json.loads(line[-1][2])
        if caption_launches != counts(beam_core=int(line[-1][1]),
                                      topk_project=int(line[-1][1])):
            fail(f"phase 11 caption --inputs launches {caption_launches}")

        # the same padded batch in process: through K1/K2, and plain
        holder = CaptionDataset(np.zeros((1, T, D), np.float32), ["x"],
                                {"x": []}, cfg.data, vocab=vocab)
        cap = Captioner.from_checkpoint(cfg, holder, checkpoint_dir=best_dir)
        paths = sorted(os.path.join(inputs, f) for f in os.listdir(inputs))
        loader = _FeatureLoader(cfg)
        decode_s = []
        for i in range(4):        # the first as the CLI runs it: cold
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch, mask = _pad_batch(cfg, [loader(p) for p in paths],
                                     min(len(paths), cfg.train.batch_size))
            got = cap.decode_batch(batch, frame_mask=mask, beam_width=K)
            decode_s.append(time.perf_counter() - t0)
            if i and not np.array_equal(got, toks):
                fail("phase 11: two decodes of the --inputs batch differ")
            toks = got
        mine = {os.path.splitext(os.path.basename(p))[0]:
                [vocab.decode_str(row)] for p, row in zip(paths, toks)}
        if mine != caps:
            fail("phase 11: caption --inputs differs from the in-process "
                 "K1/K2 decode of the same batch")
        with torch.inference_mode():
            f_, m_ = (torch.tensor(a, device="cuda") for a in (batch, mask))
            st = tile_recurrent(cap.model.init_state(f_, m_), K)
            plain, _ = beam_decode(plain_beam_step(beam_weights(cap), K), st,
                                   batch=len(paths),
                                   max_len=cfg.decode.max_len, beam_width=K,
                                   early_exit=cfg.decode.early_exit)
        same = float(np.mean((plain.cpu().numpy() == toks).all(1)))
        if same < row_floor:
            fail(f"phase 11: {same} of the caption --inputs rows identical "
                 f"to the plain path, below phase 4's floor {row_floor}")

        # ---- eval, against --refs and against the test split
        with open(os.path.join(data, "msrvtt_captions.json")) as f:
            refs = {v: c for v, c in json.load(f).items() if v in caps}
        with open(os.path.join(tmp, "refs.json"), "w") as f:
            json.dump(refs, f)
        want = evaluate_captions(refs, caps)
        scores = {}
        for name, extra in (("refs", ["--refs", "refs.json"]),
                            ("split", [*common, "--split", "test"])):
            r, walls[f"eval_{name}_s"] = run_port(
                ["eval", "--captions", "caps.json", *extra], tmp, "eval")
            scores[name] = json.loads(r.stdout)
            if set(scores[name]) != set(want) or not all(
                    np.isfinite(v) and abs(v - want[k]) <= 1e-9
                    for k, v in scores[name].items()):
                fail(f"phase 11 eval {name}: {scores[name]}, in process "
                     f"{want}")
    xe_ms = [1e3 / steps[i]["steps_per_sec"] for i in (2, 4)]
    out.update(
        vocab=vocab.size, videos={s: len(v) for s, v in ids.items()},
        train_launches=train_launches, caption_launches=caption_launches,
        xe_step_ms=float(np.median(xe_ms)), xe_step_ms_steps_2_4=xe_ms,
        validation_s={k: x["val_seconds"] for k, x in evals.items()},
        eval_rows={k: {m: v for m, v in x.items() if m.startswith("eval_")}
                   for k, x in evals.items()},
        best=best[0], inputs_frames=[int(n) for n in frames],
        inputs_decode_captions_per_s_cold=len(paths) / decode_s[0],
        inputs_decode_captions_per_s=len(paths)
        / float(np.median(decode_s[1:])),
        caption_inputs_cli_captions_per_s=len(paths)
        / walls["caption_inputs_s"],
        identical_rows_vs_plain=same, identical_rows_floor=row_floor,
        scores=scores["refs"], cli_wall_s=walls)
    return out


# Phases 12-13: serving and export through the CLI, at msrvtt_attn_beam5's
# width (beam 5, Vp=16,000) through K1/K2 and at msvd_greedy's (Vp=12,032)
# through K3, on one set of seeded weights and feature files.
SERVE_FILES, SERVE_B, GREEDY_FILES, HTTP_CLIENTS = 100, 32, 64, 8
# ``python -m vidcap_tpu_torch`` with Python's SIGINT handler installed even
# where this process's parent ignores SIGINT: SIGINT ends ``serve --http``
SERVE_CHILD = ("import runpy, signal; signal.signal(signal.SIGINT, "
               "signal.default_int_handler); runpy.run_module("
               "'vidcap_tpu_torch', run_name='__main__', alter_sys=True)")
LAUNCH_LINE = re.compile(r"\] (\w+): (\d+) decodes, (\d+) steps on [^;]*"
                         r"(?:; rollout W_out (\w+))?; kernel launches "
                         r"(\{.*\})")


def launch_line(err: str, what: str):
    """(method, decodes, steps, launches, K3's W_out mode) of the last
    decodes line a CLI call printed."""
    line = LAUNCH_LINE.findall(err)
    if not line:
        fail(f"{what} printed no launch counts: {err[-2000:]}")
    method, decodes, steps, mode, launches = line[-1]
    return method, int(decodes), int(steps), json.loads(launches), mode


_CHILDREN = []


@atexit.register
def _stop_children():
    for p in _CHILDREN:
        if p.poll() is None:
            p.kill()
            p.wait()


def port_proc(args, cwd, **kw):
    """``python -m vidcap_tpu_torch <args>`` started in ``cwd``; killed at
    exit if it still runs."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [REPO, os.environ.get("PYTHONPATH")]))}
    _CHILDREN.append(subprocess.Popen(
        [sys.executable, "-c", SERVE_CHILD, *args], cwd=cwd, env=env,
        text=True, **kw))
    return _CHILDREN[-1]


class Served:
    """A ``serve`` process: stderr read on a thread (``wait_for`` a line),
    stdout lines timed on another, killed by ``stop`` if still running."""

    def __init__(self, args, cwd, stdin=False):
        import queue
        self.proc = port_proc(args, cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE,
                              stdin=subprocess.PIPE if stdin else None)
        self.err, self.lines = [], queue.Queue()
        self._seen = threading.Condition()
        threading.Thread(target=self._read_err, daemon=True).start()
        threading.Thread(target=self._read_out, daemon=True).start()

    def _read_err(self):
        for line in self.proc.stderr:
            with self._seen:
                self.err.append(line)
                self._seen.notify_all()
        with self._seen:
            self.err.append(None)       # end of stderr
            self._seen.notify_all()

    def _read_out(self):
        for line in self.proc.stdout:
            self.lines.put((time.perf_counter(), line))
        self.lines.put((time.perf_counter(), None))

    def wait_for(self, text: str, timeout: float = 600) -> str:
        with self._seen:
            ok = self._seen.wait_for(lambda: any(
                x is None or text in x for x in self.err), timeout)
            hit = [x for x in self.err if x is not None and text in x]
        if not ok or not hit:
            self.stop()
            fail(f"serve never printed {text!r}: {''.join(self.stderr())}")
        return hit[0]

    def read(self, n: int, what: str, timeout: float = 120):
        """n stdout lines as [(perf_counter, path, caption)]."""
        import queue
        out = []
        for _ in range(n):
            try:
                t, line = self.lines.get(timeout=timeout)
            except queue.Empty:
                line = None
            if line is None:
                self.stop()
                fail(f"{what}: {len(out)} of {n} lines: "
                     f"{''.join(self.stderr())[-3000:]}")
            path, caption = line.rstrip("\n").split("\t")
            out.append((t, path, caption))
        return out

    def stderr(self):
        return [x for x in self.err if x is not None]

    def finish(self, what: str, timeout: float = 120) -> str:
        """Wait for the exit; fail unless it is 0; the whole stderr."""
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = None
        self.stop()
        with self._seen:
            self._seen.wait_for(lambda: self.err and self.err[-1] is None, 30)
        err = "".join(self.stderr())
        if rc != 0:
            fail(f"{what} exited {rc}: {err[-3000:]}")
        return err

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def serving_setup(tmp: str, g):
    """Seeded weights for msrvtt_attn_beam5 (vocab 16,000) and msvd_greedy
    (12,000) saved with save_weights; a data dir whose train splits supply
    those vocabularies and whose msrvtt test split holds 64 videos of N(0,1)
    features; SERVE_FILES .npy files of 1-40 frames (the longer cut to 26,
    the shorter masked)."""
    data = os.path.join(tmp, "data")
    os.makedirs(data)
    out = {"data": data, "inputs": os.path.join(tmp, "inputs")}
    for preset, vocab in (("msrvtt_attn_beam5", VP), ("msvd_greedy", VOCAB_G)):
        cfg = get_preset(preset)
        out[preset] = os.path.join(tmp, f"{preset}.npz")
        save_weights(init_params(create_model(cfg, vocab), cfg.train.seed),
                     out[preset])
        name = cfg.data.dataset
        vocab_of(vocab).save(os.path.join(data, f"{name}_vocab.json"))
        splits = {"train": [f"train{i}" for i in range(2)]}
        if name == "msrvtt":
            splits["test"] = [f"video{i}" for i in range(2 * SERVE_B)]
        for split, ids in splits.items():
            feats = g.normal(size=(len(ids), T, D)).astype(np.float32)
            np.save(os.path.join(data, f"{name}_{split}_feats.npy"), feats)
            with open(os.path.join(data, f"{name}_{split}_ids.json"),
                      "w") as f:
                json.dump(ids, f)
            out[f"{name}_{split}"] = (ids, feats)
        with open(os.path.join(data, f"{name}_captions.json"), "w") as f:
            json.dump({v: [] for ids in splits.values() for v in ids}, f)
    os.makedirs(out["inputs"])
    out["paths"] = []
    for i, n in enumerate(g.integers(1, 41, SERVE_FILES)):
        out["paths"].append(os.path.join(out["inputs"], f"v{i:03d}.npy"))
        np.save(out["paths"][-1], g.normal(size=(int(n), D))
                .astype(np.float32))
    return out


def served_references(setup):
    """The in-process kernel-path decodes the served captions must equal:
    each file decoded in the zero-padded batch of SERVE_B it is served in
    (files in order, SERVE_B at a time), beam through K1/K2 and greedy
    (the first GREEDY_FILES) through K3; the msrvtt test split in batches
    of SERVE_B, unmasked, as ``caption --from-export`` decodes a split."""
    from vidcap_tpu_torch.serving import _FeatureLoader, _pad_batch
    refs = {}
    for preset, method, n in (("msrvtt_attn_beam5", "beam", SERVE_FILES),
                              ("msvd_greedy", "greedy", GREEDY_FILES)):
        cfg = dataclasses.replace(get_preset(preset), data=dataclasses.replace(
            get_preset(preset).data, data_dir=setup["data"]))
        cap = Captioner.from_checkpoint(
            cfg, CaptionDataset.from_files(cfg.data, "train"),
            weights=setup[preset])
        loader, vocab = _FeatureLoader(cfg), cap.dataset.vocab
        paths, got = setup["paths"][:n], {}
        for i in range(0, n, SERVE_B):
            chunk = paths[i:i + SERVE_B]
            batch, mask = _pad_batch(cfg, [loader(p) for p in chunk], SERVE_B)
            toks = cap.decode_batch(batch, method=method, beam_width=K,
                                    frame_mask=mask)
            got.update((p, vocab.decode_str(t)) for p, t in zip(chunk, toks))
        refs[method] = got
        if method == "beam":
            ids, feats = setup["msrvtt_test"]
            refs["split"] = {}
            for i in range(0, len(ids), SERVE_B):
                toks = cap.decode_batch(feats[i:i + SERVE_B], beam_width=K)
                refs["split"].update(
                    (v, [vocab.decode_str(t)])
                    for v, t in zip(ids[i:i + SERVE_B], toks))
    return refs


def http_request(port, method, path, body=None, ctype=None):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=body,
                 headers={"Content-Type": ctype} if ctype else {})
    r = conn.getresponse()
    out = (r.status, json.loads(r.read()))
    conn.close()
    return out


def check_served(method, decodes, steps, launches, want_method, what):
    """The decodes line of a serve or caption call: its method, and its
    launches all on its path's kernels (K1 = K2 = steps, or one K3 launch a
    decode of up to 32 rows: ``decodes`` here), none on the other's."""
    if method != want_method:
        fail(f"{what}: method {method}, want {want_method}")
    want = (counts(beam_core=steps, topk_project=steps)
            if method == "beam" else counts(rollout=decodes))
    if launches != want:
        fail(f"{what}: launches {launches} for {decodes} decodes, {steps} "
             f"steps; want {want}")


def phase_serving(setup, refs, tmp):
    """``serve`` through the CLI on the card, at msrvtt_attn_beam5's width
    (beam 5, B=32): (a) stdin with --max-wait-ms 50 --pipeline-depth 1:
    SERVE_FILES paths written at once after the server's ready line, stdin
    kept open until every line is out, so the partial batch of 4 must flush
    on the deadline; each line equal to the in-process decode, 5 decodes
    (the warmup and four batches), K1 = K2 = steps ≤ 5 × 30, no K3; (b)
    --http 0 --max-wait-ms 20 --path-root: one request alone, then the rest
    of 96 from HTTP_CLIENTS threads (every 8th in JSON path mode), each
    caption equal to the in-process decode of that file, /stats served 96
    and rejected 0, a path outside the root 403, SIGINT ends it; (c)
    msvd_greedy on stdin, GREEDY_FILES files at B=32 through K3: 3 launches
    (the warmup and two batches), W_out resident. Times: captions/s of (a)
    from the first line written to the last read; p50/p99 of (a) and (b)
    from the server and from the client; the lone first request of (b)
    against the median client latency."""
    from concurrent.futures import ThreadPoolExecutor
    beam = ["--preset", "msrvtt_attn_beam5", "--weights",
            setup["msrvtt_attn_beam5"], "--set",
            f"data.data_dir={setup['data']}", "--batch", str(SERVE_B)]
    paths, out = setup["paths"], {}

    # ---- (a) stdin
    srv = Served(["serve", *beam, "--max-wait-ms", "50", "--pipeline-depth",
                  "1"], tmp, stdin=True)
    srv.wait_for("serving stdin")
    t0 = time.perf_counter()
    srv.proc.stdin.write("\n".join(paths) + "\n")
    srv.proc.stdin.flush()
    lines = srv.read(len(paths), "serve stdin")
    srv.proc.stdin.close()
    err = srv.finish("serve stdin")
    if [p for _, p, _ in lines] != paths or any(
            c != refs["beam"][p] for _, p, c in lines):
        fail("serve stdin: lines differ from the in-process decode")
    served = re.findall(r"served (\d+) captions latency p50=(\d+)ms "
                        r"p99=(\d+)ms", err)
    method, decodes, steps, launches, _ = launch_line(err, "serve stdin")
    check_served(method, decodes, steps, launches, "beam", "serve stdin")
    if not served or int(served[-1][0]) != len(paths) or decodes != 5 or \
            steps > 5 * L:
        fail(f"serve stdin: served {served}, {decodes} decodes, {steps} "
             f"steps: {err[-2000:]}")
    lat = np.array([t - t0 for t, _, _ in lines]) * 1e3
    out["stdin"] = dict(
        captions_per_s=len(paths) / (lines[-1][0] - t0),
        server_p50_ms=int(served[-1][1]), server_p99_ms=int(served[-1][2]),
        client_p50_ms=float(np.percentile(lat, 50)),
        client_p99_ms=float(np.percentile(lat, 99)),
        batch_done_ms=[float(lat[i]) for i in range(0, len(paths), SERVE_B)]
        + [float(lat[-1])], decodes=decodes, steps=steps, launches=launches)

    # ---- (b) HTTP
    srv = Served(["serve", *beam, "--max-wait-ms", "20", "--http", "0",
                  "--path-root", setup["inputs"]], tmp)
    line = srv.wait_for("serving HTTP on")
    port = int(re.search(r"serving HTTP on [\d.]+:(\d+)", line).group(1))
    http_paths = paths[:96]

    def ask(i):
        p = http_paths[i]
        t = time.perf_counter()
        if i % 8 == 1:       # path mode, inside --path-root
            r = http_request(port, "POST", "/caption", json.dumps(
                {"path": os.path.basename(p)}), "application/json")
        else:
            with open(p, "rb") as f:
                r = http_request(port, "POST", "/caption", f.read(),
                                 "application/octet-stream")
        return (time.perf_counter() - t) * 1e3, r
    try:
        first_ms, first = ask(0)
        with ThreadPoolExecutor(HTTP_CLIENTS) as pool:
            rest = list(pool.map(ask, range(1, len(http_paths))))
        answers = [first] + [r for _, r in rest]
        bad = [(p, r) for p, r in zip(http_paths, answers)
               if r != (200, {"caption": refs["beam"][p]})]
        outside = http_request(port, "POST", "/caption", json.dumps(
            {"path": "../msrvtt_attn_beam5.npz"}), "application/json")
        stats = http_request(port, "GET", "/stats")[1]
    finally:
        srv.proc.send_signal(signal.SIGINT)
    err = srv.finish("serve --http")
    if bad:
        fail(f"serve --http: {len(bad)} answers differ from the in-process "
             f"decode, e.g. {bad[0]}")
    if outside[0] != 403 or stats["served"] != 96 or stats["rejected"]:
        fail(f"serve --http: outside the root {outside}, /stats {stats}")
    method, decodes, steps, launches, _ = launch_line(err, "serve --http")
    check_served(method, decodes, steps, launches, "beam", "serve --http")
    client = np.array([ms for ms, _ in rest])
    out["http"] = dict(
        requests=len(answers), clients=HTTP_CLIENTS, stats=stats,
        client_p50_ms=float(np.percentile(client, 50)),
        client_p99_ms=float(np.percentile(client, 99)),
        first_request_ms=first_ms, decodes=decodes, steps=steps,
        launches=launches)
    # no nvcc build (seconds) and no weight cast in the first request: the
    # warmup paid them; it waits out --max-wait-ms alone and decodes once
    if first_ms > out["http"]["client_p50_ms"] + 1000:
        fail(f"serve --http: the first request took {first_ms} ms, the "
             f"median {out['http']['client_p50_ms']} ms")

    # ---- (c) greedy through K3
    srv = Served(["serve", "--preset", "msvd_greedy", "--weights",
                  setup["msvd_greedy"], "--set",
                  f"data.data_dir={setup['data']}", "--batch", str(SERVE_B)],
                 tmp, stdin=True)
    srv.proc.stdin.write("\n".join(paths[:GREEDY_FILES]) + "\n")
    srv.proc.stdin.close()
    lines = srv.read(GREEDY_FILES, "serve greedy")
    err = srv.finish("serve greedy")
    if any(c != refs["greedy"][p] for _, p, c in lines):
        fail("serve greedy: lines differ from the in-process K3 decode")
    method, decodes, steps, launches, mode = launch_line(err, "serve greedy")
    check_served(method, decodes, steps, launches, "greedy", "serve greedy")
    if decodes != 3 or mode != "resident":
        fail(f"serve greedy: {decodes} decodes, W_out {mode}")
    out["greedy"] = dict(decodes=decodes, launches=launches, w_out=mode)
    return out


def phase_export(setup, refs, tmp):
    """``export`` through the CLI: a beam artifact at B=32 from the
    msrvtt_attn_beam5 weights and a batch-polymorphic greedy one from
    msvd_greedy's; then, all at once, ``caption --from-export`` on the
    msrvtt test split and with ``--inputs`` (phase 12's files) and ``serve
    --from-export`` of the greedy artifact on stdin: each equal to the
    in-process decode of the same inputs (phase 12's references), K1/K2
    (beam) or K3 (greedy) launches on each decodes line. Refused, exit not
    0: ``export --method sample``, an export of scst_cider's sampled decode,
    ``serve --from-export`` of the beam artifact with --method greedy."""
    data = ["--set", f"data.data_dir={setup['data']}"]
    beam = ["--preset", "msrvtt_attn_beam5", *data]
    greedy = ["--preset", "msvd_greedy", *data]
    art_b, art_g = os.path.join(tmp, "art_beam"), os.path.join(tmp, "art_greedy")
    pipes = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    def finish(procs, want_ok=True):
        res = {}
        for name, (p, inp) in procs.items():
            try:
                o, e = p.communicate(inp, timeout=600)
            finally:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            if (p.returncode == 0) != want_ok:
                fail(f"phase 13 {name} exited {p.returncode}: {e[-3000:]}")
            res[name] = (o, e)
        return res

    w_b, w_g = setup["msrvtt_attn_beam5"], setup["msvd_greedy"]
    t0 = time.perf_counter()
    refused = {
        "export --method sample": (port_proc(
            ["export", *beam, "--weights", w_b, "--method", "sample",
             "--out", "never"], tmp, **pipes), None),
        "export scst_cider (sample)": (port_proc(
            ["export", "--preset", "scst_cider", *data, "--weights", w_b,
             "--out", "never"], tmp, **pipes), None)}
    made = finish({
        "export beam": (port_proc(["export", *beam, "--weights", w_b,
                                   "--batch", str(SERVE_B), "--out", art_b],
                                  tmp, **pipes), None),
        "export greedy": (port_proc(["export", *greedy, "--weights", w_g,
                                     "--batch", "0", "--method", "greedy",
                                     "--out", art_g], tmp, **pipes), None)})
    metas = {}
    for art in (art_b, art_g):
        with open(os.path.join(art, "meta.json")) as f:
            metas[os.path.basename(art)] = json.load(f)
    if metas["art_beam"]["batch_size"] != SERVE_B or metas["art_beam"][
            "method"] != "beam" or metas["art_greedy"]["batch_size"] is not None:
        fail(f"phase 13 export: metas {metas}")
    refused["serve --from-export beam --method greedy"] = (port_proc(
        ["serve", *beam, "--from-export", art_b, "--method", "greedy"], tmp,
        stdin=subprocess.PIPE, **pipes), "")
    split_json = os.path.join(tmp, "split.json")
    inputs_json = os.path.join(tmp, "inputs.json")
    used = finish({
        "caption --from-export split": (port_proc(
            ["caption", *beam, "--from-export", art_b, "--split", "test",
             "--out", split_json], tmp, **pipes), None),
        "caption --from-export --inputs": (port_proc(
            ["caption", *beam, "--from-export", art_b, "--inputs",
             setup["inputs"], "--out", inputs_json], tmp, **pipes), None),
        "serve --from-export greedy": (port_proc(
            ["serve", *greedy, "--from-export", art_g], tmp,
            stdin=subprocess.PIPE, **pipes),
            "\n".join(setup["paths"][:GREEDY_FILES]) + "\n")})
    no = finish(refused, want_ok=False)
    wall = time.perf_counter() - t0
    for name, text in (("export --method sample", "invalid choice"),
                       ("export scst_cider (sample)", "greedy/beam"),
                       ("serve --from-export beam --method greedy",
                        "conflicts with the artifact")):
        if text not in no[name][1]:
            fail(f"phase 13 {name}: refused without {text!r}: "
                 f"{no[name][1][-2000:]}")
    out = {"metas": {k: {f: m[f] for f in ("method", "beam_width",
                                           "batch_size", "platforms")}
                     for k, m in metas.items()}}
    with open(split_json) as f:
        if json.load(f) != refs["split"]:
            fail("phase 13: caption --from-export on the split differs from "
                 "the in-process decode")
    with open(inputs_json) as f:
        want = {os.path.splitext(os.path.basename(p))[0]: [c]
                for p, c in refs["beam"].items()}
        if json.load(f) != want:
            fail("phase 13: caption --from-export --inputs differs from the "
                 "in-process decode")
    o = used["serve --from-export greedy"][0].splitlines()
    if o != [f"{p}\t{refs['greedy'][p]}"
             for p in setup["paths"][:GREEDY_FILES]]:
        fail("phase 13: serve --from-export differs from the in-process K3 "
             "decode")
    for name, want_method, want_decodes in (
            ("caption --from-export split", "beam", 2),
            ("caption --from-export --inputs", "beam", 4),
            ("serve --from-export greedy", "greedy", 3)):
        method, decodes, steps, launches, _ = launch_line(used[name][1],
                                                          name)
        check_served(method, decodes, steps, launches, want_method, name)
        if decodes != want_decodes:
            fail(f"phase 13 {name}: {decodes} decodes, want {want_decodes}")
        out[name] = dict(decodes=decodes, steps=steps, launches=launches)
    out["wall_s"] = wall
    return out


# Phase 14: the trainer's dispatch at scst_cider width, on a corpus the size
# of MSR-VTT's train split: 6,513 videos of N(0,1) features (26 × 1536 f32:
# 1.04 GB, the feature bank), 5 captions each over the 12,000-word vocab.
BANK_VIDEOS = 6_513
DISPATCH_STEPS = 4   # steps a stage in (b)
# (b): (name, banked, K steps a dispatch, grad_accum)
DISPATCH_VARIANTS = (("unbanked K=1", False, 1, 1), ("banked K=1", True, 1, 1),
                     ("banked K=4", True, 4, 1),
                     ("grad_accum=2", True, 1, 2))
# (c): K of the banked dispatch, XE and SCST (the CLI's end state, (d))
TIMED_K = {"xe": 8, "scst": 4}


def bank_corpus(cfg, n: int, g) -> CaptionDataset:
    """n videos of N(0,1) features, 5 captions each of 5-29 words from a
    3,000-word pool of the 12,000-word vocab."""
    vocab = vocab_of(VOCAB_G)
    pool = g.integers(4, VOCAB_G, 3000)
    ids = [f"video{i}" for i in range(n)]
    caps = {v: [" ".join(vocab.id_to_word[int(t)] for t in g.choice(
        pool, int(g.integers(5, 30)))) for _ in range(5)] for v in ids}
    feats = g.standard_normal((n, T, D), dtype=np.float32)
    return CaptionDataset(feats, ids, caps, cfg.data, vocab=vocab)


def stage_setup(cfg, init, tables, stage: str, accum: int):
    """(a state from ``init``, the seeded init's state dict on the card;
    the stage's step body)."""
    c = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, stage=stage, grad_accum=accum))
    model = create_model(c, VOCAB_G).cuda()
    model.load_state_dict(init)
    state = create_train_state(c, model)
    body = (make_xe_step_body(c) if stage == "xe"
            else make_scst_step_body(c, tables=tables))
    return state, body


def chunks(batches, seeds, k: int, bank: bool):
    """The dispatches of ``batches`` (host dicts) k at a time, stacked when
    k > 1, features and attributes dropped in bank mode, with the seeds."""
    for i in range(0, len(batches), k):
        part = [{key: v for key, v in b.items() if not bank
                 or key not in ("features", "attributes")}
                for b in batches[i:i + k]]
        d = part[0] if k == 1 else {key: np.stack([b[key] for b in part])
                                    for key in part[0]}
        if seeds is not None:
            d["seed"] = seeds[i] if k == 1 else seeds[i:i + k]
        yield d


def dispatcher(body, ds, banks, bank: bool, k: int):
    if not bank:
        return make_step(body, "cuda")
    if k > 1:
        return make_banked_multistep(body, ds, k, banks=banks,
                                     device="cuda")[0]
    return make_banked_step(body, ds, banks=banks, device="cuda")[0]


def state_of(state):
    opt = state.opt_state
    out = {f"param {k}": p.detach().clone() for k, p in state.params.items()}
    for m in ("mu", "nu"):
        out.update({f"{m} {k}": v.clone() for k, v in opt[m].items()})
    out["count"] = opt["count"].clone()
    return out


def parting(a: dict, b: dict):
    """(max |a - b| over the tensors of two runs, the name where it is
    largest, the first name where they differ)."""
    worst, where, first = 0.0, None, None
    for k in a:
        d = (a[k].double() - b[k].double()).abs().max().item()
        if d > 0 and first is None:
            first = k
        if d > worst:
            worst, where = d, k
    return worst, where, first


def run_eager(setup, stage, accum, batches, seeds):
    """DISPATCH_STEPS steps of the eager body from the seeded init: the
    per-step metrics and the state after, flattened."""
    state, body = setup(stage, accum)
    rec = {}
    for j, b in enumerate(batches[:DISPATCH_STEPS]):
        d = {key: torch.as_tensor(v, device="cuda") for key, v in b.items()}
        if seeds is not None:
            d["seed"] = seeds[j]
        state, m = body(state, d)
        rec.update({f"step {j + 1} {key}": v.clone() for key, v in m.items()})
    torch.cuda.synchronize()
    return {**rec, **state_of(state)}


def dispatch_equal(setup, ds, banks, batches):
    """(b): for each variant and stage, DISPATCH_STEPS steps of the
    dispatched (captured) step against the eager body, from the seeded init
    and the same seeds; the eager body run twice (once for the variants of
    one grad_accum); the per-step metrics and the state after them
    compared. Captured must equal eager where the two eager runs are equal,
    else be within 2x their max |Δ|."""
    out, problems, eager = {}, [], {}
    for name, bank, k, accum in DISPATCH_VARIANTS:
        for stage in ("xe", "scst"):
            seeds = (torch.randint(0, 2**31 - 1, (DISPATCH_STEPS, accum),
                                   generator=torch.Generator().manual_seed(7))
                     if stage == "scst" else None)
            if (stage, accum) not in eager:
                runs = [run_eager(setup, stage, accum, batches, seeds)
                        for _ in range(2)]
                eager[stage, accum] = (runs[0], parting(*runs))
            ref, floor = eager[stage, accum]
            state, body = setup(stage, accum)
            fn = dispatcher(body, ds, banks, bank, k)
            rec = {}
            for i, d in enumerate(chunks(batches[:DISPATCH_STEPS], seeds, k,
                                         bank)):
                state, m = fn(state, d)
                for j in range(k):
                    rec.update({f"step {i * k + j + 1} {key}":
                                (v[j] if k > 1 else v).clone()
                                for key, v in m.items()})
            torch.cuda.synchronize()
            rec.update(state_of(state))
            capt = parting(ref, rec)
            limit = 2 * floor[0]
            ok = capt[0] <= limit and ref["count"].item() == \
                rec["count"].item() == DISPATCH_STEPS
            out[f"{name} {stage}"] = dict(
                eager_vs_eager=floor[0], eager_parts_at=floor[1],
                eager_first_parting=floor[2], captured_vs_eager=capt[0],
                captured_parts_at=capt[1], captured_first_parting=capt[2],
                limit=limit, loss=[rec[f"step {j + 1} loss"].item()
                                   for j in range(DISPATCH_STEPS)])
            if not ok:
                problems.append(f"{name} {stage}: {out[f'{name} {stage}']}")
    return out, problems


def profiled(fn, steps: int):
    """One call of ``fn`` (``steps`` steps) under torch.profiler: (device
    busy ms, device kernels, K3's device ms, top-level host events, each a
    step; the five kernels of most device time, ms a step). A graph's
    kernels have no host event for a parent: only host events count."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = kernels = k3 = 0.0
    top = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.self_device_time_total / 1e3
            busy += ms
            top[e.key[:50]] = top.get(e.key[:50], 0.0) + ms / steps
            if not e.key.startswith(("Memcpy", "Memset")):
                kernels += e.count
            if "rollout_kernel" in e.key:
                k3 += ms
    host = sum(1 for e in prof.events() if e.cpu_parent is None
               and e.device_type == torch.autograd.DeviceType.CPU)
    top = dict(sorted(top.items(), key=lambda kv: -kv[1])[:5])
    return busy / steps, kernels / steps, k3 / steps, host / steps, top


def dispatch_times(setup, ds, banks):
    """(c): ms a step of the eager body (the batch uploaded from pageable
    memory, as the loop did before the graphs), the captured step (K=1,
    unbanked) and the banked K-step dispatch, each from a fresh state: the
    median of timed dispatches (host clock, each ending in a synchronize)
    after the first, then one profiled dispatch."""
    out = {}
    it = DeterministicBatcher(ds, BG, seed=3)
    for stage in ("xe", "scst"):
        for how in ("eager", "captured K=1", f"banked K={TIMED_K[stage]}"):
            state, body = setup(stage, 1)
            k = TIMED_K[stage] if how.startswith("banked") else 1
            if how == "eager":
                call = lambda: body(state, {
                    **batch_to_device(next(it), "cuda"),
                    **({"seed": draw_seeds(state, 1)}
                       if stage == "scst" else {})})
            else:
                bank = how.startswith("banked")
                fn = dispatcher(body, ds, banks, bank, k)
                call = lambda: fn(state, next(chunks(
                    [batch_to_device_dict(next(it)) for _ in range(k)],
                    None, k, bank)))
            walls = []
            for i in range(1 + (5 if how == "eager" else 8 // k + 2)):
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                if i:
                    walls.append((time.perf_counter() - t0) * 1e3 / k)
            ms = float(np.median(walls))
            busy, kernels, k3, host, top = profiled(call, k)
            row = dict(ms_a_step=ms, steps_per_s=1e3 / ms,
                       device_busy_ms_a_step=busy, busy_share=busy / ms,
                       device_kernels_a_step=kernels,
                       host_events_a_step=host, walls_ms_a_step=walls,
                       top_device_ms_a_step=top)
            if stage == "scst":
                row["k3_ms_a_step"] = k3
                row["k3_share"] = k3 / ms
            out[f"{stage} {how}"] = row
    return out


def train_cli(args, cwd: str):
    """``train`` through the CLI, started in ``cwd``."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [REPO, os.environ.get("PYTHONPATH")]))}
    return subprocess.Popen([sys.executable, "-m", "vidcap_tpu_torch",
                             "train", "--preset", "scst_cider", *args],
                            cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finished(proc, what: str) -> str:
    _, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        fail(f"phase 14 {what} exited {proc.returncode}: {err[-3000:]}")
    return err


STAGE_LINE = re.compile(r"\[vidcap\] (\w+): (\d+) steps on (\S+?)"
                        r"(?:; rollout W_out (\w+))?; kernel launches "
                        r"(\{.*\})")


def dispatch_cli(ds, tmp: str):
    """(d): the end-state command on the corpus written as msrvtt files,
    ``--eval-every 12`` (crossed inside the XE chunk 8→16 and at 24); at
    once, ``--stages xe --steps 16 --steps-per-dispatch 8`` in another
    directory, then ``--resume --steps 24 --steps-per-dispatch 4`` there,
    whose step-24 checkpoint must equal the first run's bit for bit."""
    data = os.path.join(tmp, "data")
    os.makedirs(data)
    np.save(os.path.join(data, "msrvtt_train_feats.npy"), ds.features)
    with open(os.path.join(data, "msrvtt_train_ids.json"), "w") as f:
        json.dump(ds.video_ids, f)
    with open(os.path.join(data, "msrvtt_captions.json"), "w") as f:
        json.dump(ds.video_captions, f)
    ds.vocab.save(os.path.join(data, "msrvtt_vocab.json"))
    common = ["--feature-bank", "--log-every", "1", "--set",
              f"data.data_dir={data}", "--set", "train.checkpoint_every=16"]
    t0 = time.perf_counter()
    end_state = train_cli(["--stages", "xe,scst", "--steps", "24,8",
                           "--steps-per-dispatch", "8,4", "--set",
                           "train.prefetch_depth=2", "--eval-every", "12",
                           "--log-file", "log.jsonl", *common], tmp)
    part = train_cli(["--stages", "xe", "--steps", "16",
                      "--steps-per-dispatch", "8", "--eval-every", "0",
                      "--checkpoint-dir", "ck2", *common], tmp)
    err = finished(end_state, "train (end state)")
    wall = time.perf_counter() - t0
    finished(part, "train --steps 16")
    t1 = time.perf_counter()
    err_resume = finished(train_cli(
        ["--stages", "xe", "--steps", "24", "--steps-per-dispatch", "4",
         "--eval-every", "0", "--checkpoint-dir", "ck2", "--resume",
         *common], tmp), "train --resume")
    resume_wall = time.perf_counter() - t1
    lines = [(st, int(n), mode or None, json.loads(lc))
             for st, n, _, mode, lc in STAGE_LINE.findall(err)]
    with open(os.path.join(tmp, "log.jsonl")) as f:
        rows = [json.loads(x) for x in f]
    evals = [r["step"] for r in rows if "eval_CIDEr" in r]
    steps = [r["step"] for r in rows if "eval_CIDEr" not in r]
    ckpts = sorted(int(f[5:-3]) for f in os.listdir(os.path.join(
        tmp, "checkpoints")) if f.startswith("ckpt_"))
    best = [f for f in os.listdir(os.path.join(tmp, "checkpoints", "best"))
            if f.startswith("ckpt_")]
    per_eval = -(-200 // BG)   # validation: the first 200 videos, B=32
    want_lines = [("xe", 24, None, counts(rollout=per_eval * len(evals),
                                          teacher_forced=2 * 24)),
                  ("scst", 8, "resident", counts(rollout=2 * 8,
                                                 teacher_forced=4 * 8))]
    a, b = (torch.load(os.path.join(tmp, d, "ckpt_24.pt"), weights_only=True)
            for d in ("checkpoints", "ck2"))
    flat = lambda c: {**c["params"], **{f"{m} {k}": v for m in ("mu", "nu")
                                        for k, v in c["opt_state"][m].items()}}
    resume_diff = parting(flat(a), flat(b))[0]
    same_rest = (a["opt_state"]["count"] == b["opt_state"]["count"]
                 and a["iter_state"] == b["iter_state"]
                 and torch.equal(a["generator"], b["generator"]))
    out = dict(stage_lines=lines, eval_steps=evals, checkpoints=ckpts,
               best=best, resume_max_abs_diff=resume_diff,
               end_state_wall_s=wall, resume_wall_s=resume_wall,
               xe_steps_per_s=[r["steps_per_sec"] for r in rows
                               if "xe_loss" in r and "steps_per_sec" in r],
               scst_steps_per_s=[r["steps_per_sec"] for r in rows
                                 if "pg_loss" in r and "steps_per_sec" in r],
               resume_stage_lines=STAGE_LINE.findall(err_resume))
    problems = []
    if steps != list(range(1, 33)):
        problems.append(f"log rows at steps {steps}")
    if evals != [16, 24]:
        problems.append(f"eval rows at {evals}")
    if ckpts != [16, 24, 32] or len(best) != 1:
        problems.append(f"checkpoints {ckpts}, best/ {best}")
    if lines != want_lines:
        problems.append(f"stage lines {lines}, want {want_lines}")
    if resume_diff != 0.0 or not same_rest:
        problems.append(f"resume across K: {resume_diff} apart")
    return out, problems


def phase_dispatch():
    """The trainer's dispatch at scst_cider width (B=32, Vp=12,032, L=30)
    on BANK_VIDEOS videos: (a) the bank's bytes and upload time, the reward
    tables' build time; (b) dispatched equals eager; (c) XE and SCST ms a
    step, eager, captured and banked K, with the busy share, host events and
    device kernels a step and K3's share; (d) the CLI's end state, its
    rows, checkpoints, best/, stage lines, and a resume across K."""
    t_phase = time.perf_counter()
    cfg = get_preset("scst_cider")
    t0 = time.perf_counter()
    ds = bank_corpus(cfg, BANK_VIDEOS, np.random.default_rng(14))
    corpus_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    banks = _build_banks(ds, device="cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables = tables_from_dataset(ds)
    tables_s = time.perf_counter() - t0
    tables = tables.to("cuda")   # once, for every step body below
    bank_bytes = sum(v.numel() * v.element_size() for v in banks.values())
    it = DeterministicBatcher(ds, BG, seed=0)
    batches = [batch_to_device_dict(next(it)) for _ in range(DISPATCH_STEPS)]
    init = init_params(create_model(cfg, VOCAB_G),
                       cfg.train.seed).cuda().state_dict()
    setup = lambda stage, accum: stage_setup(cfg, init, tables, stage, accum)
    _build.reset_counts()
    t0 = time.perf_counter()
    equal, problems = dispatch_equal(setup, ds, banks, batches)
    t1 = time.perf_counter()
    times = dispatch_times(setup, ds, banks)
    t2 = time.perf_counter()
    launches = dict(_build.launch_counts)
    with tempfile.TemporaryDirectory() as tmp:
        cli, cli_problems = dispatch_cli(ds, tmp)
    out = dict(bank_bytes=bank_bytes, bank_upload_s=upload_s,
               reward_tables_s=tables_s, corpus_s=corpus_s,
               captured_equals_eager=equal, times=times, cli=cli,
               launches_b_c=launches, b_s=t1 - t0, c_s=t2 - t1,
               d_s=time.perf_counter() - t2)
    out["seconds"] = time.perf_counter() - t_phase
    if bank_bytes != BANK_VIDEOS * T * D * 4 + BANK_VIDEOS * \
            cfg.data.num_attributes * 4:
        problems.append(f"bank of {bank_bytes} bytes")
    out["reward_tables_counter"] = tables.counter
    if tables.counter != "native":
        problems.append(f"reward tables counted by the {tables.counter} "
                        "counter, not the native library")
    if problems or cli_problems:
        fail("phase 14: " + "; ".join(problems + cli_problems) + " | "
             + json.dumps(out))
    return out


# Phase 15: end to end from pixels at full width: IRv2 at width 1.0, depth
# (10, 20, 10), S=299, T=26 frames, D=1536; e2e_scst_multitask's B=8
# (208 frames a step), vocab 12,000 (Vp=12,032), bf16.
S_PIX, PIX_B, PIX_VIDEOS = 299, 8, 64
PIX_STEPS = 2        # steps a run in (c): eager twice, then captured
PREP_TOL = 1e-5      # (a): the resize's f32 sums on the card vs the CPU
BB_F32_TOL = 1e-4    # (b): f32 (TF32 off), card vs CPU, relative L2
# (b): bf16 on the card vs f32 on the CPU, relative L2. The port's bf16 path
# on the CPU (the same rounding points, f32 sums) reads 0.0051 against its
# f32 path at full width on 149² frames with the seeded weights, 0.0043
# with pixel_front_end's batch-norm draws; cuDNN rounds at the same points
# and sums in another order, so 4x that.
BB_BF16_TOL = 0.02


def pixel_corpus(cfg, n: int, g) -> CaptionDataset:
    """n videos of uniform pixels in [-1, 1] (T × 299 × 299 × 3 f32), 5
    captions each of 5-29 words from a 3,000-word pool of the 12,000-word
    vocab."""
    vocab = vocab_of(VOCAB_G)
    pool = g.integers(4, VOCAB_G, 3000)
    ids = [f"video{i}" for i in range(n)]
    caps = {v: [" ".join(vocab.id_to_word[int(t)] for t in g.choice(
        pool, int(g.integers(5, 30)))) for _ in range(5)] for v in ids}
    x = g.random((n, T, S_PIX, S_PIX, 3), dtype=np.float32)
    x *= 2.0
    x -= 1.0
    return CaptionDataset(x, ids, caps, cfg.data, vocab=vocab)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def pixel_front_end(g):
    """(a) preprocess_frames on the card against the CPU; (b) the
    full-width backbone on 4 frames: card f32 (TF32 off) and card bf16
    against the port's CPU f32. Returns (the readings, the seeded f32
    backbone's state dict)."""
    from vidcap_tpu_torch.data.frames import preprocess_frames
    from vidcap_tpu_torch.models.backbone import (InceptionResNetV2,
                                                  init_backbone)
    u8 = torch.as_tensor(g.integers(0, 256, (T, 240, 320, 3),
                                    dtype=np.uint8))
    cpu = preprocess_frames(u8, S_PIX)
    card = preprocess_frames(u8.cuda(), S_PIX)
    prep_err = float((card.cpu() - cpu).abs().max())
    prep_ms = time_ms(lambda: preprocess_frames(u8.cuda(), S_PIX), 5, 3)
    ref = InceptionResNetV2(compute_dtype=torch.float32)
    init_backbone(ref, np.random.default_rng(15))
    # init sets every batch-norm scale to 1 and offset to 0, under which a
    # ConvBN that mixed them up would pass: draw them as converted weights
    # have them, in parameter order from a numpy seed
    gbn = np.random.default_rng(16)
    with torch.no_grad():
        for name, p in ref.named_parameters():
            if name.endswith("bn_scale"):
                p.copy_(torch.as_tensor(gbn.uniform(0.5, 1.5, p.shape)))
            elif name.endswith("bn_offset"):
                p.copy_(torch.as_tensor(gbn.normal(0.0, 0.1, p.shape)))
    x = cpu[:4]
    t0 = time.perf_counter()
    with torch.no_grad():
        want = ref(x)
    cpu_s = time.perf_counter() - t0
    sd = ref.state_dict()
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        net = InceptionResNetV2(compute_dtype=dtype).cuda()
        net.load_state_dict(sd)
        with torch.no_grad():
            out[name] = rel_l2(net(x.cuda()), want)
        del net
    res = dict(preprocess_max_abs_err=prep_err,
               preprocess_ms_26_frames=prep_ms,
               backbone_rel_l2_card_f32_vs_cpu_f32=out["f32"],
               backbone_rel_l2_card_bf16_vs_cpu_f32=out["bf16"],
               cpu_f32_seconds_4_frames=cpu_s,
               feature_rms=float(want.pow(2).mean().sqrt()))
    if prep_err > PREP_TOL or out["f32"] > BB_F32_TOL \
            or out["bf16"] > BB_BF16_TOL:
        fail("phase 15 (a)/(b): " + json.dumps(res))
    return res, sd


def pixel_setup(cfg, init, tables, stage: str):
    """A state on the card from ``init`` (the full model's state dict) and
    the stage's step body."""
    c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                           stage=stage))
    model = create_model(c, VOCAB_G).cuda()
    model.load_state_dict(init)
    state = create_train_state(c, model)
    body = (make_xe_step_body(c) if stage in ("xe", "e2e")
            else make_scst_step_body(c, tables=tables))
    return state, body


def pixel_steps(cfg, init, tables, batches, seeds, captured: bool,
                hook_calls: list):
    """PIX_STEPS composed steps from ``init``: (per-step metrics and the
    state after, flattened; the state; the step function)."""
    state, body = pixel_setup(cfg, init, tables, "scst")
    state.model.backbone.register_forward_hook(
        lambda *a: hook_calls.append(1))
    fn = make_step(body, "cuda") if captured else body
    rec = {}
    for j, b in enumerate(batches):
        d = dict(b, seed=seeds[j])
        if not captured:
            d = {k: torch.as_tensor(v, device="cuda") for k, v in d.items()}
        state, m = fn(state, d)
        rec.update({f"step {j + 1} {k}": v.clone() for k, v in m.items()})
    torch.cuda.synchronize()
    return {**rec, **state_of(state)}, state, fn


def pixel_rollouts(cfg, init, tables, batch, seed: int):
    """(c) K3 at the composed step's own shapes, against its plain version:
    the step's encode of one B=8 pixel batch (``encode_features`` of the
    step's state, as the step body takes it), the decoder state from it
    (keys/values bf16[8, 26, 512]), then the greedy rollout and the sampled
    one at the preset's temperature, in the step's W_out mode: each run
    twice (identical) and replayed through the plain step along the
    kernel's tokens (check_rollout at K3_LOGIT_TOL / temperature), and the
    share of rows identical to the plain rollout read. These launches
    compare the kernel with its plain version and are not counted."""
    state, _ = pixel_setup(cfg, init, tables, "scst")
    model, d = state.model, cfg.decode
    with torch.no_grad():
        feats = model.encode_features(torch.as_tensor(batch["features"],
                                                      device="cuda"))
        st = model.init_state(feats)
    w = KernelWeights(model.decoder).rollout()
    resident = decoding.route(model.decoder, d, "greedy", 1, feats.shape[1],
                              feats.device).resident
    args = (st.keys, st.values, st.frame_mask, st.h[0].contiguous(),
            st.c[0].contiguous())
    problems = []
    out = dict(keys=[list(st.keys.shape), str(st.keys.dtype)],
               values=[list(st.values.shape), str(st.values.dtype)],
               resident_wout=resident, seed=seed)
    for name, sample, temp in (("greedy", False, 1.0),
                               ("sample", True, d.temperature)):
        run = (d.max_len, sample, seed, temp)
        tk, lk, mk = rollout(w, *args, *run, resident_wout=resident)
        tk2, lk2, _ = rollout(w, *args, *run, resident_wout=resident)
        torch.cuda.synchronize()
        if not (torch.equal(tk, tk2) and torch.equal(lk, lk2)):
            problems.append(f"{name}: two runs differ")
        pick, margin, logp_ref = replay_plain(w, *args, tk, sample, seed,
                                              temp)
        p, err, clear = check_rollout(tk, lk, mk, pick, margin, logp_ref,
                                      K3_LOGIT_TOL / temp)
        problems += [f"{name}: {x}" for x in p]
        tp, _, _ = rollout_plain(w, *args, *run)
        out[name] = dict(temperature=temp, max_abs_logp_err=err,
                         tolerance=K3_LOGIT_TOL / temp,
                         clear_step_share=clear,
                         rows_identical_to_plain=(tk == tp).all(1).float()
                         .mean().item(),
                         rows_ended=(tk == EOS).any(1).float().mean().item())
    del state, feats, st, args, w
    return problems, out


def phase_pixels(bb_sd):
    """(c) the composed e2e_scst_multitask step at full width, B=8: K3 on
    the step's own keys/values against its plain version (pixel_rollouts);
    eager twice and captured from one init and seeds (captured == eager where the
    two eager runs are equal, else within 2x their max |diff|), one backbone
    forward a step (a hook on the backbone module, outside the blocks remat
    recomputes), 2 K3 launches a captured step, finite rewards and pieces;
    ms a step eager and captured, busy share, peak memory, frames/s, the
    top kernels. (d) two e2e_irv2 steps (stage e2e, captured): ms a step,
    the backbone group's rate 0.1x the rest."""
    cfg = get_preset("e2e_scst_multitask")
    g = np.random.default_rng(151)
    t0 = time.perf_counter()
    ds = pixel_corpus(cfg, PIX_VIDEOS, g)
    corpus_s = time.perf_counter() - t0
    tables = tables_from_dataset(ds).to("cuda")
    model = init_params(create_model(cfg, VOCAB_G), cfg.train.seed)
    model.backbone.load_state_dict(bb_sd)
    init = model.cuda().state_dict()
    del model
    it = DeterministicBatcher(ds, PIX_B, seed=0)
    batches = [batch_to_device_dict(next(it)) for _ in range(PIX_STEPS)]
    seeds = torch.randint(0, 2**31 - 1, (PIX_STEPS, 1),
                          generator=torch.Generator().manual_seed(15))
    problems, k3_b8 = pixel_rollouts(cfg, init, tables, batches[0],
                                     int(seeds[0, 0]))
    hooks = {}
    runs = []
    for name in ("eager 1", "eager 2"):
        calls = []
        runs.append(pixel_steps(cfg, init, tables, batches, seeds, False,
                                calls)[0])
        hooks[name] = len(calls)
    floor = parting(*runs)
    calls = []
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    rec, state, fn = pixel_steps(cfg, init, tables, batches, seeds, True,
                                 calls)
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    hooks["captured (warm-up + capture; replays run no Python)"] = len(calls)
    capt = parting(runs[0], rec)
    metrics = {k: rec[f"step {j + 1} {k}"].item() for j in range(PIX_STEPS)
               for k in ("reward_sample", "reward_greedy", "pg_loss",
                         "xe_anchor", "attr_loss", "loss")}
    if capt[0] > 2 * floor[0]:
        problems.append(f"captured vs eager {capt} (eager vs eager {floor})")
    if hooks["eager 1"] != PIX_STEPS or hooks["eager 2"] != PIX_STEPS or \
            len(calls) != 2:
        problems.append(f"backbone forwards {hooks}")
    if launches["rollout"] != 2 * PIX_STEPS:
        problems.append(f"K3 launches {launches} for {PIX_STEPS} steps")
    if not all(np.isfinite(v) for v in metrics.values()):
        problems.append(f"metrics {metrics}")
    # the times: the captured dispatch (fresh batches), then the eager body
    it2 = DeterministicBatcher(ds, PIX_B, seed=1)
    nxt = lambda: batch_to_device_dict(next(it2))

    def walls(call, n):
        out = []
        for _ in range(n):
            t1 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t1) * 1e3)
        return out
    cap_call = lambda: fn(state, {**nxt(), "seed": draw_seeds(state, 1)})
    cap_walls = walls(cap_call, 4)
    cap_busy, cap_kernels, cap_k3, _, cap_top = profiled(cap_call, 1)
    estate, ebody = pixel_setup(cfg, init, tables, "scst")
    eag_call = lambda: ebody(estate, {
        **{k: torch.as_tensor(v, device="cuda") for k, v in nxt().items()},
        "seed": draw_seeds(estate, 1)})
    eag_walls = walls(eag_call, 3)
    eag_busy, eag_kernels, _, _, eag_top = profiled(eag_call, 1)
    del estate, ebody, state, fn
    cap_ms, eag_ms = float(np.median(cap_walls)), float(np.median(eag_walls))
    out = dict(corpus_s=corpus_s, k3_at_step_shapes=k3_b8,
               captured_vs_eager=capt[0],
               eager_vs_eager=floor[0], captured_parts_at=capt[1],
               backbone_forwards=hooks, launches=launches,
               peak_memory_bytes=peak, metrics=metrics,
               captured_ms_a_step=cap_ms, captured_walls_ms=cap_walls,
               captured_busy_ms=cap_busy, captured_busy_share=cap_busy
               / cap_ms, captured_device_kernels=cap_kernels,
               captured_k3_ms=cap_k3, captured_top_device_ms=cap_top,
               eager_ms_a_step=eag_ms, eager_walls_ms=eag_walls,
               eager_busy_ms=eag_busy, eager_busy_share=eag_busy / eag_ms,
               eager_device_kernels=eag_kernels, eager_top_device_ms=eag_top,
               frames_per_s_captured=PIX_B * T * 1e3 / cap_ms)
    # (d): e2e_irv2, stage e2e (the XE body through the backbone)
    ecfg = get_preset("e2e_irv2")
    emodel = init_params(create_model(ecfg, VOCAB_G), ecfg.train.seed)
    emodel.backbone.load_state_dict(bb_sd)
    estate, ebody = pixel_setup(ecfg, emodel.cuda().state_dict(), None, "e2e")
    del emodel
    table = estate.opt_state["table"]
    lr_ratio = float(table[3, 0] / table[0, 0])
    efn = make_step(ebody, "cuda")
    e2e_walls = walls(lambda: efn(estate, nxt()), 3)
    out["e2e"] = dict(ms_a_step=float(np.median(e2e_walls[1:])),
                      walls_ms=e2e_walls,
                      backbone_lr_over_rest=lr_ratio,
                      lr_rest=float(table[0, 0]))
    del estate, ebody, efn
    if abs(lr_ratio - 0.1) > 1e-6:
        problems.append(f"backbone rate {lr_ratio} of the rest's")
    if problems:
        fail("phase 15 (c)/(d): " + "; ".join(problems) + " | "
             + json.dumps(out))
    return ds, out


def pixel_cli(ds, tmp: str):
    """(e) the CLI on the corpus written as uint8 msrvtt frame files:
    ``train --preset e2e_scst_multitask --stages xe,scst --steps 2,2``,
    ``--resume --steps 2,3`` (one more SCST step), then ``caption
    --method greedy`` of a 16-video test split."""
    data = os.path.join(tmp, "data")
    os.makedirs(data)
    u8 = np.clip(np.round((ds.features + 1.0) * 127.5), 0, 255).astype(
        np.uint8)
    np.save(os.path.join(data, "msrvtt_train_frames.npy"), u8)
    np.save(os.path.join(data, "msrvtt_test_frames.npy"), u8[:16])
    for split, ids in (("train", ds.video_ids), ("test", ds.video_ids[:16])):
        with open(os.path.join(data, f"msrvtt_{split}_ids.json"), "w") as f:
            json.dump(ids, f)
    with open(os.path.join(data, "msrvtt_captions.json"), "w") as f:
        json.dump(ds.video_captions, f)
    ds.vocab.save(os.path.join(data, "msrvtt_vocab.json"))
    del u8
    common = ["--preset", "e2e_scst_multitask", "--set",
              f"data.data_dir={data}"]
    train = ["train", *common, "--stages", "xe,scst", "--eval-every", "0",
             "--log-every", "1", "--log-file", "log.jsonl"]
    out = {}
    r, out["train_wall_s"] = run_port(train + ["--steps", "2,2"], tmp,
                                      "train", 15)
    r2, out["resume_wall_s"] = run_port(train + ["--steps", "2,3",
                                                 "--resume"], tmp,
                                        "train --resume", 15)
    r3, out["caption_wall_s"] = run_port(
        ["caption", *common, "--method", "greedy", "--out", "caps.json"],
        tmp, "caption", 15)
    lines = [(st, int(n), mode or None, json.loads(lc))
             for st, n, _, mode, lc in STAGE_LINE.findall(r.stderr)]
    lines2 = [(st, int(n), mode or None, json.loads(lc))
              for st, n, _, mode, lc in STAGE_LINE.findall(r2.stderr)]
    with open(os.path.join(tmp, "log.jsonl")) as f:
        rows = [json.loads(x) for x in f]
    with open(os.path.join(tmp, "caps.json")) as f:
        caps = json.load(f)
    method, decodes, steps, cap_launches, _ = launch_line(r3.stderr,
                                                          "phase 15 caption")
    out.update(stage_lines=lines, resume_stage_lines=lines2,
               rows=[{k: v for k, v in row.items() if k in (
                   "step", "xe_loss", "pg_loss", "reward_sample", "loss",
                   "steps_per_sec")} for row in rows],
               captions=len(caps), caption_launches=cap_launches,
               caption_decodes=decodes)
    zero = counts()
    del zero["rollout"]
    problems = []
    if [(a, b) for a, b, _, _ in lines] != [("xe", 2), ("scst", 2)] or \
            lines[1][3] != {**zero, "rollout": 4, "teacher_forced": 8}:
        problems.append(f"stage lines {lines}")
    if [(a, b) for a, b, _, _ in lines2] != [("xe", 0), ("scst", 1)] or \
            lines2[1][3] != {**zero, "rollout": 2, "teacher_forced": 4}:
        problems.append(f"resume stage lines {lines2}")
    if [row["step"] for row in rows] != [1, 2, 3, 4, 5]:
        problems.append(f"log rows {[row['step'] for row in rows]}")
    if len(caps) != 16 or sorted(caps) != sorted(ds.video_ids[:16]) or \
            cap_launches != {**zero, "rollout": decodes} or decodes < 1:
        problems.append(f"{len(caps)} captions, launches {cap_launches}")
    if problems:
        fail("phase 15 (e): " + "; ".join(problems) + " | "
             + json.dumps(out))
    return out


def pixel_videos(bb_sd, g):
    """(f) ``encode_video`` (the device half of ``extract`` and of the
    served video path) on 8 uint8 videos of 26 × 240 × 320: videos/s, and
    each video's rows against the card's f32 backbone ((b) holds that one
    to the CPU's f32) within (b)'s bf16 bound."""
    from vidcap_tpu_torch.data.frames import make_video_encoder
    from vidcap_tpu_torch.models.backbone import InceptionResNetV2
    cfg = get_preset("e2e_irv2")
    nets = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        nets[name] = InceptionResNetV2(compute_dtype=dtype)
        nets[name].load_state_dict(bb_sd)
    enc = make_video_encoder(cfg, "cuda", nets["bf16"])
    ref = make_video_encoder(cfg, "cuda", nets["f32"])
    videos = [g.integers(0, 256, (T, 240, 320, 3), dtype=np.uint8)
              for _ in range(8)]
    enc(videos[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = [enc(v) for v in videos]
    wall = time.perf_counter() - t0
    errs = [rel_l2(torch.as_tensor(r), torch.as_tensor(ref(v)))
            for r, v in zip(rows, videos)]
    out = dict(videos_per_s=len(videos) / wall, wall_s=wall,
               rows_shape=list(rows[0].shape), rel_l2_bf16_vs_f32=errs,
               bound=BB_BF16_TOL)
    if max(errs) > BB_BF16_TOL or rows[0].shape != (T, D):
        fail("phase 15 (f): " + json.dumps(out))
    return out


def phase_e2e_pixels():
    """Phase 15: (a)-(b) the pixel front end, (c)-(d) the e2e train steps,
    (e) the CLI, (f) the video encoder."""
    t0 = time.perf_counter()
    g = np.random.default_rng(150)
    front, bb_sd = pixel_front_end(g)
    t1 = time.perf_counter()
    ds, steps = phase_pixels(bb_sd)
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cli = pixel_cli(ds, tmp)
    del ds
    t3 = time.perf_counter()
    videos = pixel_videos(bb_sd, g)
    out = dict(front_end=front, steps=steps, cli=cli, videos=videos,
               seconds=dict(ab=t1 - t0, cd=t2 - t1, e=t3 - t2,
                            f=time.perf_counter() - t3,
                            total=time.perf_counter() - t0))
    return out


# Phase 16: the rest of the decode surface. K2-int8 at msrvtt_attn_beam5's
# width (N = 920, H = 512, Vp = 16,000); the int8 and finished-pool beams
# through Captioner at B=184 beside the bf16 beam; the decoders no kernel
# covers at msvd_greedy's width (B=32, Vp=12,032); a two-layer SCST step at
# scst_cider's; the CLI: info, the int8 and pool captions, an int8 export.
PEAK_INT8 = 1979e12   # H100 SXM dense int8 tensor ops/s (NVIDIA data sheet)
OTHER_DECODERS = (("two_layers", {"num_lstm_layers": 2}),
                  ("no_attention", {"use_attention": False}),
                  ("float32", {"compute_dtype": "float32"}))


def replaced(cfg, section: str, **kw):
    """``cfg`` with the fields ``kw`` of ``section`` replaced."""
    return dataclasses.replace(cfg, **{section: dataclasses.replace(
        getattr(cfg, section), **kw)})


def check_k2_int8(h, proj, k):
    """K2-int8 on ``h`` against its plain version: the quantized rows and
    scales bit for bit; the columns equal wherever the plain K-th and
    (K+1)-th logits are more than one bf16 ulp apart; the values within one
    bf16 ulp of the row's largest |logit| + 1e-4 (the f32 lse); a second
    run identical. Returns (max |err|, share of rows with every column
    equal, rows with a clear gap)."""
    vk, ik, h8, hs = topk_project_int8(h, proj, k, return_quantized=True)
    h8, hs = h8.clone(), hs.clone()   # the scratch of this launch
    again = topk_project_int8(h, proj, k)
    vp, ip = int8_topk_project_plain(h, proj, k)
    h8p, hsp = quantize_rows(h)
    logits = int8_logits_plain(h, proj)
    torch.cuda.synchronize()
    if not (torch.equal(h8, h8p) and torch.equal(hs, hsp)):
        fail(f"K2-int8 (k={k}): the quantized rows differ from the plain "
             f"version's on {(h8 != h8p).any(1).sum().item()} rows, the "
             f"scales on {(hs != hsp).sum().item()}")
    if not (torch.equal(again[0], vk) and torch.equal(again[1], ik)):
        fail(f"K2-int8 (k={k}): two runs differ")
    real = logits[:, :proj.bq.shape[0]].masked_fill(proj.bq[None] < -1e29, 0)
    tol = bf16_ulp(real.abs().amax(1)) + 1e-4
    err = (vk - vp).abs()
    if not torch.isfinite(vk).all() or (err > tol[:, None]).any():
        fail(f"K2-int8 (k={k}) vs plain: max |err| {err.max().item()} "
             "beyond one bf16 ulp of the logit + 1e-4")
    top = logits.sort(dim=1, descending=True).values
    gap = top[:, k - 1] - top[:, k]
    clear = gap > bf16_ulp(top[:, k - 1])
    same = (ik == ip).all(1)
    if not same[clear].all():
        fail(f"K2-int8 (k={k}): columns differ on "
             f"{(~same[clear]).sum().item()} rows with a clear gap")
    return (err.max().item(), same.float().mean().item(),
            int(clear.sum().item()))


def k2_int8_inputs(g, n: int, hidden: int):
    """N(0,1) rows through tanh and a seeded W_out quantized (vocab VP)."""
    cuda = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")
    h = cuda(np.tanh(g.normal(size=(n, hidden))))
    dense = types.SimpleNamespace(kernel=cuda(g.normal(size=(hidden, VP))
                                              / np.sqrt(hidden)),
                                  bias=cuda(g.normal(size=VP) * 0.1))
    return h, Int8Projection.from_dense(dense, VP)


def k2_int8_bound(n: int, hidden: int, k: int):
    """(bound ms, what bounds it) of K2-int8 at N = n: h read once (f32),
    W8ᵀ, wscale and bq once, the K values and columns written once; 2·N·H·Vp
    int8 operations at the H100's dense int8 rate."""
    nbytes = n * hidden * 4 + VP * hidden + VP * 8 + n * k * 8
    t_bytes, t_ops = nbytes / PEAK_BYTES, 2 * n * hidden * VP / PEAK_INT8
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def int_mm_ms(h, proj):
    """torch._int_mm's time for the product alone (the yardstick; the port
    never calls it), with the layout of W8 it takes."""
    h8 = quantize_rows(h)[0]
    note = None
    for w8 in (proj.w8t.t(), proj.w8t.t().contiguous()):
        try:
            return time_ms(lambda: torch._int_mm(h8, w8)), (
                "column-major W8" if not w8.is_contiguous()
                else "row-major W8")
        except RuntimeError as ex:
            note = f"torch._int_mm refused: {str(ex)[:200]}"
    return None, note


def phase_k2_int8():
    """(a) K2-int8 at N = B·K = 920, K = 5 (the int8 beam) and 6 (the pool),
    and at hidden 1024 (K = 5), against int8_topk_project_plain; its time,
    bound and torch._int_mm's time for the product alone."""
    g = np.random.default_rng(16)
    n = B * K
    h, proj = k2_int8_inputs(g, n, H)
    errs, exact, clear = [], {}, {}
    for k in (K, K + 1):
        e, x, c = check_k2_int8(h, proj, k)
        errs.append(e)
        exact[f"k{k}"], clear[f"k{k}"] = x, c
    lib, lib_note = int_mm_ms(h, proj)
    bound_ms, bound_by = k2_int8_bound(n, H, K)
    h2, proj2 = k2_int8_inputs(g, n, 2 * H)
    e2, x2, c2 = check_k2_int8(h2, proj2, K)
    lib2, lib2_note = int_mm_ms(h2, proj2)
    b2_ms, b2_by = k2_int8_bound(n, 2 * H, K)
    wide = dict(hidden=2 * H, k=K, max_abs_err=e2, exact_rows=x2,
                clear_gap_rows=c2,
                ms=time_ms(lambda: topk_project_int8(h2, proj2, K)),
                bound_ms=b2_ms, bound_by=b2_by, library_ms=lib2,
                library=lib2_note)
    return dict(name="topk_project_int8", route="cuda",
                source="vidcap_tpu_torch/csrc/topk_project.cu",
                replaces="vidcap_tpu/ops/int8_proj.py:75",
                max_abs_err=max(errs + [e2]),
                ms=time_ms(lambda: topk_project_int8(h, proj, K)),
                plain_ms=time_ms(lambda: int8_topk_project_plain(h, proj, K),
                                 iters=5),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib), dict(exact_rows=exact, clear_gap_rows=clear,
                                      library=lib_note,
                                      ms_k6=time_ms(lambda: topk_project_int8(
                                          h, proj, K + 1)),
                                      hidden_1024=wide)


def rows_vs_cpu(cap, trials, n_cand: int, pool: bool):
    """The share of rows the kernel beam of ``cap`` (its cast weights)
    keeps identical to the plain beam on the CPU from the same state, over
    ``trials``; slot-blocking or pooled. Launches here are comparisons and
    are taken back out of the counts."""
    decode = beam_decode_pool if pool else beam_decode
    w = beam_weights(cap)
    kstep = fused_beam_step(w, K, n_cand)
    cstep = plain_beam_step(moved(w, "cpu"), K, n_cand)
    cfg = cap.cfg
    same = []

    def run():
        with torch.inference_mode():
            for f in trials:
                st = tile_recurrent(cap.model.init_state(
                    torch.tensor(f, device="cuda")), K)
                kw = dict(batch=f.shape[0], max_len=cfg.decode.max_len,
                          beam_width=K,
                          length_penalty=cfg.decode.length_penalty,
                          early_exit=cfg.decode.early_exit)
                tk = decode(kstep, st, **kw)[0]
                tc = decode(cstep, moved(st, "cpu"), **kw)[0]
                same.append((tk.cpu() == tc).all(1).float().mean().item())
    _build.counted(run)
    return same


def decode_walls(caps, trials, **kw):
    """{name: captions/s} of each captioner of ``caps`` on ``trials``, the
    calls interleaved (a, b, b, a, ...) on each input; the medians."""
    walls = {name: [] for name in caps}
    order = list(caps) + list(caps)[::-1]
    for f in trials:
        for name in order:
            t0 = time.perf_counter()
            caps[name].decode_batch(f, **kw)
            walls[name].append(time.perf_counter() - t0)
    return {name: trials[0].shape[0] / float(np.median(w))
            for name, w in walls.items()}


def beam_main_path(cap, trials, nbest_too: bool = False):
    """The counts at 0, a warm-up and a decode of each trial (and one at
    nbest 5), the counts read: (launches, K2's launches by K, steps, the
    first decode, the nbest tokens)."""
    _build.reset_counts()
    cap.decode_steps = 0
    first = cap.decode_batch(trials[0], beam_width=K)
    for f in trials:
        cap.decode_batch(f, beam_width=K)
    nb = cap.decode_batch(trials[0], beam_width=K, nbest=K) \
        if nbest_too else None
    torch.cuda.synchronize()
    by_k = {k: n for (name, k), n in _build.launches_by_k.items()
            if name == "topk_project"}
    return dict(_build.launch_counts), by_k, cap.decode_steps, first, nb


def eos_raised_model(cap, feats, k: int, share: float):
    """A copy of the model whose b_out[<eos>] is raised so that <eos> ranks
    within the top ``k`` at the first step on about ``share`` of the rows of
    ``feats`` (a finished pool needs hypotheses that finish)."""
    model = copy.deepcopy(cap.model)
    with torch.inference_mode():
        st = model.init_state(torch.tensor(feats, device="cuda"))
        _, logits = model.decoder.step(st, torch.full(
            (feats.shape[0],), BOS, dtype=torch.long, device="cuda"))
        kth = logits.sort(1, descending=True).values[:, k - 1]
        gap = torch.quantile(kth - logits[:, EOS], share).item()
    with torch.no_grad():
        model.decoder.out_proj.bias[EOS] += gap
    return model, gap


def phase_beam_variants(cap, trials, floor: float):
    """(b) the int8 beam and (c) the pool through Captioner at B=184 on
    phase 4's weights and inputs: the launches of each main path, the rows
    against the plain CPU path (at or above ``floor``, phase 4's), and
    captions/s beside the bf16 beam, interleaved."""
    out, problems = {}, []
    cfg = cap.cfg
    cap8 = Captioner(replaced(cfg, "decode", int8_vocab_projection=True),
                     cap.model, cap.dataset, cap.device)
    launches, _, steps, first, _ = beam_main_path(cap8, trials)
    if launches != counts(beam_core=steps, topk_project_int8=steps):
        problems.append(f"int8 beam: launches {launches} for {steps} steps")
    rows = rows_vs_cpu(cap8, trials, K, pool=False)
    with torch.inference_mode():
        st = tile_recurrent(cap.model.init_state(
            torch.tensor(trials[0], device="cuda")), K)
        fused = _build.counted(lambda: beam_decode(
            fused_beam_step(beam_weights(cap8), K), st, batch=B,
            max_len=cfg.decode.max_len, beam_width=K,
            early_exit=True)[0])[0]
    if not np.array_equal(fused.cpu().numpy(), first):
        problems.append("the int8 Captioner decode differs from the fused "
                        "int8 beam_decode")
    flips = float((first != cap.decode_batch(trials[0], beam_width=K)).any(
        1).mean())
    out["int8"] = dict(launches=launches, steps=steps,
                       identical_rows_vs_cpu_plain=rows,
                       rows_flipped_vs_bf16=flips)
    if float(np.mean(rows)) < floor:
        problems.append(f"int8 beam: {rows} of the rows identical to the "
                        f"plain CPU path, below {floor}")

    eos_model, raise_by = eos_raised_model(cap, trials[0], K + 1, 0.3)
    pools = {"lp0.6": replaced(cfg, "decode", length_penalty=0.6),
             "finished_pool=on": replaced(cfg, "decode", finished_pool="on")}
    walls_caps = {"bf16 beam": cap, "int8 beam": cap8}
    for name, pcfg in pools.items():
        pc = Captioner(pcfg, eos_model, cap.dataset, cap.device)
        launches, by_k, steps, _, nb = beam_main_path(pc, trials, True)
        finished = float((nb == EOS).any(2).any(1).mean())
        if launches != counts(beam_core=steps, topk_project=steps) or \
                by_k != {K + 1: steps}:
            problems.append(f"pool {name}: launches {launches}, K2 by K "
                            f"{by_k} for {steps} steps")
        if nb.shape != (B, K, cfg.decode.max_len) or not 0 < finished:
            problems.append(f"pool {name}: nbest {nb.shape}, {finished} of "
                            "the videos with a finished hypothesis")
        rows = rows_vs_cpu(pc, trials[:1], K + 1, pool=True)
        if rows[0] < floor:
            problems.append(f"pool {name}: {rows} of the rows identical to "
                            f"the plain CPU path, below {floor}")
        out[name] = dict(launches=launches, k2_launches_by_k=by_k,
                         steps=steps, identical_rows_vs_cpu_plain=rows,
                         videos_with_a_finished_hypothesis=finished,
                         eos_bias_raised_by=raise_by)
        walls_caps[f"pool {name}"] = pc
    out["captions_per_s"] = decode_walls(walls_caps, trials, beam_width=K)
    return out, problems


def replay_greedy(cap, cpu, f, toks):
    """The same decoder on the CPU fed the card's greedy tokens ``toks``:
    at each live step, the CPU's pick against the card's where the CPU's
    top-2 margin exceeds K3_LOGIT_TOL, and |card logit − CPU logit| from
    the card's own step on the same tokens. Returns (picks that differ
    where the margin is clear, clear steps, live steps, max |Δ logit|)."""
    toks = torch.as_tensor(toks).long()
    n = f.shape[0]
    bad = clear = live_steps = 0
    worst = 0.0
    with torch.inference_mode():
        sc = cap.model.init_state(torch.tensor(f, device="cuda"))
        sp = cpu.model.init_state(torch.tensor(f))
        prev = torch.full((n,), BOS, dtype=torch.long)
        live = torch.ones(n, dtype=torch.bool)
        for t in range(toks.shape[1]):
            if not live.any():
                break
            sc, lc = cap.model.decoder.step(sc, prev.cuda())
            sp, lp = cpu.model.decoder.step(sp, prev)
            top2 = lp.topk(2, -1).values
            sure = live & (top2[:, 0] - top2[:, 1] > K3_LOGIT_TOL)
            bad += int(((lp.argmax(-1) != toks[:, t]) & sure).sum())
            clear += int(sure.sum())
            live_steps += int(live.sum())
            worst = max(worst, (lc.cpu() - lp)[live].abs().max().item())
            live = live & (toks[:, t] != EOS)
            prev = toks[:, t]
    return bad, clear, live_steps, worst


def checked_module_beam(cap, cpu, f):
    """The card's beam-5 of a module decoder, each step checked against the
    same step on the CPU from the same state and tokens: h and c within
    K1_TOL, the top-K log-probs within K3_LOGIT_TOL, and the top-K columns
    equal where the CPU's K-th and (K+1)-th are further apart than that.
    Returns (the tokens, steps where the columns differ on a clear row,
    clear rows, rows, max |Δ h, c|, max |Δ logp|); its launches are taken
    back out of the counts."""
    kproj = cap._vocab_proj
    pproj = KernelWeights(cpu.model.decoder).projection(decoding.route(
        cpu.model.decoder, cpu.cfg.decode, "beam", K, T, "cpu"))
    kstep = module_beam_step(cap.model, K, kproj)
    pdec = cpu.model.decoder
    tally = dict(bad=0, clear=0, rows=0, h_c=0.0, logp=0.0)

    def step(st, tok):
        st_k, lk, ik = kstep(st, tok)
        st_p, h_p = pdec.step_beam_hidden(moved(st, "cpu"), tok.cpu(), K)
        lp, ip = pproj.topk(h_p, K + 1)
        tally["h_c"] = max(tally["h_c"],
                           (st_k.h.cpu() - st_p.h).abs().max().item(),
                           (st_k.c.cpu() - st_p.c).abs().max().item())
        sure = lp[:, K - 1] - lp[:, K] > K3_LOGIT_TOL
        same = (ik.cpu().sort(1).values == ip[:, :K].sort(1).values).all(1)
        tally["bad"] += int((~same & sure).sum())
        tally["clear"] += int(sure.sum())
        tally["rows"] += sure.numel()
        d = (lk.cpu() - lp[:, :K]).abs()[same]
        tally["logp"] = max(tally["logp"], d.max().item() if d.numel()
                            else 0.0)
        return st_k, lk, ik

    def run():
        with torch.inference_mode():
            st = tile_recurrent(cap.model.init_state(
                torch.tensor(f, device="cuda")), K)
            return beam_decode(step, st, batch=f.shape[0],
                               max_len=cap.cfg.decode.max_len, beam_width=K,
                               early_exit=cap.cfg.decode.early_exit)[0]
    toks = _build.counted(run)[0]
    return (toks.cpu().numpy(), tally["bad"], tally["clear"], tally["rows"],
            tally["h_c"], tally["logp"])


def phase_other_decoders(k3_floor: float):
    """(d) the decoders no kernel covers at msvd_greedy's width, B=32,
    seeded weights, N(0,1) features: greedy and beam-5 on the card, K1 and
    K3 never launched, K2 once a beam step for bf16 weights and no kernel
    for the f32 beam; each held to the same decoder on the CPU step by
    step along the card's own tokens (greedy: the picks where the CPU's
    top-2 margin is clear; beam: h/c, the top-K and its columns, as phase
    4 holds K1/K2; random weights leave few beam rows whose K-th and
    (K+1)-th candidates are further apart than the tolerance, so the
    columns are compared on those and the values on every row whose
    columns agree); ms a decode (medians of 3 inputs).

    The rows identical to the CPU's own decode, over the 3 inputs, are
    held to a floor. For f32 it is phase 6's (``k3_floor``). A bf16 decoder
    on the card rounds to bf16 where the CPU does and sums its f32 products
    in another order, a smaller change than leaving bf16 out; its witness
    is that change: the share of rows the CPU's bf16 decode keeps
    identical to the CPU's decode of the same weights in f32. Its floor is
    that share less ROW_SLACK, or phase 6's where that is lower."""
    out, problems = {}, []
    g = np.random.default_rng(161)
    trials = [g.normal(size=(BG, T, D)).astype(np.float32) for _ in range(3)]
    ids = [f"video{i}" for i in range(BG)]
    base = get_preset("msvd_greedy")
    for name, over in OTHER_DECODERS:
        cfg = replaced(base, "model", **over)
        ds = CaptionDataset(trials[0], ids, {v: [] for v in ids}, cfg.data,
                            vocab=vocab_of(VOCAB_G))
        cap = Captioner.from_checkpoint(cfg, ds)
        cpu = Captioner(cfg, copy.deepcopy(cap.model).cpu(), ds,
                        torch.device("cpu"))
        cpu32 = None
        if cfg.model.compute_dtype == "bfloat16":
            cfg32 = replaced(cfg, "model", compute_dtype="float32")
            m32 = create_model(cfg32, vocab_size=ds.vocab.size)
            m32.load_state_dict(cpu.model.state_dict())
            cpu32 = Captioner(cfg32, m32.eval(), ds, torch.device("cpu"))
        row = {}
        for method in ("greedy", "beam"):
            _build.reset_counts()
            cap.decode_steps = 0
            cap.decode_batch(trials[0], method=method, beam_width=K)
            walls, outs = [], []
            for f in trials:
                t0 = time.perf_counter()
                outs.append(cap.decode_batch(f, method=method, beam_width=K))
                walls.append((time.perf_counter() - t0) * 1e3)
            launches, steps = dict(_build.launch_counts), cap.decode_steps
            want = counts(topk_project=steps if method == "beam"
                          and cfg.model.compute_dtype == "bfloat16" else 0)
            if launches != want:
                problems.append(f"{name} {method}: launches {launches}, "
                                f"want {want}")
            ref = [cpu.decode_batch(f, method=method, beam_width=K)
                   for f in trials]
            same = [float((o == r).all(1).mean()) for o, r in zip(outs, ref)]
            agree = dict(identical_rows_vs_cpu=same)
            floor = k3_floor
            if cpu32 is not None:
                f32 = [cpu32.decode_batch(f, method=method, beam_width=K)
                       for f in trials]
                agree.update(
                    witness_cpu_bf16_vs_cpu_f32=[
                        float((r == e).all(1).mean())
                        for r, e in zip(ref, f32)],
                    card_vs_cpu_f32=[float((o == e).all(1).mean())
                                     for o, e in zip(outs, f32)])
                floor = min(k3_floor, float(np.mean(
                    agree["witness_cpu_bf16_vs_cpu_f32"])) - ROW_SLACK)
            agree["floor"] = floor
            if float(np.mean(same)) < floor:
                problems.append(f"{name} {method}: rows identical to the "
                                f"CPU's {same}, below {floor}: {agree}")
            if method == "greedy":
                checks = [replay_greedy(cap, cpu, f, o)
                          for f, o in zip(trials, outs)]
                bad, clear, live = (sum(c[i] for c in checks)
                                    for i in range(3))
                worst = max(c[3] for c in checks)
                step_check = dict(picks_differing_where_clear=bad,
                                  clear_steps=clear, live_steps=live,
                                  max_abs_logit_diff=worst)
                if bad or clear < 0.1 * live:
                    problems.append(f"{name} greedy vs the CPU step by "
                                    f"step: {step_check}")
            else:
                toks, bad, clear, rows, h_c, logp = checked_module_beam(
                    cap, cpu, trials[0])
                step_check = dict(columns_differing_where_clear=bad,
                                  clear_rows=clear, rows=rows,
                                  max_abs_h_c_diff=h_c,
                                  max_abs_logp_diff=logp)
                if not np.array_equal(toks, outs[0]):
                    problems.append(f"{name}: the checked beam differs from "
                                    "the Captioner's")
                if bad or h_c > K1_TOL or logp > K3_LOGIT_TOL:
                    problems.append(f"{name} beam vs the CPU step by step: "
                                    f"{step_check}")
            row[method] = dict(ms_a_decode=float(np.median(walls)),
                               launches=launches, steps=steps, **agree,
                               step_by_step=step_check)
        out[name] = row
    return out, problems


def phase_scst_two_layers(ds):
    """(e) a two-layer SCST step at scst_cider's width (B=32) on phase 9's
    corpus: the captured step against the eager body from the same init and
    seeds, DISPATCH_STEPS steps (bit for bit where two eager runs are, else
    within twice their difference, phase 14's rule), no kernel launched;
    ms a step, eager and captured."""
    cfg = replaced(get_preset("scst_cider"), "model", num_lstm_layers=2)
    init = init_params(create_model(cfg, VOCAB_G),
                       cfg.train.seed).cuda().state_dict()
    tables = tables_from_dataset(ds).to("cuda")
    setup = lambda stage, accum: stage_setup(cfg, init, tables, stage, accum)
    it = DeterministicBatcher(ds, BG, seed=0)
    batches = [batch_to_device_dict(next(it)) for _ in range(DISPATCH_STEPS)]
    seeds = torch.randint(0, 2**31 - 1, (DISPATCH_STEPS, 1),
                          generator=torch.Generator().manual_seed(16))
    _build.reset_counts()
    runs = [run_eager(setup, "scst", 1, batches, seeds) for _ in range(2)]
    floor = parting(*runs)
    state, body = setup("scst", 1)
    fn = make_step(body, "cuda")
    rec = {}
    for j, d in enumerate(chunks(batches, seeds, 1, False)):
        state, m = fn(state, d)
        rec.update({f"step {j + 1} {key}": v.clone() for key, v in m.items()})
    torch.cuda.synchronize()
    rec.update(state_of(state))
    capt = parting(runs[0], rec)
    walls = {}
    for how in ("eager", "captured"):
        state, body = setup("scst", 1)
        step = body if how == "eager" else make_step(body, "cuda")
        w = []
        for i in range(6):
            b = batches[i % DISPATCH_STEPS]
            d = ({k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
                 if how == "eager" else dict(b))
            d["seed"] = seeds[i % DISPATCH_STEPS]
            t0 = time.perf_counter()
            state, _ = step(state, d)
            torch.cuda.synchronize()
            if i:
                w.append((time.perf_counter() - t0) * 1e3)
        walls[how] = float(np.median(w))
    launches = dict(_build.launch_counts)
    out = dict(eager_vs_eager=floor[0], captured_vs_eager=capt[0],
               captured_parts_at=capt[1], limit=2 * floor[0],
               ms_a_step=walls, launches=launches,
               loss=[rec[f"step {j + 1} loss"].item()
                     for j in range(DISPATCH_STEPS)])
    problems = []
    if capt[0] > 2 * floor[0] or rec["count"].item() != DISPATCH_STEPS:
        problems.append(f"two-layer SCST captured vs eager: {out}")
    if launches != counts():
        problems.append(f"two-layer SCST launched {launches}")
    return out, problems


def phase_cli_decode_surface(tmp: str):
    """(f) the CLI, all at once: ``info --preset msrvtt_attn_beam5 --json``
    (the card's name and memory, the census), ``caption --set
    decode.int8_vocab_projection=true`` (K1 = K2-int8 = steps), ``caption
    --set decode.length_penalty=0.6 --nbest 3`` (K1 = K2 = steps, three
    captions a video) and ``export`` of an int8 beam artifact at B=32;
    then ``caption --from-export`` of it, equal to the in-process int8
    decode of the same split in batches of 32."""
    preset = "msrvtt_attn_beam5"
    cfg = get_preset(preset)
    weights = os.path.join(tmp, "w16.npz")
    save_weights(init_params(create_model(cfg, VP), cfg.train.seed), weights)
    int8 = ["--set", "decode.int8_vocab_projection=true"]
    src = ["--preset", preset, "--weights", weights]
    pipes = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    art = os.path.join(tmp, "art_int8")

    def finish(procs):
        res = {}
        for name, p in procs.items():
            try:
                o, e = p.communicate(timeout=600)
            finally:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            if p.returncode != 0:
                fail(f"phase 16 {name} exited {p.returncode}: {e[-3000:]}")
            res[name] = (o, e)
        return res

    t0 = time.perf_counter()
    res = finish({
        "info": port_proc(["info", "--preset", preset, "--json"], tmp,
                          **pipes),
        "caption int8": port_proc(["caption", *src, *int8, "--out",
                                   "int8.json"], tmp, **pipes),
        "caption lp0.6 nbest3": port_proc(
            ["caption", *src, "--set", "decode.length_penalty=0.6",
             "--nbest", "3", "--out", "pool.json"], tmp, **pipes),
        "export int8": port_proc(["export", *src, *int8, "--batch", "32",
                                  "--out", art], tmp, **pipes)})
    res.update(finish({"caption --from-export int8": port_proc(
        ["caption", "--preset", preset, "--from-export", art, "--out",
         "exported.json"], tmp, **pipes)}))
    wall = time.perf_counter() - t0
    problems, out = [], dict(cli_wall_s=wall)
    info = json.loads(res["info"][0])
    props = torch.cuda.get_device_properties(0)
    b = info.get("backend", {})
    if b.get("device_kind") != torch.cuda.get_device_name(0) or \
            b.get("total_memory_bytes") != props.total_memory or \
            info["params"] != param_census(cfg):
        problems.append(f"info: backend {b}, params {info['params']}")
    out["info"] = dict(backend=b, params=info["params"])
    read = lambda f: json.load(open(os.path.join(tmp, f)))
    for name, f, kernel, nbest in (
            ("caption int8", "int8.json", "topk_project_int8", 1),
            ("caption lp0.6 nbest3", "pool.json", "topk_project", 3),
            ("caption --from-export int8", "exported.json",
             "topk_project_int8", 1)):
        method, decodes, steps, launches, _ = launch_line(res[name][1], name)
        caps = read(f)
        if method != "beam" or steps < 1 or launches != counts(
                beam_core=steps, **{kernel: steps}) or not caps or not all(
                len(c) == nbest for c in caps.values()):
            problems.append(f"{name}: {method}, {steps} steps, launches "
                            f"{launches}, {len(caps)} videos")
        out[name] = dict(decodes=decodes, steps=steps, launches=launches,
                         videos=len(caps))
    cfg8 = replaced(cfg, "decode", int8_vocab_projection=True)
    ds = CaptionDataset.synthetic(cfg8.data)
    live = Captioner.from_checkpoint(cfg8, ds, weights=weights)
    want = _build.counted(lambda: live.caption_dataset(
        method="beam", beam_width=K, batch_size=SERVE_B))[0]
    if read("exported.json") != want:
        problems.append("caption --from-export of the int8 artifact differs "
                        "from the in-process int8 decode")
    out["exported_equals_live"] = read("exported.json") == want
    return out, problems


def phase_decode_surface(cap, trials, beam_floor, k3_floor, ds):
    """Phase 16: (a)-(f); returns (the K2-int8 kernel line, the readings,
    the launches of the main paths by kernel)."""
    t0 = time.perf_counter()
    k28, k28_out = phase_k2_int8()
    out, problems = {"k2_int8": k28_out}, []
    for key, fn in (("beams", lambda: phase_beam_variants(
                        cap, trials, beam_floor)),
                    ("other_decoders", lambda: phase_other_decoders(
                        k3_floor)),
                    ("scst_two_layers", lambda: phase_scst_two_layers(ds))):
        t1 = time.perf_counter()
        out[key], p = fn()
        out[key + "_s"] = time.perf_counter() - t1
        problems += p
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        out["cli"], p = phase_cli_decode_surface(tmp)
        out["cli_s"] = time.perf_counter() - t1
        problems += p
    out["seconds"] = time.perf_counter() - t0
    if problems:
        fail("phase 16: " + "; ".join(problems) + " | "
             + json.dumps({**out, "k2_int8_kernel": k28}, default=str))
    launched = {k: 0 for k in _build.KERNELS}
    for lc in ([out["beams"][n]["launches"] for n in
                ("int8", "lp0.6", "finished_pool=on")]
               + [r[m]["launches"] for r in out["other_decoders"].values()
                  for m in ("greedy", "beam")]
               + [out["cli"][n]["launches"] for n in (
                   "caption int8", "caption lp0.6 nbest3",
                   "caption --from-export int8")]):
        for k, n in lc.items():
            launched[k] += n
    return k28, out, launched


def phase16_line(card, cap, trials, e2e, k3_floor, ds):
    """Runs phase 16 and prints its line: (the K2-int8 kernel line, the
    main paths' launches by kernel)."""
    beam_floor = min(e2e["identical_rows_plain_cpu_vs_card_by_trial"]) \
        - ROW_SLACK
    k28, out, launched = phase_decode_surface(cap, trials, beam_floor,
                                              k3_floor, ds)
    print(f"phase 16 the rest of the decode surface (K2-int8 N={B * K} "
          f"H={H} Vp={VP}; int8 and pool beams B={B}; other decoders and "
          f"two-layer SCST B={BG}; the CLI) on {card}: " + json.dumps(
              {**out, "k2_int8_kernel": k28, "row_floors": {
                  "beam": beam_floor, "k3": k3_floor}, "tolerance": {
                  "k2_int8": "h8/hscale bit for bit; columns equal where "
                  "the K-th and (K+1)-th logits are more than one bf16 ulp "
                  "apart; values within one bf16 ulp of the row's largest "
                  "|logit| + 1e-4; two runs identical",
                  "other_decoders": "vs the CPU step by step along the "
                  "card's tokens: greedy picks equal where the CPU's top-2 "
                  f"margin > {K3_LOGIT_TOL}; beam h/c within {K1_TOL}, "
                  f"top-K logp within {K3_LOGIT_TOL}, columns equal where "
                  "the K-th and (K+1)-th are further apart; rows identical "
                  "to the CPU's decode >= phase 6's floor (f32), else the "
                  "share the CPU's bf16 decode keeps of its f32 decode "
                  f"less {ROW_SLACK} where lower",
                  "captured_vs_eager": "equal where two eager runs are, "
                  "else 2x their max |diff|"}}), flush=True)
    return k28, launched


# Phase 17: more than one GPU, run here at a world of one over NCCL (the
# four-card readings come from scripts/torch_sharded_check.py, which runs
# (a) and (b) on every visible card): (a) the sharded XE (banked) and SCST
# steps at scst_cider width, B=32 a step, captured; (b) the sharded beam at
# msrvtt_attn_beam5 width, B=184, and greedy at msvd_greedy width, B=32;
# (c) dropout in the captured XE step; (d) the shapes the kernels refuse.
SHARD_STEPS = 4      # steps compared in (a)
SHARD_TIMED = 10     # steps timed in (a), after them
SHARD_DECODES = 3    # decodes timed in (b)
DROP_P = 0.5         # (c)
# (d): (name, decode fields, model fields, method, beam width)
REFUSED = (("beam 9", {}, {}, "beam", 9),
           ("pool beam 8", {"finished_pool": "on"}, {}, "beam", 8),
           ("hidden 1024 beam, K1 refuses, K2 streamed", {},
            {"hidden_dim": 1024}, "beam", K),
           ("hidden 1024 greedy", {}, {"hidden_dim": 1024}, "greedy", K),
           ("hidden 1024 int8 beam", {"int8_vocab_projection": True},
            {"hidden_dim": 1024}, "beam", K))
REFUSED_CPU_ROWS = 32   # (d): the rows held to the CPU
RANK_BLOCKS = 4         # (b): a rank's block of the four-card mesh's rows


def sharded_corpus():
    """(a)'s corpus at scst_cider width: 64 videos of N(0,1) features, 5
    captions each (phase 14's generator)."""
    cfg = get_preset("scst_cider")
    return cfg, bank_corpus(cfg, 64, np.random.default_rng(17))


def sharded_steps(mesh, stage: str):
    """(a): SHARD_STEPS + SHARD_TIMED captured steps of ``stage`` (XE
    banked, SCST unbanked) at scst_cider width from the seeded init, B=32 a
    step (this rank's rows on ``mesh``; one card without one). Returns the
    compared steps' losses and the state after them (the seam's shards
    gathered), K3's launches in them, and the timed steps' ms a step."""
    from vidcap_tpu_torch.parallel.sharding import (full_tensors,
                                                    make_sharded_banked_step,
                                                    make_sharded_step,
                                                    place_state, shard_batch)
    cfg, ds = sharded_corpus()
    cfg = replaced(cfg, "train", stage=stage)
    dev = mesh.device if mesh is not None else torch.device("cuda")
    state = create_train_state(cfg, init_params(create_model(
        cfg, VOCAB_G), cfg.train.seed).to(dev))
    body = (make_xe_step_body(cfg) if stage == "xe"
            else make_scst_step_body(cfg, ds))
    bank = stage == "xe"
    if mesh is None:
        fn = make_banked_step(body, ds, device=dev)[0] if bank else \
            make_step(body, dev)
    else:
        if bank:
            fn, _, dp = make_sharded_banked_step(mesh, body, ds)
        else:
            fn, dp = make_sharded_step(mesh, body)
        place_state(state, mesh, dp)
    it = DeterministicBatcher(ds, BG, seed=0)

    def batch():
        b = batch_to_device_dict(next(it), bank)
        return shard_batch(b, mesh) if mesh is not None else b
    _build.reset_counts()
    losses = []
    for _ in range(SHARD_STEPS):
        state, m = fn(state, batch())
        losses.append(m["loss"].clone())
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    full = full_tensors(state, mesh) if mesh is not None else None
    params = full[0] if full is not None else state.params
    out = {"loss": torch.stack(losses).cpu(),
           "state": {k: p.detach().cpu().clone() for k, p in params.items()},
           "launches": launches, "captured": fn.graph is not None}
    batches = [batch() for _ in range(SHARD_TIMED)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        state, m = fn(state, b)
    torch.cuda.synchronize()
    out["ms_a_step"] = (time.perf_counter() - t0) * 1e3 / SHARD_TIMED
    return out


def sharded_decode_setup():
    """(b)'s captioner configurations and inputs: (name, preset, vocab,
    method, the inputs)."""
    g = np.random.default_rng(171)
    return (("beam B=184", "msrvtt_attn_beam5", VP, "beam",
             [g.normal(size=(B, T, D)).astype(np.float32)
              for _ in range(SHARD_DECODES)]),
            ("greedy B=32", "msvd_greedy", VOCAB_G, "greedy",
             [g.normal(size=(BG, T, D)).astype(np.float32)
              for _ in range(SHARD_DECODES)]))


def sharded_decodes(mesh, blocks: int = 1):
    """(b): each decode of :func:`sharded_decode_setup` through
    ``Captioner(mesh)`` (one card without one) on the seeded weights: the
    tokens, captions/s (the median of the timed decodes after a warm-up)
    and the launches of the timed decodes. ``blocks`` > 1 (one card):
    each input decoded as that many equal row blocks, as the ranks of a
    data axis of that size decode it (the projections choose their
    kernels and K2 its vocab split by the row count)."""
    out = {}
    for name, preset, vocab, method, inputs in sharded_decode_setup():
        cfg = get_preset(preset)
        ids = [f"video{i}" for i in range(inputs[0].shape[0])]
        ds = CaptionDataset(inputs[0], ids, {v: [] for v in ids}, cfg.data,
                            vocab=vocab_of(vocab))
        cap = Captioner.from_checkpoint(cfg, ds, mesh=mesh)
        cap.decode_batch(inputs[0], method=method, beam_width=K)
        _build.reset_counts()
        toks, walls = [], []
        for f in inputs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks.append(np.concatenate([
                cap.decode_batch(x, method=method, beam_width=K)
                for x in np.split(f, blocks)]))
            walls.append(time.perf_counter() - t0)
        out[name] = dict(tokens=toks, launches=dict(_build.launch_counts),
                         captions_per_s=inputs[0].shape[0]
                         / float(np.median(walls)),
                         kernels=cap.kernels(method, K))
    return out


def sharded_dropout():
    """(c): dropout p=DROP_P at scst_cider width: the keep share of both
    sites' masks on the card (4 seeds, [32, E+H] and [32, H]) within 4σ of
    1−p; the captured XE step's second replay at seed 2 against the eager
    body's second step at seed 2 (equal where two eager runs are, else
    within twice their difference), and not the replay at seed 1 again."""
    from vidcap_tpu_torch.models.decoder import Dropout
    cfg, ds = sharded_corpus()
    cfg = replaced(cfg, "model", dropout_rate=DROP_P)
    kept = n = 0
    for seed in range(1, 5):
        for site, width in ((0, E + H), (1, H)):
            m = Dropout(DROP_P, seed).mask(BG, width, site, "cuda")
            kept += int(m.sum())
            n += m.numel()
    share = kept / n
    sigma = (DROP_P * (1 - DROP_P) / n) ** 0.5
    it = DeterministicBatcher(ds, BG, seed=0)
    batches = [batch_to_device_dict(next(it)) for _ in range(2)]
    second = {}
    for run, how, seeds in ((0, "eager", (1, 2)), (1, "eager", (1, 2)),
                            (2, "captured", (1, 2)), (3, "captured", (1, 1))):
        state = create_train_state(cfg, init_params(create_model(
            cfg, VOCAB_G), cfg.train.seed).cuda())
        body = make_xe_step_body(cfg)
        fn = make_step(body, "cuda")
        for b, seed in zip(batches, seeds):
            d = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
            d["seed"] = torch.tensor([seed], device="cuda")
            state, m = body(state, d) if how == "eager" else fn(state, d)
        second[run] = float(m["xe_loss"])
    floor = abs(second[0] - second[1])
    out = dict(keep_share=share, want=1 - DROP_P, sigma=sigma,
               xe_loss_second_step={"eager": second[0], "eager_again":
                                    second[1], "captured_seeds_1_2":
                                    second[2], "captured_seeds_1_1":
                                    second[3]})
    problems = []
    if abs(share - (1 - DROP_P)) > 4 * sigma:
        problems.append(f"dropout keep share {share}")
    if abs(second[2] - second[0]) > 2 * floor:
        problems.append(f"captured dropout step vs eager: {out}")
    if second[3] == second[2]:
        problems.append(f"a new seed drew the same masks: {out}")
    return out, problems


def refused_shapes(beam_floor: float):
    """(d): each shape of :data:`REFUSED` at msrvtt_attn_beam5's width on
    B=184 N(0,1) inputs with seeded weights: the decode does not raise and
    launches what ``Captioner.kernels`` names (every other count 0; a
    beam's kernels once a step); its
    first REFUSED_CPU_ROWS rows are held to the CPU's decode under phase 16
    (d)'s rules (floor: the share the CPU's bf16 decode keeps of its f32
    decode less ROW_SLACK, or ``beam_floor`` where lower); ms a decode."""
    base = get_preset("msrvtt_attn_beam5")
    f = np.random.default_rng(172).normal(size=(B, T, D)).astype(np.float32)
    ids = [f"video{i}" for i in range(B)]
    out, problems, launched = {}, [], {k: 0 for k in _build.KERNELS}
    for name, dec, model, method, beam in REFUSED:
        cfg = replaced(replaced(base, "decode", **dec), "model", **model)
        ds = CaptionDataset(f, ids, {v: [] for v in ids}, cfg.data,
                            vocab=vocab_of(VP))
        cap = Captioner.from_checkpoint(cfg, ds)
        kernels = cap.kernels(method, beam)
        cap.decode_batch(f, method=method, beam_width=beam)   # warm-up
        _build.reset_counts()
        cap.decode_steps = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = cap.decode_batch(f, method=method, beam_width=beam)
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_build.launch_counts)
        for k, n in launches.items():
            launched[k] += n
            once = method != "beam" or n == cap.decode_steps
            if (n > 0) != (k in kernels) or (k in kernels and not once):
                problems.append(f"{name}: launches {launches}, kernels "
                                f"{kernels}, {cap.decode_steps} steps")
        held = held_to_cpu(cap, f[:REFUSED_CPU_ROWS],
                           toks[:REFUSED_CPU_ROWS], method, beam, beam_floor)
        out[name] = dict(kernels=list(kernels), launches=launches,
                         decode_steps=cap.decode_steps, ms_a_decode=ms,
                         captions_per_s=B / ms * 1e3, **held)
        if toks.shape != (B, cfg.decode.max_len) or \
                held["identical_rows_vs_cpu"] < held["floor"]:
            problems.append(f"{name}: {out[name]}")
    return out, problems, launched


def held_to_cpu(cap, rows, toks, method: str, beam: int,
                beam_floor: float) -> dict:
    """Phase 16 (d)'s rule: ``toks``, the card's decode of ``rows``,
    against the CPU's decode of the same rows with the same weights (the
    plain path): the share of identical rows, its witness (the share the
    CPU's bf16 decode keeps of its f32 decode) and the floor it must reach
    (the witness less ROW_SLACK, or ``beam_floor`` where lower)."""
    cfg, ds = cap.cfg, cap.dataset
    cpu = Captioner(cfg, copy.deepcopy(cap.model).cpu(), ds,
                    torch.device("cpu"))
    cfg32 = replaced(cfg, "model", compute_dtype="float32")
    m32 = create_model(cfg32, vocab_size=cap.model.vocab_size)
    m32.load_state_dict(cpu.model.state_dict())
    cpu32 = Captioner(cfg32, m32.eval(), ds, torch.device("cpu"))
    ref = cpu.decode_batch(rows, method=method, beam_width=beam)
    ref32 = cpu32.decode_batch(rows, method=method, beam_width=beam)
    witness = float((ref == ref32).all(1).mean())
    return dict(identical_rows_vs_cpu=float((toks == ref).all(1).mean()),
                witness_cpu_bf16_vs_cpu_f32=witness,
                floor=min(beam_floor, witness - ROW_SLACK))


def rank_blocks_vs_cpu(beam_floor: float):
    """(b) at a rank's shape: the first 1/RANK_BLOCKS of (b)'s first input
    (46 beam rows, 8 greedy rows: what a rank of the four-card mesh
    decodes) through one card's route, held to the CPU's decode under
    :func:`held_to_cpu`'s rule, with the launches."""
    out, problems = {}, []
    for name, preset, vocab, method, inputs in sharded_decode_setup():
        cfg = get_preset(preset)
        rows = inputs[0][:inputs[0].shape[0] // RANK_BLOCKS]
        ids = [f"video{i}" for i in range(rows.shape[0])]
        ds = CaptionDataset(rows, ids, {v: [] for v in ids}, cfg.data,
                            vocab=vocab_of(vocab))
        cap = Captioner.from_checkpoint(cfg, ds)
        _build.reset_counts()
        toks = cap.decode_batch(rows, method=method, beam_width=K)
        launches = dict(_build.launch_counts)
        held = held_to_cpu(cap, rows, toks, method, K, beam_floor)
        kernels = cap.kernels(method, K)
        out[f"{name} rows 0-{rows.shape[0] - 1}"] = r = dict(
            launches=launches, kernels=list(kernels), **held)
        if (held["identical_rows_vs_cpu"] < held["floor"]
                or any((n > 0) != (k in kernels)
                       for k, n in launches.items())):
            problems.append(f"(b) rank block {name}: {r}")
    return out, problems


def parted(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).abs().max().item()


def phase_sharded(beam_floor: float):
    """Phase 17 at a world of one over NCCL: (a) each stage's sharded
    captured step against the unsharded captured step run twice (bit for
    bit where those two are, else within twice their difference, phase
    14's rule; the loss and every parameter), K3 2 a SCST step, ms a step;
    (b) the sharded decodes identical to the one-card decodes, captions/s;
    (c); (d). Returns (the readings, the launches of the sharded runs and
    of (d) by kernel)."""
    from vidcap_tpu_torch.parallel import distributed
    from vidcap_tpu_torch.parallel.mesh import make_mesh
    t0 = time.perf_counter()
    distributed.init_group("cuda:0")
    out, problems = {}, []
    launched = {k: 0 for k in _build.KERNELS}
    try:
        mesh = make_mesh(None)
        for stage in ("xe", "scst"):
            one = [sharded_steps(None, stage) for _ in range(2)]
            sh = sharded_steps(mesh, stage)
            floor = max([parted(one[0]["loss"], one[1]["loss"])]
                        + [parted(one[0]["state"][k], one[1]["state"][k])
                           for k in one[0]["state"]])
            worst = max([parted(one[0]["loss"], sh["loss"])]
                        + [parted(one[0]["state"][k], sh["state"][k])
                           for k in sh["state"]])
            k3 = sh["launches"]["rollout"]
            out[f"{stage} steps"] = dict(
                bit_for_bit=worst == 0.0, unsharded_twice_max_diff=floor,
                sharded_vs_unsharded_max_diff=worst,
                loss=sh["loss"].tolist(), k3_launches=k3,
                captured=sh["captured"], ms_a_step_sharded=sh["ms_a_step"],
                ms_a_step_one_card=[o["ms_a_step"] for o in one])
            for k, n in sh["launches"].items():
                launched[k] += n
            want = 2 * SHARD_STEPS if stage == "scst" else 0
            if worst > 2 * floor or k3 != want or not sh["captured"]:
                problems.append(f"(a) {stage}: {out[f'{stage} steps']}")
        t1 = time.perf_counter()
        one, sh = sharded_decodes(None), sharded_decodes(mesh)
        for name in one:
            same = all(np.array_equal(a, b) for a, b in
                       zip(one[name]["tokens"], sh[name]["tokens"]))
            out[name] = dict(identical_to_one_card=same,
                             launches=sh[name]["launches"],
                             kernels=list(sh[name]["kernels"]),
                             captions_per_s_sharded=sh[name][
                                 "captions_per_s"],
                             captions_per_s_one_card=one[name][
                                 "captions_per_s"])
            for k, n in sh[name]["launches"].items():
                launched[k] += n
                if (n > 0) != (k in sh[name]["kernels"]):
                    problems.append(f"(b) {name}: {out[name]}")
            if not same:
                problems.append(f"(b) {name}: tokens differ from one card")
        t2 = time.perf_counter()
    finally:
        distributed.shutdown()
    out["rank blocks vs cpu"], p = rank_blocks_vs_cpu(beam_floor)
    problems += p
    t3 = time.perf_counter()
    out["dropout"], p = sharded_dropout()
    problems += p
    out["refused shapes"], p, lc = refused_shapes(beam_floor)
    problems += p
    for k, n in lc.items():
        launched[k] += n
    out["seconds"] = dict(steps=t1 - t0, decodes=t2 - t1,
                          rank_blocks_and_dropout=t3 - t2,
                          refused=time.perf_counter() - t3)
    if problems:
        fail("phase 17: " + "; ".join(problems) + " | "
             + json.dumps(out, default=str))
    return out, launched


# Phase 18: the SCST lift (scripts/torch_scst_lift.py, the reference's
# scripts/scst_lift_experiment.py): synthetic_tiny, batch 16, 40 XE steps,
# 300 SCST steps through the captured steps, greedy val CIDEr on 64
# held-out videos after each; the reference asserts a lift over 0.1.
LIFT_XE, LIFT_SCST, LIFT_MIN = 40, 300, 0.1


def phase_lift():
    """The lift on the card: (val CIDEr after XE, after SCST, the last
    reward_sample, K3's launches: 2 a SCST step plus the two validations'
    greedy decodes, one a batch), with the launches of the run."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_scst_lift as lift
    cfg = lift.lift_config(0)
    val_batches = -(-lift.VAL_VIDEOS // cfg.train.batch_size)
    t0 = time.perf_counter()
    # ---- the main path: counts at 0 just before, read just after
    _build.reset_counts()
    cider_xe, cider_scst, reward = lift.build(LIFT_XE, LIFT_SCST, seed=0,
                                              device="cuda")
    launches = dict(_build.launch_counts)
    want = counts(rollout=2 * LIFT_SCST + 2 * val_batches,
                  teacher_forced=2 * LIFT_XE + 4 * LIFT_SCST)
    out = dict(val_cider_xe=cider_xe, val_cider_scst=cider_scst,
               lift=cider_scst - cider_xe, final_reward_sample=reward,
               launches=launches, launches_expected=want,
               seconds=time.perf_counter() - t0)
    problems = []
    if not cider_scst > cider_xe + LIFT_MIN:
        problems.append(f"lift {cider_scst - cider_xe} <= {LIFT_MIN}")
    if launches != want:
        problems.append(f"launches {launches}, expected {want}")
    if not math.isfinite(reward):
        problems.append(f"reward_sample {reward}")
    if problems:
        fail("phase 18: " + "; ".join(problems) + " | " + json.dumps(out))
    return out


def tf_case(seed: int = 0):
    """scst_cider's decoder from the seeded init and one teacher-forced
    batch: (decoder, features f32[32, 26, 1536], inputs and targets
    i64[32, 30])."""
    cfg = get_preset("scst_cider")
    dec = init_params(create_model(cfg, VOCAB_G), seed).cuda().decoder
    g = np.random.default_rng(seed)
    cuda = lambda a, **k: torch.tensor(a, device="cuda", **k)
    return (dec, cuda(g.normal(size=(BG, T, D)), dtype=torch.float32),
            cuda(g.integers(len(SPECIALS), VOCAB_G, size=(BG, L))),
            cuda(g.integers(len(SPECIALS), VOCAB_G, size=(BG, L))))


def module_loop(dec, state, embs):
    """``CaptionDecoder.xe_logits``'s loop over the modules, off K4's
    route."""
    out = []
    for t in range(embs.shape[1]):
        state, logits = dec._step_from_emb(state, embs[:, t], sharded=True)
        out.append(logits)
    return torch.stack(out, 1)


def k4_on(fn):
    """K4's wrapper ``fn`` (or its plain version) as ``fn(dec, state,
    embs)``, on the decoder's parameters."""
    return lambda dec, state, embs: fn(KernelWeights(dec).teacher_forced(),
                                       dec.vocab_size, state, embs)


def tf_graph(dec, feats, toks, fn, backward: bool):
    """One CUDA graph of ``fn(dec, state, embs)`` on a copy of ``dec`` (its
    own gradient accumulators), from an encoded state and embeddings that
    are leaves, with the backward of a fixed cotangent when asked."""
    dec = copy.deepcopy(dec)
    with torch.no_grad():
        st = dec.init_state(feats)
        embs = dec.embed(toks)
    leaves = [x.detach().requires_grad_(backward)
              for x in (embs, st.h, st.c, st.keys, st.values)]
    state = DecoderState(leaves[1], leaves[2], leaves[3], leaves[4],
                         st.frame_mask)
    cot = torch.randn(BG, L, dec.padded_vocab, device="cuda")

    def run():
        with torch.set_grad_enabled(backward):
            logits = fn(dec, state, leaves[0])
            if backward:
                torch.autograd.grad(logits, leaves + list(dec.parameters()),
                                    cot, allow_unused=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        run()
    return graph


def tf_compare(dec, feats, toks, tgt, fn):
    """(logits, loss, the gradients of the features and each parameter) of
    a token-mean XE through ``fn``."""
    f = feats.clone().requires_grad_(True)
    logits = fn(dec, dec.init_state(f), dec.embed(toks))
    loss = -token_logp(logits, tgt).mean()
    return (logits.detach(), loss.item(),
            torch.autograd.grad(loss, [f] + list(dec.parameters())))


def phase_k4():
    """K4 at scst_cider's shape: kernel vs plain (the logits' max |error|,
    the loss, each leaf's gradient), then the forward and the forward +
    backward of the pass alone, each one CUDA graph, for the kernels, the
    plain version and the module loop, beside the bound (the f32 products
    at the f32 peak, or the bytes)."""
    dec, feats, toks, tgt = tf_case()
    _build.reset_counts()
    lk, sk, gk = tf_compare(dec, feats, toks, tgt, k4_on(teacher_forced))
    lp, sp, gp = tf_compare(dec, feats, toks, tgt,
                            k4_on(teacher_forced_plain))
    launches = _build.launch_counts["teacher_forced"]
    names = ["features"] + [n for n, _ in dec.named_parameters()]
    grad_err = {n: ((a - b).norm() / b.norm()).item()
                for n, a, b in zip(names, gk, gp)}
    live = lp > NEG / 2
    err = (lk - lp)[live].abs().max().item()
    logit_tol = 2 * bf16_ulp(lp[live].abs().max()).item()
    out = dict(max_abs_err=err, logit_tol=logit_tol,
               loss_rel_err=abs(sk - sp) / abs(sp),
               grad_rel_err_max=max(grad_err.values()), grad_rel_err=grad_err)
    for name, fn in (("", k4_on(teacher_forced)),
                     ("plain_", k4_on(teacher_forced_plain)),
                     ("loop_", module_loop)):
        f = time_ms(tf_graph(dec, feats, toks, fn, False).replay)
        fb = time_ms(tf_graph(dec, feats, toks, fn, True).replay)
        out[f"{name}fwd_ms"], out[f"{name}bwd_ms"] = f, fb - f
    Vp = dec.padded_vocab
    prods = H * A + (E + 2 * H) * 4 * H + H * Vp
    ops = 2 * BG * L * (prods + T * (A + H))
    weights = 4 * prods + 4 * (A + 4 * H + Vp)
    io = 2 * BG * T * (A + H) + 4 * BG * L * (E + Vp)
    for part, n_ops, n_bytes in (("fwd", ops, weights + io),
                                 ("bwd", 2 * ops, 2 * weights + 2 * io)):
        t_ops, t_bytes = n_ops / PEAK_F32, n_bytes / PEAK_BYTES
        out[f"bound_{part}_ms"] = max(t_ops, t_bytes) * 1e3
        out[f"bound_{part}_by"] = "operations" if t_ops >= t_bytes \
            else "bytes"
    out["launches"] = launches
    problems = []
    if launches != 2:
        problems.append(f"{launches} launches for one pass and its backward")
    if not err <= logit_tol:
        problems.append(f"logits {err} apart")
    if not out["loss_rel_err"] <= TF_LOSS_TOL:
        problems.append(f"loss {sk} vs {sp}")
    if not out["grad_rel_err_max"] <= TF_GRAD_TOL or not all(
            torch.isfinite(x).all() for x in gk):
        problems.append(f"gradients {grad_err}")
    if problems:
        fail("phase 20: " + "; ".join(problems) + " | " + json.dumps(out))
    return out


def print_k4(card: str) -> dict:
    k4 = phase_k4()
    print(f"phase 20 K4 teacher_forced B={BG} T={T} L={L} E=H=A={H} "
          f"Vp={VG} on {card}: " + json.dumps({**k4, "tolerance": {
              "logits": "two bf16 ulps of the largest |logit|",
              "loss": TF_LOSS_TOL, "gradients": TF_GRAD_TOL}}), flush=True)
    return k4


MOE_K, MOE_E, MOE_H, MOE_I = 6, 64, 2048, 1408   # Kimi-VL-A3B's experts
MOE_ROWS = (("decode", 5120), ("prefill", 26_624))  # 1,024 videos, beam 5


def moe_case(n: int, seed: int):
    """A router-like draw of ``n`` tokens at Kimi-VL-A3B's widths (top-6 of
    skewed scores), its weights, and random bf16 rows for each stage."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = dict(device="cuda", dtype=torch.bfloat16)
    scores = torch.rand(n, MOE_E, generator=g, device="cuda") \
        + torch.linspace(0, 0.3, MOE_E, device="cuda")
    sel = scores.topk(MOE_K, -1).indices
    w = torch.rand(n, MOE_K, generator=g, device="cuda") * 2.446
    x, shared, h = (torch.randn(n, MOE_H, generator=g, **bf)
                    for _ in range(3))
    y = torch.randn(n * MOE_K, MOE_H, generator=g, **bf)
    gate_up = torch.randn(n * MOE_K, 2 * MOE_I, generator=g, **bf) * 3
    return sel, w, x, y, gate_up, shared, h


def moe_layer_ms(n: int):
    """One Kimi-VL-A3B expert layer (router, dispatch, grouped products,
    shared experts, combine with the residual) on ``n`` rows with random
    weights: (K5's ms, the plain composition's ms)."""
    from vidcap_tpu_torch.models import lm_decoder as lm
    layer = lm.LMLayer(lm.KIMI_VL_A3B, 1, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(21)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device="cuda") * 0.02)
    x = torch.randn(n, MOE_H, generator=g, device="cuda").bfloat16()
    h = torch.randn(n, MOE_H, generator=g, device="cuda").bfloat16()
    run = lambda: layer.mlp(x, 1, h)
    with torch.no_grad():
        k5 = time_ms(run, iters=5)
        with k5_off():
            plain = time_ms(run, iters=5)
    return k5, plain


class k5_off:
    """Within it, K5's gate (``models/decoding.py::moe_kernels``, as the
    LM's modules look it up) takes nothing: the dispatch, every
    ``silu_mul`` and the combine run their plain versions."""

    def __enter__(self):
        from vidcap_tpu_torch.models import lm_decoder as lm
        self.lm, self.gate = lm, lm.moe_kernels
        lm.moe_kernels = lambda *a: ()

    def __exit__(self, *exc):
        self.lm.moe_kernels = self.gate


def phase_k5():
    """K5 at Kimi-VL-A3B's expert widths (k 6 of 64, H 2,048, I 1,408) on
    the decode's 5,120 rows and the prefill's 26,624: each kernel against
    its plain version (the dispatch exactly, silu_mul bit for bit, the
    combine within one bf16 ulp of its chain's largest magnitude), each
    one's time, the plain version's and the byte bound; then a whole expert
    layer on K5 and on the plain composition."""
    from vidcap_tpu_torch.ops import moe
    out, problems = {}, []
    _build.reset_counts()
    for name, n in MOE_ROWS:
        sel, w, x, y, gate_up, shared, h = moe_case(n, 21)
        d, p = moe.moe_dispatch(sel, x, MOE_E), moe.moe_dispatch_plain(
            sel, x, MOE_E)
        act, act_p = moe.silu_mul(gate_up), moe.silu_mul_plain(gate_up)
        got = moe.moe_combine(y, d, w, shared, h)
        want = moe.moe_combine_plain(y, p, w, shared, h)
        inner = moe.moe_combine_plain(y, p, w, shared)
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in (
            (d.order, p.order), (d.counts, p.counts), (d.offs, p.offs),
            (d.x, p.x)))
        ulp = bf16_ulp(torch.maximum(want.float().abs(), inner.float().abs()))
        over = ((got.float() - want.float()).abs() > ulp).sum().item()
        m = n * MOE_K
        bytes_ = {"dispatch": 8 * m + 2 * n * MOE_H + 2 * m * MOE_H + 12 * m,
                  "silu_mul": 2 * m * 3 * MOE_I,
                  "combine": 2 * m * MOE_H + 8 * m + 3 * 2 * n * MOE_H}
        row = dict(
            dispatch_exact=exact, silu_mul_bitwise=torch.equal(act, act_p),
            combine_over_one_ulp=over,
            combine_max_abs_err=(got.float() - want.float()).abs().max()
            .item())
        for part, fn, plain in (
                ("dispatch", lambda: moe.moe_dispatch(sel, x, MOE_E),
                 lambda: moe.moe_dispatch_plain(sel, x, MOE_E)),
                ("silu_mul", lambda: moe.silu_mul(gate_up),
                 lambda: moe.silu_mul_plain(gate_up)),
                ("combine", lambda: moe.moe_combine(y, d, w, shared, h),
                 lambda: moe.moe_combine_plain(y, p, w, shared, h))):
            row[f"{part}_ms"] = time_ms(fn)
            row[f"{part}_plain_ms"] = time_ms(plain)
            row[f"{part}_bound_ms"] = bytes_[part] / PEAK_BYTES * 1e3
        for key in ("ms", "plain_ms", "bound_ms"):
            row[f"total_{key}"] = sum(row[f"{part}_{key}"] for part in (
                "dispatch", "silu_mul", "combine"))
        out[name] = row
        if not (exact and row["silu_mul_bitwise"] and over == 0):
            problems.append(f"{name}: {row}")
    out["layer_ms"], out["layer_plain_ms"] = moe_layer_ms(MOE_ROWS[0][1])
    if problems:
        fail("phase 21: " + "; ".join(problems))
    return out


KIMI_LAYERS = 4       # Kimi-VL-A3B cut to its dense layer and 3 expert layers
KIMI_B = 1024         # videos a decode, beam 5: the Kimi cell's batch


def phase_kimi_decode():
    """Kimi-VL-A3B's decoder at its published widths, cut to KIMI_LAYERS
    layers, with random weights, decodes KIMI_B videos of random features
    by beam 5 through ``Captioner.decode_batch``, the launch counts set to
    0 just before: each expert layer launches one ``moe_dispatch`` and one
    ``moe_combine`` a step and in the prefill, ``silu_mul`` runs twice there
    (routed and shared experts) and once in each dense layer, and the K5
    kernels launched are those the route lists (``Captioner.kernels``, what
    its warmup builds). Then the same decode with K5 off: both decodes'
    times and the rows whose tokens agree."""
    from vidcap_tpu_torch.config import apply_overrides
    from vidcap_tpu_torch.models import lm_decoder as lm
    c = dataclasses.replace(lm.KIMI_VL_A3B, num_hidden_layers=KIMI_LAYERS)
    V, Tk, Dk = c.vocab_size, c.num_frames, c.feature_dim
    cfg = apply_overrides(get_preset("msrvtt_attn_beam5"), [
        f"data.feature_dim={Dk}", f"data.num_frames={Tk}",
        f"data.vocab_size={V}", "decode.max_len=30", "decode.beam_width=5"])
    model = lm.create_lm_model(c, device="cuda").eval()
    g = torch.Generator(device="cuda").manual_seed(22)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith("e_score_correction_bias"):
                p.copy_(torch.randn(p.shape, generator=g, device="cuda")
                        * 0.01)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=g, device="cuda")
                        * 0.02)
    words = ["<pad>", "<bos>", "<eos>", "<unk>"] + [f"w{i}"
                                                    for i in range(4, V)]
    ds = CaptionDataset(np.zeros((1, Tk, Dk), np.float32), ["v0"],
                        {"v0": [words[4]]}, cfg.data,
                        vocab=Vocab({w: i for i, w in enumerate(words)},
                                    words))
    cap = Captioner(cfg, model, ds, torch.device("cuda"))
    feats = np.random.default_rng(22).normal(size=(KIMI_B, Tk, Dk)).astype(
        np.float32)
    cap.warmup("beam", KIMI_B, 5)

    def decode():
        steps0 = cap.decode_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = cap.decode_batch(feats, method="beam", beam_width=5)
        return toks, cap.decode_steps - steps0, (time.perf_counter() - t0)

    _build.reset_counts()
    toks, steps, k5_s = decode()
    launches = {k: _build.launch_counts[k] for k in _build.MOE}
    with k5_off():
        decode()
        plain, _, plain_s = decode()
    moe_layers = sum(not layer.dense for layer in model.layers)
    dense = KIMI_LAYERS - moe_layers
    passes = steps + 1                     # the steps and the prefill
    want = {"moe_dispatch": moe_layers * passes,
            "silu_mul": (2 * moe_layers + dense) * passes,
            "moe_combine": moe_layers * passes}
    listed = [k for k in cap.kernels("beam", 5) if k in _build.MOE]
    out = dict(layers=KIMI_LAYERS, expert_layers=moe_layers, steps=steps,
               launches=launches, expected=want, route_k5=listed,
               decode_s=k5_s, plain_decode_s=plain_s,
               rows_equal_to_plain=float((toks == plain).all(1).mean()))
    if launches != want or listed != [k for k in _build.MOE
                                      if launches[k]]:
        fail(f"phase 22: {out}")
    del cap, model
    torch.cuda.empty_cache()
    return out


def print_k5(card: str) -> dict:
    """Phases 21 and 22; K5's launches are phase 22's, the main path's."""
    k5 = phase_k5()
    print(f"phase 21 K5 moe k={MOE_K} E={MOE_E} H={MOE_H} I={MOE_I}, N="
          + "/".join(str(n) for _, n in MOE_ROWS) + f" on {card}: "
          + json.dumps({**k5, "tolerance": {
              "dispatch": "exact", "silu_mul": "bit for bit",
              "combine": "one bf16 ulp of the chain's largest |value|"}}),
          flush=True)
    dec = phase_kimi_decode()
    print(f"phase 22 Kimi-VL-A3B decoder cut to {KIMI_LAYERS} layers, beam 5"
          f" of B={KIMI_B} through Captioner on {card}: " + json.dumps(dec),
          flush=True)
    return {**k5, "launches": dec["launches"]}


def print_k2_wide(card: str) -> None:
    print(f"phase 19 K2 topk_project N=5120 H=2048 Vp=163840 K=5 on {card}: "
          + json.dumps({**phase_k2_wide(), "tolerance": "one bf16 ulp of "
                        "the row's largest |logit| + 1e-4"}), flush=True)


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
    if not native.available():
        fail("the native host library did not build (g++ is on the CUDA "
             "toolkit's machines)")
    print(f"phase 1 card: {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} | kernels "
          f"built in {build_s:.1f} s", flush=True)
    if "--k2-wide" in sys.argv[1:]:
        print_k2_wide(card)
        return 0
    if "--k4" in sys.argv[1:]:
        print_k4(card)
        return 0
    if "--k5" in sys.argv[1:]:
        print_k5(card)
        return 0

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

    e2e, beam_cap, beam_trials = phase_end_to_end()
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
    cli_train = phase_cli_train(ds)
    print("phase 10 CLI train --preset scst_cider --stages xe,scst "
          "--eval-every 3: " + json.dumps(cli_train), flush=True)
    offline = phase_offline(min(
        e2e["identical_rows_plain_cpu_vs_card_by_trial"]) - ROW_SLACK)
    print(f"phase 11 offline path msrvtt_attn_beam5 (train B=64, beam {K}, "
          f"Vp={VP}) on {card}: " + json.dumps(offline), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        setup = serving_setup(tmp, np.random.default_rng(12))
        refs = served_references(setup)
        serving = phase_serving(setup, refs, tmp)
        serving["wall_s"] = time.perf_counter() - t0
        print(f"phase 12 serve msrvtt_attn_beam5 (B={SERVE_B}, beam {K}, "
              f"Vp={VP}) and msvd_greedy on {card}: " + json.dumps(serving),
              flush=True)
        export = phase_export(setup, refs, tmp)
        print(f"phase 13 export, caption/serve --from-export on {card}: "
              + json.dumps(export), flush=True)
    dispatch = phase_dispatch()
    print(f"phase 14 the trainer's dispatch scst_cider B={BG} Vp={VG} L={L}"
          f", {BANK_VIDEOS}-video bank, on {card}: " + json.dumps(
              {**dispatch, "tolerance": "captured == eager where two eager "
               "runs are equal, else 2x their max |diff|"}), flush=True)
    pixels = phase_e2e_pixels()
    print(f"phase 15 end to end from pixels, e2e_scst_multitask B={PIX_B} "
          f"(IRv2 width 1.0, {PIX_B * T} frames of {S_PIX}^2 a step), "
          f"Vp={VG}, on {card}: " + json.dumps(
              {**pixels, "tolerance": {
                  "preprocess_max_abs": PREP_TOL,
                  "backbone_f32_rel_l2": BB_F32_TOL,
                  "backbone_bf16_rel_l2": BB_BF16_TOL,
                  "captured_vs_eager": "equal where two eager runs are, "
                  "else 2x their max |diff|"}}), flush=True)
    k28, launched16 = phase16_line(card, beam_cap, beam_trials, e2e,
                                   row_floor, ds)
    sharded, launched17 = phase_sharded(min(
        e2e["identical_rows_plain_cpu_vs_card_by_trial"]) - ROW_SLACK)
    print(f"phase 17 more than one GPU, a world of one over NCCL on {card}: "
          "(a) sharded XE (banked) and SCST steps at scst_cider width "
          f"B={BG}, (b) sharded beam B={B} and greedy B={BG}, (c) dropout "
          f"p={DROP_P} in the captured XE step, (d) the shapes the kernels "
          "refuse at msrvtt_attn_beam5 width: " + json.dumps(
              {**sharded, "tolerance": {
                  "steps": "bit for bit where two unsharded runs are, else "
                  "2x their max |diff|", "decodes": "identical",
                  "dropout": "keep share within 4 sigma; captured vs eager "
                  "as (a)", "refused": "rows vs the CPU >= the CPU bf16-vs-"
                  f"f32 witness less {ROW_SLACK}, or phase 4's floor"}}),
          flush=True)
    lift = phase_lift()
    print(f"phase 18 the SCST lift, synthetic_tiny B=16, {LIFT_XE} XE and "
          f"{LIFT_SCST} SCST captured steps, greedy val CIDEr on 64 held-out "
          f"videos, on {card}: " + json.dumps(
              {**lift, "bound": f"lift > {LIFT_MIN}"}), flush=True)
    print_k2_wide(card)
    k4 = print_k4(card)
    k5 = print_k5(card)
    served_beam = [serving["stdin"], serving["http"],
                   export["caption --from-export split"],
                   export["caption --from-export --inputs"]]
    served_k3 = [serving["greedy"], export["serve --from-export greedy"]]

    # max_abs_err is the max |err| against the plain version (K3: of the
    # log-probs along the kernel's tokens), ms the kernel's time; bound_ms
    # alone is computed, not measured. The launches are those of the main
    # paths: K1/K2 phase 4's beam decodes, phase 11's validation and
    # caption --inputs, phase 12's served batches (stdin, HTTP) and phase
    # 13's caption --from-export; K3 phase 7's greedy and sampled decodes,
    # phase 9's SCST steps, phase 10's validation, phase 12's greedy serve
    # and phase 13's serve --from-export (the servers' warmups included),
    # phase 14's captured steps (counted per replay) and its CLI's stage
    # lines; phase 16's int8 and pool beams, other decoders' beams and CLI
    # captions for K1, K2 and K2-int8 (K3 none there).
    k3["launches"] = (sum(r["launches"]["rollout"] for r in roll.values())
                      + scst["launches"]["rollout"]
                      + cli_train["validation_rollout_launches"]
                      + sum(r["launches"]["rollout"] for r in served_k3)
                      + dispatch["launches_b_c"]["rollout"]
                      + sum(lc["rollout"] for *_, lc
                            in dispatch["cli"]["stage_lines"])
                      + pixels["steps"]["launches"]["rollout"]
                      + sum(lc["rollout"] for *_, lc
                            in pixels["cli"]["stage_lines"]
                            + pixels["cli"]["resume_stage_lines"])
                      + pixels["cli"]["caption_launches"]["rollout"])
    k3["launches"] += (launched16["rollout"] + launched17["rollout"]
                       + lift["launches"]["rollout"])
    k28["launches"] = (launched16["topk_project_int8"]
                       + launched17["topk_project_int8"])
    # K4: phase 20's pass, phase 9's timed steps, phase 14's dispatched
    # steps, phase 15's composed steps and the lift's; K5: phase 22's
    # decode through the Captioner
    k4 = dict(name="teacher_forced", **{k: k4[k] for k in (
        "max_abs_err", "fwd_ms", "bwd_ms", "plain_fwd_ms", "plain_bwd_ms",
        "loop_fwd_ms", "loop_bwd_ms", "bound_fwd_ms", "bound_bwd_ms")},
        launches=k4["launches"] + sum(
            d["teacher_forced"] for d in (
                scst["launches"], dispatch["launches_b_c"],
                pixels["steps"]["launches"], lift["launches"])))
    print(json.dumps({"kernels": [dict(k, launches=e2e["launches"][k["name"]]
                                       + offline["train_launches"][k["name"]]
                                       + offline["caption_launches"][k["name"]]
                                       + sum(r["launches"][k["name"]]
                                             for r in served_beam)
                                       + launched16[k["name"]]
                                       + launched17[k["name"]])
                                  for k in (k1, k2)] + [k28, k3, k4, dict(
                                      name="moe", **{
                                          f"{r}_{k}": k5[r][f"total_{k}"]
                                          for r, _ in MOE_ROWS
                                          for k in ("ms", "plain_ms",
                                                    "bound_ms")},
                                      launches=k5["launches"])]}),
          flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
