"""The at-scale staged run on the card: the port's counterpart of the
reference's recipe (``scripts/r5_suite.sh:19-20``, the r4 banked run).

In one process, on a corpus generated into a temporary directory:
1. ``scripts/torch_scale_corpus.py`` (5,000 train and 500 val videos of
   MSR-VTT shape, 20 captions each, a ~16k vocab);
2. the train split's reward tables built twice, by the native counter and
   by the Python one (``plain``), each timed, and checked equal;
3. ``python -m vidcap_tpu_torch train --preset msrvtt_attn_beam5
   --batch-size 64 --feature-bank --eval-every 500 --log-every 100 --set
   train.scst_xe_mix=0.1 --set train.scst_learning_rate=5e-5 --set
   train.attribute_loss_weight=0.2 --stages xe,scst --steps 2500,1500``
   (the preset's own attribute weight is 0; the reference's r4 log carries
   ``attr_loss``, and its reproductions set 0.2);
4. on the newest checkpoint (step 4,000): the int8 A/B of
   ``scripts/torch_int8_quality.py`` on the val split; the pool at
   ``decode.length_penalty=0.6`` (steps a decode, captions/s beside the
   beam's, interleaved); ``chip_smoke.py`` phase 4's kernel-vs-plain row
   check (``compare_paths``) on the val videos.

Writes ``--out`` (``artifacts/torch_scale_run.json``) with the keys of
``artifacts/SCALE_RUN_r4_banked.json`` and the card's name and power limit,
the two table-build times, the stage lines' launches, the bounds and
item 4's readings; copies the train log to ``--log-copy``.

    python scripts/torch_scale_run.py
    python scripts/torch_scale_run.py --device cpu --train 200 --val 40 \\
        --clusters 10 --pool 8 --steps 4,4 --eval-every 4 --log-every 1 \\
        --out build/run.json --log-copy build/log.jsonl   # a CPU rehearsal
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (REPO, os.path.join(REPO, "scripts")):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from vidcap_tpu_torch.data.loader import CaptionDataset  # noqa: E402
from vidcap_tpu_torch.inference import Captioner  # noqa: E402
from vidcap_tpu_torch.objectives.reward_tables import tables_from_dataset  # noqa: E402
from torch_int8_quality import int8_ab, scale_config  # noqa: E402

# End-of-XE val CIDEr: the reference's six seeded runs read 0.7540-0.7835
# (artifacts/r5_ab_w{0.0,0.2}_s{0,1,2}.jsonl); widened by that width on
# each side. SCST may not lose more than DRIFT from there by its end (the
# reference's worst drift over 1,500 steps: -0.024, r5_ab_w0.2_s0).
XE_RANGE = (0.724, 0.814)
DRIFT = 0.03
STAGE_LINE = re.compile(r"\[vidcap\] (\w+): (\d+) steps on (\S+?)"
                        r"(?:; rollout W_out (\w+))?; kernel launches "
                        r"(\{.*\})")
TABLES_LINE = re.compile(r"\[vidcap\] scst: reward tables of (\d+) videos "
                         r"built in ([\d.]+) s by the (\w+) counter")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        "not measured (no nvidia-smi)"


def canonical(t):
    """A table's content independent of slot order: per (video, reference)
    the sorted (order, lo, hi, tf, idf) entries, the IDF table as a dict,
    and the norms, lengths and counts."""
    a = {f.name: getattr(t, f.name).numpy() for f in dataclasses.fields(t)
         if isinstance(getattr(t, f.name), torch.Tensor)}
    entries = []
    for v in range(a["ref_order"].shape[0]):
        for r in range(a["ref_order"].shape[1]):
            g = a["ref_order"][v, r] > 0
            entries.append(sorted(zip(
                a["ref_order"][v, r][g].tolist(),
                a["ref_key_lo"][v, r][g].tolist(),
                a["ref_key_hi"][v, r][g].tolist(),
                a["ref_tf"][v, r][g].tolist(),
                a["ref_idf"][v, r][g].tolist())))
    used = (a["idf_key_lo"] != 0) | (a["idf_key_hi"] != 0)
    idf = dict(zip(zip(a["idf_key_lo"][used].tolist(),
                       a["idf_key_hi"][used].tolist()),
                   a["idf_val"][used].tolist()))
    return entries, idf, {k: a[k] for k in ("ref_norm", "ref_len",
                                            "ref_valid", "num_refs")}


def tables_equal(a, b) -> bool:
    """The same entries, IDF weights, lengths and counts; the norms (f64
    sums in each counter's entry order, then f32) within 1e-6."""
    (ea, ia, xa), (eb, ib, xb) = canonical(a), canonical(b)
    return (a.log_n == b.log_n and ea == eb and ia == ib
            and all(np.allclose(xa[k], xb[k], rtol=1e-6, atol=0)
                    for k in xa))


def build_tables(ds) -> dict:
    t0 = time.perf_counter()
    native = tables_from_dataset(ds)
    t1 = time.perf_counter()
    plain = tables_from_dataset(ds, plain=True)
    t2 = time.perf_counter()
    return dict(videos=ds.num_videos, references=ds.num_captions,
                native_counter=native.counter, native_s=t1 - t0,
                python_s=t2 - t1, equal=tables_equal(native, plain),
                ref_grams=native.ref_order.shape[2],
                idf_slots=native.idf_key_lo.shape[0],
                num_probes=native.num_probes)


def summarize(rows, xe_steps: int) -> dict:
    """scripts/summarize_scale_run.py's keys from the train log's rows."""
    train = [r for r in rows if "steps_per_sec" in r]
    evals = [r for r in rows if "eval_CIDEr" in r]
    scst = [r for r in train if "reward_sample" in r]
    xe = [r for r in train if "reward_sample" not in r]

    def sps(rs):
        # each stage's first window holds the capture and the table build
        vals = sorted(r["steps_per_sec"] for r in rs[1:]) or \
            [r["steps_per_sec"] for r in rs]
        return vals[len(vals) // 2] if vals else None

    curve = [{"step": r["step"], "CIDEr": r["eval_CIDEr"],
              "Bleu_4": r.get("eval_Bleu_4")} for r in evals]
    end_xe = [c for c in curve if c["step"] <= xe_steps]
    return {
        "xe": dict(logged_rows=len(xe), median_steps_per_sec=sps(xe),
                   first_loss=xe[0]["loss"] if xe else None,
                   last_loss=xe[-1]["loss"] if xe else None),
        "scst": dict(logged_rows=len(scst), median_steps_per_sec=sps(scst),
                     first_reward_sample=(scst[0]["reward_sample"]
                                          if scst else None),
                     last_reward_sample=(scst[-1]["reward_sample"]
                                         if scst else None)),
        "val_cider_curve": curve,
        "val_seconds": [r.get("val_seconds") for r in evals],
        "val_cider_end_of_xe": end_xe[-1]["CIDEr"] if end_xe else None,
        "val_cider_final": curve[-1]["CIDEr"] if curve else None,
    }


def trials_of(val: CaptionDataset, rows: int):
    """The val features as batches of ``rows`` covering every video (the
    last batch overlaps the one before it)."""
    n = val.num_videos
    starts = sorted({*range(0, max(n - rows, 0) + 1, rows), max(n - rows, 0)})
    return [np.asarray(val.features[s:s + rows], np.float32) for s in starts]


def trained_beam_checks(cap: Captioner) -> dict:
    """On the card: the pool at lp 0.6 (steps a decode, captions/s beside
    the beam's) and phase 4's kernel-vs-plain rows, at B=184 on the val
    videos."""
    import chip_smoke as smoke
    trials = trials_of(cap.dataset, smoke.B)
    out = {"trials": len(trials), "rows_a_trial": smoke.B}
    pool = Captioner(smoke.replaced(cap.cfg, "decode", length_penalty=0.6),
                     cap.model, cap.dataset, cap.device)
    for name, c in (("beam", cap), ("pool lp0.6", pool)):
        launches, by_k, steps, _, _ = smoke.beam_main_path(c, trials)
        # beam_main_path decodes trials[0] twice (a warm-up first)
        out[name] = dict(launches=launches, k2_launches_by_k=by_k,
                         decode_steps=steps,
                         steps_a_decode=steps / (len(trials) + 1),
                         max_len=c.cfg.decode.max_len)
    out["captions_per_s"] = smoke.decode_walls(
        {"beam": cap, "pool lp0.6": pool}, trials, beam_width=smoke.K)
    try:
        out["phase4_rows"] = smoke.compare_paths(cap, trials)
    except SystemExit:
        out["phase4_rows"] = "failed: see the stderr line chip_smoke FAIL"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(
        REPO, "artifacts", "torch_scale_run.json"))
    ap.add_argument("--log-copy", default=os.path.join(
        REPO, "artifacts", "torch_scale_run_train_log.jsonl"))
    ap.add_argument("--train", type=int, default=5000)
    ap.add_argument("--val", type=int, default=500)
    ap.add_argument("--clusters", type=int, default=500)
    ap.add_argument("--pool", type=int, default=32)
    ap.add_argument("--steps", default="2500,1500", help="XE,SCST")
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="cpu for a rehearsal (default: the card)")
    args = ap.parse_args(argv)
    xe_steps, scst_steps = (int(s) for s in args.steps.split(","))
    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        print("torch_scale_run: no CUDA device (use --device cpu to "
              "rehearse on the CPU)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    out = {"card": card_line() if on_card else "cpu (rehearsal)",
           "recipe": None}
    with tempfile.TemporaryDirectory(prefix="vidcap_scale_") as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, os.path.join(
            REPO, "scripts", "torch_scale_corpus.py"), "--out", data,
            "--train", str(args.train), "--val", str(args.val),
            "--clusters", str(args.clusters), "--pool", str(args.pool)],
            check=True)
        out["corpus_s"] = time.perf_counter() - t0
        cfg = scale_config(data)
        train_ds = CaptionDataset.from_files(cfg.data, split="train")
        out["corpus"] = dict(train_videos=train_ds.num_videos,
                             train_captions=train_ds.num_captions,
                             vocab=train_ds.vocab.size)
        out["reward_tables"] = build_tables(train_ds)
        print("[scale] reward tables: " + json.dumps(out["reward_tables"]),
              file=sys.stderr, flush=True)
        del train_ds

        log = os.path.join(tmp, "train_log.jsonl")
        cmd = [sys.executable, "-m", "vidcap_tpu_torch", "train",
               "--preset", "msrvtt_attn_beam5", "--batch-size", "64",
               "--feature-bank", "--eval-every", str(args.eval_every),
               "--log-every", str(args.log_every),
               "--set", f"data.data_dir={data}",
               "--set", "train.scst_xe_mix=0.1",
               "--set", "train.scst_learning_rate=5e-5",
               "--set", "train.attribute_loss_weight=0.2",
               "--stages", "xe,scst", "--steps", args.steps,
               "--log-file", log]
        if not on_card:
            cmd += ["--device", "cpu"]
        out["recipe"] = " ".join(cmd[3:]).replace(data, "DATA").replace(
            log, "LOG")
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=tmp, stderr=subprocess.PIPE, text=True,
                           env={**os.environ, "PYTHONPATH": REPO})
        out["wall_s_total"] = time.perf_counter() - t0
        sys.stderr.write(r.stderr[-4000:])
        if r.returncode != 0:
            print(f"torch_scale_run: train exited {r.returncode}",
                  file=sys.stderr)
            return 1
        with open(log) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        os.makedirs(os.path.dirname(os.path.abspath(args.log_copy)),
                    exist_ok=True)
        shutil.copyfile(log, args.log_copy)
        out.update(summarize(rows, xe_steps))
        out["stage_lines"] = [
            dict(stage=s, steps=int(n), device=d, rollout_w_out=m or None,
                 launches=json.loads(lc))
            for s, n, d, m, lc in STAGE_LINE.findall(r.stderr)]
        out["scst_reward_tables_line"] = [
            dict(videos=int(v), seconds=float(s), counter=c)
            for v, s, c in TABLES_LINE.findall(r.stderr)]
        xe_end, final = out["val_cider_end_of_xe"], out["val_cider_final"]
        out["bounds"] = dict(
            end_of_xe_range=list(XE_RANGE), drift=DRIFT,
            end_of_xe_in_range=(xe_end is not None
                                and XE_RANGE[0] <= xe_end <= XE_RANGE[1]),
            final_minus_end_of_xe=(None if xe_end is None or final is None
                                   else final - xe_end),
            final_within_drift=(xe_end is not None and final is not None
                                and final >= xe_end - DRIFT))

        val = CaptionDataset.from_files(cfg.data, split="val")
        cap = Captioner.from_checkpoint(
            cfg, val, checkpoint_dir=os.path.join(tmp, "checkpoints"),
            device=args.device)
        t0 = time.perf_counter()
        out["int8_ab"] = int8_ab(cap)
        out["int8_ab"]["seconds"] = time.perf_counter() - t0
        print("[scale] int8 A/B: " + json.dumps(out["int8_ab"]),
              file=sys.stderr, flush=True)
        if on_card:
            t0 = time.perf_counter()
            out["trained_beam"] = trained_beam_checks(cap)
            out["trained_beam"]["seconds"] = time.perf_counter() - t0
        else:
            out["trained_beam"] = "not measured (needs the card)"
    out["script_wall_s"] = time.perf_counter() - t_start
    out["card_after"] = card_line() if on_card else out["card"]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=float)
    print(json.dumps({k: out[k] for k in (
        "card", "wall_s_total", "val_cider_end_of_xe", "val_cider_final",
        "bounds")}))
    ok = all(not isinstance(v, float) or math.isfinite(v)
             for v in (out["val_cider_end_of_xe"], out["val_cider_final"]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
