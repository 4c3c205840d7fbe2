"""CLI of the PyTorch package:

  python -m vidcap_tpu_torch train --preset scst_cider --stages xe,scst
      [--steps N | --steps N1,N2] [--batch-size B] [--resume]
      [--log-file log.jsonl] [--eval-every 0] [--log-every K]
      [--checkpoint-dir DIR] [--seed S] [--set ...] [--device cpu]
  python -m vidcap_tpu_torch caption --preset msvd_greedy --weights W.npz
      [--method greedy|beam|sample] [--beam 5] [--nbest N] [--temperature T]
      [--seed S] [--split test] [--out caps.json]
      [--set section.field=value ...] [--device cpu]
  python -m vidcap_tpu_torch sample --preset scst_cider --weights W.npz
      [--temperature T] [--seed S] [--split test] [--out caps.json] ...

``train`` runs the preset's stage, or each of ``--stages`` in turn, each
resuming from the previous one's checkpoint; step counts add up over the
stages. ``caption`` decodes the split (the synthetic fixture when the
dataset is not on disk) with the preset's method unless ``--method`` is
given, and writes {video_id: [caption, ...]} json; ``sample`` is ``caption
--method sample``. All run on the card unless ``--device cpu`` is given. The other commands of
the JAX CLI are not ported yet and say which ROADMAP item they wait for.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from vidcap_tpu_torch.config import Config, apply_overrides, get_preset
from vidcap_tpu_torch.ops._build import launch_counts

# command or flag → the ROADMAP item that ports it
_NOT_PORTED = {
    "--feature-bank": "Queue 1 item 12 (the device feature bank)",
    "--steps-per-dispatch": "Queue 1 item 12 (multi-step dispatch)",
    "--sharded": "Queue 1 item 12 (multi-GPU training)",
    "eval": "Queue 1 item 4 remainder (scoring with metrics/evaluate.py)",
    "serve": "Queue 1 item 10 (serving and export)",
    "export": "Queue 1 item 10 (serving and export)",
    "--inputs": "Queue 1 item 4 remainder (caption --inputs)",
    "--from-export": "Queue 1 item 10 (serving and export)",
}


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to vidcap_tpu_torch yet (ROADMAP "
        f"{_NOT_PORTED[what]}); the JAX package's `python -m vidcap_tpu` "
        "has it")


def _load_dataset(cfg: Config, split: str):
    from vidcap_tpu_torch.data.loader import CaptionDataset
    if cfg.data.dataset == "synthetic":
        return CaptionDataset.synthetic(cfg.data)
    splits = [split] + (["val"] if split == "test" else [])
    for i, s in enumerate(splits):
        try:
            ds = CaptionDataset.from_files(cfg.data, split=s)
            if i > 0:
                print(f"[vidcap] no {split!r} split on disk — using {s!r}",
                      file=sys.stderr)
            return ds
        except FileNotFoundError as e:
            err = e
    print(f"[vidcap] dataset assets not found ({err}); "
          f"falling back to the synthetic fixture", file=sys.stderr)
    return CaptionDataset.synthetic(cfg.data)


def _decode_split(args, cfg: Config, method: str, beam: int = 5,
                  nbest: int = 1) -> None:
    from vidcap_tpu_torch.inference import Captioner
    dataset = _load_dataset(cfg, split=args.split)
    cap = Captioner.from_checkpoint(cfg, dataset, weights=args.weights,
                                    device=args.device, seed=args.seed)
    results = cap.caption_dataset(method=method, beam_width=beam,
                                  temperature=args.temperature, nbest=nbest)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[vidcap] wrote {len(results)} captions → {args.out}",
              file=sys.stderr)
    else:
        for vid, caps in list(results.items())[:20]:
            print(f"{vid}\t{caps[0]}")
    mode = ""
    if cap.rollout_resident is not None and cap.device.type == "cuda":
        mode = "; rollout W_out " + ("resident" if cap.rollout_resident
                                     else "streamed")
    print(f"[vidcap] {method}: {cap.decode_calls} decodes, "
          f"{cap.decode_steps} steps on {cap.device}{mode}; kernel launches "
          f"{json.dumps(launch_counts)}", file=sys.stderr)


def cmd_train(args) -> int:
    for flag in ("feature_bank", "steps_per_dispatch", "sharded"):
        if getattr(args, flag):
            _not_ported("--" + flag.replace("_", "-"))
    cfg = apply_overrides(get_preset(args.preset), args.set)
    # --steps: one count for every stage, or a comma list matched to
    # --stages (e.g. --stages xe,scst --steps 2500,1000)
    per_stage_steps = None
    train_over = {}
    if args.steps:
        counts = [int(s) for s in str(args.steps).split(",")]
        if len(counts) > 1:
            per_stage_steps = counts
        train_over["num_steps"] = counts[0]
    for flag, field in (("batch_size", "batch_size"),
                        ("eval_every", "eval_every"),
                        ("log_every", "log_every"),
                        ("checkpoint_dir", "checkpoint_dir"),
                        ("seed", "seed")):
        if getattr(args, flag) is not None:
            train_over[field] = getattr(args, flag)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             **train_over))
    stages = [s.strip() for s in args.stages.split(",")] if args.stages \
        else [cfg.train.stage]
    if per_stage_steps is not None and len(per_stage_steps) != len(stages):
        raise SystemExit(f"--steps lists {len(per_stage_steps)} counts for "
                         f"{len(stages)} stages")
    from vidcap_tpu_torch.inference import resolve_device
    from vidcap_tpu_torch.train.loop import train
    from vidcap_tpu_torch.utils.logging import MetricsLogger
    resolve_device(args.device)   # no card and no --device cpu: exit 2 now
    dataset = _load_dataset(cfg, split="train")
    logger = MetricsLogger(path=args.log_file)
    # the staged schedule: each stage resumes from the previous stage's
    # checkpoint, and the step counts are cumulative
    total = 0
    try:
        for i, stage in enumerate(stages):
            total += (per_stage_steps[i] if per_stage_steps is not None
                      else cfg.train.num_steps)
            scfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, stage=stage, num_steps=total))
            train(scfg, dataset=dataset, logger=logger,
                  resume=args.resume or i > 0, device=args.device)
    finally:
        logger.close()
    return 0


def cmd_caption(args) -> int:
    if args.inputs:
        _not_ported("--inputs")
    if args.from_export:
        _not_ported("--from-export")
    cfg = apply_overrides(get_preset(args.preset), args.set)
    method = args.method or cfg.decode.method
    if args.nbest > 1 and method != "beam":
        raise SystemExit(f"--nbest {args.nbest} requires --method beam")
    _decode_split(args, cfg, method, beam=args.beam or cfg.decode.beam_width,
                  nbest=args.nbest)
    return 0


def cmd_sample(args) -> int:
    _decode_split(args, apply_overrides(get_preset(args.preset), args.set),
                  "sample")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vidcap_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--preset", default="msvd_greedy")
        sp.add_argument("--set", action="append", default=None,
                        metavar="SECTION.FIELD=VALUE",
                        help="override any config field, repeatable")
        sp.add_argument("--weights", required=True,
                        help=".npz of '/'-joined Flax parameter paths "
                             "(vidcap_tpu_torch.convert)")
        sp.add_argument("--temperature", type=float, default=1.0)
        sp.add_argument("--seed", type=int, default=None,
                        help="reproducible sampling seed")
        sp.add_argument("--split", default="test",
                        help="dataset split to decode (default test; falls "
                             "back to val)")
        sp.add_argument("--out", default=None)
        sp.add_argument("--device", default=None,
                        help="cuda (default) or cpu")

    c = sub.add_parser("caption", help="decode a split, write json")
    common(c)
    c.add_argument("--method", choices=["greedy", "beam", "sample"],
                   default=None)
    c.add_argument("--beam", type=int, default=None)
    c.add_argument("--nbest", type=int, default=1,
                   help="write the N best hypotheses per video (best first)")
    c.add_argument("--inputs", nargs="+", default=None, help=argparse.SUPPRESS)
    c.add_argument("--from-export", default=None, help=argparse.SUPPRESS)
    c.set_defaults(fn=cmd_caption)

    s = sub.add_parser("sample", help="multinomial-sampling decode")
    common(s)
    s.set_defaults(fn=cmd_sample)

    t = sub.add_parser("train", help="run the preset's training stage(s)")
    t.add_argument("--preset", default="msvd_greedy")
    t.add_argument("--set", action="append", default=None,
                   metavar="SECTION.FIELD=VALUE",
                   help="override any config field, repeatable")
    t.add_argument("--steps", default=None,
                   help="steps per stage: one count for all stages, or a "
                        "comma list matched to --stages (e.g. 2500,1000)")
    t.add_argument("--stages", default=None,
                   help="comma list overriding the preset stage, e.g. xe,scst")
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--log-file", default=None)
    t.add_argument("--eval-every", type=int, default=None,
                   help="the periodic-eval cadence; 0 disables it (periodic "
                        "eval is not ported yet, so a cadence within the "
                        "run is refused)")
    t.add_argument("--log-every", type=int, default=None,
                   help="cadence of train log rows (0: only the last step)")
    t.add_argument("--checkpoint-dir", default=None)
    t.add_argument("--seed", type=int, default=None,
                   help="train.seed: the init, the batch order and the "
                        "sampling generator")
    t.add_argument("--device", default=None, help="cuda (default) or cpu")
    t.add_argument("--feature-bank", action="store_true",
                   help=argparse.SUPPRESS)
    t.add_argument("--steps-per-dispatch", default=None,
                   help=argparse.SUPPRESS)
    t.add_argument("--sharded", action="store_true", help=argparse.SUPPRESS)
    t.set_defaults(fn=cmd_train)

    for name in ("eval", "serve", "export"):
        s = sub.add_parser(name, help=f"not ported yet ({_NOT_PORTED[name]})",
                           add_help=False)
        s.set_defaults(fn=lambda args, name=name: _not_ported(name))
    return p


def main(argv=None) -> int:
    args, rest = build_parser().parse_known_args(argv)
    if rest and args.cmd in ("train", "caption", "sample"):
        build_parser().parse_args(argv)   # reports the unknown arguments
    from vidcap_tpu_torch.inference import NoDeviceError
    try:
        return args.fn(args)
    except KeyError as e:
        if "unknown preset" in str(e):
            print(f"error: {e.args[0]}", file=sys.stderr)
            return 2
        raise
    except (FileNotFoundError, NotImplementedError, NoDeviceError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
