"""CLI of the PyTorch package:

  python -m vidcap_tpu_torch caption --preset msvd_greedy --weights W.npz
      [--method greedy|beam|sample] [--beam 5] [--nbest N] [--temperature T]
      [--seed S] [--split test] [--out caps.json]
      [--set section.field=value ...] [--device cpu]
  python -m vidcap_tpu_torch sample --preset scst_cider --weights W.npz
      [--temperature T] [--seed S] [--split test] [--out caps.json] ...

``caption`` decodes the split (the synthetic fixture when the dataset is not
on disk) with the preset's method unless ``--method`` is given, and writes
{video_id: [caption, ...]} json; ``sample`` is ``caption --method sample``.
Both run on the card unless ``--device cpu`` is given. The other commands of
the JAX CLI are not ported yet and say which ROADMAP item they wait for.
"""
from __future__ import annotations

import argparse
import json
import sys

from vidcap_tpu_torch.config import Config, apply_overrides, get_preset
from vidcap_tpu_torch.ops._build import launch_counts

# command or flag → the ROADMAP item that ports it
_NOT_PORTED = {
    "train": "Queue 1 items 6 and 8 (XE and SCST training)",
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


def _load_dataset(cfg: Config, split: str = "test"):
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
    print(f"[vidcap] {method}: {cap.decode_calls} decodes, "
          f"{cap.decode_steps} steps on {cap.device}; kernel launches "
          f"{json.dumps(launch_counts)}", file=sys.stderr)


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

    for name in ("train", "eval", "serve", "export"):
        s = sub.add_parser(name, help=f"not ported yet ({_NOT_PORTED[name]})",
                           add_help=False)
        s.set_defaults(fn=lambda args, name=name: _not_ported(name))
    return p


def main(argv=None) -> int:
    args, rest = build_parser().parse_known_args(argv)
    if rest and args.cmd in ("caption", "sample"):
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
