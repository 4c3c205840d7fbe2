"""CLI of the PyTorch package:

  python -m vidcap_tpu_torch prepare --preset msrvtt_attn_beam5 ANNOTATIONS...
      [--mapping youtube_mapping.txt] [--set data.data_dir=DIR]
  python -m vidcap_tpu_torch train --preset scst_cider --stages xe,scst
      [--steps N | --steps N1,N2] [--batch-size B] [--resume]
      [--log-file log.jsonl] [--eval-every N] [--log-every K]
      [--checkpoint-dir DIR] [--seed S] [--feature-bank]
      [--steps-per-dispatch K | K1,K2] [--set ...] [--device cpu]
      [--sharded]
  python -m vidcap_tpu_torch caption --preset msvd_greedy
      [--checkpoint-dir DIR | --weights W.npz]
      [--method greedy|beam|sample] [--beam 5] [--nbest N] [--temperature T]
      [--seed S] [--split test | --inputs FILE|DIR ...] [--out caps.json]
      [--set section.field=value ...] [--device cpu]
  python -m vidcap_tpu_torch sample --preset scst_cider [--checkpoint-dir DIR
      | --weights W.npz] [--temperature T] [--seed S] [--split test] ...
  python -m vidcap_tpu_torch eval --preset msvd_greedy --captions caps.json
      [--refs refs.json | --split test]
  python -m vidcap_tpu_torch serve --preset msrvtt_attn_beam5
      [--checkpoint-dir DIR | --weights W.npz | --from-export DIR]
      [--method M] [--beam K] [--batch 32] [--max-wait-ms MS]
      [--pipeline-depth 1] [--http PORT [--path-root DIR] [--max-queue N]]
      [--device cpu] [--sharded]
  python -m vidcap_tpu_torch export --preset msvd_greedy --out DIR
      [--checkpoint-dir DIR | --weights W.npz] [--batch 32 | --batch 0]
      [--method greedy|beam] [--beam K] [--platforms cuda,cpu]
      [--device cpu]
  python -m vidcap_tpu_torch extract --preset e2e_irv2 --videos DIR
      [--split train] [--format npy|h5|tfrecord] [--device cpu]
  python -m vidcap_tpu_torch convert --tf-checkpoint CKPT --out W.npz
  python -m vidcap_tpu_torch info --preset msrvtt_attn_beam5 [--json]
      [--no-devices] [--set ...]

``prepare`` turns MSVD/MSR-VTT annotation files into the layout that
``CaptionDataset.from_files`` reads. ``train`` runs the preset's stage, or
each of ``--stages`` in turn, each resuming from the previous one's
checkpoint; step counts add up over the stages; every ``--eval-every`` steps
it scores the val split and keeps the best-CIDEr state under
``{checkpoint_dir}/best``; ``--feature-bank`` keeps the features on the
device and ``--steps-per-dispatch`` (with it) runs K steps a dispatch. ``caption`` decodes the split (the synthetic
fixture when the dataset is not on disk), or the ``.npy`` feature files of
``--inputs``, with the preset's method unless ``--method`` is given, and
writes {video_id: [caption, ...]} json; ``sample`` is ``caption --method
sample``. Both read the newest checkpoint of ``--checkpoint-dir`` (default
the preset's ``train.checkpoint_dir``) or a ``--weights`` file; ``caption
--from-export DIR`` decodes with an ``export`` artifact instead (export.py).
``eval`` scores a captions json on the host. ``serve`` captions the feature
or video paths of stdin, or of HTTP requests with ``--http`` (serving.py),
and ``export`` writes an artifact of weights, vocab and meta. ``extract``
runs every video of a directory through cv2 and the IRv2 backbone and writes
the split's feature file; ``convert`` turns a TF-slim IRv2 checkpoint into
the backbone ``.npz`` that ``load_backbone_params`` reads
(``$VIDCAP_IRV2_WEIGHTS``); ``info`` prints a preset's preflight census
(parameters per group, memory estimates, the kernels' build cache, the
card). The end-to-end presets (``model.use_backbone``:
``e2e_irv2``, ``e2e_scst_multitask``) train and decode on frame pixels
(``{dataset}_{split}_frames.*``, else the synthetic pixel fixture), and
``caption --inputs`` takes video files. Train, decode, serve and extract run
on the card unless ``--device cpu`` is given. ``train --sharded`` and
``serve --sharded`` run on every visible card from one command: it starts
one worker process a rank of the mesh ``mesh.num_data`` × ``mesh.num_model``
(``mesh.num_data`` -1: every visible card, or 2 gloo processes with
``--device cpu``), each the same command as one rank (parallel/); with one
rank they print the reference's notice and run on one device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional

from vidcap_tpu_torch.config import Config, apply_overrides, get_preset
from vidcap_tpu_torch.ops._build import launch_counts


def _sharded_mesh(args, cfg: Config, stdin: bool = False):
    """``--sharded``: (None, an exit code) in the command that starts the
    workers: one process a rank of ``cfg.mesh`` (``num_data`` × ``num_model``;
    ``num_data`` -1: every visible card, with ``--device cpu`` 2 processes
    over gloo), each this same command as one rank
    (parallel/distributed.py::launch); (the mesh over the ranks, None) in a
    worker; (None, None) with one rank, after the reference's notice, and
    without ``--sharded``."""
    if not args.sharded:
        return None, None
    from vidcap_tpu_torch.parallel.distributed import (initialize_multihost,
                                                       launch)
    from vidcap_tpu_torch.parallel.mesh import make_mesh
    if initialize_multihost(args.device):
        return make_mesh(cfg.mesh), None
    cpu = args.device == "cpu"
    if not cpu:
        from vidcap_tpu_torch.inference import resolve_device
        resolve_device(args.device)   # no card and no --device cpu: exit 2
    import torch
    visible = None if cpu else torch.cuda.device_count()
    nm = cfg.mesh.num_model
    world = (cfg.mesh.num_data * nm if cfg.mesh.num_data != -1
             else 2 if cpu else visible)
    if visible is not None and world > visible:
        raise SystemExit(f"--sharded: a mesh of {world} ranks, only "
                         f"{visible} cards visible")
    if world < 2:
        print("[vidcap] --sharded requested but only one device visible; "
              "running single-device", file=sys.stderr)
        return None, None
    nd = world // nm
    print(f"[vidcap] --sharded: {world} processes "
          f"({'gloo on the CPU' if cpu else 'NCCL, one a card'}), mesh "
          f"data {nd} x model {nm}", file=sys.stderr, flush=True)
    return None, launch(args.argv, world, stdin=stdin)


def _load_dataset(cfg: Config, split: str):
    from vidcap_tpu_torch.data.loader import CaptionDataset
    # the e2e presets (use_backbone) train on raw frames, so their synthetic
    # fixture holds pixels [N, T, S, S, 3], not feature vectors
    pixels = cfg.model.use_backbone
    if cfg.data.dataset == "synthetic":
        return CaptionDataset.synthetic(cfg.data, pixels=pixels)
    load = (CaptionDataset.from_frame_files if pixels
            else CaptionDataset.from_files)
    splits = [split] + (["val"] if split == "test" else [])
    for i, s in enumerate(splits):
        try:
            ds = load(cfg.data, split=s)
            if i > 0:
                print(f"[vidcap] no {split!r} split on disk — using {s!r}",
                      file=sys.stderr)
            return ds
        except FileNotFoundError as e:
            err = e
    print(f"[vidcap] dataset assets not found ({err}); "
          f"falling back to the synthetic fixture", file=sys.stderr)
    return CaptionDataset.synthetic(cfg.data, pixels=pixels)


def _captioner(args, cfg: Config, dataset, mesh=None):
    """The captioner of ``caption``/``sample``/``serve``: the parameters of
    ``--weights`` or of the newest checkpoint in ``--checkpoint-dir``
    (default ``train.checkpoint_dir``); ``mesh``: a rank's."""
    from vidcap_tpu_torch.inference import Captioner
    if args.weights and args.checkpoint_dir:
        raise SystemExit("give --weights or --checkpoint-dir, not both")
    return Captioner.from_checkpoint(
        cfg, dataset, weights=args.weights, device=args.device,
        seed=getattr(args, "seed", None), checkpoint_dir=None
        if args.weights else (args.checkpoint_dir or cfg.train.checkpoint_dir),
        mesh=mesh)


def _load_export(args, cfg: Config):
    """``--from-export DIR``: the artifact on ``--device``, checked against
    the preset's feature shape and the flags; a flag that conflicts with
    what the artifact froze is an error, never a decode with another
    method or width."""
    from vidcap_tpu_torch.export import ExportedCaptioner
    try:
        ec = ExportedCaptioner.load(args.from_export, device=args.device)
        ec.check_config(cfg)
    except ValueError as e:
        raise SystemExit(f"--from-export: {e}") from None
    if args.method and args.method != ec.meta["method"]:
        raise SystemExit(f"--method {args.method} conflicts with the "
                         f"artifact (exported {ec.meta['method']}); the "
                         f"decode is frozen at export time")
    if (args.beam is not None and ec.meta["method"] == "beam"
            and args.beam != ec.meta["beam_width"]):
        raise SystemExit(f"--beam {args.beam} conflicts with the artifact "
                         f"(exported beam_width {ec.meta['beam_width']})")
    return ec


def _write_results(results: dict, out: Optional[str], head: int) -> None:
    if out:
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[vidcap] wrote {len(results)} captions → {out}",
              file=sys.stderr)
    else:
        for vid, caps in list(results.items())[:head]:
            print(f"{vid}\t{caps[0]}")


def _report(cap, method: str) -> None:
    """The stderr line that says what the decode ran: decodes, steps, the
    device, K3's W_out mode and the kernel launches."""
    mode = ""
    if cap.rollout_resident is not None and cap.device.type == "cuda":
        mode = "; rollout W_out " + ("resident" if cap.rollout_resident
                                     else "streamed")
    print(f"[vidcap] {method}: {cap.decode_calls} decodes, "
          f"{cap.decode_steps} steps on {cap.device}{mode}; kernel launches "
          f"{json.dumps(launch_counts)}", file=sys.stderr)


def _decode_split(args, cfg: Config, method: str, beam: int = 5,
                  nbest: int = 1) -> None:
    dataset = _load_dataset(cfg, split=args.split)
    cap = _captioner(args, cfg, dataset)
    results = cap.caption_dataset(method=method, beam_width=beam,
                                  temperature=args.temperature, nbest=nbest)
    _write_results(results, args.out, head=20)
    _report(cap, method)


def cmd_train(args) -> int:
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
    if args.feature_bank:
        train_over["device_feature_bank"] = True
    # --steps-per-dispatch mirrors --steps: one K for every stage or a comma
    # list matched to --stages (e.g. --stages xe,scst --steps-per-dispatch
    # 8,4)
    per_stage_k = None
    if args.steps_per_dispatch is not None:
        ks = [int(s) for s in str(args.steps_per_dispatch).split(",")]
        if len(ks) > 1:
            per_stage_k = ks
        train_over["steps_per_dispatch"] = ks[0]
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             **train_over))
    stages = [s.strip() for s in args.stages.split(",")] if args.stages \
        else [cfg.train.stage]
    if per_stage_steps is not None and len(per_stage_steps) != len(stages):
        raise SystemExit(f"--steps lists {len(per_stage_steps)} counts for "
                         f"{len(stages)} stages")
    if per_stage_k is not None and len(per_stage_k) != len(stages):
        raise SystemExit(f"--steps-per-dispatch lists {len(per_stage_k)} "
                         f"values for {len(stages)} stages")
    from vidcap_tpu_torch.inference import resolve_device
    from vidcap_tpu_torch.train.loop import train
    from vidcap_tpu_torch.utils.logging import MetricsLogger
    resolve_device(args.device)   # no card and no --device cpu: exit 2 now
    # --sharded: multi-card training over every visible card, the batch
    # over the mesh's data axis, the vocab seam on its model axis
    mesh, rc = _sharded_mesh(args, cfg)
    if rc is not None:
        return rc
    dataset = _load_dataset(cfg, split="train")
    val_dataset = None
    if cfg.data.dataset != "synthetic":
        from vidcap_tpu_torch.data.loader import CaptionDataset
        load = (CaptionDataset.from_frame_files if cfg.model.use_backbone
                else CaptionDataset.from_files)
        try:
            val_dataset = load(cfg.data, split="val")
        except FileNotFoundError:
            pass   # periodic eval falls back to a train subset
    logger = MetricsLogger(path=args.log_file if mesh is None
                           or mesh.rank == 0 else None)
    # the staged schedule: each stage resumes from the previous stage's
    # checkpoint, and the step counts are cumulative
    total = 0
    try:
        for i, stage in enumerate(stages):
            total += (per_stage_steps[i] if per_stage_steps is not None
                      else cfg.train.num_steps)
            scfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, stage=stage, num_steps=total,
                steps_per_dispatch=(per_stage_k[i] if per_stage_k is not None
                                    else cfg.train.steps_per_dispatch)))
            train(scfg, dataset=dataset, logger=logger,
                  resume=args.resume or i > 0, device=args.device,
                  val_dataset=val_dataset, mesh=mesh)
    finally:
        logger.close()
        if mesh is not None:
            from vidcap_tpu_torch.parallel.distributed import shutdown
            shutdown()
    return 0


def _input_paths(items, from_export: bool = False) -> list:
    """``--inputs`` → the ``.npy`` and video paths (``.npy`` only with
    ``--from-export``), directories scanned, each file once (by
    normpath)."""
    from vidcap_tpu_torch.serving import _VIDEO_EXTS
    exts = (".npy",) if from_export else _VIDEO_EXTS + (".npy",)
    paths = []
    for item in items:
        if os.path.isdir(item):
            found = sorted(os.path.join(item, f) for f in os.listdir(item)
                           if f.lower().endswith(exts))
            if not found:
                print(f"[vidcap] warning: no matching "
                      f"{'/'.join(exts)} files in {item!r}", file=sys.stderr)
            paths.extend(found)
        elif os.path.exists(item):
            if not item.lower().endswith(exts):
                raise SystemExit(
                    f"--inputs: {item!r} is not a supported input "
                    f"({', '.join(exts)})" + (
                        "; raw videos need the live model — drop "
                        "--from-export" if from_export
                        and item.lower().endswith(_VIDEO_EXTS) else ""))
            paths.append(item)
        else:
            raise SystemExit(f"--inputs: {item!r} does not exist")
    # 'dir/f.npy' from a scan and './dir/f.npy' given by hand are one file
    paths = list(dict.fromkeys(os.path.normpath(p) for p in paths))
    if not paths:
        raise SystemExit("--inputs matched no files")
    return paths


def _caption_inputs(args, cfg: Config, method: str, nbest: int) -> None:
    """``caption --inputs FILE|DIR ...``: the given feature files (and
    video files, through cv2 and the IRv2 backbone: serving.py's loader)
    in batches of min(files, train.batch_size), zero-padded, with frame
    masks; with ``--from-export`` in batches of the artifact's size (a polymorphic one:
    as without). Keys are basenames, or the full path where two files share
    one."""
    from collections import Counter

    import numpy as np

    from vidcap_tpu_torch.serving import _FeatureLoader, _pad_batch
    paths = _input_paths(args.inputs, from_export=bool(args.from_export))
    base_of = {p: os.path.splitext(os.path.basename(p))[0] for p in paths}
    dup = {b for b, n in Counter(base_of.values()).items() if n > 1}
    B = max(1, min(len(paths), cfg.train.batch_size))
    if args.from_export:
        cap = _load_export(args, cfg)
        method, B = cap.meta["method"], cap.batch_size or B
        # --beam goes through so the artifact validates it
        decode = lambda batch, mask: cap.decode_batch(
            batch, beam_width=args.beam, frame_mask=mask)
    else:
        # the train split supplies the vocab the checkpoint was trained with
        cap = _captioner(args, cfg, _load_dataset(cfg, split="train"))
        decode = lambda batch, mask: cap.decode_batch(
            batch, method=method,
            beam_width=args.beam or cfg.decode.beam_width,
            temperature=args.temperature, frame_mask=mask, nbest=nbest)
    vocab = cap.dataset.vocab
    loader = _FeatureLoader(cfg, cap.device)
    results = {}
    for i in range(0, len(paths), B):
        chunk = paths[i:i + B]
        batch, mask = _pad_batch(cfg, [loader(p) for p in chunk], B)
        toks = np.asarray(decode(batch, mask))[:len(chunk)]
        for p, row in zip(chunk, toks):
            key = p if base_of[p] in dup else base_of[p]
            results[key] = ([vocab.decode_str(r) for r in row]
                            if nbest > 1 else [vocab.decode_str(row)])
    _write_results(results, args.out, head=len(results))
    _report(cap, method)


def cmd_caption(args) -> int:
    cfg = apply_overrides(get_preset(args.preset), args.set)
    method = args.method or cfg.decode.method
    if args.nbest > 1 and (method != "beam" or args.from_export):
        raise SystemExit(f"--nbest {args.nbest} requires --method beam and "
                         "the live model (an export artifact returns the "
                         "single best hypothesis)")
    if args.inputs:
        _caption_inputs(args, cfg, method, args.nbest)
    elif args.from_export:
        # the artifact is the model: no checkpoint, no model build from the
        # preset; the split supplies only the features
        import numpy as np
        dataset = _load_dataset(cfg, split=args.split)
        ec = _load_export(args, cfg)
        caps = ec.caption(np.asarray(dataset.features, np.float32))
        _write_results({vid: [c] for vid, c in zip(dataset.video_ids, caps)},
                       args.out, head=20)
        _report(ec, ec.meta["method"])
    else:
        _decode_split(args, cfg, method,
                      beam=args.beam or cfg.decode.beam_width,
                      nbest=args.nbest)
    return 0


def cmd_sample(args) -> int:
    _decode_split(args, apply_overrides(get_preset(args.preset), args.set),
                  "sample")
    return 0


def cmd_export(args) -> int:
    """Write the artifact of the preset's decode (export.py) from a
    checkpoint that exists or a ``--weights`` file: never from the random
    init."""
    from vidcap_tpu_torch.export import export_decoder
    cfg = apply_overrides(get_preset(args.preset), args.set)
    dataset = _load_dataset(cfg, split="train")   # supplies the vocab
    cap = _captioner(args, cfg, dataset)
    try:
        meta = export_decoder(
            cap, args.out, batch_size=args.batch,
            method=args.method or cfg.decode.method,
            beam_width=args.beam or cfg.decode.beam_width,
            platforms=args.platforms.split(",") if args.platforms else None)
    except ValueError as e:
        raise SystemExit(f"export: {e}") from None
    print(f"[vidcap] exported {meta['method']} decoder "
          f"(B={meta['batch_size'] or 'polymorphic'}, "
          f"platforms={meta['platforms']}) → {args.out}", file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    """Caption the feature paths of stdin, or of HTTP requests with
    ``--http``, until stdin ends (or the HTTP server is interrupted); the
    last stderr line reports the decodes and kernel launches, the warmup's
    included. ``--sharded``: every rank decodes its rows of each flush;
    rank 0 reads the requests, sends each flush to the others and
    answers."""
    cfg = apply_overrides(get_preset(args.preset), args.set)
    if args.sharded and args.from_export:
        raise SystemExit("--from-export artifacts decode on one device; "
                         "--sharded requires a checkpoint or --weights")
    mesh, rc = _sharded_mesh(args, cfg, stdin=args.http is None)
    if rc is not None:
        return rc
    if mesh is not None:
        return _serve_rank(args, cfg, mesh)
    return _serve(args, cfg)


def _serve_rank(args, cfg: Config, mesh) -> int:
    """One rank of ``serve --sharded``: rank 0 serves (its captioner sends
    each flush to the others), the others decode what it sends until it
    stops them."""
    from vidcap_tpu_torch.parallel import sharding
    from vidcap_tpu_torch.parallel.distributed import shutdown
    try:
        cap = _captioner(args, cfg, _load_dataset(cfg, split="train"), mesh)
        if mesh.rank != 0:
            if cap.device.type == "cuda":   # rank 0's warmup builds its own
                from vidcap_tpu_torch.ops import _build
                _build.build_all(cap.kernels(
                    args.method or cfg.decode.method,
                    args.beam or cfg.decode.beam_width))
            sharding.follow(cap)
            return 0
        cap.lead = True
        try:
            return _serve(args, cfg, cap)
        finally:
            sharding.stop_followers(mesh)
    finally:
        shutdown()


def _serve(args, cfg: Config, cap=None) -> int:
    from vidcap_tpu_torch.serving import CaptionServer, make_http_server
    if cap is not None:
        method = args.method or cfg.decode.method
        beam = args.beam or cfg.decode.beam_width
    elif args.from_export:
        # the artifact is the model: method, beam width and (unless it is
        # batch-polymorphic) the batch come from its meta, not the flags
        cap = _load_export(args, cfg)
        method, beam = cap.meta["method"], cap.meta["beam_width"] or 5
        args.batch = cap.batch_size or args.batch
        print(f"[vidcap] serving from export artifact ({method}, "
              f"B={cap.batch_size})", file=sys.stderr)
    else:
        cap = _captioner(args, cfg, _load_dataset(cfg, split="train"))
        method = args.method or cfg.decode.method
        beam = args.beam or cfg.decode.beam_width
    if args.http is not None:
        server, svc = make_http_server(
            cfg, cap, port=args.http, batch_size=args.batch, method=method,
            beam_width=beam,
            max_wait_ms=(args.max_wait_ms if args.max_wait_ms is not None
                         else 20.0),
            max_queue=args.max_queue, path_root=args.path_root)
        host, port = server.server_address[:2]
        print(f"[vidcap] serving HTTP on {host}:{port} "
              f"(POST /caption, GET /healthz)", file=sys.stderr, flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
            svc.close()
            print(f"[vidcap] {svc.stats()}", file=sys.stderr)
    else:
        server = CaptionServer(cfg, cap, batch_size=args.batch, method=method,
                               beam_width=beam, max_wait_ms=args.max_wait_ms,
                               pipeline_depth=args.pipeline_depth)
        server.warmup()
        print(f"[vidcap] serving stdin ({method}, B={args.batch})",
              file=sys.stderr, flush=True)
        server.run(warmup=False)
    _report(cap, method)
    return 0


def cmd_eval(args) -> int:
    """Score a captions json against ``--refs`` {video_id: [reference,
    ...]}, or against the references of the preset's ``--split``. Videos
    without references (none, or an empty list) are skipped and counted."""
    with open(args.captions) as f:
        results = json.load(f)
    if args.refs:
        with open(args.refs) as f:
            refs = json.load(f)
        # a bare string would score per character: refuse the shape
        if not isinstance(refs, dict):
            raise SystemExit(f"--refs must be a json object "
                             f"{{video_id: [reference, ...]}}, got "
                             f"{type(refs).__name__}")
        for vid, r in refs.items():
            if (not isinstance(r, list)
                    or not all(isinstance(c, str) for c in r)):
                raise SystemExit(
                    f"--refs[{vid!r}] must be a list of reference "
                    f"strings, got {r!r:.80}")
    else:
        cfg = apply_overrides(get_preset(args.preset), args.set)
        refs = _load_dataset(cfg, split=args.split).video_captions
    gts = {v: refs[v] for v in results if refs.get(v)}
    skipped = len(results) - len(gts)
    if skipped:
        print(f"[vidcap] {skipped} candidate video(s) have no references — "
              f"skipped", file=sys.stderr)
    if not gts:
        raise SystemExit("no video ids in common between --captions and the "
                         "references")
    from vidcap_tpu_torch.metrics.evaluate import evaluate_captions
    print(json.dumps(evaluate_captions(gts, results), indent=1))
    return 0


def cmd_extract(args) -> int:
    from vidcap_tpu_torch.data.frames import extract_features_for_dir
    cfg = apply_overrides(get_preset(args.preset), args.set)
    extract_features_for_dir(cfg, args.videos, args.split, fmt=args.format,
                             device=args.device)
    return 0


def cmd_convert(args) -> int:
    """The backbone's parameters do not depend on the preset, so it takes
    ``--preset``/``--set`` only as every command does."""
    from vidcap_tpu_torch.convert import convert_irv2_checkpoint_to_npz
    out = convert_irv2_checkpoint_to_npz(args.tf_checkpoint, args.out)
    print(f"[vidcap] wrote converted backbone weights → {out}",
          file=sys.stderr)
    return 0


def cmd_info(args) -> int:
    """Preflight: the card, the preset's dims, the parameter census (the
    model built on the meta device: nothing allocated), a rough train-step
    memory estimate, the beam's logits buffer, the kernels' build cache.
    The keys of the JAX package's ``info``, with torch and CUDA in place of
    jax; ``backend`` also gives the card's memory."""
    import torch

    from vidcap_tpu_torch.utils.meminfo import (build_cache_stats,
                                                decode_buffer_estimate,
                                                param_census,
                                                train_memory_estimate)
    cfg = apply_overrides(get_preset(args.preset), args.set)
    census = param_census(cfg)
    mem = train_memory_estimate(cfg, census["_total"])
    dec = decode_buffer_estimate(cfg)
    cache = build_cache_stats()
    info = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "preset": args.preset,
        "mode": "pixels→CNN (end-to-end)" if cfg.model.use_backbone
                else "precomputed features",
        "stage": cfg.train.stage,
        "dims": {"T": cfg.data.num_frames, "D": cfg.data.feature_dim,
                 "H": cfg.model.hidden_dim, "A": cfg.model.attn_dim,
                 "E": cfg.model.embed_dim,
                 "vocab": cfg.data.vocab_size,
                 "padded_vocab": cfg.data.padded_vocab,
                 "max_caption_len": cfg.data.max_caption_len},
        "decode": {"method": cfg.decode.method,
                   "beam_width": cfg.decode.beam_width,
                   "max_len": cfg.decode.max_len},
        "params": census,
        "train_step_hbm_estimate_bytes": mem,
        "beam_logits_buffer": dec,
        "compile_cache": cache,
    }
    if not args.no_devices:
        if torch.cuda.is_available():
            props = torch.cuda.get_device_properties(0)
            free, total = torch.cuda.mem_get_info(0)
            info["backend"] = {"platform": "cuda", "device_kind": props.name,
                               "n_devices": torch.cuda.device_count(),
                               "total_memory_bytes": props.total_memory,
                               "free_memory_bytes": free,
                               "mem_get_info_total_bytes": total}
        else:
            info["backend"] = {"platform": "cpu",
                               "device_kind": "no CUDA device visible",
                               "n_devices": 0}
    if args.json:
        print(json.dumps(info, indent=1))
        return 0
    b = info.get("backend")
    if b:
        mem_s = (f", {b['total_memory_bytes'] / 1e9:.1f} GB "
                 f"({b['free_memory_bytes'] / 1e9:.1f} free)"
                 if "total_memory_bytes" in b else "")
        print(f"[info] torch {info['torch']} CUDA {info['cuda']}  backend="
              f"{b['platform']} {b['n_devices']}x {b['device_kind']}{mem_s}")
    else:
        print(f"[info] torch {info['torch']} CUDA {info['cuda']}  (devices "
              "not queried)")
    d = info["dims"]
    print(f"[info] preset {args.preset}: {info['mode']}, stage={info['stage']}"
          f", T={d['T']} D={d['D']} H={d['H']} vocab={d['vocab']} "
          f"(padded {d['padded_vocab']})")
    groups = ", ".join(f"{k} {v/1e6:.2f}M" for k, v in census.items()
                       if k != "_total")
    print(f"[info] params: {groups} — total {census['_total']/1e6:.2f}M "
          f"({census['_total']*4/1e6:.0f} MB f32)")
    micro = max(1, cfg.train.batch_size // max(1, cfg.train.grad_accum))
    print(f"[info] train step (microbatch B={micro}): rough device memory "
          f"{mem['total']/1e9:.2f} GB  (params+opt+grads "
          f"{(mem['params']+mem['optimizer']+mem['grads'])/1e9:.2f}, "
          f"activations {mem['activations']/1e9:.2f}, inputs "
          f"{mem['inputs']/1e9:.2f}) — estimate, not an allocator count")
    print(f"[info] decode method={info['decode']['method']}; a "
          f"beam-{info['decode']['beam_width']} decode at B="
          f"{cfg.train.batch_size} has per-step logits "
          f"[{int(dec['beam_logits_rows'])}, {int(dec['padded_vocab'])}] = "
          f"{dec['beam_logits_bytes']/1e6:.1f} MB (K2 keeps them on chip)")
    print(f"[info] kernel build cache {cache['path']}: {cache['entries']} "
          f"entries, {cache['bytes']/1e6:.0f} MB")
    return 0


def cmd_prepare(args) -> int:
    from vidcap_tpu_torch.data.prepare import prepare
    cfg = apply_overrides(get_preset(args.preset), args.set)
    prepare(cfg.data, args.annotations, mapping=args.mapping)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vidcap_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def preset(sp):
        sp.add_argument("--preset", default="msvd_greedy")
        sp.add_argument("--set", action="append", default=None,
                        metavar="SECTION.FIELD=VALUE",
                        help="override any config field, repeatable")

    def source(sp):
        sp.add_argument("--checkpoint-dir", default=None,
                        help="decode the newest checkpoint here (default: "
                             "the preset's train.checkpoint_dir)")
        sp.add_argument("--weights", default=None,
                        help="or a .npz of '/'-joined Flax parameter paths "
                             "(vidcap_tpu_torch.convert)")
        sp.add_argument("--device", default=None,
                        help="cuda (default) or cpu")

    def sharded(sp):
        sp.add_argument("--sharded", action="store_true",
                        help="every visible card: one process a card, the "
                             "batch over the mesh's data axis (mesh.num_data"
                             ", mesh.num_model); with --device cpu, gloo "
                             "processes")

    def common(sp):
        preset(sp)
        source(sp)
        sp.add_argument("--temperature", type=float, default=1.0)
        sp.add_argument("--seed", type=int, default=None,
                        help="reproducible sampling seed")
        sp.add_argument("--split", default="test",
                        help="dataset split to decode (default test; falls "
                             "back to val)")
        sp.add_argument("--out", default=None)

    c = sub.add_parser("caption", help="decode a split or files, write json")
    common(c)
    c.add_argument("--method", choices=["greedy", "beam", "sample"],
                   default=None)
    c.add_argument("--beam", type=int, default=None)
    c.add_argument("--nbest", type=int, default=1,
                   help="write the N best hypotheses per video (best first)")
    c.add_argument("--inputs", nargs="+", default=None, metavar="FILE|DIR",
                   help="caption these [T, D] feature .npy files or "
                        "video files (or directories of them) instead of a "
                        "split")
    c.add_argument("--from-export", default=None, metavar="DIR",
                   help="decode with an `export` artifact instead of a "
                        "checkpoint (with --inputs: .npy files only)")
    c.set_defaults(fn=cmd_caption)

    s = sub.add_parser("sample", help="multinomial-sampling decode")
    common(s)
    s.set_defaults(fn=cmd_sample)

    e = sub.add_parser("eval", help="score a captions json (BLEU/ROUGE-L/"
                                    "CIDEr-D/METEOR)")
    preset(e)
    e.add_argument("--captions", required=True)
    e.add_argument("--refs", default=None, metavar="REFS.json",
                   help="score against this {video_id: [reference, ...]} "
                        "json instead of the preset dataset's captions")
    e.add_argument("--split", default="test",
                   help="dataset split supplying references when --refs is "
                        "not given (default test; falls back to val)")
    e.set_defaults(fn=cmd_eval)

    pr = sub.add_parser("prepare",
                        help="convert MSVD/MSR-VTT annotation files to the "
                             "canonical data layout")
    preset(pr)
    pr.add_argument("annotations", nargs="+")
    pr.add_argument("--mapping", default=None,
                    help="MSVD youtube_mapping.txt fixing the canonical "
                         "vid1..vid1970 split ordering")
    pr.set_defaults(fn=cmd_prepare)

    t = sub.add_parser("train", help="run the preset's training stage(s)")
    preset(t)
    t.add_argument("--steps", default=None,
                   help="steps per stage: one count for all stages, or a "
                        "comma list matched to --stages (e.g. 2500,1000)")
    t.add_argument("--stages", default=None,
                   help="comma list overriding the preset stage, e.g. xe,scst")
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--log-file", default=None)
    t.add_argument("--eval-every", type=int, default=None,
                   help="override the preset's periodic-eval cadence "
                        "(0 disables)")
    t.add_argument("--log-every", type=int, default=None,
                   help="cadence of train log rows (0: only the last step)")
    t.add_argument("--checkpoint-dir", default=None)
    t.add_argument("--seed", type=int, default=None,
                   help="train.seed: the init, the batch order and the "
                        "sampling generator")
    t.add_argument("--device", default=None, help="cuda (default) or cpu")
    t.add_argument("--feature-bank", action="store_true",
                   help="keep the whole feature tensor on the device and "
                        "gather each step's rows there (feature mode)")
    t.add_argument("--steps-per-dispatch", default=None,
                   help="with --feature-bank: K steps a dispatch (one CUDA "
                        "graph on the card; checkpoints and validation at "
                        "chunk boundaries). One K or a comma list matched "
                        "to --stages (e.g. 8,4)")
    sharded(t)
    t.set_defaults(fn=cmd_train)

    ax = sub.add_parser("export", help="write a serving artifact: "
                                       "weights + vocab + meta")
    preset(ax)
    source(ax)
    ax.add_argument("--out", required=True, help="artifact directory")
    ax.add_argument("--batch", type=int, default=32,
                    help="fixed batch size of the artifact; 0 = batch-"
                         "polymorphic (each call decodes exactly its rows)")
    ax.add_argument("--method", choices=["greedy", "beam"], default=None)
    ax.add_argument("--beam", type=int, default=None)
    ax.add_argument("--platforms", default=None,
                    help="comma-separated devices the artifact may load "
                         "on: cuda, cpu (default: the --device exported on)")
    ax.set_defaults(fn=cmd_export)

    sv = sub.add_parser("serve", help="caption feature paths from stdin, or "
                                      "over HTTP")
    preset(sv)
    source(sv)
    sv.add_argument("--method", choices=["greedy", "beam", "sample"],
                    default=None)
    sv.add_argument("--beam", type=int, default=None)
    sv.add_argument("--batch", type=int, default=32)
    sv.add_argument("--seed", type=int, default=None,
                    help="reproducible sampling seed (method=sample)")
    sv.add_argument("--from-export", default=None, metavar="DIR",
                    help="serve an `export` artifact: no checkpoint; "
                         "method/beam/batch come from its meta")
    sharded(sv)
    sv.add_argument("--max-wait-ms", type=float, default=None,
                    help="flush a partial batch once its oldest request has "
                         "waited this long (default: wait for a full batch)")
    sv.add_argument("--pipeline-depth", type=int, default=1,
                    help="decode-worker queue depth overlapping input loading "
                         "with decoding (0 = serial)")
    sv.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve over HTTP instead of stdin: POST /caption "
                         "(.npy bytes or {\"path\": ...}), GET /healthz|/stats")
    sv.add_argument("--path-root", type=str, default=None,
                    help="enable HTTP JSON path mode, confined to this "
                         "directory (.npy features); disabled when unset")
    sv.add_argument("--max-queue", type=int, default=None,
                    help="bound on queued HTTP requests before 429 "
                         "(default 4×batch)")
    sv.set_defaults(fn=cmd_serve)

    x = sub.add_parser("extract", help="precompute CNN features for a "
                                       "video directory")
    preset(x)
    x.add_argument("--videos", required=True)
    x.add_argument("--split", default="train")
    x.add_argument("--format", choices=["npy", "h5", "tfrecord"],
                   default="npy", help="feature container format")
    x.add_argument("--device", default=None, help="cuda (default) or cpu")
    x.set_defaults(fn=cmd_extract)

    cv = sub.add_parser("convert",
                        help="TF-slim IRv2 checkpoint → backbone .npz "
                             "(load via VIDCAP_IRV2_WEIGHTS)")
    preset(cv)
    cv.add_argument("--tf-checkpoint", required=True,
                    help=".ckpt prefix or .npz of slim-named variables")
    cv.add_argument("--out", required=True, help="output .npz path")
    cv.set_defaults(fn=cmd_convert)

    inf = sub.add_parser("info", help="preset preflight census (params, "
                                      "memory estimate, build cache, card)")
    preset(inf)
    inf.add_argument("--json", action="store_true",
                     help="machine-readable output")
    inf.add_argument("--no-devices", action="store_true",
                     help="do not query the card")
    inf.set_defaults(fn=cmd_info)
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    args.argv = argv   # --sharded starts its workers with the same command
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
