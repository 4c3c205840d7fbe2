"""Dataset preparation: real MSVD / MSR-VTT annotation files → the framework's
canonical layout (SURVEY.md C3–C6; loader.CaptionDataset.from_files).

The image has no network, so downloads are out of scope; this converts the
datasets' standard annotation formats when the user provides them:

  MSVD     — the 'MSR Video Description Corpus' CSV (video_id, start, end,
             language, caption) or a simple TSV/video-captions JSON
  MSR-VTT  — train_val_videodatainfo.json / test_videodatainfo.json
             ({"videos": [{video_id, split}], "sentences": [{video_id, caption}]})

Output layout under cfg.data.data_dir:
  {ds}_captions.json        {video_id: [caption, ...]}
  {ds}_{split}_ids.json     [video_id, ...]
  {ds}_vocab.json           built from the train split
  {ds}_{split}_feats.npy    via cli `extract` (needs the videos + backbone;
                            the JAX package's CLI has it, ROADMAP item 11)

A copy of ``vidcap_tpu/data/prepare.py`` so the PyTorch package imports
nothing of the JAX one; tests/test_torch_offline.py holds the files the two
write byte-equal.
"""
from __future__ import annotations

import csv
import json
import os
from collections import defaultdict
from typing import Dict, List, Tuple

from vidcap_tpu_torch.config import DataConfig
from vidcap_tpu_torch.data.vocab import build_vocab

# canonical MSVD split sizes (1200/100/670 by video index, the standard split)
_MSVD_SPLITS = {"train": (0, 1200), "val": (1200, 1300), "test": (1300, 1970)}


def parse_msvd_mapping(path: str) -> Dict[str, int]:
    """The youtube2text ``youtube_mapping.txt``: lines of
    ``<YoutubeID>_<Start>_<End> vidN`` — the dataset's FIXED video ordering
    that defines the canonical 1200/100/670 split. Returns {video_key: N}."""
    order: Dict[str, int] = {}
    with open(path, encoding="utf-8", errors="ignore") as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2 or not parts[1].startswith("vid"):
                continue
            order[parts[0]] = int(parts[1][3:])
    if not order:
        raise ValueError(f"no 'key vidN' lines found in {path}")
    return order


def parse_msvd_csv(path: str) -> Dict[str, List[str]]:
    """The MSVD corpus CSV: columns include VideoID, Start, End, Language,
    Description. English rows only; video key = f'{VideoID}_{Start}_{End}'."""
    caps: Dict[str, List[str]] = defaultdict(list)
    with open(path, newline="", encoding="utf-8", errors="ignore") as f:
        reader = csv.DictReader(f)
        cols = {c.lower(): c for c in reader.fieldnames or []}
        vid_c = cols.get("videoid", "VideoID")
        s_c, e_c = cols.get("start", "Start"), cols.get("end", "End")
        lang_c = cols.get("language", "Language")
        desc_c = cols.get("description", "Description")
        for row in reader:
            if row.get(lang_c, "English").strip() != "English":
                continue
            desc = (row.get(desc_c) or "").strip()
            if not desc:
                continue
            vid = f"{row[vid_c]}_{row[s_c]}_{row[e_c]}"
            caps[vid].append(desc)
    return dict(caps)


def parse_msrvtt_json(*paths: str) -> Tuple[Dict[str, List[str]],
                                            Dict[str, List[str]]]:
    """MSR-VTT videodatainfo json(s) → (captions, split→video_ids)."""
    caps: Dict[str, List[str]] = defaultdict(list)
    splits: Dict[str, List[str]] = defaultdict(list)
    for path in paths:
        with open(path) as f:
            data = json.load(f)
        for v in data.get("videos", []):
            split = v.get("split", "train")
            split = {"validate": "val"}.get(split, split)
            splits[split].append(v["video_id"])
        for s in data.get("sentences", []):
            caps[s["video_id"]].append(s["caption"])
    return dict(caps), dict(splits)


def prepare(cfg: DataConfig, annotations: List[str],
            mapping: str = None) -> None:
    """Write the canonical files for cfg.dataset from the given annotation paths.

    ``mapping`` (MSVD only): path to the youtube2text ``youtube_mapping.txt``
    that fixes the canonical vid1..vid1970 ordering; without it the split
    falls back to sorted caption keys — NOT the standard split, results are
    not comparable to published numbers (warned loudly)."""
    os.makedirs(cfg.data_dir, exist_ok=True)
    ds = cfg.dataset
    if ds == "msvd":
        caps = parse_msvd_csv(annotations[0])
        if mapping:
            order = parse_msvd_mapping(mapping)
            unknown = [v for v in order if v not in caps]
            if unknown:
                print(f"[vidcap] warning: {len(unknown)} mapped video(s) have "
                      f"no English captions (e.g. {unknown[0]!r})")
            vids = sorted((v for v in order if v in caps),
                          key=lambda v: order[v])
            # split by the vid index itself (vid1..1200 / 1201..1300 /
            # 1301..1970) so missing-caption videos never shift the boundaries
            splits = {name: [v for v in vids if a < order[v] <= b]
                      for name, (a, b) in _MSVD_SPLITS.items()}
        else:
            print("[vidcap] WARNING: no --mapping youtube_mapping.txt given — "
                  "falling back to a sorted-key split, which is NOT the "
                  "canonical MSVD 1200/100/670 split; scores will not be "
                  "comparable to published results")
            vids = sorted(caps.keys())
            splits = {name: vids[a:b] for name, (a, b) in _MSVD_SPLITS.items()}
    elif ds == "msrvtt":
        caps, splits = parse_msrvtt_json(*annotations)
    else:
        raise ValueError(f"no preparer for dataset {ds!r}")

    with open(os.path.join(cfg.data_dir, f"{ds}_captions.json"), "w") as f:
        json.dump(caps, f)
    for split, ids in splits.items():
        with open(os.path.join(cfg.data_dir, f"{ds}_{split}_ids.json"),
                  "w") as f:
            json.dump(ids, f)

    train_ids = set(splits.get("train", []))
    train_caps = [c for v, cs in caps.items() if v in train_ids for c in cs]
    vocab = build_vocab(train_caps, min_count=cfg.min_word_count,
                        max_size=cfg.vocab_size)
    vocab.save(os.path.join(cfg.data_dir, f"{ds}_vocab.json"))
    print(f"[vidcap] prepared {ds}: {len(caps)} videos, "
          f"{sum(len(v) for v in caps.values())} captions, "
          f"vocab {vocab.size}; splits: "
          f"{ {k: len(v) for k, v in splits.items()} }")
