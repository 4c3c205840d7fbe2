"""Int8 vocab projection against bf16 on trained weights: the port's
counterpart of ``scripts/eval_int8_quality.py``.

Decodes the val split of a corpus (e.g. scripts/torch_scale_corpus.py's 500
videos) from the newest checkpoint of a run with the bf16 beam (K1 + K2)
and with the int8 beam (``decode.int8_vocab_projection``: K1 + K2-int8) of
``msrvtt_attn_beam5``, scores both with the host metrics, and records the
share of videos whose captions differ, each beam's launches and its
captions/s (the two decodes of each batch interleaved). Runs on the card.

    python scripts/torch_int8_quality.py CKPT_DIR DATA_DIR [OUT_JSON]
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from vidcap_tpu_torch.config import Config, get_preset  # noqa: E402
from vidcap_tpu_torch.data.loader import CaptionDataset  # noqa: E402
from vidcap_tpu_torch.inference import Captioner  # noqa: E402
from vidcap_tpu_torch.metrics.evaluate import evaluate_captions  # noqa: E402
from vidcap_tpu_torch.ops import _build  # noqa: E402

BATCH = 100   # the reference script's batch


def scale_config(data_dir: str) -> Config:
    cfg = get_preset("msrvtt_attn_beam5")
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, data_dir=data_dir))


def int8_ab(cap: Captioner, batch: int = BATCH) -> Dict:
    """The bf16 and the int8 beam of ``cap``'s model on its dataset."""
    cfg, val = cap.cfg, cap.dataset
    int8 = Captioner(dataclasses.replace(cfg, decode=dataclasses.replace(
        cfg.decode, int8_vocab_projection=True)), cap.model, val, cap.device)
    beams = {"bf16": cap, "int8": int8}
    caps = {name: {} for name in beams}
    walls = {name: 0.0 for name in beams}
    launches = {}
    for name, c in beams.items():   # warm-up: builds, casts, quantizes
        c.decode_batch(val.features[:batch], beam_width=cfg.decode.beam_width)
    for name in beams:
        launches[name] = {k: 0 for k in _build.KERNELS}
    for i, b in enumerate(val.video_batches(batch)):
        order = list(beams) if i % 2 == 0 else list(beams)[::-1]
        for name in order:
            _build.reset_counts()
            t0 = time.perf_counter()
            toks = beams[name].decode_batch(b.features,
                                            beam_width=cfg.decode.beam_width)
            walls[name] += time.perf_counter() - t0
            for k, n in _build.launch_counts.items():
                launches[name][k] += n
            for row, vidx in zip(toks, b.video_idx):
                vid = val.video_ids[int(vidx)]
                caps[name].setdefault(vid, [val.vocab.decode_str(row)])
    refs = {v: val.video_captions[v] for v in caps["bf16"]}
    scores = {name: evaluate_captions(refs, c) for name, c in caps.items()}
    differ = float(np.mean([caps["bf16"][v] != caps["int8"][v]
                            for v in refs]))
    return dict(videos=len(refs),
                val_cider={n: s["CIDEr"] for n, s in scores.items()},
                val_bleu4={n: s["Bleu_4"] for n, s in scores.items()},
                captions_differing=differ,
                launches=launches,
                captions_per_s={n: len(refs) / w for n, w in walls.items()})


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    cfg = scale_config(argv[1])
    val = CaptionDataset.from_files(cfg.data, split="val")
    cap = Captioner.from_checkpoint(cfg, val, checkpoint_dir=argv[0])
    out = int8_ab(cap)
    line = json.dumps(out)
    if len(argv) == 3:
        with open(argv[2], "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
