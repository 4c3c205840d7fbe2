"""The training cell's control and faults: the reference put in the
program's place, computed in float8 (e4m3), the nearest precision below
the configuration's bfloat16, with its own rollouts (multinomial samples
from its own generator, greedy by argmax), driven through the cell's first
``check_steps`` steps on batches of the corpus drawn from the seed; then
judged by the cell's own check (``traffic/scst_train.py::_check``) as the
program is.

Faults, planted in the reference put in the program's place (``fault``):

* ``half``: half of the batch left out, the loss's means taken over the
  rest;
* ``token``: each greedy caption's first token altered where it is
  produced.

A step that returns its state unchanged reads 1 on the change by its
definition and is not run.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from benchmark import corpus, harness, weights
from benchmark.reference import scst as ref
from benchmark.reference.captions import Corpus


def run(cell: Dict, seed: int, fault: Optional[str] = None,
        device: str = "cuda:0", control: bool = False) -> Tuple[Dict, Dict]:
    cfg, p = cell["cfg"], cell["traffic_params"]
    dev = torch.device(device)
    s = weights.sizes(cfg)
    caps = corpus.captions(p["corpus"], seed)
    feats = corpus.features(len(caps), s["T"], s["D"], seed, dev, salt=1)
    corp = Corpus(caps, cfg["vocab_size"], cfg["min_word_count"],
                  cfg["max_caption_len"], cfg["num_attributes"])
    W0 = weights.make(cfg, seed, dev)
    W = {n: t.detach().clone().requires_grad_(True) for n, t in W0.items()}
    adam = ref.Adam(W, cfg["scst_learning_rate"])
    cd = torch.float8_e4m3fn if control else getattr(torch,
                                                      cfg["compute_dtype"])
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x435452]))
    B = cfg["batch_size"]
    caption_video = np.repeat(np.arange(len(caps)),
                              [len(c) for c in caps.values()])
    caption_row = np.concatenate([np.arange(len(c)) for c in caps.values()])
    steps, g1 = [], None
    for i in range(p["check_steps"]):
        pick = rng.choice(len(caption_video), B, replace=False)
        vidx = caption_video[pick]
        gt = np.array([corp.encoded[corp.video_ids[v]][j] for v, j in
                       zip(vidx, caption_row[pick])], np.int32)
        attrs = corp.attributes[vidx]
        f = torch.as_tensor(feats[vidx], device=dev)
        sample, greedy = ref.rollouts({n: w.detach() for n, w in W.items()},
                                      f, cfg, cd, gen)
        if fault == "token":
            greedy[:, 0] = (greedy[:, 0] + 1) % cfg["vocab_size"]
        use = slice(0, B // 2) if fault == "half" else slice(0, B)
        total, _ = ref.loss(
            W, corp, f[use], vidx[use], torch.as_tensor(gt[use], device=dev),
            sample[use], greedy[use], torch.as_tensor(attrs[use], device=dev),
            cfg, cd)
        g = ref.clipped_grads(W, total, cfg["grad_clip_norm"])
        if i == 0:
            g1 = {n: float(x.norm()) for n, x in g.items()}
        adam.update(W, g)
        steps.append({"video_idx": vidx, "tokens": gt, "attributes": attrs,
                      "loss": float(total.detach()),
                      "sample": sample.cpu().numpy(),
                      "greedy": greedy.cpu().numpy()})
    d3 = {n: float((W[n].detach() - W0[n]).norm()) for n in W}
    del W, adam
    from benchmark.traffic import scst_train
    r = harness.Run(cell["name"], seed, 0, False, device, cell=cell)
    scst_train._check(r, caps, feats, W0, steps, g1, d3)
    return r.numbers, {"check_steps": r.data.get("check_steps")}
