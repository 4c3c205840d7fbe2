"""The benchmark's calls into the program (``vidcap_tpu_torch``) for the
decode cells: a captioner on the benchmark's weights, the
program's launch counters, spans around the decode's inner calls in a
traced run, and the judgement of decoded rows by the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from benchmark import weights
from benchmark.reference import decode_check

EOS, PAD = 2, 0


def vocab_words(V: int):
    """The decode cells' vocabulary: the four specials, then ``w<id>``."""
    return ["<pad>", "<bos>", "<eos>", "<unk>"] + [f"w{i}"
                                                  for i in range(4, V)]


def captioner(r) -> Tuple[object, Dict[str, torch.Tensor]]:
    """(a ``Captioner`` of the cell's configuration on the benchmark's
    weights, the weights)."""
    from vidcap_tpu_torch.data.loader import CaptionDataset
    from vidcap_tpu_torch.data.vocab import Vocab
    from vidcap_tpu_torch.inference import Captioner
    from vidcap_tpu_torch.models.model import create_model
    cfg = r.program_config()
    s = weights.sizes(r.cfg)
    words = vocab_words(s["V"])
    vocab = Vocab({w: i for i, w in enumerate(words)}, words)
    ds = CaptionDataset(np.zeros((1, s["T"], s["D"]), np.float32), ["v0"],
                        {"v0": [words[4]]}, cfg.data, vocab=vocab)
    W = weights.make(r.cfg, r.seed, r.device)
    model = create_model(cfg, vocab_size=s["V"]).to(r.device)
    weights.load_into(model, W)
    return Captioner(cfg, model.eval(), ds, r.device), W


def launches() -> Dict[str, int]:
    from vidcap_tpu_torch.ops import _build
    return dict(_build.launch_counts)


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    now = launches()
    return {k: now[k] - before.get(k, 0) for k in now}


def inner_spans(r) -> None:
    """Spans of a traced run around the calls inside a decode: the decode
    loop (``models/decoding.py::beam_decode``), each beam step, and the
    launch of K1 and of the projection (K2)."""
    from vidcap_tpu_torch import inference
    from vidcap_tpu_torch.models import decoding
    sp = r.spans

    def wrap(fn, name):
        def wrapped(*a, **k):
            with sp.span(name):
                return fn(*a, **k)
        return wrapped

    inference.beam_decode = wrap(inference.beam_decode,
                                 "decode_loop.beam_decode")
    make_step = inference.fused_beam_step
    inference.fused_beam_step = lambda *a, **k: wrap(
        make_step(*a, **k), "decode_loop.beam_step")
    decoding.beam_core = wrap(decoding.beam_core, "kernels.beam_core")
    decoding.VocabProjection.topk = wrap(decoding.VocabProjection.topk,
                                         "kernels.topk_project")


def lengths(tokens: np.ndarray) -> np.ndarray:
    """Real tokens a row: up to and including the first <eos>."""
    is_eos = tokens == EOS
    first = np.where(is_eos.any(1), is_eos.argmax(1) + 1, tokens.shape[1])
    return first


def malformed(tokens: np.ndarray, vocab: int) -> int:
    """Rows with an id outside the vocabulary, or a non-<pad> after the
    first <eos>."""
    bad = ((tokens < 0) | (tokens >= vocab)).any(1)
    n = lengths(tokens)
    after = np.arange(tokens.shape[1])[None, :] >= n[:, None]
    return int((bad | ((tokens != PAD) & after).any(1)).sum())


def judge(r, W: Dict[str, torch.Tensor], feats: np.ndarray,
          tokens: np.ndarray, K: int) -> Dict[str, float]:
    """The reference's judgement of decoded beam rows
    (``reference/decode_check.py``) in the configuration's compute dtype:
    the share of rows that its beam search cannot keep even where it may
    prefer the row's prefix within the cell's near-tie ``margin``."""
    s = weights.sizes(r.cfg)
    cd = getattr(torch, r.cfg["compute_dtype"])
    mask = np.ones(feats.shape[:2], np.float32)
    _, kept = decode_check.beam(
        W, feats.astype(np.float32), mask, K, tokens.shape[1], s["V"], cd,
        r.device, follow=tokens, margin=r.params["margin"])
    r.data["check"] = {"rows": len(tokens)}
    return {"unexplained_rows": float((~kept).mean())}
