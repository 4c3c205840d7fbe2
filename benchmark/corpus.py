"""Inputs made from the seed: feature pools for the decode cells, and the
training corpus at MSR-VTT's training-split size (Xu et al., CVPR 2016:
6,513 videos x 20 captions) for the training cell.

Features are N(0, 1) f32, drawn on the card (or the CPU in tests) in one
call and brought to the host, where the program's callers hold them.
Captions are words of a Zipf-distributed pool, with lengths 3 + a negative
binomial (mean near 9 words, a tail to the longest the port keeps, 29), so
that the port's vocabulary of the most frequent words fills its size and
many reference words fall outside it (``<unk>``), as in a real corpus.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def features(n: int, T: int, D: int, seed: int, device, salt: int = 0
             ) -> np.ndarray:
    """f32[n, T, D] N(0, 1) on the host, drawn on ``device`` from ``seed``
    (``salt`` separates the draws of one seed)."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + salt) % (1 << 63) if salt else seed)
    x = torch.randn((n, T, D), generator=gen, device=device)
    return x.cpu().numpy()


def word(i: int) -> str:
    """The pool's i-th word: letters and digits only, so that the port's
    tokenizer keeps it whole."""
    return f"w{i}"


def captions(params: Dict, seed: int) -> Dict[str, List[str]]:
    """{video id: its captions} from the corpus parameters of a cell:
    ``videos``, ``captions_per_video``, ``pool_words``, ``zipf_s``,
    ``length_min``, ``length_nb_r``, ``length_nb_mean``, ``length_max``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x434F5250]))
    V, C = params["videos"], params["captions_per_video"]
    n = V * C
    r, mean = params["length_nb_r"], params["length_nb_mean"]
    lengths = np.minimum(
        params["length_min"] + rng.negative_binomial(r, r / (r + mean), n),
        params["length_max"])
    pool = params["pool_words"]
    p = 1.0 / np.arange(1, pool + 1) ** params["zipf_s"]
    cdf = np.cumsum(p / p.sum())
    ids = np.minimum(np.searchsorted(cdf, rng.random(int(lengths.sum()))),
                     pool - 1)
    # a word's pool rank is not its id: shuffle the names over the ranks
    names = np.array([word(i) for i in rng.permutation(pool)], dtype=object)
    words = names[ids]
    out: Dict[str, List[str]] = {}
    pos = 0
    for v in range(V):
        caps = []
        for _ in range(C):
            k = int(lengths[len(out) * C + len(caps)])
            caps.append(" ".join(words[pos:pos + k]))
            pos += k
        out[f"video{v}"] = caps
    return out
