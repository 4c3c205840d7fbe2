"""BLEU — corpus-level BLEU-1..4 with the coco-caption toolkit's conventions
(closest-reference brevity penalty, clipped counts against the max over refs;
SURVEY.md C16), plus a smoothed sentence-level BLEU-4 for the mixed SCST reward
(SURVEY.md C14, BASELINE.json configs[4] "CIDEr/BLEU reward").
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Hashable, List, Sequence

Tokens = Sequence[Hashable]
NGRAMS = 4


def _ngrams(tokens: Tokens, n: int) -> Counter:
    return Counter(tuple(tokens[i: i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(gts: Dict[str, List[Tokens]], res: Dict[str, Tokens],
                n_max: int = NGRAMS) -> List[float]:
    """Corpus BLEU-1..n_max. gts: {vid: [ref tokens]}, res: {vid: cand tokens}."""
    clipped = [0] * n_max
    total = [0] * n_max
    cand_len = 0
    ref_len = 0
    for vid, cand in res.items():
        refs = gts[vid]
        cand_len += len(cand)
        # closest reference length (ties → shorter), coco-caption convention
        ref_len += min((abs(len(r) - len(cand)), len(r)) for r in refs)[1]
        for n in range(1, n_max + 1):
            cn = _ngrams(cand, n)
            if not cn:
                continue
            max_ref: Counter = Counter()
            for r in refs:
                rn = _ngrams(r, n)
                for g, c in rn.items():
                    if c > max_ref[g]:
                        max_ref[g] = c
            total[n - 1] += sum(cn.values())
            clipped[n - 1] += sum(min(c, max_ref.get(g, 0))
                                  for g, c in cn.items())
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1))
    out = []
    logsum = 0.0
    for n in range(n_max):
        # coco-caption's "tiny smoothing": avoids zeros in higher orders
        p = (clipped[n] + 1e-9) / max(total[n], 1) if total[n] else 0.0
        p = max(p, 1e-12)
        logsum += math.log(p)
        out.append(bp * math.exp(logsum / (n + 1)))
    return out


def sentence_bleu4(refs: List[Tokens], cand: Tokens) -> float:
    """Smoothed (+1) sentence-level BLEU-4 — the reward-path variant."""
    if not cand:
        return 0.0
    logsum = 0.0
    for n in range(1, NGRAMS + 1):
        cn = _ngrams(cand, n)
        max_ref: Counter = Counter()
        for r in refs:
            for g, c in _ngrams(r, n).items():
                if c > max_ref[g]:
                    max_ref[g] = c
        tot = sum(cn.values())
        clip = sum(min(c, max_ref.get(g, 0)) for g, c in cn.items())
        p = (clip + 1.0) / (tot + 1.0)  # +1 smoothing
        logsum += math.log(p)
    closest = min((abs(len(r) - len(cand)), len(r)) for r in refs)[1]
    bp = 1.0 if len(cand) > closest else math.exp(1 - closest / max(len(cand), 1))
    return bp * math.exp(logsum / NGRAMS)
