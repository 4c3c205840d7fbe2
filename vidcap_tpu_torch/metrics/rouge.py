"""ROUGE-L with the coco-caption toolkit's conventions (beta=1.2, max precision /
recall over references; SURVEY.md C16)."""
from __future__ import annotations

from typing import Dict, Hashable, List, Sequence, Tuple

Tokens = Sequence[Hashable]
BETA = 1.2


def _lcs_len(a: Tokens, b: Tokens) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l_sentence(refs: List[Tokens], cand: Tokens) -> float:
    if not cand:
        return 0.0
    precs, recs = [], []
    for r in refs:
        lcs = _lcs_len(r, cand)
        precs.append(lcs / len(cand))
        recs.append(lcs / max(len(r), 1))
    p, r = max(precs), max(recs)
    if p == 0 or r == 0:
        return 0.0
    return ((1 + BETA ** 2) * p * r) / (r + BETA ** 2 * p)


def rouge_l(gts: Dict[str, List[Tokens]], res: Dict[str, Tokens]
            ) -> Tuple[float, Dict[str, float]]:
    per = {vid: rouge_l_sentence(gts[vid], cand) for vid, cand in res.items()}
    return sum(per.values()) / max(len(per), 1), per
