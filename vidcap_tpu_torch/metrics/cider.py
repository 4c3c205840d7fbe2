"""CIDEr-D scorer — pure-Python reimplementation of the coco-caption toolkit's
semantics (SURVEY.md C14/C16), operating on arbitrary hashable token sequences so the
same oracle scores both word strings (offline eval) and integer token ids (parity
tests for the on-device reward in objectives/reward.py).

Semantics follow pycocoevalcap's cider_scorer exactly:
  * df computed over each video's reference SET (an n-gram counts once per video)
  * weight(g) = tf(g) * (log N - log max(1, df(g)))
  * CIDEr-D: clipped dot  sum_g min(v_hyp, v_ref) * v_ref / (|v_hyp||v_ref|),
    times the length gaussian  exp(-(l_h - l_r)^2 / (2 * 6^2)),
    averaged over refs and over n = 1..4, times 10.
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, Hashable, List, Sequence, Tuple

SIGMA = 6.0
NGRAMS = 4

Tokens = Sequence[Hashable]


def ngram_counts(tokens: Tokens, n_max: int = NGRAMS) -> List[Counter]:
    """Per-order n-gram Counters, orders 1..n_max (index 0 = unigrams)."""
    out = []
    for n in range(1, n_max + 1):
        out.append(Counter(
            tuple(tokens[i: i + n]) for i in range(len(tokens) - n + 1)))
    return out


class CiderScorer:
    """Corpus-level CIDEr-D. Build once from the reference corpus; score many
    candidates (the IDF table is corpus-wide state, mirroring the reference's
    train-time reward setup)."""

    def __init__(self, refs_per_video: Dict[str, List[Tokens]]):
        self.refs = {
            vid: [ngram_counts(r) for r in refs]
            for vid, refs in refs_per_video.items()
        }
        # IDF document count = videos that actually carry references —
        # ref-less rows (MSR-VTT test-server entries, partially-captioned
        # corpora) are alignment placeholders, not corpus documents, and the
        # additive log-N idf term does not cancel in the tf-idf cosine.
        # Must mirror objectives/reward_tables.py exactly or the device
        # reward diverges from this oracle on such corpora
        # (tests/test_reward.py::test_device_cider_matches_host_oracle_refless).
        self.num_docs = sum(1 for refs in refs_per_video.values() if refs)
        self.log_ref_len = math.log(max(self.num_docs, 1))
        # document frequency over per-video reference n-gram sets
        self.df: Dict[tuple, int] = defaultdict(int)
        for counters_per_ref in self.refs.values():
            seen = set()
            for counters in counters_per_ref:
                for c in counters:
                    seen.update(c.keys())
            for g in seen:
                self.df[g] += 1

    # ------------------------------------------------------------------ weights

    def idf(self, gram: tuple) -> float:
        return self.log_ref_len - math.log(max(1.0, self.df.get(gram, 0)))

    def _vec_norm(self, counters: List[Counter]
                  ) -> Tuple[List[Dict[tuple, float]], List[float], int]:
        vecs, norms = [], []
        length = 0
        for n, counter in enumerate(counters):
            vec = {g: tf * self.idf(g) for g, tf in counter.items()}
            vecs.append(vec)
            norms.append(math.sqrt(sum(w * w for w in vec.values())))
            if n == 0:
                length = sum(counter.values())
        return vecs, norms, length

    # ------------------------------------------------------------------ scoring

    def score(self, video_id: str, candidate: Tokens) -> float:
        """CIDEr-D of one candidate against its video's references."""
        refs = self.refs[video_id]
        cand = ngram_counts(candidate)
        vec_h, norm_h, len_h = self._vec_norm(cand)
        total = [0.0] * NGRAMS
        for ref_counters in refs:
            vec_r, norm_r, len_r = self._vec_norm(ref_counters)
            delta = float(len_h - len_r)
            pen = math.exp(-(delta ** 2) / (2 * SIGMA ** 2))
            for n in range(NGRAMS):
                val = 0.0
                for g, wh in vec_h[n].items():
                    wr = vec_r[n].get(g)
                    if wr is not None:
                        val += min(wh, wr) * wr
                if norm_h[n] != 0 and norm_r[n] != 0:
                    val /= norm_h[n] * norm_r[n]
                total[n] += val * pen
        n_refs = len(refs)
        return (sum(total) / NGRAMS) / n_refs * 10.0

    def score_all(self, candidates: Dict[str, Tokens]) -> Tuple[float, Dict[str, float]]:
        per = {vid: self.score(vid, c) for vid, c in candidates.items()}
        mean = sum(per.values()) / max(len(per), 1)
        return mean, per


def cider_d(gts: Dict[str, List[Tokens]], res: Dict[str, Tokens]
            ) -> Tuple[float, Dict[str, float]]:
    """One-shot convenience: corpus CIDEr-D of res against gts."""
    return CiderScorer(gts).score_all(res)
