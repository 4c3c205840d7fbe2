"""METEOR (SURVEY.md C16, §2.2: the reference vendors Java ``meteor-1.5.jar``).

Offline-eval-only metric; never on the device reward path (SURVEY.md §2.2 marks
it a deliberate device non-goal). Two backends:

  1. If a METEOR jar + JVM are available (``VIDCAP_METEOR_JAR`` env var), shell
     out — exact parity with the reference toolkit.
  2. A pure-Python port of the Meteor 1.5 algorithm (Denkowski & Lavie 2014,
     "Meteor Universal"):

     - **Aligner**: beam search over one-to-one word alignments resolving ties
       exactly like Meteor's PartialAlignment comparator — most matches first,
       then FEWEST CHUNKS, then smallest total |i-j| distance (a greedy
       first-match aligner does not minimize chunks; see
       tests/test_metrics.py::test_meteor_chunk_minimization).
     - **Matchers**: exact (weight 1.0) and Porter-stem (weight 0.6). The
       synonym (WordNet) and paraphrase-table modules need external resources
       this image doesn't ship; their absence makes scores a LOWER bound on the
       jar's (fewer matches found), never higher.
     - **Scoring**: Meteor 1.5 English defaults α=0.85 β=0.2 γ=0.6 δ=0.75 with
       content/function word weighting, Pen = γ·(ch/m)^β, and the jar's
       system-level behavior: per-segment best reference by segment score, then
       ONE final score from the summed statistics (not a mean of segment
       scores).
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, List, Sequence, Tuple

Tokens = Sequence[str]

# Meteor 1.5 English defaults (Denkowski & Lavie 2014, table 1)
ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
W_EXACT, W_STEM = 1.0, 0.6
BEAM_SIZE = 40   # Meteor's aligner beam


# --------------------------------------------------------------- porter stemmer

_VOWELS = set("aeiou")


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Porter's m: number of VC sequences in the [C](VC)^m[V] form."""
    m, prev_v = 0, False
    for i in range(len(stem)):
        v = not _is_cons(stem, i)
        if prev_v and not v:
            m += 1
        prev_v = v
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(w: str) -> bool:
    return (len(w) >= 2 and w[-1] == w[-2] and _is_cons(w, len(w) - 1))


def _cvc(w: str) -> bool:
    """*o condition: ends cvc where the final c is not w, x or y."""
    if len(w) < 3:
        return False
    return (_is_cons(w, len(w) - 3) and not _is_cons(w, len(w) - 2)
            and _is_cons(w, len(w) - 1) and w[-1] not in "wxy")


def porter_stem(word: str) -> str:
    """The classic Porter (1980) stemmer — Meteor's stem module for English
    uses the Snowball English stemmer, which differs from Porter only on a
    small tail of words; documented approximation."""
    w = word.lower()
    if len(w) <= 2:
        return w

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w, flag = w[:-2], True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w, flag = w[:-3], True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _ends_double_cons(w) and w[-1] not in "lsz":
                w = w[:-1]
            elif _measure(w) == 1 and _cvc(w):
                w += "e"

    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # step 2
    for suf, rep in (("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
                     ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
                     ("alli", "al"), ("entli", "ent"), ("eli", "e"),
                     ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
                     ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
                     ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
                     ("iviti", "ive"), ("biliti", "ble")):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 3
    for suf, rep in (("icate", "ic"), ("ative", ""), ("alize", "al"),
                     ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
                     ("ness", "")):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 4
    for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                "ement", "ment", "ent", "ou", "ism", "ate", "iti", "ous",
                "ive", "ize"):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and _measure(w[:-3]) > 1 and w[-4] in "st":
            w = w[:-3]

    # step 5a
    if w.endswith("e"):
        m = _measure(w[:-1])
        if m > 1 or (m == 1 and not _cvc(w[:-1])):
            w = w[:-1]
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# Meteor ships a frequency-derived function-word list for English; this covers
# its high-frequency core (articles, pronouns, prepositions, conjunctions,
# auxiliaries, punctuation). Approximate — only affects the δ word weighting.
FUNCTION_WORDS = frozenset(
    "a an the this that these those some any each every no "
    "i you he she it we they me him her us them my your his its our their "
    "mine yours hers ours theirs myself yourself himself herself itself "
    "ourselves themselves who whom whose which what "
    "in on at by for with about against between into through during before "
    "after above below to from up down out off over under again of as "
    "and or but nor so yet if because while although though since until "
    "unless than whether "
    "is are was were be been being am do does did doing have has had having "
    "will would shall should may might must can could "
    "not n't no nor never "
    "there here when where why how all both few more most other such only "
    "own same too very just also then once "
    ". , ! ? ; : ' \" ` ( ) -".split()
)


def _word_weight(w: str) -> float:
    return (1.0 - DELTA) if w in FUNCTION_WORDS else DELTA


# -------------------------------------------------------------------- aligner

def _chunk_count(matches: Tuple[Tuple[int, int, float], ...]) -> int:
    """Number of chunks: maximal runs of matches adjacent in BOTH strings.
    ``matches`` is ordered by candidate position i."""
    chunks, prev = 0, None
    for i, j, _ in matches:
        if prev is None or i != prev[0] + 1 or j != prev[1] + 1:
            chunks += 1
        prev = (i, j)
    return chunks


def _align(ref: Tokens, cand: Tokens,
           beam_size: int = BEAM_SIZE) -> Tuple[Tuple[Tuple[int, int, float],
                                                      ...], int]:
    """Meteor-style beam-search alignment.

    Returns (matches, chunks) where matches is a tuple of (cand_idx, ref_idx,
    module_weight), resolved to maximize matches, then MINIMIZE chunks, then
    minimize total match distance — the Meteor 1.5 comparator order."""
    ref_stems = [porter_stem(r) for r in ref]
    cand_opts: List[List[Tuple[int, float]]] = []
    for w in cand:
        ws = None
        opts = []
        for j, r in enumerate(ref):
            if w == r:
                opts.append((j, W_EXACT))
            else:
                if ws is None:
                    ws = porter_stem(w)
                if ws == ref_stems[j]:
                    opts.append((j, W_STEM))
        cand_opts.append(opts)

    def key(state):
        used, matches = state
        return (-len(matches), _chunk_count(matches),
                sum(abs(i - j) for i, j, _ in matches))

    beams: List[Tuple[int, Tuple]] = [(0, ())]
    for i, opts in enumerate(cand_opts):
        if not opts:
            continue
        new = []
        for used, matches in beams:
            new.append((used, matches))            # leave cand[i] unmatched
            for j, wt in opts:
                if used >> j & 1:
                    continue
                new.append((used | (1 << j), matches + ((i, j, wt),)))
        new.sort(key=key)
        beams = new[:beam_size]
    used, matches = min(beams, key=key)
    return matches, _chunk_count(matches)


# -------------------------------------------------------------------- scoring

class _Stats:
    """Sufficient statistics of one segment (or a running system total)."""

    __slots__ = ("p_num", "p_den", "r_num", "r_den", "chunks", "m")

    def __init__(self, p_num=0.0, p_den=0.0, r_num=0.0, r_den=0.0,
                 chunks=0, m=0):
        self.p_num, self.p_den = p_num, p_den
        self.r_num, self.r_den = r_num, r_den
        self.chunks, self.m = chunks, m

    def add(self, o: "_Stats") -> None:
        self.p_num += o.p_num
        self.p_den += o.p_den
        self.r_num += o.r_num
        self.r_den += o.r_den
        self.chunks += o.chunks
        self.m += o.m

    def score(self) -> float:
        if self.p_den == 0 or self.r_den == 0:
            return 0.0
        p = self.p_num / self.p_den
        r = self.r_num / self.r_den
        if p == 0 or r == 0:
            return 0.0
        fmean = p * r / (ALPHA * p + (1 - ALPHA) * r)
        pen = 0.0
        if self.chunks > 0 and self.m > 0:
            pen = GAMMA * (self.chunks / self.m) ** BETA
        return (1.0 - pen) * fmean


def _segment_stats(ref: Tokens, cand: Tokens) -> _Stats:
    matches, chunks = _align(ref, cand)
    p_num = sum(wt * _word_weight(cand[i]) for i, _, wt in matches)
    r_num = sum(wt * _word_weight(ref[j]) for _, j, wt in matches)
    return _Stats(
        p_num=p_num, p_den=sum(_word_weight(w) for w in cand),
        r_num=r_num, r_den=sum(_word_weight(w) for w in ref),
        chunks=chunks, m=len(matches))


def meteor_sentence(refs: List[Tokens], cand: Tokens) -> float:
    """Segment score: best reference by segment-level Meteor score."""
    if not cand:
        return 0.0
    best = 0.0
    for ref in refs:
        if not ref:
            continue
        best = max(best, _segment_stats(ref, cand).score())
    return best


def meteor(gts: Dict[str, List[Tokens]], res: Dict[str, Tokens]
           ) -> Tuple[float, Dict[str, float]]:
    """Corpus METEOR. Returns (system score, {segment: score}).

    System score follows the jar: pick each segment's best reference by
    SEGMENT score, sum those segments' sufficient statistics, apply the
    formula once to the totals (micro-average, not a mean of segment scores).
    """
    jar = os.environ.get("VIDCAP_METEOR_JAR")
    if jar and os.path.exists(jar) and shutil.which("java"):
        return _meteor_jar(jar, gts, res)

    total = _Stats()
    per: Dict[str, float] = {}
    for vid, cand in res.items():
        best_stats, best_score = None, 0.0
        if cand:
            for ref in gts.get(vid, []):
                if not ref:
                    continue
                st = _segment_stats(ref, cand)
                sc = st.score()
                if best_stats is None or sc > best_score:
                    best_stats, best_score = st, sc
        if best_stats is None:
            # zero-match degenerate segment (empty candidate and/or no usable
            # reference): the jar still counts its denominators toward the
            # system totals, so dropping it would let the python score exceed
            # the jar's and break the documented strict-lower-bound claim.
            refs = [r for r in gts.get(vid, []) if r]
            r_den = (sum(_word_weight(w) for w in refs[0]) if refs else 0.0)
            best_stats = _Stats(
                p_den=sum(_word_weight(w) for w in cand), r_den=r_den)
        per[vid] = best_score
        total.add(best_stats)
    return total.score(), per


def _meteor_jar(jar: str, gts, res):  # pragma: no cover - needs JVM asset
    """Exact METEOR via the reference toolkit's jar protocol."""
    vids = list(res.keys())
    proc = subprocess.Popen(
        ["java", "-jar", "-Xmx2G", jar, "-", "-", "-stdio", "-l", "en",
         "-norm"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    scores = {}
    eval_line = "EVAL"
    for vid in vids:
        cand = " ".join(res[vid])
        refs = "|||".join(" ".join(r) for r in gts[vid])
        proc.stdin.write(f"SCORE ||| {refs} ||| {cand}\n")
    proc.stdin.flush()
    stats = [proc.stdout.readline().strip() for _ in vids]
    for s in stats:
        eval_line += f" ||| {s}"
    proc.stdin.write(eval_line + "\n")
    proc.stdin.flush()
    for vid in vids:
        scores[vid] = float(proc.stdout.readline().strip())
    final = float(proc.stdout.readline().strip())
    proc.stdin.close()
    proc.wait()
    return final, scores
