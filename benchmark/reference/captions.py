"""The reference's reading of the training corpus, worked out from the
caption strings alone: the tokenizer, the vocabulary, the encoded
captions, the attribute targets, and CIDEr-D (Vedantam et al., CVPR 2015,
the coco-caption toolkit's CIDEr-D, with lengths counted in words).

* tokens: lowercase, punctuation to spaces, split on whitespace;
* the vocabulary: <pad> <bos> <eos> <unk>, then the words seen at least
  ``min_count`` times, most frequent first (ties in order of first
  appearance), up to ``size`` entries;
* a caption: its word ids (unknown words <unk>), cut to ``max_len`` - 1,
  then <eos>, padded with <pad> to ``max_len``;
* attributes: the ``k`` most frequent words of the corpus that are not
  stop words and longer than one letter; a video's target marks each that
  appears in any of its captions;
* CIDEr-D: n-grams of orders 1-4; document frequency over each video's
  set of reference n-grams; weight tf * (log N - log max(1, df)), N the
  videos with references; per order the clipped dot
  sum min(w_c, w_r) * w_r over the norms' product; times
  exp(-(len_c - len_r)^2 / 72); the mean over orders, over references,
  times 10. References are the encoded captions without specials (<unk>
  kept); a candidate is its tokens before its first <eos>.
"""
from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List, Sequence

import numpy as np

PAD, BOS, EOS, UNK = 0, 1, 2, 3
_PUNCT = re.compile(
    r"[\"'`!?,;:.\-_()\[\]{}<>@#$%^&*+=~/\\|]|\.\.\.|&amp;|&lt;|&gt;")
_WS = re.compile(r"\s+")
STOPWORDS = frozenset(
    "a an the is are was were be been being am do does did to of in on at by "
    "for with and or but not no so as from this that these those it its he "
    "she they his her their there then than who whom which what when where "
    "how why i you we me him them us your our my mine yours s t ll re ve d m "
    "don isn aren".split())
SIGMA = 6.0
BITS = 15   # bits a token id takes in a packed n-gram key


def tokenize(text: str) -> List[str]:
    text = _WS.sub(" ", _PUNCT.sub(" ", text.lower())).strip()
    return text.split(" ") if text else []


class Corpus:
    """The corpus {video id: captions} in video order, as the reference
    reads it."""

    def __init__(self, captions: Dict[str, List[str]], vocab_size: int,
                 min_count: int, max_len: int, attributes: int):
        self.video_ids = list(captions)
        words = {v: [tokenize(c) for c in caps]
                 for v, caps in captions.items()}
        count: Counter = Counter()
        for caps in words.values():
            for w in caps:
                count.update(w)
        kept = [w for w, c in count.most_common() if c >= min_count]
        self.id_to_word = ["<pad>", "<bos>", "<eos>", "<unk>"] + \
            kept[:vocab_size - 4]
        w2i = {w: i for i, w in enumerate(self.id_to_word)}
        self.encoded = {
            v: [self._encode(w, w2i, max_len) for w in caps]
            for v, caps in words.items()}
        content: Counter = Counter()
        for caps in words.values():
            for w in caps:
                content.update(x for x in w if x not in STOPWORDS
                               and len(x) > 1)
        attr = {w: i for i, (w, _) in
                enumerate(content.most_common(attributes))}
        self.attributes = np.zeros((len(self.video_ids), attributes),
                                   np.float32)
        for vi, v in enumerate(self.video_ids):
            for w in words[v]:
                for x in w:
                    if x in attr:
                        self.attributes[vi, attr[x]] = 1.0
        self._df = None

    @staticmethod
    def _encode(words: Sequence[str], w2i: Dict[str, int], max_len: int
                ) -> List[int]:
        ids = [w2i.get(w, UNK) for w in words][:max_len - 1] + [EOS]
        return ids + [PAD] * (max_len - len(ids))

    def references(self, v: int) -> List[List[int]]:
        """Video ``v``'s references: ids without specials, <unk> kept."""
        return [[t for t in r if t >= UNK]
                for r in self.encoded[self.video_ids[v]]]

    # ------------------------------------------------------------- CIDEr-D

    @staticmethod
    def _keys(ids: Sequence[int], n: int) -> List[int]:
        """Packed keys of the order-n grams of ``ids``."""
        out = []
        for i in range(len(ids) - n + 1):
            k = n
            for t in ids[i:i + n]:
                k = (k << BITS) | int(t)
            out.append(k)
        return out

    def _document_frequency(self) -> Dict[int, int]:
        """Per n-gram key, the number of videos whose references hold it
        (numpy: sort the (key, video) pairs, count the distinct ones)."""
        refs, vid = [], []
        for v in range(len(self.video_ids)):
            for r in self.references(v):
                refs.append(r)
                vid.append(v)
        L = max((len(r) for r in refs), default=1)
        ids = np.zeros((len(refs), L), np.int64)
        lens = np.array([len(r) for r in refs], np.int64)
        for i, r in enumerate(refs):
            ids[i, :len(r)] = r
        vid = np.asarray(vid, np.int64)
        keys, vids = [], []
        for n in range(1, 5):
            if L < n:
                break
            k = np.full((len(refs), L - n + 1), n, np.int64)
            for j in range(n):
                k = (k << BITS) | ids[:, j:L - n + 1 + j]
            ok = np.arange(L - n + 1)[None, :] + n <= lens[:, None]
            keys.append(k[ok])
            vids.append(np.broadcast_to(vid[:, None], k.shape)[ok])
        k, v = np.concatenate(keys), np.concatenate(vids)
        order = np.lexsort((v, k))
        k, v = k[order], v[order]
        new = np.ones(len(k), bool)
        new[1:] = (k[1:] != k[:-1]) | (v[1:] != v[:-1])
        uniq, cnt = np.unique(k[new], return_counts=True)
        self.n_docs = sum(1 for v in range(len(self.video_ids))
                          if self.encoded[self.video_ids[v]])
        return dict(zip(uniq.tolist(), cnt.tolist()))

    def _vec(self, ids: Sequence[int]):
        log_n = math.log(max(self.n_docs, 1))
        vecs, norms = [], []
        for n in range(1, 5):
            tf = Counter(self._keys(ids, n))
            vec = {g: c * (log_n - math.log(max(1.0, self._df.get(g, 0))))
                   for g, c in tf.items()}
            vecs.append(vec)
            norms.append(math.sqrt(sum(x * x for x in vec.values())))
        return vecs, norms, len(ids)

    def cider(self, v: int, tokens: Sequence[int]) -> float:
        """CIDEr-D of the candidate ``tokens`` (stopping at its first
        <eos>) against video ``v``'s references."""
        if self._df is None:
            self._df = self._document_frequency()
        cand = []
        for t in tokens:
            if int(t) == EOS:
                break
            cand.append(int(t))
        vh, nh, lh = self._vec(cand)
        refs = self.references(v)
        total = 0.0
        for r in refs:
            vr, nr, lr = self._vec(r)
            pen = math.exp(-((lh - lr) ** 2) / (2 * SIGMA ** 2))
            for n in range(4):
                val = sum(min(w, vr[n][g]) * vr[n][g]
                          for g, w in vh[n].items() if g in vr[n])
                if nh[n] != 0 and nr[n] != 0:
                    val /= nh[n] * nr[n]
                total += val * pen
        return total / 4 / max(len(refs), 1) * 10.0
