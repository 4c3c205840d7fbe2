"""Host-side construction of the device CIDEr/BLEU reward tables, as
``vidcap_tpu/objectives/reward_tables.py`` builds them.

Built once per dataset at train start, in numpy; everything the per-step
reward needs then lives in fixed-shape tensors on the device:

  * per-video reference n-gram tables: hashed keys (ops/ngram_hash.py), term
    frequencies, corpus IDF weights, per-(reference, order) norms, lengths;
  * a corpus-wide open-addressing IDF hash table for the candidate norms
    (grams absent from the corpus get the df = 0 weight log N, exactly like
    pycocoevalcap's ``ref_len - log(max(1, df))`` with df missing).

The n-gram entries of a reference are counted in Python here; the JAX
package may count them in its native extension, in another order. The
order decides the IDF table's probe lengths: where the JAX package refuses
a table whose longest probe exceeds the cap, the port doubles the table
(a lookup's result does not depend on the table's size).
"""
from __future__ import annotations

import dataclasses
import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

import numpy as np
import torch

from vidcap_tpu_torch.ops.ngram_hash import host_ngram_key

NGRAMS = 4


@dataclasses.dataclass
class RewardTables:
    """V videos, R most references, G most grams a reference, S IDF slots.
    Keys are int64 tensors holding uint32 values."""

    ref_key_lo: torch.Tensor    # i64[V, R, G]
    ref_key_hi: torch.Tensor    # i64[V, R, G]
    ref_tf: torch.Tensor        # f32[V, R, G]
    ref_idf: torch.Tensor       # f32[V, R, G]
    ref_order: torch.Tensor     # i32[V, R, G]  1..4, 0 = pad slot
    ref_norm: torch.Tensor      # f32[V, R, 4]  per-order tf-idf vector norms
    ref_len: torch.Tensor       # f32[V, R]     unigram count
    ref_valid: torch.Tensor     # f32[V, R]     1.0 = real reference
    num_refs: torch.Tensor      # f32[V]
    idf_key_lo: torch.Tensor    # i64[S] open addressing (0 = empty: real
    idf_key_hi: torch.Tensor    # i64[S]  keys are never (0, 0) in practice)
    idf_val: torch.Tensor       # f32[S]
    log_n: float                # log(videos with references): idf on a miss
    num_probes: int             # linear-probe length used at build time

    def to(self, device) -> "RewardTables":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _ref_entries(tokens: Sequence[int]):
    """Unique n-gram entries (lo, hi, tf, order) of one reference."""
    entries = []
    for n in range(1, NGRAMS + 1):
        counter = Counter(tuple(tokens[i: i + n])
                          for i in range(len(tokens) - n + 1))
        for gram, tf in counter.items():
            lo, hi = host_ngram_key(gram, n)
            entries.append((lo, hi, float(tf), n))
    return entries


def _open_addressing(keys, weight, log_n: float, S: int, max_probes: int):
    """Linear-probing table of ``S`` slots: (lo, hi, value, probes the
    longest lookup takes), or None if one would take more than
    ``max_probes``."""
    t_lo = np.zeros((S,), np.int64)
    t_hi = np.zeros((S,), np.int64)
    t_val = np.full((S,), log_n, np.float32)   # a miss gets this weight anyway
    used = np.zeros((S,), bool)
    probes_needed = 1
    for lo, hi in keys:
        slot = lo % S
        p = 0
        while used[slot] and not (t_lo[slot] == lo and t_hi[slot] == hi):
            slot = (slot + 1) % S
            p += 1
            if p >= max_probes:
                return None
        used[slot] = True
        t_lo[slot], t_hi[slot] = lo, hi
        t_val[slot] = weight((lo, hi))
        probes_needed = max(probes_needed, p + 1)
    return t_lo, t_hi, t_val, probes_needed


def build_reward_tables(refs_per_video: List[List[Sequence[int]]],
                        max_probes: int = 16) -> RewardTables:
    """refs_per_video[v]: the tokenized references of video v (id lists
    without <bos>/<eos>/<pad>), in the dataset's video order. Returns CPU
    tensors; move them with :meth:`RewardTables.to`."""
    V = len(refs_per_video)
    # the IDF document count is the videos that carry references: ref-less
    # rows are feature-alignment placeholders, not corpus documents, and the
    # additive log-N term does not cancel in the tf-idf cosine
    n_docs = sum(1 for r in refs_per_video if r)
    log_n = math.log(max(n_docs, 1))

    per_video_entries = [[_ref_entries(r) for r in refs]
                         for refs in refs_per_video]

    # corpus document frequency over each video's reference set of keys
    df: Dict[tuple, int] = defaultdict(int)
    for refs in per_video_entries:
        seen = set()
        for entries in refs:
            seen.update((lo, hi) for lo, hi, _, _ in entries)
        for k in seen:
            df[k] += 1

    def idf_weight(key: tuple) -> float:
        return log_n - math.log(max(1.0, df.get(key, 0)))

    R = max((len(r) for r in refs_per_video), default=1)
    G = 1
    per_video = []
    for refs, refs_entries in zip(refs_per_video, per_video_entries):
        per_ref = []
        for r, raw in zip(refs, refs_entries):
            entries = []   # (lo, hi, tf, idf, order)
            sq = [0.0] * NGRAMS
            for lo, hi, tf, n in raw:
                w = idf_weight((lo, hi))
                entries.append((lo, hi, float(tf), w, int(n)))
                sq[int(n) - 1] += (tf * w) ** 2
            per_ref.append((entries, [math.sqrt(s) for s in sq],
                            float(len(r))))
            G = max(G, len(entries))
        per_video.append(per_ref)

    key_lo = np.zeros((V, R, G), np.int64)
    key_hi = np.zeros((V, R, G), np.int64)
    tf = np.zeros((V, R, G), np.float32)
    idf = np.zeros((V, R, G), np.float32)
    order = np.zeros((V, R, G), np.int32)
    norm = np.zeros((V, R, NGRAMS), np.float32)
    rlen = np.zeros((V, R), np.float32)
    valid = np.zeros((V, R), np.float32)
    nrefs = np.zeros((V,), np.float32)
    for v, per_ref in enumerate(per_video):
        nrefs[v] = max(len(per_ref), 1)
        for r, (entries, norms, length) in enumerate(per_ref):
            for g, (lo, hi, t, w, n) in enumerate(entries):
                key_lo[v, r, g] = lo
                key_hi[v, r, g] = hi
                tf[v, r, g] = t
                idf[v, r, g] = w
                order[v, r, g] = n
            norm[v, r] = norms
            rlen[v, r] = length
            valid[v, r] = 1.0

    # the corpus IDF open-addressing table (for the candidate norms), twice
    # as large until no lookup needs more than max_probes probes
    uniq = list(df.keys())
    S = 1 << max(int(math.ceil(math.log2(max(len(uniq) * 2, 16)))), 4)
    while (idf_table := _open_addressing(uniq, idf_weight, log_n, S,
                                         max_probes)) is None:
        S *= 2
    t_lo, t_hi, t_val, probes_needed = idf_table

    t = torch.from_numpy
    return RewardTables(
        ref_key_lo=t(key_lo), ref_key_hi=t(key_hi), ref_tf=t(tf),
        ref_idf=t(idf), ref_order=t(order), ref_norm=t(norm),
        ref_len=t(rlen), ref_valid=t(valid), num_refs=t(nrefs),
        idf_key_lo=t(t_lo), idf_key_hi=t(t_hi), idf_val=t(t_val),
        log_n=log_n, num_probes=probes_needed)


def tables_from_dataset(dataset) -> RewardTables:
    """Tables of a CaptionDataset: the references are its tokenized
    captions (specials stripped), grouped by video in ``video_ids`` order."""
    refs: List[List[List[int]]] = [[] for _ in dataset.video_ids]
    for row, vidx in zip(dataset.tokens, dataset.caption_video_idx):
        ids = [int(t) for t in row if t >= 3]  # strip PAD/BOS/EOS, keep <unk>
        refs[int(vidx)].append(ids)
    return build_reward_tables(refs)
