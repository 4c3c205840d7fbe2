"""Multitask attribute mining (SURVEY.md C5).

The reference's multitask stage predicts the K most frequent caption words (attributes)
per video as a multi-hot auxiliary target sharing the video encoder (SURVEY.md §2.1 C5,
BASELINE.json configs[3]). We mine the same targets: top-K frequent non-stopword tokens
across training captions → per-video multi-hot vector.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

import numpy as np

from vidcap_tpu_torch.data.vocab import ptb_tokenize

# minimal english stopword list — attributes should be content words (nouns/verbs)
_STOPWORDS = frozenset(
    "a an the is are was were be been being am do does did to of in on at by for "
    "with and or but not no so as from this that these those it its he she they "
    "his her their there then than who whom which what when where how why i you "
    "we me him them us your our my mine yours s t ll re ve d m don isn aren".split()
)


def mine_attributes(
    video_captions: Dict[str, List[str]],
    num_attributes: int = 400,
) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """Return (attribute_words, {video_id: multi-hot float32[num_attributes]}).

    attribute_words[k] is the k-th most frequent content word across all training
    captions; a video's target bit k is set iff that word appears in ANY of its
    reference captions.
    """
    counter: Counter = Counter()
    tokenized: Dict[str, List[List[str]]] = {}
    for vid, caps in video_captions.items():
        toks = [ptb_tokenize(c) for c in caps]
        tokenized[vid] = toks
        for t in toks:
            counter.update(w for w in t if w not in _STOPWORDS and len(w) > 1)

    attr_words = [w for w, _ in counter.most_common(num_attributes)]
    attr_index = {w: i for i, w in enumerate(attr_words)}

    targets: Dict[str, np.ndarray] = {}
    for vid, toks in tokenized.items():
        vec = np.zeros((num_attributes,), dtype=np.float32)
        for t in toks:
            for w in t:
                k = attr_index.get(w)
                if k is not None:
                    vec[k] = 1.0
        targets[vid] = vec
    return attr_words, targets
