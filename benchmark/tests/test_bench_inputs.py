"""Inputs follow the seed: the corpus and the feature pools are the same
for the same seed, and differ between seeds."""
from __future__ import annotations

import numpy as np

from benchmark import corpus

PARAMS = dict(videos=50, captions_per_video=4, pool_words=500, zipf_s=1.0,
              length_min=3, length_nb_r=3, length_nb_mean=6.0,
              length_max=40)


def test_corpus_follows_the_seed():
    a = corpus.captions(PARAMS, 2**31 + 5)
    assert a == corpus.captions(PARAMS, 2**31 + 5)
    assert a != corpus.captions(PARAMS, 6)
    lengths = [len(c.split()) for caps in a.values() for c in caps]
    assert len(a) == 50 and all(len(c) == 4 for c in a.values())
    assert 3 <= min(lengths) and max(lengths) <= 40


def test_features_follow_the_seed():
    x = corpus.features(3, 4, 8, 2**31 + 3, "cpu", salt=1)
    assert np.array_equal(x, corpus.features(3, 4, 8, 2**31 + 3, "cpu",
                                              salt=1))
    assert not np.array_equal(x, corpus.features(3, 4, 8, 2**31 + 3, "cpu",
                                                 salt=2))
