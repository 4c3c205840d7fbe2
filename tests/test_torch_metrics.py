"""The port's copy of the metrics (``vidcap_tpu_torch/metrics``) against the
JAX package's on the same corpora: the corpora of tests/test_metrics.py and
seeded random corpora (numpy) with mixed case, punctuation, stems, repeated
words, empty candidates and videos without references. Pure Python on both
sides, the same arithmetic in the same order: the scores agree within 1e-9
(they are equal as measured)."""
import numpy as np
import pytest

from vidcap_tpu.metrics import cider as jax_cider
from vidcap_tpu.metrics import meteor as jax_meteor
from vidcap_tpu.metrics import rouge as jax_rouge
from vidcap_tpu.metrics.evaluate import evaluate_captions as jax_evaluate
from vidcap_tpu_torch.data.vocab import ptb_tokenize
from vidcap_tpu_torch.metrics import cider, meteor, rouge
from vidcap_tpu_torch.metrics.evaluate import evaluate_captions

TOL = 1e-9
KEYS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr", "METEOR")

# the corpora of tests/test_metrics.py, as caption strings
FIXED = {
    "two_videos": ({"v1": ["a b"], "v2": ["c d"]},
                   {"v1": ["a x"], "v2": ["c d"]}),
    "length_penalty": ({"v": ["a b c d"], "w": ["x y"]},
                       {"v": ["a b"], "w": ["x y"]}),
    "repeated_refs": ({"v": ["a b", "a b"], "w": ["c d"]},
                      {"v": ["a b"], "w": ["d c"]}),
    "end_to_end": ({"v1": ["a man is playing guitar",
                           "a person plays a guitar"],
                    "v2": ["a dog runs in the park"]},
                   {"v1": ["a man is playing guitar"], "v2": ["a dog runs"]}),
    "meteor_chunks": ({"v1": ["a man is running"], "v2": ["cat cat dog"]},
                      {"v1": ["a man is running"], "v2": ["cat dog"]}),
    "stems_and_function_words": ({"v": ["runs"], "w": ["a cat"]},
                                 {"v": ["running"], "w": ["the cat"]}),
    "empty_refs_skipped": ({"v": ["a cat plays"], "w": []},
                           {"v": ["a cat"], "w": ["a dog"]}),
}

POOL = ("a man woman is are playing plays played guitar piano dog dogs run "
        "runs running the in on park street cat sits sitting mat car cars "
        "driving drives fast slowly people dancing dance stage").split()


def random_corpus(seed: int):
    """30 videos: 0-5 references of 1-14 words (Title case, commas, full
    stops, repeats), candidates of 0-12 words, some videos without a
    reference list and some candidates for unknown videos."""
    g = np.random.default_rng(seed)

    def sentence(lo, hi):
        words = [str(w) for w in g.choice(POOL, int(g.integers(lo, hi)))]
        if words and g.random() < 0.3:
            words[0] = words[0].title()
        if len(words) > 2 and g.random() < 0.3:
            words[int(g.integers(1, len(words)))] += ","
        return " ".join(words) + ("." if g.random() < 0.3 else "")

    gts, res = {}, {}
    for i in range(30):
        gts[f"v{i}"] = [sentence(1, 15) for _ in range(int(g.integers(0, 6)))]
        res[f"v{i}"] = [sentence(0, 13)]
    for i in range(3):
        res[f"unknown{i}"] = [sentence(1, 8)]
    return gts, res


CASES = {**FIXED, **{f"random_seed{s}": random_corpus(s) for s in range(6)}}


@pytest.mark.parametrize("name", sorted(CASES))
def test_evaluate_captions_equals_jax(name):
    gts, res = CASES[name]
    port, ref = evaluate_captions(gts, res), jax_evaluate(gts, res)
    assert set(port) == set(ref) == set(KEYS)
    for k in KEYS:
        assert abs(port[k] - ref[k]) <= TOL, (k, port[k], ref[k])


@pytest.mark.parametrize("name", sorted(CASES))
def test_per_video_scores_equal_jax(name):
    """CIDEr-D, ROUGE-L and METEOR per video, on the tokenized corpus."""
    gts, res = CASES[name]
    g = {v: [ptb_tokenize(c) for c in caps] for v, caps in gts.items()
         if caps}
    r = {v: ptb_tokenize(caps[0]) for v, caps in res.items() if v in g}
    for port, ref in ((cider.cider_d, jax_cider.cider_d),
                      (rouge.rouge_l, jax_rouge.rouge_l),
                      (meteor.meteor, jax_meteor.meteor)):
        (pm, pv), (rm, rv) = port(g, r), ref(g, r)
        assert abs(pm - rm) <= TOL and pv.keys() == rv.keys()
        assert all(abs(pv[v] - rv[v]) <= TOL for v in rv), port.__name__


def test_no_scorable_pair_raises_like_jax():
    gts, res = {"v": []}, {"v": ["a cat"]}
    for fn in (evaluate_captions, jax_evaluate):
        with pytest.raises(ValueError, match="no scorable"):
            fn(gts, res)
