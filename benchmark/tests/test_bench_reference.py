"""The reference agrees with the port's plain route (the kernels' plain
versions, which CPU tensors take) at the synthetic_tiny widths: the beam
decode and the SCST step, each through a whole run of its
cell with the cell's own limits."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import common, corpus, harness, program, weights
from benchmark.reference import decode_check
from benchmark.reference.captions import Corpus


def _run(cell, seconds=1.5, seed=2**31 + 11, **kw):
    return harness.execute(cell["name"], seed, seconds, False, "cpu",
                           cell=cell, **kw)


def test_reference_beam_is_the_plain_route(tiny):
    cell = tiny(common.cells_of("closed_beam")[0])
    r = harness.Run(cell["name"], 3, 1.0, False, "cpu", cell=cell)
    cap, W = program.captioner(r)
    s = weights.sizes(cell["cfg"])
    feats = corpus.features(6, s["T"], s["D"], 3, "cpu")
    toks = cap.decode_batch(feats, method="beam", beam_width=5)
    mask = np.ones(feats.shape[:2], np.float32)
    mine = decode_check.beam(W, feats, mask, 5, s["L"], s["V"],
                             torch.bfloat16, "cpu")
    assert np.array_equal(mine, toks)
    _, kept = decode_check.beam(W, feats, mask, 5, s["L"], s["V"],
                                torch.bfloat16, "cpu", follow=toks,
                                margin=0.0)
    assert kept.all()
    wrong = toks.copy()
    wrong[:, 0] = (wrong[:, 0] + 7) % s["V"]
    _, kept = decode_check.beam(W, feats, mask, 5, s["L"], s["V"],
                                torch.bfloat16, "cpu", follow=wrong,
                                margin=0.0)
    assert not kept.any()


@pytest.mark.parametrize("name", [w["name"] for w in
                                  common.manifest()["workloads"]])
def test_sound_run_is_correct(tiny, name):
    r = _run(tiny(name))
    assert all(ok for *_, ok in harness.verdict(r)), harness.verdict(r)
    assert r.attempted > 0 and r.setup_s is not None


def test_reference_cider_is_the_port_scorer():
    from vidcap_tpu_torch.metrics.cider import CiderScorer
    caps = corpus.captions(dict(videos=40, captions_per_video=5,
                                pool_words=300, zipf_s=1.0, length_min=3,
                                length_nb_r=3, length_nb_mean=6.0,
                                length_max=40), 9)
    corp = Corpus(caps, 200, 2, 12, 16)
    port = CiderScorer({v: corp.references(i) for i, v in
                        enumerate(corp.video_ids)})
    rng = np.random.default_rng(0)
    for i in range(20):
        cand = rng.integers(3, 200, rng.integers(1, 11)).tolist()
        if i % 4 == 0:
            cand = corp.references(i)[0]
        assert corp.cider(i, cand + [2, 0]) == pytest.approx(
            port.score(corp.video_ids[i], cand), rel=1e-9, abs=1e-12)
