"""K3's split-vocab pick on the CPU, and the choice of its W_out mode.

The Hopper kernel (``vidcap_tpu_torch/csrc/rollout.cu``) gives each block a
contiguous slice of the vocab columns; per row and slice it keeps the max
and exp-sum of the clean logits and the best (noisy, clean, column), and the
next step merges the slices in block order. ``select_sliced_plain`` is that
decomposition in PyTorch; here it is held to ``select_plain`` (one pass over
the row) on numpy-seeded logits: the same picks, log-probs within 1e-6.
``rollout_fits_resident`` decides whether W_out stays in shared memory.
"""
import math

import numpy as np
import pytest
import torch

from vidcap_tpu_torch.models.decoder import NEG
from vidcap_tpu_torch.models.decoding import KernelWeights
from vidcap_tpu_torch.models.model import create_model, init_params
from vidcap_tpu_torch.config import get_preset
from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.ops.rollout import (H100_SMEM, H100_SMS,
                                          rollout,
                                          rollout_fits_resident, rollout_plain,
                                          rollout_smem_bytes, select_plain,
                                          select_sliced_plain,
                                          vocab_slice_cols)

MODES = [(False, 1.0), (True, 1.0), (True, 0.7)]   # (sample, temperature)


def _clean(logits: np.ndarray, vocab: int, temperature: float):
    """K3's clean logits: logits / temperature, columns ≥ vocab at −1e30."""
    x = torch.tensor(logits, dtype=torch.float32) * (1.0 / temperature)
    col = torch.arange(x.shape[1])
    return torch.where(col < vocab, x, torch.full_like(x, NEG))


def _check(clean, sample, seed, step, slice_cols):
    pick, logp, _ = select_plain(clean, sample, seed, step)
    pick_s, logp_s = select_sliced_plain(clean, sample, seed, step,
                                         slice_cols)
    assert torch.equal(pick_s, pick)
    assert (logp_s - logp).abs().max().item() <= 1e-6
    return pick_s, logp_s


@pytest.mark.parametrize("sample,temperature", MODES)
@pytest.mark.parametrize("vp,vocab,slice_cols", [
    (1000, 1000, 96),     # slices that do not divide the row (a last of 40)
    (1000, 930, 136),     # and padding columns inside the last slices
    (384, 300, 40),
    (12_032, 12_000, 96),   # msvd_greedy: the H100's slices
])
def test_sliced_pick_matches_one_pass(sample, temperature, vp, vocab,
                                      slice_cols):
    g = np.random.default_rng(vp + slice_cols)
    clean = _clean(g.normal(size=(12, vp)) * 2, vocab, temperature)
    for step in (0, 7):
        pick, _ = _check(clean, sample, 5, step, slice_cols)
        assert (pick < vocab).all()


@pytest.mark.parametrize("sample,temperature", MODES)
def test_132_slices_over_a_small_vocab(sample, temperature):
    """The H100's 132 blocks over Vp = 264: slices of 8 columns, 33 of them
    hold columns, the other 99 are empty; with vocab_size 100 most of the
    non-empty ones lie wholly past it and hold only −1e30."""
    vp, vocab = 264, 100
    cols = vocab_slice_cols(vp, H100_SMS)
    assert cols == 8 and -(-vp // cols) == 33 < H100_SMS
    g = np.random.default_rng(1)
    clean = _clean(g.normal(size=(9, vp)), vocab, temperature)
    pick, _ = _check(clean, sample, 3, 2, cols)
    assert (pick < vocab).all()


@pytest.mark.parametrize("sample,temperature", MODES)
@pytest.mark.parametrize("start", [92, 188, 283])
def test_ties_across_a_slice_boundary(sample, temperature, start):
    """Columns start..start+7 share one logit, the rows' largest; the run
    straddles a boundary of 96-column slices. Greedy takes its first
    column; both versions agree when sampling (the noise breaks the tie)."""
    g = np.random.default_rng(start)
    logits = g.normal(size=(6, 384))
    logits[:, start:start + 8] = logits.max(1, keepdims=True) + 1.0
    clean = _clean(logits, 384, temperature)
    pick, _ = _check(clean, sample, 9, 4, 96)
    if not sample:
        assert (pick == start).all()


@pytest.mark.parametrize("sample", [False, True])
def test_all_equal_logits(sample):
    """W_out = 0 and b_out constant: every clean logit of the vocab equal.
    Greedy takes column 0; both take the plain version's pick; the log-prob
    is −log(vocab) at every row, across any slicing."""
    vp, vocab = 12_032, 12_000
    clean = _clean(np.full((4, vp), 0.25), vocab, 1.0)
    for cols in (96, vocab_slice_cols(vp, H100_SMS), 1000):
        pick, logp = _check(clean, sample, 1, 3, cols)
        if not sample:
            assert (pick == 0).all()
        torch.testing.assert_close(logp, torch.full((4,), -math.log(vocab)),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("vp,fits", [(12_032, True), (16_000, True),
                                     (65_536, False)])
def test_rollout_fits_resident(vp, fits):
    """msvd_greedy / scst_cider (12,032) and msrvtt (16,000) widths keep
    W_out resident on a 132-SM card with 232,448 bytes a block; 65,536
    columns do not, and stream."""
    e = h = a = 512
    assert rollout_fits_resident(vp, e, h, a, 26) is fits
    assert rollout_fits_resident(vp, e, h, a, 26, H100_SMS, H100_SMEM) is fits
    assert rollout_smem_bytes(False, vp, e, h, a, 26, H100_SMS) <= H100_SMEM
    assert (rollout_smem_bytes(True, vp, e, h, a, 26, H100_SMS)
            > rollout_smem_bytes(False, vp, e, h, a, 26, H100_SMS))


@pytest.mark.parametrize("vp,blocks", [(12_032, 132), (16_000, 132),
                                       (264, 132), (1000, 7), (512, 64)])
def test_vocab_slices_cover_the_row(vp, blocks):
    cols = vocab_slice_cols(vp, blocks)
    assert cols % 8 == 0 and cols * blocks >= vp
    assert cols - 8 < -(-vp // blocks)   # the least multiple of 8


@pytest.mark.parametrize("resident", [True, False])
def test_rollout_on_cpu_runs_plain_in_either_mode(resident):
    """A CPU tensor takes the plain version whatever the mode, and no
    kernel launch is counted."""
    cfg = get_preset("synthetic_tiny")
    model = init_params(create_model(cfg, 43), seed=0).eval()
    feats = torch.tensor(np.random.default_rng(0).normal(size=(8, 8, 64)),
                         dtype=torch.float32)
    with torch.no_grad():
        st = model.init_state(feats)
    w = KernelWeights(model.decoder).rollout()
    args = (w, st.keys, st.values, st.frame_mask, st.h[0], st.c[0], 6)
    before = dict(_build.launch_counts)
    got = rollout(*args, sample=True, seed=4, temperature=0.7,
                  resident_wout=resident)
    want = rollout_plain(*args, sample=True, seed=4, temperature=0.7)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _build.launch_counts == before
