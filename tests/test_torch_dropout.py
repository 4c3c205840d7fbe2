"""Dropout in the port (``model.dropout_rate``), the reference's semantics
(``vidcap_tpu/models/decoder.py:159,203-212``; ``train/steps.py:36-47``):
[emb; ctx] before the LSTM stack and the top h before out_proj, one mask a
forward reused at every timestep, kept values scaled by 1/(1−p), only in the
XE/e2e training steps. Flax's masks come from threefry and cannot be
matched bit for bit, so these are statistics and invariants:

* the keep share within 4σ of 1−p (σ = sqrt(p(1−p)/n));
* kept values exactly x / (1−p), dropped ones 0;
* one mask across a row's timesteps, new masks at a new seed, and
  microbatches (``train.grad_accum``) draw their own (keyed by the row's
  place in the batch, so the accumulated step equals the full-batch step
  within the sum-order tolerance, 1e-6);
* the SCST step, its rollouts and every decode unchanged by the rate;
* at p = 0 no seed is drawn and the step's loss is, bit for bit, the loss
  of the teacher-forced forward without dropout.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vidcap_tpu_torch.config import apply_overrides, get_preset
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.data.pipeline import DeterministicBatcher
from vidcap_tpu_torch.inference import Captioner
from vidcap_tpu_torch.models import decoder as decoder_mod
from vidcap_tpu_torch.models.decoder import DROPOUT_SITES, Dropout
from vidcap_tpu_torch.models.model import create_model, init_params
from vidcap_tpu_torch.objectives.xe import masked_xe_loss, shift_right
from vidcap_tpu_torch.train.loop import batch_to_device
from vidcap_tpu_torch.train.scst import make_scst_step_body
from vidcap_tpu_torch.train.state import create_train_state
from vidcap_tpu_torch.train.steps import make_step, make_xe_step_body

F32 = ["model.compute_dtype=float32", "train.attribute_loss_weight=0.2"]


def _setup(over, seed=0):
    cfg = apply_overrides(get_preset("synthetic_tiny"), F32 + over)
    ds = CaptionDataset.synthetic(cfg.data)
    model = init_params(create_model(cfg, ds.vocab.size), seed=seed)
    return cfg, ds, create_train_state(cfg, model)


def _batch(ds, B=4):
    return batch_to_device(next(DeterministicBatcher(ds, B, seed=0)), "cpu")


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_share_within_four_sigma(rate):
    n_rows, width = 512, 96
    keep = Dropout(rate, seed=11).mask(n_rows, width, 0, "cpu")
    n = keep.numel()
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(keep.float().mean().item() - (1 - rate)) < 4 * sigma
    # the two sites draw different masks
    other = Dropout(rate, seed=11).mask(n_rows, width, 1, "cpu")
    assert not torch.equal(keep, other)


def test_kept_values_scale_by_one_over_keep_exactly():
    d = Dropout(0.3, seed=2)
    x = torch.randn(64, 40, generator=torch.Generator().manual_seed(0))
    keep = d.mask(64, 40, 0, "cpu")
    y = d.apply(x, keep)
    assert torch.equal(y[keep], x[keep] / 0.7)
    assert torch.equal(y[~keep], torch.zeros_like(y[~keep]))


def test_masks_key_on_seed_and_global_row():
    """A new seed draws new masks; rows are keyed by their global place:
    rows 4..7 of a 8-row mask are the mask of 4 rows from row0 = 4 (a
    microbatch, a data-parallel rank)."""
    full = Dropout(0.4, seed=7).mask(8, 50, 0, "cpu")
    assert torch.equal(full[4:], Dropout(0.4, seed=7, row0=4).mask(
        4, 50, 0, "cpu"))
    assert not torch.equal(full[:4], full[4:])
    assert not torch.equal(full, Dropout(0.4, seed=8).mask(8, 50, 0, "cpu"))
    seed_t = torch.tensor(7, dtype=torch.int64)   # a captured step's buffer
    assert torch.equal(full, Dropout(0.4, seed=seed_t).mask(8, 50, 0, "cpu"))


def test_one_mask_across_a_rows_timesteps(monkeypatch):
    """In the teacher-forced forward each site's mask is drawn once and
    reused at every step: the zeros of the dropped [emb; ctx] and top h sit
    in the same columns of a row at every timestep."""
    cfg, ds, state = _setup(["model.dropout_rate=0.5"])
    b = _batch(ds)
    seen = []
    real = Dropout.apply

    def spy(self, x, keep):
        y = real(self, x, keep)
        seen.append((x.shape[-1], keep, y))
        return y
    monkeypatch.setattr(Dropout, "apply", spy)
    drop = Dropout(0.5, seed=3)
    state.model.xe_logits(b["features"], None, shift_right(b["tokens"]),
                          drop)
    L = b["tokens"].shape[1]
    E, H = cfg.model.embed_dim, cfg.model.hidden_dim
    assert len(seen) == 2 * L
    for width in (E + H, H):
        site = [s for s in seen if s[0] == width]
        assert len(site) == L
        assert all(s[1] is site[0][1] for s in site)   # one mask tensor
        for _, keep, y in site:
            assert torch.equal(y[~keep], torch.zeros_like(y[~keep]))


def test_dropout_changes_the_xe_step_and_draws_one_seed_a_step():
    """The XE step with dropout draws one seed a step from the state's
    generator (the dispatch's static buffer on the card) and its loss
    differs from the deterministic step's; at a given seed it repeats."""
    cfg, ds, state = _setup(["model.dropout_rate=0.3"])
    body = make_xe_step_body(cfg)
    assert body.seeds_per_step == 1
    b = _batch(ds)
    gen0 = state.generator.get_state()
    _, m = make_step(body, "cpu")(state, dict(b))
    assert not torch.equal(state.generator.get_state(), gen0)
    cfg0, _, state0 = _setup([])
    _, m0 = make_xe_step_body(cfg0)(state0, dict(b))
    assert float(m["xe_loss"]) != float(m0["xe_loss"])
    _, _, s1 = _setup(["model.dropout_rate=0.3"])
    _, _, s2 = _setup(["model.dropout_rate=0.3"])
    seed = torch.tensor([5])
    _, a = body(s1, {**b, "seed": seed})
    _, c = body(s2, {**b, "seed": seed})
    assert float(a["loss"]) == float(c["loss"])


def test_grad_accum_microbatches_draw_their_own_masks(monkeypatch):
    """Under grad_accum = 2 each microbatch draws its own masks (rows
    0..1 and 2..3 of the batch), and since the masks are keyed by the row's
    place the accumulated step equals the full-batch step (1e-6)."""
    masks = []
    real = Dropout.mask

    def spy(self, rows, width, site, device):
        m = real(self, rows, width, site, device)
        masks.append((self.row0, site, m))
        return m
    monkeypatch.setattr(Dropout, "mask", spy)
    seed = torch.tensor([9])
    out = {}
    for accum in (1, 2):
        cfg, ds, state = _setup(["model.dropout_rate=0.3",
                                 f"train.grad_accum={accum}"])
        b = _batch(ds)
        masks.clear()
        _, out[accum] = make_xe_step_body(cfg)(state, {**b, "seed": seed})
        if accum == 2:
            by_row0 = {(r, s): m for r, s, m in masks}
            assert sorted(by_row0) == [(0, 0), (0, 1), (2, 0), (2, 1)]
            assert not torch.equal(by_row0[(0, 0)], by_row0[(2, 0)])
        else:
            full = {s: m for _, s, m in masks}
    for site in (0, 1):
        assert torch.equal(torch.cat([by_row0[(0, site)],
                                      by_row0[(2, site)]]), full[site])
    for k in ("loss", "xe_loss", "attr_loss"):
        np.testing.assert_allclose(float(out[2][k]), float(out[1][k]),
                                   rtol=1e-6)


def test_scst_step_and_decodes_ignore_the_rate():
    """The SCST step (its rollouts, re-score, anchor) and greedy, sampled
    and beam decodes are deterministic: the same bits at rate 0.5 as at
    0."""
    results = {}
    for rate in (0.0, 0.5):
        cfg, ds, state = _setup(["train.stage=scst",
                                 f"model.dropout_rate={rate}",
                                 "train.scst_xe_mix=0.1"])
        step = make_scst_step_body(cfg, ds)
        b = _batch(ds)
        _, m = step(state, b, seed=4)
        cap = Captioner(cfg, state.model.eval(), ds, torch.device("cpu"),
                        seed=1)
        f = ds.features[:4]
        results[rate] = ({k: float(v) for k, v in m.items()},
                         [cap.decode_batch(f, method=x, beam_width=3)
                          for x in ("greedy", "sample", "beam")])
    assert results[0.0][0] == results[0.5][0]
    for a, c in zip(results[0.0][1], results[0.5][1]):
        np.testing.assert_array_equal(a, c)


def test_rate_zero_is_todays_step_bit_for_bit():
    """At p = 0: no seed is drawn (the generator is untouched, so SCST's
    seeds stay where they were), and the XE step's loss is, bit for bit,
    the masked XE of the plain teacher-forced forward plus the BCE."""
    cfg, ds, state = _setup([])
    body = make_xe_step_body(cfg)
    assert body.seeds_per_step == 0
    b = _batch(ds)
    model = state.model
    with torch.no_grad():
        feats = model.encode_features(b["features"])
        xe, _ = masked_xe_loss(model.xe_logits(feats, None,
                                               shift_right(b["tokens"])),
                               b["tokens"], b["mask"])
        from vidcap_tpu_torch.objectives.multitask import attribute_bce_loss
        bce = attribute_bce_loss(model.attribute_logits(feats),
                                 b["attributes"])
    gen0 = state.generator.get_state()
    _, m = make_step(body, "cpu")(state, dict(b))
    assert torch.equal(state.generator.get_state(), gen0)
    assert float(m["xe_loss"]) == float(xe)
    assert float(m["loss"]) == float(xe + cfg.train.attribute_loss_weight
                                     * bce)


def test_sites_hash_apart_from_the_sampling_steps():
    """The two sites' hash steps are outside any rollout's step range, so
    a dropout mask never reuses a sampling draw of the same seed."""
    assert all(s > 10_000 for s in DROPOUT_SITES)
    assert len(set(DROPOUT_SITES)) == 2
    assert decoder_mod.Dropout is Dropout
    cfg = dataclasses.replace(get_preset("synthetic_tiny"))
    assert cfg.model.dropout_rate == 0.0
