"""Each cell's check comes out not correct when the timed path is broken
underneath (the harness's look for a card skipped, a run at CPU sizes):
a step that returns its state unchanged, half of the batch left out, a
token altered where it is produced; and under its control, the lower
precision that would tempt a later change (the program's int8 vocab
projection for the decode cells, the reference in float8 for training).
"""
from __future__ import annotations

import copy

import numpy as np
import pytest

from benchmark import common, harness
from benchmark.tools import scst_control

DECODE = common.cells_of("closed_beam")
TRAIN = common.cells_of("scst_train")


def _correct(cell, **kw):
    r = harness.execute(cell["name"], 2**31 + 21, 1.5, False, "cpu",
                        cell=cell, **kw)
    return all(ok for *_, ok in harness.verdict(r))


def _decode_fault(monkeypatch, fault):
    from vidcap_tpu_torch import inference
    if fault == "state_unchanged":
        make = inference.fused_beam_step

        def frozen(*a, **k):
            step = make(*a, **k)

            def s(state, tok):
                _, logp, idx = step(state, tok)
                return state, logp, idx
            return s
        monkeypatch.setattr(inference, "fused_beam_step", frozen)
        return
    local = inference.Captioner.decode_local

    def broken(self, feats, *a, **k):
        toks = local(self, feats, *a, **k)
        if fault == "half_batch":
            h = (len(toks) + 1) // 2
            toks = np.concatenate([toks[:h], toks[:len(toks) - h]])
        else:
            toks = toks.copy()
            toks[:, 0] = (toks[:, 0] + 1) % self.model.vocab_size
        return toks
    monkeypatch.setattr(inference.Captioner, "decode_local", broken)


@pytest.mark.parametrize("name", DECODE)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_decode_fault_is_not_correct(tiny, monkeypatch, name, fault):
    _decode_fault(monkeypatch, fault)
    assert not _correct(tiny(name))


def _train_fault(monkeypatch, fault):
    from vidcap_tpu_torch.models.decoding import Rollout
    from vidcap_tpu_torch.train import scst, state
    if fault == "state_unchanged":
        monkeypatch.setattr(state.Optimizer, "update",
                            lambda self, *a, **k: None)
    elif fault == "half_batch":
        update = scst.ScstStep.update

        def half(self, st, batch, sample, greedy, feats=None):
            h = batch["tokens"].shape[0] // 2
            cut = lambda ro: Rollout(ro.tokens[:h], ro.logp[:h], ro.mask[:h])
            batch = {k: v if k == "seed" else v[:h] for k, v in batch.items()}
            return update(self, st, batch, cut(sample), cut(greedy),
                          None if feats is None else feats[:h])
        monkeypatch.setattr(scst.ScstStep, "update", half)
    else:
        rollout = scst.model_rollout

        def altered(*a, **k):
            ro = rollout(*a, **k)
            if not k.get("sample"):
                ro.tokens[:, 0] = (ro.tokens[:, 0] + 1) % 200
            return ro
        monkeypatch.setattr(scst, "model_rollout", altered)


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_train_fault_is_not_correct(tiny, monkeypatch, name, fault):
    _train_fault(monkeypatch, fault)
    assert not _correct(tiny(name))


@pytest.mark.parametrize("name", DECODE)
def test_decode_control_is_not_correct(name):
    """The int8 vocab projection at the cell's own widths (a smaller
    batch): the decode cells' control."""
    cell = copy.deepcopy(common.load_cell(name))
    cell["traffic_params"].update(batch=128, pool_batches=1, check_rows=128,
                                  warm_decodes=0)
    r = harness.execute(cell["name"], 77, 1.0, False, "cpu", cell=cell,
                        program_overrides=[
                            "decode.int8_vocab_projection=true"])
    assert r.numbers["unexplained_rows"] > cell["limits"]["unexplained_rows"]


@pytest.mark.parametrize("name", TRAIN)
def test_train_control_is_not_correct(tiny, name):
    cell = tiny(name)
    numbers, _ = scst_control.run(cell, 5, None, "cpu", control=True)
    assert any(numbers[k] > v for k, v in cell["limits"].items())
