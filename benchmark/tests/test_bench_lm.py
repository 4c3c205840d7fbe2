"""The language-model cell's arithmetic and readers, pinned on plain data:
the configuration's size and FLOPs (the published 15.96 B parameters and
5.15 GFLOP a beam row a step), the expert phases between the decoder's
marks, the expert load, and the four-card cell's exposed all-reduce. Then
both cells of the language model and of four ranks run whole at sizes the
CPU holds: sound, and with faults that their checks must catch."""
from __future__ import annotations

import copy
import types

import numpy as np
import pytest

from benchmark import common, flops_kimi, harness, lm_marks

CFG = common.load_json(common.config_file("kimi_vl_a3b_beam5"))

# the language-model decoder's architecture at widths the CPU holds
TINY_LM = dict(vocab_size=512, hidden_size=64, intermediate_size=96,
               moe_intermediate_size=32, num_hidden_layers=3,
               num_attention_heads=4, n_shared_experts=1,
               n_routed_experts=8, kv_lora_rank=32, qk_rope_head_dim=16,
               v_head_dim=16, qk_nope_head_dim=16, num_experts_per_tok=2,
               feature_dim=48, num_frames=6, max_len=8)
# the synthetic_tiny widths, as conftest.py shrinks the LSTM's cells
TINY_LSTM = dict(embed_dim=32, hidden_dim=32, attn_dim=32, feature_dim=64,
                 num_frames=8, vocab_size=256, num_attributes=32,
                 max_caption_len=12, max_len=12)
CORPUS = dict(videos=300, captions_per_video=5, pool_words=2000, zipf_s=1.0,
              length_min=3, length_nb_r=3, length_nb_mean=6.0, length_max=40)
TRAFFIC = {   # by traffic kind
    "closed_beam_lm": (TINY_LM, dict(batch=6, pool_batches=2,
                                     check_rows=10)),
    "scst_train_dp4": (TINY_LSTM, dict(corpus=CORPUS, rows_per_rank=4,
                                       pace_steps=2, spawn_timeout_s=600)),
}
CELLS = [w["name"] for w in common.manifest()["workloads"]
         if w["traffic"] in TRAFFIC]


def tiny_cell(name: str):
    """Cell ``name`` of a traffic kind in ``TRAFFIC`` at its CPU widths and
    traffic, with its own limits."""
    cell = copy.deepcopy(common.load_cell(name))
    widths, traffic = TRAFFIC[cell["traffic"]]
    cell["cfg"].update(widths)
    cell["traffic_params"].update(copy.deepcopy(traffic))
    return cell


@pytest.fixture
def tiny():
    return tiny_cell


def test_the_configuration_is_the_published_model():
    assert flops_kimi.params(CFG) == pytest.approx(15.967e9, rel=1e-3)
    assert flops_kimi.step_flops_per_row(CFG, 0) == pytest.approx(
        5.158e9, rel=1e-3)
    # a call of 1,024 videos, 30 steps of 5 beams: about 918 TFLOP
    assert flops_kimi.decode_flops(CFG, 1024, 5, 30) == pytest.approx(
        918.2e12, rel=1e-3)


def _marks(layers, steps, prefill=True):
    """Device events of a decode: the prefill's layer marks, then each
    step's, 1 s a phase, a kernel inside each phase."""
    ev, t = [], 0.0

    def phase(name):
        nonlocal t
        ev.append((f"vidcap_phase_{name}", t, t + 0.001))
        ev.append(("gemm_kernel" if name == "lm_moe" else "other",
                   t + 0.1, t + 0.6))
        t += 1.0

    if prefill:
        for i in range(layers):
            phase("lm_attn")
            phase("lm_mlp" if i == 0 else "lm_moe")
    for _ in range(steps):
        for i in range(layers):
            phase("lm_attn")
            phase("lm_mlp" if i == 0 else "lm_moe")
        phase("lm_head")
    return ev


@pytest.mark.parametrize("prefill", [False, True])
def test_moe_phases_are_the_steps_expert_layers(prefill):
    """Each whole step's expert phases, the prefill's in none; the busy
    and product seconds inside them (each phase: 0.001 + 0.5 s busy, 0.5
    s of product)."""
    ev = _marks(3, 2, prefill)
    steps = lm_marks.moe_phases(ev, 3)
    assert len(steps) == 2 and all(len(s) == 2 for s in steps)
    busy, gemm, n = lm_marks.moe_seconds(ev, 3)
    assert n == 2
    assert busy == pytest.approx(4 * 0.501)
    assert gemm == pytest.approx(4 * 0.5)
    assert lm_marks.moe_seconds([("k", 0.0, 1.0)], 3) is None


def test_expert_load_reads_the_steps_counts():
    reader = common.load_module(common.metric_file("expert_load.kimi"))
    cfg = dict(CFG, n_routed_experts=4, num_experts_per_tok=2)
    even, skew = np.array([5, 5, 5, 5]), np.array([10, 4, 4, 2])
    prefill = np.array([40, 40, 40, 40])
    r = types.SimpleNamespace(cfg=cfg, data={
        "batch": 2, "beam": 5,
        "expert_tokens": [(1, prefill), (1, even), (2, skew)]})
    assert reader.read(r) == pytest.approx((1.0 + 2.0) / 2)


def test_allreduce_counts_what_no_other_kernel_covers():
    reader = common.load_module(common.metric_file("allreduce_ms.dp4"))
    ev = [("ncclDevKernel_AllReduce", 0.0, 0.010),
          ("elementwise_kernel", 0.004, 0.006),
          ("ncclDevKernel_AllReduce", 0.020, 0.025)]
    tracer = types.SimpleNamespace(in_slice=lambda: ev)
    r = types.SimpleNamespace(tracer=tracer, params={"trace_units": 2})
    assert reader.read(r) == pytest.approx((0.008 + 0.005) / 2 * 1e3)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny, name):
    r = harness.execute(name, 2**31 + 11, 1.5, False, "cpu", cell=tiny(name))
    assert all(ok for *_, ok in harness.verdict(r)), harness.verdict(r)
    assert r.attempted > 0 and r.setup_s is not None


def _lm_fault(monkeypatch, fault):
    import dataclasses

    from benchmark import lm_program
    from vidcap_tpu_torch import inference
    from vidcap_tpu_torch.models import lm_decoder as lm
    if fault == "token_altered":
        local = inference.Captioner.decode_local

        def altered(self, *a, **k):
            toks = local(self, *a, **k).copy()
            toks[:, 1] = (toks[:, 1] + 1) % self.model.vocab_size
            return toks
        monkeypatch.setattr(inference.Captioner, "decode_local", altered)
    elif fault == "reorder_skipped":
        monkeypatch.setattr(lm.LMState, "reorder", lambda self, src: self)
    else:   # expert_dropped: one routed expert a token left out
        make = lm_program.captioner

        def captioner(r):
            cap, W = make(r)
            for m in cap.model.modules():
                if isinstance(m, (lm.MoE, lm.Router)):
                    m.cfg = dataclasses.replace(
                        m.cfg, num_experts_per_tok=m.cfg.num_experts_per_tok
                        - 1)
            return cap, W
        monkeypatch.setattr(lm_program, "captioner", captioner)


@pytest.mark.parametrize("fault", ["token_altered", "reorder_skipped",
                                   "expert_dropped"])
def test_lm_decode_fault_is_not_correct(tiny, monkeypatch, fault):
    """The language-model cell's check at the CPU's size: a token altered
    after the decode, a beam reorder that leaves the latent cache's lineage
    as it was, and a routed expert a token left out each fail it."""
    _lm_fault(monkeypatch, fault)
    cell = tiny("kimivl-a3b-beam5-bulk-b1024")
    r = harness.execute(cell["name"], 2**31 + 21, 1.5, False, "cpu",
                        cell=cell)
    assert not all(ok for *_, ok in harness.verdict(r)), r.numbers
