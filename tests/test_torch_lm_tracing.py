"""The language-model decoder's spans, phase marks and expert counter
(``models/lm_decoder.py``, ``utils/profiling.py``), beside
``test_torch_tracing.py``: nothing recorded while tracing is off; under
``recording()`` one ``lm.prefill`` and one ``lm.step`` a step (``id`` the
step), the marks launched in each layer's order, and the counter of
tokens an expert summing to tokens × experts a token in each expert
layer. Imports no JAX."""
import numpy as np
import pytest
import torch

from vidcap_tpu_torch.models import lm_decoder as lm
from vidcap_tpu_torch.models.decoding import KernelWeights, Route
from vidcap_tpu_torch.utils import profiling

CFG = lm.LMDecoderConfig(
    vocab_size=256, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
    n_shared_experts=1, n_routed_experts=8, kv_lora_rank=32,
    qk_rope_head_dim=16, v_head_dim=16, qk_nope_head_dim=16,
    num_experts_per_tok=2, first_k_dense_replace=1, feature_dim=48,
    num_frames=5)
B, K, STEPS = 2, 3, 3


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture
def marks(monkeypatch):
    """The names of the marks the decoder launches (on the CPU
    ``profiling.phase`` launches nothing, so it is recorded here)."""
    got = []
    monkeypatch.setattr(profiling, "phase",
                        lambda name, like: got.append(name))
    return got


def _beam(tracing: bool):
    m = lm.init_lm_params(lm.create_lm_model(CFG), seed=0)
    feats = torch.randn(B, CFG.num_frames, CFG.feature_dim,
                        generator=torch.Generator().manual_seed(1))
    step = lm.lm_beam_step(m, KernelWeights(m).projection(
        Route(None, None, False, None)), K)

    def run():
        st = m.init_beam(feats, torch.ones(B, CFG.num_frames), K, STEPS)
        tok = torch.ones(B * K, dtype=torch.long)
        for _ in range(STEPS):
            st, _, idx = step(st, tok)
            tok = idx[:, 0].long()

    if tracing:
        with profiling.recording():
            run()
    else:
        run()


@pytest.mark.parametrize("tracing", [False, True], ids=["off", "on"])
def test_spans_and_marks_record_only_while_tracing(marks, tracing):
    """Off: no span, no mark, no counter. On: a prefill span, a step span
    with its step as id, and each layer's marks in order: attention, then
    the dense MLP or the experts; the head after the last layer."""
    _beam(tracing)
    spans = profiling.spans()
    if not tracing:
        assert spans == [] and marks == []
        assert profiling.counters("lm.expert_tokens") == []
        return
    assert [s.name for s in spans if s.name == "lm.prefill"] == ["lm.prefill"]
    assert [s.id for s in spans if s.name == "lm.step"] == list(range(STEPS))
    layer = ["lm_attn", "lm_mlp"] + ["lm_attn", "lm_moe"] * 2
    assert marks == layer + (layer + ["lm_head"]) * STEPS


def test_the_expert_counter_sums_to_the_routed_slots():
    """Each expert layer counts every token once for each of its experts:
    the prefill's B·T tokens, then B·K rows a step; ids are the layers."""
    _beam(True)
    got = profiling.counters("lm.expert_tokens")
    experts = CFG.num_hidden_layers - CFG.first_k_dense_replace
    assert len(got) == experts * (1 + STEPS)
    assert [i for i, _ in got[:experts]] == list(range(1, 1 + experts))
    tokens = [B * CFG.num_frames] * experts + [B * K] * experts * STEPS
    for (_, counts), n in zip(got, tokens):
        assert counts.shape == (CFG.n_routed_experts,)
        assert int(np.sum(counts)) == n * CFG.num_experts_per_tok
