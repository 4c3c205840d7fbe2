"""K4 (ops/teacher_forced.py) on the CPU: its plain version against
``CaptionDecoder.xe_logits``'s module loop, bit for bit on the logits and on
every gradient, and the route ``xe_logits`` takes. The kernels themselves
run on the card (tests/test_torch_cuda.py, marker ``cuda``)."""
import dataclasses

import numpy as np
import pytest
import torch

from vidcap_tpu_torch.config import ModelConfig
from vidcap_tpu_torch.models import decoding
from vidcap_tpu_torch.models.decoder import CaptionDecoder, Dropout
from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.ops import teacher_forced as tf


def _params(dec):
    """K4's parameters of ``dec`` and its vocab size."""
    return decoding.KernelWeights(dec).teacher_forced(), dec.vocab_size


def _decoder(B, T, L, E, H, A, V, Vp, D, seed, **over):
    cfg = dataclasses.replace(ModelConfig(), embed_dim=E, hidden_dim=H,
                              attn_dim=A, **over)
    dec = CaptionDecoder(cfg, V, Vp, D)
    g = np.random.default_rng(seed)
    with torch.no_grad():
        for p in dec.parameters():
            p.copy_(torch.tensor(g.normal(size=p.shape)
                                 * (0.5 if p.dim() > 1 else 0.3)))
    feats = torch.tensor(g.normal(size=(B, T, D)), dtype=torch.float32,
                         requires_grad=True)
    mask = torch.ones(B, T)
    mask[1, T // 2:] = 0.0          # masked tail frames
    toks = torch.tensor(g.integers(0, V, size=(B, L)))
    cot = torch.tensor(g.normal(size=(B, L, Vp)), dtype=torch.float32)
    return dec, feats, mask, toks, cot


@pytest.mark.parametrize("B,T,L,E,H,A,V,Vp,seed", [
    (3, 5, 4, 8, 24, 16, 50, 64, 0),      # H != A, padding columns
    (4, 6, 5, 16, 16, 32, 120, 128, 1),
    (2, 3, 5, 32, 32, 32, 60, 64, 2),
])
def test_plain_equals_the_module_loop_bit_for_bit(B, T, L, E, H, A, V, Vp,
                                                  seed):
    """The plain version's logits, and the gradients of a random cotangent
    of them with respect to the features and every parameter, equal the
    loop's bit for bit: every rounding point, forward and backward, where
    the loop has it, and each sum in the loop's order."""
    dec, feats, mask, toks, cot = _decoder(B, T, L, E, H, A, V, Vp, 12, seed)
    leaves = [feats] + list(dec.parameters())
    loop = dec.xe_logits(feats, mask, toks)
    g_loop = torch.autograd.grad(loop, leaves, cot)
    state = dec.init_state(feats, mask)
    plain = tf.teacher_forced_plain(*_params(dec), state, dec.embed(toks))
    g_plain = torch.autograd.grad(plain, leaves, cot)
    assert torch.equal(loop, plain)
    names = ["features"] + [n for n, _ in dec.named_parameters()]
    for name, a, b in zip(names, g_loop, g_plain):
        assert torch.equal(a, b), name


def test_plain_rounds_each_timesteps_weight_gradient():
    """Summing a weight's gradient over timesteps in f32 and rounding once
    (not the loop's order of roundings) is caught by the comparison."""
    dec, feats, mask, toks, cot = _decoder(3, 5, 4, 8, 24, 16, 50, 64, 12, 0)
    state = dec.init_state(feats, mask)
    params = list(dec.parameters())
    ok = torch.autograd.grad(tf.teacher_forced_plain(
        *_params(dec), state, dec.embed(toks)), params, cot,
        retain_graph=False)

    def rounded_once(x, y):
        return sum(x[t].t().mm(y[t]) for t in reversed(range(x.shape[0])))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tf._Plain, "wgrad", staticmethod(rounded_once))
        state = dec.init_state(feats, mask)
        bad = torch.autograd.grad(tf.teacher_forced_plain(
            *_params(dec), state, dec.embed(toks)), params, cot)
    assert any(not torch.equal(a, b) for a, b in zip(ok, bad))


ROUTE_CASES = {
    "kernel": ({}, "cuda", None, True),
    "cpu_tensors": ({}, "cpu", None, False),
    "f32": ({"compute_dtype": "float32"}, "cuda", None, False),
    "two_layers": ({"num_lstm_layers": 2}, "cuda", None, False),
    "no_attention": ({"use_attention": False}, "cuda", None, False),
    "vocab_seam": ({}, "cuda", "seam", False),
    "dropout": ({}, "cuda", "dropout", False),
    "frames_past_the_limit": ({}, "cuda", "frames", False),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_takes_the_kernel_only_where_it_computes_the_call(case):
    """``xe_logits`` takes K4 only on CUDA tensors, for one bf16 LSTM layer
    with attention, no vocab seam, no dropout, at widths K4 takes."""
    over, device, extra, want = ROUTE_CASES[case]
    cfg = dataclasses.replace(ModelConfig(), embed_dim=32, hidden_dim=32,
                              attn_dim=32, **over)
    dec = CaptionDecoder(cfg, 250, 256, 16)
    frames, dropout = 8, None
    if extra == "seam":
        dec.vocab_shard = object()
    elif extra == "dropout":
        dropout = Dropout(0.5, 1)
    elif extra == "frames":
        frames = tf.TF_MAX_FRAMES + 1
    r = decoding.route(dec, None, "teacher_forced", 1, frames,
                       torch.device(device), dropout)
    assert (r.recurrent == "teacher_forced") is want


@pytest.mark.parametrize("over", [{}, {"num_lstm_layers": 2}])
def test_cpu_tensors_run_the_module_loop(over, monkeypatch):
    """On the CPU ``xe_logits`` never reaches K4's wrapper and launches
    nothing; the wrapper itself refuses CPU tensors (no fallback)."""
    cfg = dataclasses.replace(ModelConfig(), embed_dim=16, hidden_dim=16,
                              attn_dim=16, **over)
    dec = CaptionDecoder(cfg, 60, 64, 8)

    def refuse(*a, **k):
        raise AssertionError("the kernel route on the CPU")

    monkeypatch.setattr(tf, "teacher_forced", refuse)
    before = dict(_build.launch_counts)
    feats = torch.randn(2, 3, 8)
    out = dec.xe_logits(feats, None, torch.zeros(2, 4, dtype=torch.long))
    assert out.shape == (2, 4, 64)
    assert _build.launch_counts == before
    monkeypatch.undo()
    if not over:
        state = dec.init_state(feats)
        with pytest.raises(ValueError, match="CUDA"):
            tf.teacher_forced(*_params(dec), state, dec.embed(torch.zeros(
                2, 4, dtype=torch.long)))
