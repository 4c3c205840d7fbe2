"""The port's Hopper kernels on the card (marker ``cuda``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Imports no JAX, so it runs where only PyTorch is installed (``--noconftest``
skips tests/conftest.py, which imports JAX). Each test skips without a CUDA
device: the kernels have no CPU mode. Inputs come from numpy seeds; each
kernel is held against its plain PyTorch version on the same CUDA tensors.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vidcap_tpu_torch.config import get_preset
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.inference import Captioner
from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.data.vocab import EOS, PAD
from vidcap_tpu_torch.ops.beam_core import beam_core, beam_core_plain
from vidcap_tpu_torch.ops.rollout import (RolloutWeights, replay_plain,
                                          rollout, rollout_plain)
from vidcap_tpu_torch.ops.topk_project import topk_project, topk_project_plain
from vidcap_tpu_torch.data.pipeline import DeterministicBatcher
from vidcap_tpu_torch.models.decoding import Rollout
from vidcap_tpu_torch.models.model import create_model, init_params
from vidcap_tpu_torch.objectives.xe import shift_right
from vidcap_tpu_torch.train.loop import batch_to_device
from vidcap_tpu_torch.train.scst import make_scst_step_body
from vidcap_tpu_torch.train.state import create_train_state

pytestmark = pytest.mark.cuda

# h'/c': both sides round at the same bf16 points, but a sum next to a
# rounding boundary of q or of the tanh input/output may land one bf16 ulp
# apart in another summation order and carry through the softmax and the
# gate product. The bound chip_smoke.py holds K1 to at full width.
K1_TOL = 3e-3
# K3, kernel vs plain along the kernel's tokens: the h' differences above
# move a logit by at most a bf16 ulp or two (0.008-0.016 at |logit| ~ 1);
# where the plain top-2 margin is wider than this the picks must agree, and
# the log-probs agree within it (both in logit units, times 1/temperature).
K3_LOGIT_TOL = 0.03


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 products
    return torch.device("cuda")


def _beam_core_args(dev, B, K, T, E, H, A, seed=0):
    g = np.random.default_rng(seed)
    mask = np.ones((B, T), np.float32)
    mask[1, T // 2:] = 0.0          # masked tail frames
    mask[2, :] = 0.0                # a video with no real frame
    f32, bf = torch.float32, torch.bfloat16
    t = lambda a, dt=f32: torch.tensor(a, dtype=dt, device=dev)
    return dict(
        emb=t(g.normal(size=(B * K, E))),
        h=t(np.tanh(g.normal(size=(B * K, H)))),
        c=t(g.normal(size=(B * K, H))),
        keys=t(g.normal(size=(B, T, A)), bf),
        values=t(g.normal(size=(B, T, H)), bf),
        frame_mask=t(mask),
        wq=t(g.normal(size=(H, A)) / np.sqrt(H), bf),
        u=t(g.normal(size=A) * 0.05),
        wg=t(g.normal(size=(E + 2 * H, 4 * H)) / np.sqrt(E + 2 * H), bf),
        bg=t(g.normal(size=4 * H) * 0.1))


@pytest.mark.parametrize("B,K,T,E,H,A", [
    (4, 3, 8, 32, 32, 32),
    (6, 5, 26, 64, 96, 64),         # H != A, the bench's T
    (3, 8, 40, 32, 64, 128),        # the widest beam, T past one warp
    (184, 5, 26, 512, 512, 512),    # msrvtt_attn_beam5 at full width
    (27, 5, 26, 512, 512, 512),     # M = 135: ragged 64- and 128-row tiles
])
def test_beam_core_matches_plain(dev, B, K, T, E, H, A):
    args = _beam_core_args(dev, B, K, T, E, H, A)
    n = _build.launch_counts["beam_core"]
    h_k, c_k = beam_core(**args, beam_width=K)
    h_p, c_p = beam_core_plain(**args, beam_width=K)
    torch.cuda.synchronize()
    assert _build.launch_counts["beam_core"] == n + 1
    assert (h_k - h_p).abs().max().item() < K1_TOL
    assert (c_k - c_p).abs().max().item() < K1_TOL
    assert (h_k - h_p).abs().median().item() < 1e-4


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def _topk_check(h, w, b, K, vocab):
    """Values within one bf16 ulp of the row's largest |logit| (+1e-4 for
    the f32 lse); where the K-th and (K+1)-th are further apart than that,
    the index sets are equal. Returns the kernel's indices."""
    n = _build.launch_counts["topk_project"]
    v_k, i_k = topk_project(h, w, b, K, vocab)
    v_p, i_p = topk_project_plain(h, w, b, K, vocab)
    v_p1, _ = topk_project_plain(h, w, b, K + 1, vocab)
    torch.cuda.synchronize()
    assert _build.launch_counts["topk_project"] == n + 1
    tol = _bf16_ulp((h.bfloat16().float() @ w.float()).abs().amax(1)) + 1e-4
    assert ((v_k - v_p).abs() <= tol[:, None]).all()
    clear = v_p1[:, K - 1] - v_p1[:, K] > tol
    assert clear.float().mean().item() > 0.5
    same = (i_k.sort(1).values == i_p.sort(1).values).all(1)
    assert same[clear].all()
    assert (i_k < vocab).all()
    return i_k


@pytest.mark.parametrize("N,H,Vp,vocab,K", [
    (16, 64, 256, 200, 5),      # vocab_size < Vp: padding columns masked
    (24, 64, 264, 264, 8),      # a ragged last tile of 8 columns; K = 8
    (70, 32, 512, 100, 6),      # two row tiles; K + 1 = 6 (the pool's K)
    (920, 512, 16000, 16000, 5),   # msrvtt_attn_beam5 at full width
])
def test_topk_project_matches_plain(dev, N, H, Vp, vocab, K):
    g = np.random.default_rng(N)
    h = torch.tensor(g.normal(size=(N, H)), dtype=torch.float32, device=dev)
    w = torch.tensor(g.normal(size=(H, Vp)) * 0.1, dtype=torch.bfloat16,
                     device=dev)
    b = torch.tensor(g.normal(size=Vp) * 0.1, dtype=torch.float32, device=dev)
    _topk_check(h, w, b, K, vocab)


def test_topk_project_ties_go_to_the_smallest_column(dev):
    zeros = torch.zeros(8, 32, device=dev)
    _, idx = topk_project(zeros, torch.zeros(32, 256, dtype=torch.bfloat16,
                                             device=dev),
                          torch.zeros(256, device=dev), 5, 256)
    assert (idx.cpu() == torch.arange(5, dtype=torch.int32)).all()

    g = np.random.default_rng(3)
    w = g.normal(size=(64, 384)) * 0.1
    b = g.normal(size=384) * 0.1
    w[:, 1::2], b[1::2] = w[:, 0::2], b[0::2]       # duplicated columns
    h = torch.tensor(g.normal(size=(16, 64)), dtype=torch.float32, device=dev)
    idx = _topk_check(h, torch.tensor(w, dtype=torch.bfloat16, device=dev),
                      torch.tensor(b, dtype=torch.float32, device=dev), 4, 384)
    for row in idx.cpu().tolist():   # a pair is taken as (even, even + 1)
        for k, col in enumerate(row):
            if col % 2:
                assert k > 0 and row[k - 1] == col - 1, row


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    args = _beam_core_args(dev, 3, 3, 8, 32, 32, 32)
    with pytest.raises(ValueError, match="wq"):
        beam_core(**{**args, "wq": args["wq"].float()}, beam_width=3)
    with pytest.raises(ValueError, match="keys"):
        beam_core(**{**args, "keys": args["keys"].cpu()}, beam_width=3)
    with pytest.raises(ValueError, match="beam"):
        beam_core(**args, beam_width=2)
    h = torch.zeros(4, 32, device=dev)
    w = torch.zeros(32, 256, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="K=9"):
        topk_project(h, w, torch.zeros(256, device=dev), 9, 256)
    with pytest.raises(ValueError, match="w_out"):
        topk_project(h, w.t(), torch.zeros(256, device=dev), 5, 256)


def _rollout_args(dev, B=24, T=10, E=64, H=64, A=32, Vp=384, vocab=300,
                  seed=0):
    g = np.random.default_rng(seed)
    mask = np.ones((B, T), np.float32)
    mask[1, T // 2:] = 0.0          # masked tail frames
    mask[2, :] = 0.0                # a video with no real frame
    f32, bf = torch.float32, torch.bfloat16
    t = lambda a, dt=f32: torch.tensor(a, dtype=dt, device=dev)
    b_out = g.normal(size=Vp) * 0.1
    b_out[EOS] = 1.0                # some rows end before max_len
    w = RolloutWeights(
        emb=t(g.normal(size=(Vp, E)) / np.sqrt(E), bf),
        wq=t(g.normal(size=(H, A)) / np.sqrt(H), bf),
        u=t(g.normal(size=A) * 0.05),
        wg=t(g.normal(size=(E + 2 * H, 4 * H)) / np.sqrt(E + 2 * H), bf),
        bg=t(g.normal(size=4 * H) * 0.1),
        w_out=t(g.normal(size=(H, Vp)) * 0.3, bf), b_out=t(b_out),
        vocab_size=vocab)
    return w, (t(g.normal(size=(B, T, A)), bf), t(g.normal(size=(B, T, H)), bf),
               t(mask), t(np.tanh(g.normal(size=(B, H)))),
               t(g.normal(size=(B, H))))


@pytest.mark.parametrize("sample,seed,temperature,B", [
    (False, 0, 1.0, 24), (True, 1, 1.0, 24), (True, 2, 0.7, 24),
    (True, 4, 1.0, 40)])   # 40 rows: two launches of up to 32
def test_rollout_matches_plain(dev, sample, seed, temperature, B):
    """The kernel's rollout, replayed through the plain version: its tokens
    are the plain picks wherever the plain top-2 margin is clear, its logp
    within the tolerance; PAD, logp 0 and mask 0 after the first <eos>."""
    w, args = _rollout_args(dev, B=B)
    L = 12
    n = _build.launch_counts["rollout"]
    tk, lk, mk = rollout(w, *args, L, sample, seed, temperature)
    torch.cuda.synchronize()
    assert _build.launch_counts["rollout"] == n + -(-B // 32)
    pick, margin, logp = replay_plain(w, *args, tk, sample, seed, temperature)
    tol = K3_LOGIT_TOL / temperature
    live = mk > 0
    clear = live & (margin > tol)
    assert clear.float().sum() > 0.5 * live.float().sum()
    assert torch.equal(tk[clear].long(), pick[clear])
    assert (lk - logp)[live].abs().max().item() <= tol
    ended = torch.cumsum((tk == EOS).int(), 1) - (tk == EOS).int() > 0
    assert torch.equal(live, ~ended)
    assert (tk[ended] == PAD).all() and (lk[ended] == 0).all()
    assert 0 < (tk == EOS).any(1).sum().item() < tk.shape[0]
    tp, _, mp = rollout_plain(w, *args, L, sample, seed, temperature)
    assert (tk == tp).all(1).float().mean().item() >= 0.5


@pytest.mark.parametrize("sample,seed,temperature", [
    (False, 0, 1.0), (True, 3, 0.7)])
def test_rollout_modes_agree_and_repeat(dev, sample, seed, temperature):
    """W_out resident and streamed give the same tokens, log-probs and mask,
    and a rollout run again gives them again: the blocks' hand-offs through
    memory leave no race."""
    w, args = _rollout_args(dev)
    runs = [rollout(w, *args, 12, sample, seed, temperature,
                    resident_wout=resident)
            for resident in (True, True, False, False)]
    torch.cuda.synchronize()
    for got in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(got, runs[0]))


def test_rollout_wrapper_refuses_what_the_kernel_does_not_take(dev):
    w, args = _rollout_args(dev)
    with pytest.raises(ValueError, match="keys"):
        rollout(w, args[0].float(), *args[1:], 4)
    with pytest.raises(ValueError, match="w_out"):
        rollout(dataclasses.replace(w, w_out=w.w_out.float()), *args, 4)
    with pytest.raises(ValueError, match="temperature"):
        rollout(w, *args, 4, True, 0, 0.0)


def test_captioner_greedy_and_sample_go_through_the_rollout_kernel(dev):
    """One rollout launch per greedy or sampled decode, K1 and K2 none; the
    same seed gives the same tokens, another seed others."""
    cfg = get_preset("synthetic_tiny")
    cap = Captioner.from_checkpoint(cfg, CaptionDataset.synthetic(
        cfg.data, num_videos=12), seed=1)
    _build.reset_counts()
    greedy = cap.caption_dataset(method="greedy", batch_size=8)
    sample = cap.caption_dataset(method="sample", temperature=0.7,
                                 batch_size=8)
    assert len(greedy) == len(sample) == 12
    assert cap.decode_calls == 4 and cap.decode_steps == 4 * cap.max_len
    assert _build.launch_counts == {"beam_core": 0, "topk_project": 0,
                                    "rollout": 4}
    feats = cap.dataset.features[:8]
    a, b, c = (cap.decode_batch(feats, method="sample", seed=s)
               for s in (7, 7, 8))
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_captioner_beam_goes_through_both_kernels(dev):
    """The default device is the card; every beam step launches K1 and K2
    once, and the captions are whole words of the vocab."""
    cfg = get_preset("synthetic_tiny")
    cap = Captioner.from_checkpoint(cfg, CaptionDataset.synthetic(
        cfg.data, num_videos=12))
    assert cap.device.type == "cuda"
    _build.reset_counts()
    caps = cap.caption_dataset(method="beam", beam_width=5, batch_size=8)
    assert len(caps) == 12 and all(len(c) == 1 for c in caps.values())
    assert cap.decode_steps >= 2
    assert _build.launch_counts == {"beam_core": cap.decode_steps,
                                    "topk_project": cap.decode_steps,
                                    "rollout": 0}


def test_scst_step_rollouts_go_through_the_rollout_kernel(dev):
    """One SCST step on synthetic_tiny at B=32: its two rollouts are two K3
    launches; against the plain rollouts from the same state and seed, at
    least half the rows identical (random weights, as
    test_rollout_matches_plain), equal rewards on identical rows, and K3's
    sampled log-probs within K3_LOGIT_TOL of the differentiable re-score's;
    the update leaves finite metrics and changed parameters."""
    cfg = get_preset("synthetic_tiny")
    ds = CaptionDataset.synthetic(cfg.data)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, stage="scst", batch_size=32))
    state = create_train_state(cfg, init_params(
        create_model(cfg, ds.vocab.size), 0).to(dev))
    step = make_scst_step_body(cfg, ds)
    batch = batch_to_device(next(DeterministicBatcher(ds, 32, seed=0)), dev)
    _build.reset_counts()
    sample, greedy = step.rollouts(state, batch, seed=5)
    torch.cuda.synchronize()
    assert _build.launch_counts == {"beam_core": 0, "topk_project": 0,
                                    "rollout": 2}
    with torch.no_grad():
        st = state.model.init_state(batch["features"])
        w = RolloutWeights.from_model(state.model)
        args = (w, st.keys, st.values, st.frame_mask, st.h[0], st.c[0],
                cfg.decode.max_len)
        ps = Rollout(*rollout_plain(*args, True, 5, cfg.decode.temperature))
        pg = Rollout(*rollout_plain(*args))
        logits = state.model.xe_logits(batch["features"], None,
                                       shift_right(sample.tokens))
    same = (sample.tokens == ps.tokens).all(1) & (greedy.tokens ==
                                                  pg.tokens).all(1)
    assert same.float().mean().item() >= 0.5
    for a, b in zip(step.rewards(batch, sample, greedy),
                    step.rewards(batch, ps, pg)):
        torch.testing.assert_close(a[same], b[same])
    rescored = torch.log_softmax(logits, -1).gather(
        -1, sample.tokens.long()[..., None])[..., 0]
    live = sample.mask > 0
    assert (rescored - sample.logp)[live].abs().max().item() <= K3_LOGIT_TOL
    before = {k: p.detach().clone() for k, p in state.params.items()}
    state, m = step.update(state, batch, sample, greedy)
    assert all(torch.isfinite(v) for v in m.values())
    assert any(not torch.equal(p, before[k]) for k, p in state.params.items())
