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

from vidcap_tpu_torch import inference
from vidcap_tpu_torch.config import apply_overrides, get_preset
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.inference import Captioner, staging_chunks
from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.data.vocab import EOS, PAD
from vidcap_tpu_torch.ops.beam_core import beam_core, beam_core_plain
from vidcap_tpu_torch.ops.rollout import (RolloutWeights, replay_plain,
                                          rollout, rollout_plain)
from vidcap_tpu_torch.ops.topk_project import topk_project, topk_project_plain
from vidcap_tpu_torch.data.pipeline import DeterministicBatcher
from vidcap_tpu_torch.models.decoding import Rollout, tile_recurrent
from vidcap_tpu_torch.models.model import create_model, init_params
from vidcap_tpu_torch.objectives.xe import shift_right
from vidcap_tpu_torch.train.loop import batch_to_device, batch_to_device_dict
from vidcap_tpu_torch.train.scst import make_scst_step_body
from vidcap_tpu_torch.train.state import create_train_state
from vidcap_tpu_torch.train.steps import (make_banked_multistep, make_step,
                                          make_xe_step_body)

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
                                    "topk_project_int8": 0, "rollout": 4}
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
                                    "topk_project_int8": 0, "rollout": 0}


def _staging_captioner(frames=8, dim=64):
    cfg = apply_overrides(get_preset("synthetic_tiny"), [
        f"data.num_frames={frames}", f"data.feature_dim={dim}"])
    return Captioner.from_checkpoint(cfg, CaptionDataset.synthetic(
        cfg.data, num_videos=12))


def _host_inputs(cap, B, seed):
    T, D = cap.cfg.data.num_frames, cap.cfg.data.feature_dim
    g = np.random.default_rng(seed)
    mask = np.ones((B, T), np.float32)
    mask[1, T // 2:] = 0.0
    return g.normal(size=(B, T, D)).astype(np.float32), mask


def _pageable_decode(cap, feats, mask, method):
    """The decode of the f32 features copied to the card as they were
    before the staged upload."""
    dev = cap.device
    with torch.inference_mode():
        return cap._decode(torch.as_tensor(feats, device=dev),
                           torch.as_tensor(mask, device=dev), method, 5,
                           1.0, None, 1).cpu().numpy()


@pytest.mark.parametrize("method,B,frames,dim,buffer,chunks", [
    ("beam", 32, 26, 1536, None, 1),      # the serving flush: one chunk
    ("greedy", 32, 26, 1536, None, 1),    # K3
    ("beam", 5, 8, 64, 600, 9),           # 9 chunks, the last ragged
    ("greedy", 5, 8, 64, 600, 9),
    ("beam", 1472, 26, 1536, None, 8)])   # the bulk batch
def test_staged_upload_decodes_as_the_pageable_f32_upload(
        dev, monkeypatch, method, B, frames, dim, buffer, chunks):
    if buffer is not None:
        monkeypatch.setattr(inference, "STAGING_BYTES", buffer)
    cap = _staging_captioner(frames, dim)
    feats, mask = _host_inputs(cap, B, seed=B)
    assert len(staging_chunks(feats.size, 2)) == chunks
    _build.reset_counts()
    toks = cap.decode_batch(feats, method=method, frame_mask=mask)
    assert cap.staged_uploads == 1
    assert (_build.launch_counts["rollout"] == 1 if method == "greedy"
            else _build.launch_counts["beam_core"] == cap.decode_steps)
    assert np.array_equal(toks, _pageable_decode(cap, feats, mask, method))


def test_staged_uploads_back_to_back_reuse_the_ring_safely(dev, monkeypatch):
    """Two uploads of 9 chunks each through 3 buffers, queued behind a
    sleeping kernel so that no copy has left when the host comes round to
    a buffer again: each lands whole. Then two decodes back to back each
    equal their own decode."""
    monkeypatch.setattr(inference, "STAGING_BYTES", 600)
    cap = _staging_captioner()
    (x1, m1), (x2, m2) = _host_inputs(cap, 5, 1), _host_inputs(cap, 5, 2)
    torch.cuda._sleep(50_000_000)
    a = cap._upload(x1, features=True)
    b = cap._upload(x2, features=True)
    for got, x in ((a, x1), (b, x2)):
        assert torch.equal(got.cpu(), torch.from_numpy(x).to(torch.bfloat16))
    t1 = cap.decode_batch(x1, frame_mask=m1)
    t2 = cap.decode_batch(x2, frame_mask=m2)
    assert np.array_equal(t1, _pageable_decode(cap, x1, m1, "beam"))
    assert np.array_equal(t2, _pageable_decode(cap, x2, m2, "beam"))


def test_staged_uploads_count_host_inputs_alone(dev):
    """Host arrays go through the ring (features bf16, mask and pixels
    f32, f64 rounded to f32 first); inputs on the card do not."""
    cap = _staging_captioner()
    feats, mask = _host_inputs(cap, 8, 0)
    cap.decode_batch(feats, frame_mask=mask)
    cap.decode_batch(torch.as_tensor(feats, device=dev), frame_mask=mask)
    assert (cap.decode_calls, cap.staged_uploads) == (2, 1)
    cap.caption_dataset(batch_size=8, device_bank=True)     # 12 videos
    assert (cap.decode_calls, cap.staged_uploads) == (4, 1)
    cap.caption_dataset(batch_size=8)
    assert (cap.decode_calls, cap.staged_uploads) == (6, 3)
    assert cap._upload(feats, features=True).dtype == torch.bfloat16
    assert cap._upload(mask).dtype == torch.float32
    assert cap._upload(np.zeros((2, 2, 4, 4, 3)),
                       features=True).dtype == torch.float32
    x = np.full((2, 8, 64), 1.0 + 2.0 ** -8 + 2.0 ** -30, np.float64)
    assert bool((cap._upload(x, features=True).float() == 1.0).all())


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
                                    "topk_project_int8": 0, "rollout": 2}
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


def _eager_twice_and_captured(dev, stage, k, **model):
    """Three runs of 4 steps of ``stage`` on synthetic_tiny (its ``model``
    fields replaced by ``model``) from the seeded init at B=32: the eager
    body twice, then the dispatched step (captured on the card; banked
    K-step chunks when k > 1) on the same batches and seeds. Returns the
    three runs' metrics and states, flattened."""
    cfg = get_preset("synthetic_tiny")
    ds = CaptionDataset.synthetic(cfg.data)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, stage=stage, batch_size=32), model=dataclasses.replace(
            cfg.model, **model))
    it = DeterministicBatcher(ds, 32, seed=0)
    batches = [batch_to_device_dict(next(it)) for _ in range(4)]
    seeds = torch.randint(0, 2**31 - 1, (4, 1),
                          generator=torch.Generator().manual_seed(3))
    runs = []
    for how in ("eager", "eager", "captured"):
        state = create_train_state(cfg, init_params(
            create_model(cfg, ds.vocab.size), 0).to(dev))
        body = (make_xe_step_body(cfg) if stage == "xe"
                else make_scst_step_body(cfg, ds))
        rec = {}
        if how == "eager":
            for j, b in enumerate(batches):
                d = {key: torch.as_tensor(v, device=dev)
                     for key, v in b.items()}
                state, m = body(state, {**d, "seed": seeds[j]})
                rec.update({f"{j} {key}": v.clone() for key, v in m.items()})
        else:
            if k == 1:
                fn = make_step(body, dev)
            else:
                fn, _ = make_banked_multistep(body, ds, k, device=dev)
            for j in range(0, 4, k):
                part = batches[j:j + k]
                d = part[0] if k == 1 else {
                    key: np.stack([b[key] for b in part]) for key in part[0]
                    if key not in ("features", "attributes")}
                state, m = fn(state, {**d, "seed": seeds[j:j + k].reshape(
                    k, 1) if k > 1 else seeds[j]})
                for i in range(k):
                    rec.update({f"{j + i} {key}": (v[i] if k > 1 else v)
                                .clone() for key, v in m.items()})
        rec.update({k_: p.detach().clone()
                    for k_, p in state.params.items()})
        rec["count"] = state.opt_state["count"].clone()
        torch.cuda.synchronize()
        runs.append(rec)
    return runs


def _max_diff(a, b):
    return max((a[k].double() - b[k].double()).abs().max().item() for k in a)


@pytest.mark.parametrize("stage,k", [("xe", 1), ("scst", 2)])
def test_captured_step_equals_eager(dev, stage, k):
    """The dispatched step on the card (one CUDA graph a call; K3 inside
    for SCST, its seed read from the graph's buffer) against the eager body
    from the same state and seeds: bit for bit where two eager runs are,
    else within twice their difference; the count advanced by 4."""
    eager, again, captured = _eager_twice_and_captured(dev, stage, k)
    floor = _max_diff(eager, again)
    assert _max_diff(eager, captured) <= 2 * floor
    assert int(captured["count"]) == 4


# ------------------------------------------------ K2's int8 variant, the pool

def _int8_inputs(dev, N, H, Vp, vocab, seed):
    from vidcap_tpu_torch.ops.int8_proj import Int8Projection
    g = np.random.default_rng(seed)
    W = torch.tensor(g.normal(size=(H, Vp)) / np.sqrt(H), dtype=torch.float32)
    b = torch.tensor(g.normal(size=Vp) * 0.1, dtype=torch.float32)
    dense = type("Dense", (), {"kernel": W, "bias": b})
    proj = Int8Projection.from_dense(dense, vocab)
    proj = Int8Projection(*(t.to(dev) for t in (proj.w8t, proj.wscale,
                                                 proj.bq)))
    h = torch.tensor(np.tanh(g.normal(size=(N, H))), dtype=torch.float32,
                     device=dev)
    return h, proj


@pytest.mark.parametrize("N,H,Vp,vocab,K", [
    (16, 64, 256, 200, 5),      # vocab_size < Vp: bq holds -1e30 past it
    (24, 64, 264, 264, 8),      # a ragged last tile of 8 columns; K = 8
    (70, 32, 512, 100, 6),      # one ragged 128-row tile
    (920, 512, 16000, 16000, 6),   # the pool at msrvtt_attn_beam5 width
    (129, 1024, 16000, 16000, 5),  # a 1-row 128-row tile; a 5-stage ring
    (256, 96, 1000, 900, 8),    # depth not a multiple of 128 (zero fill)
])
def test_topk_project_int8_matches_plain(dev, N, H, Vp, vocab, K):
    """The quantized rows and scales bit for bit; the logits are the plain
    version's exactly (the same int32 sums and rounding chain), so the
    columns are equal and the values within the f32 lse's error."""
    from vidcap_tpu_torch.ops.int8_proj import (int8_topk_project_plain,
                                                quantize_rows,
                                                topk_project_int8)
    h, proj = _int8_inputs(dev, N, H, Vp, vocab, seed=N + K)
    n = _build.launch_counts["topk_project_int8"]
    v_k, i_k, h8, hs = topk_project_int8(h, proj, K, return_quantized=True)
    v_p, i_p = int8_topk_project_plain(h, proj, K)
    h8_p, hs_p = quantize_rows(h)
    torch.cuda.synchronize()
    assert _build.launch_counts["topk_project_int8"] == n + 1
    assert torch.equal(h8, h8_p) and torch.equal(hs, hs_p)
    assert torch.equal(i_k, i_p)
    assert (v_k - v_p).abs().max().item() <= 1e-4
    again = topk_project_int8(h, proj, K)
    assert torch.equal(again[0], v_k) and torch.equal(again[1], i_k)


def test_topk_project_int8_refuses_what_shared_memory_cannot_hold(dev):
    """Hidden 1,152 is the widest the kernel's block holds (a ring of 4
    stages); 1,184 raises before any launch, as the router's predicate
    says."""
    from vidcap_tpu_torch.ops.int8_proj import topk_project_int8
    from vidcap_tpu_torch.ops.limits import topk_project_int8_takes
    assert topk_project_int8_takes(5, 1152, 512)
    assert not topk_project_int8_takes(5, 1184, 512)
    h, proj = _int8_inputs(dev, 8, 1184, 512, 512, seed=1)
    n = _build.launch_counts["topk_project_int8"]
    with pytest.raises(ValueError, match="shared memory"):
        topk_project_int8(h, proj, 5)
    assert _build.launch_counts["topk_project_int8"] == n


def test_pool_beam_width_is_capped_by_k2(dev):
    """The pool takes K+1 candidates a row and K2 at most 8: beam width 7
    runs K2 at K=8 on every step; at 8 (once refused) K1 runs every step
    and the projection's top-9 goes through PyTorch, no K2 launch, and the
    rows agree with the CPU's decode."""
    cfg = dataclasses.replace(get_preset("synthetic_tiny"), decode=dataclasses
                              .replace(get_preset("synthetic_tiny").decode,
                                       finished_pool="on"))
    cap = Captioner.from_checkpoint(cfg, CaptionDataset.synthetic(
        cfg.data, num_videos=4))
    feats = np.zeros((4, cfg.data.num_frames, cfg.data.feature_dim),
                     np.float32)
    _build.reset_counts()
    cap.decode_steps = 0
    assert cap.decode_batch(feats, beam_width=7).shape == (4, cap.max_len)
    assert _build.launches_by_k == {("topk_project", 8): cap.decode_steps}
    _build.reset_counts()
    cap.decode_steps = 0
    assert cap.kernels("beam", 8) == ("beam_core",)
    got = cap.decode_batch(feats, beam_width=8)
    assert _build.launch_counts["beam_core"] == cap.decode_steps > 0
    assert _build.launch_counts["topk_project"] == 0
    cpu = Captioner(cap.cfg, cap.model.cpu(), cap.dataset,
                    torch.device("cpu"))
    assert (cpu.decode_batch(feats, beam_width=8) == got).all(1).mean() \
        >= 0.75


@pytest.mark.parametrize("over,beam_kernel", [
    ({"num_lstm_layers": 2}, "topk_project"),
    ({"use_attention": False}, "topk_project"),
    ({"compute_dtype": "float32"}, None)])
def test_other_decoders_launch_no_recurrent_kernel(dev, over, beam_kernel):
    """The decoders no kernel covers decode through their modules on the
    card: K1 and K3 launch 0 times; the bf16 beam launches K2 once a step,
    the f32 beam no kernel; the f32 beam's hidden state stays f32."""
    base = get_preset("synthetic_tiny")
    cfg = dataclasses.replace(base, model=dataclasses.replace(base.model,
                                                              **over))
    cap = Captioner.from_checkpoint(cfg, CaptionDataset.synthetic(
        cfg.data, num_videos=8))
    feats = np.random.default_rng(0).normal(
        size=(8, cfg.data.num_frames, cfg.data.feature_dim)).astype(
            np.float32)
    _build.reset_counts()
    cap.decode_steps = 0
    cap.decode_batch(feats, method="greedy")
    cap.decode_batch(feats, method="sample", seed=1)
    assert sum(_build.launch_counts.values()) == 0
    cap.decode_steps = 0
    cap.decode_batch(feats, method="beam", beam_width=3)
    want = {k: 0 for k in _build.KERNELS}
    if beam_kernel:
        want[beam_kernel] = cap.decode_steps
    assert _build.launch_counts == want
    if cfg.model.compute_dtype == "float32":
        st = cap.model.init_state(torch.tensor(feats, device=dev))
        st, h = cap.model.decoder.step_beam_hidden(
            tile_recurrent(st, 3), torch.full((24,), 1, device=dev), 3)
        assert h.dtype == torch.float32
        assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("k", [1, 2])
def test_two_layer_scst_captured_equals_eager(dev, k):
    """A decoder no kernel covers in a captured SCST step: both rollouts
    through its modules inside the graph (the seed read from the graph's
    buffer, the counter hash's step a host scalar, so no copy to the
    device during capture), equal to the eager body as
    test_captured_step_equals_eager holds it; no kernel launched."""
    _build.reset_counts()
    eager, again, captured = _eager_twice_and_captured(
        dev, "scst", k, num_lstm_layers=2)
    floor = _max_diff(eager, again)
    assert _max_diff(eager, captured) <= 2 * floor
    assert int(captured["count"]) == 4
    assert sum(_build.launch_counts.values()) == 0


@pytest.mark.parametrize("over,method,beam,kernels", [
    ({}, "beam", 9, ()),
    ({"hidden_dim": 1024}, "beam", 5, ("beam_core",)),
    ({"hidden_dim": 1024}, "greedy", 5, ())])
def test_shapes_the_kernels_refuse_decode_on_the_card(dev, over, method,
                                                      beam, kernels):
    """Beam 9 and hidden 1024 (K2's and K3's limits) decode without raising
    through the route ``Captioner.kernels`` names (the modules for the
    rest), B=32; at least 3/4 of the rows equal the CPU's decode of the
    same weights (bf16 sums in another order may flip a near-tie)."""
    base = get_preset("synthetic_tiny")
    cfg = dataclasses.replace(base, model=dataclasses.replace(base.model,
                                                              **over))
    cap = Captioner.from_checkpoint(cfg, CaptionDataset.synthetic(
        cfg.data, num_videos=8))
    assert cap.kernels(method, beam) == kernels
    feats = np.random.default_rng(4).normal(
        size=(32, cfg.data.num_frames, cfg.data.feature_dim)).astype(
            np.float32)
    _build.reset_counts()
    cap.decode_steps = 0
    got = cap.decode_batch(feats, method=method, beam_width=beam)
    torch.cuda.synchronize()
    for k in _build.KERNELS:
        n = _build.launch_counts[k]
        assert (n > 0) == (k in kernels), (k, n)
    cpu = Captioner(cfg, cap.model.cpu(), cap.dataset, torch.device("cpu"))
    want = cpu.decode_batch(feats, method=method, beam_width=beam)
    assert (want == got).all(1).mean() >= 0.75


@pytest.fixture
def nccl_world_of_one(dev):
    from vidcap_tpu_torch.parallel import distributed
    from vidcap_tpu_torch.parallel.mesh import make_mesh
    distributed.init_group(dev)
    yield make_mesh(None)
    distributed.shutdown()


@pytest.mark.parametrize("stage", ["xe", "scst"])
def test_world_one_nccl_step_is_the_unsharded_step(nccl_world_of_one,
                                                   stage):
    """A world of one over NCCL: the sharded step (its all-reduces inside
    the captured graph) against the unsharded captured step run twice, 3
    steps, the losses and the parameters: equal where the two unsharded
    runs are, else within twice their largest difference (the card may
    sum an index gradient in another order: chip_smoke.py phase 14's
    rule); SCST launches K3 twice a step."""
    from vidcap_tpu_torch.parallel.sharding import make_sharded_step
    mesh = nccl_world_of_one
    dev = mesh.device
    cfg = get_preset("synthetic_tiny")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, stage=stage, batch_size=32))
    ds = CaptionDataset.synthetic(cfg.data)
    runs = []
    for sharded in (False, False, True):
        state = create_train_state(cfg, init_params(
            create_model(cfg, ds.vocab.size), 0).to(dev))
        body = (make_xe_step_body(cfg) if stage == "xe"
                else make_scst_step_body(cfg, ds))
        fn = (make_sharded_step(mesh, body)[0] if sharded
              else make_step(body, dev))
        it = DeterministicBatcher(ds, 32, seed=0)
        _build.reset_counts()
        rec = {}
        for j in range(3):
            state, m = fn(state, batch_to_device_dict(next(it)))
            rec[f"loss {j}"] = m["loss"].clone()
        torch.cuda.synchronize()
        assert fn.graph is not None
        rec.update({k: p.detach().clone() for k, p in state.params.items()})
        runs.append((rec, dict(_build.launch_counts)))
    (one, c0), (again, _), (sharded_run, c1) = runs
    floor = _max_diff(one, again)
    assert _max_diff(one, sharded_run) <= 2 * floor
    assert c0 == c1
    assert c1["rollout"] == (6 if stage == "scst" else 0)


def test_dropout_draws_new_masks_at_each_replay(dev):
    """XE with dropout 0.5, captured: the seed is written into the graph's
    buffer before each replay, so the second replay at seed 2 is the eager
    body's second step at seed 2 (within 1e-5), and not the replay at seed
    1 again."""
    cfg = get_preset("synthetic_tiny")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dropout_rate=0.5))
    ds = CaptionDataset.synthetic(cfg.data)
    it = DeterministicBatcher(ds, 32, seed=0)
    batches = [batch_to_device_dict(next(it)) for _ in range(2)]
    second = {}
    for how, seeds in (("eager", (1, 2)), ("captured", (1, 2)),
                       ("captured", (1, 1))):
        state = create_train_state(cfg, init_params(
            create_model(cfg, ds.vocab.size), 0).to(dev))
        body = make_xe_step_body(cfg)
        fn = make_step(body, dev)
        for b, seed in zip(batches, seeds):
            d = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
            d["seed"] = torch.tensor([seed], device=dev)
            state, m = (body(state, d) if how == "eager" else fn(state, d))
        second[(how, seeds)] = float(m["xe_loss"])
    want = second[("eager", (1, 2))]
    assert abs(second[("captured", (1, 2))] - want) <= 1e-5 * abs(want)
    assert second[("captured", (1, 1))] != second[("captured", (1, 2))]
