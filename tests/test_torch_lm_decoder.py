"""The language-model caption decoder (``models/lm_decoder.py``) against its
plain reference (``references/kimi_vl_lm.py``) on the CPU, at a tiny size
of the same architecture on seeded random weights: hidden 64, 3 layers (1
dense, 2 of experts), 8 experts, top-2, 1 shared, kv_lora 32, rope 16,
nope 16, v 16, vocab 512; and through ``Captioner`` and
``BatchingCaptioner`` end to end.

Tolerances: the program and the reference round to bf16 at the same
points, but a product's f32 sum runs in another order, so a value may
round to the neighbouring bf16 (2^-8 of it) and carry that on; the logits
are O(1) and bf16 at 2^-8 there, so a few such steps stay under
LOGIT_TOL. Where such a difference reaches the router and swaps an expert
of near-equal score, that token's output moves by a share of one expert's:
FLIP_TOL bounds it, and most positions must stay within LOGIT_TOL.
"""
import dataclasses

import numpy as np
import pytest
import torch

from references import kimi_vl_lm as ref
from vidcap_tpu_torch.config import apply_overrides, get_preset
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.data.vocab import BOS
from vidcap_tpu_torch.inference import Captioner
from vidcap_tpu_torch.models import lm_decoder as lm
from vidcap_tpu_torch.models import decoding
from vidcap_tpu_torch.models.decoding import KernelWeights, beam_decode
from vidcap_tpu_torch.ops.limits import MAX_HIDDEN, topk_project_takes
from vidcap_tpu_torch.serving import BatchingCaptioner

TINY = lm.LMDecoderConfig(
    vocab_size=512, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
    n_shared_experts=1, n_routed_experts=8, kv_lora_rank=32,
    qk_rope_head_dim=16, v_head_dim=16, qk_nope_head_dim=16,
    num_experts_per_tok=2, first_k_dense_replace=1, feature_dim=48,
    num_frames=6)
LOGIT_TOL = 2 ** -7   # two bf16 roundings of O(1) logits (docstring)
FLIP_TOL = 0.1       # an expert swapped on a near-tie (docstring)


def _within(gap):
    """Every gap within FLIP_TOL; 90% of the positions within LOGIT_TOL."""
    worst = gap.reshape(-1, gap.shape[-1]).max(-1).values
    return bool(worst.max() <= FLIP_TOL
                and (worst <= LOGIT_TOL).float().mean() >= 0.9)


@torch.no_grad()
def _teacher_forced_topk(model, proj, feats, frame_mask, tokens, n):
    """The model's own top-``n`` log-probs at each position of given rows:
    the prefill of ``feats``, then <bos> and ``tokens`` i32[R, L] fed
    through the cached steps (one beam a row) → (logp f32[R, L, n], ids
    i32[R, L, n]); position j predicts ``tokens[:, j]``."""
    R, L = tokens.shape
    state = model.init_beam(feats, frame_mask, 1, L)
    prev = torch.full((R,), BOS, dtype=torch.long, device=feats.device)
    vals, ids = [], []
    for j in range(L):
        state, h = model.step_hidden(state, prev)
        v, i = proj.topk(h, n)
        vals.append(v)
        ids.append(i)
        prev = tokens[:, j].long()
    return torch.stack(vals, 1), torch.stack(ids, 1)


def _model(seed=0):
    m = lm.init_lm_params(lm.create_lm_model(TINY), seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    for n, p in m.named_parameters():   # selection and weights differ
        if n.endswith("e_score_correction_bias"):
            p.copy_(torch.randn(p.shape, generator=g) * 0.01)
    return m


def _inputs(R, L, seed=1, padded=False):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(R, TINY.num_frames, TINY.feature_dim, generator=g)
    mask = torch.ones(R, TINY.num_frames)
    if padded:
        mask[:, -2:] = 0.0
    toks = torch.randint(4, TINY.vocab_size, (R, L), generator=g)
    return feats, mask, toks


def _ref_logp(m, feats, mask, toks):
    W = {n: p.detach() for n, p in m.named_parameters()}
    return torch.log_softmax(ref.logits(W, dataclasses.asdict(TINY), feats,
                                        mask, toks, "cpu"), -1)


def test_param_table_names_the_model():
    """The reference's parameter table is the model's names and shapes."""
    m = lm.create_lm_model(TINY, device="meta")
    got = {n: tuple(p.shape) for n, p in m.named_parameters()}
    assert got == {n: s for n, s, _ in ref.param_table(
        dataclasses.asdict(TINY))}


def _head(m):
    """The head as the beam's projection, through no kernel."""
    return KernelWeights(m).projection(decoding.Route(None, None, False,
                                                      None))


@pytest.mark.parametrize("padded", [False, True], ids=["frames", "padded"])
def test_cached_decode_equals_the_reference(padded):
    """The prefill then cached steps (fed <bos> and the tokens) give, at
    each position, top-5 log-probs of the reference's full forward at the
    same ids (:func:`_within`), and the same best id wherever the
    reference's best leads its second by more than FLIP_TOL."""
    m = _model()
    feats, mask, toks = _inputs(4, 6, padded=padded)
    v, i = _teacher_forced_topk(m, _head(m), feats, mask,
                                  toks, 5)
    lp = _ref_logp(m, feats, mask, toks)
    assert _within((lp.gather(2, i.long()) - v).abs())
    top2 = lp.topk(2, -1)
    clear = (top2.values[..., 0] - top2.values[..., 1]) > FLIP_TOL
    assert clear.any()
    assert (i[..., 0].long() == top2.indices[..., 0])[clear].all()


def test_absorbed_decode_equals_the_expanded_form():
    """The decode's absorbed attention over the latent cache gives the
    logits of the program's own expanded form over the whole sequence
    (frames, <bos>, tokens) (:func:`_within`: W_UK folded into q rounds
    where the expanded form rounds k)."""
    m = _model()
    feats, mask, toks = _inputs(3, 5)
    proj = _head(m)
    v, i = _teacher_forced_topk(m, proj, feats, mask, toks, 5)
    T, L = TINY.num_frames, toks.shape[1]
    suffix = torch.cat([torch.full((3, 1), BOS), toks[:, :-1]], 1)
    with torch.no_grad():
        h = torch.cat([m.project(feats), m.embed_tokens[suffix]], 1)
        cos, sin = lm.rope_tables(torch.arange(T + L), TINY.qk_rope_head_dim,
                                  TINY.rope_theta)
        full = torch.cat([mask, torch.ones(3, L)], 1)
        for layer in m.layers:
            o, _ = layer.self_attn.prefill(layer.input_layernorm(h), cos,
                                           sin, full)
            h = layer.mlp_part(h + o)
        logits = (m.norm(h[:, T:]) @ m.lm_head).float()
    lp = torch.log_softmax(logits, -1)
    assert _within((lp.gather(2, i.long()) - v).abs())


@pytest.mark.parametrize("padded", [False, True], ids=["all", "some"])
def test_grouped_experts_equal_the_loop(padded):
    """An expert layer's grouped products (tokens permuted by expert, the
    offsets on the device) equal the reference's loop over the experts on
    the same input, to a bf16 rounding of the output (2^-8 relative), the
    residual zero; with ``padded`` most tokens route to one expert, so some
    experts get none."""
    m = _model()
    moe = m.layers[1].mlp
    x = torch.randn(40, TINY.hidden_size, generator=torch.Generator()
                    .manual_seed(3)).to(torch.bfloat16)
    if padded:
        with torch.no_grad():
            moe.gate.e_score_correction_bias[0] = 10.0
    with torch.no_grad():
        got = moe(x, 1, torch.zeros_like(x)).float()
    L = {n.replace("mlp.", ""): p.detach().float()
         for n, p in m.layers[1].named_parameters() if n.startswith("mlp.")}
    want, _ = ref.experts(x.float(), L, dataclasses.asdict(TINY))
    scale = want.abs().max()
    assert (got - want).abs().max() <= 2 ** -7 * scale


@pytest.mark.parametrize("given", ["own", "program", "one_dropped",
                                   "one_swapped"])
def test_reference_takes_the_given_experts(given):
    """The reference's expert layer given each token's experts: its own
    choice changes nothing (route gap 0); the program's router's choice
    on the same input matches it exactly here (f32 scores of the same
    rounded input, no tie); a dropped expert reads a route gap of the
    dropped one's biased score, a swapped one the difference of the two
    biased scores, and both change the output."""
    m = _model()
    x = torch.randn(40, TINY.hidden_size, generator=torch.Generator()
                    .manual_seed(3)).to(torch.bfloat16).float()
    L = {n.replace("mlp.", ""): p.detach().float()
         for n, p in m.layers[1].named_parameters() if n.startswith("mlp.")}
    c = dataclasses.asdict(TINY)
    own, _ = ref.experts(x, L, c)
    biased = torch.sigmoid(x @ L["gate.weight"]) + L[
        "gate.e_score_correction_bias"]
    top = biased.topk(TINY.n_routed_experts, -1)
    sel, want_gap = top.indices[:, :2], torch.zeros(40)
    if given == "program":
        with torch.no_grad():
            sel = m.layers[1].mlp.gate(x.to(torch.bfloat16))[0]
    elif given == "one_dropped":
        sel, want_gap = sel[:, :1], top.values[:, 1]
    elif given == "one_swapped":
        sel = torch.stack([sel[:, 0], top.indices[:, 2]], 1)
        want_gap = top.values[:, 1] - top.values[:, 2]
    got, gap = ref.experts(x, L, c, forced=sel)
    torch.testing.assert_close(gap, want_gap, rtol=0, atol=1e-6)
    assert torch.equal(got, own) == (given in ("own", "program"))
    # a row of −1: the reference chooses there
    free = torch.cat([sel[:20], torch.full_like(sel[20:], -1)])
    got, gap = ref.experts(x, L, c, forced=free)
    assert torch.equal(got[20:], own[20:]) and not gap[20:].any()


class CopiedState(lm.LMState):
    """The same cache with the beam's reorder done by copying: each row's
    latents are moved into its own slots and the lineage is the identity."""

    def reorder(self, flat_src):
        st = super().reorder(flat_src)
        B, K, L = st.lineage.shape
        T = st.frame_mask.shape[1]
        cache = st.cache.clone()
        for j in range(st.t):
            cols = T + j * K + st.lineage[:, :, j].long()     # [B, K]
            src = torch.gather(st.cache[:, :, T + j * K:T + (j + 1) * K], 2,
                               (cols - T - j * K)[None, :, :, None].expand(
                                   st.cache.shape[0], B, K,
                                   st.cache.shape[-1]))
            cache[:, :, T + j * K:T + (j + 1) * K] = src
        ident = torch.arange(K, dtype=torch.int32)[None, :, None].expand(
            B, K, L).clone()
        return CopiedState(cache=cache, frame_mask=st.frame_mask,
                           lineage=ident, t=st.t)


def test_lineage_reorder_equals_a_copied_cache():
    """A whole beam (K=3, 6 steps) through the lineage table gives the
    tokens and scores of the same beam whose reorder copies each row's
    latents into its own slots: masking a slot and moving it are the
    same attention."""
    m = _model()
    feats, mask, _ = _inputs(2, 1)
    K, L = 3, 6
    proj = _head(m)
    step = lm.lm_beam_step(m, proj, K)
    st = m.init_beam(feats, mask, K, L)
    a = beam_decode(step, st, batch=2, max_len=L, beam_width=K,
                    return_all=True)
    st = m.init_beam(feats, mask, K, L)
    b = beam_decode(step, CopiedState(**vars(st)), batch=2, max_len=L,
                    beam_width=K, return_all=True)
    assert torch.equal(a[0], b[0])
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=1e-5)
    assert (a[0][:, :, 1:] != a[0][:, :1, 1:]).any()   # the beams differ


def _captioner(seed=0):
    cfg = apply_overrides(get_preset("synthetic_tiny"), [
        f"data.feature_dim={TINY.feature_dim}",
        f"data.num_frames={TINY.num_frames}",
        f"data.vocab_size={TINY.vocab_size}", "decode.max_len=5"])
    ds = CaptionDataset.synthetic(cfg.data, num_videos=2)
    return Captioner(cfg, _model(seed).eval(), ds, torch.device("cpu"))


@pytest.mark.parametrize("front", ["captioner", "batching"])
def test_captioner_decodes_the_lm(front):
    """Beam 3 through ``Captioner.decode_batch`` (the prefill, the cached
    steps, the head through K2's plain version) and through
    ``BatchingCaptioner``: ids inside the vocab, the same caption for the
    same video both ways, and greedy the beam of one."""
    cap = _captioner()
    feats = np.random.default_rng(5).normal(
        size=(3, TINY.num_frames, TINY.feature_dim)).astype(np.float32)
    toks = cap.decode_batch(feats, method="beam", beam_width=3)
    assert toks.shape == (3, 5) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < TINY.vocab_size)).all()
    assert cap.kernels("beam", 3) == ("topk_project",)
    assert cap.decode_steps == 5
    greedy = cap.decode_batch(feats, method="greedy")
    np.testing.assert_array_equal(
        greedy, cap.decode_batch(feats, method="beam", beam_width=1))
    if front == "batching":
        svc = BatchingCaptioner(cap.cfg, cap, batch_size=2, method="beam",
                                beam_width=3, max_wait_ms=1.0)
        try:
            got = [svc.submit(f) for f in feats]
        finally:
            svc.close()
        assert got == [cap.dataset.vocab.decode_str(t) for t in toks]


@pytest.mark.parametrize("hidden,vocab", [(2048, 163_840), (1024, 163_840),
                                          (2080, 163_840)])
def test_head_routes_to_k2_exactly_where_the_limits_say(hidden, vocab):
    """On the meta device (nothing allocated): the head's kernel, and the
    Captioner's route, at Kimi-VL's vocabulary are K2 exactly where
    ``ops/limits.py`` takes the hidden width (up to MAX_HIDDEN)."""
    c = dataclasses.replace(lm.KIMI_VL_A3B, hidden_size=hidden)
    m = lm.create_lm_model(c, device="meta")
    takes = topk_project_takes(5, hidden, vocab)
    assert takes is (hidden <= MAX_HIDDEN)
    cfg = apply_overrides(get_preset("msrvtt_attn_beam5"),
                          [f"data.vocab_size={vocab}"])
    assert decoding.route(m, cfg.decode, "beam", 5, cfg.data.num_frames,
                          "cpu").projection == ("topk_project" if takes
                                                else None)
    ds = CaptionDataset.synthetic(cfg.data, num_videos=2)
    cap = Captioner(cfg, m, ds, torch.device("cpu"))
    assert cap.kernels("beam", 5) == (("topk_project",) if takes else ())


def test_the_reference_stands_alone_and_the_benchmark_holds_a_copy():
    """The reference imports plain torch only, and ``benchmark/reference/``
    holds the same file."""
    import ast
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "references", "kimi_vl_lm.py")
    src = open(path).read()
    tops = {(n.module if isinstance(n, ast.ImportFrom) else a.name)
            .split(".")[0] for n in ast.walk(ast.parse(src))
            if isinstance(n, (ast.Import, ast.ImportFrom))
            for a in (n.names if isinstance(n, ast.Import) else [n])}
    assert tops <= {"__future__", "math", "typing", "torch"}
    assert open(os.path.join(root, "benchmark", "reference",
                             "kimi_vl_lm.py")).read() == src


def _inline_moe(moe, x):
    """The expert layer as ``MoE.forward`` composed it inline before its
    passes became named functions (``ops/moe.py``): argsort, bincount,
    cumsum, the gather, the grouped products, the argsort back, the
    batched product, the shared experts' sum. Returns (its output, its
    order, counts, offsets and permuted rows)."""
    from torch.nn import functional as F
    N, H = x.shape
    k, E = moe.cfg.num_experts_per_tok, moe.cfg.n_routed_experts
    sel, w = moe.gate(x)
    flat = sel.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=E)
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    xs = x[order // k]
    ex = moe.experts
    gu = lm.grouped_mm(xs, ex.gate_up_proj, offs)
    g, u = gu.chunk(2, dim=-1)
    y = lm.grouped_mm(F.silu(g) * u, ex.down_proj, offs)
    y = y[torch.argsort(order)].view(N, k, H)
    routed = torch.bmm(w.to(x.dtype)[:, None, :], y)[:, 0]
    return routed + moe.shared_experts(x), (order, counts, offs, xs)


def _moe_case(case):
    """An expert layer of the tiny model and its input for ``case``."""
    m = _model()
    moe = m.layers[1].mlp
    N = 1 if case == "one_token" else 40
    x = torch.randn(N, TINY.hidden_size, generator=torch.Generator()
                    .manual_seed(7)).to(torch.bfloat16)
    with torch.no_grad():
        if case == "one_expert":        # every token's first choice
            moe.gate.e_score_correction_bias[3] = 10.0
        elif case == "none_on_some":    # two experts dominate, some get none
            moe.gate.e_score_correction_bias[:2] = 10.0
    if case in ("k1", "k5"):   # the cfg replaced, as the harness's fault does
        k = 1 if case == "k1" else 5
        for mod in m.modules():
            if isinstance(mod, (lm.MoE, lm.Router)):
                mod.cfg = dataclasses.replace(mod.cfg, num_experts_per_tok=k)
    return m, moe, x


MOE_CASES = ["spread", "none_on_some", "one_expert", "one_token", "k1", "k5"]


@pytest.mark.parametrize("case", MOE_CASES)
def test_plain_moe_passes_equal_the_inline_composition(case):
    """The named plain dispatch, activation and combine (``ops/moe.py``)
    give exactly what the inline code gave: the order, counts, offsets and
    permuted rows, the activation, the layer's output; ``MoE.forward``
    with the residual gives exactly h + that output (``mlp_part``'s old
    composition)."""
    from vidcap_tpu_torch.ops import moe as k5
    m, moe, x = _moe_case(case)
    k = moe.cfg.num_experts_per_tok
    with torch.no_grad():
        want, (order, counts, offs, xs) = _inline_moe(moe, x)
        sel, w = moe.gate(x)
        d = k5.moe_dispatch_plain(sel, x, TINY.n_routed_experts)
        ex = moe.experts
        y = lm.grouped_mm(k5.silu_mul_plain(lm.grouped_mm(
            d.x, ex.gate_up_proj, d.offs)), ex.down_proj, d.offs)
        got = k5.moe_combine_plain(y, d, w, moe.shared_experts(x))
        h = torch.randn(x.shape, generator=torch.Generator().manual_seed(8)
                        ).to(torch.bfloat16)
        with_h = moe(x, 1, h)
    assert sel.shape == (x.shape[0], k)
    for a, b in ((d.order, order), (d.counts, counts), (d.offs, offs),
                 (d.x, xs), (got, want), (with_h, h + want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(d.counts.sum()) == x.shape[0] * k
    if case == "none_on_some":
        assert (d.counts == 0).any()
    if case == "one_expert":
        assert int(d.counts[3]) == x.shape[0]
    gu = torch.randn(30, 2 * TINY.moe_intermediate_size).to(torch.bfloat16)
    g, u = gu.chunk(2, dim=-1)
    assert torch.equal(k5.silu_mul_plain(gu),
                       torch.nn.functional.silu(g) * u)
    assert torch.equal(lm.silu_mul(gu), k5.silu_mul_plain(gu))


@pytest.mark.parametrize("case", ["spread", "k5"])
def test_mlp_part_keeps_the_residual_composition(case):
    """An expert layer's ``mlp_part`` hands h to the experts and equals the
    old h + MoE(norm(h)) exactly, on a [B, T, H] prefill-shaped input; the
    router's forward hook still sees (experts i64[N, k], weights
    f32[N, k])."""
    m, moe, _ = _moe_case(case)
    layer = m.layers[1]
    h = torch.randn(3, 5, TINY.hidden_size, generator=torch.Generator()
                    .manual_seed(9)).to(torch.bfloat16)
    seen = []
    hook = moe.gate.register_forward_hook(
        lambda mod, inp, out: seen.append(out))
    try:
        with torch.no_grad():
            got = layer.mlp_part(h)
            x = layer.post_attention_layernorm(h).reshape(-1, h.shape[-1])
            want = h + _inline_moe(moe, x)[0].view(h.shape)
    finally:
        hook.remove()
    assert torch.equal(got, want)
    sel, w = seen[0]
    k = moe.cfg.num_experts_per_tok
    assert sel.dtype == torch.int64 and sel.shape == (15, k)
    assert w.dtype == torch.float32 and w.shape == (15, k)


def test_the_route_reports_k5_on_the_card_only():
    """On the meta device: Kimi-VL-A3B's decoder lists K5's three kernels
    beside K2 on the card, none on the CPU; a shape ``moe_takes`` refuses
    (257 experts) and a model without expert layers list ``silu_mul``
    alone, which their MLPs still launch."""
    from vidcap_tpu_torch.ops import _build
    cfg = apply_overrides(get_preset("msrvtt_attn_beam5"),
                          ["data.vocab_size=163840"])
    for c, card in ((lm.KIMI_VL_A3B, _build.MOE),
                    (dataclasses.replace(lm.KIMI_VL_A3B,
                                         n_routed_experts=257),
                     ("silu_mul",)),
                    (dataclasses.replace(lm.KIMI_VL_A3B,
                                         first_k_dense_replace=27),
                     ("silu_mul",))):
        m = lm.create_lm_model(c, device="meta")
        for dev, want in (("cuda", card), ("cpu", ())):
            r = decoding.route(m, cfg.decode, "beam", 5, 26, dev)
            assert r.kernels == ("topk_project",) + want
