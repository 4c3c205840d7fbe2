"""The reference's judgement of decoded captions.

Beam rows (:func:`beam` with ``follow``): the reference runs its own beam
search over the same videos (slot-blocking, no length penalty, each row's
K best log-probabilities as candidates, ties to the smaller token id and
the earlier candidate), but wherever the judged row's prefix is a
candidate that the reference ranks at most ``margin`` below what it would
keep instead, it keeps the prefix. A row is explained when its whole
hypothesis is kept so and ends within ``margin`` of the best; the
compared number is the share of rows that are not. Random weights leave
many near-ties, so right computations part rows at rounding's scale; a
fault, or a lower precision, parts them by more.

Greedy rows (:func:`token_gaps` with K = 1): the gap of each token's
logit below the best after its own prefix, up to and including its first
<eos>; the compared number is the widest.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference import model as ref

EOS, BOS, PAD = 2, 1, 0


def token_gaps(W: Dict, feats: np.ndarray, mask: np.ndarray,
               tokens: np.ndarray, K: int, vocab: int, cd, device,
               block: int = 256) -> np.ndarray:
    """f32[N, L] gaps of each token below the K-th best logit after its
    prefix; positions after the first <eos> read -inf."""
    ref.full_f32()
    N, L = tokens.shape
    out = np.full((N, L), -np.inf, np.float32)
    for a in range(0, N, block):
        b = min(a + block, N)
        tok = torch.as_tensor(tokens[a:b], device=device).long()
        inp = torch.cat([torch.full_like(tok[:, :1], BOS), tok[:, :-1]], 1)
        with torch.no_grad():
            lg = ref.teacher_forced(
                W, torch.as_tensor(feats[a:b], device=device),
                torch.as_tensor(mask[a:b], device=device), inp, vocab, cd)
            kth = torch.topk(lg, K, dim=-1).values[..., K - 1]
            gap = kth - lg.gather(-1, tok[..., None])[..., 0]
        # real positions: up to and including the first <eos>
        ended = torch.cumsum((tok == EOS).int(), 1) - (tok == EOS).int()
        gap = torch.where(ended == 0, gap, torch.full_like(gap, -np.inf))
        out[a:b] = gap.cpu().numpy()
    return out


def _topk_stable(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def beam(W: Dict, feats: np.ndarray, mask: np.ndarray, K: int, L: int,
         vocab: int, cd, device, block: int = 128, follow=None,
         margin: float = 0.0):
    """The reference's beam search: the best of K slot-blocking beams a
    video (a finished beam extends only by <pad> at no cost), the raw
    sum of log-probabilities as score; tokens i32[N, L].

    ``follow`` (i32[N, L], rows to judge) with ``margin``: the beam keeps
    a row's prefix wherever the reference ranks it at most ``margin``
    below what it would keep instead (a near-tie), and returns (tokens,
    bool[N]: whether each row's whole hypothesis was kept so and ends
    within ``margin`` of the best)."""
    ref.full_f32()
    out, kept = [], []
    for a in range(0, len(feats), block):
        f = torch.as_tensor(feats[a:a + block], device=device)
        m = torch.as_tensor(mask[a:a + block], device=device)
        n = f.shape[0]
        st = ref.init_state(W, f, m, cd)
        rep = lambda x: x.repeat_interleave(K, dim=0)
        st = ref.State(rep(st.h), rep(st.c), rep(st.keys), rep(st.values),
                       rep(st.mask))
        seq = torch.zeros(n, K, L, dtype=torch.int32, device=device)
        score = torch.zeros(n, K, device=device)
        done = torch.zeros(n, K, dtype=torch.bool, device=device)
        prev = torch.full((n * K,), BOS, dtype=torch.long, device=device)
        rows = torch.arange(n, device=device)[:, None]
        hyp = (None if follow is None else
               torch.as_tensor(follow[a:a + block], device=device).long())
        path = torch.zeros(n, K, dtype=torch.bool, device=device)
        path[:, 0] = True
        ok = torch.ones(n, dtype=torch.bool, device=device)
        for t in range(L):
            if bool(done.all()):
                break
            st, lg = ref.step(W, st, prev, vocab, cd)
            logp = torch.log_softmax(lg, -1)
            lp, idx = _topk_stable(logp, K)
            lp, idx = lp.view(n, K, K), idx.view(n, K, K)
            if hyp is not None:
                lp, idx, ok, want = _offer(logp.view(n, K, -1), lp, idx,
                                           hyp[:, t], path, done, ok,
                                           margin, t == 0)
            pad_only = torch.full((K,), ref.NEG, device=device)
            pad_only[0] = 0.0
            lp = torch.where(done[:, :, None], pad_only, lp)
            idx = torch.where(done[:, :, None], torch.full_like(idx, PAD),
                              idx)
            cand = score[:, :, None] + lp
            if t == 0:
                cand[:, 1:] = ref.NEG
            cand = cand.reshape(n, K * K)
            top, pick = _topk_stable(cand, K)
            if hyp is not None:
                top, pick, ok = _keep(cand, top, pick, want, ok, margin)
            score = top
            src = pick // K
            tok = idx.reshape(n, K * K).gather(1, pick)
            seq = seq[rows, src]
            seq[:, :, t] = tok.int()
            done = done[rows, src] | (tok == EOS)
            if hyp is not None:
                path = path[rows, src] & (tok == hyp[:, t:t + 1])
            flat = (rows * K + src).reshape(-1)
            st = ref.State(st.h[flat], st.c[flat], st.keys, st.values,
                           st.mask)
            prev = tok.reshape(-1)
        best = score.argmax(-1)
        out.append(seq[torch.arange(n, device=device), best].cpu().numpy())
        if hyp is not None:
            on = path & (score >= score.max(-1, keepdim=True).values
                         - margin)
            kept.append((ok & on.any(-1)).cpu().numpy())
    toks = np.concatenate(out)
    return toks if follow is None else (toks, np.concatenate(kept))


def _offer(logp, lp, idx, y, path, done, ok, margin, first):
    """Make the followed token a candidate of its prefix's beam where the
    reference ranks it within ``margin`` of that row's K-th best; returns
    (lp, idx, ok, the candidate's flat index or -1)."""
    n, K, _ = lp.shape
    ar = torch.arange(n, device=lp.device)
    has = path & ok[:, None]
    if first:
        has = has & (torch.arange(K, device=lp.device) == 0)[None, :]
    live = has.any(-1)
    k = has.float().argmax(-1)
    fin = done[ar, k]
    same = idx[ar, k] == y[:, None]
    hit = same.any(-1)
    ly = logp[ar, k, y]
    near = ~hit & ~fin & (ly >= lp[ar, k, K - 1] - margin)
    put = live & near
    lp[ar[put], k[put], K - 1] = ly[put]
    idx[ar[put], k[put], K - 1] = y[put]
    want = torch.where(fin, k * K, torch.where(
        hit, k * K + same.float().argmax(-1),
        torch.where(near, k * K + K - 1, torch.full_like(k, -1))))
    want = torch.where(live, want, torch.full_like(want, -1))
    return lp, idx, ok & (~live | (want >= 0)), want


def _keep(cand, top, pick, want, ok, margin):
    """Keep the followed candidate among the K picks where it lies within
    ``margin`` of the K-th pick; a row whose candidate lies further below
    is no longer followed."""
    K = pick.shape[1]
    act = (want >= 0) & ok
    there = (pick == want[:, None]).any(-1)
    cw = cand.gather(1, want.clamp(min=0)[:, None])[:, 0]
    fits = cw >= top[:, K - 1] - margin
    put = act & ~there & fits
    pick[put, K - 1] = want[put]
    top[put, K - 1] = cw[put]
    return top, pick, ok & ~(act & ~there & ~fits)
