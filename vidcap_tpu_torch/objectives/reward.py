"""Device CIDEr-D (+ BLEU-4) reward as batched tensor ops, the semantics of
``vidcap_tpu/objectives/reward.py`` (== ``metrics/cider.py``, pycocoevalcap's).

For a unique gram g with candidate count tf_c, appearing at tf_c positions,
summing f(g)/tf_c over its positions gives f(g) once. So, per order n:

  dot_n(c, r) = Σ_{i ∈ order n} min(tf_c_i, tf_r_i) · tf_r_i · idf_i² / tf_c_i
  ‖vec_c‖²_n  = Σ_{i ∈ order n} tf_c_i · idf_i²            (= Σ_g tf_c² idf²)

where tf_r_i and idf_i come from matching position i's hashed key against
the video's reference table, and the candidate norm's idf from the corpus
IDF hash table (a miss ⇒ log N, the df = 0 weight). Everything is
fixed-shape: [B, 4L] candidate keys against [B, R, G] reference entries, one
[B, 4L, R, G] masked equality.
"""
from __future__ import annotations

from typing import Tuple

import torch

from vidcap_tpu_torch.data.vocab import EOS
from vidcap_tpu_torch.objectives.reward_tables import NGRAMS, RewardTables
from vidcap_tpu_torch.ops.ngram_hash import device_ngram_keys

SIGMA = 6.0


def caption_mask(tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The rollout mask includes <eos>; the scored caption does not (the
    references are stored without specials)."""
    return mask * (tokens != EOS).to(mask.dtype)


def _candidate_keys(tokens: torch.Tensor, cmask: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
    """tokens int[B, L] → all orders stacked: keys lo/hi i64[B, 4L],
    validity f32[B, 4L], order i64[B, 4L]."""
    B, L = tokens.shape
    los, his = device_ngram_keys(tokens, NGRAMS)
    valids, orders = [], []
    pos = torch.arange(L, device=tokens.device)
    for n in range(1, NGRAMS + 1):
        v = cmask
        for k in range(1, n):
            v = v * torch.roll(cmask, -k, dims=-1)
        # positions within L-n+1 only (the roll wraps: cut the tail)
        valids.append(v * (pos < L - n + 1).to(cmask.dtype)[None, :])
        orders.append(torch.full((B, L), n, device=tokens.device))
    return (torch.cat(los, -1), torch.cat(his, -1), torch.cat(valids, -1),
            torch.cat(orders, -1))


def _idf_lookup(lo: torch.Tensor, hi: torch.Tensor, tables: RewardTables
                ) -> torch.Tensor:
    """Corpus IDF weight per candidate gram by fixed-probe open addressing."""
    S = tables.idf_key_lo.shape[0]
    slot = lo % S
    val = torch.full(lo.shape, tables.log_n, dtype=torch.float32,
                     device=lo.device)
    found = torch.zeros(lo.shape, dtype=torch.bool, device=lo.device)
    for p in range(tables.num_probes):
        s = (slot + p) % S
        hit = ((tables.idf_key_lo[s] == lo) & (tables.idf_key_hi[s] == hi)
               & ~found)
        val = torch.where(hit, tables.idf_val[s], val)
        found = found | hit
    return val


def _term_freq(lo, hi, valid, order) -> torch.Tensor:
    """Within-candidate term frequency per position: the positions of the
    same order with equal keys, at least 1 (pad positions)."""
    same = ((lo[:, :, None] == lo[:, None, :]) & (hi[:, :, None] == hi[:, None, :])
            & (order[:, :, None] == order[:, None, :]))
    tf_c = torch.einsum("bij,bj->bi", same.float(), valid)
    return torch.clamp(tf_c, min=1.0)


def _order_onehot(order: torch.Tensor) -> torch.Tensor:
    n = torch.arange(1, NGRAMS + 1, device=order.device)
    return (order[:, :, None] == n[None, None, :]).float()    # [B, 4L, 4]


def _ref_match(lo, hi, tables: RewardTables, video_idx) -> torch.Tensor:
    """f32[B, 4L, R, G]: 1 where a candidate position's key equals a
    reference entry's."""
    r_lo = tables.ref_key_lo[video_idx]                        # [B, R, G]
    r_hi = tables.ref_key_hi[video_idx]
    return ((lo[:, :, None, None] == r_lo[:, None, :, :])
            & (hi[:, :, None, None] == r_hi[:, None, :, :])).float()


def cider_reward(tables: RewardTables, video_idx: torch.Tensor,
                 tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """CIDEr-D of each rollout against its video's references: video_idx
    int[B], tokens int[B, L], mask f32[B, L] (the rollout mask, incl.
    <eos>) → f32[B]. Exact pycocoevalcap semantics up to 64-bit hash
    collisions."""
    video_idx = video_idx.long()
    cmask = caption_mask(tokens, mask)
    lo, hi, valid, order = _candidate_keys(tokens, cmask)     # [B, 4L]
    tf_c = _term_freq(lo, hi, valid, order)
    idf_c = _idf_lookup(lo, hi, tables)
    onehot = _order_onehot(order)
    # Σ_i tf_c·idf² per order = Σ_g tf_c²·idf² (each gram's tf_c positions)
    norm_sq = torch.einsum("bi,bin->bn", valid * tf_c * idf_c * idf_c, onehot)
    norm_c = torch.sqrt(norm_sq)                               # [B, 4]

    eqf = _ref_match(lo, hi, tables, video_idx)                # [B, 4L, R, G]
    tf_r = torch.einsum("birg,brg->bir", eqf, tables.ref_tf[video_idx])
    idf_r = torch.einsum("birg,brg->bir", eqf, tables.ref_idf[video_idx])
    # clipped dot per position, divided by tf_c to undo the duplication
    contrib = (torch.minimum(tf_c[:, :, None], tf_r) * tf_r * idf_r * idf_r
               / tf_c[:, :, None]) * valid[:, :, None]         # [B, 4L, R]
    dot = torch.einsum("bir,bin->bnr", contrib, onehot)        # [B, 4, R]

    denom = norm_c[:, :, None] * tables.ref_norm[video_idx].transpose(1, 2)
    val = torch.where(denom > 0, dot / torch.clamp(denom, min=1e-12),
                      torch.zeros_like(dot))
    len_c = cmask.sum(-1)
    delta = len_c[:, None] - tables.ref_len[video_idx]         # [B, R]
    pen = torch.exp(-(delta ** 2) / (2 * SIGMA ** 2)) \
        * tables.ref_valid[video_idx]
    per_ref = val.mean(dim=1) * pen                            # [B, R]
    return (per_ref.sum(-1) / torch.clamp(tables.num_refs[video_idx], min=1.0)
            * 10.0)


def bleu4_reward(tables: RewardTables, video_idx: torch.Tensor,
                 tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Smoothed sentence BLEU-4 (``metrics/bleu.sentence_bleu4``'s
    semantics) per rollout → f32[B]."""
    video_idx = video_idx.long()
    B = tokens.shape[0]
    cmask = caption_mask(tokens, mask)
    lo, hi, valid, order = _candidate_keys(tokens, cmask)
    tf_c = _term_freq(lo, hi, valid, order)
    eqf = _ref_match(lo, hi, tables, video_idx)
    tf_r = torch.einsum("birg,brg->bir", eqf, tables.ref_tf[video_idx])
    tf_r_max = tf_r.max(dim=-1).values                         # over refs
    onehot = _order_onehot(order)
    clip = torch.einsum("bi,bin->bn",
                        valid * torch.minimum(tf_c, tf_r_max) / tf_c, onehot)
    tot = torch.einsum("bi,bin->bn", valid, onehot)
    p = (clip + 1.0) / (tot + 1.0)
    logp = torch.log(torch.clamp(p, min=1e-12)).mean(dim=-1)   # [B]

    len_c = cmask.sum(-1)
    r_len = tables.ref_len[video_idx]
    # the closest reference length, ties to the shorter
    diff = (r_len - len_c[:, None]).abs() \
        + (1.0 - tables.ref_valid[video_idx]) * 1e9
    closest = r_len[torch.arange(B, device=r_len.device),
                    torch.argmin(diff + r_len * 1e-6, dim=-1)]
    bp = torch.where(len_c > closest, torch.ones_like(len_c),
                     torch.exp(1.0 - closest / torch.clamp(len_c, min=1.0)))
    return torch.where(len_c > 0, bp * torch.exp(logp),
                       torch.zeros_like(len_c))


def scst_reward(tables: RewardTables, video_idx: torch.Tensor,
                tokens: torch.Tensor, mask: torch.Tensor,
                bleu_mix: float = 0.0) -> torch.Tensor:
    r = cider_reward(tables, video_idx, tokens, mask)
    if bleu_mix > 0:
        r = (1.0 - bleu_mix) * r + bleu_mix * bleu4_reward(
            tables, video_idx, tokens, mask)
    return r
