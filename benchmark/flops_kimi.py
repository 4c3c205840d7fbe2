"""The yardstick's arithmetic for the language-model decode cell, frozen
here so that no change to the program moves it: a decode's model FLOPs
(2 a multiply-add: the prefill, then each step of each beam), K2's
operations and bytes at the head, and the expert layers' products a
step. The peaks are ``flops.py``'s.
"""
from __future__ import annotations

import math
from typing import Dict

from benchmark.reference import kimi_vl_lm as ref

def step_flops_per_row(c: Dict, context: int) -> int:
    """One decode step of one row (model FLOPs, 2 a multiply-add): every
    layer's q, latent, absorbed W_UK/W_UV and output products and its
    attention over ``context`` positions (scores over the latent and rope
    dims, the weighted sum over the latent); the dense layers' MLP; each
    expert layer's router, its routed experts (``num_experts_per_tok``)
    and shared experts; the head."""
    H, nh, r = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
    nope, rp, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                    c["v_head_dim"])
    L, dense = c["num_hidden_layers"], c["first_k_dense_replace"]
    attn = (H * nh * (nope + rp) + H * (r + rp) + nh * vd * H
            + nh * nope * r + nh * r * vd + nh * context * (r + rp + r))
    return 2 * (L * attn + dense * 3 * H * c["intermediate_size"]
                + (L - dense) * (H * c["n_routed_experts"]
                                 + expert_macs_per_token(c))
                + H * c["vocab_size"])


def expert_macs_per_token(c: Dict) -> int:
    """Multiply-adds of one token's routed and shared experts in a layer."""
    H, I = c["hidden_size"], c["moe_intermediate_size"]
    return 3 * H * I * (c["num_experts_per_tok"] + c["n_shared_experts"])


def prefill_flops_per_video(c: Dict) -> int:
    """The prefill of one video's T frames: the projector, and every layer
    in the expanded form (q, latent, k_nope and v from the latent, causal
    attention, output) with its MLP; no head."""
    H, nh, r = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
    nope, rp, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                    c["v_head_dim"])
    T, D = c["num_frames"], c["feature_dim"]
    L, dense = c["num_hidden_layers"], c["first_k_dense_replace"]
    pairs = T * (T + 1) // 2
    attn = (T * (H * nh * (nope + rp) + H * (r + rp) + r * nh * (nope + vd)
                 + nh * vd * H) + pairs * nh * (nope + rp + vd))
    mlp = T * (dense * 3 * H * c["intermediate_size"]
               + (L - dense) * (H * c["n_routed_experts"]
                                + expert_macs_per_token(c)))
    return 2 * (T * (D * H + H * H) + L * attn + mlp)


def decode_flops(c: Dict, videos: int, beam: int, steps: int) -> int:
    """A beam decode of ``videos`` videos that ran ``steps`` steps: the
    prefill, then each step for every beam (step t attends T + t + 1
    positions)."""
    T = c["num_frames"]
    return videos * prefill_flops_per_video(c) + videos * beam * sum(
        step_flops_per_row(c, T + t + 1) for t in range(steps))


def k2_flops(rows: int, c: Dict) -> int:
    """K2 at the head: the vocab projection of ``rows`` rows."""
    return 2 * rows * c["hidden_size"] * c["vocab_size"]


def k2_bytes(rows: int, c: Dict, K: int) -> int:
    H, V = c["hidden_size"], c["vocab_size"]
    return rows * H * 4 + H * V * 2 + V * 4 + rows * K * 8


def moe_flops_per_step(c: Dict, rows: int) -> int:
    """The expert layers' routed and shared products of one step."""
    return 2 * rows * (c["num_hidden_layers"] - c["first_k_dense_replace"]) \
        * expert_macs_per_token(c)


def params(c: Dict) -> int:
    return sum(math.prod(s) for _, s, _ in ref.param_table(c))
