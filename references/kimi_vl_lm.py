"""The plain reference of the language-model caption decoder: Kimi-VL-A3B-
Instruct's language model (the DeepSeek-V3 architecture,
https://huggingface.co/moonshotai/Kimi-VL-A3B-Instruct/blob/main/config.json)
after a prefix of frame features, written out in PyTorch operations. It
imports nothing of the program: the configuration is a dict under the
config's own keys, the weights a dict of tensors under the names of
:func:`param_table`.

A full causal forward with no cache, no batching tricks and no grouped
products: every row's whole sequence (its T frames, <bos>, its tokens)
through every layer, attention in the expanded form (k_nope and v from
c_kv), the routed experts by a loop over the experts. The experts of a
token are the reference's own choice, or the program's, given: a near tie
of two experts' scores that one rounding tips would otherwise part the two
forwards by far more than rounding. Given, the reference still weights
them by its own scores and reports how far they fall short of its own
choice (the route gap).

Arithmetic: every tensor is float32, products accumulate in float32 with
TF32 off (:func:`full_f32`), and a value is rounded to bfloat16 and back
(``rnd``) where the program rounds: each product's output, each norm's
output before and after its weight, RoPE's output, the activation and the
gated product of each MLP, the projector's bias adds, each residual add,
the attention scores before the scale and the attention weights after the
f32 softmax, the routing weights before they weight the experts' outputs
(summed in f32, then rounded), and the sum with the shared experts. The
router computes in f32 on the rounded input.

Departures from the published description, all because the system captions
from per-frame features and has no trained weights:
* the projector: Linear D→hidden (with bias), GELU, Linear hidden→hidden
  (with bias) from the pooled IRv2 feature of each frame, in place of
  Kimi-VL's MoonViT tower and pixel-shuffle projector;
* the prefix: the T projected frames at positions 0..T−1, then <bos> at T
  and the caption's tokens after it;
* the weights: random from a seed, N(0, 0.02) (DeepSeek-V3's
  ``initializer_range``), norms one, biases zero, and
  ``e_score_correction_bias`` N(0, 0.01) so that selection and weighting
  differ.

On the card it upcasts one layer's bf16 weights at a time.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

NEG = -1e30


def full_f32() -> None:
    """Products in full f32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rnd(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def param_table(c: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter; kind ``normal`` (the
    initializer's N(0, 0.02)), ``one`` (a norm), ``zero`` (a bias) or
    ``correction`` (the score correction). Weights are [in, out]; a gated
    MLP's gate and up are one [in, 2·width] weight, gate first; kv_b_proj's
    columns are, head by head, [k_nope; v]; experts are stacked [E, ...]."""
    H, D, V = c["hidden_size"], c["feature_dim"], c["vocab_size"]
    nh, r = c["num_attention_heads"], c["kv_lora_rank"]
    nope, rope, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
    E, I = c["n_routed_experts"], c["moe_intermediate_size"]
    out = [("proj_fc1", (D, H), "normal"), ("proj_fc1_bias", (H,), "zero"),
           ("proj_fc2", (H, H), "normal"), ("proj_fc2_bias", (H,), "zero"),
           ("embed_tokens", (V, H), "normal")]
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "input_layernorm.weight", (H,), "one"),
                (p + "self_attn.q_proj", (H, nh * (nope + rope)), "normal"),
                (p + "self_attn.kv_a_proj_with_mqa", (H, r + rope), "normal"),
                (p + "self_attn.kv_a_layernorm.weight", (r,), "one"),
                (p + "self_attn.kv_b_proj", (r, nh * (nope + vd)), "normal"),
                (p + "self_attn.o_proj", (nh * vd, H), "normal"),
                (p + "post_attention_layernorm.weight", (H,), "one")]
        if i < c["first_k_dense_replace"]:
            W = c["intermediate_size"]
            out += [(p + "mlp.gate_up_proj", (H, 2 * W), "normal"),
                    (p + "mlp.down_proj", (W, H), "normal")]
        else:
            S = c["n_shared_experts"] * I
            out += [(p + "mlp.gate.weight", (H, E), "normal"),
                    (p + "mlp.gate.e_score_correction_bias", (E,),
                     "correction"),
                    (p + "mlp.experts.gate_up_proj", (E, H, 2 * I), "normal"),
                    (p + "mlp.experts.down_proj", (E, I, H), "normal"),
                    (p + "mlp.shared_experts.gate_up_proj", (H, 2 * S),
                     "normal"),
                    (p + "mlp.shared_experts.down_proj", (S, H), "normal")]
    out += [("norm.weight", (H,), "one"), ("lm_head", (H, V), "normal")]
    return out


def _f(W: Dict[str, torch.Tensor], name: str, dev) -> torch.Tensor:
    return W[name].to(dev, torch.float32)


def linear(x, w):
    return rnd(x @ w)


def rms_norm(x, w, eps):
    return rnd(w * rnd(x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                                       + eps)))


def rope(x, pos, theta):
    """DeepSeek-V3's RoPE: pairs de-interleaved, rotated by half."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float32) / d)
    ang = pos.float()[:, None] * inv[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    while cos.dim() < x.dim() - 1:   # positions on axis -2 (or -3 for heads)
        cos, sin = cos[:, None], sin[:, None]
    a, b = x[..., 0::2], x[..., 1::2]
    return rnd(torch.cat([a * cos - b * sin, b * cos + a * sin], -1))


def gated(x, gate_up, down):
    g, u = (x @ gate_up).chunk(2, -1)
    return linear(rnd(rnd(F.silu(rnd(g))) * rnd(u)), down)


def attention(x, L: Dict[str, torch.Tensor], c: Dict, keep):
    """Expanded MLA over rows x [R, S, H]; ``keep`` bool[R, S, S]."""
    R, S, _ = x.shape
    nh, r = c["num_attention_heads"], c["kv_lora_rank"]
    nope, rp, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], \
        c["v_head_dim"]
    pos = torch.arange(S, device=x.device)
    q = linear(x, L["q_proj"]).view(R, S, nh, nope + rp)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, c["rope_theta"])],
                  -1)
    kva = linear(x, L["kv_a_proj_with_mqa"])
    ckv = rms_norm(kva[..., :r], L["kv_a_layernorm.weight"],
                   c["rms_norm_eps"])
    kpe = rope(kva[..., r:], pos, c["rope_theta"])
    kv = linear(ckv, L["kv_b_proj"]).view(R, S, nh, nope + vd)
    k = torch.cat([kv[..., :nope], kpe[:, :, None].expand(R, S, nh, rp)], -1)
    v = kv[..., nope:]
    scores = rnd(torch.einsum("rshd,rthd->rhst", q, k)) * (
        1.0 / math.sqrt(nope + rp))
    scores = scores.masked_fill(~keep[:, None], NEG)
    p = rnd(torch.softmax(scores, -1))
    o = rnd(torch.einsum("rhst,rthd->rshd", p, v)).reshape(R, S, nh * vd)
    return linear(o, L["o_proj"])


def experts(x, L: Dict[str, torch.Tensor], c: Dict, forced=None):
    """The routed experts by a loop over the experts, plus the shared
    ones. x [N, H] (normed). ``forced`` i64[N, k'] (optional): the experts
    the program chose for each token, a row of −1 where the reference
    chooses; the weights are the reference's own scores at them. Returns
    (output, route gap f32[N]): |the reference's best k biased scores'
    sum − the biased scores' sum over the distinct experts used| (0 where
    the reference chose)."""
    k = c["num_experts_per_tok"]
    scores = torch.sigmoid(x @ L["gate.weight"])
    biased = scores + L["gate.e_score_correction_bias"]
    best = torch.topk(biased, k, dim=-1)
    sel, gap = best.indices, torch.zeros(x.shape[0], device=x.device)
    if forced is not None:
        forced = forced.to(x.device).long()
        given = forced[:, :1] >= 0
        width = max(k, forced.shape[1])
        pad = lambda s: F.pad(s, (0, width - s.shape[1]), value=-1)
        sel = torch.where(given, pad(forced), pad(sel))
        used = torch.zeros_like(biased).scatter_add_(
            1, sel.clamp_min(0), (sel >= 0).float()) > 0
        gap = torch.where(given[:, 0], (best.values.sum(-1) - torch.where(
            used, biased, 0.0).sum(-1)).abs(), 0.0)
    valid = sel >= 0
    w = torch.where(valid, scores.gather(1, sel.clamp_min(0)), 0.0)
    if c["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = rnd(w * c["routed_scaling_factor"])
    out = torch.zeros_like(x)
    gu, dn = L["experts.gate_up_proj"], L["experts.down_proj"]
    for e in range(c["n_routed_experts"]):
        tok, slot = (sel == e).nonzero(as_tuple=True)
        if len(tok):
            y = gated(x[tok], gu[e], dn[e])
            out.index_add_(0, tok, y * w[tok, slot, None])
    shared = gated(x, L["shared_experts.gate_up_proj"],
                   L["shared_experts.down_proj"])
    return rnd(rnd(out) + shared), gap


def logits(W: Dict[str, torch.Tensor], c: Dict, feats: torch.Tensor,
           frame_mask: torch.Tensor, tokens: torch.Tensor, device,
           bos: int = 1) -> torch.Tensor:
    """f32 logits [R, L, V] at the suffix positions of R rows, the
    reference choosing every token's experts: :func:`forward`'s first."""
    return forward(W, c, feats, frame_mask, tokens, device, bos)[0]


def forward(W: Dict[str, torch.Tensor], c: Dict, feats: torch.Tensor,
            frame_mask: torch.Tensor, tokens: torch.Tensor, device,
            bos: int = 1, routes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f32 logits [R, L, V] at the suffix positions, the route gap f32[R,
    S] of each position, the largest over the layers) of R rows: the
    forward over [frames, <bos>, tokens[:, :L−1]] (S = T + L positions),
    position T + j predicting ``tokens[:, j]``. feats [R, T, D]; frame_mask
    [R, T]; tokens i64[R, L]; ``routes`` (optional): expert layer → the
    program's experts i64[R, S, k'] at each position, −1 where the
    reference chooses (:func:`experts`)."""
    full_f32()
    dev = torch.device(device)
    R, T, _ = feats.shape
    Lx = tokens.shape[1]
    S = T + Lx
    x = rnd(feats.to(dev, torch.float32))
    h = rnd(linear(x, _f(W, "proj_fc1", dev)) + _f(W, "proj_fc1_bias", dev))
    h = rnd(F.gelu(h))
    h = rnd(linear(h, _f(W, "proj_fc2", dev)) + _f(W, "proj_fc2_bias", dev))
    suffix = torch.cat([torch.full((R, 1), bos, dtype=torch.long),
                        tokens[:, :Lx - 1].long().cpu()], 1)
    emb = W["embed_tokens"]
    h = torch.cat([h, emb[suffix.to(emb.device)].to(dev, torch.float32)], 1)
    real = torch.cat([frame_mask.to(dev) > 0,
                      torch.ones(R, Lx, dtype=torch.bool, device=dev)], 1)
    keep = torch.ones(S, S, dtype=torch.bool, device=dev).tril()[None] \
        & real[:, None, :]
    eps = c["rms_norm_eps"]
    gap = torch.zeros(R * S, device=dev)
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}."
        L = {n[len(p):].replace("self_attn.", "").replace("mlp.", ""):
             _f(W, n, dev) for n in W if n.startswith(p)}
        a = rms_norm(h, L["input_layernorm.weight"], eps)
        h = rnd(h + attention(a, L, c, keep))
        m = rms_norm(h, L["post_attention_layernorm.weight"], eps)
        if i < c["first_k_dense_replace"]:
            y = gated(m, L["gate_up_proj"], L["down_proj"])
        else:
            forced = None if routes is None else torch.as_tensor(
                routes[i]).reshape(R * S, -1)
            y, g = experts(m.reshape(R * S, -1), L, c, forced)
            y, gap = y.view(R, S, -1), torch.maximum(gap, g)
        h = rnd(h + y)
        del L
    h = rms_norm(h[:, T:], _f(W, "norm.weight", dev), eps)
    return linear(h, _f(W, "lm_head", dev)), gap.view(R, S)
