"""A language-model caption decoder: Kimi-VL-A3B-Instruct's language model
(the DeepSeek-V3 architecture: latent attention and a mixture of experts)
writing the caption after a prefix of frame features.

The clip's T frame features (the pooled IRv2 features the system keeps a
frame) go through a projector (Linear D→hidden, GELU, Linear hidden→hidden)
and stand as prefix tokens at positions 0..T−1; the beam then feeds <bos>
at position T and each caption token after it. Every layer is pre-RMSNorm
attention, then pre-RMSNorm MLP, each added to the residual stream. The
first ``first_k_dense_replace`` layers have a dense SiLU MLP, the rest a
mixture of experts:

* the router runs in f32 on the bf16 input: score σ(x·Wg), selection the
  top ``num_experts_per_tok`` of score + ``e_score_correction_bias``
  (``noaux_tc`` with one group), weights the selected scores normalized
  and scaled by ``routed_scaling_factor``;
* the routed products are grouped GEMMs over the experts
  (``torch._grouped_mm``) between a dispatch, which sorts the tokens'
  (token, expert) pairs by expert and counts each expert's tokens and the
  group ends, and a combine, which sums each token's outputs weighted by
  its weights rounded to bf16, in f32. On the card these run on K5
  (``ops/moe.py``: the dispatch, the activation and the combine, which
  adds the shared experts and the residual too), with the counts and
  offsets computed there, so no step reads a count on the host; off the
  card, or at a shape ``ops/limits.py`` refuses, their plain
  versions (a stable argsort, ``bincount``, which reads the ids' range on
  the host on a card, ``cumsum``, gathers and a batched product);
* the shared experts are one SiLU MLP of width ``n_shared_experts`` ×
  ``moe_intermediate_size``, added unweighted.

Attention (MLA, ``q_lora_rank`` null): q = x·Wq per head [nope; rope]; the
latent [c_kv; k_pe] = x·W_kva, c_kv through ``kv_a_layernorm``, RoPE on the
rope dims of q and of the shared k_pe only (DeepSeek-V3's de-interleaved
pairs); scale 1/√(nope + rope), softmax in f32. The prefill computes the
expanded form over the frames (k_nope and v from c_kv·W_kvb) and keeps the
latents; a decode step computes the absorbed form over them: W_UK folded
into q_nope, scores and the weighted sum over the latents, W_UV after.

The latent cache (:class:`LMState`) is split as the beam needs it: the
prefix latents once a video, read by its K beams; each step's latents in a
per-video pool (position-major, a slot a beam); a lineage table says which
slot holds each beam's latent at each position, so a beam reorder gathers
int32 indices, not latents, and each step masks the pool's columns that
are not in the row's lineage.

Arithmetic: parameters and activations in bf16; a product accumulates in
f32 and rounds to bf16; norms, RoPE, the router and attention's softmax
compute in f32 and round to bf16 where the value goes on. ``references/kimi_vl_lm.py`` is the same model without a
cache, batching or grouped products.

Tracing (``utils/profiling.py``): the spans ``lm.prefill`` and ``lm.step``
(``id`` the step), the phase marks ``vidcap_phase_lm_{attn,mlp,moe,head}``
at each layer's boundaries, launched while tracing is on, and the counter
``lm.expert_tokens`` (tokens an expert, ``id`` the layer), kept while
tracing is on.
"""
from __future__ import annotations

import dataclasses
import math
import types
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vidcap_tpu_torch.models.decoding import (VocabProjection, Widths,
                                              moe_kernels)
from vidcap_tpu_torch.ops import moe as k5
from vidcap_tpu_torch.utils import profiling

NEG = -1e30
BF16 = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class LMDecoderConfig:
    """The language model's numbers under the keys of its ``config.json``,
    and the prefix: ``feature_dim`` per frame, ``num_frames`` frames."""

    vocab_size: int = 163_840
    hidden_size: int = 2_048
    intermediate_size: int = 11_264
    moe_intermediate_size: int = 1_408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    qk_nope_head_dim: int = 128
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800_000.0
    feature_dim: int = 1_536
    num_frames: int = 26

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    def validate(self) -> "LMDecoderConfig":
        """Raise for the variants of the architecture this decoder does not
        compute."""
        if self.q_lora_rank is not None:
            raise NotImplementedError("q_lora_rank: only a direct q "
                                      "projection (null) is computed")
        if (self.topk_method, self.scoring_func, self.n_group,
                self.topk_group) != ("noaux_tc", "sigmoid", 1, 1):
            raise NotImplementedError(
                "routing: only noaux_tc selection of sigmoid scores in one "
                "group is computed")
        return self


# Kimi-VL-A3B-Instruct's language model (huggingface.co/moonshotai/
# Kimi-VL-A3B-Instruct, config.json text_config), after a 26-frame prefix
# of 1536-wide pooled IRv2 features
KIMI_VL_A3B = LMDecoderConfig()


# ------------------------------------------------------------- arithmetic

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """x / rms(x) in f32, rounded to x's dtype, times the weight."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return weight * y.to(x.dtype)


def rope_tables(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin f32[P, dim/2] of the positions (no scaling)."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=positions.device,
                                       dtype=torch.float32) / dim)
    ang = positions.float()[:, None] * inv[None]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """DeepSeek-V3's RoPE on the last axis: the interleaved pairs
    (x0, x1), (x2, x3), ... de-interleaved to [evens; odds], then rotated
    by half, in f32, rounded to x's dtype. ``cos``/``sin`` broadcast
    against x's last axis halved."""
    xf = x.float()
    a, b = xf[..., 0::2], xf[..., 1::2]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1).to(x.dtype)


def silu_mul(gate_up: torch.Tensor) -> torch.Tensor:
    """bf16(bf16(silu(gate)) · up) of [gate | up] on the last axis (each
    op computes in f32 and rounds to the inputs' dtype): on K5's kernel
    where ``moe_kernels`` takes the input's device and width, else its plain
    version (``ops/moe.py``)."""
    if "silu_mul" in moe_kernels(gate_up.device, gate_up.shape[-1] // 2):
        return k5.silu_mul(gate_up)
    return k5.silu_mul_plain(gate_up)


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor
               ) -> torch.Tensor:
    """x bf16[S, in] (rows sorted by group), w bf16[G, in, out], offs
    int32[G] (each group's end row, on x's device) → bf16[S, out]: group
    g's rows times w[g], f32 accumulation."""
    return torch._grouped_mm(x, w, offs=offs)


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=BF16, device=device),
                        requires_grad=False)


# ------------------------------------------------------------------ state

@dataclasses.dataclass
class LMState:
    """The beam's latent cache. ``cache`` bf16[layers, B, T + L·K, r + rope]:
    per video the T prefix latents, then position-major the pool of each
    step's latents, beam slot k of step j at column T + j·K + k.
    ``lineage`` int32[B, K, L]: row (b, k)'s latent at step j lies in slot
    ``lineage[b, k, j]``. ``frame_mask`` f32[B, T]; ``t`` steps taken."""

    cache: torch.Tensor
    frame_mask: torch.Tensor
    lineage: torch.Tensor
    t: int = 0

    @property
    def device(self) -> torch.device:
        return self.cache.device

    @property
    def beam(self) -> int:
        return self.lineage.shape[1]

    def reorder(self, flat_src: torch.Tensor) -> "LMState":
        """Row i takes row ``flat_src[i]``'s lineage (a beam never leaves
        its video's block): int32 indices move, latents stay."""
        B, K, L = self.lineage.shape
        return dataclasses.replace(
            self, lineage=self.lineage.view(B * K, L)[flat_src].view(B, K, L))

    def attn_bias(self) -> torch.Tensor:
        """f32[B, K, 1, T + (t+1)·K] of the current step: 0 on real frames
        and on the pool's columns in the row's lineage, −1e30 elsewhere."""
        B, K, _ = self.lineage.shape
        t = self.t
        slots = torch.arange(K, device=self.device, dtype=torch.int32)
        own = (self.lineage[:, :, :t + 1, None] == slots).reshape(
            B, K, (t + 1) * K)
        pre = (self.frame_mask > 0)[:, None, :].expand(B, K, -1)
        valid = torch.cat([pre, own], -1)
        zero = torch.zeros((), device=self.device)
        return torch.where(valid, zero, NEG)[:, :, None, :]


# ---------------------------------------------------------------- modules

class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = _param(dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class MLA(nn.Module):
    """Multi-head latent attention with a direct q projection. Weights are
    [in, out]; kv_b_proj's columns are, head by head, [k_nope; v]."""

    def __init__(self, cfg: LMDecoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        nh, H = cfg.num_attention_heads, cfg.hidden_size
        self.q_proj = _param(H, nh * cfg.qk_head_dim, device=device)
        self.kv_a_proj_with_mqa = _param(H, cfg.latent_dim, device=device)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps,
                                      device)
        self.kv_b_proj = _param(cfg.kv_lora_rank,
                                nh * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                                device=device)
        self.o_proj = _param(nh * cfg.v_head_dim, H, device=device)
        self.scale = 1.0 / math.sqrt(cfg.qk_head_dim)
        self._absorbed = None

    def _split_q(self, x, cos, sin):
        """q_nope, roped q_pe [..., nh, ·] of normed x [..., H]."""
        c = self.cfg
        q = (x @ self.q_proj).unflatten(-1, (c.num_attention_heads,
                                             c.qk_head_dim))
        q_nope, q_pe = q.split([c.qk_nope_head_dim, c.qk_rope_head_dim], -1)
        return q_nope, apply_rope(q_pe, cos[..., None, :], sin[..., None, :])

    def latents(self, x, cos, sin) -> torch.Tensor:
        """[c_kv (normed); k_pe (roped)] bf16[..., r + rope] of normed x."""
        r = self.cfg.kv_lora_rank
        kva = x @ self.kv_a_proj_with_mqa
        return torch.cat([self.kv_a_layernorm(kva[..., :r]),
                          apply_rope(kva[..., r:], cos, sin)], -1)

    def prefill(self, x, cos, sin, frame_mask):
        """The expanded form over the frames. x bf16[B, T, H]; cos/sin
        [T, rope/2] → (output bf16[B, T, H], latents bf16[B, T, r + rope]).
        Causal over the frames; masked frames are no keys."""
        c = self.cfg
        B, T, _ = x.shape
        nh, r = c.num_attention_heads, c.kv_lora_rank
        q_nope, q_pe = self._split_q(x, cos, sin)
        lat = self.latents(x, cos, sin)
        kv = (lat[..., :r] @ self.kv_b_proj).unflatten(
            -1, (nh, c.qk_nope_head_dim + c.v_head_dim))
        k_nope, v = kv.split([c.qk_nope_head_dim, c.v_head_dim], -1)
        k_pe = lat[..., None, r:].expand(B, T, nh, c.qk_rope_head_dim)
        q = torch.cat([q_nope, q_pe], -1).transpose(1, 2)    # [B, nh, T, d]
        k = torch.cat([k_nope, k_pe], -1).transpose(1, 2)
        scores = (q @ k.transpose(-1, -2)).float() * self.scale
        causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        keep = causal[None, None] & (frame_mask > 0)[:, None, None, :]
        p = torch.softmax(scores.masked_fill(~keep, NEG), -1).to(x.dtype)
        o = (p @ v.transpose(1, 2)).transpose(1, 2).reshape(B, T, -1)
        return o @ self.o_proj, lat

    def absorbed_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(W_UK bf16[nh, nope, r], W_UV bf16[nh, r, v]) from kv_b_proj,
        laid out once for the decode's batched products."""
        if self._absorbed is None:
            c = self.cfg
            w = self.kv_b_proj.unflatten(
                1, (c.num_attention_heads,
                    c.qk_nope_head_dim + c.v_head_dim))     # [r, nh, n+v]
            wuk = w[:, :, :c.qk_nope_head_dim].permute(1, 2, 0).contiguous()
            wuv = w[:, :, c.qk_nope_head_dim:].permute(1, 0, 2).contiguous()
            self._absorbed = (wuk, wuv)
        return self._absorbed

    def decode(self, x, cos, sin, cache, bias, t: int):
        """One step of the absorbed form for the B·K rows. x bf16[B·K, H];
        ``cache`` this layer's bf16[B, T + L·K, r + rope], into which the
        rows' latents go at step ``t``; ``bias`` f32[B, K, 1, C] over its
        first C columns (:meth:`LMState.attn_bias`)."""
        c = self.cfg
        nh, r = c.num_attention_heads, c.kv_lora_rank
        N = x.shape[0]
        B, K, C = bias.shape[0], bias.shape[1], bias.shape[-1]
        T = C - (t + 1) * K
        q_nope, q_pe = self._split_q(x, cos, sin)             # [N, nh, ·]
        cache[:, T + t * K:C] = self.latents(x, cos, sin).view(B, K, -1)
        wuk, wuv = self.absorbed_weights()
        q_lat = (q_nope.transpose(0, 1) @ wuk).transpose(0, 1)  # [N, nh, r]
        q = torch.cat([q_lat, q_pe], -1).reshape(B, K * nh, -1)
        ctx = cache[:, :C]                                     # [B, C, r+p]
        scores = (q @ ctx.transpose(1, 2)).float() * self.scale
        scores = scores.view(B, K, nh, C) + bias
        p = torch.softmax(scores, -1).to(x.dtype).view(B, K * nh, C)
        o_lat = (p @ ctx[..., :r]).view(N, nh, r)
        o = (o_lat.transpose(0, 1) @ wuv).transpose(0, 1).reshape(N, -1)
        return o @ self.o_proj


class DenseMLP(nn.Module):
    """SiLU MLP: [gate | up] in one product, then down."""

    def __init__(self, hidden: int, inter: int, device=None):
        super().__init__()
        self.gate_up_proj = _param(hidden, 2 * inter, device=device)
        self.down_proj = _param(inter, hidden, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return silu_mul(x @ self.gate_up_proj) @ self.down_proj


class Experts(nn.Module):
    """The routed experts' weights, stacked: [E, in, out]."""

    def __init__(self, E: int, hidden: int, inter: int, device=None):
        super().__init__()
        self.gate_up_proj = _param(E, hidden, 2 * inter, device=device)
        self.down_proj = _param(E, inter, hidden, device=device)


class Router(nn.Module):
    def __init__(self, cfg: LMDecoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.weight = _param(cfg.hidden_size, cfg.n_routed_experts,
                             device=device)
        self.e_score_correction_bias = nn.Parameter(
            torch.empty(cfg.n_routed_experts, device=device),
            requires_grad=False)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x bf16[N, H] → (experts i64[N, k], weights f32[N, k])."""
        c = self.cfg
        scores = torch.sigmoid(x.float() @ self.weight.float())
        sel = torch.topk(scores + self.e_score_correction_bias,
                         c.num_experts_per_tok, dim=-1).indices
        w = scores.gather(1, sel)
        if c.norm_topk_prob:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return sel, w * c.routed_scaling_factor


class MoE(nn.Module):
    def __init__(self, cfg: LMDecoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, I = cfg.hidden_size, cfg.moe_intermediate_size
        self.gate = Router(cfg, device)
        self.experts = Experts(cfg.n_routed_experts, H, I, device)
        self.shared_experts = DenseMLP(H, cfg.n_shared_experts * I, device)

    def forward(self, x: torch.Tensor, layer: int,
                h: torch.Tensor) -> torch.Tensor:
        """x bf16[N, H] (normed), the residual h bf16[N, H] → h plus the
        routed experts' weighted sum, rounded, plus the shared experts'.
        Where ``moe_kernels`` takes the call (the card, the shape), the
        dispatch and the combine run on K5 and nothing is read on the host;
        else their plain versions. The experts a token are the
        configuration's at the call."""
        H = x.shape[1]
        c = self.cfg
        k, E = c.num_experts_per_tok, c.n_routed_experts
        sel, w = self.gate(x)
        on_k5 = "moe_dispatch" in moe_kernels(
            x.device, c.moe_intermediate_size, (k, E, H))
        dispatch, combine = ((k5.moe_dispatch, k5.moe_combine) if on_k5
                             else (k5.moe_dispatch_plain,
                                   k5.moe_combine_plain))
        d = dispatch(sel, x, E)
        profiling.count("lm.expert_tokens", layer, d.counts)
        ex = self.experts
        y = grouped_mm(silu_mul(grouped_mm(d.x, ex.gate_up_proj, d.offs)),
                       ex.down_proj, d.offs)
        return combine(y, d, w, self.shared_experts(x), h)


class LMLayer(nn.Module):
    def __init__(self, cfg: LMDecoderConfig, index: int, device=None):
        super().__init__()
        self.index = index
        H = cfg.hidden_size
        self.input_layernorm = RMSNorm(H, cfg.rms_norm_eps, device)
        self.self_attn = MLA(cfg, device)
        self.post_attention_layernorm = RMSNorm(H, cfg.rms_norm_eps, device)
        self.dense = index < cfg.first_k_dense_replace
        self.mlp = (DenseMLP(H, cfg.intermediate_size, device) if self.dense
                    else MoE(cfg, device))

    def mlp_part(self, h: torch.Tensor) -> torch.Tensor:
        """h + MLP(norm(h)) over the last axis of any leading shape."""
        _mark("lm_mlp" if self.dense else "lm_moe", h)
        x = self.post_attention_layernorm(h)
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        if self.dense:
            return h + self.mlp(x).view(shape)
        return self.mlp(x, self.index, h.reshape(x.shape)).view(shape)


def _mark(name: str, like: torch.Tensor) -> None:
    """The phase mark ``vidcap_phase_<name>``, while tracing is on."""
    if profiling.tracing():
        profiling.phase(name, like)


class LMCaptionModel(nn.Module):
    """The projector, the embedding, the layers, the final norm and the
    untied head (``lm_head`` [H, V], K2's layout). Parameters are bf16 and
    need no gradient: the model decodes, by beam only (greedy is the beam
    of one), through the beam surface ``models/model.py::VidCapModel``
    has too."""

    beam_only = True
    feature_dtype = compute_dtype = BF16

    def __init__(self, cfg: LMDecoderConfig = KIMI_VL_A3B, device=None):
        super().__init__()
        self.cfg = cfg.validate()
        H, D = cfg.hidden_size, cfg.feature_dim
        self.proj_fc1 = _param(D, H, device=device)
        self.proj_fc1_bias = _param(H, device=device)
        self.proj_fc2 = _param(H, H, device=device)
        self.proj_fc2_bias = _param(H, device=device)
        self.embed_tokens = _param(cfg.vocab_size, H, device=device)
        self.layers = nn.ModuleList(LMLayer(cfg, i, device)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(H, cfg.rms_norm_eps, device)
        self.lm_head = _param(H, cfg.vocab_size, device=device)

    @property
    def vocab_size(self) -> int:
        return self.cfg.vocab_size

    def project(self, feats: torch.Tensor) -> torch.Tensor:
        """Frame features [B, T, D] → prefix tokens bf16[B, T, H]."""
        x = (feats.to(BF16) @ self.proj_fc1) + self.proj_fc1_bias
        x = F.gelu(x.float()).to(BF16)
        return (x @ self.proj_fc2) + self.proj_fc2_bias

    @torch.no_grad()
    def init_beam(self, feats: torch.Tensor, frame_mask: torch.Tensor,
                  beam_width: int, max_len: int) -> LMState:
        """The prefill: the frames through every layer in the expanded
        form, their latents into a new cache sized for ``max_len`` steps
        of ``beam_width`` beams a video."""
        c = self.cfg
        B, T, _ = feats.shape
        dev = feats.device
        mask = frame_mask.float()
        cache = torch.zeros(c.num_hidden_layers, B, T + max_len * beam_width,
                            c.latent_dim, dtype=BF16, device=dev)
        with profiling.annotate("lm.prefill"):
            cos, sin = rope_tables(torch.arange(T, device=dev),
                                   c.qk_rope_head_dim, c.rope_theta)
            h = self.project(feats)
            for i, layer in enumerate(self.layers):
                _mark("lm_attn", h)
                o, lat = layer.self_attn.prefill(
                    layer.input_layernorm(h), cos, sin, mask)
                cache[i, :, :T] = lat
                h = layer.mlp_part(h + o)
        lineage = torch.zeros(B, beam_width, max_len, dtype=torch.int32,
                              device=dev)
        return LMState(cache=cache, frame_mask=mask, lineage=lineage)

    @torch.no_grad()
    def step_hidden(self, state: LMState, tok: torch.Tensor
                    ) -> Tuple[LMState, torch.Tensor]:
        """Feed token ``tok`` i64[B·K] at step ``state.t`` (position
        T + t) → (the state after it, the final norm's output f32[B·K, H])."""
        c = self.cfg
        t, K = state.t, state.beam
        T = state.frame_mask.shape[1]
        with profiling.annotate("lm.step", t):
            state.lineage[:, :, t] = torch.arange(
                K, dtype=torch.int32, device=state.device)
            bias = state.attn_bias()
            cos, sin = rope_tables(torch.tensor([T + t], device=state.device),
                                   c.qk_rope_head_dim, c.rope_theta)
            h = self.embed_tokens[tok]
            for i, layer in enumerate(self.layers):
                _mark("lm_attn", h)
                h = h + layer.self_attn.decode(
                    layer.input_layernorm(h), cos, sin, state.cache[i],
                    bias, t)
                h = layer.mlp_part(h)
            _mark("lm_head", h)
            out = self.norm(h).float()
        return dataclasses.replace(state, t=t + 1), out


    @property
    def decoder(self) -> "LMCaptionModel":
        """What the route and the kernels' weights read
        (``models/decoding.py``): the model itself."""
        return self

    @property
    def widths(self) -> Widths:
        """No recurrent kernel; K2 where it takes the head's hidden width
        and vocab (the int8 projection is the LSTM decoder's alone); K5
        for the MLPs its layers have: the dense layers', the shared
        experts' and the routed experts'."""
        c = self.cfg
        I = c.moe_intermediate_size
        mlps = ((c.intermediate_size, None),) \
            if min(c.first_k_dense_replace, c.num_hidden_layers) > 0 else ()
        if c.num_hidden_layers > c.first_k_dense_replace:
            mlps += ((c.n_shared_experts * I, None),
                     (I, (c.num_experts_per_tok, c.n_routed_experts)))
        return Widths(lstm=False, embed=c.hidden_size, hidden=c.hidden_size,
                      attn=0, vocab=c.vocab_size, bf16=True, int8=False,
                      seam=False, mlps=mlps)

    @property
    def out_proj(self):
        """The head as the beam's projection weights: ``lm_head`` bf16[H,
        V], no bias."""
        return types.SimpleNamespace(kernel=self.lm_head, bias=None)

    def beam_step(self, proj: VocabProjection, beam_width: int,
                  candidates: int):
        return lm_beam_step(self, proj, candidates)


def create_lm_model(cfg: LMDecoderConfig = KIMI_VL_A3B, device=None
                    ) -> LMCaptionModel:
    """The model with uninitialized parameters (``device="meta"``: none
    allocated, for :func:`load_lm_weights` to share a caller's tensors)."""
    return LMCaptionModel(cfg, device=device)


@torch.no_grad()
def init_lm_params(model: LMCaptionModel, seed: int = 0,
                   std: float = 0.02) -> LMCaptionModel:
    """DeepSeek-V3's initializer from a seed: weights N(0, ``std``), norms
    one, biases and the score correction zero."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("norm.weight"):
            p.fill_(1.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=gen) * std)
    return model


@torch.no_grad()
def load_lm_weights(model: LMCaptionModel, tensors, share: bool = True
                    ) -> LMCaptionModel:
    """Set every parameter from ``tensors`` (name → tensor, the same set of
    names and shapes); ``share``: the parameter becomes the caller's tensor
    (cast to its dtype where that differs), so that a 32 GB model is not
    held twice."""
    params = dict(model.named_parameters())
    if set(params) != set(tensors):
        raise ValueError(
            "weights do not match the model: missing "
            f"{sorted(set(params) - set(tensors))[:5]}, extra "
            f"{sorted(set(tensors) - set(params))[:5]}")
    mods = dict(model.named_modules())
    for name, p in params.items():
        t = tensors[name]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: model {tuple(p.shape)}, given "
                             f"{tuple(t.shape)}")
        if share:
            mod, attr = name.rpartition(".")[::2]
            setattr(mods[mod], attr, nn.Parameter(t.to(p.dtype),
                                                  requires_grad=False))
        else:
            p.copy_(t)
    for m in model.modules():
        if isinstance(m, MLA):
            m._absorbed = None
    return model


# ------------------------------------------------------------- beam step

def lm_beam_step(model: LMCaptionModel, proj, candidates: int):
    """The beam step (``models/decoding.py::BeamStep``): the cached
    decode step, then the head's top-``candidates`` log-probs a row."""

    def step(state: LMState, tok: torch.Tensor):
        state, h = model.step_hidden(state, tok)
        logp, idx = proj.topk(h, candidates)
        return state, logp, idx

    return step
