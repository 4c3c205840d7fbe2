"""Temporal-attention LSTM caption decoder, in PyTorch.

Mirrors ``vidcap_tpu/models/decoder.py`` parameter for parameter and rounding
point for rounding point, so weights converted from the Flax tree
(convert.py) give the same numbers:

* a dense layer in ``compute_dtype`` rounds its product to that dtype and adds
  its bias in that dtype: ``round(round(x·W) + round(b))``;
* attention: ``q = round(h·Wq)``, ``s = round(tanh(round(keys + q)))``,
  ``scores = Σ_A s·round(u)`` in f32, masked frames at −1e30, f32 softmax
  over frames, ``ctx = Σ_T round(attn)·values`` in f32;
* LSTM: ``gates = round([x; h])·round(W) + b`` with ``b`` in f32, gate order
  i, f, g, o, forget gate ``σ(f + 1)``.

Kernels ("Dense") keep the Flax layout ``[in, out]`` so the converted tree
loads without transposes and the Hopper kernels read the weights as the TPU
kernels did. Every tensor the math touches is float32 holding values rounded
to ``compute_dtype`` where the JAX package rounds; the attention keys and
values are stored in ``compute_dtype`` itself, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from vidcap_tpu_torch.config import ModelConfig
from vidcap_tpu_torch.models import decoding
from vidcap_tpu_torch.ops import teacher_forced as k4
from vidcap_tpu_torch.ops.cell import NEG, attention_beam, lstm_update, rnd
from vidcap_tpu_torch.ops.rollout import counter_uniform


def dtype_of(name: str) -> torch.dtype:
    """Config string → torch dtype ("bfloat16" | "float32")."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


# the counter hash's "step" of each dropout site: [emb; ctx] before the LSTM
# stack, the top h before out_proj
DROPOUT_SITES = (0x44524F30, 0x44524F31)


@dataclasses.dataclass
class Dropout:
    """The training instance's dropout (``model.dropout_rate`` = ``rate``,
    the reference's ``nn.Dropout`` with ``deterministic=False``): a kept
    value becomes ``x / (1 − rate)``, a dropped one 0. Each mask is drawn
    once a forward, [B, width], and reused at every timestep of the decode
    (the reference's scan reuses its mask). A mask bit is K3's counter
    hash of (seed, ``row0`` + row, column, site) (``ops/rollout.py::
    counter_uniform``), kept where the uniform is below 1 − rate: keyed by
    the row's place in the global batch, so that a microbatch and a
    data-parallel rank draw the masks one process draws for the same rows.
    ``seed``: an int or an int64 tensor on the device (a captured step's
    buffer: each replay draws new masks)."""

    rate: float
    seed: object
    row0: int = 0

    def mask(self, rows: int, width: int, site: int, device
             ) -> torch.Tensor:
        """bool[rows, width]: True where the value is kept."""
        return counter_uniform(rows, width, self.seed, DROPOUT_SITES[site],
                               device, self.row0) < 1.0 - self.rate

    def apply(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


@dataclasses.dataclass
class DecoderState:
    """Carried decode state. h/c are per example (``[layers, B, H]``, f32);
    keys/values/frame_mask are per video."""

    h: torch.Tensor           # f32[L, B, H]
    c: torch.Tensor           # f32[L, B, H]
    keys: torch.Tensor        # compute_dtype[B, T, A]
    values: torch.Tensor      # compute_dtype[B, T, H]
    frame_mask: torch.Tensor  # f32[B, T], 1.0 for real frames

    @property
    def device(self) -> torch.device:
        return self.h.device

    def reorder(self, flat_src: torch.Tensor) -> "DecoderState":
        """The beam's reorder of the B·K rows after pruning: row i takes row
        ``flat_src[i]``. Only h and c move: keys/values/frame_mask are per
        video, and a beam never leaves its video's K-row block."""
        return DecoderState(h=self.h[:, flat_src], c=self.c[:, flat_src],
                            keys=self.keys, values=self.values,
                            frame_mask=self.frame_mask)


class Dense(nn.Module):
    """Flax ``nn.Dense(dtype=compute_dtype)``: kernel ``[in, out]``."""

    def __init__(self, in_dim: int, out_dim: int, compute_dtype: torch.dtype,
                 use_bias: bool = True):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        y = rnd(rnd(x, cd) @ rnd(self.kernel, cd), cd)
        if self.bias is not None:
            y = rnd(y + rnd(self.bias, cd), cd)
        return y


class Embed(nn.Module):
    """Flax ``nn.Embed``: table ``embedding [num, features]`` in f32."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, features))
        # the vocab seam (parallel/sharding.py::VocabShard): the table
        # holds this rank's rows and the lookup is vocab-parallel
        self.shard = None

    def forward(self, token: torch.Tensor) -> torch.Tensor:
        if self.shard is not None:
            return self.shard.lookup(self.embedding, token)
        return self.embedding[token]


class LSTMCell(nn.Module):
    """Fused-gate LSTM cell: gates = [x, h] @ w + b, in compute_dtype."""

    def __init__(self, in_dim: int, hidden_dim: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.w = nn.Parameter(torch.zeros(in_dim + hidden_dim, 4 * hidden_dim))
        self.b = nn.Parameter(torch.zeros(4 * hidden_dim))

    def forward(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cd = self.compute_dtype
        xh = rnd(torch.cat([x, h], dim=-1), cd)
        return lstm_update(xh @ rnd(self.w, cd) + self.b, c)


class TemporalAttention(nn.Module):
    """Bahdanau soft attention over frames: ``u · tanh(keys + W_q h)``."""

    def __init__(self, hidden_dim: int, attn_dim: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.query = Dense(hidden_dim, attn_dim, compute_dtype, use_bias=False)
        self.u = nn.Parameter(torch.zeros(attn_dim))

    def forward(self, h: torch.Tensor, keys: torch.Tensor,
                values: torch.Tensor, frame_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """h f32[B, H]; keys/values/frame_mask per row → (ctx f32[B, Dv],
        attn f32[B, T])."""
        cd = self.compute_dtype
        q = self.query(h)
        s = rnd(torch.tanh(rnd(keys.float() + q[:, None, :], cd)), cd)
        scores = torch.einsum("bta,a->bt", s, rnd(self.u, cd))
        scores = torch.where(frame_mask > 0, scores,
                             torch.full_like(scores, NEG))
        attn = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bt,btd->bd", rnd(attn, cd), values.float())
        return ctx, attn

    def beam(self, h_top: torch.Tensor, keys: torch.Tensor,
             values: torch.Tensor, frame_mask: torch.Tensor) -> torch.Tensor:
        """h_top f32[B, K, H]; keys/values/frame_mask per VIDEO → ctx
        f32[B, K, Dv]. The K beams of a video share one keys/values read."""
        return attention_beam(self.query(h_top), keys, values, frame_mask,
                              self.u, self.compute_dtype)


class CaptionDecoder(nn.Module):
    """Embedding + attention + LSTM stack + vocab projection."""

    def __init__(self, cfg: ModelConfig, vocab_size: int, padded_vocab: int,
                 feature_dim: int):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.padded_vocab = padded_vocab
        cd = self.compute_dtype = dtype_of(c.compute_dtype)
        self.embed = Embed(padded_vocab, c.embed_dim)
        self.feat_proj = Dense(feature_dim, c.hidden_dim, cd)
        if c.use_attention:
            # Flax makes key_proj's kernel only where it is called: with
            # attention (a JAX tree without attention has none)
            self.key_proj = Dense(c.hidden_dim, c.attn_dim, cd,
                                  use_bias=False)
        self.init_proj = Dense(c.hidden_dim,
                               2 * c.hidden_dim * c.num_lstm_layers, cd)
        for i in range(c.num_lstm_layers):
            in_dim = c.embed_dim + c.hidden_dim if i == 0 else c.hidden_dim
            self.add_module(f"lstm{i}", LSTMCell(in_dim, c.hidden_dim, cd))
        if c.use_attention:
            self.attention = TemporalAttention(c.hidden_dim, c.attn_dim, cd)
        self.out_proj = Dense(c.hidden_dim, padded_vocab, cd)
        # the vocab seam (parallel/sharding.py::place_state): embed and
        # out_proj hold this rank's share of the vocab
        self.vocab_shard = None

    @property
    def widths(self) -> decoding.Widths:
        """What the route reads of this decoder (``models/decoding.py``)."""
        c = self.cfg
        bf16 = c.compute_dtype == "bfloat16"
        return decoding.Widths(
            lstm=c.num_lstm_layers == 1 and c.use_attention and bf16,
            embed=c.embed_dim, hidden=c.hidden_dim, attn=c.attn_dim,
            vocab=self.padded_vocab, bf16=bf16, int8=True,
            seam=self.vocab_shard is not None)

    @property
    def cells(self):
        return [getattr(self, f"lstm{i}")
                for i in range(self.cfg.num_lstm_layers)]

    # ------------------------------------------------------------------ encoding

    def encode_video(self, feats: torch.Tensor, frame_mask: torch.Tensor
                     ) -> torch.Tensor:
        """Masked-mean-pooled projected features → f32[B, H]."""
        proj = self.feat_proj(feats)
        denom = torch.clamp(frame_mask.sum(-1, keepdim=True), min=1.0)
        return (proj * frame_mask[..., None]).sum(1) / denom

    def init_state(self, feats: torch.Tensor,
                   frame_mask: Optional[torch.Tensor] = None) -> DecoderState:
        B, T, _ = feats.shape
        c = self.cfg
        cd = self.compute_dtype
        if frame_mask is None:
            frame_mask = torch.ones(B, T, device=feats.device)
        frame_mask = frame_mask.float()
        values = self.feat_proj(feats)                             # [B, T, H]
        pooled = self.encode_video(feats, frame_mask)              # f32[B, H]
        hc = rnd(torch.tanh(self.init_proj(pooled)), cd)
        hc = hc.reshape(B, 2, c.num_lstm_layers, c.hidden_dim).permute(1, 2, 0, 3)
        if c.use_attention:
            keys = self.key_proj(values)
        else:
            keys = torch.zeros(B, T, c.attn_dim, device=feats.device)
        return DecoderState(h=hc[0].contiguous(), c=hc[1].contiguous(),
                            keys=keys.to(cd), values=values.to(cd),
                            frame_mask=frame_mask)

    # ------------------------------------------------------------------ stepping

    def _pooled_ctx(self, state: DecoderState) -> torch.Tensor:
        denom = torch.clamp(state.frame_mask.sum(-1, keepdim=True), min=1.0)
        return ((state.values.float() * state.frame_mask[..., None]).sum(1)
                / denom)

    def _lstm_stack(self, state: DecoderState, x: torch.Tensor
                    ) -> Tuple[DecoderState, torch.Tensor]:
        new_h, new_c = [], []
        for i, cell in enumerate(self.cells):
            hi, ci = cell(x, state.h[i], state.c[i])
            new_h.append(hi)
            new_c.append(ci)
            x = hi
        return DecoderState(h=torch.stack(new_h), c=torch.stack(new_c),
                            keys=state.keys, values=state.values,
                            frame_mask=state.frame_mask), x

    def logits(self, h_top: torch.Tensor, sharded: bool = False
               ) -> torch.Tensor:
        """Vocab projection of the top hidden state → f32[N, Vp]; padding
        columns at −1e30. Under the vocab seam each rank projects onto its
        columns; ``sharded`` keeps them (the teacher-forced logits), else
        they are gathered over the model axis (decoding)."""
        shard = self.vocab_shard
        if shard is not None:
            h_top = shard.copy_in(h_top)
        logits = self.out_proj(h_top)
        col = (torch.arange(self.padded_vocab, device=logits.device)
               if shard is None
               else shard.columns(logits.shape[-1], logits.device))
        logits = torch.where(col < self.vocab_size, logits,
                             torch.full_like(logits, NEG))
        if shard is not None and not sharded:
            return shard.gather_columns(logits)
        return logits

    def step(self, state: DecoderState, token: torch.Tensor
             ) -> Tuple[DecoderState, torch.Tensor]:
        """One decode step, per-row attention tensors: token i32[B] →
        (state, logits f32[B, Vp])."""
        return self._step_from_emb(state, self.embed(token))

    def _step_from_emb(self, state: DecoderState, emb: torch.Tensor,
                       dropout: Optional[Dropout] = None, keep=None,
                       sharded: bool = False
                       ) -> Tuple[DecoderState, torch.Tensor]:
        """``dropout`` with its two masks ``keep`` (:meth:`xe_logits`):
        applied to [emb; ctx] and to the top h before the projection; the
        state carries the top h undropped, as the reference's.
        ``sharded``: as :meth:`logits`."""
        if self.cfg.use_attention:
            ctx, _ = self.attention(state.h[-1], state.keys, state.values,
                                    state.frame_mask)
        else:
            ctx = self._pooled_ctx(state)
        x = torch.cat([emb, ctx], dim=-1)
        if dropout is not None:
            x = dropout.apply(x, keep[0])
        state, x = self._lstm_stack(state, x)
        if dropout is not None:
            x = dropout.apply(x, keep[1])
        return state, self.logits(x, sharded)

    def step_beam_hidden(self, state: DecoderState, token: torch.Tensor,
                         beam_width: int) -> Tuple[DecoderState, torch.Tensor]:
        """Beam step with per-VIDEO attention tensors (h/c have B·K rows,
        video-major) → (state, new top-layer hidden f32[B·K, H])."""
        K = beam_width
        B = state.keys.shape[0]
        emb = self.embed(token)
        if self.cfg.use_attention:
            h_top = state.h[-1].reshape(B, K, -1)
            ctx = self.attention.beam(h_top, state.keys, state.values,
                                      state.frame_mask).reshape(B * K, -1)
        else:
            ctx = self._pooled_ctx(state).repeat_interleave(K, dim=0)
        return self._lstm_stack(state, torch.cat([emb, ctx], dim=-1))

    def step_beam(self, state: DecoderState, token: torch.Tensor,
                  beam_width: int) -> Tuple[DecoderState, torch.Tensor]:
        """Like :meth:`step_beam_hidden` but returns logits f32[B·K, Vp]."""
        state, h = self.step_beam_hidden(state, token, beam_width)
        return state, self.logits(h)

    # ------------------------------------------------------------------ XE path

    def xe_logits(self, feats: torch.Tensor,
                  frame_mask: Optional[torch.Tensor], inputs: torch.Tensor,
                  dropout: Optional[Dropout] = None) -> torch.Tensor:
        """Teacher-forced logits: inputs int[B, L] (<bos>-shifted tokens) →
        f32[B, L, Vp]. The embeddings of the whole sequence are gathered
        once, outside the loop over L; differentiable throughout. Where the
        route (``models/decoding.py::route``) says so, the loop and its
        backward run on K4 (ops/teacher_forced.py).
        ``dropout`` (the training instance): its two masks are drawn once
        here and reused at every step. Under the vocab seam the logits are
        this rank's columns, f32[B, L, Vp / model ranks]."""
        state = self.init_state(feats, frame_mask)
        embs = self.embed(inputs.long())                   # [B, L, E]
        if decoding.route(self, None, "teacher_forced", 1, feats.shape[1],
                          feats.device, dropout).recurrent:
            return k4.teacher_forced(
                decoding.KernelWeights(self).teacher_forced(),
                self.vocab_size, state, embs)
        keep = None
        if dropout is not None:
            B, dev, c = inputs.shape[0], feats.device, self.cfg
            keep = (dropout.mask(B, c.embed_dim + c.hidden_dim, 0, dev),
                    dropout.mask(B, c.hidden_dim, 1, dev))
        logits = []
        for t in range(inputs.shape[1]):
            state, lg = self._step_from_emb(state, embs[:, t], dropout, keep,
                                            sharded=True)
            logits.append(lg)
        return torch.stack(logits, dim=1)
