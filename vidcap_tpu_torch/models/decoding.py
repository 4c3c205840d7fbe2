"""Decode strategies of the PyTorch package: greedy, sampled and beam.

Beam search mirrors ``vidcap_tpu/models/decoding.py::beam_decode``
(slot-blocking beams, B×K beams flattened into the batch, state gathered on
h/c only), driven by a step that returns each row's top-K log-probs
directly. On the card that step is :func:`fused_beam_step`: K1 ``beam_core``
then K2 ``topk_project``, with no switch back to the plain versions.

Ties go to the smallest index in the per-row top-K
(:func:`per_row_topk_iterative`, the plain K2's) and in the K·K top-K
(:func:`topk_stable`, one stable sort where the JAX package calls
``lax.top_k``); ``torch.topk`` promises no tie order.

:func:`greedy_decode` and :func:`sample_decode` are the generic loops over a
logits step (``model.step``), as in the JAX package. Serving does not use
them: ``Captioner`` runs greedy and sampled decode through K3
(``ops/rollout.py::model_rollout``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from vidcap_tpu_torch.data.vocab import BOS, EOS, PAD
from vidcap_tpu_torch.models.decoder import NEG, DecoderState
from vidcap_tpu_torch.ops.beam_core import beam_core
from vidcap_tpu_torch.ops.rollout import gumbel_noise
from vidcap_tpu_torch.ops.topk_project import (  # noqa: F401 (re-export)
    per_row_topk_iterative, topk_project)

# step(state, prev_tok i64[B·K]) → (state, logp f32[B·K, K], idx i32[B·K, K])
BeamStep = Callable[[DecoderState, torch.Tensor],
                    Tuple[DecoderState, torch.Tensor, torch.Tensor]]
# step(state, prev_tok i64[B]) → (state, logits f32[B, V])
LogitsStep = Callable[[DecoderState, torch.Tensor],
                      Tuple[DecoderState, torch.Tensor]]


@dataclasses.dataclass
class Rollout:
    """tokens i32[B, L]; logp f32[B, L] (log-prob of the emitted token, 0
    after finish); mask f32[B, L] (1.0 for real tokens incl. the first
    <eos>)."""

    tokens: torch.Tensor
    logp: torch.Tensor
    mask: torch.Tensor


def _rollout(step_fn: LogitsStep, state, batch: int, max_len: int,
             select_fn, early_exit: bool) -> Rollout:
    """Shared greedy/sample loop. ``select_fn(logits, t)`` → (token, logp).
    early_exit=True stops once every row has finished (one host read of the
    flags per step); the steps it skips would only emit PAD with logp 0 and
    mask 0, which the outputs already hold."""
    dev = state.h.device
    toks = torch.zeros(batch, max_len, dtype=torch.int32, device=dev)
    logps = torch.zeros(batch, max_len, device=dev)
    masks = torch.zeros(batch, max_len, device=dev)
    prev = torch.full((batch,), BOS, dtype=torch.long, device=dev)
    finished = torch.zeros(batch, dtype=torch.bool, device=dev)
    for t in range(max_len):
        if early_exit and bool(finished.all()):
            break
        state, logits = step_fn(state, prev)
        tok, logp = select_fn(logits, t)
        tok = torch.where(finished, PAD, tok)
        toks[:, t] = tok
        logps[:, t] = torch.where(finished, 0.0, logp)
        masks[:, t] = (~finished).float()
        finished = finished | (tok == EOS)
        prev = tok
    return Rollout(tokens=toks, logp=logps, mask=masks)


def _picked_logp(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), -1).gather(1, tok[:, None])[:, 0]


def greedy_decode(step_fn: LogitsStep, state, batch: int, max_len: int,
                  early_exit: bool = False, with_logp: bool = True
                  ) -> Rollout:
    """Argmax rollout to <eos>/max_len; ties to the smallest index.
    early_exit=True stops once every row has emitted <eos> (same result).
    with_logp=False skips the log-softmax and returns zeros in ``logp``."""

    def select(logits, t):
        tok = logits.argmax(-1)
        if not with_logp:
            return tok, torch.zeros(tok.shape, device=tok.device)
        return tok, _picked_logp(logits, tok)

    return _rollout(step_fn, state, batch, max_len, select, early_exit)


def sample_decode(step_fn: LogitsStep, state, batch: int, max_len: int,
                  seed: int, temperature: float = 1.0) -> Rollout:
    """Multinomial rollout by Gumbel-max on ``logits · (1/temperature)``,
    with K3's counter-hash noise of (row, column, seed, step)
    (``ops/rollout.py::gumbel_noise``). The JAX package's ``sample_decode``
    draws with ``jax.random.categorical`` (threefry), which PyTorch cannot
    reproduce, so only the distribution is shared with it; with the same
    seed this loop picks what K3 picks. ``logp`` is the log-softmax of the
    scaled logits at the pick."""
    inv_t = 1.0 / temperature

    def select(logits, t):
        scaled = logits.float() * inv_t
        tok = gumbel_noise(scaled, seed, t).argmax(-1)
        return tok, _picked_logp(scaled, tok)

    return _rollout(step_fn, state, batch, max_len, select, early_exit=False)


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the smallest index: one stable
    descending sort, a single launch per beam step on the card."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _lp_factor(length_penalty: float, lengths: torch.Tensor) -> torch.Tensor:
    """GNMT length-normalization factor ((5+len)/6)^lp; 1.0 when lp == 0."""
    lengths = lengths.float()
    if length_penalty == 0.0:
        return torch.ones_like(lengths)
    return ((5.0 + lengths) / 6.0) ** length_penalty


def _make_state_gather(B: int, K: int):
    """Reorder the B·K rows of the recurrent state after beam pruning. Only
    h and c move: keys/values/frame_mask are per video, and a beam never
    leaves its video's K-row block."""
    del B, K

    def gather_state(st: DecoderState, flat_src: torch.Tensor) -> DecoderState:
        return DecoderState(h=st.h[:, flat_src], c=st.c[:, flat_src],
                            keys=st.keys, values=st.values,
                            frame_mask=st.frame_mask)

    return gather_state


def use_finished_pool(decode_cfg) -> bool:
    """The pool runs exactly when slot-blocking could return a different
    winner: under a nonzero length penalty, or when asked for."""
    pool = decode_cfg.finished_pool
    return pool == "on" or (pool == "auto"
                            and decode_cfg.length_penalty != 0.0)


def tile_recurrent(state: DecoderState, beam_width: int) -> DecoderState:
    """Beam-tile only h and c (→ [layers, B·K, H]); attention tensors stay
    per video for the shared-keys beam step."""
    return DecoderState(h=state.h.repeat_interleave(beam_width, dim=1),
                        c=state.c.repeat_interleave(beam_width, dim=1),
                        keys=state.keys, values=state.values,
                        frame_mask=state.frame_mask)


def beam_decode(step_fn: BeamStep, state: DecoderState, batch: int,
                max_len: int, beam_width: int, length_penalty: float = 0.0,
                early_exit: bool = False, return_all: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched slot-blocking beam search. ``state`` has h/c tiled to B·K
    rows (:func:`tile_recurrent`).

    early_exit=True stops once every beam of every video is finished: a
    finished beam only extends with <pad> at zero cost, so the result equals
    the full run. It reads ``finished.all()`` on the host once per step.

    Returns (tokens i32[B, L] best beam, scores f32[B]); with
    ``return_all=True``: (tokens i32[B, K, L], scores f32[B, K]) sorted
    best-first."""
    K, B = beam_width, batch
    dev = state.h.device
    gather_state = _make_state_gather(B, K)
    bidx = torch.arange(B, device=dev)[:, None]
    first_slot = (torch.arange(K, device=dev) == 0)[None, None, :]
    fin_cand = torch.where(first_slot, 0.0, NEG)                  # [1, 1, K]

    alive_seq = torch.zeros(B, K, max_len, dtype=torch.int32, device=dev)
    alive_logp = torch.zeros(B, K, device=dev)
    finished = torch.zeros(B, K, dtype=torch.bool, device=dev)
    prev_tok = torch.full((B * K,), BOS, dtype=torch.long, device=dev)
    for t in range(max_len):
        if early_exit and bool(finished.all()):
            break
        state, logp_k, idx_k = step_fn(state, prev_tok)
        logp_k = logp_k.reshape(B, K, K)
        idx_k = idx_k.reshape(B, K, K)

        # finished beams: the only candidate is PAD at zero cost
        fin = finished[:, :, None]
        logp_k = torch.where(fin, fin_cand, logp_k)
        idx_k = torch.where(fin, torch.full_like(idx_k, PAD), idx_k)

        cand = alive_logp[:, :, None] + logp_k                   # [B, K, K]
        if t == 0:   # all beams are identical: keep beam 0's candidates
            cand[:, 1:] += NEG
        top_logp, top_idx = topk_stable(cand.reshape(B, K * K), K)
        src_beam = top_idx // K
        new_tok = idx_k[bidx, src_beam, top_idx % K]              # [B, K]

        alive_seq = alive_seq[bidx, src_beam]
        alive_seq[:, :, t] = new_tok
        finished = finished[bidx, src_beam] | (new_tok == EOS)
        state = gather_state(state, (bidx * K + src_beam).reshape(B * K))
        prev_tok = new_tok.reshape(B * K).long()
        alive_logp = top_logp

    lengths = (alive_seq != PAD).float().sum(-1)
    scores = alive_logp / _lp_factor(length_penalty, lengths)
    if return_all:
        order = torch.argsort(-scores, dim=-1, stable=True)
        return alive_seq[bidx, order], scores.gather(1, order)
    best = scores.argmax(-1)
    rows = torch.arange(B, device=dev)
    return alive_seq[rows, best], scores[rows, best]


@dataclasses.dataclass
class BeamWeights:
    """The beam step's weights in the kernels' layout, cast once:
    wq [H, A], wg [E+2H, 4H], w_out [H, Vp] in the compute dtype (bf16 on the
    card); u, bg, b_out and the embedding table in f32."""

    embedding: torch.Tensor
    wq: torch.Tensor
    u: torch.Tensor
    wg: torch.Tensor
    bg: torch.Tensor
    w_out: torch.Tensor
    b_out: torch.Tensor
    vocab_size: int

    @classmethod
    def from_model(cls, model) -> "BeamWeights":
        dec = model.decoder
        c = dec.cfg
        if c.num_lstm_layers != 1 or not c.use_attention:
            raise NotImplementedError(
                "the beam step of vidcap_tpu_torch supports only the 1-layer "
                f"attention decoder (got num_lstm_layers={c.num_lstm_layers},"
                f" use_attention={c.use_attention}); other decoders wait for "
                "ROADMAP Queue 1 item 3 ('beam for other decoders')")
        cd = dec.compute_dtype
        if dec.out_proj.kernel.is_cuda and cd != torch.bfloat16:
            raise NotImplementedError(
                "the Hopper beam kernels compute in bf16; "
                "model.compute_dtype=float32 runs only on the CPU (ROADMAP "
                "Queue 1 item 3, 'f32 beam kernels')")
        d = lambda p: p.detach().contiguous()
        return cls(embedding=d(dec.embed.embedding),
                   wq=d(dec.attention.query.kernel.to(cd)),
                   u=d(dec.attention.u), wg=d(dec.lstm0.w.to(cd)),
                   bg=d(dec.lstm0.b), w_out=d(dec.out_proj.kernel.to(cd)),
                   b_out=d(dec.out_proj.bias), vocab_size=dec.vocab_size)


def fused_beam_step(w: BeamWeights, beam_width: int) -> BeamStep:
    """The beam step: embedding gather, K1 ``beam_core`` (attention + LSTM),
    K2 ``topk_project`` (vocab projection + top-K + lse). On CUDA tensors
    both launch their kernels; on CPU tensors they run their plain versions."""
    K = beam_width

    def step(state: DecoderState, tok: torch.Tensor):
        emb = w.embedding[tok]
        h, c = beam_core(emb, state.h[0], state.c[0], state.keys,
                         state.values, state.frame_mask, w.wq, w.u, w.wg,
                         w.bg, K)
        logp, idx = topk_project(h, w.w_out, w.b_out, K, w.vocab_size)
        return (DecoderState(h=h[None], c=c[None], keys=state.keys,
                             values=state.values,
                             frame_mask=state.frame_mask), logp, idx)

    return step
