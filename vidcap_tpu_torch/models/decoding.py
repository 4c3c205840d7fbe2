"""Decode strategies of the PyTorch package: greedy, sampled and beam.

Beam search mirrors ``vidcap_tpu/models/decoding.py``: :func:`beam_decode`
(slot-blocking beams, B×K beams flattened into the batch, the state's own
``reorder`` after pruning: h/c only for the LSTM) and
:func:`beam_decode_pool` (the finished-hypothesis pool), driven by a step
that returns each row's top-n log-probs directly (n = K for slot-blocking,
K+1 for the pool). :func:`kernel_decoder` and
:func:`projection_kernel` are the one place that decides, from the
configuration and the shape (ops/limits.py), which step that is. For the
one-layer bf16 attention decoder at a beam width K1 takes it is
:func:`fused_beam_step`: K1 ``beam_core`` then K2 ``topk_project`` (or K2's
int8 variant) where it takes the candidates and widths, with no switch back
to the plain versions. For every other decoder or shape it is
:func:`module_beam_step`: the recurrent step through the model's own
modules, as the JAX package runs such decoders through XLA, then the same
projection kernels wherever one computes the logits
(:class:`VocabProjection`; none where the kernel refuses the shape).

Ties go to the smallest index in the per-row top-K
(:func:`per_row_topk_iterative`, the plain K2's) and in the K·K top-K
(:func:`topk_stable`, one stable sort where the JAX package calls
``lax.top_k``); ``torch.topk`` promises no tie order.

:func:`greedy_decode` and :func:`sample_decode` are the generic loops over a
logits step (``model.step``), as in the JAX package. Serving does not use
them for the decoder K3 runs: ``Captioner`` runs its greedy and sampled
decode through K3 (``ops/rollout.py::model_rollout``), and every other
decoder's through these loops over ``CaptionDecoder.step``.

With early exit, each loop reads its finish test on the host once a step,
inside a ``beam.exit_check`` span (``utils/profiling.py``; ``id`` the
step): the count of those spans is the count of host reads.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from vidcap_tpu_torch.data.vocab import BOS, EOS, PAD
from vidcap_tpu_torch.models.decoder import NEG, DecoderState
from vidcap_tpu_torch.ops.beam_core import beam_core
from vidcap_tpu_torch.ops.int8_proj import (Int8Projection,
                                            int8_topk_project_plain,
                                            topk_project_int8)
from vidcap_tpu_torch.ops.limits import (H100_SMEM, H100_SMS,
                                         beam_core_takes, rollout_takes,
                                         teacher_forced_takes,
                                         topk_project_int8_takes,
                                         topk_project_takes)
from vidcap_tpu_torch.ops.rollout import device_limits, gumbel_noise
from vidcap_tpu_torch.ops.topk_project import (  # noqa: F401 (re-export)
    MAX_K, logits_topk, masked_logits, per_row_topk_iterative, topk_project)
from vidcap_tpu_torch.utils import profiling

# step(state, prev_tok i64[B·K]) → (state, logp f32[B·K, n], idx i32[B·K, n])
# with n = K (beam_decode) or K + 1 (beam_decode_pool) candidates a row
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
        if early_exit and _exit_check(finished.all(), t):
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


def _exit_check(flag: torch.Tensor, t: int) -> bool:
    """The decode loops' one host read a step, of the device flag of their
    finish test at step ``t``, in a ``beam.exit_check`` span."""
    with profiling.annotate("beam.exit_check", t):
        return bool(flag)


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
                  seed, temperature: float = 1.0, row0: int = 0) -> Rollout:
    """Multinomial rollout by Gumbel-max on ``logits · (1/temperature)``,
    with K3's counter-hash noise of (row, column, seed, step)
    (``ops/rollout.py::gumbel_noise``). ``seed``: an int or an int64 tensor
    on the state's device, read there (no host read: a captured step keeps
    its seed in a device buffer). The JAX package's ``sample_decode``
    draws with ``jax.random.categorical`` (threefry), which PyTorch cannot
    reproduce, so only the distribution is shared with it; with the same
    seed this loop picks what K3 picks. ``logp`` is the log-softmax of the
    scaled logits at the pick. ``row0``: the hash's row of the first row (a
    data-parallel rank's offset in the global batch)."""
    inv_t = 1.0 / temperature

    def select(logits, t):
        scaled = logits.float() * inv_t
        tok = gumbel_noise(scaled, seed, t, row0).argmax(-1)
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
    rows (:func:`tile_recurrent`), or is another decoder's beam state
    (``models/lm_decoder.py::LMState``); after pruning, the state's own
    ``reorder`` takes the surviving rows.

    early_exit=True stops once every beam of every video is finished: a
    finished beam only extends with <pad> at zero cost, so the result equals
    the full run. It reads ``finished.all()`` on the host once per step.

    Returns (tokens i32[B, L] best beam, scores f32[B]); with
    ``return_all=True``: (tokens i32[B, K, L], scores f32[B, K]) sorted
    best-first."""
    K, B = beam_width, batch
    dev = state.device
    bidx = torch.arange(B, device=dev)[:, None]
    first_slot = (torch.arange(K, device=dev) == 0)[None, None, :]
    fin_cand = torch.where(first_slot, 0.0, NEG)                  # [1, 1, K]

    alive_seq = torch.zeros(B, K, max_len, dtype=torch.int32, device=dev)
    alive_logp = torch.zeros(B, K, device=dev)
    finished = torch.zeros(B, K, dtype=torch.bool, device=dev)
    prev_tok = torch.full((B * K,), BOS, dtype=torch.long, device=dev)
    for t in range(max_len):
        if early_exit and _exit_check(finished.all(), t):
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
        state = state.reorder((bidx * K + src_beam).reshape(B * K))
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


def beam_decode_pool(step_fn: BeamStep, state: DecoderState, batch: int,
                     max_len: int, beam_width: int,
                     length_penalty: float = 0.0, early_exit: bool = False,
                     return_all: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search with a finished-hypothesis pool
    (``vidcap_tpu/models/decoding.py::beam_decode_pool``). ``step_fn``
    returns each row's top-(K+1) candidates; ``state`` has h/c tiled to B·K
    rows (:func:`tile_recurrent`), or is another decoder's beam state, as
    :func:`beam_decode` takes it.

    A hypothesis whose <eos> ranks within its row's top K+1 moves, scored
    at its finish length, into a fixed [B, K] pool of the best finished
    ones; all K alive slots keep the best K non-<eos> continuations. The
    merges keep the lower index on a tie (:func:`topk_stable`), the pool's
    block first. early_exit=True stops once no alive beam can still beat
    the pool's K-th score even at the most favourable length factor (one
    host read of that test a step); the result equals the full run.

    Returns (tokens i32[B, L] best overall, scores f32[B]); with
    ``return_all=True``: (tokens i32[B, K, L], scores f32[B, K]), the K
    best of the pool and the alive beams (normalized at max_len), best
    first, a finished one ahead of an alive one on an exact tie."""
    K, B, C = beam_width, batch, beam_width + 1
    dev = state.device
    bidx = torch.arange(B, device=dev)[:, None]
    # the length factor of every finish length 1..max_len, on the device
    factors = _lp_factor(length_penalty,
                         torch.arange(1, max_len + 1, device=dev))
    best_factor = factors.max()

    alive_seq = torch.zeros(B, K, max_len, dtype=torch.int32, device=dev)
    alive_logp = torch.zeros(B, K, device=dev)
    fin_seq = torch.zeros(B, K, max_len, dtype=torch.int32, device=dev)
    fin_logp = torch.full((B, K), NEG, device=dev)
    prev_tok = torch.full((B * K,), BOS, dtype=torch.long, device=dev)
    for t in range(max_len):
        if early_exit:
            # an alive beam's raw logp only falls and is ≤ 0, so its best
            # reachable score divides by the largest factor
            best_possible = alive_logp.max(-1).values / best_factor
            if not _exit_check(
                    (best_possible > fin_logp.min(-1).values).any(), t):
                break
        state, logp_k, idx_k = step_fn(state, prev_tok)
        logp_k = logp_k.reshape(B, K, C)
        idx_k = idx_k.reshape(B, K, C)
        cand = alive_logp[:, :, None] + logp_k                   # [B, K, C]
        if t == 0:   # all beams are identical: keep beam 0's candidates
            cand[:, 1:] += NEG
        is_eos = idx_k == EOS

        # the pool: <eos> candidates scored at finish length t+1, merged
        # with the pool's K, the pool's block first
        eos_scores = torch.where(is_eos, cand / factors[t],
                                 torch.full_like(cand, NEG))
        eos_seq = alive_seq[:, :, None, :].expand(B, K, C, max_len).reshape(
            B, K * C, max_len).clone()
        eos_seq[:, :, t] = EOS
        fin_logp, fin_src = topk_stable(
            torch.cat([fin_logp, eos_scores.reshape(B, K * C)], 1), K)
        fin_seq = torch.cat([fin_seq, eos_seq], 1).gather(
            1, fin_src[:, :, None].expand(B, K, max_len))

        # alive: the best K non-<eos> candidates keep exploring
        live = torch.where(is_eos, torch.full_like(cand, NEG), cand)
        top_logp, top_idx = topk_stable(live.reshape(B, K * C), K)
        src_beam = top_idx // C
        new_tok = idx_k[bidx, src_beam, top_idx % C]              # [B, K]
        alive_seq = alive_seq[bidx, src_beam]
        alive_seq[:, :, t] = new_tok
        state = state.reorder((bidx * K + src_beam).reshape(B * K))
        prev_tok = new_tok.reshape(B * K).long()
        alive_logp = top_logp

    # alive sequences have no <eos>: normalized at full length
    alive_norm = alive_logp / factors[max_len - 1]
    if return_all:
        top, idx = topk_stable(torch.cat([fin_logp, alive_norm], 1), K)
        seqs = torch.cat([fin_seq, alive_seq], 1)
        return seqs.gather(1, idx[:, :, None].expand(B, K, max_len)), top
    rows = torch.arange(B, device=dev)
    best_fin = fin_logp.argmax(-1)
    best_alive = alive_norm.argmax(-1)
    fin_best, alive_best = fin_logp[rows, best_fin], alive_norm[rows, best_alive]
    use_fin = fin_best >= alive_best
    toks = torch.where(use_fin[:, None], fin_seq[rows, best_fin],
                       alive_seq[rows, best_alive])
    return toks, torch.where(use_fin, fin_best, alive_best)


def kernel_decoder(model_cfg, method: Optional[str] = None,
                   beam_width: int = 1, frames: int = 1,
                   padded_vocab: Optional[int] = None, device=None) -> bool:
    """True for the decoder the kernels compute, one LSTM layer with
    attention in bf16 (``model_cfg``: the ``model`` section), and, given a
    ``method``, when its recurrent kernel takes the shape (ops/limits.py):
    K1 ``beam_width`` beams for "beam", K3 over ``frames`` frames and the
    ``padded_vocab`` on ``device``'s SMs and shared memory (the H100's off
    the card) for "greedy" and "sample", K4 over ``frames`` frames and the
    ``padded_vocab`` for "teacher_forced" (``CaptionDecoder.xe_logits``).
    K1–K4 run such a decoder on the card with no switch back. Every other
    configuration, and every shape a kernel refuses, decodes through the
    model's own modules on the caller's device, where the JAX package
    takes its XLA path (its Pallas kernels cover one-layer attention
    decoders only, and its beam never runs Pallas)."""
    c = model_cfg
    if not (c.num_lstm_layers == 1 and c.use_attention
            and c.compute_dtype == "bfloat16"):
        return False
    if method is None:
        return True
    if method == "beam":
        return beam_core_takes(beam_width, c.embed_dim, c.hidden_dim,
                               c.attn_dim)
    if method == "teacher_forced":
        return teacher_forced_takes(c.hidden_dim, c.attn_dim, frames,
                                    padded_vocab)
    device = torch.device(device or "cpu")
    sms, smem = ((H100_SMS, H100_SMEM) if device.type != "cuda"
                 else device_limits(device))
    return rollout_takes(c.embed_dim, c.hidden_dim, c.attn_dim, padded_vocab,
                         frames, sms, smem)


def projection_kernel(cfg, candidates: Optional[int] = None,
                      padded_vocab: Optional[int] = None) -> Optional[str]:
    """The kernel that computes the beam's projection and top-n on the card
    for the configuration ``cfg``: K2's int8 variant with the int8 flag, K2
    for bf16 weights, none for f32 weights (:class:`VocabProjection`); given
    ``candidates`` a row and the ``padded_vocab``, none where that kernel
    does not take the shape (ops/limits.py)."""
    H = cfg.model.hidden_dim
    if cfg.decode.int8_vocab_projection:
        kernel, takes = "topk_project_int8", topk_project_int8_takes
    elif cfg.model.compute_dtype == "bfloat16":
        kernel, takes = "topk_project", topk_project_takes
    else:
        return None
    if candidates is not None and not takes(candidates, H, padded_vocab):
        return None
    return kernel


@dataclasses.dataclass
class VocabProjection:
    """The beam step's vocab projection, per-row top-n and lse, from the
    top hidden state, through ``kernel`` (:func:`projection_kernel` of the
    configuration and shape, decided once here): K2's int8 variant on the
    quantized weights (``decode.int8_vocab_projection``, any compute dtype:
    the int8 product does not depend on it); K2 on the weights in the
    compute dtype (``logits_topk`` of ``CaptionDecoder.logits``, exactly,
    for bf16); or, with none, the same arithmetic in PyTorch, which no
    kernel computes: K2-int8's plain version on the quantized weights, else
    ``logits_topk`` of the logits in the compute dtype (the JAX package
    computes them in XLA)."""

    kernel: Optional[str]
    vocab_size: int
    w_out: Optional[torch.Tensor] = None   # compute dtype [H, Vp]; not int8
    b_out: Optional[torch.Tensor] = None   # f32 [Vp]; not int8
    int8: Optional[Int8Projection] = None   # int8 only

    @classmethod
    def from_model(cls, model, kernel: Optional[str] = "topk_project",
                   int8: Optional[bool] = None) -> "VocabProjection":
        """Quantize (int8: the flag, by default whether ``kernel`` is
        K2-int8) or cast the decoder's out_proj once."""
        dec = model.decoder
        if int8 is None:
            int8 = kernel == "topk_project_int8"
        if int8:
            return cls(kernel, dec.vocab_size, int8=Int8Projection.from_dense(
                dec.out_proj, dec.vocab_size))
        return cls(kernel, dec.vocab_size,
                   w_out=dec.out_proj.kernel.detach().to(
                       dec.compute_dtype).contiguous(),
                   b_out=dec.out_proj.bias.detach().contiguous())

    def topk(self, h: torch.Tensor, n: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """h f32[N, H] → (logp f32[N, n], idx i32[N, n]), best first."""
        if self.int8 is not None:
            if self.kernel == "topk_project_int8":
                return topk_project_int8(h, self.int8, n)
            return int8_topk_project_plain(h, self.int8, n)
        if self.kernel == "topk_project":
            return topk_project(h, self.w_out, self.b_out, n, self.vocab_size)
        return logits_topk(masked_logits(h, self.w_out, self.b_out,
                                         self.vocab_size), n)


@dataclasses.dataclass
class BeamWeights:
    """K1's weights in the kernel's layout, cast once: wq [H, A] and
    wg [E+2H, 4H] in the compute dtype (bf16 on the card); u, bg and the
    embedding table in f32; and the projection (:class:`VocabProjection`,
    K2 or K2-int8)."""

    embedding: torch.Tensor
    wq: torch.Tensor
    u: torch.Tensor
    wg: torch.Tensor
    bg: torch.Tensor
    proj: VocabProjection

    @classmethod
    def from_model(cls, model, proj_kernel: Optional[str] = "topk_project",
                   int8: Optional[bool] = None) -> "BeamWeights":
        """``proj_kernel``: :func:`projection_kernel` of the configuration
        and shape; ``int8``: the flag (:class:`VocabProjection`)."""
        dec = model.decoder
        c = dec.cfg
        if c.num_lstm_layers != 1 or not c.use_attention:
            raise NotImplementedError(
                "K1 (beam_core) runs only the 1-layer attention decoder (got "
                f"num_lstm_layers={c.num_lstm_layers}, use_attention="
                f"{c.use_attention}); the Captioner decodes other decoders "
                "through module_beam_step (models/decoding.py::"
                "kernel_decoder; ROADMAP Queue 1 item 5)")
        cd = dec.compute_dtype
        if dec.out_proj.kernel.is_cuda and cd != torch.bfloat16:
            raise NotImplementedError(
                "K1 (beam_core) computes in bf16; the Captioner decodes "
                "model.compute_dtype=float32 through module_beam_step "
                "(models/decoding.py::kernel_decoder; ROADMAP Queue 1 item 5)")
        d = lambda p: p.detach().contiguous()
        return cls(embedding=d(dec.embed.embedding),
                   wq=d(dec.attention.query.kernel.to(cd)),
                   u=d(dec.attention.u), wg=d(dec.lstm0.w.to(cd)),
                   bg=d(dec.lstm0.b),
                   proj=VocabProjection.from_model(model, proj_kernel, int8))


def fused_beam_step(w: BeamWeights, beam_width: int,
                    candidates: Optional[int] = None) -> BeamStep:
    """The beam step of the kernel decoder: embedding gather, K1
    ``beam_core`` (attention + LSTM) over the ``beam_width`` beams of each
    video, then the projection (K2 or K2-int8: projection + top-n + lse)
    with ``candidates`` a row (default ``beam_width``; the pool takes
    ``beam_width + 1``). On CUDA tensors the wrappers launch their kernels;
    on CPU tensors they run their plain versions."""
    K = beam_width
    n = candidates or K

    def step(state: DecoderState, tok: torch.Tensor):
        emb = w.embedding[tok]
        h, c = beam_core(emb, state.h[0], state.c[0], state.keys,
                         state.values, state.frame_mask, w.wq, w.u, w.wg,
                         w.bg, K)
        logp, idx = w.proj.topk(h, n)
        return (DecoderState(h=h[None], c=c[None], keys=state.keys,
                             values=state.values,
                             frame_mask=state.frame_mask), logp, idx)

    return step


def require_full_f32(model, device) -> None:
    """An f32 decoder decodes on the card in full f32, as on the CPU and in
    the JAX package: raise if PyTorch would run its matmuls in TF32."""
    if (torch.device(device).type == "cuda"
            and model.decoder.compute_dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "model.compute_dtype=float32 decodes in full f32, but "
            "torch.backends.cuda.matmul.allow_tf32 is True (TF32 keeps ~3 "
            "decimal digits); set it to False")


def module_beam_step(model, beam_width: int, proj: VocabProjection,
                     candidates: Optional[int] = None) -> BeamStep:
    """The beam step of the decoders no kernel covers: the recurrent step
    through the model's modules (``CaptionDecoder.step_beam_hidden``, on the
    state's device), then ``proj`` (K2 or K2-int8 where one computes the
    logits) with ``candidates`` a row (default ``beam_width``)."""
    K = beam_width
    n = candidates or K
    dec = model.decoder
    require_full_f32(model, dec.out_proj.kernel.device)

    def step(state: DecoderState, tok: torch.Tensor):
        state, h = dec.step_beam_hidden(state, tok, K)
        logp, idx = proj.topk(h, n)
        return state, logp, idx

    return step
