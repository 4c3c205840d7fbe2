"""Decode strategies of the PyTorch package: greedy, sampled and beam, and
the one place that decides which kernels run them.

Beam search mirrors ``vidcap_tpu/models/decoding.py``: :func:`beam_decode`
(slot-blocking beams, B×K beams flattened into the batch, the state's own
``reorder`` after pruning: h/c only for the LSTM) and
:func:`beam_decode_pool` (the finished-hypothesis pool), driven by a step
that returns each row's top-n log-probs directly (n = K for slot-blocking,
K+1 for the pool).

:func:`route` decides, once a call, from the decoder, the configuration and
the shape (ops/limits.py), what a call launches; :class:`KernelWeights`
reads the decoder's parameters for the kernels and casts them once. The
beam step is :func:`fused_beam_step` (K1 ``beam_core``, then the
projection) where the route takes K1, else the model's own (the LSTM's
:func:`module_beam_step`); either projects through :class:`VocabProjection`
on the route's kernel. :func:`model_rollout` runs one greedy or sampled
rollout, on K3 or by :func:`greedy_decode` and :func:`sample_decode`, the
generic loops over a logits step (``model.step``), as in the JAX package.

Ties go to the smallest index in the per-row top-K
(:func:`per_row_topk_iterative`, the plain K2's) and in the K·K top-K
(:func:`topk_stable`, one stable sort where the JAX package calls
``lax.top_k``); ``torch.topk`` promises no tie order.

With early exit, each loop reads its finish test on the host once a step,
inside a ``beam.exit_check`` span (``utils/profiling.py``; ``id`` the
step): the count of those spans is the count of host reads.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from vidcap_tpu_torch.data.vocab import BOS, EOS, PAD
from vidcap_tpu_torch.ops.beam_core import beam_core
from vidcap_tpu_torch.ops.cell import NEG
from vidcap_tpu_torch.ops.int8_proj import (Int8Projection,
                                            int8_topk_project_plain,
                                            topk_project_int8)
from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.ops.limits import (H100_SMEM, H100_SMS,
                                         beam_core_takes, moe_takes,
                                         rollout_takes, silu_mul_takes,
                                         teacher_forced_takes,
                                         topk_project_int8_takes,
                                         topk_project_takes)
from vidcap_tpu_torch.ops.rollout import (RolloutWeights, device_limits,
                                          device_seed, gumbel_noise, rollout,
                                          rollout_fits_resident)
from vidcap_tpu_torch.ops.topk_project import (  # noqa: F401 (re-export)
    MAX_K, logits_topk, masked_logits, per_row_topk_iterative, topk_project)
from vidcap_tpu_torch.utils import profiling

# step(state, prev_tok i64[B·K]) → (state, logp f32[B·K, n], idx i32[B·K, n])
# with n = K (beam_decode) or K + 1 (beam_decode_pool) candidates a row
BeamStep = Callable[["DecoderState", torch.Tensor],
                    Tuple["DecoderState", torch.Tensor, torch.Tensor]]
# step(state, prev_tok i64[B]) → (state, logits f32[B, V])
LogitsStep = Callable[["DecoderState", torch.Tensor],
                      Tuple["DecoderState", torch.Tensor]]


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


def tile_recurrent(state, beam_width: int):
    """Beam-tile only h and c (→ [layers, B·K, H]); attention tensors stay
    per video for the shared-keys beam step."""
    return dataclasses.replace(
        state, h=state.h.repeat_interleave(beam_width, dim=1),
        c=state.c.repeat_interleave(beam_width, dim=1))


def beam_decode(step_fn: BeamStep, state, batch: int,
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


def beam_decode_pool(step_fn: BeamStep, state, batch: int,
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


@dataclasses.dataclass(frozen=True)
class Widths:
    """What :func:`route` reads of a decoder (its ``widths``): whether it is
    the decoder the recurrent kernels compute, one bf16 LSTM layer with
    attention (``lstm``); its embedding, hidden and attention widths and its
    projection's vocab columns; whether its projection weights are bf16;
    whether it has the int8 projection; whether it holds a rank's share of
    the vocab (the vocab seam, ``parallel/sharding.py::VocabShard``); and
    its SiLU MLPs (``mlps``), each as (its activation's width, and for
    routed experts (experts a token, routed experts), else None)."""

    lstm: bool
    embed: int
    hidden: int
    attn: int
    vocab: int
    bf16: bool
    int8: bool
    seam: bool
    mlps: Tuple[Tuple[int, Optional[Tuple[int, int]]], ...] = ()


@dataclasses.dataclass(frozen=True)
class Route:
    """What one call launches (:func:`route`): its recurrent kernel
    ("beam_core", "rollout" or "teacher_forced"), or None where the model's
    modules compute the step; the beam's projection kernel ("topk_project"
    or "topk_project_int8"), or None where PyTorch computes it; whether that
    projection is the int8 one; K3's W_out mode, True resident in shared
    memory, False streamed from L2 (None without K3); and the K5 kernels
    (``ops/moe.py``) the decoder's MLPs launch (``moe``,
    :func:`moe_kernels`)."""

    recurrent: Optional[str]
    projection: Optional[str]
    int8: bool
    resident: Optional[bool]
    moe: Tuple[str, ...] = ()

    @property
    def kernels(self) -> Tuple[str, ...]:
        return tuple(k for k in (self.recurrent, self.projection) if k) \
            + self.moe


def moe_kernels(device, inter: int,
                routed: Optional[Tuple[int, int, int]] = None
                ) -> Tuple[str, ...]:
    """K5's kernels that a SiLU MLP with activations ``inter`` columns wide
    launches on ``device``: none off the card; on it ``silu_mul`` wherever
    ``ops/limits.py`` takes the width, and for routed experts (``routed``:
    experts a token, experts, hidden width) ``moe_dispatch`` and
    ``moe_combine`` wherever it takes those. The one rule for K5:
    :func:`route` lists what it gives over a decoder's MLPs, and
    ``models/lm_decoder.py``'s modules ask it at each call, of their
    input's device and the configuration then."""
    if torch.device(device).type != "cuda":
        return ()
    act = ("silu_mul",) if silu_mul_takes(inter) else ()
    if routed is None or not moe_takes(*routed):
        return act
    return ("moe_dispatch",) + act + ("moe_combine",)


def route(dec, decode, method: str, beam_width: int, frames: int, device,
          dropout=None) -> Route:
    """The one place that decides which kernels a call of decoder ``dec``
    (a model's ``decoder``) launches, once a call: ``method`` "beam",
    "greedy", "sample" or "teacher_forced" (``CaptionDecoder.xe_logits``,
    with its ``dropout``) under the decode configuration ``decode``, at
    ``beam_width`` beams (candidates a row: one more with the finished
    pool) over ``frames`` frames on ``device``.

    K1 (beam), K3 (greedy and sampled) and K4 (teacher-forced) run the one
    bf16 LSTM layer with attention wherever the kernel takes the shape
    (ops/limits.py): K3 on ``device``'s SMs and shared memory (the H100's
    off the card), K4 on the card only, with no dropout and no vocab seam.
    They run it with no switch back. Every other decoder, and every shape a
    kernel refuses, runs its step through the model's modules on the same
    device, where the JAX package takes its XLA path (its Pallas kernels
    cover one-layer attention decoders only, and its beam never runs
    Pallas). The beam's projection runs on K2-int8 with
    ``decode.int8_vocab_projection`` where the decoder has the int8
    projection, else on K2 for bf16 weights, wherever the kernel takes the
    candidates and widths. A decoder with SiLU MLPs runs their
    activation, and its routed experts' dispatch and combine, on K5 wherever
    :func:`moe_kernels` says so, its modules asking the same rule at each
    call."""
    w = dec.widths
    device = torch.device(device)
    if method == "beam":
        n = beam_width + 1 if use_finished_pool(decode) else beam_width
        int8 = decode.int8_vocab_projection and w.int8
        kernel, takes = (("topk_project_int8", topk_project_int8_takes)
                         if int8 else ("topk_project", topk_project_takes))
        proj = kernel if (int8 or w.bf16) and takes(n, w.hidden, w.vocab) \
            else None
        k1 = w.lstm and beam_core_takes(beam_width, w.embed, w.hidden, w.attn)
        k5 = {n for inter, routed in w.mlps for n in moe_kernels(
            device, inter, routed and (*routed, w.hidden))}
        return Route("beam_core" if k1 else None, proj, int8, None,
                     tuple(n for n in _build.MOE if n in k5))
    if method == "teacher_forced":
        k4 = (w.lstm and device.type == "cuda" and dropout is None
              and not w.seam
              and teacher_forced_takes(w.hidden, w.attn, frames, w.vocab))
        return Route("teacher_forced" if k4 else None, None, False, None)
    none = Route(None, None, False, None)
    if not w.lstm:
        return none
    sms, smem = ((H100_SMS, H100_SMEM) if device.type != "cuda"
                 else device_limits(device))
    if not rollout_takes(w.embed, w.hidden, w.attn, w.vocab, frames, sms,
                         smem):
        return none
    return Route("rollout", None, False, device.type != "cuda"
                 or rollout_fits_resident(w.vocab, w.embed, w.hidden, w.attn,
                                          frames, sms, smem))


@dataclasses.dataclass
class VocabProjection:
    """The beam step's vocab projection, per-row top-n and lse, from the
    top hidden state, through ``kernel`` (the route's ``projection``): K2's
    int8 variant on the quantized weights (``decode.int8_vocab_projection``,
    any compute dtype: the int8 product does not depend on it); K2 on the
    weights in the compute dtype (``logits_topk`` of
    ``CaptionDecoder.logits``, exactly, for bf16); or, with none, the same
    arithmetic in PyTorch, which no kernel computes: K2-int8's plain version
    on the quantized weights, else ``logits_topk`` of the logits in the
    compute dtype (the JAX package computes them in XLA)."""

    kernel: Optional[str]
    vocab_size: int
    w_out: Optional[torch.Tensor] = None   # compute dtype [H, Vp]; not int8
    b_out: Optional[torch.Tensor] = None   # f32 [Vp]; not int8
    int8: Optional[Int8Projection] = None   # int8 only

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
    """K1's weights in the kernel's layout (:meth:`KernelWeights.beam`): wq
    [H, A] and wg [E+2H, 4H] in the compute dtype (bf16 on the card); u, bg
    and the embedding table in f32; and the projection
    (:class:`VocabProjection`, K2 or K2-int8)."""

    embedding: torch.Tensor
    wq: torch.Tensor
    u: torch.Tensor
    wg: torch.Tensor
    bg: torch.Tensor
    proj: VocabProjection


class KernelWeights:
    """The tensors the kernels take of decoder ``dec`` (a model's
    ``decoder``), read from its parameters here alone, each cast once, on
    the first call that asks for it: the beam's projection
    (:meth:`projection`, any decoder), and of the one bf16 LSTM layer with
    attention K1's (:meth:`beam`, the embedding in f32), K3's
    (:meth:`rollout`, the embedding in the compute dtype; Wq, u, Wg and bg
    shared with K1, W_out and b_out with the projection) and K4's parameters
    as they are (:meth:`teacher_forced`: autograd needs them). ``full``:
    (embedding, out_proj kernel, bias) of the whole vocab where ``dec``
    holds a rank's share of it (the vocab seam,
    ``parallel/sharding.py::VocabShard.full``). A ``Captioner`` keeps one
    until its parameters change; the SCST step builds one a step."""

    def __init__(self, dec, full=None):
        self.dec = dec
        self.full = full
        self.proj: Optional[VocabProjection] = None   # the last one handed out
        self._cell = None   # (Wq, u, Wg, bg)
        self._head = None   # (W_out, b_out)
        self._rollout: Optional[RolloutWeights] = None

    def _one_layer(self):
        """The decoder, if the kernels compute it; raises for every other
        (f32 only for CUDA tensors: on the CPU the plain versions take f32
        weights)."""
        dec = self.dec
        c = dec.cfg
        if (c.num_lstm_layers != 1 or not c.use_attention
                or (dec.out_proj.kernel.is_cuda
                    and dec.compute_dtype != torch.bfloat16)):
            raise NotImplementedError(
                "K1, K3 and K4 compute one bf16 LSTM layer with attention "
                f"(got num_lstm_layers={c.num_lstm_layers}, use_attention="
                f"{c.use_attention}, compute_dtype={c.compute_dtype}); every "
                "other decoder decodes through its modules (models/"
                "decoding.py::route; ROADMAP Queue 1 item 5)")
        return dec

    def _cast(self, p: torch.Tensor) -> torch.Tensor:
        return p.detach().to(self.dec.compute_dtype).contiguous()

    def _cell_weights(self):
        if self._cell is None:
            dec = self._one_layer()
            f32 = lambda p: p.detach().float().contiguous()
            self._cell = (self._cast(dec.attention.query.kernel),
                          f32(dec.attention.u), self._cast(dec.lstm0.w),
                          f32(dec.lstm0.b))
        return self._cell

    def _head_weights(self):
        if self._head is None:
            out = self.dec.out_proj
            w, b = self.full[1:] if self.full else (out.kernel, out.bias)
            self._head = (self._cast(w), torch.zeros(w.shape[1],
                                                     device=w.device)
                          if b is None else b.detach().float().contiguous())
        return self._head

    def projection(self, r: Route) -> VocabProjection:
        """The beam's projection through ``r.projection``: quantized
        (``r.int8``) or cast once; a later route changes its kernel, not its
        weights."""
        p, dec = self.proj, self.dec
        if p is None or (p.int8 is not None) != r.int8:
            p = (VocabProjection(r.projection, dec.vocab_size,
                                 int8=Int8Projection.from_dense(
                                     dec.out_proj, dec.vocab_size))
                 if r.int8 else
                 VocabProjection(r.projection, dec.vocab_size,
                                 *self._head_weights()))
        elif p.kernel != r.projection:
            p = dataclasses.replace(p, kernel=r.projection)
        self.proj = p
        return p

    def beam(self, r: Route) -> BeamWeights:
        """K1's weights, with the projection of ``r``."""
        cell = self._cell_weights()
        return BeamWeights(self.dec.embed.embedding.detach().contiguous(),
                           *cell, self.projection(r))

    def rollout(self) -> RolloutWeights:
        if self._rollout is None:
            dec = self._one_layer()
            emb = self._cast(self.full[0] if self.full
                             else dec.embed.embedding)
            self._rollout = RolloutWeights(emb, *self._cell_weights(),
                                           *self._head_weights(),
                                           dec.vocab_size)
        return self._rollout

    def teacher_forced(self) -> Tuple[torch.Tensor, ...]:
        """(Wq, u, W, b, W_out, b_out), the parameters themselves."""
        dec = self._one_layer()
        a, out = dec.attention, dec.out_proj
        return (a.query.kernel, a.u, dec.lstm0.w, dec.lstm0.b, out.kernel,
                out.bias)


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

    def step(state, tok: torch.Tensor):
        emb = w.embedding[tok]
        h, c = beam_core(emb, state.h[0], state.c[0], state.keys,
                         state.values, state.frame_mask, w.wq, w.u, w.wg,
                         w.bg, K)
        logp, idx = w.proj.topk(h, n)
        return dataclasses.replace(state, h=h[None], c=c[None]), logp, idx

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

    def step(state, tok: torch.Tensor):
        state, h = dec.step_beam_hidden(state, tok, K)
        logp, idx = proj.topk(h, n)
        return state, logp, idx

    return step


@torch.no_grad()
def model_rollout(model, r: Route, w: Optional[RolloutWeights], feats,
                  frame_mask, max_len: int, step: LogitsStep, *,
                  sample: bool, seed, temperature: float, row0: int,
                  early_exit: bool) -> Rollout:
    """One greedy or sampled (``sample``) rollout of ``model`` from the
    features ``feats`` (``model.init_state``) on route ``r``: by K3
    (``ops/rollout.py::rollout``: forward only, one launch a 32 rows on the
    card, its plain version on the CPU) over its weights ``w``
    (:meth:`KernelWeights.rollout`) in ``r``'s W_out mode; else by
    :func:`sample_decode` or :func:`greedy_decode` over ``step`` (the
    model's ``step``, or a caller's wrapper of it), the greedy one reading
    its finish test on the host once a step with ``early_exit``. ``seed``
    (sampled only): an int or an int64 tensor on the device, read there;
    ``row0``: the noise hash's row of the first row (a data-parallel rank's
    offset in the global batch). Both routes draw K3's counter-hash noise
    (``ops/rollout.py::gumbel_noise``)."""
    state = model.init_state(feats, frame_mask)
    if r.recurrent:
        toks, logp, mask = rollout(
            w, state.keys, state.values, state.frame_mask,
            state.h[0].contiguous(), state.c[0].contiguous(), max_len,
            sample, seed, temperature if sample else 1.0, r.resident, row0)
        return Rollout(tokens=toks, logp=logp, mask=mask)
    require_full_f32(model, feats.device)
    B = feats.shape[0]
    if sample:
        return sample_decode(step, state, B, max_len,
                             device_seed(seed, feats.device), temperature,
                             row0)
    return greedy_decode(step, state, B, max_len, early_exit=early_exit,
                         with_logp=False)
