"""K3: a whole greedy or Gumbel-max sampled rollout, as a Hopper kernel
(csrc/rollout.cu).

Replaces ``vidcap_tpu/ops/pallas_decoder.py::pallas_rollout`` (body
``_rollout_kernel``, weights ``from_params``). For B rows, from (h0, c0),
BOS first, each of the max_len steps:

    emb = E[token]                     (PAD's row once a row has finished)
    h', c' = attention + LSTM as in K1 (beam_core) with one row per video
    logits = f32(bf16(bf16(h')·W_out) + bf16(b_out))
    clean = logits · (1/temperature); columns ≥ vocab_size −1e30
    pick = argmax(clean) (greedy) or argmax(clean − log(−log(uni))) (sample,
           uni from the counter hash of (row, column, seed, step))
    token = PAD once finished, else pick;  logp = clean[pick] − lse(clean),
    0 once finished;  mask = 1 − finished;  finished |= token == EOS

Ties go to the smallest column. There is no early exit: all max_len steps
run. :func:`rollout` launches the kernel for CUDA tensors and runs
:func:`rollout_plain` for CPU tensors; it never falls back from one to the
other.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from vidcap_tpu_torch.data.vocab import BOS, EOS, PAD
from vidcap_tpu_torch.models.decoder import NEG
from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.ops.beam_core import beam_core_plain
from vidcap_tpu_torch.ops.topk_project import TILE_N, masked_logits

_U32 = 0xFFFFFFFF


@dataclasses.dataclass
class RolloutWeights:
    """The rollout's weights in the kernel's layout, cast once: emb [Vp, E],
    wq [H, A], wg [E+2H, 4H], w_out [H, Vp] in the compute dtype (bf16 on
    the card, as K3 always computes); u, bg, b_out in f32."""

    emb: torch.Tensor
    wq: torch.Tensor
    u: torch.Tensor
    wg: torch.Tensor
    bg: torch.Tensor
    w_out: torch.Tensor
    b_out: torch.Tensor
    vocab_size: int

    @classmethod
    def from_model(cls, model) -> "RolloutWeights":
        dec = model.decoder
        c = dec.cfg
        if c.num_lstm_layers != 1 or not c.use_attention:
            raise NotImplementedError(
                "greedy/sample decode in vidcap_tpu_torch supports only the "
                f"1-layer attention decoder (got num_lstm_layers="
                f"{c.num_lstm_layers}, use_attention={c.use_attention}); "
                "other decoders wait for ROADMAP Queue 1 item 5 ('rollout "
                "for other decoders')")
        cd = dec.compute_dtype
        if dec.out_proj.kernel.is_cuda and cd != torch.bfloat16:
            raise NotImplementedError(
                "the Hopper rollout kernel computes in bf16; "
                "model.compute_dtype=float32 greedy/sample runs only on the "
                "CPU (ROADMAP Queue 1 item 5, 'f32 rollout kernel')")
        d = lambda p: p.detach().to(cd).contiguous()
        f = lambda p: p.detach().float().contiguous()
        return cls(emb=d(dec.embed.embedding), wq=d(dec.attention.query.kernel),
                   u=f(dec.attention.u), wg=d(dec.lstm0.w), bg=f(dec.lstm0.b),
                   w_out=d(dec.out_proj.kernel), b_out=f(dec.out_proj.bias),
                   vocab_size=dec.vocab_size)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for int64 x in [0, 2³²): split in 16-bit halves so no
    int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def gumbel_noise(clean: torch.Tensor, seed, step) -> torch.Tensor:
    """``clean − log(−log(uni))``, K3's Gumbel-perturbed logits
    (``pallas_decoder.py:216-230``) bit for bit: uint32 arithmetic emulated
    in int64. ``clean`` is f32[..., B, V]; the hash's row is the index along
    B, its column the index along V. ``seed`` and ``step`` are ints or int64
    tensors that broadcast against [..., 1, 1]; the seed is taken mod 2³²."""
    dev = clean.device
    as64 = lambda v: torch.as_tensor(v, dtype=torch.int64, device=dev) & _U32
    row = torch.arange(clean.shape[-2], device=dev)[:, None]
    col = torch.arange(clean.shape[-1], device=dev)[None, :]
    x = (_mul32(row, 0x9E3779B9) ^ _mul32(col, 0x85EBCA6B)
         ^ ((_mul32(as64(seed), 0x27D4EB2F)
             + _mul32(as64(step), 0x165667B1)) & _U32))
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    uni = (x >> 8).float() * (1.0 / (1 << 24)) + 1e-12
    return clean - torch.log(-torch.log(uni))


def step_plain(w: RolloutWeights, h, c, tok, keys, values, frame_mask,
               inv_temp: float):
    """One step of the plain version from (h, c) and the previous tokens:
    → (h', c', clean f32[B, Vp]). Rounds to the weights' dtype where the
    kernel rounds to bf16 (all f32 for f32 weights)."""
    h, c = beam_core_plain(w.emb[tok], h, c, keys, values, frame_mask, w.wq,
                           w.u, w.wg, w.bg, 1)
    logits = masked_logits(h, w.w_out, w.b_out, w.vocab_size)
    col = torch.arange(logits.shape[-1], device=logits.device)
    clean = torch.where(col < w.vocab_size, logits * inv_temp,
                        torch.full_like(logits, NEG))
    return h, c, clean


def _lse(clean: torch.Tensor) -> torch.Tensor:
    m = clean.max(-1).values
    return m + torch.log(torch.clamp(torch.exp(clean - m[:, None]).sum(-1),
                                     min=1e-30))


def select_plain(clean, sample: bool, seed, step: int):
    """K3's pick from clean logits: (pick i64[B], logp f32[B], the values
    it was taken from — noisy when sampling, else clean)."""
    scored = gumbel_noise(clean, seed, step) if sample else clean
    pick = scored.argmax(-1)          # the first maximum: the smallest column
    return pick, clean.gather(1, pick[:, None])[:, 0] - _lse(clean), scored


def _temperature(temperature: float) -> float:
    if not temperature > 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    return 1.0 / temperature


@torch.no_grad()
def rollout_plain(w: RolloutWeights, keys, values, frame_mask, h0, c0,
                  max_len: int, sample: bool = False, seed: int = 0,
                  temperature: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PyTorch version of the kernel, on any device: (tokens i32[B, L],
    logp f32[B, L], mask f32[B, L]). Forward only, as K3: SCST takes its
    gradient from a teacher-forced re-score."""
    inv_t = _temperature(temperature)
    B = h0.shape[0]
    dev = h0.device
    h, c = h0.float(), c0.float()
    tok = torch.full((B,), BOS, dtype=torch.long, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    toks, logps, masks = [], [], []
    for t in range(max_len):
        h, c, clean = step_plain(w, h, c, tok, keys, values, frame_mask, inv_t)
        pick, logp, _ = select_plain(clean, sample, seed, t)
        tok = torch.where(finished, PAD, pick)
        toks.append(tok)
        logps.append(torch.where(finished, 0.0, logp))
        masks.append((~finished).float())
        finished = finished | (tok == EOS)
    return (torch.stack(toks, 1).to(torch.int32), torch.stack(logps, 1),
            torch.stack(masks, 1))


@torch.no_grad()
def replay_plain(w: RolloutWeights, keys, values, frame_mask, h0, c0,
                 tokens, sample: bool = False, seed: int = 0,
                 temperature: float = 1.0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version fed the given tokens (a kernel's own rollout, i32[B,
    L]) in place of its own picks. For each step t, from the state the plain
    arithmetic reaches on tokens[:, :t]: (its pick i64[B, L], the top-2
    margin f32[B, L] of the values it picks from, the log-prob f32[B, L] of
    tokens[:, t]). Holds a rollout to the plain version step by step, where
    one flipped near-tie would part the two whole rollouts."""
    inv_t = _temperature(temperature)
    h, c = h0.float(), c0.float()
    tok = torch.full((h0.shape[0],), BOS, dtype=torch.long, device=h0.device)
    picks, margins, logps = [], [], []
    for t in range(tokens.shape[1]):
        h, c, clean = step_plain(w, h, c, tok, keys, values, frame_mask, inv_t)
        pick, _, scored = select_plain(clean, sample, seed, t)
        top2 = scored.topk(2, dim=-1).values
        tok = tokens[:, t].long()
        picks.append(pick)
        margins.append(top2[:, 0] - top2[:, 1])
        logps.append(clean.gather(1, tok[:, None])[:, 0] - _lse(clean))
    return (torch.stack(picks, 1), torch.stack(margins, 1),
            torch.stack(logps, 1))


def rollout(w: RolloutWeights, keys, values, frame_mask, h0, c0,
            max_len: int, sample: bool = False, seed: int = 0,
            temperature: float = 1.0
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """keys bf16[B, T, A], values bf16[B, T, H], frame_mask f32[B, T],
    h0/c0 f32[B, H] and the weights of :class:`RolloutWeights` → (tokens
    i32[B, L], logp f32[B, L], mask f32[B, L]); one host call, one count."""
    if not h0.is_cuda:
        return rollout_plain(w, keys, values, frame_mask, h0, c0, max_len,
                             sample, seed, temperature)
    inv_t = _temperature(temperature)
    B, T, A = keys.shape
    H = h0.shape[1]
    Vp, E = w.emb.shape
    if H % 32 or A % 32 or Vp % 8 or E % 8:
        raise ValueError(f"rollout: hidden {H} and attention {A} widths must "
                         f"be multiples of 32 and the vocab {Vp} and "
                         f"embedding {E} widths of 8")
    if max_len < 1 or not 1 <= w.vocab_size <= Vp:
        raise ValueError(f"rollout: max_len={max_len} must be ≥ 1 and "
                         f"vocab_size={w.vocab_size} in 1..{Vp}")
    f32, bf16 = torch.float32, torch.bfloat16
    _build.require("rollout", (
        (keys, "keys", bf16, (B, T, A)), (values, "values", bf16, (B, T, H)),
        (frame_mask, "frame_mask", f32, (B, T)), (h0, "h0", f32, (B, H)),
        (c0, "c0", f32, (B, H)), (w.emb, "emb", bf16, (Vp, E)),
        (w.wq, "wq", bf16, (H, A)), (w.u, "u", f32, (A,)),
        (w.wg, "wg", bf16, (E + 2 * H, 4 * H)), (w.bg, "bg", f32, (4 * H,)),
        (w.w_out, "w_out", bf16, (H, Vp)), (w.b_out, "b_out", f32, (Vp,))))
    fn = _build.entry("rollout", 26, 9, (ctypes.c_uint32, ctypes.c_float))
    dev = h0.device
    n_tiles = (Vp + TILE_N - 1) // TILE_N
    e = lambda *shape, dt=f32: torch.empty(*shape, device=dev, dtype=dt)
    hbuf, cbuf = e(2, B, H), e(2, B, H)
    xh, q = e(B, E + 2 * H, dt=bf16), e(B, A, dt=bf16)
    tok, fin = e(B, dt=torch.int32), e(B, dt=torch.int32)
    tmax, tsum, tnoisy, tclean = (e(B, n_tiles) for _ in range(4))
    tcol = e(B, n_tiles, dt=torch.int32)
    out_tok, out_logp, out_mask = e(B, max_len, dt=torch.int32), \
        e(B, max_len), e(B, max_len)
    err = fn(w.emb.data_ptr(), keys.data_ptr(), values.data_ptr(),
             frame_mask.data_ptr(), h0.data_ptr(), c0.data_ptr(),
             w.wq.data_ptr(), w.u.data_ptr(), w.wg.data_ptr(),
             w.bg.data_ptr(), w.w_out.data_ptr(), w.b_out.data_ptr(),
             hbuf.data_ptr(), cbuf.data_ptr(), xh.data_ptr(), q.data_ptr(),
             tok.data_ptr(), fin.data_ptr(), tmax.data_ptr(), tsum.data_ptr(),
             tnoisy.data_ptr(), tclean.data_ptr(), tcol.data_ptr(),
             out_tok.data_ptr(), out_logp.data_ptr(), out_mask.data_ptr(),
             B, T, E, H, A, Vp, w.vocab_size, max_len, int(sample),
             int(seed) & _U32, inv_t, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rollout")
    _build.launch_counts["rollout"] += 1
    return out_tok, out_logp, out_mask


@torch.no_grad()
def model_rollout(model, feats, frame_mask, max_len: int,
                  sample: bool = False, seed: int = 0,
                  temperature: float = 1.0,
                  weights: Optional[RolloutWeights] = None):
    """The model's ``init_state`` (feature/key projections, h0/c0), then
    :func:`rollout`. ``weights``: :meth:`RolloutWeights.from_model` of this
    model, cast once by the caller, or None to cast them here. Returns a
    ``models.decoding.Rollout``."""
    from vidcap_tpu_torch.models.decoding import Rollout
    state = model.init_state(feats, frame_mask)
    w = weights if weights is not None else RolloutWeights.from_model(model)
    toks, logp, mask = rollout(
        w, state.keys, state.values, state.frame_mask, state.h[0].contiguous(),
        state.c[0].contiguous(), max_len, sample, seed, temperature)
    return Rollout(tokens=toks, logp=logp, mask=mask)
