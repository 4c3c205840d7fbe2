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
run. The sampling seed is an int or an int64 tensor; the kernel reads it
from device memory at launch, so a captured launch samples with the seed
written into its buffer before each replay. :func:`rollout` launches the
kernel for CUDA tensors and runs :func:`rollout_plain` for CPU tensors; it
never falls back from one to the other. On the card the kernel keeps W_out
in shared memory for the whole rollout (``resident_wout=True``) or streams
it from L2 each step (``False``), as ``pallas_rollout`` does; the route
(``models/decoding.py::route``) chooses.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from vidcap_tpu_torch.data.vocab import BOS, EOS, PAD
from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.ops.beam_core import beam_core_plain
from vidcap_tpu_torch.ops.cell import NEG
from vidcap_tpu_torch.ops.limits import (  # noqa: F401 (H100_*: re-export)
    H100_SMEM, H100_SMS, HID, MAX_GRID, MAX_WIDTH, ROWS, rollout_shape_ok)
from vidcap_tpu_torch.ops.topk_project import masked_logits

_U32 = 0xFFFFFFFF


@dataclasses.dataclass
class RolloutWeights:
    """The rollout's weights in the kernel's layout: emb [Vp, E], wq [H, A],
    wg [E+2H, 4H], w_out [H, Vp] in the compute dtype (bf16 on the card, as
    K3 always computes); u, bg, b_out in f32 (``models/decoding.py::
    KernelWeights`` casts them from a decoder)."""

    emb: torch.Tensor
    wq: torch.Tensor
    u: torch.Tensor
    wg: torch.Tensor
    bg: torch.Tensor
    w_out: torch.Tensor
    b_out: torch.Tensor
    vocab_size: int


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for int64 x in [0, 2³²): split in 16-bit halves so no
    int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def counter_uniform(rows: int, cols: int, seed, step, device,
                    row0: int = 0) -> torch.Tensor:
    """K3's counter hash of (row0 + row, column, seed, step) as uniforms
    f32[rows, cols] in (0, 1] (``pallas_decoder.py:216-229``), uint32
    arithmetic emulated in int64. ``seed`` and ``step`` are ints or int64
    tensors that broadcast against [..., 1, 1]; the seed is taken mod 2³².
    An int is hashed on the host and enters as a scalar, never copied to
    the device, so a CUDA graph can hold the call."""

    def mixed(v, c: int):
        if torch.is_tensor(v):
            return _mul32(v.to(device=device, dtype=torch.int64) & _U32, c)
        return ((int(v) & _U32) * c) & _U32

    row = torch.arange(row0, row0 + rows, device=device)[:, None]
    col = torch.arange(cols, device=device)[None, :]
    x = (_mul32(row, 0x9E3779B9) ^ _mul32(col, 0x85EBCA6B)
         ^ ((mixed(seed, 0x27D4EB2F) + mixed(step, 0x165667B1)) & _U32))
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).float() * (1.0 / (1 << 24)) + 1e-12


def gumbel_noise(clean: torch.Tensor, seed, step, row0: int = 0
                 ) -> torch.Tensor:
    """``clean − log(−log(uni))``, K3's Gumbel-perturbed logits
    (``pallas_decoder.py:216-230``) bit for bit: uint32 arithmetic emulated
    in int64. ``clean`` is f32[..., B, V]; the hash's row is the index along
    B, its column the index along V. ``seed`` and ``step`` are ints or int64
    tensors on ``clean``'s device that broadcast against [..., 1, 1]; the
    seed is taken mod 2³². An int is hashed on the host and enters as a
    scalar, never copied to the device, so a CUDA graph can hold the
    call. ``row0``: the hash's row of the first row (K3's ``row0``: a
    data-parallel rank's offset in the global batch)."""
    uni = counter_uniform(clean.shape[-2], clean.shape[-1], seed, step,
                          clean.device, row0)
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


def select_plain(clean, sample: bool, seed, step: int, row0: int = 0):
    """K3's pick from clean logits: (pick i64[B], logp f32[B], the values
    it was taken from — noisy when sampling, else clean)."""
    scored = gumbel_noise(clean, seed, step, row0) if sample else clean
    pick = scored.argmax(-1)          # the first maximum: the smallest column
    return pick, clean.gather(1, pick[:, None])[:, 0] - _lse(clean), scored


def _temperature(temperature: float) -> float:
    if not temperature > 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    return 1.0 / temperature


@torch.no_grad()
def rollout_plain(w: RolloutWeights, keys, values, frame_mask, h0, c0,
                  max_len: int, sample: bool = False, seed: int = 0,
                  temperature: float = 1.0, row0: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PyTorch version of the kernel, on any device: (tokens i32[B, L],
    logp f32[B, L], mask f32[B, L]). Forward only, as K3: SCST takes its
    gradient from a teacher-forced re-score. ``row0``: as :func:`rollout`."""
    inv_t = _temperature(temperature)
    B = h0.shape[0]
    dev = h0.device
    h, c = h0.float(), c0.float()
    tok = torch.full((B,), BOS, dtype=torch.long, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    toks, logps, masks = [], [], []
    for t in range(max_len):
        h, c, clean = step_plain(w, h, c, tok, keys, values, frame_mask, inv_t)
        pick, logp, _ = select_plain(clean, sample, seed, t, row0)
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


# The kernel's grid and shared memory (csrc/rollout.cu): one block per SM;
# a launch takes up to ROWS rows; a block holds HID hidden columns of the
# gates, a slice of W_out's columns (resident) or streams it through STAGES
# ring stages of up to PASS_COLS columns (ops/limits.py).
STAGES, PASS_COLS = 3, 128


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def vocab_slice_cols(vp: int, blocks: int) -> int:
    """W_out columns each block of the kernel holds: ``vp / blocks`` rounded
    up to a multiple of 8 (an 8-column panel). The last blocks may hold
    fewer, or none. Wq's columns are sliced by the same rule."""
    return _up(-(-vp // 8), blocks) // blocks * 8


def rollout_smem_bytes(resident: bool, vp: int, e: int, h: int, a: int,
                       t: int, blocks: int) -> int:
    """Shared memory one block of the kernel takes (``smem_layout`` in
    csrc/rollout.cu, plus its 8 static bytes): the W_out slice (resident) or
    its ring, Wg's 16 gate columns, the Wq slice, the b_out slice, bf16(h)
    of 32 rows (or the gate partials, whichever is larger), c, the pick
    partials, the scores, the barriers and 1 KB for alignment."""
    nc, qc = vocab_slice_cols(vp, blocks), vocab_slice_cols(a, blocks)
    kd = 64 if h % 64 == 0 else 32
    wout = nc * h * 2 if resident else STAGES * min(nc, PASS_COLS) * kd * 2
    parts = (wout, 2 * (e + 2 * h) * 16, qc * h * 2, nc * 4,
             max(ROWS * (h + 8) * 2, 8 * ROWS * 4 * HID * 4), ROWS * HID * 4,
             4 * ROWS * 5 * 4, t * 4, 8 * (1 + STAGES))
    return sum(_up(x, 128) for x in parts) + 1024 + 8


def rollout_fits_resident(vp: int, e: int, h: int, a: int, t: int,
                          blocks: int = H100_SMS,
                          smem_per_block: int = H100_SMEM) -> bool:
    """Whether the kernel can keep W_out resident in shared memory on a card
    of ``blocks`` SMs that lets a block take ``smem_per_block`` bytes (the
    H100's by default): the route's choice (``models/decoding.py::route``).
    When it does not, W_out streams from L2 each step (``resident_wout=
    False``), as the reference's ``pallas_rollout(resident_wout=False)``."""
    return rollout_smem_bytes(True, vp, e, h, a, t, blocks) <= smem_per_block


_limits = {}


def device_limits(dev: torch.device) -> Tuple[int, int]:
    """(SMs, shared memory a block may opt into) of a CUDA device."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _limits:
        lib = _build.load("rollout")
        smem, sms = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(idx):
            _build.check(lib.vidcap_rollout_limits(ctypes.byref(smem),
                                                   ctypes.byref(sms)),
                         "rollout")
        _limits[idx] = (sms.value, smem.value)
    return _limits[idx]


def select_sliced_plain(clean, sample: bool, seed, step: int,
                        slice_cols: int):
    """:func:`select_plain` by the kernel's decomposition: the columns in
    contiguous slices of ``slice_cols`` (one per block; slices past the
    width are empty); per slice its max m_j, Σ exp(clean − m_j) and best
    (noisy desc, column asc) with its clean value; merged in slice order:
    lse = m + log(max(Σ_j s_j · exp(m_j − m), 1e-30)) and the best of the
    slices' bests, ties to the smaller column. Returns (pick i64[B], logp
    f32[B]). The CPU tests hold it to :func:`select_plain`."""
    scored = gumbel_noise(clean, seed, step) if sample else clean
    B, V = clean.shape
    m = torch.full((B,), -torch.inf)
    s = torch.zeros(B)
    bv = torch.full((B,), -torch.inf)
    bc = torch.zeros(B)
    bi = torch.full((B,), 2 ** 31 - 1, dtype=torch.long)
    for c0 in range(0, _up(V, slice_cols), slice_cols):
        x, nz = clean[:, c0:c0 + slice_cols], scored[:, c0:c0 + slice_cols]
        if x.shape[1] == 0:
            continue   # an empty slice: (−inf, 0, −inf, 2³¹−1) merges to nothing
        mj = x.max(-1).values
        sj = torch.exp(x - mj[:, None]).sum(-1)
        vj, ij = nz.max(-1)   # the first maximum: the smallest column
        cj = x.gather(1, ij[:, None])[:, 0]
        mn = torch.maximum(m, mj)
        s = torch.where(m > -torch.inf, s * torch.exp(m - mn), 0.0) \
            + sj * torch.exp(mj - mn)
        m = mn
        take = (vj > bv) | ((vj == bv) & (ij + c0 < bi))
        bv, bc = torch.where(take, vj, bv), torch.where(take, cj, bc)
        bi = torch.where(take, ij + c0, bi)
    return bi, bc - (m + torch.log(torch.clamp(s, min=1e-30)))


def device_seed(seed, device) -> torch.Tensor:
    """``seed`` as the int64 scalar on ``device`` that the kernel reads (an
    int is uploaded; a tensor is taken as it is, so a captured caller keeps
    its own buffer)."""
    if torch.is_tensor(seed):
        if seed.dtype != torch.int64 or seed.numel() != 1 \
                or seed.device != torch.device(device):
            raise ValueError(f"rollout: the seed must be one int64 on "
                             f"{device}, got {seed.dtype} {tuple(seed.shape)}"
                             f" on {seed.device}")
        return seed
    return torch.tensor(int(seed), dtype=torch.int64, device=device)


def rollout(w: RolloutWeights, keys, values, frame_mask, h0, c0,
            max_len: int, sample: bool = False, seed=0,
            temperature: float = 1.0, resident_wout: bool = True,
            row0: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """keys bf16[B, T, A], values bf16[B, T, H], frame_mask f32[B, T],
    h0/c0 f32[B, H] and the weights of :class:`RolloutWeights` → (tokens
    i32[B, L], logp f32[B, L], mask f32[B, L]).

    On the card: one launch of the persistent kernel per 32 rows (one for
    B ≤ 32), one count each. ``seed`` (sampled only): an int, or an int64
    tensor of one element on the card (:func:`device_seed`), read by the
    kernel when it runs. ``resident_wout`` mirrors
    ``pallas_rollout(resident_wout=...)``: True keeps W_out in shared
    memory for the whole rollout and raises ValueError if it does not fit
    (:func:`rollout_fits_resident`); False streams it from L2 each step.
    CPU tensors take :func:`rollout_plain`, which has no mode. ``row0``:
    the noise hash's row of the first row, so that a data-parallel rank
    holding rows row0.. of the global batch samples what one process
    samples for them."""
    if not h0.is_cuda:
        return rollout_plain(w, keys, values, frame_mask, h0, c0, max_len,
                             sample, seed, temperature, row0)
    inv_t = _temperature(temperature)
    B, T, A = keys.shape
    H = h0.shape[1]
    Vp, E = w.emb.shape
    dev = h0.device
    sms, smem = device_limits(dev)
    if not rollout_shape_ok(E, H, A, Vp, sms):
        raise ValueError(f"rollout: embedding {E}, hidden {H} and attention "
                         f"{A} widths must be multiples of 32, hidden and "
                         f"attention at most {MAX_WIDTH}, and the vocab "
                         f"width {Vp} a multiple of 8; the kernel runs one "
                         f"block per SM on {2 * ROWS}..{MAX_GRID} SMs, {HID} "
                         f"hidden columns a block (the card has {sms} SMs)")
    if max_len < 1 or not 1 <= w.vocab_size <= Vp:
        raise ValueError(f"rollout: max_len={max_len} must be ≥ 1 and "
                         f"vocab_size={w.vocab_size} in 1..{Vp}")
    need = rollout_smem_bytes(resident_wout, Vp, E, H, A, T, sms)
    if need > smem:
        if resident_wout:
            raise ValueError(
                f"rollout: resident W_out needs {need} bytes of shared "
                f"memory a block ({Vp} vocab columns over {sms} SMs), more "
                f"than the {smem} the card allows; set resident_wout=False "
                "to stream W_out from L2 each step")
        raise ValueError(f"rollout: {need} bytes of shared memory a block "
                         f"even with W_out streamed, more than the card's "
                         f"{smem}")
    f32, bf16 = torch.float32, torch.bfloat16
    _build.require("rollout", (
        (keys, "keys", bf16, (B, T, A)), (values, "values", bf16, (B, T, H)),
        (frame_mask, "frame_mask", f32, (B, T)), (h0, "h0", f32, (B, H)),
        (c0, "c0", f32, (B, H)), (w.emb, "emb", bf16, (Vp, E)),
        (w.wq, "wq", bf16, (H, A)), (w.u, "u", f32, (A,)),
        (w.wg, "wg", bf16, (E + 2 * H, 4 * H)), (w.bg, "bg", f32, (4 * H,)),
        (w.w_out, "w_out", bf16, (H, Vp)), (w.b_out, "b_out", f32, (Vp,))))
    seed_t = device_seed(seed, dev) if sample else None
    fn = _build.entry("rollout", 24, 14, (ctypes.c_void_p, ctypes.c_float))
    n = min(B, ROWS)
    # scratch handed between the blocks: bf16 [emb; ctx], bf16(h'), q, per
    # (row, block) the pick partials (max, exp-sum, best noisy, its clean
    # value f32; its column i32), and two steps' pick keys per row (u64)
    buf, (xh, h16, q, pm, ps, pn, pc, pi, pick) = _build.scratch(dev, (
        n * (E + H) * 2, n * H * 2, n * A * 2, *(n * sms * 4,) * 5, 2 * n * 8))
    out_tok = torch.empty(B, max_len, device=dev, dtype=torch.int32)
    out_logp = torch.empty(B, max_len, device=dev, dtype=f32)
    out_mask = torch.empty(B, max_len, device=dev, dtype=f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    nc, qc = vocab_slice_cols(Vp, sms), vocab_slice_cols(A, sms)
    for r0 in range(0, B, ROWS):
        r1 = min(B, r0 + ROWS)
        at = lambda x: x.data_ptr() + r0 * x.stride(0) * x.element_size()
        err = fn(w.emb.data_ptr(), at(keys), at(values), at(frame_mask),
                 at(h0), at(c0), w.wq.data_ptr(), w.u.data_ptr(),
                 w.wg.data_ptr(), w.bg.data_ptr(), w.w_out.data_ptr(),
                 w.b_out.data_ptr(), xh, h16, q, pm, ps, pn, pc, pi, pick,
                 at(out_tok), at(out_logp), at(out_mask), r1 - r0, T, E, H, A,
                 Vp, w.vocab_size, max_len, row0 + r0, sms, nc, qc,
                 int(resident_wout), int(sample),
                 None if seed_t is None else seed_t.data_ptr(), inv_t, stream)
        if err == 82:   # cudaErrorCooperativeLaunchTooLarge
            raise RuntimeError(
                f"rollout: the card cannot hold all {sms} blocks of the "
                f"persistent kernel at once ({need} bytes of shared memory "
                "and 256 threads a block); the cooperative launch was "
                "refused")
        _build.check(err, "rollout")
        _build.count_launch("rollout")
    return out_tok, out_logp, out_mask
