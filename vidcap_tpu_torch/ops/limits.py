"""Which shapes the kernels take on the card: one predicate a kernel, from
the constants its wrapper raises on.

The wrappers (``beam_core``, ``topk_project``, ``topk_project_int8``,
``rollout``, ``teacher_forced``, and K5's ``moe_dispatch``, ``silu_mul``
and ``moe_combine``) raise ``ValueError`` for a shape their
kernel cannot compute; the route (``models/decoding.py::route``) asks these
predicates first, so a shape no kernel takes decodes through the model's
modules instead (K4's: the teacher-forced pass through the module loop),
as the JAX package decodes every width through XLA. Nothing here touches the card: K3's limits take
the card's SM count and the shared memory a block may opt into
(``ops/rollout.py::device_limits``), the H100's by default.
"""
from __future__ import annotations

MAX_BEAM = 8       # K1: beams a video (a warp's rows of a video's scores)
MAX_K = 8          # K2, K2-int8: candidates a row (the register top-K)
# K2: up to 512 a block keeps its rows of bf16(h) in shared memory; wider
# rows stream through its ring beside W_out (csrc/projection.cuh)
MAX_HIDDEN = 2048
MAX_WIDTH = 512    # K3: hidden and attention widths, a column pair a thread
# K3's grid: one block per SM, a launch takes up to ROWS rows, a block holds
# HID hidden columns of the gates; a warp merges a row's partials, 8 a lane
ROWS, HID, MAX_GRID = 32, 4, 256
H100_SMS, H100_SMEM = 132, 232_448   # SMs; shared memory a block may opt into
# K4: its attention kernels keep a row's d ctx, q, bf16(u), three per-frame
# rows and 4,096 partial sums in the 48 KB of shared memory a block takes
# without opting in
TF_MAX_WIDTH, TF_MAX_FRAMES = 2048, 512
# K5: experts a token (the combine's loop) and experts (the sort's per-warp
# histograms, 32 KB of shared memory)
MOE_MAX_K, MOE_MAX_EXPERTS = 8, 256


def beam_core_takes(beam: int, embed: int, hidden: int, attn: int) -> bool:
    """K1: 1..MAX_BEAM beams; hidden and attention widths multiples of 32,
    the embedding a multiple of 8."""
    return (1 <= beam <= MAX_BEAM and hidden % 32 == 0 and attn % 32 == 0
            and embed % 8 == 0)


def topk_project_takes(k: int, hidden: int, vocab: int) -> bool:
    """K2: 1..MAX_K candidates a row, at most the vocab width; the hidden
    width a multiple of 32 up to MAX_HIDDEN (the rows resident up to 512,
    streamed past it), the vocab width of 8."""
    return (1 <= k <= MAX_K and vocab >= k and hidden % 32 == 0
            and hidden <= MAX_HIDDEN and vocab % 8 == 0)


def topk_project_int8_takes(k: int, hidden: int, vocab: int) -> bool:
    """K2-int8: 1..MAX_K candidates a row, at most the vocab width; the
    hidden width a multiple of 32 at which the H100's block, with its rows
    of h8 resident, holds a ring of at least MIN_STAGES W8 stages
    (``ops/int8_proj.py::s8_stages``, the kernel's formula): up to 1,152."""
    from vidcap_tpu_torch.ops.int8_proj import MIN_STAGES, s8_stages
    return (1 <= k <= MAX_K and vocab >= k and hidden % 32 == 0
            and s8_stages(hidden) >= MIN_STAGES)


def rollout_shape_ok(embed: int, hidden: int, attn: int, vocab: int,
                     sms: int) -> bool:
    """K3's widths on a card of ``sms`` SMs: embedding, hidden and
    attention multiples of 32, hidden and attention at most MAX_WIDTH, the
    vocab a multiple of 8; 2·ROWS..MAX_GRID SMs holding HID hidden columns
    each."""
    return (hidden % 32 == 0 and attn % 32 == 0 and embed % 32 == 0
            and vocab % 8 == 0 and max(hidden, attn) <= MAX_WIDTH
            and 2 * ROWS <= sms <= MAX_GRID and hidden <= HID * sms)


def rollout_takes(embed: int, hidden: int, attn: int, vocab: int,
                  frames: int, sms: int = H100_SMS,
                  smem: int = H100_SMEM) -> bool:
    """K3: :func:`rollout_shape_ok`, and a block's shared memory with W_out
    streamed (the smaller mode) within ``smem``."""
    from vidcap_tpu_torch.ops.rollout import rollout_smem_bytes
    return (rollout_shape_ok(embed, hidden, attn, vocab, sms)
            and rollout_smem_bytes(False, vocab, embed, hidden, attn, frames,
                                   sms) <= smem)


def teacher_forced_takes(hidden: int, attn: int, frames: int,
                         vocab: int) -> bool:
    """K4: hidden and attention widths multiples of 8 (16-byte rows of
    bf16 keys and values) up to TF_MAX_WIDTH, 1..TF_MAX_FRAMES frames, the
    vocab width a multiple of 4 (the logits kernels' 16-byte columns)."""
    return (hidden % 8 == 0 and attn % 8 == 0
            and max(hidden, attn) <= TF_MAX_WIDTH
            and 1 <= frames <= TF_MAX_FRAMES and vocab % 4 == 0)


def silu_mul_takes(width: int) -> bool:
    """K5's activation: each half of a row (``width`` columns) a multiple
    of 8, in 16-byte vectors."""
    return width > 0 and width % 8 == 0


def moe_takes(k: int, experts: int, hidden: int) -> bool:
    """K5's dispatch and combine: 1..MOE_MAX_K of 1..MOE_MAX_EXPERTS
    experts a token, the hidden width a multiple of 8 (16-byte rows)."""
    return (1 <= k <= MOE_MAX_K and 1 <= experts <= MOE_MAX_EXPERTS
            and hidden > 0 and hidden % 8 == 0)
