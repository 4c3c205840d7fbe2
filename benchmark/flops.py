"""The yardstick's arithmetic, frozen here so that no change to the program
moves it: the H100's data-sheet peaks, each kernel's operations and bytes
(every input read once, every output written once, every product once a
row and a step), and the model FLOPs a decode or a training step needs.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
"""
from __future__ import annotations

PEAK_BF16 = 989e12     # FLOP/s, bf16 dense tensor cores
PEAK_BYTES = 3.35e12   # bytes/s, HBM3


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: operations or bytes, whichever
    bounds."""
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES)


def step_flops_per_row(E: int, H: int, A: int, T: int, Vp: int) -> int:
    """One decoder step of one row: the attention query, the scores and the
    context over T frames, the fused LSTM gates on [emb; ctx; h], and the
    vocab projection."""
    return 2 * (H * A + T * A + T * H + (E + 2 * H) * 4 * H + H * Vp)


def init_flops_per_video(D: int, H: int, A: int, T: int) -> int:
    """``init_state`` of one video: the feature projection of T frames, the
    attention keys, and h0/c0 from the pooled projection."""
    return 2 * (T * D * H + T * H * A + H * 2 * H)


def k1_bytes(rows: int, videos: int, E: int, H: int, A: int, T: int) -> int:
    """K1 ``beam_core`` a launch: the embeddings, h and c in (f32), h' and
    c' out (f32), the per-video keys and values (bf16) and frame mask
    (f32), W_q and the fused gate weights (bf16), u and the gate bias."""
    return (rows * (E + 4 * H) * 4 + videos * T * (A + H) * 2 + videos * T * 4
            + H * A * 2 + A * 4 + (E + 2 * H) * 4 * H * 2 + 4 * H * 4)


def k1_flops(rows: int, E: int, H: int, A: int, T: int) -> int:
    return 2 * rows * ((E + 2 * H) * 4 * H + H * A + T * A + T * H)


def k2_flops(rows: int, H: int, Vp: int) -> int:
    """K2 ``topk_project`` a launch: the vocab projection."""
    return 2 * rows * H * Vp


def k2_bytes(rows: int, H: int, Vp: int, K: int) -> int:
    """h in (f32), W_out (bf16) and its bias (f32), K values and K ids out
    a row."""
    return rows * H * 4 + H * Vp * 2 + Vp * 4 + rows * K * 8


def k3_flops(rows: int, steps: int, E: int, H: int, A: int, T: int,
             Vp: int) -> int:
    """K3 ``rollout`` a launch: every product once a row and a step."""
    return 2 * rows * steps * (H * A + (E + 2 * H) * 4 * H + H * Vp
                               + T * A + T * H)


def k3_bytes(rows: int, steps: int, E: int, H: int, A: int, T: int,
             Vp: int) -> int:
    """The gathered embedding rows (bf16), W_q, the gate weights and W_out
    (bf16), u, the gate and vocab biases, the keys and values (bf16), the
    frame mask, h0/c0 (f32), and tokens, log-probs and mask out."""
    return (rows * steps * E * 2 + H * A * 2 + A * 4 + (E + 2 * H) * 4 * H * 2
            + 4 * H * 4 + H * Vp * 2 + Vp * 4 + rows * T * (A + H) * 2
            + rows * T * 4 + 2 * rows * H * 4 + rows * steps * 12)


def beam_decode_flops(videos: int, beam: int, steps: int, D: int, E: int,
                      H: int, A: int, T: int, Vp: int) -> int:
    """Model FLOPs of one beam decode: ``init_state`` a video, then each
    step for every beam of every video."""
    return (videos * init_flops_per_video(D, H, A, T)
            + videos * beam * steps * step_flops_per_row(E, H, A, T, Vp))


def scst_step_flops(rows: int, steps: int, D: int, E: int, H: int, A: int,
                    T: int, Vp: int, attributes: int) -> int:
    """Model FLOPs of one SCST step as the algorithm needs them: the
    encoding (``init_state``) once, forward and backward (x3); the greedy
    rollout's steps forward; the sampled rollout's steps forward and
    backward (x3); the teacher-forced XE anchor's steps forward and
    backward (x3); the attribute head forward and backward (x3). The
    re-score of the sampled tokens and the encodings that each pass
    repeats recompute work and are not counted again."""
    init = rows * init_flops_per_video(D, H, A, T)
    seq = rows * steps * step_flops_per_row(E, H, A, T, Vp)
    attr = 2 * rows * (H * H + H * attributes)
    return 3 * init + seq + 3 * seq + 3 * seq + 3 * attr
