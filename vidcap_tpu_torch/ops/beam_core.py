"""K1: one beam step's recurrent core, as a Hopper kernel (csrc/beam_core.cu).

Replaces ``vidcap_tpu/ops/pallas_beam_core.py::beam_core`` (body
``_beam_core_kernel``). For B videos × K beams, rows video-major (row b·K+k is
video b's beam k):

    q = bf16(h·Wq); s = bf16(tanh(bf16(keys + q))); scores = Σ_A s·bf16(u)
    attn = softmax_T(scores, masked frames −1e30); ctx = Σ_T bf16(attn)·values
    gates = bf16([emb; ctx; h])·Wg + bg
    c' = σ(f+1)·c + σ(i)·tanh(g);  h' = σ(o)·tanh(c')

:func:`beam_core` launches the kernel for CUDA tensors and runs
:func:`beam_core_plain` for CPU tensors; it never falls back from one to the
other.
"""
from __future__ import annotations

from typing import Tuple

import torch

from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.ops.cell import attention_beam, lstm_update, rnd
from vidcap_tpu_torch.ops.limits import MAX_BEAM, beam_core_takes


def beam_core_plain(emb, h, c, keys, values, frame_mask, wq, u, wg, bg,
                    beam_width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """PyTorch version of the kernel. Rounds to ``wq.dtype`` where the kernel
    rounds to bf16 (pass f32 weights for an all-f32 reference)."""
    cd = wq.dtype
    BK, H = h.shape
    B = keys.shape[0]
    q = rnd(rnd(h, cd) @ wq.float(), cd).reshape(B, beam_width, -1)
    ctx = attention_beam(q, keys, values, frame_mask.float(), u.float(), cd)
    xh = rnd(torch.cat([emb.float(), ctx.reshape(BK, H), h.float()], -1), cd)
    return lstm_update(xh @ wg.float() + bg.float(), c.float())


def beam_core(emb, h, c, keys, values, frame_mask, wq, u, wg, bg,
              beam_width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """emb f32[B·K, E], h/c f32[B·K, H], keys bf16[B, T, A], values
    bf16[B, T, H], frame_mask f32[B, T], wq bf16[H, A], u f32[A],
    wg bf16[E+2H, 4H], bg f32[4H] → (h', c') f32[B·K, H]."""
    if not h.is_cuda:
        return beam_core_plain(emb, h, c, keys, values, frame_mask, wq, u,
                               wg, bg, beam_width)
    K = beam_width
    BK, E = emb.shape
    H = h.shape[1]
    B, T, A = keys.shape
    if BK != B * K or not 1 <= K <= MAX_BEAM:
        raise ValueError(f"beam_core: {BK} rows for {B} videos × beam {K} "
                         f"(beam must be in 1..{MAX_BEAM})")
    if not beam_core_takes(K, E, H, A):
        raise ValueError(f"beam_core: hidden {H} and attention {A} widths "
                         f"must be multiples of 32 and embedding {E} of 8")
    f32, bf16 = torch.float32, torch.bfloat16
    _build.require("beam_core", (
        (emb, "emb", f32, (BK, E)), (h, "h", f32, (BK, H)),
        (c, "c", f32, (BK, H)), (keys, "keys", bf16, (B, T, A)),
        (values, "values", bf16, (B, T, H)),
        (frame_mask, "frame_mask", f32, (B, T)), (wq, "wq", bf16, (H, A)),
        (u, "u", f32, (A,)), (wg, "wg", bf16, (E + 2 * H, 4 * H)),
        (bg, "bg", f32, (4 * H,))))
    fn = _build.entry("beam_core", 14, 6)
    # scratch: the gate GEMM's A operand bf16([emb; ctx; h]) and q (bf16)
    buf, (xh, q) = _build.scratch(h.device, (BK * (E + 2 * H) * 2, BK * A * 2))
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    err = fn(emb.data_ptr(), h.data_ptr(), c.data_ptr(), keys.data_ptr(),
             values.data_ptr(), frame_mask.data_ptr(), wq.data_ptr(),
             u.data_ptr(), wg.data_ptr(), bg.data_ptr(), xh, q,
             h_out.data_ptr(), c_out.data_ptr(), B, K, T, E, H, A,
             torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "beam_core")
    _build.count_launch("beam_core")
    return h_out, c_out
