"""The int8 vocab projection of the beam step (``decode.int8_vocab_projection``)
and K2's int8 variant, a Hopper kernel (csrc/topk_project.cu,
``vidcap_topk_project_int8``).

The JAX package computes these logits in XLA
(``vidcap_tpu/ops/int8_proj.py``: ``quantize_out_proj``, ``int8_logits``;
no Pallas kernel) and hands them to its beam's top-K. Symmetric
per-column weight quantization, done once::

    wscale = max(max_h |W[:, v]|, 1e-8) / 127
    W8 = clip(round(W / wscale), -127, 127)          (int8)
    bq = b, with columns >= vocab_size at -1e30

and per-row activation quantization, each step::

    hscale = max|h| / 127
    h8 = clip(round(h / max(hscale, 1e-8)), -127, 127)   (round half to even)
    logits = bf16(f32(h8 · W8) * (hscale * wscale) + bq)

The int32 sums are exact. On the card the logits never reach memory: K2's
int8 variant quantizes the rows, runs the s8 × s8 → s32 product (TMA and
``wgmma`` on 128-row tiles) and, after each tile's product, the rounding
chain and K2's running max, exp-sum and top-K over vocab chunks, and
merges the chunks. :func:`topk_project_int8` launches it for CUDA tensors
and runs :func:`int8_topk_project_plain` for CPU tensors; it never falls
back. It takes the hidden widths at which a block's shared memory holds
a ring of at least MIN_STAGES W8 stages (:func:`s8_stages`, the kernel's
``s8_stages``): multiples of 32 up to 1,152 on the H100.

Not bit-identical to the bf16 projection: the weight rounding moves logits
by ~1e-2, which flips most beam captions on random weights and few on
trained ones (the JAX package's docstring), so the flag is off by default.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.ops.cell import NEG
from vidcap_tpu_torch.ops.limits import H100_SMEM, topk_project_int8_takes
from vidcap_tpu_torch.ops.topk_project import (MAX_K, _sm_count,
                                               chunk_layout, logits_topk,
                                               logits_topk_chunked)

TILE_ROWS = 128   # rows per block of the int8 chunk kernel
# The kernel's shared memory (csrc/topk_project.cu: kS8*, s8_stages,
# s8_smem): the block's rows of h8 in boxes of DEPTH_BOX bytes of depth
# (TILE_ROWS x DEPTH_BOX each), a ring of W8 stages of 128 columns x
# DEPTH_BOX bytes, and FIXED bytes (alignment slack, the wscale/bq side
# ring of 4 tiles, barriers). The ring holds two tiles' stages,
# MIN_STAGES..MAX_STAGES, as far as the H100's H100_SMEM (kS8SmemCap)
# allows; fewer than MIN_STAGES, and the kernel refuses.
DEPTH_BOX = 128
STAGE_BYTES = 128 * DEPTH_BOX
MIN_STAGES, MAX_STAGES = 4, 8
FIXED = 1024 + 4 * 2 * 128 * 4 + 256


def s8_stages(hidden: int) -> int:
    """The ring's stages at ``hidden`` (the kernel's ``s8_stages``)."""
    boxes = -(-hidden // DEPTH_BOX)
    fit = (H100_SMEM - FIXED - boxes * TILE_ROWS * DEPTH_BOX) // STAGE_BYTES
    return min(min(MAX_STAGES, max(MIN_STAGES, 2 * boxes)), fit)


def s8_smem_bytes(hidden: int) -> int:
    """Dynamic shared memory a block of the kernel needs at ``hidden``
    (the kernel's ``s8_smem``), with at least MIN_STAGES ring stages."""
    boxes = -(-hidden // DEPTH_BOX)
    return (FIXED + boxes * TILE_ROWS * DEPTH_BOX
            + max(s8_stages(hidden), MIN_STAGES) * STAGE_BYTES)


def _div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 by IEEE division on any device: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which rounds differently."""
    return x / torch.full_like(x, 127.0)


def quantize_out_proj(kernel: torch.Tensor, bias: Optional[torch.Tensor],
                      vocab_size: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """out_proj's kernel f32[H, Vp] and bias → (W8 int8[H, Vp], wscale
    f32[Vp], bq f32[Vp]) with ``W8[h, v] · wscale[v] ≈ W[h, v]`` and the
    padding columns' −1e30 folded into ``bq``."""
    W = kernel.detach().float()
    wscale = _div127(torch.clamp(W.abs().amax(0), min=1e-8))
    W8 = torch.clamp(torch.round(W / wscale), -127, 127).to(torch.int8)
    Vp = W.shape[1]
    b = (torch.zeros(Vp, device=W.device) if bias is None
         else bias.detach().float())
    col = torch.arange(Vp, device=W.device)
    return W8, wscale, torch.where(col < vocab_size, b,
                                   torch.full_like(b, NEG))


@dataclasses.dataclass
class Int8Projection:
    """The quantized projection in K2-int8's layout: ``w8t`` int8[Vp, H]
    (W8 transposed: each vocab column's H values contiguous, the K-major B
    operand of the s8 ``wgmma``), ``wscale`` and ``bq`` f32[Vp]."""

    w8t: torch.Tensor
    wscale: torch.Tensor
    bq: torch.Tensor

    @classmethod
    def from_dense(cls, dense, vocab_size: int) -> "Int8Projection":
        """Quantize a ``Dense`` (the decoder's ``out_proj``) once."""
        W8, wscale, bq = quantize_out_proj(dense.kernel, dense.bias,
                                           vocab_size)
        return cls(w8t=W8.t().contiguous(), wscale=wscale.contiguous(),
                   bq=bq.contiguous())


def quantize_rows(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """h [N, H] → (h8 int8[N, H], hscale f32[N]): the per-row quantization,
    with the scale unguarded (the guard only keeps the division finite)."""
    h = h.float()
    hscale = _div127(h.abs().amax(-1))
    h8 = torch.clamp(torch.round(h / torch.clamp(hscale, min=1e-8)[:, None]),
                     -127, 127).to(torch.int8)
    return h8, hscale


def int8_sums(h8: torch.Tensor, w8t: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums h8 · W8 (h8 int8[N, H], w8t int8[Vp, H]),
    through float64, whose 53-bit significand holds every partial sum
    (|sum| ≤ 127² · H) on any device."""
    return (h8.double() @ w8t.double().t()).to(torch.int32)


def int8_logits_plain(h, proj: Int8Projection) -> torch.Tensor:
    """``bf16(f32(h8 · W8) · (hscale · wscale) + bq)`` as f32[N, Vp], the
    JAX package's ``int8_logits`` rounding for rounding."""
    h8, hscale = quantize_rows(h)
    acc = int8_sums(h8, proj.w8t)
    return (acc.float() * (hscale[:, None] * proj.wscale) + proj.bq
            ).to(torch.bfloat16).float()


def int8_topk_project_plain(h, proj: Int8Projection, K: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PyTorch version of K2-int8: :func:`logits_topk` of the int8 logits."""
    return logits_topk(int8_logits_plain(h, proj), K)


def int8_topk_project_chunked_plain(h, proj: Int8Projection, K: int,
                                    chunk_cols: int
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`int8_topk_project_plain` by the kernel's split-vocab
    decomposition (``topk_project.logits_topk_chunked``)."""
    return logits_topk_chunked(int8_logits_plain(h, proj), K, chunk_cols)


def topk_project_int8(h, proj: Int8Projection, K: int,
                      return_quantized: bool = False):
    """h f32[N, H] → (logp f32[N, K], idx i32[N, K]), best first, over the
    int8 logits; with ``return_quantized`` also (h8 int8[N, H], hscale
    f32[N]), the rows as the kernel quantized them (on the CPU, as
    :func:`quantize_rows` does)."""
    if not h.is_cuda:
        out = int8_topk_project_plain(h, proj, K)
        return out + quantize_rows(h) if return_quantized else out
    N, H = h.shape
    Vp = proj.w8t.shape[0]
    if not 1 <= K <= MAX_K or Vp < K:
        raise ValueError(f"topk_project_int8: K={K} must be in 1..{MAX_K} "
                         f"and at most the vocab width {Vp}")
    if not topk_project_int8_takes(K, H, Vp):
        raise ValueError(f"topk_project_int8: hidden width {H} must be a "
                         "multiple of 32 whose shared memory "
                         f"({s8_smem_bytes(H)} bytes) fits in a block")
    _build.require("topk_project_int8", (
        (h, "h", torch.float32, (N, H)),
        (proj.w8t, "w8t", torch.int8, (Vp, H)),
        (proj.wscale, "wscale", torch.float32, (Vp,)),
        (proj.bq, "bq", torch.float32, (Vp,))))
    fn = _build.entry("topk_project_int8", 12, 6)
    dev = h.device
    per_chunk, n_chunks = chunk_layout(N, Vp, _sm_count(dev), TILE_ROWS)
    nc = N * n_chunks
    buf, (h8p, hsp, cmax, csum, cval, ccol) = _build.scratch(
        dev, (N * H, N * 4, nc * 4, nc * 4, nc * K * 4, nc * K * 4))
    vals = torch.empty(N, K, device=dev, dtype=torch.float32)
    idx = torch.empty(N, K, device=dev, dtype=torch.int32)
    err = fn(h.data_ptr(), proj.w8t.data_ptr(), proj.wscale.data_ptr(),
             proj.bq.data_ptr(), h8p, hsp, cmax, csum, cval, ccol,
             vals.data_ptr(), idx.data_ptr(), N, H, Vp, K, per_chunk,
             n_chunks, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "topk_project_int8")
    _build.count_launch("topk_project_int8", K)
    if not return_quantized:
        return vals, idx
    h8 = buf[:N * H].view(torch.int8).view(N, H)
    off = hsp - buf.data_ptr()
    hscale = buf[off:off + N * 4].view(torch.float32)
    return vals, idx, h8, hscale
