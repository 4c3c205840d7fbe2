"""K2: vocab projection + padding mask + per-row top-K + logsumexp, as a
Hopper kernel (csrc/topk_project.cu).

Replaces ``vidcap_tpu/ops/pallas_topk.py::topk_project`` (body ``_kernel``,
``_merge_topk``). For N rows:

    logits = f32(bf16(bf16(h)·W_out) + bf16(b_out)); columns ≥ vocab_size −1e30
    lse = m + log(max(Σ exp(logits − m), 1e-30))
    returns (top-K logits − lse) f32[N, K] and their columns i32[N, K]

Ties go to the smallest column, as ``lax.top_k`` and the iterative
max-extract do. The [N, Vp] logits never reach device memory: the kernel
splits the vocab into contiguous chunks of 128-column tiles, carries a
running max, exp-sum and top-K over each chunk, and merges the chunks
(:func:`topk_project_chunked_plain` is that decomposition in PyTorch).

:func:`topk_project` launches the kernel for CUDA tensors and runs
:func:`topk_project_plain` for CPU tensors; it never falls back.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.ops.cell import NEG, rnd
from vidcap_tpu_torch.ops.limits import (MAX_HIDDEN, MAX_K,
                                         topk_project_takes)

TILE_N = 128   # vocab columns per projection tile (csrc/projection.cuh)
TILE_ROWS = 128   # rows per block of K2's product (csrc/projection.cuh)


def per_row_topk_iterative(x: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k by k max-extract passes; ties to the smallest index
    (``argmax`` returns the first maximum; ``torch.topk`` promises no tie
    order). Returns (values, int32 indices), best first."""
    col = torch.arange(x.shape[-1], device=x.device)
    cur = x
    vals, idxs = [], []
    for _ in range(k):
        v, a = cur.max(-1)   # the first maximum's index
        vals.append(v)
        idxs.append(a)
        cur = torch.where(col == a[..., None], -torch.inf, cur)
    return torch.stack(vals, -1), torch.stack(idxs, -1).to(torch.int32)


def logits_topk(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 logits [N, V] → (top-k log-softmax values, int32 columns)."""
    m = logits.max(-1, keepdim=True).values
    s = torch.exp(logits - m).sum(-1, keepdim=True)
    lse = m + torch.log(torch.clamp(s, min=1e-30))
    vals, idx = per_row_topk_iterative(logits, k)
    return vals - lse, idx


def masked_logits(h, w_out, b_out, vocab_size: int) -> torch.Tensor:
    """f32(bf16(bf16(h)·W_out) + bf16(b_out)) with columns ≥ vocab_size at
    −1e30, rounding to ``w_out.dtype`` where the kernels round to bf16 (all
    f32 for f32 weights)."""
    cd = w_out.dtype
    logits = rnd(rnd(rnd(h, cd) @ w_out.float(), cd) + rnd(b_out, cd), cd)
    col = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(col < vocab_size, logits, torch.full_like(logits, NEG))


def topk_project_plain(h, w_out, b_out, K: int, vocab_size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PyTorch version of the kernel. Rounds to ``w_out.dtype`` where the
    kernel rounds to bf16 (pass f32 weights for an all-f32 reference)."""
    return logits_topk(masked_logits(h, w_out, b_out, vocab_size), K)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def chunk_layout(n_rows: int, vp: int, sms: int,
                 tile_rows: int = TILE_ROWS) -> Tuple[int, int]:
    """(tiles per chunk, chunks) of K2's split-vocab grid: ``tile_rows``-row
    tiles × vocab chunks, as many chunks as fill ``sms`` SMs once, every
    chunk non-empty."""
    n_tiles = -(-vp // TILE_N)
    row_tiles = -(-n_rows // tile_rows)
    chunks = max(1, min(n_tiles, sms // row_tiles))
    per_chunk = -(-n_tiles // chunks)
    return per_chunk, -(-n_tiles // per_chunk)


def topk_project_chunked_plain(h, w_out, b_out, K: int, vocab_size: int,
                               chunk_cols: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_project_plain` by the kernel's split-vocab decomposition
    (:func:`logits_topk_chunked`). The CPU tests hold it equal to the
    one-pass version."""
    return logits_topk_chunked(masked_logits(h, w_out, b_out, vocab_size), K,
                               chunk_cols)


def logits_topk_chunked(logits: torch.Tensor, K: int, chunk_cols: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`logits_topk` by the kernels' split-vocab decomposition: the
    columns in contiguous chunks of ``chunk_cols``; per chunk its max m_c,
    Σ exp(x − m_c) and top-K (ties to the smaller column, fewer than K
    columns padded with (−inf, 2³¹−1)); then lse = m + log(max(Σ_c s_c ·
    exp(m_c − m), 1e-30)) and the top-K of all chunks' candidates by (value
    desc, column asc)."""
    n, vp = logits.shape
    ms, ss, cvs, cis = [], [], [], []
    for c0 in range(0, vp, chunk_cols):
        x = logits[:, c0:c0 + chunk_cols]
        m = x.max(-1).values
        ms.append(m)
        ss.append(torch.exp(x - m[:, None]).sum(-1))
        k = min(K, x.shape[1])
        v, i = per_row_topk_iterative(x, k)
        pad = K - k
        cvs.append(torch.cat([v, torch.full((n, pad), -torch.inf)], 1))
        cis.append(torch.cat([i + c0, torch.full((n, pad), 2 ** 31 - 1,
                                                 dtype=torch.int32)], 1))
    m_c, s_c = torch.stack(ms, 1), torch.stack(ss, 1)
    m = m_c.max(-1).values
    lse = m + torch.log(torch.clamp(
        (s_c * torch.exp(m_c - m[:, None])).sum(-1), min=1e-30))
    cand_v, cand_i = torch.cat(cvs, 1), torch.cat(cis, 1)
    # (value desc, column asc): sort by column, then stably by value
    by_col = torch.argsort(cand_i, dim=-1, stable=True)
    cand_v, cand_i = cand_v.gather(1, by_col), cand_i.gather(1, by_col)
    best = torch.argsort(-cand_v, dim=-1, stable=True)[:, :K]
    return cand_v.gather(1, best) - lse[:, None], cand_i.gather(1, best)


def topk_project(h, w_out, b_out, K: int, vocab_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h f32[N, H]; w_out bf16[H, Vp]; b_out f32[Vp] → (logp f32[N, K],
    idx i32[N, K]), best first."""
    if not h.is_cuda:
        return topk_project_plain(h, w_out, b_out, K, vocab_size)
    N, H = h.shape
    Vp = w_out.shape[1]
    if not 1 <= K <= MAX_K or Vp < K:
        raise ValueError(f"topk_project: K={K} must be in 1..{MAX_K} and at "
                         f"most the vocab width {Vp}")
    if not topk_project_takes(K, H, Vp):
        raise ValueError(f"topk_project: hidden width {H} must be a multiple "
                         f"of 32 and at most {MAX_HIDDEN}, and vocab width "
                         f"{Vp} a multiple of 8")
    _build.require("topk_project", (
        (h, "h", torch.float32, (N, H)),
        (w_out, "w_out", torch.bfloat16, (H, Vp)),
        (b_out, "b_out", torch.float32, (Vp,))))
    fn = _build.entry("topk_project", 10, 7)
    dev = h.device
    per_chunk, n_chunks = chunk_layout(N, Vp, _sm_count(dev))
    # scratch: bf16(h) (cast once a step), per (row, chunk) max and exp-sum
    # f32, and top-K values f32 and columns i32
    nc = N * n_chunks
    buf, (h16, cmax, csum, cval, ccol) = _build.scratch(
        dev, (N * H * 2, nc * 4, nc * 4, nc * K * 4, nc * K * 4))
    vals = torch.empty(N, K, device=dev, dtype=torch.float32)
    idx = torch.empty(N, K, device=dev, dtype=torch.int32)
    err = fn(h.data_ptr(), w_out.data_ptr(), b_out.data_ptr(), h16, cmax,
             csum, cval, ccol, vals.data_ptr(), idx.data_ptr(), N, H, Vp, K,
             vocab_size, per_chunk, n_chunks,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "topk_project")
    _build.count_launch("topk_project", K)
    return vals, idx
