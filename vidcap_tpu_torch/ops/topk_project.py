"""K2: vocab projection + padding mask + per-row top-K + logsumexp, as a
Hopper kernel (csrc/topk_project.cu).

Replaces ``vidcap_tpu/ops/pallas_topk.py::topk_project`` (body ``_kernel``,
``_merge_topk``). For N rows:

    logits = f32(bf16(bf16(h)·W_out) + bf16(b_out)); columns ≥ vocab_size −1e30
    lse = m + log(max(Σ exp(logits − m), 1e-30))
    returns (top-K logits − lse) f32[N, K] and their columns i32[N, K]

Ties go to the smallest column, as ``lax.top_k`` and the iterative
max-extract do. The [N, Vp] logits never reach device memory.

:func:`topk_project` launches the kernel for CUDA tensors and runs
:func:`topk_project_plain` for CPU tensors; it never falls back.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vidcap_tpu_torch.models.decoder import NEG, rnd
from vidcap_tpu_torch.ops import _build

MAX_K = 8
TILE_N = 128   # vocab columns per projection tile (csrc/projection.cuh)


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
    if H % 32 or Vp % 8:
        raise ValueError(f"topk_project: hidden width {H} must be a multiple "
                         f"of 32 and vocab width {Vp} a multiple of 8")
    for t, name, dt, shape in ((h, "h", torch.float32, (N, H)),
                               (w_out, "w_out", torch.bfloat16, (H, Vp)),
                               (b_out, "b_out", torch.float32, (Vp,))):
        if not t.is_cuda or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"topk_project: {name} must be a contiguous "
                             f"CUDA {dt} tensor of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    lib = _build.load("topk_project")
    fn = lib.vidcap_topk_project
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_tiles = (Vp + TILE_N - 1) // TILE_N
    dev = h.device
    tile_max = torch.empty(N, n_tiles, device=dev, dtype=torch.float32)
    tile_sum = torch.empty(N, n_tiles, device=dev, dtype=torch.float32)
    tile_v = torch.empty(N, n_tiles, K, device=dev, dtype=torch.float32)
    tile_i = torch.empty(N, n_tiles, K, device=dev, dtype=torch.int32)
    vals = torch.empty(N, K, device=dev, dtype=torch.float32)
    idx = torch.empty(N, K, device=dev, dtype=torch.int32)
    err = fn(h.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
             tile_max.data_ptr(), tile_sum.data_ptr(), tile_v.data_ptr(),
             tile_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
             N, H, Vp, K, vocab_size,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "topk_project")
    _build.launch_counts["topk_project"] += 1
    return vals, idx
