"""K2's split-vocab decomposition on the CPU.

The Hopper kernel (``vidcap_tpu_torch/csrc/topk_project.cu``) splits the
vocab into contiguous chunks of 128-column tiles, carries a running max,
exp-sum and top-K over each chunk, and merges the chunks.
``topk_project_chunked_plain`` is that decomposition in PyTorch; here it is
held to ``topk_project_plain`` (one pass over the whole row) on numpy-seeded
inputs: the same columns, values within 1e-6. The chunk layout the kernel
picks (``chunk_layout``) is checked against the SM count it is given.
"""
import numpy as np
import pytest
import torch

from vidcap_tpu_torch.ops.topk_project import (TILE_N, chunk_layout,
                                               topk_project_chunked_plain,
                                               topk_project_plain)


def _inputs(N, H, Vp, seed, scale=0.1):
    g = np.random.default_rng(seed)
    h = g.normal(size=(N, H))
    w = g.normal(size=(H, Vp)) * scale
    b = g.normal(size=Vp) * scale
    return h, w, b


def _check(h, w, b, K, vocab, chunk_cols, dtype=torch.bfloat16):
    ht = torch.tensor(h, dtype=torch.float32)
    wt = torch.tensor(w, dtype=torch.float32).to(dtype)
    bt = torch.tensor(b, dtype=torch.float32)
    v_p, i_p = topk_project_plain(ht, wt, bt, K, vocab)
    v_c, i_c = topk_project_chunked_plain(ht, wt, bt, K, vocab, chunk_cols)
    assert i_c.dtype == i_p.dtype == torch.int32
    assert torch.equal(i_c, i_p)
    assert (v_c - v_p).abs().max().item() <= 1e-6
    return i_c


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("Vp,chunk_cols", [
    (512, 512),          # one chunk
    (1024, 128),         # many chunks of one tile
    (1024, 256),         # many chunks of two tiles
    (1000, 256),         # a ragged last chunk (232 columns)
    (264, 128),          # a last chunk of 8 columns, as in a ragged tile
])
def test_chunked_matches_one_pass(Vp, chunk_cols, K):
    h, w, b = _inputs(12, 64, Vp, seed=Vp + chunk_cols + K)
    _check(h, w, b, K, Vp, chunk_cols)


@pytest.mark.parametrize("K", [1, 5, 8])
@pytest.mark.parametrize("start", [124, 250, 380])
def test_chunk_boundary_inside_a_run_of_tied_columns(start, K):
    """Columns start..start+7 share one column of W and one bias, so their
    logits tie; the run straddles the chunk boundary at a multiple of 128.
    The tied run is the rows' maximum, so the top-K is its first K columns,
    and both versions take them smallest first."""
    Vp, N, H = 512, 10, 32
    h, w, b = _inputs(N, H, Vp, seed=start + K)
    h = np.abs(h)
    w[:, start:start + 8] = np.abs(w[:, 7:8]) + 1.0   # the same, large column
    b[start:start + 8] = b[7]
    i = _check(h, w, b, K, Vp, 128)
    expect = torch.arange(start, start + K, dtype=torch.int32)
    assert (i == expect).all()


@pytest.mark.parametrize("K", [1, 8])
def test_padding_columns_fill_whole_chunks(K):
    """vocab_size < Vp: the columns past vocab_size are −1e30 and whole
    chunks of them hold no pick, but their exp-sum still merges (to 0)."""
    h, w, b = _inputs(9, 64, 1024, seed=11 + K)
    i = _check(h, w, b, K, 300, 128)
    assert (i < 300).all()


def test_all_equal_logits_give_the_first_columns():
    """Every logit equal: the first K columns, across any chunking (the
    cross-chunk merge keeps the smaller column on a tie)."""
    h = np.zeros((4, 32))
    w = np.zeros((32, 640))
    b = np.zeros(640)
    for chunk_cols in (128, 256, 640):
        i = _check(h, w, b, 8, 640, chunk_cols)
        assert (i == torch.arange(8, dtype=torch.int32)).all()


def test_f32_weights_chunked_matches_one_pass():
    h, w, b = _inputs(7, 64, 640, seed=5)
    _check(h, w, b, 6, 600, 256, dtype=torch.float32)


@pytest.mark.parametrize("N,Vp,sms,expect", [
    (920, 16_000, 132, (8, 16)),    # msrvtt_attn_beam5: 8 row tiles x 16
    (16, 256, 132, (1, 2)),         # fewer tiles than SMs: a tile a chunk
    (70, 512, 132, (1, 4)),
    (24, 264, 132, (1, 3)),         # a ragged last tile is a chunk too
    (4000, 16_000, 132, (32, 4)),   # 32 row tiles x 4 chunks
    (17_000, 16_000, 132, (125, 1)),   # more row tiles than SMs: one chunk
])
def test_chunk_layout(N, Vp, sms, expect):
    per_chunk, n_chunks = chunk_layout(N, Vp, sms)
    assert (per_chunk, n_chunks) == expect
    n_tiles = -(-Vp // TILE_N)
    assert (n_chunks - 1) * per_chunk < n_tiles <= n_chunks * per_chunk
