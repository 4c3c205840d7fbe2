"""The PyTorch port's kernel modules against the JAX Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; the JAX kernels run
in interpret mode, as tests/test_pallas_beam_core.py and
tests/test_pallas_topk.py run them. The same numpy inputs go to both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidcap_tpu.ops.pallas_beam_core import beam_core as jax_beam_core
from vidcap_tpu.ops.pallas_topk import topk_project as jax_topk_project
from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.ops.beam_core import beam_core, beam_core_plain
from vidcap_tpu_torch.ops.topk_project import (topk_project,
                                               topk_project_plain)


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _beam_core_inputs(B=4, K=3, T=8, E=32, H=32, A=32, seed=0):
    g = np.random.default_rng(seed)
    mask = np.ones((B, T), np.float32)
    mask[1, T // 2:] = 0.0          # masked tail frames
    mask[2, :] = 0.0                # a video with no real frame
    return dict(
        emb=g.normal(size=(B * K, E)).astype(np.float32),
        h=np.tanh(g.normal(size=(B * K, H))).astype(np.float32),
        c=g.normal(size=(B * K, H)).astype(np.float32),
        keys=g.normal(size=(B, T, A)).astype(np.float32),
        values=g.normal(size=(B, T, H)).astype(np.float32),
        frame_mask=mask,
        wq=(g.normal(size=(H, A)) / np.sqrt(H)).astype(np.float32),
        u=(g.normal(size=(A,)) * 0.05).astype(np.float32),
        wg=(g.normal(size=(E + 2 * H, 4 * H)) / np.sqrt(E + 2 * H)
            ).astype(np.float32),
        bg=(g.normal(size=(4 * H,)) * 0.1).astype(np.float32)), K


def _torch_beam_core_args(x):
    bf = {"keys", "values", "wq", "wg"}
    return {k: torch.tensor(v, dtype=torch.bfloat16 if k in bf else
                            torch.float32) for k, v in x.items()}


def test_plain_beam_core_matches_pallas():
    """Tolerance 2e-2 on h'/c': both sides round at the same bf16 points, but
    XLA's tanh and the f32 sums run in another order, so a value next to a
    rounding boundary of q or of the tanh input/output can land one bf16 ulp
    apart and carry through the softmax and the gate product (the bound
    tests/test_pallas_beam_core.py uses for the same kernel)."""
    x, K = _beam_core_inputs()
    h_j, c_j = jax_beam_core(*(jnp.asarray(v) for v in x.values()),
                             beam_width=K, interpret=True)
    h_t, c_t = beam_core_plain(**_torch_beam_core_args(x), beam_width=K)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=2e-2)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=2e-2)
    # most values agree far more tightly than the bound
    assert np.median(np.abs(h_t.numpy() - np.asarray(h_j))) < 1e-4


def test_beam_core_wrapper_runs_plain_on_cpu():
    """A CPU tensor takes the plain version, and no kernel launch is
    counted."""
    x, K = _beam_core_inputs(seed=1)
    args = _torch_beam_core_args(x)
    before = dict(_build.launch_counts)
    h_w, c_w = beam_core(**args, beam_width=K)
    h_p, c_p = beam_core_plain(**args, beam_width=K)
    assert torch.equal(h_w, h_p) and torch.equal(c_w, c_p)
    assert _build.launch_counts == before


def _topk_inputs(N, H, Vp, seed=0):
    g = np.random.default_rng(seed)
    return (g.normal(size=(N, H)).astype(np.float32),
            (g.normal(size=(H, Vp)) * 0.1).astype(np.float32),
            (g.normal(size=(Vp,)) * 0.1).astype(np.float32))


def _check_topk_vs_pallas(h, w, b, K, vocab):
    """Values within one bf16 ulp of the row's largest logit (+1e-4 for the
    f32 lse, whose exp-sums run in another order): interpret mode on the CPU
    keeps some of the kernel's bf16 roundings in f32 (XLA's excess
    precision), the port rounds them all. Where the K-th and (K+1)-th values
    are further apart than that, the two index sets are equal; closer, a
    one-ulp difference may legitimately swap them, and may reorder near-ties
    inside the top K."""
    v_j, i_j = jax_topk_project(jnp.asarray(h), jnp.asarray(w),
                                jnp.asarray(b), K=K, vocab_size=vocab,
                                interpret=True)
    v_j, i_j = np.asarray(v_j), np.asarray(i_j)
    ht = torch.tensor(h)
    wt = torch.tensor(w, dtype=torch.bfloat16)
    v_t, i_t = topk_project_plain(ht, wt, torch.tensor(b), K, vocab)
    v_t, i_t = v_t.numpy(), i_t.numpy()
    v_k1, _ = topk_project_plain(ht, wt, torch.tensor(b), K + 1, vocab)
    v_k1 = v_k1.numpy()
    logits = h @ wt.float().numpy()
    tol = bf16_ulp(np.abs(logits).max(axis=1)) + 1e-4
    np.testing.assert_allclose(v_t, v_j, atol=float(tol.max()))
    clear = v_k1[:, K - 1] - v_k1[:, K] > tol
    assert clear.mean() > 0.5
    for r in np.flatnonzero(clear):
        assert set(i_t[r]) == set(i_j[r]), (r, i_t[r], i_j[r])
    return i_t, i_j


@pytest.mark.parametrize("N,H,Vp,vocab,K", [
    (16, 64, 256, 200, 5),      # vocab_size < Vp: padding columns masked
    (8, 32, 512, 512, 3),
    (16, 64, 384, 300, 6),      # K+1 = 6, what the finished pool will need
])
def test_plain_topk_project_matches_pallas(N, H, Vp, vocab, K):
    h, w, b = _topk_inputs(N, H, Vp)
    i_t, _ = _check_topk_vs_pallas(h, w, b, K, vocab)
    assert (i_t < vocab).all()


def test_plain_topk_project_duplicate_columns_tie_to_smallest_index():
    """All-equal logits: both pick columns 0..K-1 (ties to the smallest
    index). Duplicated W_out columns give exact ties, resolved the same way."""
    zeros = np.zeros((8, 32), np.float32)
    v_j, i_j = jax_topk_project(jnp.zeros((8, 32)), jnp.zeros((32, 256)),
                                jnp.zeros((256,)), K=5, vocab_size=256,
                                interpret=True)
    v_t, i_t = topk_project_plain(torch.tensor(zeros),
                                  torch.zeros(32, 256, dtype=torch.bfloat16),
                                  torch.zeros(256), 5, 256)
    np.testing.assert_array_equal(i_t.numpy(), np.tile(np.arange(5), (8, 1)))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-6)

    h, w, b = _topk_inputs(16, 64, 256, seed=3)
    w[:, 1::2] = w[:, 0::2]
    b[1::2] = b[0::2]
    i_t, i_j = _check_topk_vs_pallas(h, w, b, 4, 256)
    # a duplicated pair is taken as (even, even + 1), in that order
    for row in i_t:
        for k, col in enumerate(row):
            if col % 2 == 1:
                assert k > 0 and row[k - 1] == col - 1, row


def test_topk_project_wrapper_runs_plain_on_cpu():
    h, w, b = _topk_inputs(8, 32, 256, seed=4)
    args = (torch.tensor(h), torch.tensor(w, dtype=torch.bfloat16),
            torch.tensor(b), 5, 250)
    before = dict(_build.launch_counts)
    v_w, i_w = topk_project(*args)
    v_p, i_p = topk_project_plain(*args)
    assert torch.equal(v_w, v_p) and torch.equal(i_w, i_p)
    assert i_w.dtype == torch.int32
    assert _build.launch_counts == before

