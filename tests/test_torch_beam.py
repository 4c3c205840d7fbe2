"""The PyTorch port's beam search against the JAX package's ``beam_decode``:
same weights, same features, same tie rule."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidcap_tpu.config import PRESETS as JAX_PRESETS
from vidcap_tpu.config import apply_overrides as jax_apply_overrides
from vidcap_tpu.models.decoding import beam_decode as jax_beam_decode
from vidcap_tpu.models.decoding import \
    per_row_topk_iterative as jax_per_row_topk
from vidcap_tpu.models.decoding import tile_recurrent as jax_tile_recurrent
from vidcap_tpu.models.model import VidCapModel as JaxModel
from vidcap_tpu.models.model import create_model as jax_create_model
from vidcap_tpu.models.model import init_params as jax_init_params
from vidcap_tpu_torch import config as tconfig
from vidcap_tpu_torch.convert import from_flax
from vidcap_tpu_torch.data.vocab import EOS
from vidcap_tpu_torch.models.decoder import DecoderState
from vidcap_tpu_torch.models.decoding import (BeamWeights, beam_decode,
                                              fused_beam_step,
                                              per_row_topk_iterative,
                                              tile_recurrent, topk_stable)
from vidcap_tpu_torch.models.model import create_model
from vidcap_tpu_torch.ops.topk_project import logits_topk

B, K, VOCAB = 4, 3, 100


@pytest.fixture(scope="module")
def f32_pair():
    """JAX and port models in float32 with the same weights; the <eos> bias
    is raised so that beams finish before max_len and early exit matters."""
    over = ["model.compute_dtype=float32"]
    jcfg = jax_apply_overrides(JAX_PRESETS["synthetic_tiny"], over)
    jm = jax_create_model(jcfg, vocab_size=VOCAB)
    params = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jm, jcfg, jax.random.key(0)))
    params["decoder"]["out_proj"]["bias"] = \
        params["decoder"]["out_proj"]["bias"].copy()
    params["decoder"]["out_proj"]["bias"][EOS] = 2.5
    tm = from_flax(create_model(tconfig.apply_overrides(
        tconfig.get_preset("synthetic_tiny"), over), VOCAB), params)
    g = np.random.default_rng(0)
    feats = g.normal(size=(B, 8, 64)).astype(np.float32)
    mask = np.ones((B, 8), np.float32)
    mask[1, 5:] = 0.0
    return jm, params, tm, feats, mask, jcfg.decode.max_len


def _jax_beam(jm, params, feats, mask, max_len, **kw):
    state = jax_tile_recurrent(jm.apply(
        {"params": params}, jnp.asarray(feats), jnp.asarray(mask),
        method=JaxModel.init_state), K)

    def step(st, tok):
        return jm.apply({"params": params}, st, tok, K,
                        method=JaxModel.step_beam)

    toks, scores = jax_beam_decode(step, state, batch=B, max_len=max_len,
                                   beam_width=K, **kw)
    return np.asarray(toks), np.asarray(scores)


@pytest.mark.parametrize("early_exit,return_all", [
    (False, False), (True, False), (True, True), (False, True)])
@torch.no_grad()
def test_beam_decode_matches_jax(f32_pair, early_exit, return_all):
    """Tokens identical and scores within 1e-4 (f32; only summation order
    differs), through the logits step and through the fused step (the
    plain versions of K1 and K2 on the CPU)."""
    jm, params, tm, feats, mask, max_len = f32_pair
    j_toks, j_scores = _jax_beam(jm, params, feats, mask, max_len,
                                 early_exit=early_exit, return_all=return_all)
    steps = []

    def logits_step(st, tok):
        steps.append(1)
        st, logits = tm.step_beam(st, tok, K)
        return (st, *logits_topk(logits, K))

    fused = fused_beam_step(BeamWeights.from_model(tm), K)
    for step_fn in (logits_step, fused):
        state = tile_recurrent(tm.init_state(torch.tensor(feats),
                                             torch.tensor(mask)), K)
        toks, scores = beam_decode(step_fn, state, batch=B, max_len=max_len,
                                   beam_width=K, early_exit=early_exit,
                                   return_all=return_all)
        np.testing.assert_array_equal(toks.numpy(), j_toks)
        np.testing.assert_allclose(scores.numpy(), j_scores, atol=1e-4)
    if early_exit:   # the raised <eos> bias finishes every beam early
        assert len(steps) < max_len
    assert (j_toks == EOS).any()


def test_beam_decode_ties_resolve_like_lax_top_k():
    """Logits with many exact ties: the per-row top-K and the K·K top-K both
    take the smallest index, so the beams equal JAX's bit for bit."""
    V, L = 32, 6
    g = np.random.default_rng(7)
    table = (g.integers(0, 3, size=(L + 1, V)) * 0.5).astype(np.float32)

    # the step counter rides in the state; prev_tok's parity shifts a row
    def jax_step(t, tok):
        return t + 1, jnp.asarray(table)[t][None, :] + 0.25 * (tok % 2)[:, None]

    j_toks, j_scores = jax_beam_decode(jax_step, jnp.int32(0),
                                       batch=2, max_len=L, beam_width=K,
                                       return_all=True)

    def port_step(st, tok):   # the counter rides in h, which beams gather
        t = int(st.h[0, 0, 0])
        rows = torch.tensor(table[t])[None, :] + 0.25 * (tok % 2)[:, None]
        return (DecoderState(h=st.h + 1, c=st.c, keys=st.keys,
                             values=st.values, frame_mask=st.frame_mask),
                *logits_topk(rows.float(), K))

    zero = torch.zeros(1, 2 * K, 1)
    toks, scores = beam_decode(port_step, DecoderState(zero, zero, zero, zero,
                                                       zero),
                               batch=2, max_len=L, beam_width=K,
                               return_all=True)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(j_toks))
    np.testing.assert_allclose(scores.numpy(), np.asarray(j_scores),
                               atol=1e-5)


def test_per_row_topk_iterative_ties_to_smallest_index():
    x = np.asarray([[1, 3, 3, 2, 3, 0], [0, 0, 0, 0, 0, 0]], np.float32)
    jv, ji = jax_per_row_topk(jnp.asarray(x), 4)
    tv, ti = per_row_topk_iterative(torch.tensor(x), 4)
    sv, si = topk_stable(torch.tensor(x), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(si.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(jv))
    assert ti.numpy().tolist()[0] == [1, 2, 4, 3]
