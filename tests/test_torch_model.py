"""The PyTorch port's config, weight bridge and decoder against the JAX
package: the same Flax parameters and numpy inputs through both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidcap_tpu.config import PRESETS as JAX_PRESETS
from vidcap_tpu.config import apply_overrides as jax_apply_overrides
from vidcap_tpu.models.decoding import tile_recurrent as jax_tile_recurrent
from vidcap_tpu.models.model import VidCapModel as JaxModel
from vidcap_tpu.models.model import create_model as jax_create_model
from vidcap_tpu.models.model import init_params as jax_init_params
from vidcap_tpu_torch import config as tconfig
from vidcap_tpu_torch.convert import (flatten_tree, from_flax, load_weights,
                                      save_weights, to_flat)
from vidcap_tpu_torch.models.decoder import DecoderState
from vidcap_tpu_torch.models.decoding import tile_recurrent
from vidcap_tpu_torch.models.model import create_model, init_params


def test_presets_equal_the_jax_presets():
    """The port keeps its own copy of config.py; it must not drift."""
    assert set(tconfig.PRESETS) == set(JAX_PRESETS)
    for name, cfg in JAX_PRESETS.items():
        assert dataclasses.asdict(tconfig.PRESETS[name]) == \
            dataclasses.asdict(cfg), name
    over = ["model.compute_dtype=float32", "decode.beam_width=3"]
    assert dataclasses.asdict(tconfig.apply_overrides(
        tconfig.get_preset("synthetic_tiny"), over)) == dataclasses.asdict(
        jax_apply_overrides(JAX_PRESETS["synthetic_tiny"], over))


@pytest.mark.parametrize("preset,vocab", [("synthetic_tiny", 100),
                                          ("msrvtt_attn_beam5", 16_000)])
def test_from_flax_round_trips_every_name_and_shape(preset, vocab, tmp_path):
    cfg = JAX_PRESETS[preset]
    model = jax_create_model(cfg, vocab_size=vocab)
    shapes = flatten_tree(jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape),   # no allocation
        jax.eval_shape(lambda: jax_init_params(model, cfg,
                                               jax.random.key(0)))))
    tm = create_model(tconfig.PRESETS[preset], vocab)
    assert {k: tuple(v.shape) for k, v in to_flat(tm).items()} == \
        {k: tuple(v.shape) for k, v in shapes.items()}
    if preset != "synthetic_tiny":   # values too, at the small size
        return
    flat = flatten_tree(jax.tree_util.tree_map(
        np.asarray, jax_init_params(model, cfg, jax.random.key(0))))
    for k, v in to_flat(from_flax(tm, flat_to_tree(flat))).items():
        np.testing.assert_array_equal(v, flat[k])
    save_weights(tm, str(tmp_path / "w.npz"))
    np.savez(tmp_path / "jax.npz", **flat)   # as a file written from JAX
    for path in ("w.npz", "jax.npz"):
        t2 = load_weights(create_model(tconfig.PRESETS[preset], vocab),
                          str(tmp_path / path))
        for k, v in to_flat(t2).items():
            np.testing.assert_array_equal(v, flat[k])


def flat_to_tree(flat):
    tree = {}
    for path, v in flat.items():
        *dirs, leaf = path.split("/")
        node = tree
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = v
    return tree


def test_init_params_uses_the_flax_initializer_kinds():
    """Same draws are not possible (threefry vs numpy), so compare the
    per-parameter spread of the two inits at the same shapes."""
    cfg = JAX_PRESETS["synthetic_tiny"]
    jp = flatten_tree(jax.tree_util.tree_map(np.asarray, jax_init_params(
        jax_create_model(cfg, 100), cfg, jax.random.key(0))))
    tp = to_flat(init_params(create_model(tconfig.PRESETS["synthetic_tiny"],
                                          100), seed=0))
    for k, v in jp.items():
        assert tp[k].shape == v.shape, k
        if v.std() == 0:
            assert (tp[k] == 0).all(), k
        else:
            slack = 4.0 / np.sqrt(v.size)   # ~6 sigma of two sample stds
            assert abs(tp[k].std() / v.std() - 1.0) < slack, k


def _pair(dtype: str, vocab: int = 100):
    over = [f"model.compute_dtype={dtype}"]
    jcfg = jax_apply_overrides(JAX_PRESETS["synthetic_tiny"], over)
    tcfg = tconfig.apply_overrides(tconfig.get_preset("synthetic_tiny"), over)
    jm = jax_create_model(jcfg, vocab_size=vocab)
    params = jax_init_params(jm, jcfg, jax.random.key(0))
    tm = from_flax(create_model(tcfg, vocab),
                   jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _inputs(B=4, T=8, D=64, seed=0):
    g = np.random.default_rng(seed)
    mask = np.ones((B, T), np.float32)
    mask[1, T // 2:] = 0.0
    mask[2, :] = 0.0
    return g.normal(size=(B, T, D)).astype(np.float32), mask


# f32: only summation order differs (1e-5). bf16: the same rounding points on
# both sides, but a sum next to a bf16 rounding boundary may round one ulp
# apart (2^-8 relative) and carry through a step.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@torch.no_grad()
def test_init_state_and_beam_steps_match_jax(dtype):
    jm, params, tm = _pair(dtype)
    feats, mask = _inputs()
    B, K = feats.shape[0], 3
    js = jm.apply({"params": params}, jnp.asarray(feats), jnp.asarray(mask),
                  method=JaxModel.init_state)
    ts = tm.init_state(torch.tensor(feats), torch.tensor(mask))
    tol = TOL[dtype]
    for name in ("h", "c", "keys", "values", "frame_mask"):
        np.testing.assert_allclose(
            getattr(ts, name).float().numpy(),
            np.asarray(getattr(js, name), np.float32), atol=tol, err_msg=name)

    js, ts = jax_tile_recurrent(js, K), tile_recurrent(ts, K)
    tok = np.random.default_rng(1).integers(4, 90, B * K)
    js2, jlog = jm.apply({"params": params}, js, jnp.asarray(tok, jnp.int32),
                         K, method=JaxModel.step_beam)
    ts2, tlog = tm.step_beam(ts, torch.tensor(tok), K)
    np.testing.assert_allclose(ts2.h.numpy(), np.asarray(js2.h), atol=tol)
    np.testing.assert_allclose(ts2.c.numpy(), np.asarray(js2.c), atol=tol)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog, np.float32),
                               atol=tol, rtol=0)
    assert (tlog[:, 100:] == -1e30).all()   # padding columns masked

    js3, jh = jm.apply({"params": params}, js, jnp.asarray(tok, jnp.int32),
                       K, method=JaxModel.step_beam_hidden)
    ts3, th = tm.step_beam_hidden(ts, torch.tensor(tok), K)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=tol)
    assert isinstance(ts3, DecoderState)


@torch.no_grad()
def test_step_matches_jax_float32():
    jm, params, tm = _pair("float32")
    feats, mask = _inputs(seed=2)
    js = jm.apply({"params": params}, jnp.asarray(feats), jnp.asarray(mask),
                  method=JaxModel.init_state)
    ts = tm.init_state(torch.tensor(feats), torch.tensor(mask))
    tok = np.asarray([5, 6, 7, 8])
    _, jlog = jm.apply({"params": params}, js, jnp.asarray(tok, jnp.int32),
                       method=JaxModel.step)
    _, tlog = tm.step(ts, torch.tensor(tok))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)
