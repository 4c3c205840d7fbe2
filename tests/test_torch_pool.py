"""The port's finished-hypothesis beam pool (``beam_decode_pool``) against the
JAX package's and the numpy oracle of ``tests/test_beam_oracle.py``, on toy
Markov tables, and through ``Captioner`` and the CLI on ``synthetic_tiny``
against the JAX ``Captioner``.

Tolerances: on the toy tables, tokens identical and scores within 1e-6 of
the JAX pool (the same f32 arithmetic; only the logsumexp's summation order
may differ), within 1e-5 of the float64 numpy oracle (as the oracle's own
test holds the JAX pool). Caption JSON: identical in f32; in bf16 ≥ 90% of
the rows (XLA's tanh and f32 sums run in another order, so a sum next to a
bf16 rounding boundary may flip a near-tie between random-weight beams,
as in ``tests/test_torch_slice.py``).
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_beam_oracle import numpy_beam_pool
from test_torch_slice import (PYTHONPATH, kernel_route,  # noqa: F401
                              run_jax_scripts)
from vidcap_tpu.data.vocab import BOS, EOS
from vidcap_tpu.models.decoding import beam_decode_pool as jax_pool
from vidcap_tpu_torch.config import apply_overrides, get_preset
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.inference import Captioner
from vidcap_tpu_torch.models.decoder import DecoderState
from vidcap_tpu_torch.models.decoding import beam_decode_pool
from vidcap_tpu_torch.ops.topk_project import logits_topk

V, MAX_LEN, NSEEDS = 9, 7, 5


def _jax_table_step(tables, pos_bias):
    """logits = tables[video, prev] + pos_bias[t]; the state packs
    video · 64 + t per flat row (the oracle test's step)."""
    tb, pb = jnp.asarray(tables), jnp.asarray(pos_bias)

    def step(state, tok):
        sid = state.astype(jnp.int32)
        return state + 1.0, tb[sid // 64, tok] + pb[jnp.minimum(
            sid % 64, pb.shape[0] - 1)]
    return step


def _port_table_step(tables, pos_bias, n):
    """The same logits as a BeamStep of ``n`` candidates a row; the packed
    id rides in h, which the pool gathers with the beams."""
    tb, pb = torch.tensor(tables), torch.tensor(pos_bias)

    def step(st, tok):
        sid = st.h[0, :, 0].long()
        logits = tb[sid // 64, tok] + pb[torch.clamp(sid % 64,
                                                     max=pb.shape[0] - 1)]
        return (DecoderState(st.h + 1.0, st.c, st.keys, st.values,
                             st.frame_mask), *logits_topk(logits, n))
    return step


def _both(tables, pos_bias, B, K, max_len, **kw):
    """(JAX tokens, scores), (port tokens, scores) of the pool."""
    init = np.repeat(np.arange(B, dtype=np.float32) * 64.0, K)
    jt, js = jax_pool(_jax_table_step(tables, pos_bias), jnp.asarray(init),
                      batch=B, max_len=max_len, beam_width=K, **kw)
    h = torch.tensor(init)[None, :, None]
    z = torch.zeros(B, 1, 1)
    pt, ps = beam_decode_pool(
        _port_table_step(tables, pos_bias, K + 1),
        DecoderState(h, h, z, z, torch.ones(B, 1)), batch=B,
        max_len=max_len, beam_width=K, **kw)
    return (np.asarray(jt), np.asarray(js)), (pt.numpy(), ps.numpy())


def _pad(seq, n):
    return np.asarray(list(seq) + [0] * (n - len(seq)), np.int32)


@pytest.mark.parametrize("lp", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("K", [2, 3, 5])
def test_pool_matches_jax_and_the_numpy_oracle(K, lp):
    """Random per-video Markov tables with a position bias and <eos> raised
    (the oracle test's fixture): early exit on and off, best-1 and
    ``return_all``, each equal to the JAX pool; the ranked pool equal to
    ``numpy_beam_pool``."""
    g = np.random.default_rng(4321)
    tables = g.normal(size=(NSEEDS, V, V)).astype(np.float32)
    tables[..., EOS] += 1.0
    pos_bias = g.normal(size=(MAX_LEN, V)).astype(np.float32)
    finished = 0
    for early_exit in (False, True):
        for return_all in (False, True):
            (jt, js), (pt, ps) = _both(tables, pos_bias, NSEEDS, K, MAX_LEN,
                                       length_penalty=lp,
                                       early_exit=early_exit,
                                       return_all=return_all)
            np.testing.assert_array_equal(pt, jt)
            np.testing.assert_allclose(ps, js, rtol=1e-6, atol=1e-6)
            for b in range(NSEEDS):
                ranked = numpy_beam_pool(tables[b], pos_bias, K, MAX_LEN, lp)
                got = pt[b] if return_all else pt[b][None]
                for n, row in enumerate(got):
                    np.testing.assert_array_equal(
                        row, _pad(ranked[n][0], MAX_LEN))
                    np.testing.assert_allclose(
                        ps[b][n] if return_all else ps[b], ranked[n][1],
                        rtol=1e-5, atol=1e-5)
                finished += EOS in ranked[0][0]
    assert finished >= 2, "the pool path barely ran"


def _adversarial_rows():
    from test_decoding import _adversarial_rows as rows
    return rows()


@pytest.mark.parametrize("early_exit", [False, True])
def test_pool_beats_slot_blocking_adversarial(early_exit):
    """``tests/test_decoding.py``'s adversarial Markov LM at lp 1: the pool
    keeps exploring past the two short finished captions and returns "a b
    <eos>" (raw −1.40, length 3), as the JAX pool does."""
    rows, a_tok, b_tok = _adversarial_rows()
    (jt, js), (pt, ps) = _both(rows[None], np.zeros((1, 7), np.float32), 1,
                               2, 3, length_penalty=1.0,
                               early_exit=early_exit)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pt[0], [a_tok, b_tok, EOS])
    np.testing.assert_allclose(ps, js, rtol=1e-6)
    np.testing.assert_allclose(ps[0], -1.40 * 6 / 8, rtol=1e-5)


def test_pool_prunes_low_ranked_eos():
    """``tests/test_decoding.py``'s low-ranked-<eos> case: <eos> third in
    the row, outside the top K+1 = 2, never enters the pool; the caption is
    a real one, as the JAX pool's."""
    a_tok, junk = 4, 6
    rows = np.full((7, 7), -1e9, np.float32)
    rows[BOS, a_tok], rows[BOS, 5], rows[BOS, EOS] = -0.9, -1.3, -1.7
    rows[BOS, junk] = np.log(1.0 - np.exp(-0.9) - np.exp(-1.3)
                             - np.exp(-1.7))
    for t in (a_tok, 5, junk):
        rows[t, a_tok], rows[t, junk] = -1.0, -1.2
    (jt, js), (pt, ps) = _both(rows[None], np.zeros((1, 7), np.float32), 1,
                               1, 3, length_penalty=1.0)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_allclose(ps, js, rtol=1e-6)
    assert pt[0][0] != EOS


# ------------------------------------------------ through Captioner and CLI

F32 = ["model.compute_dtype=float32"]
POOLS = {"lp": ["decode.length_penalty=0.6"], "on": ["decode.finished_pool=on"]}

# one JAX process per compute dtype: the seeded weights as an .npz, and the
# beam-5 captions of each pool setting at nbest 1 and 3
_JAX_POOL = """
import json, sys
import jax, numpy as np
jax.config.update("jax_platforms", "cpu")
from vidcap_tpu.config import apply_overrides, get_preset
from vidcap_tpu.data.loader import CaptionDataset
from vidcap_tpu.inference import Captioner
over, out = json.loads(sys.argv[1]), sys.argv[2]
pools = %r
cfg = apply_overrides(get_preset("synthetic_tiny"), over)
ds = CaptionDataset.synthetic(cfg.data)
cap = Captioner.from_checkpoint(cfg, ds, checkpoint_dir=None)
flat = {}
def walk(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            walk(v, prefix + k + "/")
        else:
            flat[prefix + k] = np.asarray(v)
walk(cap.params)
np.savez(out + "/w.npz", **flat)
caps = {}
for name, extra in pools.items():
    c = Captioner(apply_overrides(cfg, extra), cap.model, cap.params, ds)
    for nbest in (1, 3):
        caps[f"{name}{nbest}"] = c.caption_dataset(method="beam",
                                                   beam_width=5, nbest=nbest)
with open(out + "/caps.json", "w") as f:
    json.dump(caps, f)
""" % (POOLS,)


@pytest.fixture(scope="module")
def jax_pools(tmp_path_factory):
    jobs = {name: (over, tmp_path_factory.mktemp(f"pool_{name}"))
            for name, over in (("float32", F32), ("bfloat16", []))}
    run_jax_scripts(_JAX_POOL, jobs.values())
    return {name: (json.loads((out / "caps.json").read_text()),
                   str(out / "w.npz"), over)
            for name, (over, out) in jobs.items()}


def _port_pool_captions(weights, over, name, nbest):
    cfg = apply_overrides(get_preset("synthetic_tiny"), over + POOLS[name])
    cap = Captioner.from_checkpoint(cfg, CaptionDataset.synthetic(cfg.data),
                                    weights=weights, device="cpu")
    return cap.caption_dataset(method="beam", beam_width=5, nbest=nbest)


@pytest.mark.parametrize("name,nbest", [("lp", 1), ("lp", 3), ("on", 1),
                                        ("on", 3)])
def test_pool_caption_json_identical_to_jax_float32(jax_pools, name, nbest):
    caps, weights, over = jax_pools["float32"]
    assert _port_pool_captions(weights, over, name, nbest) == \
        caps[f"{name}{nbest}"]


@pytest.mark.parametrize("name,nbest", [("lp", 1), ("lp", 3), ("on", 1),
                                        ("on", 3)])
def test_pool_caption_json_identical_to_jax_float32_on_the_kernel_route(
        jax_pools, kernel_route, name, nbest):
    """The same JSON through the kernel decoder's beam step with K+1
    candidates a row (K1's and K2's plain versions here)."""
    caps, weights, over = jax_pools["float32"]
    assert _port_pool_captions(weights, over, name, nbest) == \
        caps[f"{name}{nbest}"]
    assert kernel_route["fused_beam_step"] == 2


@pytest.mark.parametrize("name,nbest", [("lp", 1), ("on", 3)])
def test_pool_caption_json_matches_jax_bfloat16(jax_pools, name, nbest):
    caps, weights, over = jax_pools["bfloat16"]
    want = caps[f"{name}{nbest}"]
    port = _port_pool_captions(weights, over, name, nbest)
    assert port.keys() == want.keys()
    same = sum(port[v] == want[v] for v in want)
    assert same >= 0.9 * len(want), (same, len(want))


@pytest.mark.parametrize("name,nbest", [("lp", 3), ("on", 1)])
def test_cli_pool_caption_equals_jax(jax_pools, tmp_path, name, nbest):
    caps, weights, over = jax_pools["float32"]
    out = tmp_path / "caps.json"
    cmd = [sys.executable, "-m", "vidcap_tpu_torch", "caption",
           "--preset", "synthetic_tiny", "--weights", weights,
           "--method", "beam", "--beam", "5", "--nbest", str(nbest),
           "--device", "cpu", "--out", str(out)]
    cmd += [a for o in over + POOLS[name] for a in ("--set", o)]
    r = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": PYTHONPATH},
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(out.read_text()) == caps[f"{name}{nbest}"]
    assert '"beam_core": 0, "topk_project": 0' in r.stderr   # CPU tensors


def test_pool_runs_past_the_cards_beam_width_limit_on_the_cpu():
    """On the card K2 takes at most 8 candidates a row, so the pool (K+1 a
    row) stops at beam width 7 with a ValueError that names the limit
    (``tests/test_torch_cuda.py``); the CPU's plain versions have no such
    limit."""
    cfg = apply_overrides(get_preset("synthetic_tiny"), POOLS["on"])
    cap = Captioner.from_checkpoint(cfg, CaptionDataset.synthetic(
        cfg.data, num_videos=2), device="cpu")
    feats = np.zeros((2, cfg.data.num_frames, cfg.data.feature_dim),
                     np.float32)
    toks = cap.decode_batch(feats, beam_width=8, nbest=8)
    assert toks.shape == (2, 8, cap.max_len)


def test_pool_artifact_decodes_as_live(jax_pools, tmp_path):
    """An exported beam artifact carries the decode section, so its decode
    takes the pool where the live one does: the same tokens."""
    from vidcap_tpu_torch.export import ExportedCaptioner, export_decoder
    _, weights, over = jax_pools["float32"]
    cfg = apply_overrides(get_preset("synthetic_tiny"), over + POOLS["lp"])
    cap = Captioner.from_checkpoint(cfg, CaptionDataset.synthetic(cfg.data),
                                    weights=weights, device="cpu")
    export_decoder(cap, str(tmp_path / "art"), batch_size=0, method="beam",
                   beam_width=5)
    ec = ExportedCaptioner.load(str(tmp_path / "art"), device="cpu")
    assert ec.meta["decode"]["length_penalty"] == 0.6
    feats = np.random.default_rng(5).normal(
        size=(6, cfg.data.num_frames, cfg.data.feature_dim)).astype(
            np.float32)
    np.testing.assert_array_equal(ec.decode_batch(feats),
                                  cap.decode_batch(feats, beam_width=5))


def test_launch_counts_by_k_follow_the_rule_of_the_counts():
    """K2's and K2-int8's launches by K (the pool runs K2 at the width + 1)
    live beside the launch counts in ``_build`` and follow their rule:
    reset together, taken back out by ``counted``, added back by
    ``add_counts`` (a captured graph's replay)."""
    from vidcap_tpu_torch.ops import _build
    _build.reset_counts()
    _build.count_launch("topk_project", 6)
    _build.count_launch("beam_core")
    _, delta = _build.counted(lambda: (
        _build.count_launch("topk_project", 6),
        _build.count_launch("topk_project_int8", 5)))
    assert _build.launch_counts == {"beam_core": 1, "topk_project": 1,
                                    "topk_project_int8": 0, "rollout": 0,
                                    "teacher_forced": 0, "moe_dispatch": 0,
                                    "silu_mul": 0, "moe_combine": 0}
    assert _build.launches_by_k == {("topk_project", 6): 1}
    assert delta == {"beam_core": 0, "topk_project": 1,
                     "topk_project_int8": 1, "rollout": 0,
                     "teacher_forced": 0, "moe_dispatch": 0, "silu_mul": 0,
                     "moe_combine": 0,
                     ("topk_project", 6): 1, ("topk_project_int8", 5): 1}
    _build.add_counts(delta)
    assert _build.launch_counts["topk_project"] == 2
    assert _build.launches_by_k == {("topk_project", 6): 2,
                                    ("topk_project_int8", 5): 1}
    _build.reset_counts()
    assert _build.launches_by_k == {}
    assert not any(_build.launch_counts.values())
