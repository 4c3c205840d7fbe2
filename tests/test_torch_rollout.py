"""The port's second slice against the JAX package: greedy and sampled
captioning through K3's plain version (``ops/rollout.py``) on the CPU, with
the same weights. The JAX side runs in subprocesses as in
tests/test_torch_slice.py (excess precision off), its K3 in interpret mode.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import (F32, PYTHONPATH, kernel_route,  # noqa: F401
                              run_jax_scripts)
from vidcap_tpu.config import PRESETS as JAX_PRESETS
from vidcap_tpu.config import apply_overrides as jax_apply_overrides
from vidcap_tpu.models.decoding import greedy_decode as jax_greedy_decode
from vidcap_tpu.models.model import VidCapModel as JaxModel
from vidcap_tpu.models.model import create_model as jax_create_model
from vidcap_tpu.models.model import init_params as jax_init_params
from vidcap_tpu_torch import config as tconfig
from vidcap_tpu_torch.config import apply_overrides, get_preset
from vidcap_tpu_torch.convert import from_flax
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.data.vocab import EOS, PAD
from vidcap_tpu_torch.inference import Captioner, NoDeviceError
from vidcap_tpu_torch.models import decoding
from vidcap_tpu_torch.models.decoding import (KernelWeights, greedy_decode,
                                              model_rollout, sample_decode)
from vidcap_tpu_torch.models.model import create_model, init_params
from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.ops.rollout import (RolloutWeights, gumbel_noise,
                                          replay_plain, rollout, rollout_plain)

SEED = 3          # the sampling seed of both Captioners
EOS_RAISE = 1.0   # added to b_out[<eos>]: some rows end before max_len

# Runs in a subprocess (see tests/test_torch_slice.py): the JAX package's
# greedy captions (XLA, early exit) of the synthetic split with the seeded
# init, and those weights as an .npz; in bf16 also K3 (interpret mode):
# greedy captions, two sampled batches through Captioner(seed=SEED), the
# same batches through model_rollout with Captioner's derived seeds, and one
# sampled rollout at temperature 0.7 with <eos> raised, with its state.
_JAX_ROLLOUTS = """
import json, sys
import jax, numpy as np
jax.config.update("jax_platforms", "cpu")
from vidcap_tpu.config import apply_overrides, get_preset
from vidcap_tpu.data.loader import CaptionDataset
from vidcap_tpu.data.vocab import EOS
from vidcap_tpu.inference import Captioner
from vidcap_tpu.models.model import VidCapModel
from vidcap_tpu.ops.pallas_decoder import (from_params, model_rollout,
                                           pallas_rollout)
SEED, EOS_RAISE = %d, %r
over, out = json.loads(sys.argv[1]), sys.argv[2]
cfg = apply_overrides(get_preset("synthetic_tiny"), over)
ds = CaptionDataset.synthetic(cfg.data)
cap = Captioner.from_checkpoint(cfg, ds, checkpoint_dir=None, seed=SEED)
flat = {}
def walk(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            walk(v, prefix + k + "/")
        else:
            flat[prefix + k] = np.asarray(v)
walk(cap.params)
np.savez(out + "/w.npz", **flat)
caps = {"xla_greedy": cap.caption_dataset(method="greedy")}
arrays = {}
if cfg.model.compute_dtype == "bfloat16":
    L, model, params = cfg.decode.max_len, cap.model, cap.params
    k3 = Captioner(apply_overrides(cfg, ["model.use_pallas_decoder=true"]),
                   model, params, ds, seed=SEED)
    caps["k3_greedy"] = k3.caption_dataset(method="greedy")
    roll = jax.jit(lambda p, f, s: model_rollout(model, p, f, L, sample=True,
                                                 seed=s))
    for i, batch in enumerate(ds.video_batches(32)):
        arrays[f"feats{i}"] = batch.features
        arrays[f"k3_sample{i}"] = k3.decode_batch(batch.features,
                                                  method="sample")
        r = roll(params, batch.features, (SEED * 1000003 + i + 1) %% (1 << 31))
        for name in ("tokens", "logp", "mask"):
            arrays[f"rollout{i}_{name}"] = np.asarray(getattr(r, name))
    st = model.apply({"params": params}, arrays["feats0"],
                     method=VidCapModel.init_state)
    w = from_params(params)
    w = w._replace(b_out=w.b_out.at[0, EOS].add(EOS_RAISE))
    r = jax.jit(lambda: pallas_rollout(
        w, st.keys, st.values, st.frame_mask, st.h[0], st.c[0], L,
        model.vocab_size, sample=True, seed=SEED, temperature=0.7,
        interpret=True))()
    for name, v in (("keys", st.keys), ("values", st.values),
                    ("frame_mask", st.frame_mask), ("h0", st.h[0]),
                    ("c0", st.c[0]), ("tokens", r[0]), ("logp", r[1]),
                    ("mask", r[2])):
        arrays["eos_" + name] = np.asarray(v, np.float32)
np.savez(out + "/arrays.npz", **arrays)
with open(out + "/caps.json", "w") as f:
    json.dump(caps, f)
""" % (SEED, EOS_RAISE)


@pytest.fixture(scope="module")
def jax_rollouts(tmp_path_factory):
    jobs = {name: (over, tmp_path_factory.mktemp(name))
            for name, over in (("float32", F32), ("bfloat16", []))}
    run_jax_scripts(_JAX_ROLLOUTS, jobs.values())
    runs = {}
    for name, (over, out) in jobs.items():
        with np.load(out / "arrays.npz") as f:
            arrays = {k: f[k] for k in f.files}
        runs[name] = (json.loads((out / "caps.json").read_text()),
                      str(out / "w.npz"), over, arrays)
    return runs


def _captioner(weights, over, seed=None):
    cfg = apply_overrides(get_preset("synthetic_tiny"), over)
    return Captioner.from_checkpoint(cfg, CaptionDataset.synthetic(cfg.data),
                                     weights=weights, device="cpu", seed=seed)


def _same_rows(a, b):
    return (np.asarray(a) == np.asarray(b)).all(1)


def test_greedy_caption_json_identical_to_jax_float32(jax_rollouts):
    caps, weights, over, _ = jax_rollouts["float32"]
    cap = _captioner(weights, over)
    assert cap.caption_dataset(method="greedy") == caps["xla_greedy"]
    assert cap.decode_calls == 2 and cap.decode_steps == 2 * cap.max_len


def test_greedy_caption_json_identical_to_jax_float32_on_the_kernel_route(
        jax_rollouts, kernel_route):
    """The f32 decoder's greedy runs through its modules; the same JSON
    through K3's wiring (``model_rollout``, K3's plain version here)."""
    caps, weights, over, _ = jax_rollouts["float32"]
    cap = _captioner(weights, over)
    assert cap.caption_dataset(method="greedy") == caps["xla_greedy"]
    assert kernel_route["model_rollout"] == 2
    assert cap._weights._rollout is not None


def test_cli_greedy_caption_equals_jax_float32(jax_rollouts, tmp_path):
    caps, weights, over, _ = jax_rollouts["float32"]
    out = tmp_path / "caps.json"
    cmd = [sys.executable, "-m", "vidcap_tpu_torch", "caption",
           "--preset", "synthetic_tiny", "--weights", weights,
           "--method", "greedy", "--device", "cpu",
           "--out", str(out)] + [a for o in over for a in ("--set", o)]
    r = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": PYTHONPATH},
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(out.read_text()) == caps["xla_greedy"]
    assert "greedy: 2 decodes, 24 steps on cpu" in r.stderr


def test_greedy_bfloat16_matches_jax_k3_and_xla(jax_rollouts):
    """bf16: the same rounding points on all three sides, but XLA's tanh and
    the f32 sums run in another order, so a sum next to a rounding boundary
    may round one ulp apart and flip a near-tie between random-weight
    logits: ≥ 90% of the rows identical to K3 and to the XLA greedy."""
    caps, weights, over, _ = jax_rollouts["bfloat16"]
    port = _captioner(weights, over).caption_dataset(method="greedy")
    for ref in (caps["k3_greedy"], caps["xla_greedy"]):
        assert port.keys() == ref.keys()
        same = sum(port[v] == ref[v] for v in ref)
        assert same >= 0.9 * len(ref), (same, len(ref))


def test_sample_bfloat16_same_seed_matches_jax_k3(jax_rollouts):
    """Captioner(seed) over two batches (so the per-call seed counter moves)
    against JAX's Captioner(seed) on K3: ≥ 90% of the rows identical (the
    bf16 margin of the greedy test; Gumbel noise widens most margins);
    on identical rows of model_rollout at the derived seeds, logp within
    1e-3 and the mask equal."""
    _, weights, over, a = jax_rollouts["bfloat16"]
    cap = _captioner(weights, over, seed=SEED)
    for i in range(2):
        feats = a[f"feats{i}"]
        toks = cap.decode_batch(feats, method="sample")
        assert _same_rows(toks, a[f"k3_sample{i}"]).mean() >= 0.9
        route = decoding.route(cap.model.decoder, cap.cfg.decode, "sample",
                               1, feats.shape[1], "cpu")
        r = model_rollout(cap.model, route,
                          KernelWeights(cap.model.decoder).rollout(),
                          torch.tensor(feats), None, cap.max_len,
                          cap.model.step, sample=True,
                          seed=(SEED * 1000003 + i + 1) % 2**31,
                          temperature=1.0, row0=0, early_exit=False)
        np.testing.assert_array_equal(r.tokens.numpy(), toks)
        same = _same_rows(toks, a[f"rollout{i}_tokens"])
        assert same.mean() >= 0.9
        np.testing.assert_allclose(r.logp.numpy()[same],
                                   a[f"rollout{i}_logp"][same], atol=1e-3)
        np.testing.assert_array_equal(r.mask.numpy()[same],
                                      a[f"rollout{i}_mask"][same])


def _raised(w: RolloutWeights, by: float) -> RolloutWeights:
    b = w.b_out.clone()
    b[EOS] += by
    return dataclasses.replace(w, b_out=b)


def test_rollout_plain_matches_pallas_rollout_sampled(jax_rollouts):
    """The same state, <eos> raised, temperature 0.7, the same seed: ≥ 90% of
    the rows identical; on those the mask equal and logp within one bf16 ulp
    of a logit below 2 in magnitude (2^-7) over the temperature: a sum next
    to a rounding boundary may round one ulp apart and move one logit (the
    median stays within 1e-5). Some rows end before max_len and some do
    not, on both sides."""
    _, weights, over, a = jax_rollouts["bfloat16"]
    w = _raised(KernelWeights(_captioner(weights, over).model.decoder)
                .rollout(), EOS_RAISE)
    t = lambda k, dt=torch.float32: torch.tensor(a["eos_" + k]).to(dt)
    toks, logp, mask = rollout_plain(
        w, t("keys", torch.bfloat16), t("values", torch.bfloat16),
        t("frame_mask"), t("h0"), t("c0"), a["eos_tokens"].shape[1],
        sample=True, seed=SEED, temperature=0.7)
    same = _same_rows(toks, a["eos_tokens"])
    assert same.mean() >= 0.9, same.mean()
    err = np.abs(logp.numpy()[same] - a["eos_logp"][same])
    assert err.max() <= 2**-7 / 0.7 and np.median(err) < 1e-5, err.max()
    np.testing.assert_array_equal(mask.numpy()[same], a["eos_mask"][same])
    for tk in (toks.numpy(), a["eos_tokens"]):
        ended = (tk == EOS).any(1)
        assert ended.any() and not ended.all(), ended.mean()


def _k3_uniform_numpy(B, V, seed, step):
    """pallas_decoder.py:216-230 in numpy uint32 arithmetic."""
    u32 = np.uint32
    row = np.arange(B, dtype=u32)[:, None]
    col = np.arange(V, dtype=u32)[None, :]
    with np.errstate(over="ignore"):
        x = ((row * u32(0x9E3779B9)) ^ (col * u32(0x85EBCA6B))
             ^ (u32(seed) * u32(0x27D4EB2F) + u32(step) * u32(0x165667B1)))
        x = x ^ (x >> u32(16))
        x = x * u32(0x7FEB352D)
        x = x ^ (x >> u32(15))
        x = x * u32(0x846CA68B)
        x = x ^ (x >> u32(16))
    return ((x >> u32(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))
            + np.float32(1e-12))


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 29), (2**31 - 1, 3)])
def test_gumbel_noise_is_the_k3_hash(seed, step):
    uni = _k3_uniform_numpy(40, 300, seed, step)
    noise = gumbel_noise(torch.zeros(40, 300), seed, step).numpy()
    np.testing.assert_allclose(noise, -np.log(-np.log(uni)), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_gumbel_picks_follow_the_softmax(temperature):
    """One 20-column logits row, 20,000 (seed, step) draws: the share of
    each column within 0.01 of softmax(logits / temperature) (the standard
    error is at most 0.0035)."""
    logits = torch.tensor(np.random.default_rng(0).normal(size=20),
                          dtype=torch.float32)
    clean = (logits / temperature).expand(200, 100, 1, 20)
    seeds = torch.arange(200)[:, None, None, None]
    steps = torch.arange(100)[None, :, None, None]
    picks = gumbel_noise(clean, seeds * 7919 + 11, steps).argmax(-1)
    freq = torch.bincount(picks.flatten(), minlength=20).double() / 20_000
    np.testing.assert_allclose(freq.numpy(), torch.softmax(
        logits.double() / temperature, -1).numpy(), atol=0.01)


def _tiny_port(vocab=43):
    cfg = get_preset("synthetic_tiny")
    model = init_params(create_model(cfg, vocab), seed=0).eval()
    feats = np.random.default_rng(0).normal(size=(16, 8, 64))
    return cfg, model, torch.tensor(feats, dtype=torch.float32)


@pytest.mark.parametrize("sample,raise_by", [(False, 0.2), (True, 1.0)])
@torch.no_grad()
def test_finish_semantics_with_raised_eos(sample, raise_by):
    """tests/test_pallas_decoder.py::test_mask_and_finish_semantics's rules:
    the mask is 1 up to and including the first <eos>, then 0; PAD and
    logp 0 follow it; logp ≤ 0 before. Some rows end, some do not."""
    cfg, model, feats = _tiny_port()
    st = model.init_state(feats)
    w = _raised(KernelWeights(model.decoder).rollout(), raise_by)
    toks, logp, mask = rollout_plain(w, st.keys, st.values, st.frame_mask,
                                     st.h[0], st.c[0], cfg.decode.max_len,
                                     sample=sample, seed=5)
    toks, logp, mask = toks.numpy(), logp.numpy(), mask.numpy()
    ended = 0
    for b in range(toks.shape[0]):
        eos = np.flatnonzero(toks[b] == EOS)
        e = eos[0] if len(eos) else toks.shape[1] - 1
        ended += len(eos) > 0
        assert mask[b, :e + 1].all() and not mask[b, e + 1:].any()
        assert (toks[b, e + 1:] == PAD).all() and (logp[b, e + 1:] == 0).all()
        assert (logp[b, :e + 1] <= 1e-6).all()
    assert 0 < ended < toks.shape[0]


@torch.no_grad()
def test_generic_loops_match_jax_greedy_and_k3_float32():
    """f32, in process: the port's greedy_decode over model.step equals the
    JAX package's (tokens; logp within 1e-5), with and without early exit,
    and equals rollout_plain; sample_decode over model.step picks what
    rollout_plain(sample=True) picks with the same seed."""
    over = ["model.compute_dtype=float32"]
    jcfg = jax_apply_overrides(JAX_PRESETS["synthetic_tiny"], over)
    jm = jax_create_model(jcfg, vocab_size=43)
    params = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jm, jcfg, jax.random.key(0)))
    params["decoder"]["out_proj"]["bias"] = \
        params["decoder"]["out_proj"]["bias"].copy()
    params["decoder"]["out_proj"]["bias"][EOS] = 0.3   # some rows finish
    tm = from_flax(create_model(tconfig.apply_overrides(
        get_preset("synthetic_tiny"), over), 43), params)
    feats = np.random.default_rng(1).normal(size=(8, 8, 64)).astype(
        np.float32)
    L = jcfg.decode.max_len
    js = jm.apply({"params": params}, jnp.asarray(feats),
                  method=JaxModel.init_state)
    j = jax_greedy_decode(lambda s, t: jm.apply({"params": params}, s, t,
                                                method=JaxModel.step),
                          js, 8, L)
    st = tm.init_state(torch.tensor(feats))
    w = KernelWeights(tm.decoder).rollout()
    k3 = rollout_plain(w, st.keys, st.values, st.frame_mask, st.h[0],
                       st.c[0], L)
    for early_exit in (False, True):
        r = greedy_decode(tm.step, st, 8, L, early_exit=early_exit)
        np.testing.assert_array_equal(r.tokens.numpy(), np.asarray(j.tokens))
        np.testing.assert_array_equal(r.mask.numpy(), np.asarray(j.mask))
        np.testing.assert_allclose(r.logp.numpy(), np.asarray(j.logp),
                                   atol=1e-5)
        np.testing.assert_array_equal(r.tokens.numpy(), k3[0].numpy())
    assert (r.tokens.numpy() == EOS).any()
    for temperature in (1.0, 0.7):
        s = sample_decode(tm.step, st, 8, L, seed=11, temperature=temperature)
        k3s = rollout_plain(w, st.keys, st.values, st.frame_mask, st.h[0],
                            st.c[0], L, sample=True, seed=11,
                            temperature=temperature)
        np.testing.assert_array_equal(s.tokens.numpy(), k3s[0].numpy())
        np.testing.assert_array_equal(s.mask.numpy(), k3s[2].numpy())
        np.testing.assert_allclose(s.logp.numpy(), k3s[1].numpy(), atol=1e-5)


def test_rollout_wrapper_runs_plain_on_cpu():
    """A CPU tensor takes the plain version, and no kernel launch is
    counted; replay_plain fed a rollout's own tokens picks them; the K3
    route refuses decoders K3 does not run."""
    cfg, model, feats = _tiny_port()
    st = model.init_state(feats)
    w = KernelWeights(model.decoder).rollout()
    args = (w, st.keys, st.values, st.frame_mask, st.h[0], st.c[0], 5)
    before = dict(_build.launch_counts)
    got = rollout(*args, sample=True, seed=2, temperature=0.7)
    want = rollout_plain(*args, sample=True, seed=2, temperature=0.7)
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    assert got[0].dtype == torch.int32
    assert _build.launch_counts == before
    # fed its own tokens, the replay picks them and gives their logp
    pick, margin, logp = replay_plain(*args[:-1], got[0], sample=True, seed=2,
                                      temperature=0.7)
    live = got[2] > 0
    assert torch.equal(pick[live].int(), got[0][live])
    assert (margin >= 0).all()
    torch.testing.assert_close(logp[live], got[1][live])
    with pytest.raises(ValueError, match="temperature"):
        rollout(*args, sample=True, temperature=0.0)
    two = create_model(apply_overrides(cfg, ["model.num_lstm_layers=2"]), 43)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        KernelWeights(two.decoder).rollout()


def test_greedy_and_sample_refuse_to_run_on_cpu_unasked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device exists")
    cfg = get_preset("synthetic_tiny")
    with pytest.raises(NoDeviceError):
        Captioner.from_checkpoint(cfg, CaptionDataset.synthetic(
            cfg.data, num_videos=4), seed=1)
    for cmd in (["caption", "--method", "greedy"], ["sample", "--seed", "1"]):
        r = subprocess.run(
            [sys.executable, "-m", "vidcap_tpu_torch", *cmd, "--preset",
             "synthetic_tiny", "--weights", "absent.npz", "--out", "c.json"],
            cwd=tmp_path, env={**os.environ, "PYTHONPATH": PYTHONPATH},
            capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr
        assert not (tmp_path / "c.json").exists()
