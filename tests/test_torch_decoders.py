"""The decoders no kernel covers: two LSTM layers, no attention, and
``model.compute_dtype=float32``. ``models/decoding.py::route`` routes
them through the model's own modules (the JAX package's XLA path
for the same configurations); the one-layer bf16 attention decoder of every
preset keeps K1–K3. Against the JAX package on the CPU:

* greedy, beam and the finished pool (lp 0.6) through ``Captioner``: caption
  JSON identical in f32; in bf16 ≥ 90% of the rows (the rule of
  ``tests/test_torch_slice.py``: XLA sums in another order, so a one-ulp
  near-tie between random-weight logits may flip);
* sampled: the JAX package draws with threefry, which PyTorch cannot
  reproduce, so ``sample_decode`` (K3's counter-hash noise) is held to K3's
  plain version at the same seed on the one-layer f32 decoder (tokens and
  masks identical, log-probs within 1e-6), and to itself elsewhere;
* SCST for a two-layer f32 decoder: the greedy rollout identical to the
  JAX package's XLA greedy; fed the same rollouts, the update's rewards
  within 1e-5 and loss pieces within 1e-6, its gradient norm within 1e-5
  (``tests/test_torch_train.py``'s float32 tolerances), and its step body
  reads nothing on the host.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dispatch import NoHostRead
from test_torch_slice import run_jax_scripts
from vidcap_tpu.config import apply_overrides as jax_apply_overrides
from vidcap_tpu.config import get_preset as jax_get_preset
from vidcap_tpu.data.loader import CaptionDataset as JaxDataset
from vidcap_tpu.data.pipeline import DeterministicBatcher as JaxBatcher
from vidcap_tpu.models import decoding as jax_decoding
from vidcap_tpu.models.model import VidCapModel as JaxModel
from vidcap_tpu.models.model import create_model as jax_create_model
from vidcap_tpu.models.model import init_params as jax_init_params
from vidcap_tpu.objectives.reward_tables import \
    tables_from_dataset as jax_tables
from vidcap_tpu.train.scst import make_scst_step_body as jax_scst_body
from vidcap_tpu.train.state import create_train_state as jax_train_state
from vidcap_tpu_torch.config import PRESETS, apply_overrides, get_preset
from vidcap_tpu_torch.convert import from_flax
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.data.pipeline import DeterministicBatcher
from vidcap_tpu_torch.inference import Captioner
from vidcap_tpu_torch.models import decoding
from vidcap_tpu_torch.models.decoding import KernelWeights, sample_decode
from vidcap_tpu_torch.models.model import create_model, init_params
from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.ops.rollout import rollout_plain
from vidcap_tpu_torch.train.loop import batch_to_device
from vidcap_tpu_torch.train.scst import make_scst_step_body
from vidcap_tpu_torch.train.state import create_train_state

F32 = ["model.compute_dtype=float32"]
DECODERS = {"two_layers": ["model.num_lstm_layers=2"],
            "no_attention": ["model.use_attention=false"],
            "float32": F32}
POOL = ["decode.length_penalty=0.6"]

# one JAX process per set of configurations: each one's seeded weights as
# an .npz and its greedy, beam-5 and pool captions of the synthetic split
_JAX_DECODERS = """
import json, sys
import jax, numpy as np
jax.config.update("jax_platforms", "cpu")
from vidcap_tpu.config import apply_overrides, get_preset
from vidcap_tpu.data.loader import CaptionDataset
from vidcap_tpu.inference import Captioner
jobs, out = json.loads(sys.argv[1]), sys.argv[2]
caps = {}
for name, over in jobs.items():
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
    np.savez(f"{out}/{name}.npz", **flat)
    pool = Captioner(apply_overrides(cfg, %r), cap.model, cap.params, ds)
    caps[name] = {"greedy": cap.caption_dataset(method="greedy"),
                  "beam": cap.caption_dataset(method="beam", beam_width=5),
                  "pool": pool.caption_dataset(method="beam", beam_width=5)}
with open(out + "/caps.json", "w") as f:
    json.dump(caps, f)
""" % (POOL,)


@pytest.fixture(scope="module")
def jax_decoders(tmp_path_factory):
    """{dtype: (captions by config and method, weights dir, configs)}: the
    three configurations in f32, the first two in bf16 as well."""
    sets = {"f32": {"two_layers": DECODERS["two_layers"] + F32,
                    "no_attention": DECODERS["no_attention"] + F32,
                    "float32": F32},
            "bf16": {k: DECODERS[k] for k in ("two_layers", "no_attention")}}
    jobs = {k: (v, tmp_path_factory.mktemp(f"dec_{k}"))
            for k, v in sets.items()}
    run_jax_scripts(_JAX_DECODERS, jobs.values())
    return {k: (json.loads((out / "caps.json").read_text()), out, jobs[k][0])
            for k, (_, out) in jobs.items()}


def _port_captions(weights, over, method):
    cfg = apply_overrides(get_preset("synthetic_tiny"),
                          over + (POOL if method == "pool" else []))
    cap = Captioner.from_checkpoint(cfg, CaptionDataset.synthetic(cfg.data),
                                    weights=weights, device="cpu")
    before = dict(_build.launch_counts)
    caps = cap.caption_dataset(method="greedy" if method == "greedy"
                               else "beam", beam_width=5)
    assert _build.launch_counts == before   # CPU tensors: no launch
    return caps


@pytest.mark.parametrize("method", ["greedy", "beam", "pool"])
@pytest.mark.parametrize("name", list(DECODERS))
def test_caption_json_identical_to_jax_float32(jax_decoders, name, method):
    caps, out, over = jax_decoders["f32"]
    assert _port_captions(str(out / f"{name}.npz"), over[name], method) \
        == caps[name][method]


@pytest.mark.parametrize("method", ["greedy", "beam", "pool"])
@pytest.mark.parametrize("name", ["two_layers", "no_attention"])
def test_caption_json_matches_jax_bfloat16(jax_decoders, name, method):
    caps, out, over = jax_decoders["bf16"]
    want = caps[name][method]
    got = _port_captions(str(out / f"{name}.npz"), over[name], method)
    assert got.keys() == want.keys()
    same = sum(got[v] == want[v] for v in want)
    assert same >= 0.9 * len(want), (same, len(want))


# ------------------------------------------------------------ the router

def _meta_decoder(cfg):
    with torch.device("meta"):
        return create_model(cfg, cfg.data.vocab_size).decoder


def test_kernel_decoder_holds_for_every_preset_and_no_other():
    """The route's first question (``CaptionDecoder.widths``): the
    decoder the recurrent kernels compute."""
    assert all(_meta_decoder(cfg).widths.lstm for cfg in PRESETS.values())
    for over in DECODERS.values():
        cfg = apply_overrides(get_preset("msrvtt_attn_beam5"), over)
        assert not _meta_decoder(cfg).widths.lstm


def _tiny(over, seed=0):
    cfg = apply_overrides(get_preset("synthetic_tiny"), over)
    ds = CaptionDataset.synthetic(cfg.data, num_videos=4)
    return Captioner(cfg, init_params(create_model(cfg, ds.vocab.size),
                                      seed).eval(), ds,
                     torch.device("cpu"), seed=3)


@pytest.mark.parametrize("name,int8,beam_kernels", [
    ("two_layers", False, ("topk_project",)),
    ("no_attention", False, ("topk_project",)),
    ("float32", False, ()),
    ("two_layers", True, ("topk_project_int8",)),
    ("float32", True, ("topk_project_int8",))])
def test_router_picks_the_module_step_and_the_projection(
        monkeypatch, name, int8, beam_kernels):
    """For each configuration: greedy and sampled run
    ``CaptionDecoder.step`` (K3 never), the beam runs ``step_beam_hidden``
    (K1 never) and the projection K2 for bf16 weights, K2-int8 with the
    flag, plain ``logits_topk`` for f32 weights without it; on CPU tensors
    no launch is counted."""
    cap = _tiny(DECODERS[name] + [f"decode.int8_vocab_projection={int8}"])
    assert cap.kernels("greedy") == cap.kernels("sample") == ()
    assert cap.kernels("beam") == beam_kernels
    calls = []
    for fn in ("step", "step_beam_hidden"):
        real = getattr(cap.model.decoder, fn)
        monkeypatch.setattr(cap.model.decoder, fn, lambda *a, _r=real,
                            _n=fn, **k: (calls.append(_n), _r(*a, **k))[1])
    for fn in ("beam_core", "topk_project", "topk_project_int8",
               "logits_topk"):
        if hasattr(decoding, fn):
            real = getattr(decoding, fn)
            monkeypatch.setattr(decoding, fn, lambda *a, _r=real, _n=fn,
                                **k: (calls.append(_n), _r(*a, **k))[1])
    before = dict(_build.launch_counts)
    feats = np.zeros((4, 8, 64), np.float32)
    cap.decode_batch(feats, method="greedy")
    cap.decode_batch(feats, method="sample")
    assert set(calls) == {"step"}
    calls.clear()
    cap.decode_batch(feats, method="beam", beam_width=3)
    proj = beam_kernels[0] if beam_kernels else "logits_topk"
    assert set(calls) == {"step_beam_hidden", proj}
    assert cap._weights._cell is None and cap._weights._rollout is None
    assert _build.launch_counts == before


def test_kernel_decoder_keeps_the_kernels_wrappers(monkeypatch):
    """The preset's decoder runs K1 (``beam_core``) and K2 in the beam and
    K3's wrapper (``model_rollout``) for greedy and sampled decode, on the
    CPU through their plain versions: no switch by dtype of tensor."""
    cap = _tiny([])
    calls = []
    import vidcap_tpu_torch.inference as inference
    for mod, fn in ((decoding, "beam_core"), (decoding, "topk_project"),
                    (inference, "model_rollout")):
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _r=real, _n=fn, **k: (
            calls.append(_n), _r(*a, **k))[1])
    feats = np.zeros((4, 8, 64), np.float32)
    cap.decode_batch(feats, method="beam", beam_width=3)
    assert {"beam_core", "topk_project"} <= set(calls)
    calls.clear()
    cap.decode_batch(feats, method="greedy")
    assert calls == ["model_rollout"]


def test_the_kernels_weights_keep_refusing_other_decoders():
    """K1's, K3's and K4's tensors of ``KernelWeights``; the projection,
    which every decoder's beam takes, is cast."""
    r = decoding.Route("beam_core", "topk_project", False, None)
    for over in DECODERS.values():
        if over == F32:
            continue   # on the CPU f32 weights are K1's plain version's
        w = KernelWeights(_tiny(over).model.decoder)
        for variant in (lambda: w.beam(r), w.rollout, w.teacher_forced):
            with pytest.raises(NotImplementedError,
                               match="route; ROADMAP Queue 1 item 5"):
                variant()
        assert w.projection(r).kernel == "topk_project"


# ------------------------------------------------------------ sampled

@pytest.mark.parametrize("seed,temperature", [(1, 1.0), (7, 0.7)])
def test_sample_decode_equals_k3_plain_one_layer(seed, temperature):
    """On the one-layer f32 decoder, ``sample_decode`` over
    ``CaptionDecoder.step`` draws what K3's plain version draws at the same
    seed (an int or a device int64 tensor); an output bias raised on <eos>
    makes some rows end."""
    cap = _tiny(F32)
    with torch.no_grad():
        cap.model.decoder.out_proj.bias[2] = 3.0
    g = np.random.default_rng(seed)
    feats = torch.tensor(g.normal(size=(6, 8, 64)), dtype=torch.float32)
    with torch.no_grad():
        st = cap.model.init_state(feats)
        w = KernelWeights(cap.model.decoder).rollout()
        tk, lk, mk = rollout_plain(w, st.keys, st.values, st.frame_mask,
                                   st.h[0], st.c[0], cap.max_len,
                                   sample=True, seed=seed,
                                   temperature=temperature)
        for s in (seed, torch.tensor(seed, dtype=torch.int64)):
            r = sample_decode(cap.model.decoder.step, st, 6, cap.max_len, s,
                              temperature)
            assert torch.equal(r.tokens, tk) and torch.equal(r.mask, mk)
            torch.testing.assert_close(r.logp, lk, rtol=0, atol=1e-6)
    assert (mk == 0).any()   # some rows end


@pytest.mark.parametrize("name", ["two_layers", "no_attention"])
def test_sampled_decode_is_deterministic_per_seed(name):
    cap = _tiny(DECODERS[name])
    feats = np.random.default_rng(0).normal(size=(4, 8, 64)).astype(
        np.float32)
    a, b, c = (cap.decode_batch(feats, method="sample", seed=s,
                                temperature=0.7) for s in (5, 5, 6))
    assert np.array_equal(a, b) and not np.array_equal(a, c)


# ------------------------------------------------------------ SCST

@pytest.fixture(scope="module")
def scst_pair():
    """A two-layer f32 ``synthetic_tiny`` decoder in both packages, from the
    JAX ``init_params``, at the SCST stage with the XE anchor and the
    attribute head."""
    over = DECODERS["two_layers"] + F32 + [
        "train.stage=scst", "train.batch_size=8",
        "train.attribute_loss_weight=0.2"]
    jcfg = jax_apply_overrides(jax_get_preset("synthetic_tiny"), over)
    jds = JaxDataset.synthetic(jcfg.data)
    jm = jax_create_model(jcfg, jds.vocab.size)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jax_init_params(jm, jcfg, k))(jax.random.key(0)))
    cfg = apply_overrides(get_preset("synthetic_tiny"), over)
    ds = CaptionDataset.synthetic(cfg.data)
    state = create_train_state(cfg, from_flax(create_model(
        cfg, ds.vocab.size), params))
    jb = next(JaxBatcher(jds, 8, seed=0))
    batch = {k: getattr(jb, k) for k in ("features", "tokens", "mask",
                                         "attributes", "video_idx")}
    return jcfg, jds, jm, params, cfg, ds, state, batch


def test_scst_two_layers_greedy_identical_to_jax_xla(scst_pair):
    jcfg, _, jm, params, cfg, ds, state, batch = scst_pair
    step = make_scst_step_body(cfg, ds)
    b = batch_to_device(next(DeterministicBatcher(ds, 8, seed=0)), "cpu")
    np.testing.assert_array_equal(b["tokens"].numpy(), batch["tokens"])
    before = dict(_build.launch_counts)
    sample, greedy = step.rollouts(state, b, seed=4)
    assert _build.launch_counts == before and step.rollout_resident is None
    f = jnp.asarray(batch["features"])
    jst = jm.apply({"params": params}, f, method=JaxModel.init_state)
    jg = jax_decoding.greedy_decode(
        lambda s, t: jm.apply({"params": params}, s, t,
                              method=JaxModel.step),
        jst, 8, jcfg.decode.max_len)
    np.testing.assert_array_equal(greedy.tokens.numpy(),
                                  np.asarray(jg.tokens))
    np.testing.assert_array_equal(greedy.mask.numpy(), np.asarray(jg.mask))
    assert sample.tokens.shape == greedy.tokens.shape
    # the sampled rollout is sample_decode's at that seed
    with torch.no_grad():
        again = sample_decode(state.model.decoder.step,
                              state.model.init_state(b["features"]), 8,
                              cfg.decode.max_len, 4, cfg.decode.temperature)
    assert torch.equal(again.tokens, sample.tokens)


def test_scst_two_layers_update_matches_jax(scst_pair, monkeypatch):
    """Fed the port's rollouts, the JAX step (its default fused-rollout
    branch, whose ``dual_rollout`` returns them) and the port's update give
    the same rewards, loss pieces and gradient norm."""
    jcfg, jds, jm, params, cfg, ds, state, batch = scst_pair
    step = make_scst_step_body(cfg, ds)
    b = batch_to_device(next(DeterministicBatcher(ds, 8, seed=0)), "cpu")
    sample, greedy = step.rollouts(state, b, seed=9)
    js, jg = (jax_decoding.Rollout(tokens=jnp.asarray(r.tokens.numpy()),
                                   logp=jnp.zeros(r.logp.shape),
                                   mask=jnp.asarray(r.mask.numpy()))
              for r in (sample, greedy))
    monkeypatch.setattr(jax_decoding, "dual_rollout",
                        lambda *a, **k: (jg, js))
    jbody = jax_scst_body(jm, jcfg, tables=jax_tables(jds))
    _, jmet = jax.jit(jbody)(jax_train_state(jcfg, params), batch)
    _, m = step.update(state, b, sample, greedy)
    for k, rtol in (("reward_sample", 1e-5), ("reward_greedy", 1e-5),
                    ("pg_loss", 1e-6), ("xe_anchor", 1e-6),
                    ("attr_loss", 1e-6), ("loss", 1e-6),
                    ("grad_norm", 1e-5)):
        np.testing.assert_allclose(float(m[k]), float(jmet[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)


def test_scst_two_layers_body_reads_nothing_on_the_host(scst_pair):
    """The step body with its seed in a device buffer (the captured step's
    input) under a mode that raises on any host read: a CUDA graph could
    hold it."""
    *_, cfg, ds, state, _ = scst_pair
    step = make_scst_step_body(cfg, ds)
    b = batch_to_device(next(DeterministicBatcher(ds, 8, seed=1)), "cpu")
    b["seed"] = torch.tensor([3], dtype=torch.int64)
    with NoHostRead():
        _, m = step.body(state, b)
    assert np.isfinite(float(m["loss"]))
