"""The port's end-to-end pixel path against the JAX package on the CPU: the
``e2e`` XE step through the backbone with its ``backbone_lr_scale`` group,
the composed ``e2e_scst_multitask`` step (one encode a step, fed the same
rollouts as the JAX step), the staged CLI on frame files with a cross-stage
resume, ``caption`` on pixels against the JAX CLI, and, with cv2, video
decode, ``extract`` and a served video caption.

Both packages run the JAX tests' tiny backbone (width 1/16, depth (1, 1, 1),
patched into both ``InceptionResNetV2``s as tests/test_composed_e2e.py does;
its compute dtype float32 unless the caller gives one) under
``synthetic_tiny`` widths with 2 frames of 75 × 75 pixels, in float32,
weights from JAX ``init_params`` through ``convert.from_flax``.

Tolerances, and why:
* losses 1e-5 relative, the gradient norm 1e-4 relative: the backbone's
  f32 convolutions sum their products in another order (measured 3.9e-7 on
  its output, tests/test_torch_backbone.py), and the gradient norm sums
  ~160 leaves.
* the parameters after 2 Adam steps: 5e-5 absolute (lr 3e-3; Adam divides
  by sqrt(ν), so a gradient element of ~1e-7 that differs in its last bits
  moves its parameter by up to lr a step, as tests/test_torch_train.py
  says).
* the backbone group's update against Optax ``multi_transform``: identical.
* captions (greedy, float32): identical; extracted features 1e-4 relative.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vidcap_tpu.config import apply_overrides as jax_apply_overrides
from vidcap_tpu.config import get_preset as jax_get_preset
from vidcap_tpu.data.loader import CaptionDataset as JaxDataset
from vidcap_tpu.models import backbone as jax_bb
from vidcap_tpu.models.model import create_model as jax_create_model
from vidcap_tpu.models.model import init_params as jax_init_params
from vidcap_tpu.objectives.reward_tables import \
    tables_from_dataset as jax_tables
from vidcap_tpu.train.state import create_train_state as jax_train_state
from vidcap_tpu.train.state import make_optimizer as jax_make_optimizer
from vidcap_tpu_torch.cli.main import main as cli_main
from vidcap_tpu_torch.config import apply_overrides, get_preset
from vidcap_tpu_torch.convert import flatten_tree, from_flax
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.models import backbone as bb
from vidcap_tpu_torch.models.model import create_model
from vidcap_tpu_torch.train.scst import make_scst_step_body
from vidcap_tpu_torch.train.state import create_train_state, make_optimizer
from vidcap_tpu_torch.train.steps import make_xe_step_body

jax.config.update("jax_platforms", "cpu")

TINY = dict(width_mult=0.0625, depth=(1, 1, 1))
# synthetic_tiny reshaped for the tiny backbone, in float32
E2E = ["data.num_frames=2", "data.frame_size=75", "data.feature_dim=96",
       "model.use_backbone=true", "model.compute_dtype=float32",
       "train.batch_size=2", "train.attribute_loss_weight=0.2",
       "train.scst_xe_mix=0.1", "train.scst_learning_rate=1e-4"]
# the e2e presets cut to the same size, for the CLIs
CUT = E2E + ["data.dataset=synthetic", "data.vocab_size=256",
             "data.max_caption_len=12", "data.num_attributes=32",
             "model.embed_dim=32", "model.hidden_dim=32", "model.attn_dim=32",
             "decode.max_len=12"]


@pytest.fixture(autouse=True, scope="module")
def tiny_backbones():
    """Both packages' ``InceptionResNetV2`` at the tiny width and depth
    (float32 unless the caller gives a dtype); one torch thread (small
    convolutions on a shared CPU)."""
    mp = pytest.MonkeyPatch()
    jax_orig, port_orig = jax_bb.InceptionResNetV2, bb.InceptionResNetV2
    mp.setattr(jax_bb, "InceptionResNetV2", lambda **kw: jax_orig(
        **{**TINY, "compute_dtype": jnp.float32, **kw}))
    mp.setattr(bb, "InceptionResNetV2", lambda **kw: port_orig(
        **{**TINY, "compute_dtype": torch.float32, **kw}))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    mp.undo()


def _cfgs(*over):
    return (jax_apply_overrides(jax_get_preset("synthetic_tiny"), E2E + list(over)),
            apply_overrides(get_preset("synthetic_tiny"), E2E + list(over)))


@pytest.fixture(scope="module")
def corpus():
    """(JAX dataset, port dataset, JAX init params as numpy): the
    synthetic pixel corpus (16 videos) and the seeded JAX init."""
    jcfg, cfg = _cfgs()
    jds = JaxDataset.synthetic(jcfg.data, num_videos=16, pixels=True)
    ds = CaptionDataset.synthetic(cfg.data, num_videos=16, pixels=True)
    assert np.array_equal(jds.features, ds.features)
    model = jax_create_model(jcfg, jds.vocab.size)
    params = jax.jit(lambda k: jax_init_params(model, jcfg, k))(
        jax.random.key(0))
    return jds, ds, jax.tree_util.tree_map(np.asarray, params)


def _batch(ds, B=2, seed=0):
    """A pixel batch as numpy (the same arrays go to both packages)."""
    rng = np.random.default_rng(seed)
    vidx = rng.integers(0, ds.num_videos, size=B).astype(np.int32)
    rows = np.array([np.flatnonzero(ds.caption_video_idx == v)[0]
                     for v in vidx])
    return {"features": ds.features[vidx], "tokens": ds.tokens[rows],
            "mask": ds.mask[rows], "attributes": ds.attributes[vidx],
            "video_idx": vidx}


def _port_state(cfg, ds, params, stage):
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             stage=stage))
    model = from_flax(create_model(cfg, ds.vocab.size), params)
    return cfg, create_train_state(cfg, model)


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ------------------------------------------------------------------ e2e XE

def test_e2e_xe_step_matches_jax(corpus):
    """Two ``e2e`` steps (XE + BCE through the backbone): the metrics of
    each and the parameters after, the backbone's moved at 0.1× the rate."""
    jds, ds, params = corpus
    jcfg, cfg = _cfgs("train.stage=e2e")
    from vidcap_tpu.train.steps import make_xe_step_body as jax_xe_body
    jstep = jax.jit(jax_xe_body(jax_create_model(jcfg, jds.vocab.size), jcfg))
    jstate = jax_train_state(jcfg, params)
    cfg, state = _port_state(cfg, ds, params, "e2e")
    body = make_xe_step_body(cfg)
    table = state.opt_state["table"]
    np.testing.assert_allclose(table[3].numpy(), 0.1 * table[0].numpy(),
                               rtol=1e-6)
    for i in range(2):
        b = _batch(jds, seed=i)
        jstate, jm = jstep(jstate, b)
        state, m = body(state, _t(b))
        for k in ("xe_loss", "attr_loss", "loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = {k.replace(".", "/"): p.detach().numpy()
           for k, p in state.model.named_parameters()}
    moved = []
    for k, w in want.items():
        g = got[k] if got[k].ndim != 4 else np.transpose(got[k], (2, 3, 1, 0))
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=0, err_msg=k)
        moved.append(np.abs(w - flatten_tree(params)[k]).max())
    assert max(moved) > 0


@pytest.mark.parametrize("schedule", ["constant", "cosine_warmup"])
@pytest.mark.parametrize("stage", ["e2e", "scst"])
def test_backbone_group_matches_multi_transform(schedule, stage):
    """The port's update against Optax's ``multi_transform`` chain of the
    reference (global clip, then the backbone group at
    ``lr · backbone_lr_scale``), bit for bit over 3 steps, on a backbone and
    a decoder leaf with a gradient large enough to clip."""
    over = [f"train.stage={stage}", "train.num_steps=10",
            "train.backbone_lr_scale=0.3", "train.weight_decay=0.01"]
    if schedule == "cosine_warmup":
        over += ["train.lr_schedule=cosine", "train.warmup_steps=2"]
    jcfg, cfg = _cfgs(*over)
    rng = np.random.default_rng(6)
    p0 = {"backbone": {"c": rng.normal(size=(3, 4)).astype(np.float32)},
          "decoder": {"d": rng.normal(size=(5,)).astype(np.float32)}}
    jtx = jax_make_optimizer(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jst = jtx.init(jp)
    tx = make_optimizer(cfg)
    assert tx.backbone_schedule is not None
    tp = {"backbone.c": torch.tensor(p0["backbone"]["c"]),
          "decoder.d": torch.tensor(p0["decoder"]["d"])}
    tst = tx.init(tp)
    for _ in range(3):
        g = {"backbone": {"c": rng.normal(size=(3, 4)).astype(np.float32)
                          * 4},
             "decoder": {"d": rng.normal(size=(5,)).astype(np.float32)}}
        upd, jst = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), jst,
                              jp)
        jp = optax.apply_updates(jp, upd)
        tx.update(tp, {"backbone.c": torch.tensor(g["backbone"]["c"]),
                       "decoder.d": torch.tensor(g["decoder"]["d"])}, tst)
    np.testing.assert_array_equal(tp["backbone.c"].numpy(),
                                  np.asarray(jp["backbone"]["c"]))
    np.testing.assert_array_equal(tp["decoder.d"].numpy(),
                                  np.asarray(jp["decoder"]["d"]))


# ------------------------------------------------------------------ SCST

def test_composed_scst_step_matches_jax(corpus, monkeypatch):
    """The ``e2e_scst_multitask`` step (PG + XE anchor + attribute BCE
    through the backbone) fed the same rollouts on both sides: the rewards,
    loss pieces and gradient norm of the JAX step."""
    jds, ds, params = corpus
    jcfg, cfg = _cfgs("train.stage=scst", "model.use_pallas_decoder=true")
    cfg, state = _port_state(cfg, ds, params, "scst")
    step = make_scst_step_body(cfg, ds)
    batch = _batch(jds, seed=3)
    # the port's K3 rollouts (the plain version on the CPU) on its encode
    sample, greedy = step.rollouts(
        state, _t(batch), seed=5,
        feats=state.model.encode_features(_t(batch)["features"]))
    from vidcap_tpu.models.decoding import Rollout as JaxRollout
    from vidcap_tpu.ops import pallas_decoder
    js, jg = (JaxRollout(tokens=jnp.asarray(r.tokens.numpy()),
                         logp=jnp.asarray(r.logp.numpy()),
                         mask=jnp.asarray(r.mask.numpy()))
              for r in (sample, greedy))
    monkeypatch.setattr(pallas_decoder, "model_rollout",
                        lambda *a, sample=False, **k: js if sample else jg)
    from vidcap_tpu.train.scst import make_scst_step_body as jax_scst_body
    jbody = jax_scst_body(jax_create_model(jcfg, jds.vocab.size), jcfg,
                          tables=jax_tables(jds))
    _, jm = jax.jit(jbody)(jax_train_state(jcfg, params), batch)
    feats = state.model.encode_features(_t(batch)["features"])
    _, m = step.update(state, _t(batch), sample, greedy, feats=feats)
    for k in ("reward_sample", "reward_greedy", "pg_loss", "xe_anchor",
              "attr_loss", "loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("stage", ["scst", "e2e"])
def test_one_backbone_forward_a_step(corpus, stage, accum):
    """A forward hook on the backbone (outside the blocks that remat
    recomputes) counts one encode a step (a microbatch with
    ``grad_accum``), whatever reads the features: both rollouts, the PG
    re-score, the XE anchor and the attribute head."""
    _, ds, params = corpus
    _, cfg = _cfgs(f"train.grad_accum={accum}", "train.batch_size=4")
    cfg, state = _port_state(cfg, ds, params, stage)
    body = (make_scst_step_body(cfg, ds) if stage == "scst"
            else make_xe_step_body(cfg))
    calls = []
    state.model.backbone.register_forward_hook(
        lambda *a: calls.append(1))
    before = state.model.backbone.conv7b.bn_offset.detach().clone()
    for i in range(2):
        b = _t(_batch(ds, B=4, seed=i))
        if stage == "scst":
            b["seed"] = torch.arange(accum, dtype=torch.int64) + i
        state, m = body(state, b)
        assert len(calls) == (i + 1) * accum
        assert all(np.isfinite(float(v)) for v in m.values())
    assert not torch.equal(before, state.model.backbone.conv7b.bn_offset)


def test_each_scst_term_reaches_the_backbone(corpus):
    """The PG term, the XE anchor and the attribute BCE each have a nonzero
    gradient on the backbone's parameters, through the one encode."""
    _, ds, params = corpus
    _, cfg = _cfgs()
    cfg, state = _port_state(cfg, ds, params, "scst")
    step = make_scst_step_body(cfg, ds)
    b = _t(_batch(ds, seed=4))
    feats = state.model.encode_features(b["features"])
    sample, greedy = step.rollouts(state, b, seed=7, feats=feats)
    pg, xe, _, bce, _ = step.pieces(state.model, b, sample, greedy,
                                    feats=feats)
    bb_params = list(state.model.backbone.parameters())
    for name, term in (("pg", pg), ("xe anchor", xe), ("attr", bce)):
        grads = torch.autograd.grad(term, bb_params, retain_graph=True,
                                    allow_unused=True)
        norm = sum(float(g.abs().sum()) for g in grads if g is not None)
        assert norm > 0, name


# ------------------------------------------------------------------ CLI

def _write_frames(d, ds, split="train"):
    """``ds``'s pixels as uint8 frame files, with ids, captions and vocab:
    the layout ``CaptionDataset.from_frame_files`` reads."""
    os.makedirs(d, exist_ok=True)
    u8 = np.clip(np.round((ds.features + 1.0) * 127.5), 0, 255).astype(
        np.uint8)
    np.save(os.path.join(d, f"msrvtt_{split}_frames.npy"), u8)
    with open(os.path.join(d, f"msrvtt_{split}_ids.json"), "w") as f:
        json.dump(ds.video_ids, f)
    with open(os.path.join(d, "msrvtt_captions.json"), "w") as f:
        json.dump(ds.video_captions, f)
    return u8


def test_train_cli_on_frame_files(corpus, tmp_path, monkeypatch, capsys):
    """``train --preset e2e_scst_multitask --stages xe,scst`` on frame files
    (uint8 → [-1, 1]), then an ``xe → e2e`` resume in another directory:
    the parameters of the XE checkpoint, the optimizer fresh (with its
    backbone group)."""
    _, ds, _ = corpus
    monkeypatch.chdir(tmp_path)
    data = str(tmp_path / "data")
    u8 = _write_frames(data, ds)
    cut = [c for c in CUT if c != "data.dataset=synthetic"]
    common = ["--preset", "e2e_scst_multitask", "--device", "cpu",
              "--log-every", "1", "--eval-every", "0"]
    for c in cut + [f"data.data_dir={data}"]:
        common += ["--set", c]
    loaded = CaptionDataset.from_frame_files(
        apply_overrides(get_preset("e2e_scst_multitask"),
                        cut + [f"data.data_dir={data}"]).data)
    np.testing.assert_array_equal(loaded.features,
                                  u8.astype(np.float32) / 127.5 - 1.0)
    assert cli_main(["train", *common, "--stages", "xe,scst", "--steps",
                     "1,1", "--log-file", "log.jsonl"]) == 0
    err = capsys.readouterr().err
    assert "[vidcap] xe: 1 steps on cpu" in err
    assert "[vidcap] scst: 1 steps on cpu" in err
    rows = [json.loads(x) for x in open("log.jsonl")]
    assert "xe_loss" in rows[0] and "pg_loss" in rows[1]
    assert all(np.isfinite(rows[1][k]) for k in ("xe_anchor", "attr_loss"))
    xe_dir = str(tmp_path / "xe")
    assert cli_main(["train", *common, "--stages", "xe", "--steps", "1",
                     "--checkpoint-dir", xe_dir]) == 0
    xe = torch.load(os.path.join(xe_dir, "ckpt_1.pt"), weights_only=True)
    capsys.readouterr()
    assert cli_main(["train", *common, "--stages", "e2e", "--steps", "2",
                     "--checkpoint-dir", xe_dir, "--resume"]) == 0
    assert "resuming across stages (xe → e2e): params restored, optimizer " \
        "re-initialised" in capsys.readouterr().err
    e2e = torch.load(os.path.join(xe_dir, "ckpt_2.pt"), weights_only=True)
    assert e2e["opt_state"]["count"] == 1   # fresh: one e2e update
    assert not torch.equal(e2e["params"]["backbone.conv7b.bn_offset"],
                           xe["params"]["backbone.conv7b.bn_offset"])


def test_caption_json_equal_to_jax_cli(corpus, tmp_path, monkeypatch):
    """``caption --preset e2e_scst_multitask --method greedy`` on the
    synthetic pixel fixture: the port on the JAX init's weights (``--weights``)
    writes the JSON the JAX CLI writes from a checkpoint of them."""
    monkeypatch.chdir(tmp_path)
    jcfg = jax_apply_overrides(jax_get_preset("e2e_scst_multitask"), CUT)
    jds = JaxDataset.synthetic(jcfg.data, pixels=True)
    model = jax_create_model(jcfg, jds.vocab.size)
    params = jax.jit(lambda k: jax_init_params(model, jcfg, k))(
        jax.random.key(1))
    from vidcap_tpu.train.checkpoint import CheckpointManager as JaxCkpt
    mgr = JaxCkpt(str(tmp_path / "jck"))
    mgr.save(jax_train_state(jcfg, params), stage="scst")
    mgr.wait()
    mgr.close()
    np.savez("w.npz", **flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                            params)))
    sets = sum((["--set", c] for c in CUT), [])
    from vidcap_tpu.cli.main import main as jax_main
    base = ["caption", "--preset", "e2e_scst_multitask", "--method",
            "greedy", *sets]
    assert jax_main(base + ["--checkpoint-dir", "jck", "--out",
                            "jax.json"]) == 0
    assert cli_main(base + ["--weights", "w.npz", "--device", "cpu",
                            "--out", "port.json"]) == 0
    want = json.loads(open("jax.json").read())
    assert len(want) == 64
    assert json.loads(open("port.json").read()) == want


# ------------------------------------------------------------------ video

def _clip(path, frames=12, size=(64, 48), seed=0):
    cv2 = pytest.importorskip("cv2")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, size)
    assert w.isOpened()
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        w.write(rng.integers(0, 255, size=(size[1], size[0], 3),
                             dtype=np.uint8))
    w.release()
    return path


def test_decode_video_frames_equal(tmp_path):
    from vidcap_tpu.data.frames import decode_video_frames as jax_decode
    from vidcap_tpu_torch.data.frames import decode_video_frames
    path = _clip(str(tmp_path / "clip.avi"))
    for n in (5, 12, 20):
        np.testing.assert_array_equal(decode_video_frames(path, n),
                                      jax_decode(path, n))
    (tmp_path / "bad.mp4").write_bytes(b"\0")
    with pytest.raises(RuntimeError, match="no frames decoded"):
        decode_video_frames(str(tmp_path / "bad.mp4"), 4)


@pytest.fixture()
def irv2_weights(corpus, tmp_path, monkeypatch):
    """The tiny backbone's JAX init as the ImageNet weights file both
    packages' loaders read (``$VIDCAP_IRV2_WEIGHTS``)."""
    params = corpus[2]["backbone"]
    path = str(tmp_path / "irv2.npz")
    jax_bb.save_backbone_params(params, path)
    monkeypatch.setenv("VIDCAP_IRV2_WEIGHTS", path)
    return path


def test_extract_rows_match_jax(tmp_path, irv2_weights):
    """``extract`` of a directory of clips: the same ids, rows within 1e-4
    of the JAX package's."""
    videos = tmp_path / "videos"
    videos.mkdir()
    for i in range(2):
        _clip(str(videos / f"v{i}.avi"), frames=8 + 3 * i, seed=i)
    from vidcap_tpu.data.frames import extract_features_for_dir as jax_ext
    out = {}
    for name in ("jax", "port"):
        over = E2E + ["data.dataset=msrvtt",
                      f"data.data_dir={tmp_path / name}"]
        if name == "jax":
            jax_ext(jax_apply_overrides(jax_get_preset("e2e_irv2"), over),
                    str(videos))
        else:
            sets = sum((["--set", c] for c in over), [])
            assert cli_main(["extract", "--preset", "e2e_irv2", *sets,
                             "--videos", str(videos), "--device",
                             "cpu"]) == 0
        d = tmp_path / name
        out[name] = (np.load(d / "msrvtt_train_feats.npy"),
                     json.loads((d / "msrvtt_train_ids.json").read_text()))
    assert out["port"][1] == out["jax"][1] == ["v0", "v1"]
    assert out["port"][0].shape == (2, 2, 96)
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=1e-4,
                               atol=1e-4 * np.abs(out["jax"][0]).max())


def test_served_video_caption_equal_to_jax(corpus, tmp_path, irv2_weights):
    """A video path on the stdin server: the JAX server's line. Both
    loaders decode with cv2 and encode with their own backbone from the
    weights file; the decoders share the JAX init's weights."""
    import io
    from vidcap_tpu.inference import Captioner as JaxCaptioner
    from vidcap_tpu.serving import CaptionServer as JaxServer
    from vidcap_tpu_torch.inference import Captioner
    from vidcap_tpu_torch.serving import CaptionServer
    jds, ds, params = corpus
    jcfg, cfg = _cfgs("model.use_backbone=false")
    jcap = JaxCaptioner.from_checkpoint(jcfg, jds, checkpoint_dir=None)
    model = from_flax(create_model(cfg, ds.vocab.size), jcap.params)
    cap = Captioner(cfg, model.eval(), ds, torch.device("cpu"))
    path = _clip(str(tmp_path / "clip.avi"), frames=9, seed=3)
    lines = []
    for server in (JaxServer(jcfg, jcap, batch_size=2, method="greedy"),
                   CaptionServer(cfg, cap, batch_size=2, method="greedy")):
        out = io.StringIO()
        assert server.run(inp=io.StringIO(path + "\n"), out=out,
                          warmup=False) == 1
        lines.append(out.getvalue())
    assert lines[0].startswith(path + "\t")
    assert lines[1] == lines[0]
