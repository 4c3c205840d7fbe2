"""The port's offline data and evaluation path against the JAX package on
the CPU: ``prepare`` → ``train`` with periodic validation and a best
checkpoint → ``caption --checkpoint-dir`` / ``--inputs`` → ``eval``, and the
feature containers.

The JAX training and captioning run in subprocesses, all at once
(tests/test_torch_slice.py's ``run_jax_scripts``), at ``synthetic_tiny``
size in float32. The port trains from a step-0 checkpoint holding the JAX
package's initial parameters, so both train the same model on the same
batch stream.

Tolerances, and why:
* validation scores 1e-6: the two trainings' parameters differ by float32
  summation order only (tests/test_torch_train.py: ≤ 5e-5 after 3 steps),
  which leaves every decoded token the same; the scores are then the same
  pure-Python arithmetic on the same strings.
* caption json, prepared files and feature arrays: identical.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_slice import (PYTHONPATH, kernel_route,  # noqa: F401
                              run_jax_scripts)
from vidcap_tpu.cli.main import main as jax_main
from vidcap_tpu.config import DataConfig as JaxDataConfig
from vidcap_tpu.data import feature_io as jax_io
from vidcap_tpu.data.prepare import prepare as jax_prepare
from vidcap_tpu_torch.cli.main import main as cli_main
from vidcap_tpu_torch.config import DataConfig, apply_overrides, get_preset
from vidcap_tpu_torch.convert import load_weights, save_weights
from vidcap_tpu_torch.data import feature_io
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.inference import Captioner
from vidcap_tpu_torch.models.model import create_model
from vidcap_tpu_torch.serving import _pad_batch
from vidcap_tpu_torch.train.checkpoint import CheckpointManager
from vidcap_tpu_torch.train.loop import run_validation, train
from vidcap_tpu_torch.train.state import create_train_state
from vidcap_tpu_torch.utils.logging import MetricsLogger

F32 = ["model.compute_dtype=float32"]
EVAL_TOL = 1e-6
SCORES = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr",
          "METEOR")

# JAX, one job a process. "validate": train() 4 XE steps with validation
# every 2 from init_params at train.seed, as cmd_train calls it on the
# synthetic split; the initial parameters as an .npz, the log rows and the
# step kept under best/. "inputs": the CLI trains 2 steps, captions the
# --inputs files (greedy, beam, beam --nbest 3) and the trained parameters
# are written as an .npz.
_JAX_JOB = """
import json, os, sys
import jax, numpy as np
jax.config.update("jax_platforms", "cpu")
from vidcap_tpu.cli.main import main
from vidcap_tpu.config import apply_overrides, get_preset
from vidcap_tpu.data.loader import CaptionDataset
from vidcap_tpu.inference import Captioner
from vidcap_tpu.models.model import create_model, init_params
from vidcap_tpu.train.checkpoint import CheckpointManager
from vidcap_tpu.train.loop import train
from vidcap_tpu.utils.logging import MetricsLogger
job, out = json.loads(sys.argv[1]), sys.argv[2]
os.chdir(out)
def save(params):
    flat = {}
    def walk(tree, prefix=""):
        for k, v in tree.items():
            if hasattr(v, "items"):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v)
    walk(params)
    np.savez("w.npz", **flat)
if job["kind"] == "validate":
    cfg = apply_overrides(get_preset("synthetic_tiny"),
                          job["over"] + ["train.checkpoint_dir=ckpt"])
    ds = CaptionDataset.synthetic(cfg.data)
    save(init_params(create_model(cfg, ds.vocab.size), cfg,
                     jax.random.key(cfg.train.seed)))
    logger = MetricsLogger(path="log.jsonl")
    train(cfg, dataset=ds, logger=logger, num_steps=4)
    logger.close()
    best = CheckpointManager("ckpt/best", max_to_keep=1)
    json.dump({"best": best.latest_step()}, open("best.json", "w"))
else:
    f32 = ["--set", "model.compute_dtype=float32"]
    assert main(["train", "--preset", "synthetic_tiny", "--steps", "2",
                 "--eval-every", "0"] + f32) == 0
    for name, extra in job["runs"].items():
        assert main(["caption", "--preset", "synthetic_tiny", "--inputs",
                     *job["inputs"], "--out", name + ".json"]
                    + extra + f32) == 0
    cfg = apply_overrides(get_preset("synthetic_tiny"), f32[1::2])
    save(Captioner.from_checkpoint(cfg, CaptionDataset.synthetic(cfg.data),
                                   "checkpoints").params)
"""

CAPTION_RUNS = {"greedy": ["--method", "greedy"],
                "beam": ["--method", "beam", "--beam", "5"],
                "nbest3": ["--method", "beam", "--beam", "5", "--nbest", "3"]}


def _write_inputs(root):
    """Per-frame features of 1-40 frames (synthetic_tiny keeps 8): five in
    a directory, two loose files, one of which shares its basename with a
    file of the directory; the directory scan skips a .txt."""
    g = np.random.default_rng(5)
    d = root / "feats"
    d.mkdir()
    (d / "notes.txt").write_text("not a feature file")
    paths = []
    for i, t in enumerate((1, 3, 8, 9, 40)):
        paths.append(d / f"clip_{i}.npy")
        np.save(paths[-1], g.normal(size=(t, 64)).astype(np.float32))
    loose = root / "loose"
    loose.mkdir()
    for name, t in (("clip_2.npy", 5), ("other.npy", 17)):
        np.save(loose / name, g.normal(size=(t, 64)).astype(np.float32))
    # the directory, a repeat of one of its files, the loose files
    return [str(d), str(d / "clip_0.npy"), str(loose / "clip_2.npy"),
            str(loose / "other.npy")]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("offline")
    inputs = _write_inputs(root)
    val = F32 + ["train.eval_every=2"]
    jobs = {"val_greedy": {"kind": "validate", "over": val},
            "val_beam": {"kind": "validate",
                         "over": val + ["train.eval_method=beam"]},
            "inputs": {"kind": "inputs", "inputs": inputs,
                       "runs": CAPTION_RUNS}}
    outs = {name: root / name for name in jobs}
    for out in outs.values():
        out.mkdir()
    run_jax_scripts(_JAX_JOB, [(job, outs[name])
                               for name, job in jobs.items()])
    return dict(outs=outs, inputs=inputs)


def _rows(path):
    with open(path) as f:
        return [json.loads(x) for x in f]


def _eval_rows(rows):
    return {r["step"]: r for r in rows if "eval_CIDEr" in r}


def best_step(evals):
    """The step the strict-> best-CIDEr rule keeps."""
    best, cider = None, -1.0
    for step in sorted(evals):
        if evals[step]["eval_CIDEr"] > cider:
            best, cider = step, evals[step]["eval_CIDEr"]
    return best


def _port_train(tmp_path, over, weights):
    """The port's train() from a step-0 checkpoint of ``weights``."""
    cfg = apply_overrides(get_preset("synthetic_tiny"),
                          over + [f"train.checkpoint_dir={tmp_path / 'c'}"])
    ds = CaptionDataset.synthetic(cfg.data)
    model = create_model(cfg, ds.vocab.size)
    load_weights(model, weights)
    CheckpointManager(cfg.train.checkpoint_dir).save(
        create_train_state(cfg, model), stage="xe")
    logger = MetricsLogger(path=str(tmp_path / "log.jsonl"), quiet=True)
    state = train(cfg, dataset=ds, logger=logger, num_steps=4, resume=True,
                  device="cpu")
    logger.close()
    return cfg, ds, state, _rows(tmp_path / "log.jsonl")


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_validation_rows_and_best_step_equal_jax(jax_runs, tmp_path,
                                                 method):
    """``train.eval_every=2`` over 4 XE steps: eval rows at steps 2 and 4
    equal to the JAX loop's (both on the 64-video train-subset fallback,
    flagged), the same best step under best/, which resume ignores; and the
    step-4 scores are those of a fresh Captioner on the checkpointed
    parameters (validation decodes the parameters as they are, never cast
    weights cached at an earlier evaluation)."""
    out = jax_runs["outs"][f"val_{method}"]
    over = F32 + ["train.eval_every=2", f"train.eval_method={method}"]
    cfg, ds, state, rows = _port_train(tmp_path, over, str(out / "w.npz"))
    port, ref = _eval_rows(rows), _eval_rows(_rows(out / "log.jsonl"))
    assert sorted(port) == sorted(ref) == [2, 4]
    for step in (2, 4):
        assert port[step]["eval_on_train_fallback"] == 1.0 \
            == ref[step]["eval_on_train_fallback"]
        for k in SCORES:
            assert abs(port[step][f"eval_{k}"] - ref[step][f"eval_{k}"]) \
                <= EVAL_TOL, (step, k)
    assert port[2]["eval_CIDEr"] != port[4]["eval_CIDEr"]
    best = json.loads((out / "best.json").read_text())["best"]
    assert best == best_step(port)
    ckpt = CheckpointManager(cfg.train.checkpoint_dir)
    assert CheckpointManager(os.path.join(cfg.train.checkpoint_dir,
                                          "best")).all_steps() == [best]
    assert ckpt.all_steps() == [0, 4]
    fresh = Captioner.from_checkpoint(cfg, ds, device="cpu",
                                      checkpoint_dir=cfg.train.checkpoint_dir)
    again = run_validation(cfg, fresh, ds)
    assert again == {k: port[4][f"eval_{k}"] for k in SCORES}
    assert state.model.training


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_validation_rows_and_best_step_equal_jax_on_the_kernel_route(
        jax_runs, tmp_path, kernel_route, method):
    """The same rows and best step with the f32 decoder on the kernel
    decoder's steps (K1/K2's and K3's plain versions here), whose weights
    a Captioner casts once: validation must not decode stale casts."""
    test_validation_rows_and_best_step_equal_jax(jax_runs, tmp_path, method)
    assert kernel_route["fused_beam_step" if method == "beam"
                        else "model_rollout"] > 0


def test_validation_leaves_training_exact(tmp_path):
    """SCST with validation every 2 steps: the parameters, optimizer state
    and generator after 4 steps equal those of the run without validation,
    and those of 2 steps, a checkpoint and 2 resumed steps."""
    from test_torch_train import _run, _same_state
    over = ["train.stage=scst"]
    plain = _run(tmp_path, "a", over, num_steps=4)
    evald = _run(tmp_path, "b", over + ["train.eval_every=2"], num_steps=4)
    _run(tmp_path, "c", over + ["train.eval_every=2"], num_steps=2)
    resumed = _run(tmp_path, "c", over + ["train.eval_every=2"], num_steps=4,
                   resume=True)
    _same_state(plain, evald)
    _same_state(plain, resumed)
    assert CheckpointManager(str(tmp_path / "c" / "best")).all_steps()


@pytest.mark.parametrize("run", sorted(CAPTION_RUNS))
def test_caption_inputs_json_identical_to_jax(jax_runs, run, capsys):
    """``caption --inputs`` over a directory and loose files (1-40 frames,
    a repeated path, a shared basename) on the JAX CLI's trained
    parameters: the same keys and captions as the JAX CLI's."""
    out = jax_runs["outs"]["inputs"]
    got = out / f"port_{run}.json"
    assert cli_main(["caption", "--preset", "synthetic_tiny", "--weights",
                     str(out / "w.npz"), "--device", "cpu", "--inputs",
                     *jax_runs["inputs"], "--out", str(got)]
                    + CAPTION_RUNS[run]
                    + ["--set", "model.compute_dtype=float32"]) == 0
    want = json.loads((out / f"{run}.json").read_text())
    assert json.loads(got.read_text()) == want
    loose = os.path.normpath(jax_runs["inputs"][2])
    assert len(want) == 7 and loose in want and "clip_0" in want
    assert all(len(c) == (3 if run == "nbest3" else 1) for c in want.values())
    assert "kernel launches" in capsys.readouterr().err


def test_caption_inputs_equals_decode_batch(jax_runs):
    """The CLI's batches are ``_pad_batch`` + ``Captioner.decode_batch``:
    frames past num_frames cut, the filler rows' mask all zero."""
    out = jax_runs["outs"]["inputs"]
    cfg = apply_overrides(get_preset("synthetic_tiny"), F32)
    ds = CaptionDataset.synthetic(cfg.data)
    cap = Captioner.from_checkpoint(cfg, ds, weights=str(out / "w.npz"),
                                    device="cpu")
    d = jax_runs["inputs"][0]
    feats = [np.load(os.path.join(d, f"clip_{i}.npy")) for i in range(5)]
    batch, mask = _pad_batch(cfg, feats, cfg.train.batch_size * 2)
    assert mask.sum(1).tolist() == [1, 3, 8, 8, 8, 0, 0, 0]
    np.testing.assert_array_equal(batch[4], feats[4][:8])
    toks = cap.decode_batch(batch, method="greedy", frame_mask=mask)
    want = json.loads((out / "greedy.json").read_text())
    for i in range(5):
        key = os.path.join(d, "clip_2.npy") if i == 2 else f"clip_{i}"
        assert [ds.vocab.decode_str(toks[i])] == want[key]


@pytest.mark.parametrize("make,message", [
    (lambda root: [str(root / "notes.txt")], "is not a supported input"),
    (lambda root: [str(root / "absent.npy")], "does not exist"),
    (lambda root: [str(root / "empty")], "--inputs matched no files")])
def test_caption_inputs_errors_are_jax_s(tmp_path, make, message):
    (tmp_path / "notes.txt").write_text("x")
    (tmp_path / "empty").mkdir()
    args = ["caption", "--preset", "synthetic_tiny", "--inputs",
            *make(tmp_path)]
    with pytest.raises(SystemExit, match=message) as port:
        cli_main(args + ["--device", "cpu"])
    with pytest.raises(SystemExit) as ref:
        jax_main(args)
    assert str(port.value) == str(ref.value)


def test_caption_inputs_video_and_nbest_refused(tmp_path, monkeypatch):
    """A video file in ``--inputs`` goes through cv2 and the IRv2 backbone:
    a corrupt clip fails with the JAX loader's own error, and a real clip
    (with cv2) captions, at the tiny backbone's width; --nbest needs
    beam."""
    from vidcap_tpu.serving import _FeatureLoader as JaxLoader
    from vidcap_tpu_torch.models import backbone as bb
    orig = bb.InceptionResNetV2
    monkeypatch.setattr(bb, "InceptionResNetV2", lambda **kw: orig(
        width_mult=0.0625, depth=(1, 1, 1), **kw))
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(b"\0")
    over = ["data.feature_dim=96", "data.frame_size=75"]
    cfg = apply_overrides(get_preset("synthetic_tiny"), over)
    save_weights(create_model(cfg, CaptionDataset.synthetic(
        cfg.data).vocab.size), str(tmp_path / "w.npz"))
    args = ["caption", "--preset", "synthetic_tiny", "--device", "cpu",
            "--weights", str(tmp_path / "w.npz"), "--set", over[0], "--set",
            over[1], "--inputs"]
    with pytest.raises(RuntimeError) as want:
        JaxLoader(cfg)(str(clip))
    with pytest.raises(RuntimeError) as got:
        cli_main(args + [str(clip)])
    assert str(got.value) == str(want.value)
    cv2 = pytest.importorskip("cv2")
    real = str(tmp_path / "real.avi")
    w = cv2.VideoWriter(real, cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    for i in range(6):
        w.write(np.full((48, 64, 3), 40 * i, np.uint8))
    w.release()
    out = str(tmp_path / "caps.json")
    assert cli_main(args + [real, "--out", out]) == 0
    caps = json.loads(open(out).read())
    assert list(caps) == ["real"] and isinstance(caps["real"][0], str)
    with pytest.raises(SystemExit, match="requires --method beam"):
        cli_main(["caption", "--preset", "synthetic_tiny", "--method",
                  "greedy", "--nbest", "2", "--inputs", str(tmp_path)])


def test_caption_checkpoint_dir_equals_weights(tmp_path, capsys,
                                               monkeypatch):
    """``caption`` from the port's own checkpoint (the newest step of
    --checkpoint-dir, or of train.checkpoint_dir by default) equals
    ``caption --weights`` on the same parameters; an empty or absent
    directory exits 2 with the FileNotFoundError; both flags are refused."""
    monkeypatch.chdir(tmp_path)
    base = ["--preset", "synthetic_tiny", "--device", "cpu"]
    assert cli_main(["train", *base, "--steps", "2", "--eval-every",
                     "0"]) == 0
    cfg = get_preset("synthetic_tiny")
    ds = CaptionDataset.synthetic(cfg.data)
    model = create_model(cfg, ds.vocab.size)
    state = CheckpointManager("checkpoints").restore(
        create_train_state(cfg, model))
    assert state.step == 2
    save_weights(model, "w.npz")
    outs = {}
    for name, src in (("weights", ["--weights", "w.npz"]),
                      ("dir", ["--checkpoint-dir", "checkpoints"]),
                      ("default", [])):
        outs[name] = f"{name}.json"
        assert cli_main(["caption", *base, "--method", "beam", *src,
                         "--out", outs[name]]) == 0
    caps = [json.load(open(p)) for p in outs.values()]
    assert caps[0] == caps[1] == caps[2] and len(caps[0]) == 64
    os.makedirs("empty")
    for d in ("empty", "absent"):
        capsys.readouterr()
        assert cli_main(["caption", *base, "--checkpoint-dir", d]) == 2
        assert f"no checkpoint found in {d!r}" in capsys.readouterr().err
    assert not os.path.exists("absent")
    with pytest.raises(SystemExit, match="not both"):
        cli_main(["caption", *base, "--weights", "w.npz",
                  "--checkpoint-dir", "checkpoints"])


def _eval_both(args, capsys):
    """(port rc, stdout, stderr) and the JAX CLI's, on the same args; a
    SystemExit is returned as its message."""
    out = []
    for main in (cli_main, jax_main):
        try:
            rc = main(args)
        except SystemExit as e:
            rc = str(e)
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


def test_eval_prints_the_jax_json(tmp_path, capsys):
    """``eval --refs`` (a video without references among the candidates, an
    empty reference list) and ``eval --split`` (the synthetic split's
    references) print the JAX CLI's json and notice."""
    refs = {"v1": ["a man rides a horse", "someone rides"],
            "v2": ["a cat sits on a mat."], "v3": []}
    res = {"v1": ["a man rides a horse"], "v2": ["A cat sits"],
           "v3": ["a dog"], "v_unknown": ["mystery clip"]}
    rp, cp = tmp_path / "refs.json", tmp_path / "caps.json"
    rp.write_text(json.dumps(refs))
    cp.write_text(json.dumps(res))
    port, ref = _eval_both(["eval", "--preset", "synthetic_tiny",
                            "--captions", str(cp), "--refs", str(rp)], capsys)
    assert port == ref and port[0] == 0
    assert "2 candidate video(s) have no references" in port[2]
    assert json.loads(port[1])["Bleu_1"] > 0.5
    cfg = get_preset("synthetic_tiny")
    ds = CaptionDataset.synthetic(cfg.data)
    g = np.random.default_rng(0)
    caps = {v: [ds.video_captions[v][int(g.integers(3))] if i % 2 else
                "a man is doing something"]
            for i, v in enumerate(ds.video_ids[:20])}
    cp.write_text(json.dumps(caps))
    port, ref = _eval_both(["eval", "--preset", "synthetic_tiny",
                            "--captions", str(cp), "--split", "test"], capsys)
    assert port == ref and port[0] == 0
    assert set(json.loads(port[1])) == set(SCORES)


@pytest.mark.parametrize("refs,message", [
    ([["a cat"]], "json object"),
    ({"v": "a cat"}, "must be a list"),
    ({"w": ["a cat"]}, "no video ids in common"),
    ({"v": []}, "no video ids in common")])
def test_eval_refs_exits_like_jax(tmp_path, capsys, refs, message):
    rp, cp = tmp_path / "refs.json", tmp_path / "caps.json"
    rp.write_text(json.dumps(refs))
    cp.write_text(json.dumps({"v": ["a cat"]}))
    port, ref = _eval_both(["eval", "--captions", str(cp), "--refs",
                            str(rp)], capsys)
    assert port == ref and message in port[0]


# ---------------------------------------------------------------- prepare

MSVD_CSV = """VideoID,Start,End,WorkerID,Source,AnnotationTime,Language,Description
vidA,1,10,1,x,1,English,A man is playing a guitar
vidA,1,10,2,x,1,English,Someone plays guitar
vidA,1,10,3,x,1,Spanish,Un hombre toca la guitarra
vidB,5,20,1,x,1,English,A dog runs in the park
vidB,5,20,2,x,1,English,
vidC,0,4,1,x,1,English,"A woman, smiling, slices a tomato."
"""


def _msrvtt(n0, splits):
    g = np.random.default_rng(n0)
    words = "a man woman dog cat runs is cooking food people dance".split()
    videos = [{"video_id": f"video{n0 + i}", "split": s}
              for i, s in enumerate(splits)]
    sentences = [{"video_id": v["video_id"],
                  "caption": " ".join(g.choice(words, int(g.integers(2, 8))))}
                 for v in videos for _ in range(int(g.integers(1, 4)))]
    return {"videos": videos, "sentences": sentences}


def _annotations(tmp_path, kind):
    """(dataset, annotation paths, mapping) for one hand-made corpus."""
    if kind.startswith("msvd"):
        csv = tmp_path / "msvd.csv"
        csv.write_text(MSVD_CSV)
        mapping = None
        if kind == "msvd_mapping":
            mapping = tmp_path / "youtube_mapping.txt"
            mapping.write_text("vidB_5_20 vid1\nvidA_1_10 vid2\n"
                               "vidX_0_1 vid3\nvidC_0_4 vid1250\n"
                               "junk line\n")
            mapping = str(mapping)
        return "msvd", [str(csv)], mapping
    paths = []
    for name, n0, splits in (
            ("train_val", 0, ["train"] * 6 + ["validate"] * 2),
            ("test", 8, ["test"] * 3)):
        paths.append(str(tmp_path / f"{name}_videodatainfo.json"))
        with open(paths[-1], "w") as f:
            json.dump(_msrvtt(n0, splits), f)
    return "msrvtt", paths, None


@pytest.mark.parametrize("kind", ["msvd", "msvd_mapping", "msrvtt"])
def test_prepare_writes_the_jax_files(tmp_path, kind, capsys):
    """The port's ``prepare`` (through its CLI) writes the files the JAX
    package's writes, byte for byte, and ``from_files`` loads them."""
    ds_name, ann, mapping = _annotations(tmp_path, kind)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    args = ["prepare", "--preset", "synthetic_tiny", "--set",
            f"data.dataset={ds_name}", "--set", "data.min_word_count=1",
            *ann] + (["--mapping", mapping] if mapping else [])
    assert cli_main(args + ["--set", f"data.data_dir={port_dir}"]) == 0
    port_out = capsys.readouterr().out
    jax_prepare(JaxDataConfig(dataset=ds_name, data_dir=str(jax_dir),
                              feature_dim=64, num_frames=8,
                              min_word_count=1), ann, mapping=mapping)
    assert capsys.readouterr().out == port_out
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names and len(names) >= 4
    for n in names:
        assert (port_dir / n).read_bytes() == (jax_dir / n).read_bytes(), n
    cfg = DataConfig(dataset=ds_name, data_dir=str(port_dir),
                     feature_dim=64, num_frames=8, min_word_count=1)
    ids = json.loads((port_dir / f"{ds_name}_train_ids.json").read_text())
    np.save(port_dir / f"{ds_name}_train_feats.npy",
            np.zeros((len(ids), 8, 64), np.float32))
    ds = CaptionDataset.from_files(cfg, split="train")
    assert ds.num_videos == len(ids) > 0 and ds.num_captions > 0


# ---------------------------------------------------------- feature files

def _features(dtype):
    g = np.random.default_rng(3)
    if dtype == "uint8":
        return g.integers(0, 256, (3, 2, 4, 4, 3)).astype(np.uint8)
    return g.normal(size=(3, 5, 6)).astype(np.float32)


IDS = ["vb", "va", "vc"]


def _round_trip(tmp_path, writer, reader, fmt, dtype):
    feats = _features(dtype)
    path = writer.save_features(str(tmp_path / "f"), feats, IDS, fmt=fmt)
    got, ids = reader.load_features(path)
    np.testing.assert_array_equal(got, feats)
    assert got.dtype == feats.dtype
    assert ids == (None if fmt == "npy" else IDS)
    if fmt != "npy":   # rows follow the ids asked for
        got, ids = reader.load_features(path, ["vc", "vb"])
        np.testing.assert_array_equal(got, feats[[2, 0]])
        assert ids == ["vc", "vb"]


@pytest.mark.parametrize("fmt", ["npy", "h5"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("direction", ["jax_writes", "port_writes"])
def test_feature_files_cross_packages(tmp_path, fmt, dtype, direction):
    w, r = ((jax_io, feature_io) if direction == "jax_writes"
            else (feature_io, jax_io))
    _round_trip(tmp_path, w, r, fmt, dtype)


@pytest.mark.parametrize("case", ["jax_writes_float32", "port_writes_float32",
                                  "jax_writes_uint8"])
def test_tfrecord_cross_packages(tmp_path, case):
    """One tfrecord file a case: TensorFlow is slow to import."""
    direction, _, dtype = case.rpartition("_")
    w, r = ((jax_io, feature_io) if direction == "jax_writes"
            else (feature_io, jax_io))
    _round_trip(tmp_path, w, r, "tfrecord", dtype)


def test_h5_per_video_layout_and_from_files(tmp_path):
    """An h5 of one dataset per video id reads in the ids' order (sorted
    without them); ``from_files`` takes the ids an h5 embeds when there is
    no ``_ids.json``, and reorders the rows to one when there is."""
    import h5py
    g = np.random.default_rng(2)
    rows = {v: g.normal(size=(8, 64)).astype(np.float32) for v in IDS}
    with h5py.File(tmp_path / "per_video.h5", "w") as f:
        for v, a in rows.items():
            f.create_dataset(v, data=a)
    got, ids = feature_io.load_features(str(tmp_path / "per_video.h5"))
    assert ids == sorted(IDS)
    np.testing.assert_array_equal(got[0], rows["va"])
    ref = jax_io.load_features(str(tmp_path / "per_video.h5"), IDS)
    got, ids = feature_io.load_features(str(tmp_path / "per_video.h5"), IDS)
    np.testing.assert_array_equal(got, ref[0])
    assert ids == ref[1] == IDS
    cfg = DataConfig(dataset="msrvtt", data_dir=str(tmp_path),
                     feature_dim=64, num_frames=8, min_word_count=1)
    (tmp_path / "msrvtt_captions.json").write_text(json.dumps(
        {v: [f"a {v} runs"] for v in IDS}))
    feats = np.stack([rows[v] for v in IDS])
    jax_io.save_features(str(tmp_path / "msrvtt_train_feats"), feats, IDS,
                         fmt="h5")
    ds = CaptionDataset.from_files(cfg, split="train")
    assert ds.video_ids == IDS
    np.testing.assert_array_equal(ds.features, feats)
    (tmp_path / "msrvtt_train_ids.json").write_text(json.dumps(IDS[::-1]))
    ds = CaptionDataset.from_files(cfg, split="train")
    assert ds.video_ids == IDS[::-1]
    np.testing.assert_array_equal(ds.features, feats[::-1])


@pytest.mark.parametrize("fmt,module", [("h5", "h5py"),
                                        ("tfrecord", "tensorflow")])
def test_missing_container_package_names_the_format(tmp_path, monkeypatch,
                                                    fmt, module):
    """Without h5py or tensorflow, reading or writing that container raises
    ImportError naming the format; nothing is skipped."""
    monkeypatch.setitem(sys.modules, module, None)
    with pytest.raises(ImportError, match=f"the {fmt} feature container"):
        feature_io.save_features(str(tmp_path / "f"), _features("float32"),
                                 IDS, fmt=fmt)
    (tmp_path / f"g.{fmt}").write_bytes(b"")
    with pytest.raises(ImportError, match=module):
        feature_io.load_features(str(tmp_path / f"g.{fmt}"))


def test_cli_offline_path_through_subprocesses(tmp_path):
    """The commands as a user runs them: prepare (MSR-VTT) → features →
    train with validation on the val split → caption --checkpoint-dir
    best/ --inputs → eval --split test."""
    env = {**os.environ, "PYTHONPATH": PYTHONPATH}
    data = tmp_path / "data"
    _, ann, _ = _annotations(tmp_path, "msrvtt")
    common = ["--preset", "synthetic_tiny", "--set", "data.dataset=msrvtt",
              "--set", f"data.data_dir={data}", "--set",
              "data.min_word_count=1"]

    def run(*args):
        r = subprocess.run([sys.executable, "-m", "vidcap_tpu_torch", *args],
                           cwd=tmp_path, env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        return r

    run("prepare", *common, *ann)
    g = np.random.default_rng(0)
    for split in ("train", "val", "test"):
        ids = json.loads((data / f"msrvtt_{split}_ids.json").read_text())
        np.save(data / f"msrvtt_{split}_feats.npy",
                g.normal(size=(len(ids), 8, 64)).astype(np.float32))
        (tmp_path / split).mkdir()
        for i, v in enumerate(ids):
            np.save(tmp_path / split / f"{v}.npy",
                    g.normal(size=(int(g.integers(1, 12)), 64))
                    .astype(np.float32))
    r = run("train", *common, "--steps", "4", "--eval-every", "2",
            "--log-file", "log.jsonl", "--device", "cpu")
    assert "TRAIN subset" not in r.stderr
    rows = _eval_rows(_rows(tmp_path / "log.jsonl"))
    assert sorted(rows) == [2, 4]
    assert not any("eval_on_train_fallback" in x for x in rows.values())
    run("caption", *common, "--checkpoint-dir", "checkpoints/best",
        "--inputs", "test", "--out", "caps.json", "--device", "cpu")
    caps = json.loads((tmp_path / "caps.json").read_text())
    assert sorted(caps) == sorted(json.loads(
        (data / "msrvtt_test_ids.json").read_text()))
    r = run("eval", *common, "--captions", "caps.json", "--split", "test")
    scores = json.loads(r.stdout)
    assert set(scores) == set(SCORES)
    assert all(np.isfinite(v) for v in scores.values())
    best = CheckpointManager(str(tmp_path / "checkpoints" / "best"))
    assert best.all_steps() == [best_step(rows)]


@pytest.mark.parametrize("argv,says", [
    (["caption", "--from-export", "JAX_ARTIFACT"],
     "artifact of the JAX package")])
def test_commands_not_ported_name_their_item(argv, says, tmp_path, capsys):
    """An artifact of the JAX package (a StableHLO graph,
    ``decoder.jaxexp`` and its meta) is named and refused. (``serve
    --sharded``, once refused here, runs: tests/test_torch_parallel.py.)"""
    jax_artifact = tmp_path / "jax_artifact"
    jax_artifact.mkdir()
    (jax_artifact / "decoder.jaxexp").write_bytes(b"")
    (jax_artifact / "meta.json").write_text(json.dumps({"schema": 1}))
    argv = [str(jax_artifact) if a == "JAX_ARTIFACT" else a for a in argv]
    assert cli_main([argv[0], "--preset", "msrvtt_attn_beam5", *argv[1:],
                     "--device", "cpu"]) == 2
    assert says in capsys.readouterr().err
