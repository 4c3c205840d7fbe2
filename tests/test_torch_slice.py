"""The port's first slice end to end against the JAX package: beam-5
captioning of the synthetic split with the same weights, in process and
through the CLI; plus the port's import boundary and its device rule."""
import ast
import glob
import json
import os
import subprocess
import sys

import pytest
import torch

from vidcap_tpu_torch.config import apply_overrides, get_preset
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.inference import Captioner, NoDeviceError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PYTHONPATH = os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")]))
F32 = ["model.compute_dtype=float32"]


# Runs in a subprocess: XLA on the CPU by default keeps some bf16 roundings
# in f32 inside fused ops (excess precision), which the TPU, the port and the
# JAX package's own eager ops all round. Without it the bf16 decode follows
# the rounding chain that both packages state.
_JAX_CAPTIONS = """
import json, sys
import jax, numpy as np
jax.config.update("jax_platforms", "cpu")
from vidcap_tpu.config import apply_overrides, get_preset
from vidcap_tpu.data.loader import CaptionDataset
from vidcap_tpu.inference import Captioner
over, out = json.loads(sys.argv[1]), sys.argv[2]
cfg = apply_overrides(get_preset("synthetic_tiny"), over)
cap = Captioner.from_checkpoint(cfg, CaptionDataset.synthetic(cfg.data),
                                checkpoint_dir=None)
flat = {}
def walk(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            walk(v, prefix + k + "/")
        else:
            flat[prefix + k] = np.asarray(v)
walk(cap.params)
np.savez(out + "/w.npz", **flat)   # the file format JAX users write
with open(out + "/caps.json", "w") as f:
    json.dump(cap.caption_dataset(method="beam", beam_width=5), f)
"""


def force_kernel_route(monkeypatch):
    """Route every decoder and shape, f32 too, as the route routes the
    kernel decoder (``models/decoding.py::route``): K1 with K2 (K2-int8
    with the int8 flag) for the beam, K3 for greedy and sampled decodes;
    the teacher-forced pass keeps its own route."""
    from vidcap_tpu_torch.models import decoding
    real = decoding.route

    def forced(dec, decode, method, *a, **k):
        if method == "teacher_forced":
            return real(dec, decode, method, *a, **k)
        if method == "beam":
            int8 = decode.int8_vocab_projection
            return decoding.Route("beam_core", "topk_project_int8" if int8
                                  else "topk_project", int8, None)
        return decoding.Route("rollout", None, False, True)
    monkeypatch.setattr(decoding, "route", forced)


@pytest.fixture
def kernel_route(monkeypatch):
    """Route every decoder, f32 too, as the route routes the kernel
    decoder (:func:`force_kernel_route`): the Captioner's beam through
    ``fused_beam_step`` over ``KernelWeights.beam`` with the projection
    through K2's wrapper (K2-int8's with the int8 flag), its greedy and
    sampled decodes and SCST's rollouts through ``model_rollout`` over
    ``KernelWeights.rollout``. On CPU tensors the wrappers run their
    kernels' plain versions, so an f32 decode on this route is held exactly
    against the JAX package through the kernel path's wiring (tiling, early
    exit, nbest, the weights cast once). ``models/decoding.py::route`` keeps
    f32 off this route everywhere else. Returns the calls of the route's
    two entry points; a module step on this route fails the test."""
    from vidcap_tpu_torch import inference
    from vidcap_tpu_torch.models import decoding
    from vidcap_tpu_torch.models import model as model_mod
    from vidcap_tpu_torch.train import scst
    calls = {"fused_beam_step": 0, "model_rollout": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    def refused(*a, **kw):
        raise AssertionError("a module step ran on the kernel route")

    force_kernel_route(monkeypatch)
    for mod in (inference, scst):
        monkeypatch.setattr(mod, "model_rollout",
                            spy("model_rollout", mod.model_rollout))
    monkeypatch.setattr(inference, "fused_beam_step",
                        spy("fused_beam_step", inference.fused_beam_step))
    monkeypatch.setattr(model_mod, "module_beam_step", refused)
    for loop in ("greedy_decode", "sample_decode"):
        monkeypatch.setattr(decoding, loop, refused)
    return calls


def run_jax_scripts(script, jobs):
    """Run ``script`` as ``python -c script <overrides json> <out dir>`` once
    per (overrides, out dir) job, all in parallel, with the JAX package on
    the CPU and XLA's excess precision off; fail on a nonzero exit."""
    env = {**os.environ, "PYTHONPATH": PYTHONPATH, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, json.dumps(over), str(out)],
        env=env, stderr=subprocess.PIPE, text=True) for over, out in jobs]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX beam-5 captions of the CLI's synthetic split (64 videos) with the
    seeded init, and those weights as an .npz, per compute dtype."""
    jobs = {name: (over, tmp_path_factory.mktemp(name))
            for name, over in (("float32", F32), ("bfloat16", []))}
    run_jax_scripts(_JAX_CAPTIONS, jobs.values())
    return {name: (json.loads((out / "caps.json").read_text()),
                   str(out / "w.npz"), over)
            for name, (over, out) in jobs.items()}


def _port_captions(weights, over):
    cfg = apply_overrides(get_preset("synthetic_tiny"), over)
    cap = Captioner.from_checkpoint(cfg, CaptionDataset.synthetic(cfg.data),
                                    weights=weights, device="cpu")
    return cap.caption_dataset(method="beam", beam_width=5)


def test_caption_json_identical_to_jax_float32(jax_runs):
    caps, weights, over = jax_runs["float32"]
    assert _port_captions(weights, over) == caps


def test_caption_json_identical_to_jax_float32_on_the_kernel_route(
        jax_runs, kernel_route):
    """The f32 decoder decodes through its modules; the same JSON through
    the kernel decoder's beam step (K1's and K2's plain versions here)."""
    caps, weights, over = jax_runs["float32"]
    assert _port_captions(weights, over) == caps
    assert kernel_route["fused_beam_step"] == 2   # 64 videos, 2 batches


def test_caption_json_matches_jax_bfloat16(jax_runs):
    """bf16: the same rounding points on both sides (all 64 rows agree as
    measured), but XLA's tanh and the f32 sums run in another order, so a
    sum next to a rounding boundary may round one ulp apart and flip a
    near-tie between random-weight beams: ≥ 90% of the rows identical."""
    caps, weights, over = jax_runs["bfloat16"]
    port = _port_captions(weights, over)
    assert port.keys() == caps.keys()
    same = sum(port[v] == caps[v] for v in caps)
    assert same >= 0.9 * len(caps), (same, len(caps))


def test_cli_caption_equals_jax(jax_runs, tmp_path):
    caps, weights, over = jax_runs["float32"]
    out = tmp_path / "caps.json"
    cmd = [sys.executable, "-m", "vidcap_tpu_torch", "caption",
           "--preset", "synthetic_tiny", "--weights", weights,
           "--method", "beam", "--beam", "5", "--device", "cpu",
           "--out", str(out)] + [a for o in over for a in ("--set", o)]
    env = {**os.environ, "PYTHONPATH": PYTHONPATH}
    r = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(out.read_text()) == caps


_BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "vidcap_tpu")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += glob.glob(os.path.join(REPO, "scripts", "torch_*.py"))
    for root, _, names in os.walk(os.path.join(REPO, "vidcap_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in _BANNED, f"{path} imports {mod}"


_ABOVE_OPS = tuple(f"vidcap_tpu_torch.{m}" for m in (
    "models", "train", "inference", "serving", "parallel"))


def test_ops_import_nothing_above_them():
    """The kernels' wrappers take tensors: no module under ``ops/`` imports
    the layers that call them, not even inside a function."""
    files = glob.glob(os.path.join(REPO, "vidcap_tpu_torch", "ops", "*.py"))
    assert len(files) > 5
    for path in files:
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            for name in names:
                assert not (name + ".").startswith(
                    tuple(m + "." for m in _ABOVE_OPS)), \
                    f"{path} imports {name}"


def test_entry_points_refuse_to_run_on_cpu_unasked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device exists")
    cfg = get_preset("synthetic_tiny")
    with pytest.raises(NoDeviceError):
        Captioner.from_checkpoint(cfg, CaptionDataset.synthetic(cfg.data,
                                                                num_videos=4))
    r = subprocess.run(
        [sys.executable, "-m", "vidcap_tpu_torch", "caption", "--preset",
         "synthetic_tiny", "--weights", "absent.npz", "--out", "c.json"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": PYTHONPATH},
        capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not (tmp_path / "c.json").exists()
