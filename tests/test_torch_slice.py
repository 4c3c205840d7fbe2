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
