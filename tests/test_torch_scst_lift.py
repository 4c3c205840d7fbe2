"""The SCST lift (scripts/torch_scst_lift.py) against the reference's
scripts/scst_lift_experiment.py, and the port's scale corpus
(scripts/torch_scale_corpus.py) against scripts/make_scale_corpus.py.

Tier-1: from the JAX package's ``init_params`` weights the port's 40 XE
steps of the lift configuration (synthetic_tiny, batch 16, the reference's
batch order) against the JAX package's XE step on the same batches, step
by step, and greedy val CIDEr on the 64 held-out videos within 0.01. The
JAX side runs the reference script's own ``build`` in a subprocess with
XLA's excess precision off (as tests/test_torch_train.py runs its bf16
steps): its XE step wrapped to record each loss, its init wrapped to save
the weights, and its SCST step replaced by one that leaves the state as it
is (``build`` cannot run with zero SCST steps, and only its XE half is
compared here). Both run as the configuration is (bf16) and in float32.

Tolerances, and why:
* every loss within 1e-5 in float32 (the same products summed in another
  order; measured 1.7e-6 at most over the 40 steps);
* in bf16 the first loss within 1e-5 (the same forward from the same
  weights), the later ones within 1e-3 relative: from the first update on
  the parameters part, because XLA sums a bf16 bias or weight cotangent in
  bf16 where autograd sums in f32 (the gradient norms 3e-4 apart,
  tests/test_torch_train.py), and Adam at lr 3e-3 carries that into every
  later loss (measured 3.1e-4 relative at most, 8.2e-4 absolute).

Slow (as tests/test_scst_lift.py): the whole 40/300 lift on the CPU from
the port's seeded init, held to the reference's assertion: a lift over
0.1.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_slice import REPO, run_jax_scripts
from vidcap_tpu_torch.config import apply_overrides
from vidcap_tpu_torch.convert import unflatten_tree

sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_scst_lift  # noqa: E402

_JAX_LIFT = """
import json, sys
import numpy as np
over, out = json.loads(sys.argv[1]), sys.argv[2]
sys.path.insert(0, %r)
import vidcap_tpu.config as CF
import vidcap_tpu.models.model as M
import vidcap_tpu.train.scst as C
import vidcap_tpu.train.steps as S
from scripts.scst_lift_experiment import build
losses, flat = [], {}
make_xe_step, init_params = S.make_xe_step, M.init_params
def recording_xe_step(model, cfg):
    step = make_xe_step(model, cfg)
    def run(state, batch):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        return state, m
    return run
def saving_init(model, cfg, key):
    params = init_params(model, cfg, key)
    def walk(tree, prefix=""):
        for k, v in tree.items():
            if hasattr(v, "items"):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v)
    walk(params)
    return params
S.make_xe_step, M.init_params = recording_xe_step, saving_init
get_preset = CF.get_preset
CF.get_preset = lambda name: CF.apply_overrides(get_preset(name), over)
C.make_scst_step = lambda model, cfg, ds: (
    lambda state, batch: (state, {"reward_sample": 0.0}))
cider_xe, _, _ = build(xe_steps=40, scst_steps=1, seed=0, cpu=True)
np.savez(out + "/w.npz", **flat)
json.dump({"losses": losses, "cider_xe": cider_xe}, open(out + "/r.json", "w"))
""" % REPO


DTYPES = {"bfloat16": [], "float32": ["model.compute_dtype=float32"]}


@pytest.fixture(scope="module")
def reference_xe(tmp_path_factory):
    """The reference script's XE half per compute dtype: its losses, val
    CIDEr after XE, and its init as a Flax tree."""
    jobs = {name: (over, tmp_path_factory.mktemp(name))
            for name, over in DTYPES.items()}
    run_jax_scripts(_JAX_LIFT, jobs.values())
    out = {}
    for name, (_, d) in jobs.items():
        with np.load(d / "w.npz") as f:
            tree = unflatten_tree({k: f[k] for k in f.files})
        out[name] = json.loads((d / "r.json").read_text()), tree
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_xe_phase_matches_the_reference_script(reference_xe, dtype,
                                               monkeypatch):
    ref, tree = reference_xe[dtype]
    get_preset = torch_scst_lift.get_preset
    monkeypatch.setattr(torch_scst_lift, "get_preset", lambda name: (
        apply_overrides(get_preset(name), DTYPES[dtype])))
    xe = torch_scst_lift.xe_phase(40, seed=0, device="cpu", weights=tree)
    assert xe.cfg.model.compute_dtype == dtype
    assert len(ref["losses"]) == len(xe.losses) == 40
    if dtype == "float32":
        np.testing.assert_allclose(xe.losses, ref["losses"], rtol=0,
                                   atol=1e-5)
    else:
        assert abs(xe.losses[0] - ref["losses"][0]) <= 1e-5
        np.testing.assert_allclose(xe.losses, ref["losses"], rtol=1e-3)
    cider = torch_scst_lift.val_cider(xe.cfg, xe.val_ds, xe.state)
    assert abs(cider - ref["cider_xe"]) <= 0.01, (cider, ref["cider_xe"])


def test_lift_config_is_the_reference_configuration():
    cfg = torch_scst_lift.lift_config(0)
    t = cfg.train
    assert (t.batch_size, t.seed, t.scst_learning_rate, t.scst_xe_mix) == \
        (16, 0, 3e-4, 0.05)
    assert cfg.model == torch_scst_lift.get_preset("synthetic_tiny").model
    train_ds, val_ds = torch_scst_lift.datasets(cfg, 0)
    assert (train_ds.num_videos, val_ds.num_videos) == (128, 64)
    assert val_ds.vocab is train_ds.vocab
    assert not np.array_equal(train_ds.features[:64], val_ds.features)


@pytest.mark.slow
def test_scst_improves_heldout_cider_on_the_cpu():
    cider_xe, cider_scst, reward = torch_scst_lift.build(
        xe_steps=40, scst_steps=300, seed=0, device="cpu")
    assert reward > 0.0
    assert cider_scst > cider_xe + 0.1, (
        f"SCST did not lift held-out CIDEr: xe={cider_xe:.4f} "
        f"scst={cider_scst:.4f}")


def test_scale_corpus_scripts_write_the_same_files(tmp_path):
    """Both scripts at a small size write the same files, byte for byte."""
    outs = {}
    for name in ("make_scale_corpus.py", "torch_scale_corpus.py"):
        outs[name] = out = tmp_path / name
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", name), "--out",
             str(out), "--train", "40", "--val", "8", "--clusters", "10",
             "--pool", "8"],
            capture_output=True, text=True, timeout=120,
            env={**os.environ, "PYTHONPATH": REPO})
        assert r.returncode == 0, r.stderr
    files = sorted(os.listdir(outs["make_scale_corpus.py"]))
    assert files == sorted(os.listdir(outs["torch_scale_corpus.py"]))
    assert len(files) == 6
    for f in files:
        assert (outs["torch_scale_corpus.py"] / f).read_bytes() == \
            (outs["make_scale_corpus.py"] / f).read_bytes(), f
