"""The port's mesh (``vidcap_tpu_torch/parallel/``) on the CPU: gloo
processes against one process of the port and against the JAX package's
sharded step on a virtual CPU mesh of the same shape.

The ranks run in processes that ``parallel/distributed.py::spawn`` starts
(tests/torch_parallel_worker.py, which imports no JAX); each group is
started once a module (world 2: data 2; world 4: data 2 × model 2, the vocab
seam) and every test reads its results. At most 4 workers at a time, each
spawn with its own timeout.

Against the JAX package, both start from its init. Its SCST steps run the
kernel branch (``model.use_pallas_decoder``) with ``model_rollout`` replaced
by the one-process port's rollouts of the same step and microbatch, looked
up by the sampling seed the JAX step derives; the port's ranks are fed their
rows of the same rollouts. So both packages hold the same sampled and greedy
tokens, and what is compared is the rest of the step: the rewards, the PG
re-score, the XE anchor, the BCE, the global normalization and the update.
(Threefry's draws cannot be matched; tests/test_torch_train.py holds the
port's rollouts against the JAX K3's.)

Tolerances, and why (f32, the same products summed in another order):
* the loss 1e-6 relative at data 2 (a sum over ranks of the shares of one
  global numerator over one global count), 1e-5 across the vocab seam (the
  vocab-parallel log-softmax takes the max and the exp-sum in pieces: the
  bound of tests/test_parallel.py's seam);
* the gradient norm 1e-5 relative; the raw gradients 1e-5 of the
  gradient's largest entry (a gradient near 1e-10, e.g. attention's query
  on two frames, differs in its own last bits);
* the parameters after 3 Adam steps 5e-5 absolute (tests/test_torch_train.py
  says why: Adam divides by sqrt(ν));
* SCST's sampled tokens identical: each rank's K3 hashes its rows from
  ``row0``, so the ranks draw the one process's noise, in every microbatch
  of ``train.grad_accum``;
* the sharded decodes identical to the one-process decode.
"""
import contextlib
import dataclasses
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from vidcap_tpu.config import apply_overrides as jax_apply_overrides
from vidcap_tpu.config import get_preset as jax_get_preset
from vidcap_tpu.data.loader import CaptionDataset as JaxDataset
from vidcap_tpu.data.pipeline import DeterministicBatcher as JaxBatcher
from vidcap_tpu.models import backbone as jax_bb
from vidcap_tpu.models.decoding import Rollout as JaxRollout
from vidcap_tpu.models.model import create_model as jax_create_model
from vidcap_tpu.models.model import init_params as jax_init_params
from vidcap_tpu.ops import pallas_decoder as jax_pallas_decoder
from vidcap_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vidcap_tpu.parallel.sharding import \
    make_sharded_banked_step as jax_sharded_banked
from vidcap_tpu.parallel.sharding import make_sharded_step as jax_sharded
from vidcap_tpu.parallel.sharding import place_state as jax_place_state
from vidcap_tpu.parallel.sharding import shard_batch as jax_shard_batch
from vidcap_tpu.train.scst import make_scst_step_body as jax_scst_body
from vidcap_tpu.train.state import create_train_state as jax_train_state
from vidcap_tpu.train.steps import make_xe_step_body as jax_xe_body
from vidcap_tpu_torch.cli.main import main as cli_main
from vidcap_tpu_torch.config import get_preset
from vidcap_tpu_torch.convert import from_flax, save_weights
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.models.model import create_model, init_params
from vidcap_tpu_torch.parallel import distributed, sharding
from vidcap_tpu_torch.parallel.dryrun import dryrun_multigpu
from vidcap_tpu_torch.parallel.mesh import make_mesh
from vidcap_tpu_torch.train.checkpoint import CheckpointManager

jax.config.update("jax_platforms", "cpu")

DP_CASES = list(worker.CASES)
SEAM_CASES = ["xe", "scst"]
# from the JAX init, against its sharded step (data 2; the seam's too)
JAX_CASES = ["xe", "xe_banked", "scst", "scst_accum", "e2e"]
SCST_CASES = ["scst", "scst_accum"]
SPAWN_TIMEOUT = 240


@contextlib.contextmanager
def _tiny_backbones():
    """Both packages' ``InceptionResNetV2`` at the tiny width and depth in
    f32, as tests/test_torch_e2e.py has them."""
    orig = jax_bb.InceptionResNetV2
    jax_bb.InceptionResNetV2 = lambda **kw: orig(
        **{**worker.TINY_BACKBONE, "compute_dtype": jnp.float32, **kw})
    try:
        with worker.tiny_backbone():
            yield
    finally:
        jax_bb.InceptionResNetV2 = orig


def _jax_setup(case):
    """The JAX package's config (the case's overrides; SCST on the kernel
    branch, whose ``model_rollout`` the tests replace), dataset and
    model."""
    over = worker.CASES[case] + (["model.use_pallas_decoder=true"]
                                 if case in SCST_CASES else [])
    jcfg = jax_apply_overrides(jax_get_preset("synthetic_tiny"), over)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, donate_state=False))
    pixels = jcfg.model.use_backbone
    ds = JaxDataset.synthetic(jcfg.data, num_videos=16 if pixels else 64,
                              pixels=pixels)
    return jcfg, ds, jax_create_model(jcfg, ds.vocab.size)


def _as_port(case, params):
    """{name: array} of the port's parameters holding the JAX ``params``
    (the convolutions' kernels in the port's layout)."""
    cfg, ds = worker.case_setup(case)
    model = from_flax(create_model(cfg, ds.vocab.size), params)
    return {k: p.detach().numpy() for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def jax_inits():
    """{case: (the JAX package's init, the same as the port's weights)}."""
    out = {}
    with _tiny_backbones():
        for case in JAX_CASES:
            jcfg, _, jm = _jax_setup(case)
            params = jax.tree_util.tree_map(np.asarray, jax.jit(
                lambda k: jax_init_params(jm, jcfg, k))(jax.random.key(0)))
            out[case] = (params, _as_port(case, params))
    return out


def _sampling_seeds(rng, accum):
    """The K3 seeds the JAX SCST body derives from its state's rng, a
    microbatch, over :data:`worker.STEPS` steps, in order."""
    seeds = []
    for _ in range(worker.STEPS):
        rng, sub = jax.random.split(rng)
        subs = [sub] if accum == 1 else jax.random.split(sub, accum)
        seeds += [int(jax.random.randint(r, (), 0, jnp.int32(2**31 - 1)))
                  for r in subs]
    return seeds


@contextlib.contextmanager
def _fed_rollouts(seeds, rollouts):
    """The JAX package's ``model_rollout`` replaced by a lookup: the
    sampled call returns the rollout of its seed's place in ``seeds``, the
    greedy call after it that place's greedy rollout."""
    assert len(set(seeds)) == len(seeds) == len(rollouts)
    table = jnp.asarray(seeds, jnp.int32)
    tabs = [{f: jnp.asarray(np.stack([pair[i][f] for pair in rollouts]),
                            jnp.int32 if f == "tokens" else jnp.float32)
             for f in worker.ROLLOUT_FIELDS} for i in (0, 1)]
    held = {}

    def fed(*a, sample=False, seed=None, **k):
        if sample:
            held["i"] = jnp.argmax(table == seed)
        tab = tabs[0 if sample else 1]
        return JaxRollout(*(tab[f][held["i"]]
                            for f in worker.ROLLOUT_FIELDS))
    orig = jax_pallas_decoder.model_rollout
    jax_pallas_decoder.model_rollout = fed
    try:
        yield
    finally:
        jax_pallas_decoder.model_rollout = orig


def _jax_run(case, nd, nm, params, rollouts=None):
    """The JAX package's sharded step (``make_sharded_step``, or
    ``make_sharded_banked_step`` with the feature bank) on a data nd ×
    model nm mesh of virtual CPU devices, 3 steps from ``params``: the
    metrics of each step and the parameters after, in the port's names and
    layout. SCST takes ``rollouts`` (:func:`_fed_rollouts`)."""
    with _tiny_backbones(), contextlib.ExitStack() as stack:
        jcfg, ds, jm = _jax_setup(case)
        t = jcfg.train
        state = jax_train_state(jcfg, params)
        if t.stage == "scst":
            stack.enter_context(_fed_rollouts(
                _sampling_seeds(state.rng, max(1, t.grad_accum)), rollouts))
            body = jax_scst_body(jm, jcfg, ds)
        else:
            body = jax_xe_body(jm, jcfg)
        mesh = jax_make_mesh(jcfg.mesh, devices=jax.devices()[:nd * nm],
                             num_data=nd, num_model=nm)
        keys = ("tokens", "mask", "video_idx")
        metrics = []
        with mesh:
            state = jax_place_state(state, mesh)
            if t.device_feature_bank:
                step, _ = jax_sharded_banked(jcfg, mesh, body, ds)
            else:
                step = jax_sharded(jcfg, mesh, body)
                keys += ("features", "attributes")
            it = JaxBatcher(ds, t.batch_size, seed=0)
            for _ in range(worker.STEPS):
                b = next(it)
                state, m = step(state, jax_shard_batch(
                    {k: getattr(b, k) for k in keys}, mesh))
                metrics.append({k: float(v) for k, v in m.items()})
        return metrics, _as_port(case, jax.tree_util.tree_map(
            np.asarray, state.params))


@pytest.fixture(scope="module")
def one_process(jax_inits):
    """The one-process port: each case from the seeded init; the JAX
    cases from the JAX init (as "jax_<case>")."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {c: worker.run_case(c) for c in DP_CASES}
        out.update({f"jax_{c}": worker.run_case(c, jax_inits[c][1])
                    for c in JAX_CASES})
        out["decode"] = worker.decode()
    finally:
        torch.set_num_threads(n)
    return out


def _fed(one_process, cases):
    """{case: the one-process rollouts from the JAX init} of the SCST
    cases among ``cases``."""
    return {c: one_process[f"jax_{c}"]["rollouts"] for c in cases
            if c in SCST_CASES}


@pytest.fixture(scope="module")
def jax_dp(jax_inits, one_process):
    """{case: the JAX package's data-2 step (metrics, parameters)}."""
    fed = _fed(one_process, JAX_CASES)
    return {c: _jax_run(c, 2, 1, jax_inits[c][0], fed.get(c))
            for c in JAX_CASES}


@pytest.fixture(scope="module")
def jax_seam(jax_inits, one_process):
    """{case: the JAX package's data 2 × model 2 step}."""
    fed = _fed(one_process, SEAM_CASES)
    return {c: _jax_run(c, 2, 2, jax_inits[c][0], fed.get(c))
            for c in SEAM_CASES}


@pytest.fixture(scope="module")
def world2(jax_inits, one_process):
    """Data 2 (gloo, 2 processes): every case, the JAX cases from the JAX
    init (as "jax_<case>", SCST fed the one-process rollouts), and the
    decodes."""
    return distributed.spawn(
        worker.rank_steps, 2,
        (2, 1, DP_CASES, {c: jax_inits[c][1] for c in JAX_CASES},
         _fed(one_process, JAX_CASES), True), timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def world4(jax_inits, one_process):
    """Data 2 × model 2 (gloo, 4 processes): the seam, from the seeded
    init and from the JAX init (as "jax_<case>")."""
    return distributed.spawn(
        worker.rank_steps, 4,
        (2, 2, SEAM_CASES, {c: jax_inits[c][1] for c in SEAM_CASES},
         _fed(one_process, SEAM_CASES)), timeout=SPAWN_TIMEOUT)


def _close_metrics(got, want, rtol):
    for s, (g, w) in enumerate(zip(got, want, strict=True)):
        for k in w:
            tol = 1e-5 if k == "grad_norm" else rtol
            np.testing.assert_allclose(g[k], w[k], rtol=tol, atol=1e-7,
                                       err_msg=f"step {s + 1} {k}")


def _close_grads(got, want):
    scale = max(np.abs(g).max() for g in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5 * scale,
                                   err_msg=k)


def _close_params(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=5e-5, err_msg=k)


def _close_to_jax(got, jax_run, rtol):
    """Every metric both packages report, each step (the loss and its
    pieces within ``rtol``, the gradient norm 1e-5), and the parameters
    after the 3 steps."""
    jax_metrics, jax_params = jax_run
    shared = [{k: m[k] for k in m if k in g}
              for m, g in zip(jax_metrics, got["metrics"], strict=True)]
    assert {"loss", "grad_norm"} <= set(shared[0])
    _close_metrics(got["metrics"], shared, rtol)
    _close_params(got["params"], jax_params)


def _sampled(ranks, case):
    """Each rollout's sampled tokens, the ranks' rows stacked."""
    return [np.concatenate([r[case]["rollouts"][i][0]["tokens"]
                            for r in ranks])
            for i in range(len(ranks[0][case]["rollouts"]))]


# ------------------------------------------------------------ data 2

@pytest.mark.parametrize("case", DP_CASES)
def test_dp_steps_match_one_process(case, world2, one_process):
    """Data 2 against one process, 3 steps: every metric (the loss 1e-6),
    the raw gradients of the first step, the parameters after the third;
    both ranks hold the same parameters."""
    ranks, ref = world2, one_process[case]
    got = ranks[0][case]
    _close_metrics(got["metrics"], ref["metrics"], 1e-6)
    _close_grads(got["grads"], ref["grads"])
    _close_params(got["params"], ref["params"])
    for k, p in got["params"].items():
        np.testing.assert_array_equal(p, ranks[1][case]["params"][k])


@pytest.mark.parametrize("case", SCST_CASES)
def test_dp_scst_samples_the_one_process_tokens(case, world2, one_process):
    """Each rank's K3 (plain) rollout hashes its rows from row0: every
    sampled rollout of the 3 steps (each microbatch's with
    ``train.grad_accum`` 2), the two ranks' rows stacked, is the one
    process's."""
    got, want = _sampled(world2, case), _sampled([one_process], case)
    assert len(got) == len(want) == worker.STEPS * (
        2 if case == "scst_accum" else 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_dp_dropout_draws_the_one_process_masks(world2, one_process):
    """With dropout 0.3 the masks are keyed by the global row, so data 2
    steps as one process does (to the tolerances above), and not as the
    deterministic step."""
    got = world2[0]["xe_dropout"]["metrics"]
    ref = one_process["xe_dropout"]["metrics"]
    _close_metrics(got, ref, 1e-6)
    assert got[0]["loss"] != one_process["xe"]["metrics"][0]["loss"]


@pytest.mark.parametrize("case", JAX_CASES)
def test_dp_steps_match_the_jax_sharded_step(case, world2, jax_dp):
    """From the JAX init, data 2 against the JAX package's sharded step on
    a data-2 mesh of virtual CPU devices (SCST both fed the same
    rollouts): every metric per step, the loss within 1e-6, and the
    parameters after 3 steps."""
    _close_to_jax(world2[0][f"jax_{case}"], jax_dp[case], 1e-6)


# ------------------------------------------------------------ the seam

@pytest.mark.parametrize("case", SEAM_CASES)
def test_seam_matches_one_process(case, world4, one_process):
    """Data 2 × model 2: the embedding's rows and out_proj's columns split
    over the model axis; the loss within 1e-5, every metric, the
    gradients (the seam's shards of the two model ranks joined) and the
    gathered parameters after 3 steps; SCST samples the same tokens."""
    ranks, ref = world4, one_process[case]
    got = ranks[0][case]
    _close_metrics(got["metrics"], ref["metrics"], 1e-5)
    grads = dict(got["grads"])
    for k, dim in sharding.SEAM.items():
        grads[k] = np.concatenate([ranks[r][case]["grads"][k]
                                   for r in (0, 1)], dim)
    _close_grads(grads, ref["grads"])
    _close_params(got["params"], ref["params"])
    if case == "scst":
        for g, w in zip(_sampled([ranks[0], ranks[2]], case),
                        _sampled([one_process], case), strict=True):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", SEAM_CASES)
def test_seam_matches_the_jax_seam(case, world4, jax_seam):
    """From the JAX init, data 2 × model 2 against the JAX package's
    vocab-TP seam on the same mesh (SCST both fed the same rollouts):
    every metric per step, the loss within rtol 1e-5
    (tests/test_parallel.py's bound), the parameters after 3."""
    _close_to_jax(world4[0][f"jax_{case}"], jax_seam[case], 1e-5)


def test_dryrun_multigpu_four_processes(capsys):
    """``dryrun_multigpu(4)``: data 2 × model 2, one XE and one SCST step
    against one process, printed as JSON."""
    out = dryrun_multigpu(4, timeout=SPAWN_TIMEOUT)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["mesh"] == {"data": 2, "model": 2} == out["mesh"]
    assert printed["xe_delta"] < 1e-5 and printed["scst_delta"] < 1e-5


# ------------------------------------------------------------ decode

@pytest.mark.parametrize("name", list(worker.DECODES))
def test_sharded_decode_matches_one_process(name, world2, one_process):
    """``Captioner(mesh)``: greedy (K3's route), beam (K1/K2's), the
    finished pool and the int8 projection, with frame masks, split over
    data 2: both ranks get the one-process tokens."""
    ref = one_process["decode"][name]
    for r in range(2):
        np.testing.assert_array_equal(world2[r]["decode"][name], ref)


def test_captioner_mesh_routes_greedy_and_beam_only(world2, one_process):
    """Sampling stays on the rank (the one-process tokens at the same
    seed, no sharded decode built for it)."""
    got = world2[0]["decode"]
    np.testing.assert_array_equal(got["sample"],
                                  one_process["decode"]["sample"])
    assert got["sharded_compiled"] == ["('greedy', 3)"]


def test_initialize_multihost_is_a_no_op_without_a_launcher(monkeypatch):
    """Without RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT it returns
    False and joins nothing (every entry point may call it), and a mesh
    needs a group."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize_multihost("cpu") is False
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_mesh(None)


@pytest.fixture
def world_of_one():
    """A gloo group of this process alone."""
    distributed.init_group("cpu")
    yield make_mesh(None)
    distributed.shutdown()


def test_mesh_and_decode_refuse_what_they_cannot_split(world_of_one):
    """make_mesh refuses a grid that does not cover the world; a mesh
    decode refuses nbest > 1, as the reference; shard_batch refuses rows
    that do not divide."""
    mesh = world_of_one
    assert (mesh.num_data, mesh.num_model, mesh.data_index) == (1, 1, 0)
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(None, num_data=2, num_model=1)
    cfg = get_preset("synthetic_tiny")
    ds = CaptionDataset.synthetic(cfg.data, num_videos=4)
    from vidcap_tpu_torch.inference import Captioner
    cap = Captioner(cfg, init_params(create_model(cfg, ds.vocab.size)).eval(),
                    ds, torch.device("cpu"), mesh=mesh)
    feats, mask = worker.decode_inputs(B=2)
    with pytest.raises(ValueError, match="single-device only"):
        cap.decode_batch(feats, method="beam", beam_width=3, nbest=2)
    assert cap.decode_batch(feats, method="beam", beam_width=3,
                            frame_mask=mask).shape == (2, cfg.decode.max_len)
    mesh2 = dataclasses.replace(mesh, num_data=2)
    with pytest.raises(ValueError, match="does not divide"):
        sharding.shard_batch({"tokens": np.zeros((3, 4))}, mesh2)


# ------------------------------------------------------------ the CLI

def _train(args):
    return cli_main(["train", "--preset", "synthetic_tiny", "--eval-every",
                     "0", "--device", "cpu", "--set",
                     "model.compute_dtype=float32"] + args)


def test_cli_train_sharded_and_resume_are_exact(tmp_path, monkeypatch,
                                                capsys):
    """``train --sharded --device cpu`` starts 2 gloo processes from one
    command: its rows match one process; a sharded ``--resume`` from its
    step-3 checkpoint (the step-4 one removed) ends bit for bit where the
    uninterrupted run ended."""
    monkeypatch.chdir(tmp_path)
    common = ["--stages", "xe,scst", "--log-every", "1", "--steps", "2,2"]
    assert _train(common + ["--checkpoint-dir", "plain", "--log-file",
                            "plain.jsonl"]) == 0
    assert _train(common + ["--sharded", "--checkpoint-dir", "full",
                            "--log-file", "full.jsonl",
                            "--set", "train.checkpoint_every=1"]) == 0
    err = capsys.readouterr().err
    assert "--sharded: 2 processes (gloo on the CPU), mesh data 2 x model 1" \
        in err
    assert "scst: 2 steps on cpu (rank 0 of a data 2 x model 1 mesh)" in err
    rows = lambda f: [json.loads(x) for x in open(f)]
    for a, b in zip(rows("full.jsonl"), rows("plain.jsonl"), strict=True):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5)
    full = CheckpointManager("full")._load(4)
    os.remove(os.path.join("full", "ckpt_4.pt"))
    assert _train(common + ["--sharded", "--checkpoint-dir", "full",
                            "--resume"]) == 0
    assert "scst: 1 steps on cpu" in capsys.readouterr().err
    again = CheckpointManager("full")._load(4)
    for k, v in full["params"].items():
        assert torch.equal(v, again["params"][k]), k
    assert full["iter_state"] == again["iter_state"]


def test_cli_serve_sharded_over_stdin(tmp_path, monkeypatch, capsys):
    """``serve --sharded --device cpu``: rank 0 reads the stdin batch and
    sends each flush to rank 1; the lines equal the one-process server's."""
    monkeypatch.chdir(tmp_path)
    cfg = get_preset("synthetic_tiny")
    ds = CaptionDataset.synthetic(cfg.data)
    save_weights(init_params(create_model(cfg, ds.vocab.size), seed=2),
                 "w.npz")
    g = np.random.default_rng(4)
    paths = []
    for i in range(6):
        p = str(tmp_path / f"v{i}.npy")
        np.save(p, g.normal(size=(int(g.integers(2, 9)),
                                  cfg.data.feature_dim)).astype(np.float32))
        paths.append(p)
    lines = {}
    for mode in ("one", "sharded"):
        monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(paths)
                                                      + "\n"))
        assert cli_main(["serve", "--preset", "synthetic_tiny", "--weights",
                         "w.npz", "--method", "beam", "--beam", "3",
                         "--batch", "4", "--device", "cpu"]
                        + (["--sharded"] if mode == "sharded" else [])) == 0
        lines[mode] = capsys.readouterr()
    assert lines["sharded"].out == lines["one"].out
    assert len(lines["one"].out.splitlines()) == 6
    assert "[vidcap] served 6 captions" in lines["sharded"].err
