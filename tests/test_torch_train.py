"""The port's training path against the JAX package on the CPU: the XE step,
the optimizer and its schedules, the SCST step (K3's plain version against
the JAX package's K3 in interpret mode, and the differentiable part fed the
same rollouts), checkpoint resume, the staged CLI.

Weights come from JAX ``init_params`` through ``convert.from_flax``; the
data is the synthetic corpus. float32 runs in process. bfloat16 runs the JAX
side in a subprocess with XLA's excess precision off (tests/test_torch_slice.py
says why), where one XE step and one SCST step are taken.

Tolerances, and why:
* float32 losses 1e-6 and the gradient norm 1e-5 relative: the same
  products summed in another order. The parameters after 3 Adam steps,
  5e-5 absolute (lr 3e-3): Adam divides by sqrt(ν), so a gradient of ~1e-7
  that differs in its last bits moves its parameter by up to lr a step;
  measured 4.8e-6.
* bfloat16: the loss 2e-6 relative (the forward's rounding points are the
  same); the gradient norm 2e-3 relative: the backward rounds its cotangents
  to bf16 at the same points, but XLA reduces a bf16 bias or weight
  cotangent in bf16 where autograd sums in f32 (measured 3e-4).
* The SCST rollouts: ≥ 90% of the rows identical to the JAX K3's, the
  margin of tests/test_torch_rollout.py (one-ulp near-ties between random
  logits).
"""
import json

import jax
import numpy as np
import optax
import pytest
import torch

from test_torch_slice import run_jax_scripts
from vidcap_tpu.config import apply_overrides as jax_apply_overrides
from vidcap_tpu.config import get_preset as jax_get_preset
from vidcap_tpu.data.loader import CaptionDataset as JaxDataset
from vidcap_tpu.data.pipeline import DeterministicBatcher as JaxBatcher
from vidcap_tpu.models.model import create_model as jax_create_model
from vidcap_tpu.models.model import init_params as jax_init_params
from vidcap_tpu.train.state import create_train_state as jax_train_state
from vidcap_tpu.train.state import make_lr_schedule as jax_lr_schedule
from vidcap_tpu.train.state import make_optimizer as jax_make_optimizer
from vidcap_tpu.train.steps import make_xe_step_body as jax_xe_body
from vidcap_tpu_torch.cli.main import main as cli_main
from vidcap_tpu_torch.config import apply_overrides, get_preset
from vidcap_tpu_torch.convert import flatten_tree, from_flax, load_weights
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.data.pipeline import DeterministicBatcher
from vidcap_tpu_torch.models.decoding import Rollout
from vidcap_tpu_torch.models.model import create_model
from vidcap_tpu_torch.train.checkpoint import CheckpointManager
from vidcap_tpu_torch.train.loop import batch_to_device, train
from vidcap_tpu_torch.train.scst import make_scst_step_body
from vidcap_tpu_torch.train.state import (create_train_state,
                                          make_lr_schedule, make_optimizer)
from vidcap_tpu_torch.train.steps import make_xe_step_body

SCST_B = 32   # rows of the SCST comparison (K3 in interpret mode wants B%8=0)

# Runs in a subprocess (excess precision off), bf16, synthetic_tiny with
# the attribute head on: one XE step (batch 4) and one SCST step (batch
# 32, model.use_pallas_decoder: K3 in interpret mode) from JAX init_params.
# The SCST step runs twice: its K3 rollouts at the seed the step derives
# from its rng are taken by themselves, then the step is traced with
# model_rollout returning exactly those, so that its metrics are those of
# the differentiable part fed known rollouts.
_JAX_TRAIN = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_platforms", "cpu")
from vidcap_tpu.config import apply_overrides, get_preset
from vidcap_tpu.data.loader import CaptionDataset
from vidcap_tpu.data.pipeline import DeterministicBatcher
from vidcap_tpu.models.model import create_model, init_params
from vidcap_tpu.objectives.reward import scst_reward
from vidcap_tpu.objectives.reward_tables import tables_from_dataset
from vidcap_tpu.ops import pallas_decoder
from vidcap_tpu.train.scst import make_scst_step_body
from vidcap_tpu.train.state import create_train_state
from vidcap_tpu.train.steps import make_xe_step_body
def batch_to_device_dict(b):
    return {k: getattr(b, k) for k in ("features", "tokens", "mask",
                                       "attributes", "video_idx")}
over, out = json.loads(sys.argv[1]), sys.argv[2]
cfg = apply_overrides(get_preset("synthetic_tiny"), over)
ds = CaptionDataset.synthetic(cfg.data)
model = create_model(cfg, ds.vocab.size)
params = jax.jit(lambda k: init_params(model, cfg, k))(jax.random.key(0))
flat = {}
def walk(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            walk(v, prefix + k + "/")
        else:
            flat[prefix + k] = np.asarray(v)
walk(params)
np.savez(out + "/w.npz", **flat)
metrics = {}
xcfg = apply_overrides(cfg, ["train.stage=xe"])
b = batch_to_device_dict(next(DeterministicBatcher(ds, 4, seed=0)))
_, m = jax.jit(make_xe_step_body(model, xcfg))(
    create_train_state(xcfg, params), b)
metrics["xe"] = {k: float(v) for k, v in m.items()}
scfg = apply_overrides(cfg, ["train.stage=scst", "train.batch_size=%d",
                             "model.use_pallas_decoder=true"])
state = create_train_state(scfg, params)
_, sub = jax.random.split(state.rng)
seed = jax.random.randint(sub, (), 0, jnp.int32(2**31 - 1))
batch = batch_to_device_dict(next(DeterministicBatcher(ds, %d, seed=0)))
L, temp = scfg.decode.max_len, scfg.decode.temperature
r_s, r_g = jax.jit(lambda p, f, s: (
    pallas_decoder.model_rollout(model, p, f, max_len=L, sample=True, seed=s,
                                 temperature=temp),
    pallas_decoder.model_rollout(model, p, f, max_len=L)))(
        params, batch["features"], seed)
tables = tables_from_dataset(ds)
pallas_decoder.model_rollout = lambda *a, sample=False, **k: (
    r_s if sample else r_g)
_, m = jax.jit(make_scst_step_body(model, scfg, tables=tables))(state, batch)
metrics["scst"] = {k: float(v) for k, v in m.items()}
metrics["seed"] = int(seed)
arrays = {"batch_" + k: np.asarray(v) for k, v in batch.items()}
reward = jax.jit(lambda r: scst_reward(tables, batch["video_idx"], r.tokens,
                                       r.mask))
for name, r in (("sample", r_s), ("greedy", r_g)):
    for f in ("tokens", "logp", "mask"):
        arrays[name + "_" + f] = np.asarray(getattr(r, f))
    arrays["reward_" + name] = np.asarray(reward(r))
np.savez(out + "/arrays.npz", **arrays)
with open(out + "/metrics.json", "w") as f:
    json.dump(metrics, f)
""" % (SCST_B, SCST_B)

ATTR = ["train.attribute_loss_weight=0.2"]


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_train")
    run_jax_scripts(_JAX_TRAIN, [(ATTR, out)])
    with np.load(out / "arrays.npz") as f:
        arrays = {k: f[k] for k in f.files}
    return (json.loads((out / "metrics.json").read_text()),
            str(out / "w.npz"), arrays)


def _port(over, weights=None, params=None):
    cfg = apply_overrides(get_preset("synthetic_tiny"), over)
    ds = CaptionDataset.synthetic(cfg.data)
    model = create_model(cfg, ds.vocab.size)
    if weights:
        load_weights(model, weights)
    else:
        from_flax(model, params)
    return cfg, ds, create_train_state(cfg, model)


def _metrics_close(port, ref, keys, rtol):
    for k in keys:
        np.testing.assert_allclose(float(port[k]), ref[k], rtol=rtol,
                                   err_msg=k)


@pytest.mark.parametrize("attr_w", [0.0, 0.2])
def test_xe_steps_match_jax_float32(attr_w):
    """f32, in process: each of 3 XE steps over the same DeterministicBatcher
    stream gives the JAX step's loss, pieces, token count and gradient
    norm, and the parameters after them agree."""
    over = ["model.compute_dtype=float32",
            f"train.attribute_loss_weight={attr_w}"]
    jcfg = jax_apply_overrides(jax_get_preset("synthetic_tiny"), over)
    jds = JaxDataset.synthetic(jcfg.data)
    jm = jax_create_model(jcfg, jds.vocab.size)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jax_init_params(jm, jcfg, k))(jax.random.key(0)))
    js = jax_train_state(jcfg, params)
    jbody = jax.jit(jax_xe_body(jm, jcfg))
    cfg, ds, state = _port(over, params=params)
    body = make_xe_step_body(cfg)
    jit, it = JaxBatcher(jds, 4, seed=0), DeterministicBatcher(ds, 4, seed=0)
    for _ in range(3):
        jb, b = next(jit), next(it)
        np.testing.assert_array_equal(b.tokens, jb.tokens)
        js, jm_ = jbody(js, {k: getattr(jb, k) for k in (
            "features", "tokens", "mask", "attributes", "video_idx")})
        state, m = body(state, batch_to_device(b, "cpu"))
        assert float(m["tokens"]) == float(jm_["tokens"])
        _metrics_close(m, jm_, ["loss", "xe_loss"]
                       + (["attr_loss"] if attr_w else []), 1e-6)
        _metrics_close(m, jm_, ["grad_norm"], 1e-5)
    assert ("attr_loss" in m) == (attr_w > 0) and state.step == 3
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, js.params))
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name.replace(".", "/")], rtol=0,
                                   atol=5e-5, err_msg=name)


def test_xe_step_matches_jax_bfloat16(jax_bf16):
    metrics, weights, _ = jax_bf16
    cfg, ds, state = _port(ATTR, weights=weights)
    b = batch_to_device(next(DeterministicBatcher(ds, 4, seed=0)), "cpu")
    _, m = make_xe_step_body(cfg)(state, b)
    ref = metrics["xe"]
    assert float(m["tokens"]) == ref["tokens"]
    _metrics_close(m, ref, ["loss", "xe_loss", "attr_loss"], 2e-6)
    _metrics_close(m, ref, ["grad_norm"], 2e-3)


def _rollout(a, name):
    return Rollout(*(torch.tensor(a[f"{name}_{f}"])
                     for f in ("tokens", "logp", "mask")))


def test_scst_step_matches_jax_k3(jax_bf16):
    """bf16, B=32: the port's rollouts (K3's plain version on the CPU) at
    the seed the JAX step derives from its rng, against the JAX K3's: ≥ 90%
    of the rows identical, sampled and greedy. Fed the JAX rollouts, the
    port's rewards equal the JAX ones within 1e-5, and its differentiable
    part gives the JAX step's rewards, PG loss, XE anchor and BCE within
    2e-6 relative and its gradient norm within 2e-3."""
    metrics, weights, a = jax_bf16
    cfg, ds, state = _port(ATTR + ["train.stage=scst",
                                   f"train.batch_size={SCST_B}"],
                           weights=weights)
    step = make_scst_step_body(cfg, ds)
    batch = {k[6:]: torch.tensor(v) for k, v in a.items()
             if k.startswith("batch_")}
    sample, greedy = step.rollouts(state, batch, seed=metrics["seed"])
    for name, r in (("sample", sample), ("greedy", greedy)):
        same = (r.tokens.numpy() == a[f"{name}_tokens"]).all(1)
        assert same.mean() >= 0.9, (name, same.mean())
    js, jg = _rollout(a, "sample"), _rollout(a, "greedy")
    r_s, r_g = step.rewards(batch, js, jg)
    np.testing.assert_allclose(r_s.numpy(), a["reward_sample"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(r_g.numpy(), a["reward_greedy"], rtol=1e-5,
                               atol=1e-5)
    assert (a["reward_sample"] != a["reward_greedy"]).any()
    before = {k: p.detach().clone() for k, p in state.params.items()}
    state, m = step.update(state, batch, js, jg)
    ref = metrics["scst"]
    _metrics_close(m, ref, ["reward_sample", "reward_greedy",
                            "advantage_mean", "advantage_std"], 1e-5)
    _metrics_close(m, ref, ["pg_loss", "xe_anchor", "attr_loss", "loss"],
                   2e-6)
    _metrics_close(m, ref, ["grad_norm"], 2e-3)
    assert state.step == 1 and state.opt_state["count"] == 1
    assert any(not torch.equal(p, before[k])
               for k, p in state.params.items())


@pytest.mark.parametrize("wd,scale,schedule", [
    (0.0, 1.0, "constant"), (0.0, 40.0, "constant"),
    (0.01, 40.0, "cosine"), (0.01, 1.0, "exponential")])
def test_optimizer_matches_optax(wd, scale, schedule):
    """Hand-made gradients (global norm ~2.6 × scale, so 40 is clipped at
    5) through three updates of the JAX package's Optax chain and of the
    port's: the parameters and the moments within 1e-6, the count equal."""
    over = [f"train.weight_decay={wd}", f"train.lr_schedule={schedule}",
            "train.warmup_steps=1", "train.lr_decay_steps=4",
            "train.learning_rate=0.1"]
    jtx = jax_make_optimizer(jax_apply_overrides(
        jax_get_preset("synthetic_tiny"), over))
    tx = make_optimizer(apply_overrides(get_preset("synthetic_tiny"), over))
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=5).astype(np.float32)}
    jp, jst = dict(p0), jtx.init(p0)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    tst = tx.init(tp)
    for _ in range(3):
        g = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
             for k, v in p0.items()}
        upd, jst = jtx.update(g, jst, jp)
        jp = optax.apply_updates(jp, upd)
        tx.update(tp, {k: torch.tensor(v) for k, v in g.items()}, tst)
    adam = jst[1][0]
    assert tst["count"] == int(adam.count) == 3
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tst["mu"][k].numpy(),
                                   np.asarray(adam.mu[k]), rtol=1e-6)
        np.testing.assert_allclose(tst["nu"][k].numpy(),
                                   np.asarray(adam.nu[k]), rtol=1e-6)


@pytest.mark.parametrize("schedule", ["constant", "cosine", "exponential"])
@pytest.mark.parametrize("warmup", [0, 5])
def test_lr_schedule_matches_jax(schedule, warmup):
    over = [f"train.lr_schedule={schedule}", f"train.warmup_steps={warmup}",
            "train.lr_decay_steps=20", "train.lr_decay_rate=0.3"]
    jt = jax_apply_overrides(jax_get_preset("synthetic_tiny"), over).train
    t = apply_overrides(get_preset("synthetic_tiny"), over).train
    jsched, sched = jax_lr_schedule(jt), make_lr_schedule(t)
    for count in range(40):
        want = float(jsched(count)) if callable(jsched) else jsched
        assert sched(count) == pytest.approx(want, rel=1e-6, abs=1e-12)


def _run(tmp_path, name, over, **kw):
    cfg = apply_overrides(get_preset("synthetic_tiny"),
                          [f"train.checkpoint_dir={tmp_path / name}",
                           "train.eval_every=0", "train.log_every=0"] + over)
    from vidcap_tpu_torch.utils.logging import MetricsLogger
    return train(cfg, dataset=CaptionDataset.synthetic(cfg.data),
                 logger=MetricsLogger(quiet=True), device="cpu", **kw)


def _same_state(a, b):
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.opt_state["count"] == b.opt_state["count"]
    for k, p in a.params.items():
        assert torch.equal(p, b.params[k]), k
        for m in ("mu", "nu"):
            assert torch.equal(a.opt_state[m][k], b.opt_state[m][k]), (m, k)


@pytest.mark.parametrize("stage", ["xe", "scst"])
def test_resume_is_exact(tmp_path, stage):
    """4 steps straight equal 2 steps, a checkpoint, and 2 resumed steps in
    a fresh train() call: parameters, optimizer state and generator bit for
    bit (SCST draws its sampling seed from the generator)."""
    over = [f"train.stage={stage}"]
    straight = _run(tmp_path, "a", over, num_steps=4)
    _run(tmp_path, "b", over, num_steps=2)
    resumed = _run(tmp_path, "b", over, num_steps=4, resume=True)
    _same_state(straight, resumed)
    ckpt = CheckpointManager(str(tmp_path / "b"))
    assert ckpt.all_steps() == [2, 4] and ckpt.saved_stage() == stage


def test_stage_change_reinitialises_optimizer(tmp_path):
    """xe → scst: the parameters, step, generator and batch position carry
    over, the optimizer starts fresh (and scst_learning_rate applies); a
    nonzero rng_salt changes the generator; the parameter tree is checked."""
    xe = _run(tmp_path, "s", [], num_steps=2)
    cfg = apply_overrides(get_preset("synthetic_tiny"), ["train.stage=scst"])
    ds = CaptionDataset.synthetic(cfg.data)
    fresh = create_train_state(cfg, create_model(cfg, ds.vocab.size))
    ckpt = CheckpointManager(str(tmp_path / "s"))
    st, it = ckpt.restore_params_only(fresh, with_iter=True)
    assert st.step == 2 and it.position == 8 and it.epoch == 0
    assert torch.equal(st.generator.get_state(), xe.generator.get_state())
    assert st.opt_state["count"] == 0
    for k, p in st.params.items():
        assert torch.equal(p, xe.params[k])
        assert not st.opt_state["mu"][k].any()
    scst = _run(tmp_path, "s", ["train.stage=scst"], num_steps=3,
                resume=True)
    assert scst.step == 3 and scst.opt_state["count"] == 1
    assert ckpt.saved_stage() == "scst"
    _run(tmp_path, "s2", [], num_steps=2)
    salted = _run(tmp_path, "s2", ["train.stage=scst", "train.rng_salt=7"],
                  num_steps=2, resume=True)
    assert not torch.equal(salted.generator.get_state(),
                           xe.generator.get_state())
    wide = apply_overrides(cfg, ["model.hidden_dim=64"])
    other = create_train_state(wide, create_model(wide, ds.vocab.size))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_params_only(other)


def test_cli_train_staged_and_resume(tmp_path, capsys, monkeypatch):
    """``train --stages xe,scst --steps 2,2`` on the CPU: two XE rows, then
    two SCST rows, all finite; one stage line each with no kernel launch
    (CPU tensors take the plain versions); stage.json reads scst; then
    ``--resume --steps 2,3`` runs exactly one more SCST step."""
    monkeypatch.chdir(tmp_path)
    args = ["train", "--preset", "synthetic_tiny", "--stages", "xe,scst",
            "--eval-every", "0", "--log-every", "1", "--device", "cpu",
            "--log-file", "log.jsonl"]
    assert cli_main(args + ["--steps", "2,2"]) == 0
    err = capsys.readouterr().err
    rows = [json.loads(x) for x in open("log.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert all("xe_loss" in r for r in rows[:2])
    assert all("pg_loss" in r and "xe_anchor" in r for r in rows[2:])
    assert all(np.isfinite(v) for r in rows for v in r.values()
               if isinstance(v, float))
    none = ('{"beam_core": 0, "topk_project": 0, "topk_project_int8": 0, '
            '"rollout": 0, "teacher_forced": 0, "moe_dispatch": 0, '
            '"silu_mul": 0, "moe_combine": 0}')
    for stage in ("xe", "scst"):
        assert f"[vidcap] {stage}: 2 steps on cpu; kernel launches {none}" \
            in err
    ckpt = CheckpointManager("checkpoints")
    assert ckpt.saved_stage() == "scst" and ckpt.latest_step() == 4
    assert cli_main(args + ["--steps", "2,3", "--resume"]) == 0
    err = capsys.readouterr().err
    assert "[vidcap] xe: 0 steps" in err and "[vidcap] scst: 1 steps" in err
    assert ckpt.latest_step() == 5
    assert [json.loads(x)["step"] for x in open("log.jsonl")][-1] == 5


def test_train_eval_every_one_runs_validation(tmp_path, capsys, monkeypatch):
    """``--eval-every 1`` within the run, once refused, now validates after
    every step: eval_CIDEr rows at steps 1 and 2 and one best checkpoint."""
    monkeypatch.chdir(tmp_path)
    assert cli_main(["train", "--preset", "synthetic_tiny", "--steps", "2",
                     "--device", "cpu", "--eval-every", "1", "--log-file",
                     "log.jsonl"]) == 0
    rows = [json.loads(x) for x in open("log.jsonl")]
    assert [r["step"] for r in rows if "eval_CIDEr" in r] == [1, 2]
    assert len(CheckpointManager("checkpoints/best").all_steps()) == 1


@pytest.mark.parametrize("extra,message", [
    ([], "no CUDA device")])
def test_train_refuses_what_is_not_ported(tmp_path, capsys, monkeypatch,
                                          extra, message):
    """Exit 2 without a card and without --device cpu, "no CUDA device";
    no checkpoint is written."""
    if not extra and torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device exists")
    monkeypatch.chdir(tmp_path)
    assert cli_main(["train", "--preset", "synthetic_tiny", "--steps", "2",
                     "--eval-every", "0"] + extra) == 2
    assert message in capsys.readouterr().err
    assert not (tmp_path / "checkpoints").exists() or not list(
        (tmp_path / "checkpoints").iterdir())


@pytest.mark.parametrize("extra,rtol", [
    (["--feature-bank"], 0.0),
    (["--set", "train.grad_accum=2"], 1e-6),
    (["--set", "train.prefetch_depth=2"], 0.0),
    (["--sharded"], 1e-6),
    (["--set", "model.dropout_rate=0.1"], None)])
def test_train_accepts_what_is_now_ported(tmp_path, monkeypatch, extra,
                                          rtol):
    """Once refused, now ported: exit 0, a checkpoint written, and the
    plain run's final loss, in f32 (bit for bit; with grad_accum=2 after
    gradients summed in another order, and --sharded over 2 gloo
    processes, within 1e-6). With dropout (rtol None) another, finite
    loss."""
    monkeypatch.chdir(tmp_path)
    args = ["train", "--preset", "synthetic_tiny", "--steps", "3",
            "--eval-every", "0", "--device", "cpu", "--set",
            "model.compute_dtype=float32"]
    assert cli_main(args + ["--checkpoint-dir", "plain", "--log-file",
                            "plain.jsonl"]) == 0
    assert cli_main(args + extra + ["--log-file", "log.jsonl"]) == 0
    assert CheckpointManager("checkpoints").latest_step() == 3
    last = lambda f: [json.loads(x) for x in open(f)][-1]
    assert last("log.jsonl")["step"] == 3
    if rtol is None:
        assert np.isfinite(last("log.jsonl")["loss"])
        assert last("log.jsonl")["loss"] != last("plain.jsonl")["loss"]
        return
    np.testing.assert_allclose(last("log.jsonl")["loss"],
                               last("plain.jsonl")["loss"], rtol=rtol)
