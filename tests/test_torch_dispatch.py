"""The port's train dispatch on the CPU: the device feature bank, multi-step
dispatch, prefetch and ``grad_accum``, each against the port's plain loop
and against the JAX package (``tests/test_feature_bank.py``,
``test_multistep.py``, ``test_grad_accum.py``, ``test_pipeline.py`` hold
the JAX package to the same properties).

On the CPU a dispatched step runs its body eagerly; on the card it is a CUDA
graph (``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 14 hold the
graph to the eager body). A step body reads nothing on the host, which the
dispatch-mode test checks here.

Tolerances: the bank, the chunks, prefetch and a resume change nothing of
the arithmetic, so they are bit for bit. The accumulated XE gradient sums
the same products in another order: against the full batch's rtol 1e-4,
atol 1e-6 (as the JAX package holds its own), against the JAX package's
accumulated gradient 1e-5. The banked multi-step run against the JAX
package's: the f32 train tolerances of tests/test_torch_train.py (losses
1e-6 relative, parameters 5e-5 absolute).
"""
import json
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vidcap_tpu.config import apply_overrides as jax_apply_overrides
from vidcap_tpu.config import get_preset as jax_get_preset
from vidcap_tpu.data.loader import CaptionDataset as JaxDataset
from vidcap_tpu.data.pipeline import DeterministicBatcher as JaxBatcher
from vidcap_tpu.models.model import create_model as jax_create_model
from vidcap_tpu.models.model import init_params as jax_init_params
from vidcap_tpu.train.loop import batch_to_device_dict as jax_batch_dict
from vidcap_tpu.train.state import TrainState as JaxTrainState
from vidcap_tpu.train.state import create_train_state as jax_train_state
from vidcap_tpu.train.steps import make_banked_multistep as jax_multistep
from vidcap_tpu.train.steps import make_xe_step as jax_xe_step
from vidcap_tpu.train.steps import make_xe_step_body as jax_xe_body
from vidcap_tpu_torch.config import apply_overrides, get_preset
from vidcap_tpu_torch.convert import flatten_tree, from_flax
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.data.pipeline import (DeterministicBatcher,
                                            IteratorState, PrefetchBatcher)
from vidcap_tpu_torch.inference import Captioner
from vidcap_tpu_torch.models.model import create_model, init_params
from vidcap_tpu_torch.train.checkpoint import CheckpointManager
from vidcap_tpu_torch.train.loop import (batch_to_device,
                                         batch_to_device_dict, train)
from vidcap_tpu_torch.train.scst import make_scst_step_body
from vidcap_tpu_torch.train.state import create_train_state
from vidcap_tpu_torch.train.steps import (accum_grads, draw_seeds,
                                          make_banked_multistep,
                                          make_banked_step, make_step,
                                          make_xe_step_body, xe_grads)
from vidcap_tpu_torch.utils.logging import MetricsLogger

F32 = ["model.compute_dtype=float32"]


class Rows(MetricsLogger):
    """Keeps every logged row (without its wall clock and rate)."""

    def __init__(self):
        super().__init__(quiet=True)
        self.rows = []

    def log(self, step, metrics, prefix="train"):
        self.rows.append((int(step), {
            k: float(v) for k, v in metrics.items()
            if k not in ("steps_per_sec", "val_seconds")}))


def _cfg(over):
    return apply_overrides(get_preset("synthetic_tiny"), over)


def _run(tmp_path, name, over, logger=None, **kw):
    cfg = _cfg([f"train.checkpoint_dir={tmp_path / name}",
                "train.eval_every=0", "train.log_every=1"] + over)
    return train(cfg, dataset=CaptionDataset.synthetic(cfg.data),
                 logger=logger or MetricsLogger(quiet=True), device="cpu",
                 **kw)


def _same_state(a, b):
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert int(a.opt_state["count"]) == int(b.opt_state["count"])
    for k, p in a.params.items():
        assert torch.equal(p, b.params[k]), k
        for m in ("mu", "nu"):
            assert torch.equal(a.opt_state[m][k], b.opt_state[m][k]), (m, k)


def _state(cfg, ds, seed=0):
    return create_train_state(cfg, init_params(
        create_model(cfg, ds.vocab.size), seed))


def _body(cfg, ds):
    return (make_xe_step_body(cfg) if cfg.train.stage == "xe"
            else make_scst_step_body(cfg, ds))


# ------------------------------------------------------------ the bank

@pytest.mark.parametrize("stage,steps", [("xe", 3), ("scst", 2)])
def test_banked_step_bit_exact(stage, steps):
    """The banked step (features and attributes gathered by video_idx) and
    the unbanked one from the same init and generator: every metric of
    every step and the state after them bit for bit."""
    cfg = _cfg([f"train.stage={stage}", "train.batch_size=8"])
    ds = CaptionDataset.synthetic(cfg.data)
    plain, banked = _state(cfg, ds), _state(cfg, ds)
    step = make_step(_body(cfg, ds), "cpu")
    bstep, banks = make_banked_step(_body(cfg, ds), ds, device="cpu")
    assert tuple(banks["features"].shape) == ds.features.shape
    it = DeterministicBatcher(ds, 8, seed=3)
    for _ in range(steps):
        b = next(it)
        plain, m_a = step(plain, batch_to_device_dict(b))
        banked, m_b = bstep(banked, batch_to_device_dict(b, bank_mode=True))
        assert {k: float(v) for k, v in m_a.items()} == \
            {k: float(v) for k, v in m_b.items()}
    _same_state(plain, banked)


def test_banked_batch_dict_omits_features():
    ds = CaptionDataset.synthetic(_cfg([]).data)
    b = next(DeterministicBatcher(ds, 4, seed=0))
    full, lean = batch_to_device_dict(b), batch_to_device_dict(b, True)
    assert "features" in full and "attributes" in full
    assert "features" not in lean and "attributes" not in lean
    assert {"video_idx", "tokens", "mask"} <= set(lean)


def test_banked_interrupted_resume_exact(tmp_path):
    """10 banked steps straight equal 5, a checkpoint, and 5 resumed in a
    fresh train() call, bit for bit."""
    over = ["train.device_feature_bank=true", "train.checkpoint_every=5"]
    straight = _run(tmp_path, "a", over, num_steps=10)
    _run(tmp_path, "b", over, num_steps=5)
    resumed = _run(tmp_path, "b", over, num_steps=10, resume=True)
    _same_state(straight, resumed)


def test_caption_dataset_device_bank_identical():
    """Validation's bank: the same captions as the host batches; the bank
    is made once and kept."""
    cfg = _cfg([])
    ds = CaptionDataset.synthetic(cfg.data)
    state = _state(cfg, ds, seed=2)
    cap = Captioner.from_state(cfg, ds, state)
    plain = cap.caption_dataset(method="greedy", batch_size=8)
    banked = cap.caption_dataset(method="greedy", batch_size=8,
                                 device_bank=True)
    assert plain == banked
    bank = cap._feature_bank
    assert bank is not None and tuple(bank.shape) == ds.features.shape
    cap.caption_dataset(method="greedy", batch_size=8, device_bank=True)
    assert cap._feature_bank is bank


@pytest.mark.parametrize("make", ["step", "multistep"])
def test_banked_rejects_pixel_mode(make):
    """A dataset of pixels [N, T, H, W, C] cannot be banked."""
    cfg = _cfg([])
    ds = types.SimpleNamespace(features=np.zeros((2, 3, 4, 4, 3), np.uint8),
                               attributes=np.zeros((2, 8), np.float32))
    body = lambda s, b: (s, {})
    with pytest.raises(ValueError, match="feature-mode"):
        if make == "step":
            make_banked_step(body, ds, device="cpu")
        else:
            make_banked_multistep(body, ds, 4, device="cpu")


# ------------------------------------------------------------ K steps a call

@pytest.mark.parametrize("stage", ["xe", "scst"])
def test_multistep_bit_exact_with_tail(tmp_path, stage):
    """7 steps at K=3 (two chunks and a tail of 1) equal 7 single steps:
    the state, the generator (SCST's seeds) and every log row."""
    over = [f"train.stage={stage}", "train.device_feature_bank=true"]
    r1, r3 = Rows(), Rows()
    s1 = _run(tmp_path, "k1", over, logger=r1, num_steps=7)
    s3 = _run(tmp_path, "k3", over + ["train.steps_per_dispatch=3"],
              logger=r3, num_steps=7)
    _same_state(s1, s3)
    assert r1.rows == r3.rows and [s for s, _ in r3.rows] == list(
        range(1, 8))
    assert len({m["loss"] for _, m in r3.rows}) > 1   # each step its own
    assert CheckpointManager(str(tmp_path / "k3")).all_steps() == [7]


def test_multistep_resume_exact_across_a_change_of_k(tmp_path):
    """A K=3 run stopped at its chunk-boundary checkpoint and resumed at
    K=2 equals an uninterrupted K=3 run."""
    over = ["train.device_feature_bank=true", "train.checkpoint_every=6"]
    ref = _run(tmp_path, "a", over + ["train.steps_per_dispatch=3"],
               num_steps=12)
    _run(tmp_path, "b", over + ["train.steps_per_dispatch=3"], num_steps=6)
    res = _run(tmp_path, "b", over + ["train.steps_per_dispatch=2"],
               num_steps=12, resume=True)
    _same_state(ref, res)


def test_multistep_checkpoints_and_evals_at_chunk_boundaries(tmp_path):
    """K=4 over 10 steps (chunks to 4 and 8, then single steps): a
    checkpoint where the chunk 4→8 crosses the cadence of 5 and at the end,
    validation where the same chunk crosses its cadence of 6, one row a
    step."""
    rows = Rows()
    cfg = _cfg([f"train.checkpoint_dir={tmp_path / 'c'}", "train.log_every=1",
                "train.device_feature_bank=true", "train.steps_per_dispatch=4",
                "train.checkpoint_every=5", "train.eval_every=6"])
    train(cfg, dataset=CaptionDataset.synthetic(cfg.data), logger=rows,
          device="cpu", num_steps=10)
    ckpt = CheckpointManager(str(tmp_path / "c"))
    assert ckpt.all_steps() == [8, 10]
    assert [s for s, m in rows.rows if "eval_CIDEr" in m] == [8]
    assert [s for s, m in rows.rows if "loss" in m] == list(range(1, 11))


def test_multistep_without_the_bank_runs_single_steps(tmp_path, capsys):
    """steps_per_dispatch > 1 without the bank says it is ignored (the
    JAX loop's message) and runs K=1."""
    s1 = _run(tmp_path, "a", [], num_steps=4)
    s3 = _run(tmp_path, "b", ["train.steps_per_dispatch=3"], num_steps=4)
    assert "[vidcap] steps_per_dispatch ignored — multi-step dispatch " \
        "requires the device feature bank" in capsys.readouterr().err
    _same_state(s1, s3)


# ------------------------------------------------------------ prefetch

def test_prefetch_yields_same_stream():
    ds = CaptionDataset.synthetic(_cfg([]).data)
    plain = DeterministicBatcher(ds, batch_size=8, seed=9)
    pre = PrefetchBatcher(DeterministicBatcher(ds, batch_size=8, seed=9))
    for _ in range(10):
        a, b = next(plain), next(pre)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.video_idx, b.video_idx)
    pre.close()


def test_prefetch_state_is_consumer_exact():
    """The state is the consumer's position, however far ahead the producer
    has drawn: resuming from it replays exactly the batches not taken."""
    ds = CaptionDataset.synthetic(_cfg([]).data)
    pre = PrefetchBatcher(DeterministicBatcher(ds, batch_size=8, seed=3),
                          depth=4)
    for _ in range(5):
        next(pre)
    time.sleep(0.05)                 # the producer runs ahead
    saved = pre.state.to_dict()
    assert saved == {"seed": 3, "epoch": 0, "position": 40}
    tail1 = [next(pre) for _ in range(6)]
    pre.close()
    resumed = DeterministicBatcher(ds, batch_size=8,
                                   state=IteratorState.from_dict(saved))
    for a in tail1:
        b = next(resumed)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.video_idx, b.video_idx)


def test_prefetch_raises_the_batchers_error():
    ds = CaptionDataset.synthetic(_cfg([]).data)
    pre = PrefetchBatcher(DeterministicBatcher(ds, batch_size=10_000))
    with pytest.raises(ValueError, match="cannot fill a batch"):
        next(pre)
    pre.close()


@pytest.mark.parametrize("stage", ["xe", "scst"])
def test_prefetched_banked_run_equals_the_plain_loop(tmp_path, stage):
    """train.prefetch_depth = 2 with the bank and K=2: the state and rows
    of the plain loop, bit for bit."""
    r0, r1 = Rows(), Rows()
    s0 = _run(tmp_path, "a", [f"train.stage={stage}"], logger=r0,
              num_steps=5)
    s1 = _run(tmp_path, "b", [f"train.stage={stage}",
                              "train.prefetch_depth=2",
                              "train.device_feature_bank=true",
                              "train.steps_per_dispatch=2"], logger=r1,
              num_steps=5)
    _same_state(s0, s1)
    assert r0.rows == r1.rows


def test_seeds_drawn_at_once_equal_seeds_drawn_one_by_one():
    cfg = _cfg([])
    ds = CaptionDataset.synthetic(cfg.data)
    a, b = _state(cfg, ds), _state(cfg, ds)
    many = draw_seeds(a, 6)
    one = torch.cat([draw_seeds(b, 1) for _ in range(6)])
    assert torch.equal(many, one)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


# ------------------------------------------------------------ grad_accum

def _grad_cfg(**kw):
    over = F32 + ["train.batch_size=8", "train.attribute_loss_weight=0.2"]
    return _cfg(over + [f"train.{k}={v}" for k, v in kw.items()])


def _tiny_batch(ds, n=8):
    return batch_to_device(next(DeterministicBatcher(ds, n, seed=3)), "cpu")


def test_xe_accum_grads_match_full_batch():
    cfg1, cfg4 = _grad_cfg(), _grad_cfg(grad_accum=4)
    ds = CaptionDataset.synthetic(cfg1.data)
    batch = _tiny_batch(ds)
    # rows of different lengths, or the token weighting goes untested
    assert len(set(batch["mask"].sum(1).tolist())) > 1
    state = _state(cfg1, ds)
    g1, m1 = xe_grads(cfg1, state, batch)
    g4, m4 = xe_grads(cfg4, state, batch)
    for k in g1:
        np.testing.assert_allclose(g1[k].numpy(), g4[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for k in ("loss", "xe_loss", "attr_loss", "tokens"):
        np.testing.assert_allclose(float(m1[k].detach()),
                                   float(m4[k].detach()), rtol=1e-5)


def test_xe_accum_grads_match_jax():
    """The port's accumulated gradient (grad_accum=4) against the JAX
    package's ``accum_grads`` (read through an SGD(1) step) on the same
    init_params and batch."""
    over = F32 + ["train.batch_size=8", "train.attribute_loss_weight=0.2",
                  "train.grad_accum=4", "train.donate_state=false"]
    jcfg = jax_apply_overrides(jax_get_preset("synthetic_tiny"), over)
    jds = JaxDataset.synthetic(jcfg.data)
    jm = jax_create_model(jcfg, jds.vocab.size)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jax_init_params(jm, jcfg, k))(jax.random.key(0)))
    b = next(JaxBatcher(jds, 8, seed=3))
    tx = optax.sgd(1.0)
    st = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params), rng=jax.random.key(0),
                       tx=tx)
    st2, _ = jax_xe_step(jm, jcfg)(st, {k: getattr(b, k) for k in (
        "features", "tokens", "mask", "attributes", "video_idx")})
    want = flatten_tree(jax.tree_util.tree_map(
        lambda a, z: np.asarray(a) - np.asarray(z), params, st2.params))
    cfg = apply_overrides(get_preset("synthetic_tiny"), over)
    ds = CaptionDataset.synthetic(cfg.data)
    model = from_flax(create_model(cfg, ds.vocab.size), params)
    got, _ = accum_grads(cfg, create_train_state(cfg, model),
                         batch_to_device(next(DeterministicBatcher(
                             ds, 8, seed=3)), "cpu"))
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k.replace(".", "/")],
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("stage", ["xe", "scst"])
def test_accum_indivisible_batch_raises(stage):
    cfg = _grad_cfg(grad_accum=3, stage=stage)
    ds = CaptionDataset.synthetic(cfg.data)
    with pytest.raises(ValueError, match="not divisible"):
        _body(cfg, ds)(_state(cfg, ds), {**_tiny_batch(ds),
                                         "seed": torch.zeros(3, dtype=torch.int64)})


def test_scst_accum_exact_terms():
    """grad_accum=2 in SCST: the XE anchor and the BCE equal the full
    batch's; every metric finite; a nonzero gradient."""
    cfg1 = _grad_cfg(stage="scst", scst_xe_mix=0.1)
    cfg2 = _grad_cfg(stage="scst", scst_xe_mix=0.1, grad_accum=2)
    ds = CaptionDataset.synthetic(cfg1.data)
    batch = _tiny_batch(ds)
    s1, m1 = make_scst_step_body(cfg1, ds)(_state(cfg1, ds), batch, seed=4)
    st = _state(cfg2, ds)
    before = {k: p.detach().clone() for k, p in st.params.items()}
    st, m2 = make_scst_step_body(cfg2, ds)(
        st, {**batch, "seed": torch.tensor([4, 5])})
    for k in ("xe_anchor", "attr_loss"):
        np.testing.assert_allclose(float(m1[k]), float(m2[k]), rtol=1e-5)
    assert all(np.isfinite(float(v)) for v in m2.values())
    assert float(m2["grad_norm"]) > 0
    assert any(not torch.equal(p, before[k]) for k, p in st.params.items())


# ------------------------------------------------------------ against JAX

def test_banked_multistep_matches_jax():
    """4 banked XE steps at K=2, f32: the port's chunks against the JAX
    package's ``make_banked_multistep`` from the same init_params on the
    same stream: each step's loss, and the parameters after."""
    over = F32 + ["train.device_feature_bank=true",
                  "train.steps_per_dispatch=2", "train.donate_state=false"]
    jcfg = jax_apply_overrides(jax_get_preset("synthetic_tiny"), over)
    jds = JaxDataset.synthetic(jcfg.data)
    jm = jax_create_model(jcfg, jds.vocab.size)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jax_init_params(jm, jcfg, k))(jax.random.key(0)))
    jfn, _ = jax_multistep(jcfg, jax_xe_body(jm, jcfg), jds, 2)
    js = jax_train_state(jcfg, params)
    cfg = apply_overrides(get_preset("synthetic_tiny"), over)
    ds = CaptionDataset.synthetic(cfg.data)
    state = create_train_state(cfg, from_flax(create_model(
        cfg, ds.vocab.size), params))
    fn, _ = make_banked_multistep(make_xe_step_body(cfg), ds, 2,
                                  device="cpu")
    jit, it = JaxBatcher(jds, 4, seed=0), DeterministicBatcher(ds, 4, seed=0)
    for _ in range(2):
        jb = [jax_batch_dict(next(jit), bank_mode=True) for _ in range(2)]
        pb = [batch_to_device_dict(next(it), bank_mode=True)
              for _ in range(2)]
        js, jm_ = jfn(js, {k: np.stack([b[k] for b in jb]) for k in jb[0]})
        state, m = fn(state, {k: np.stack([b[k] for b in pb])
                              for k in pb[0]})
        np.testing.assert_allclose(m["loss"].numpy(), np.asarray(
            jm_["loss"]), rtol=1e-6)
    assert state.step == 4 and int(state.opt_state["count"]) == 4
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, js.params))
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name.replace(".", "/")], rtol=0,
                                   atol=5e-5, err_msg=name)


# ------------------------------------------------------------ host reads

class NoHostRead(TorchDispatchMode):
    """Raises where an op reads a tensor's value on the host: .item(),
    int(t), float(t) and bool(t) reach ``_local_scalar_dense``, boolean
    indexing ``nonzero``. A CUDA graph cannot hold either."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default,
                    torch.ops.aten.nonzero.default):
            raise RuntimeError(f"host read in a step body: {func}")
        return func(*args, **(kwargs or {}))


def _chunk_under_the_mode(stage, mutate=False):
    """One banked chunk of K=2 steps with grad_accum=2 and the attribute
    head, the step body run under NoHostRead; ``mutate`` adds one .item()
    to the body."""
    cfg = _cfg([f"train.stage={stage}", "train.grad_accum=2",
                "train.attribute_loss_weight=0.2"])
    ds = CaptionDataset.synthetic(cfg.data)
    state = _state(cfg, ds)
    body = _body(cfg, ds)

    def checked(s, b):
        with NoHostRead():
            s, m = body(s, b)
            if mutate:
                m["loss"].item()
        return s, m
    checked.seeds_per_step = getattr(body, "seeds_per_step", 0)
    fn, _ = make_banked_multistep(checked, ds, 2, device="cpu")
    it = DeterministicBatcher(ds, 4, seed=0)
    bs = [batch_to_device_dict(next(it), bank_mode=True) for _ in range(2)]
    return fn(state, {k: np.stack([b[k] for b in bs]) for k in bs[0]})


@pytest.mark.parametrize("stage", ["xe", "scst"])
def test_step_bodies_read_nothing_on_the_host(stage):
    state, m = _chunk_under_the_mode(stage)
    assert state.step == 2 and all(np.isfinite(v.numpy()).all()
                                   for v in m.values())
    with pytest.raises(RuntimeError, match="host read"):
        _chunk_under_the_mode(stage, mutate=True)


def test_cli_train_end_state_flags_on_the_cpu(tmp_path, monkeypatch):
    """``train --stages xe,scst --steps 6,4 --feature-bank
    --steps-per-dispatch 3,2 --set train.prefetch_depth=2`` on the CPU: a
    row a step, the same rows as the plain command; a list of K of the
    wrong length exits with a message."""
    monkeypatch.chdir(tmp_path)
    from vidcap_tpu_torch.cli.main import main as cli_main
    args = ["train", "--preset", "synthetic_tiny", "--stages", "xe,scst",
            "--steps", "6,4", "--eval-every", "0", "--log-every", "1",
            "--device", "cpu"]

    def rows(path):
        return [{k: v for k, v in json.loads(x).items()
                 if k not in ("wall_s", "steps_per_sec")} for x in open(path)]
    assert cli_main(args + ["--log-file", "a.jsonl", "--checkpoint-dir",
                            "a"]) == 0
    assert cli_main(args + ["--log-file", "b.jsonl", "--checkpoint-dir", "b",
                            "--feature-bank", "--steps-per-dispatch", "3,2",
                            "--set", "train.prefetch_depth=2"]) == 0
    assert rows("a.jsonl") == rows("b.jsonl")
    assert [r["step"] for r in rows("b.jsonl")] == list(range(1, 11))
    with pytest.raises(SystemExit,
                       match="--steps-per-dispatch lists 3 values for 2"):
        cli_main(args + ["--steps-per-dispatch", "3,2,1"])
