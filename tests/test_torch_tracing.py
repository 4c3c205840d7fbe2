"""The port's spans and phase marks (vidcap_tpu_torch/utils/profiling.py):
nothing recorded while tracing is off; under a ``torch.profiler`` session
or ``recording()`` spans nest, carry their parent and id and lie on
``time.perf_counter``; the store keeps its bound; a decode records one
upload, one download and one ``beam.exit_check`` a host read; the
dispatch's two spans; the training steps' phase marks in order. On the
card (marker ``cuda``): a captured graph replays its marks, and a profiler
that records the card's activity alone turns tracing on.

Imports no JAX, so the ``cuda`` test runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""
import collections
import threading
import time

import numpy as np
import pytest
import torch

from vidcap_tpu_torch.config import apply_overrides, get_preset
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.data.pipeline import DeterministicBatcher
from vidcap_tpu_torch.data.vocab import EOS, Vocab
from vidcap_tpu_torch.inference import Captioner
from vidcap_tpu_torch.models.model import create_model, init_params
from vidcap_tpu_torch.train.loop import batch_to_device, batch_to_device_dict
from vidcap_tpu_torch.train.scst import make_scst_step_body
from vidcap_tpu_torch.train.state import create_train_state
from vidcap_tpu_torch.train.steps import make_step, make_xe_step_body
from vidcap_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


def named(name):
    return [s for s in profiling.spans() if s.name == name]


def test_nothing_is_recorded_while_tracing_is_off():
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.annotate("outer", 1):
        with profiling.annotate("inner", 1):
            torch.ones(4).sum()
    assert profiling.spans() == []
    # the off path hands out one shared no-op object
    assert profiling.annotate("a") is profiling.annotate("b", 3)


def _nested(outer_id):
    before = time.perf_counter()
    with profiling.annotate("outer", outer_id):
        with profiling.annotate("inner", outer_id):
            torch.ones(4).sum()
        seen = {}
        t = threading.Thread(target=lambda: seen.update(
            parent=_span_in_thread()))
        t.start()
        t.join(10)
        assert not t.is_alive()
    after = time.perf_counter()
    return before, after, seen["parent"]


def _span_in_thread():
    with profiling.annotate("other_thread"):
        pass
    return named("other_thread")[0].parent


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_spans_nest_with_parent_and_id(how):
    if how == "profiler":
        ctx = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
    else:
        ctx = profiling.recording()
    with ctx:
        before, after, other_parent = _nested(7)
    inner, = named("inner")
    outer, = named("outer")
    assert (inner.parent, inner.id) == ("outer", 7)
    assert (outer.parent, outer.id) == (None, 7)
    assert inner.thread == outer.thread == threading.get_ident()
    assert before <= outer.t0 <= inner.t0 <= inner.t1 <= outer.t1 <= after
    # another thread's span has its own (empty) chain of open spans
    assert other_parent is None
    # and after the block, nothing more is recorded
    with profiling.annotate("after"):
        pass
    assert named("after") == []


def test_recording_contexts_nest():
    with profiling.recording():
        with profiling.recording():
            pass
        with profiling.annotate("still_on"):
            pass
    with profiling.annotate("off"):
        pass
    assert [s.name for s in profiling.spans()] == ["still_on"]


def test_the_store_keeps_its_bound(monkeypatch):
    assert profiling._store.maxlen == profiling.MAX_SPANS == 1_000_000
    monkeypatch.setattr(profiling, "_store", collections.deque(maxlen=4))
    with profiling.recording():
        for i in range(10):
            with profiling.annotate("s", i):
                pass
    assert [s.id for s in profiling.spans()] == [6, 7, 8, 9]


# ----------------------------------------------------------- the decode


def _captioner(over, eos_bias):
    cfg = apply_overrides(get_preset("synthetic_tiny"), over)
    words = ["<pad>", "<bos>", "<eos>", "<unk>"] + [f"w{i}" for i in
                                                    range(4, 40)]
    vocab = Vocab({w: i for i, w in enumerate(words)}, words)
    T, D = cfg.data.num_frames, cfg.data.feature_dim
    ds = CaptionDataset(np.zeros((1, T, D), np.float32), ["v0"],
                        {"v0": ["w4"]}, cfg.data, vocab=vocab)
    model = init_params(create_model(cfg, vocab_size=len(words)), seed=0)
    with torch.no_grad():
        model.decoder.out_proj.bias[EOS] += eos_bias
    return Captioner(cfg, model.eval(), ds, torch.device("cpu"))


@pytest.mark.parametrize("eos_bias", [30.0, -1e4],
                         ids=["ends_early", "runs_to_max_len"])
@pytest.mark.parametrize("method,over", [
    ("beam", []),
    ("beam", ["decode.finished_pool=on", "decode.length_penalty=0.6"]),
    ("greedy", ["model.compute_dtype=float32"]),
], ids=["beam", "pool", "greedy_modules"])
def test_a_decode_records_its_upload_download_and_host_reads(method, over,
                                                             eos_bias):
    cap = _captioner(over, eos_bias)
    assert cap.cfg.decode.early_exit
    feats = np.random.default_rng(0).normal(
        size=(3, cap.cfg.data.num_frames, cap.cfg.data.feature_dim)
    ).astype(np.float32)
    cap.decode_batch(feats, method=method, beam_width=3)   # call 0
    steps0 = cap.decode_steps
    with profiling.recording():
        cap.decode_batch(feats, method=method, beam_width=3)   # call 1
    steps = cap.decode_steps - steps0
    ended_early = steps < cap.max_len
    assert ended_early == (eos_bias > 0)
    decode, = named("captioner.decode")
    upload, = named("captioner.upload")
    download, = named("captioner.download")
    assert decode.id == upload.id == download.id == 1
    assert upload.parent == download.parent == "captioner.decode"
    assert decode.t0 <= upload.t0 <= upload.t1 <= download.t0 <= decode.t1
    checks = named("beam.exit_check")
    # one host read a step the loop ran, plus the read that ends it early
    assert len(checks) == steps + ended_early
    assert [s.id for s in checks] == list(range(len(checks)))
    assert all(s.parent == "captioner.decode" for s in checks)


def test_a_kernel_route_decode_reads_no_flag_on_the_host():
    """Greedy on the one-layer bf16 decoder is one K3 rollout (its plain
    version on the CPU): no loop on the host, so no exit check."""
    cap = _captioner([], 0.0)
    feats = np.zeros((2, cap.cfg.data.num_frames, cap.cfg.data.feature_dim),
                     np.float32)
    with profiling.recording():
        cap.decode_batch(feats, method="greedy")
    assert named("beam.exit_check") == []
    assert len(named("captioner.upload")) == 1


# ------------------------------------------------------------- training


def _train(over):
    cfg = apply_overrides(get_preset("synthetic_tiny"), over)
    ds = CaptionDataset.synthetic(cfg.data)
    state = create_train_state(cfg, create_model(cfg, ds.vocab.size))
    it = DeterministicBatcher(ds, cfg.train.batch_size, seed=0)
    return cfg, ds, state, next(iter(it))


@pytest.fixture
def marks(monkeypatch):
    seen = []
    monkeypatch.setattr(profiling, "phase",
                        lambda name, like: seen.append(name))
    return seen


SCST_MARKS = ["rollout", "loss", "reward", "loss", "backward"]


@pytest.mark.parametrize("accum", [1, 2])
def test_an_scst_step_marks_its_phases_in_order(marks, accum):
    cfg, ds, state, batch = _train(["train.stage=scst",
                                    f"train.grad_accum={accum}"])
    step = make_scst_step_body(cfg, ds)
    step(state, batch_to_device(batch, "cpu"), seed=[1] * accum)
    assert marks == SCST_MARKS * accum + ["update", "end"]


def test_an_xe_step_marks_backward_update_and_end(marks):
    cfg, _, state, batch = _train([])
    make_xe_step_body(cfg)(state, batch_to_device(batch, "cpu"))
    assert marks == ["backward", "update", "end"]


def test_a_mark_on_the_cpu_does_nothing():
    profiling.phase("rollout", torch.zeros(1))


def test_the_dispatch_records_inputs_and_replay_by_step():
    cfg, ds, state, batch = _train(["train.stage=scst"])
    step_fn = make_step(make_scst_step_body(cfg, ds), "cpu")
    state, _ = step_fn(state, batch_to_device_dict(batch))
    with profiling.recording():
        state, _ = step_fn(state, batch_to_device_dict(batch))
    inputs, = named("dispatch.inputs")
    replay, = named("dispatch.replay")
    assert inputs.id == replay.id == 1 and state.step == 2
    assert inputs.t1 <= replay.t0


# ------------------------------------------------------------- the card


@pytest.mark.cuda
def test_a_captured_graph_replays_its_marks_under_the_profiler():
    """Each mark is captured into the graph and runs at every replay; a
    profiler that records only the card's activity (as the benchmark's
    traced slice does) turns span recording on."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(256, device="cuda")
    for name in profiling.PHASES:      # load before the capture
        profiling.phase(name, x)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for name in profiling.PHASES:
            profiling.phase(name, x)
            x.add_(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        for i in range(3):
            with profiling.annotate("replay", i):
                graph.replay()
        torch.cuda.synchronize()
    assert [s.id for s in named("replay")] == [0, 1, 2]
    names = collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA)
    for name in profiling.PHASES:
        got = sum(n for k, n in names.items()
                  if k.startswith(f"vidcap_phase_{name}"))
        assert got == 3, (name, dict(names))
    assert float(x[0]) == 3 * len(profiling.PHASES)
