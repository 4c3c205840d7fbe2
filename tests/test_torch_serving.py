"""The port's serving (``vidcap_tpu_torch/serving.py``, ``serve``) against
the JAX package's (``vidcap_tpu/serving.py``) on the CPU: a counterpart of
each test of tests/test_serving.py, and the stdin lines, HTTP captions,
status codes and /stats keys of both packages side by side.

Both packages decode in process at ``synthetic_tiny`` size in float32, the
port on weights carried over from JAX ``init_params`` by
``convert.from_flax``. Tolerance: identical lines, captions and status codes
(f32 greedy and beam are identical, tests/test_torch_slice.py and
tests/test_torch_rollout.py). The timing tests use stub captioners with the
reference's margins and wait a few seconds at most.
"""
import http.client
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_slice import PYTHONPATH, kernel_route  # noqa: F401
from vidcap_tpu.config import apply_overrides as jax_apply_overrides
from vidcap_tpu.config import get_preset as jax_get_preset
from vidcap_tpu.data.loader import CaptionDataset as JaxDataset
from vidcap_tpu.inference import Captioner as JaxCaptioner
from vidcap_tpu.serving import CaptionServer as JaxCaptionServer
from vidcap_tpu.serving import make_http_server as jax_make_http_server
from vidcap_tpu_torch.cli.main import main as cli_main
from vidcap_tpu_torch.config import apply_overrides, get_preset
from vidcap_tpu_torch.convert import from_flax, save_weights
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.inference import Captioner
from vidcap_tpu_torch.models.model import create_model
from vidcap_tpu_torch.serving import (BatchingCaptioner, CaptionServer,
                                      ServerOverloaded, make_http_server)

F32 = ["model.compute_dtype=float32"]
# ``python -m vidcap_tpu_torch`` with Python's SIGINT handler installed even
# where the parent ignores SIGINT, so that SIGINT ends ``serve --http``
SERVE_CHILD = ("import runpy, signal; signal.signal(signal.SIGINT, "
               "signal.default_int_handler); runpy.run_module("
               "'vidcap_tpu_torch', run_name='__main__', alter_sys=True)")


@pytest.fixture(scope="module")
def jax_side():
    """(config, Captioner) of the JAX package: synthetic_tiny in float32,
    ``init_params`` weights, the synthetic corpus the CLI falls back to
    (64 videos, so the CLI's vocab is the same)."""
    jcfg = jax_apply_overrides(jax_get_preset("synthetic_tiny"), F32)
    jds = JaxDataset.synthetic(jcfg.data)
    return jcfg, JaxCaptioner.from_checkpoint(jcfg, jds, checkpoint_dir=None)


@pytest.fixture(scope="module")
def cfg():
    return apply_overrides(get_preset("synthetic_tiny"), F32)


def port_captioner(cfg, jcap) -> Captioner:
    """A fresh port Captioner on the CPU with the JAX captioner's weights
    and the same corpus (the same vocab)."""
    ds = CaptionDataset.synthetic(cfg.data)
    assert ds.vocab.id_to_word == jcap.dataset.vocab.id_to_word
    model = from_flax(create_model(cfg, ds.vocab.size), jcap.params)
    return Captioner(cfg, model.eval(), ds, torch.device("cpu"))


@pytest.fixture()
def cap(cfg, jax_side):
    return port_captioner(cfg, jax_side[1])


def write_features(root, frames, seed=0, dim=64):
    """One [t, dim] N(0,1) .npy file per entry of ``frames``; the paths."""
    rng = np.random.default_rng(seed)
    paths = []
    for i, t in enumerate(frames):
        p = root / f"feat{i}.npy"
        np.save(p, rng.normal(size=(t, dim)).astype(np.float32))
        paths.append(str(p))
    return paths


def serve_lines(server, paths, **kw) -> str:
    out = io.StringIO()
    server.run(inp=io.StringIO("\n".join(paths) + "\n"), out=out, **kw)
    return out.getvalue()


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_serve_lines_identical_to_jax(tmp_path, cfg, jax_side, cap, method):
    """1.5 batches of 4: full-length, short (masked) and long (cut) files,
    one missing path and one of the wrong feature dim (both skipped): the
    port's output is the JAX server's, line for line."""
    jcfg, jcap = jax_side
    paths = write_features(tmp_path, (8, 3, 8, 12, 1, 8))
    bad = tmp_path / "bad.npy"
    np.save(bad, np.zeros((8, 71), np.float32))
    paths[2:2] = [str(tmp_path / "missing.npy"), str(bad)]
    kw = dict(batch_size=4, method=method, beam_width=3)
    want = serve_lines(JaxCaptionServer(jcfg, jcap, **kw), paths)
    got = serve_lines(CaptionServer(cfg, cap, **kw), paths)
    assert len(got.splitlines()) == 6
    assert got == want
    # the warmup decode and the two flushes
    assert cap.decode_calls == 3


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_serve_lines_identical_to_jax_on_the_kernel_route(
        tmp_path, cfg, jax_side, kernel_route, method):
    """The same lines with the f32 decoder on the kernel decoder's steps
    (K1/K2's and K3's plain versions here)."""
    test_serve_lines_identical_to_jax(tmp_path, cfg, jax_side,
                                      port_captioner(cfg, jax_side[1]),
                                      method)
    assert kernel_route["fused_beam_step" if method == "beam"
                        else "model_rollout"] == 3


def test_serve_features_roundtrip(tmp_path, cfg, cap):
    paths = write_features(tmp_path, (8,) * 6)   # 1.5 batches
    paths.insert(3, str(tmp_path / "missing.npy"))   # bad row skipped
    out = io.StringIO()
    served = CaptionServer(cfg, cap, batch_size=4).run(
        inp=io.StringIO("\n".join(paths) + "\n"), out=out)
    lines = [l for l in out.getvalue().splitlines() if l]
    assert served == 6 and len(lines) == 6
    for line in lines:
        path, caption = line.split("\t")
        assert path.endswith(".npy") and isinstance(caption, str)


def test_serve_short_features_masked(tmp_path, cfg, cap):
    """A short file's caption is the decode of its zero-padded batch with
    the frame mask (the padding is invisible to attention)."""
    T, D = cfg.data.num_frames, cfg.data.feature_dim
    p, = write_features(tmp_path, (T // 2,), seed=1)
    out = io.StringIO()
    CaptionServer(cfg, cap, batch_size=4).run(inp=io.StringIO(p + "\n"),
                                              out=out)
    served = out.getvalue().splitlines()[0].split("\t")[1]
    batch = np.zeros((4, T, D), np.float32)
    batch[0, :T // 2] = np.load(p)
    mask = np.zeros((4, T), np.float32)
    mask[0, :T // 2] = 1.0
    toks = cap.decode_batch(batch, method="greedy", frame_mask=mask)
    assert served == cap.dataset.vocab.decode_str(toks[0])


def test_serve_wrong_dim_skipped(tmp_path, cfg, cap):
    T, D = cfg.data.num_frames, cfg.data.feature_dim
    bad, good = tmp_path / "bad.npy", tmp_path / "good.npy"
    np.save(bad, np.zeros((T, D + 7), np.float32))
    np.save(good, np.zeros((T, D), np.float32))
    out = io.StringIO()
    served = CaptionServer(cfg, cap, batch_size=2).run(
        inp=io.StringIO(f"{bad}\n{good}\n"), out=out)
    lines = [l for l in out.getvalue().splitlines() if l]
    assert served == 1 and len(lines) == 1
    assert lines[0].startswith(str(good))


def test_serve_flush_on_timeout(tmp_path, cfg, cap):
    """With max_wait_ms, a partial batch flushes once its oldest request
    hits the deadline, long before the input ends; p50/p99 are kept."""
    server = CaptionServer(cfg, cap, batch_size=8, max_wait_ms=150)
    server.warmup()
    paths = write_features(tmp_path, (8,) * 3, seed=5)   # 3 of 8
    r_fd, w_fd = os.pipe()
    reader, writer = os.fdopen(r_fd, "r"), os.fdopen(w_fd, "w")

    class TimedOut:
        def __init__(self):
            self.events = []

        def write(self, s):
            if "\t" in s:
                self.events.append(time.perf_counter())

        def flush(self):
            pass

    out = TimedOut()

    def feed():
        writer.write("\n".join(paths) + "\n")
        writer.flush()
        time.sleep(2.0)       # EOF only after 2 s: the flush must beat it
        writer.close()

    t0 = time.perf_counter()
    ft = threading.Thread(target=feed)
    ft.start()
    served = server.run(inp=reader, out=out, warmup=False)
    ft.join(10)
    assert not ft.is_alive()
    assert served == 3 and len(out.events) == 3
    assert out.events[0] - t0 < 1.5, "flush-on-timeout did not fire"
    p50, p99 = server.latency_percentiles()
    assert p50 is not None and p99 >= p50 > 0


def test_serve_pipelined_overlaps_load_and_decode(cfg, cap, monkeypatch):
    """pipeline_depth > 0: batch N+1's loading overlaps batch N's decode,
    the output order is kept (stub load and decode sleeps)."""
    server = CaptionServer(cfg, cap, batch_size=2, pipeline_depth=1)
    T, D, L = cfg.data.num_frames, cfg.data.feature_dim, cfg.decode.max_len
    monkeypatch.setattr(server, "_load_features", lambda path: (
        time.sleep(0.06), np.zeros((T, D), np.float32))[1])
    monkeypatch.setattr(cap, "decode_batch", lambda *a, **k: (
        time.sleep(0.12), np.zeros((2, L), np.int32))[1])
    lines = "\n".join(f"p{i}.npy" for i in range(8)) + "\n"   # 4 batches
    out = io.StringIO()
    t0 = time.perf_counter()
    served = server.run(inp=io.StringIO(lines), out=out, warmup=False)
    dt = time.perf_counter() - t0
    assert served == 8
    outs = [l.split("\t")[0] for l in out.getvalue().splitlines() if l]
    assert outs == [f"p{i}.npy" for i in range(8)]
    # serial: 4 x (120 ms load + 120 ms decode) = 0.96 s; pipelined ~0.60 s
    assert dt < 0.85, f"no load/decode overlap: {dt:.2f}s"


def run_bounded(fn, timeout=15):
    """Run fn on a thread; fail instead of hanging if it deadlocks. Returns
    the exception it raised, or None."""
    box = {}

    def target():
        try:
            fn()
        except BaseException as e:
            box["exc"] = e

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), "server.run() deadlocked"
    return box.get("exc")


def test_serve_worker_error_raises_not_deadlocks(cfg, cap, monkeypatch):
    """A decode error in the pipelined worker surfaces from run(); the
    worker keeps draining, so the main thread never blocks on put()."""
    server = CaptionServer(cfg, cap, batch_size=2, pipeline_depth=1)
    T, D = cfg.data.num_frames, cfg.data.feature_dim
    monkeypatch.setattr(server, "_load_features",
                        lambda path: np.zeros((T, D), np.float32))

    def boom(*a, **k):
        raise RuntimeError("decode boom")
    monkeypatch.setattr(cap, "decode_batch", boom)
    lines = "\n".join(f"p{i}.npy" for i in range(8)) + "\n"
    exc = run_bounded(lambda: server.run(inp=io.StringIO(lines),
                                         out=io.StringIO(), warmup=False))
    assert isinstance(exc, RuntimeError) and "decode boom" in str(exc)


def test_serve_reader_error_raises_not_deadlocks(cfg, cap):
    class BadInput:
        def __iter__(self):
            yield "missing0.npy\n"      # skipped (load fails)
            raise OSError("stream broke")

    exc = run_bounded(lambda: CaptionServer(cfg, cap, batch_size=4).run(
        inp=BadInput(), out=io.StringIO(), warmup=False))
    assert isinstance(exc, OSError) and "stream broke" in str(exc)


@pytest.mark.parametrize("method,weights", [("greedy", "_rollout_weights"),
                                            ("beam", "_beam_weights")])
def test_warmup_casts_weights_before_the_first_request(jax_side, method,
                                                       weights):
    """The warmup pays the weight cast (and on the card the kernels' build,
    ``_build.build_all``) with one decode of the flush shape; serving then
    casts nothing. On the preset's bf16 decoder, the one whose decodes cast
    weights for the kernels (an f32 decoder decodes through its modules)."""
    cfg = apply_overrides(get_preset("synthetic_tiny"), [])
    cap = port_captioner(cfg, jax_side[1])
    server = CaptionServer(cfg, cap, batch_size=4, method=method,
                           beam_width=3)
    # the method's tensors in the Captioner's one KernelWeights: K3's, or
    # K1's (Wq, u, Wg, bg)
    part = {"_rollout_weights": "_rollout", "_beam_weights": "_cell"}[weights]
    assert getattr(cap._weights, part) is None
    server.warmup()
    cast = getattr(cap._weights, part)
    assert cast is not None and cap.decode_calls == 1
    T, D = cfg.data.num_frames, cfg.data.feature_dim
    server._flush(["a"], [np.zeros((T, D), np.float32)], [time.perf_counter()],
                  io.StringIO())
    assert getattr(cap._weights, part) is cast and cap.decode_calls == 2


def test_serve_sharded_is_refused(tmp_path, cfg, jax_side, monkeypatch,
                                  capsys):
    """``serve --sharded`` runs (once refused): with a mesh of one rank
    (``mesh.num_data=1``) it prints the reference's notice and serves on
    that device, the lines of the plain server (the multi-process server:
    tests/test_torch_parallel.py).
    What stays refused is the reference's refusal: ``--sharded`` with
    ``--from-export``."""
    weights = str(tmp_path / "w.npz")
    save_weights(port_captioner(cfg, jax_side[1]).model, weights)
    paths = write_features(tmp_path, (8, 2, 5), seed=3)
    out = {}
    for extra in ([], ["--sharded", "--set", "mesh.num_data=1"]):
        monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(paths)
                                                      + "\n"))
        assert cli_main(["serve", "--preset", "synthetic_tiny", "--weights",
                         weights, "--method", "greedy", "--batch", "4",
                         "--device", "cpu", "--set", F32[0]] + extra) == 0
        out[bool(extra)] = capsys.readouterr()
    assert out[True].out == out[False].out and out[True].out
    assert "--sharded requested but only one device visible" in \
        out[True].err
    with pytest.raises(SystemExit, match="--sharded requires"):
        cli_main(["serve", "--preset", "synthetic_tiny", "--sharded",
                  "--from-export", str(tmp_path), "--device", "cpu"])


def test_cli_serve_stdin(tmp_path, cfg, jax_side, monkeypatch, capsys):
    """``serve --weights W.npz --device cpu`` over stdin: the lines of the
    in-process JAX server, then the served count with p50/p99 and the
    decodes line on stderr."""
    jcfg, jcap = jax_side
    weights = str(tmp_path / "w.npz")
    save_weights(port_captioner(cfg, jcap).model, weights)
    paths = write_features(tmp_path, (8, 2, 8, 5, 8), seed=7)
    want = serve_lines(JaxCaptionServer(jcfg, jcap, batch_size=4,
                                        method="beam", beam_width=3), paths)
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(paths) + "\n"))
    assert cli_main(["serve", "--preset", "synthetic_tiny", "--weights",
                     weights, "--method", "beam", "--beam", "3", "--batch",
                     "4", "--max-wait-ms", "50", "--device", "cpu",
                     "--set", F32[0]]) == 0
    out, err = capsys.readouterr()
    assert out == want
    assert "[vidcap] served 5 captions latency p50=" in err
    assert "[vidcap] beam: 3 decodes" in err and "kernel launches" in err


# --------------------------------------------------------------- HTTP

def request(port, method, path, body=None, ctype="application/octet-stream"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=body,
                 headers={"Content-Type": ctype} if body is not None else {})
    r = conn.getresponse()
    out = (r.status, json.loads(r.read()))
    conn.close()
    return out


def npy_bytes(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def post_npy(port, arr):
    return request(port, "POST", "/caption", npy_bytes(arr))


def post_path(port, path):
    return request(port, "POST", "/caption", json.dumps({"path": path}),
                   "application/json")


class Gate:
    """A captioner whose decode_batch waits for ``release`` once ``closed``
    and sets ``entered`` when it starts: holds the batcher in a decode so
    the bounded queue fills deterministically."""

    def __init__(self, inner):
        self.inner = inner
        self.dataset = inner.dataset
        self.entered = threading.Event()
        self.release = threading.Event()
        self.release.set()

    def warmup(self, *a, **k):
        return self.inner.warmup(*a, **k)

    def decode_batch(self, *a, **k):
        self.entered.set()
        assert self.release.wait(30)
        return self.inner.decode_batch(*a, **k)


def http_script(cfg, make, captioner, root):
    """The same requests to a server built by ``make`` (either package's
    make_http_server): [(status, caption or error kind)], the /stats keys
    and counts. The 429: one request held in its decode, one queued
    (max_queue 1), the third refused."""
    T, D = cfg.data.num_frames, cfg.data.feature_dim
    rng = np.random.default_rng(0)
    gate = Gate(captioner)
    server, svc = make(gate, port=0, batch_size=4, method="greedy",
                       max_wait_ms=10.0, max_queue=1, max_body_bytes=4096,
                       path_root=str(root))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    got = []
    keep = lambda r: (r[0], r[1].get("caption", "error" in r[1]))
    try:
        for t in (8, 3, 8):
            got.append(keep(post_npy(
                port, rng.normal(size=(t, D)).astype(np.float32))))
        got.append(keep(post_path(port, "good.npy")))
        got.append(keep(post_path(port, "../outside.npy")))
        got.append(keep(post_npy(port, np.zeros((T, D + 3), np.float32))))
        got.append(keep(request(port, "POST", "/caption", b"{}",
                                "application/json")))
        got.append(keep(post_npy(port, np.zeros(2048, np.float32))))
        got.append(keep(request(port, "GET", "/nope")))
        got.append(keep(request(port, "POST", "/nope", b"")))
        gate.release.clear()
        gate.entered.clear()
        held = [None, None]
        feats = rng.normal(size=(2, T, D)).astype(np.float32)

        def send(i):
            held[i] = keep(post_npy(port, feats[i]))
        first = threading.Thread(target=send, args=(0,))
        first.start()
        assert gate.entered.wait(30)
        second = threading.Thread(target=send, args=(1,))
        second.start()
        deadline = time.time() + 30
        while svc._q.qsize() < 1 and time.time() < deadline:
            time.sleep(0.005)
        got.append(keep(post_npy(port, feats[0])))      # the queue is full
        gate.release.set()
        for th in (first, second):
            th.join(30)
            assert not th.is_alive()
        got += held
        status, stats = request(port, "GET", "/stats")
        assert status == 200
    finally:
        gate.release.set()
        server.shutdown()
        server.server_close()
        svc.close()
    return got, {k: stats[k] for k in ("served", "rejected")}, sorted(stats)


PORT_STATS = {"flushes", "rows_decoded", "rows_padded", "queue_wait_p50_ms"}


def test_http_captions_and_status_codes_identical_to_jax(tmp_path, cfg,
                                                        jax_side, cap):
    """The same POSTs and GETs to the JAX server and to the port's: the
    same captions and the same 200, 400, 403, 404, 413 and 429, and the
    same /stats counts and keys, the port's batcher counters besides."""
    jcfg, jcap = jax_side
    root = tmp_path / "safe"
    root.mkdir()
    rng = np.random.default_rng(1)
    np.save(root / "good.npy", rng.normal(size=(8, 64)).astype(np.float32))
    np.save(tmp_path / "outside.npy", np.zeros((8, 64), np.float32))
    want = http_script(jcfg, lambda c, **kw: jax_make_http_server(
        jcfg, c, **kw), jcap, root)
    got = http_script(cfg, lambda c, **kw: make_http_server(cfg, c, **kw),
                      cap, root)
    assert got[:2] == want[:2]
    # the port's /stats adds the batcher's counters to the JAX server's keys
    assert set(got[2]) == set(want[2]) | PORT_STATS
    statuses = [s for s, _ in got[0]]
    assert statuses == [200] * 4 + [403, 400, 400, 413, 404, 404, 429,
                                    200, 200]
    assert got[1] == {"served": 6, "rejected": 1}


def test_http_server_caption_and_stats(cfg, cap):
    """Concurrent POSTs coalesce into micro-batches; a wrong dim answers
    400; /healthz reports p50/p99."""
    server, svc = make_http_server(cfg, cap, port=0, batch_size=4,
                                   method="greedy", max_wait_ms=30.0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    T, D = cfg.data.num_frames, cfg.data.feature_dim
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(6, T, D)).astype(np.float32)
    results = [None] * 6

    def worker(i):
        results[i] = post_npy(port, feats[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    try:
        assert all(r is not None and r[0] == 200 for r in results), results
        vocab = cap.dataset.vocab
        for f, r in zip(feats, results):   # rows decode alone in any batch
            batch = np.zeros((4, T, D), np.float32)
            batch[0] = f
            mask = np.zeros((4, T), np.float32)
            mask[0] = 1.0
            assert r[1]["caption"] == vocab.decode_str(cap.decode_batch(
                batch, method="greedy", frame_mask=mask)[0])
        status, body = post_npy(port, np.zeros((T, D + 3), np.float32))
        assert status == 400 and "error" in body
        status, stats = request(port, "GET", "/healthz")
        assert stats["served"] == 6
        assert stats["p99_ms"] >= stats["p50_ms"] > 0
    finally:
        server.shutdown()
        svc.close()


class StubCaptioner:
    """decode_batch stand-in: a set latency, <eos> rows."""

    def __init__(self, dataset, delay_s=0.0):
        self.dataset = dataset
        self.delay_s = delay_s
        self.calls = 0

    def decode_batch(self, batch, method="greedy", beam_width=5,
                     frame_mask=None):
        self.calls += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        return np.full((batch.shape[0], 4), 2, np.int32)


def test_batching_captioner_overload_sheds_load(cfg, cap):
    svc = BatchingCaptioner(cfg, StubCaptioner(cap.dataset, delay_s=0.15),
                            batch_size=2, max_wait_ms=1.0, max_queue=2)
    feats = np.zeros((cfg.data.num_frames, cfg.data.feature_dim), np.float32)
    outcomes = []
    lock = threading.Lock()

    def worker():
        try:
            svc.submit(feats, timeout=10.0)
            r = "ok"
        except ServerOverloaded:
            r = "rejected"
        except TimeoutError:
            r = "timeout"
        with lock:
            outcomes.append(r)

    threads = [threading.Thread(target=worker) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(outcomes) == 16
    stats = svc.stats()
    assert outcomes.count("rejected") >= 1, outcomes
    assert stats["rejected"] == outcomes.count("rejected")
    assert stats["served"] == outcomes.count("ok")
    assert stats["queue_depth"] <= 2
    svc.close()


def test_batching_captioner_closed_submit_fails_fast(cfg, cap):
    svc = BatchingCaptioner(cfg, StubCaptioner(cap.dataset), batch_size=2,
                            max_wait_ms=1.0)
    svc.close()
    with pytest.raises(RuntimeError, match="shut down"):
        svc.submit(np.zeros((cfg.data.num_frames, cfg.data.feature_dim),
                            np.float32), timeout=1.0)


def test_batching_captioner_timeout_item_skipped(cfg, cap):
    """A submit that times out marks its queued item cancelled: the batcher
    skips it instead of decoding a discarded request."""
    stub = StubCaptioner(cap.dataset, delay_s=0.4)
    svc = BatchingCaptioner(cfg, stub, batch_size=1, max_wait_ms=1.0)
    feats = np.zeros((cfg.data.num_frames, cfg.data.feature_dim), np.float32)
    t1 = threading.Thread(target=lambda: svc.submit(feats, timeout=5.0))
    t1.start()
    time.sleep(0.1)
    with pytest.raises(TimeoutError):
        svc.submit(feats, timeout=0.05)
    t1.join(10)
    time.sleep(0.6)     # the batcher pops (and skips) the item
    assert svc.stats()["served"] == 1 and stub.calls == 1
    svc.close()


def test_batching_captioner_drains_queued_requests_past_the_deadline(cfg,
                                                                   cap):
    """Requests that queue while a decode outlasts max_wait_ms go out in
    ONE next batch. The reference's batcher stops at its first item once
    that item's deadline has passed, so it decodes them one by one: on the
    card, 95 decodes for 96 HTTP requests from 8 clients (ROADMAP Queue
    3)."""
    stub = StubCaptioner(cap.dataset)
    gate = Gate(stub)
    svc = BatchingCaptioner(cfg, gate, batch_size=4, max_wait_ms=20.0)
    feats = np.zeros((cfg.data.num_frames, cfg.data.feature_dim), np.float32)
    gate.release.clear()
    threads = [threading.Thread(target=svc.submit, args=(feats, 30.0))]
    threads[0].start()
    assert gate.entered.wait(30)          # the first request's decode holds
    threads += [threading.Thread(target=svc.submit, args=(feats, 30.0))
                for _ in range(3)]
    for t in threads[1:]:
        t.start()
    deadline = time.time() + 30
    while svc._q.qsize() < 3 and time.time() < deadline:
        time.sleep(0.005)
    time.sleep(0.05)                      # all three past their deadline
    gate.release.set()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert stub.calls == 2 and svc.stats()["served"] == 4
    svc.close()


def test_batching_captioner_counts_flushes_padding_and_queue_wait(cfg, cap):
    """Two flushes at batch 4: one request while the batcher waits, then
    three that queue behind its held decode. ``rows_decoded`` counts the
    batch rows decoded, ``rows_padded`` the part of them that padded a
    partial batch; the three queued requests' wait covers the hold."""
    stub = StubCaptioner(cap.dataset)
    gate = Gate(stub)
    svc = BatchingCaptioner(cfg, gate, batch_size=4, max_wait_ms=1.0)
    assert svc.stats()["queue_wait_p50_ms"] is None
    feats = np.zeros((cfg.data.num_frames, cfg.data.feature_dim), np.float32)
    gate.release.clear()
    threads = [threading.Thread(target=svc.submit, args=(feats, 30.0))]
    threads[0].start()
    assert gate.entered.wait(30)
    threads += [threading.Thread(target=svc.submit, args=(feats, 30.0))
                for _ in range(3)]
    for t in threads[1:]:
        t.start()
    deadline = time.time() + 30
    while svc._q.qsize() < 3 and time.time() < deadline:
        time.sleep(0.005)
    time.sleep(0.2)
    gate.release.set()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    stats = svc.stats()
    svc.close()
    assert stub.calls == 2 and stats["served"] == 4
    assert (stats["flushes"], stats["rows_decoded"],
            stats["rows_padded"]) == (2, 8, 4)
    # the median of four waits is a queued request's, held >= 200 ms
    assert stats["queue_wait_p50_ms"] >= 100
    assert svc._latencies_ms.maxlen == svc._queue_wait_ms.maxlen == 10_000


def test_batching_captioner_flush_is_a_span(cfg, cap):
    """While tracing is on each flush is a ``batcher.flush`` span, ``id``
    the flush's number, on the batcher's thread."""
    from vidcap_tpu_torch.utils import profiling
    profiling.clear()
    svc = BatchingCaptioner(cfg, StubCaptioner(cap.dataset), batch_size=2,
                            max_wait_ms=1.0)
    feats = np.zeros((cfg.data.num_frames, cfg.data.feature_dim), np.float32)
    try:
        with profiling.recording():
            for _ in range(3):
                svc.submit(feats, timeout=30.0)
    finally:
        svc.close()
    flushes = [s for s in profiling.spans() if s.name == "batcher.flush"]
    profiling.clear()
    assert [s.id for s in flushes] == [0, 1, 2]
    assert {s.thread for s in flushes} == {svc._thread.ident}
    assert svc.stats()["rows_padded"] == 3


def test_http_hardening(tmp_path, cfg, cap):
    """413 on oversize bodies, 403 on escapes, 200 in the root, a JSON 500
    when the decode fails (and the server still serves), 503 on a decode
    deadline (TimeoutError before OSError)."""
    T, D = cfg.data.num_frames, cfg.data.feature_dim
    root = tmp_path / "safe"
    root.mkdir()
    rng = np.random.default_rng(0)
    np.save(root / "good.npy", rng.normal(size=(T, D)).astype(np.float32))
    np.save(tmp_path / "outside.npy",
            rng.normal(size=(T, D)).astype(np.float32))
    server, svc = make_http_server(cfg, cap, port=0, batch_size=2,
                                   method="greedy", max_wait_ms=10.0,
                                   max_body_bytes=4096, path_root=str(root))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        status, body = post_path(port, "good.npy")
        assert status == 200 and isinstance(body["caption"], str)
        status, body = post_path(port, "../outside.npy")
        assert status == 403 and "escapes" in body["error"]
        assert post_npy(port, np.zeros(2048, np.float32))[0] == 413
        # beyond the drain cap the server closes without an answer
        try:
            assert post_npy(port, np.zeros((T, D + 4096), np.float32))[0] \
                == 413
        except (http.client.RemoteDisconnected, http.client.BadStatusLine,
                ConnectionError, OSError):
            pass
        orig = svc.captioner.decode_batch
        svc.captioner.decode_batch = lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("the card exploded"))
        try:
            status, body = post_npy(port, rng.normal(size=(T, D)).astype(
                np.float32))
            assert status == 500 and "the card exploded" in body["error"]
        finally:
            svc.captioner.decode_batch = orig
        assert post_npy(port, rng.normal(size=(T, D)).astype(
            np.float32))[0] == 200
        orig_submit = svc.submit
        svc.submit = lambda *a, **k: (_ for _ in ()).throw(
            TimeoutError("decode timed out"))
        try:
            status, body = post_npy(port, rng.normal(size=(T, D)).astype(
                np.float32))
            assert status == 503 and "timed out" in body["error"]
        finally:
            svc.submit = orig_submit
    finally:
        server.shutdown()
        svc.close()


def test_http_path_mode_disabled_by_default(cfg, cap):
    server, svc = make_http_server(cfg, cap, port=0, batch_size=2,
                                   method="greedy", max_wait_ms=10.0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        status, body = post_path(port, "/etc/passwd")
        assert status == 403 and "disabled" in body["error"]
    finally:
        server.shutdown()
        svc.close()


def test_http_video_path_answers_500_naming_the_item(tmp_path, cfg, cap):
    """A video in path mode that cv2 cannot decode: the loader raises the
    reference's RuntimeError and the reference's handler order answers a
    JSON 500 with it, never a caption; the stdin loop skips the same
    path."""
    (tmp_path / "clip.mp4").write_bytes(b"\0")
    server, svc = make_http_server(cfg, cap, port=0, batch_size=2,
                                   method="greedy", max_wait_ms=10.0,
                                   path_root=str(tmp_path))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        status, body = post_path(port, "clip.mp4")
        assert status == 500 and "caption" not in body
        assert body["error"].startswith("RuntimeError: ")
        assert ("no frames decoded" in body["error"]
                or "requires OpenCV" in body["error"])
        assert svc.stats()["served"] == 0
    finally:
        server.shutdown()
        svc.close()
    assert CaptionServer(cfg, cap, batch_size=2).run(
        inp=io.StringIO(f"{tmp_path / 'clip.mp4'}\n"), out=io.StringIO(),
        warmup=False) == 0


def test_batching_captioner_rejects_unbounded_queue(cfg):
    with pytest.raises(ValueError, match="max_queue"):
        BatchingCaptioner(cfg, None, batch_size=2, max_queue=0)


def test_cli_serve_http_through_a_subprocess(tmp_path, cfg, jax_side):
    """``serve --http 0 --device cpu`` as chip_smoke.py drives it on the
    card: the port from stderr, one caption equal to the JAX package's,
    /stats, then SIGINT ends it with the stats and the decodes line."""
    jcfg, jcap = jax_side
    weights = str(tmp_path / "w.npz")
    save_weights(port_captioner(cfg, jcap).model, weights)
    feats = np.random.default_rng(3).normal(size=(5, 64)).astype(np.float32)
    batch = np.zeros((4, 8, 64), np.float32)
    batch[0, :5] = feats
    mask = np.zeros((4, 8), np.float32)
    mask[0, :5] = 1.0
    want = jcap.dataset.vocab.decode_str(np.asarray(jcap.decode_batch(
        batch, method="greedy", frame_mask=mask))[0])
    proc = subprocess.Popen(
        [sys.executable, "-c", SERVE_CHILD, "serve", "--preset",
         "synthetic_tiny", "--weights", weights, "--method", "greedy",
         "--batch", "4", "--http", "0", "--device", "cpu", "--set", F32[0]],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": PYTHONPATH},
        stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        while "serving HTTP on" not in line:
            line = proc.stderr.readline()
            assert line, "the server exited before it served"
        port = int(line.split("serving HTTP on ")[1].split()[0].split(":")[1])
        assert post_npy(port, feats) == (200, {"caption": want})
        status, stats = request(port, "GET", "/stats")
        assert status == 200 and stats["served"] == 1
        proc.send_signal(signal.SIGINT)
        _, err = proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == 0, err
    assert "'served': 1" in err
    assert "[vidcap] greedy: 2 decodes" in err
