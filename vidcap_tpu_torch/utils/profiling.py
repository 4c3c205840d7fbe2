"""Tracing and profiling hooks, the counterparts of
``vidcap_tpu/utils/profiling.py``'s four names, and the port's own spans
and phase marks.

``trace`` records a ``torch.profiler`` trace (CPU, and CUDA where a card is
visible) of the enclosed region, which TensorBoard's profiler plugin and
Perfetto read; ``annotate`` names a region in such traces (and in Nsight's,
through an NVTX range on a CUDA device); ``start_server`` stands in for
``jax.profiler.start_server``, which PyTorch has no counterpart of: a
local HTTP endpoint that records the next N ms of the process on request;
``enable_nan_debugging`` is ``jax_debug_nans``: the first operation whose
floating-point output holds a NaN raises.

Spans. ``annotate(name, id)`` also records a :class:`Span` in a bounded
in-memory store (:data:`MAX_SPANS`, the oldest dropped first), read with
:func:`spans` and emptied with :func:`clear`. It records only while
tracing is on: while a ``torch.profiler`` session records in the process
(``trace``, the ``/trace`` endpoint, any caller's profiler; PyTorch's
``_is_profiler_enabled`` flag), or inside ``recording()``. Otherwise it
returns a shared no-op context, at the cost of one check of those two
flags. Times are ``time.perf_counter`` seconds; ``parent`` is the name of
the innermost span open on the same thread; ``id`` ties the spans of one
call together (a decode's number, a training step). The program's spans:
``captioner.decode`` / ``.upload`` / ``.download`` (``inference.py``),
``beam.exit_check`` around each host read of a decode loop's finish test
(``models/decoding.py``; ``id`` the step), ``dispatch.inputs`` /
``dispatch.replay`` (``train/steps.py``), ``batcher.flush``
(``serving.py``; ``id`` the flush).

Phase marks. A CUDA graph replays kernels, never Python, so a training
step marks its phases on the device: :func:`phase` launches
``vidcap_phase_<name>`` (``csrc/phase_marks.cu``, an empty one-thread
kernel) on the current stream, where a capture records it and every replay
runs it, whether tracing is on or off. A device trace then splits a step's
time at the marks: rollout, reward, loss (twice: after the rollouts and
after the reward), backward, update, end. On the CPU a mark does nothing.
"""
from __future__ import annotations

import collections
import contextlib
import http.server
import json
import os
import tempfile
import threading
import time
import urllib.parse
from typing import Iterator, List, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None) -> Iterator[None]:
    """Record a trace of the enclosed region into ``trace_dir`` (else
    ``$VIDCAP_TRACE_DIR``) as ``<host>_<pid>.<ns>.pt.trace.json``; with
    neither, record nothing."""
    trace_dir = trace_dir or os.environ.get("VIDCAP_TRACE_DIR")
    if not trace_dir:
        yield
        return
    with torch.profiler.profile(
            activities=_activities(),
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                trace_dir)):
        yield


class Span(NamedTuple):
    """One recorded region: ``t0``/``t1`` in ``time.perf_counter`` seconds,
    ``parent`` the name of the span open around it on ``thread``, or
    None."""

    name: str
    id: Optional[int]
    parent: Optional[str]
    thread: int
    t0: float
    t1: float


MAX_SPANS = 1_000_000
_store: "collections.deque[Span]" = collections.deque(maxlen=MAX_SPANS)
_open = threading.local()        # .stack: this thread's open spans
_recording = 0                   # open recording() contexts
_recording_lock = threading.Lock()
_profiler = torch.autograd.profiler   # ._is_profiler_enabled: a session runs
_nvtx: Optional[bool] = None     # a card is visible (asked once)


class _Off:
    """What :func:`annotate` returns while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """A span being recorded: a ``record_function``, an NVTX range on a
    card, then a :class:`Span` in the store when it closes."""

    __slots__ = ("name", "id", "parent", "t0", "rf", "stack")

    def __init__(self, name: str, id: Optional[int]):
        self.name, self.id = name, id

    def __enter__(self):
        global _nvtx
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.stack = stack
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if _nvtx is None:
            _nvtx = torch.cuda.is_available()
        if _nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if _nvtx:
            torch.cuda.nvtx.range_pop()
        self.rf.__exit__(*exc)
        self.stack.pop()
        _store.append(Span(self.name, self.id, self.parent,
                           threading.get_ident(), self.t0, t1))
        return False


def tracing() -> bool:
    """Whether spans, counters and the decoder's marks record now."""
    return bool(_profiler._is_profiler_enabled or _recording)


def annotate(name: str, id: Optional[int] = None):
    """A named region, as a context manager: while tracing is on (a
    ``torch.profiler`` session records, or inside :func:`recording`) a
    ``record_function`` in ``torch.profiler`` traces, an NVTX range where a
    card is visible, and a :class:`Span` in the store; otherwise nothing."""
    if _profiler._is_profiler_enabled or _recording:
        return _On(name, id)
    return _OFF


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside the block without a profiler."""
    global _recording
    with _recording_lock:
        _recording += 1
    try:
        yield
    finally:
        with _recording_lock:
            _recording -= 1


def spans() -> List[Span]:
    """A copy of the store, oldest first."""
    return list(_store)


def clear() -> None:
    """Empty the store and the counters."""
    _store.clear()
    _counts.clear()


_counts: "collections.deque[tuple]" = collections.deque(maxlen=MAX_SPANS)


def count(name: str, id: Optional[int], value: torch.Tensor) -> None:
    """Keep a copy of ``value`` under ``name`` while tracing is on."""
    if tracing():
        _counts.append((name, id, value.detach().clone()))


def counters(name: str) -> List[tuple]:
    """(id, numpy array) of each value kept under ``name``, oldest
    first."""
    return [(i, v.cpu().numpy()) for n, i, v in list(_counts) if n == name]


PHASES = ("rollout", "reward", "loss", "backward", "update", "end")
LM_MARKS = ("lm_attn", "lm_mlp", "lm_moe", "lm_head")
_PHASE_INDEX = {name: i for i, name in enumerate(PHASES + LM_MARKS)}


def phase(name: str, like: torch.Tensor) -> None:
    """Launch the phase mark ``vidcap_phase_<name>`` (one of
    :data:`PHASES` or :data:`LM_MARKS`) on the current stream of
    ``like``'s device; on the CPU, nothing. Its library is built like the kernels' (``ops/_build.py``,
    ``MARKS``); the marks are not launch-counted."""
    if not like.is_cuda:
        return
    from vidcap_tpu_torch.ops import _build
    fn = _build.entry(_build.MARKS, 0, 1)
    stream = torch.cuda.current_stream(like.device).cuda_stream
    _build.check(fn(_PHASE_INDEX[name], stream), f"phase mark {name}")


MAX_TRACE_MS = 60_000


class _TraceHandler(http.server.BaseHTTPRequestHandler):
    """``GET /trace?ms=N``: record the next N ms (default 1,000, at most
    :data:`MAX_TRACE_MS`) of the process; answers ``{"trace": path}``, or
    409 while another recording runs. The trace holds the card's kernels
    and copies of every thread (CUPTI traces the process) but the CPU
    operations of the recording thread only: PyTorch's CPU profiler
    follows the thread that starts it."""

    def do_GET(self):
        url = urllib.parse.urlparse(self.path)
        if url.path != "/trace":
            return self._reply(404, {"error": "GET /trace?ms=N"})
        try:
            ms = int(urllib.parse.parse_qs(url.query).get("ms", ["1000"])[0])
        except ValueError:
            return self._reply(400, {"error": "ms must be an integer"})
        if not 0 < ms <= MAX_TRACE_MS:
            return self._reply(400, {"error": f"ms must be in 1..{MAX_TRACE_MS}"})
        server = self.server
        if not server.busy.acquire(blocking=False):
            return self._reply(409, {"error": "a trace is being recorded"})
        try:
            with torch.profiler.profile(activities=_activities()) as prof:
                time.sleep(ms / 1000)
            path = os.path.join(server.trace_dir, f"trace_{os.getpid()}_"
                                f"{time.time_ns() // 1_000_000}.json")
            prof.export_chrome_trace(path)
        finally:
            server.busy.release()
        self._reply(200, {"trace": path})

    def _reply(self, code: int, body: dict) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args) -> None:   # no access log on stderr
        pass


def start_server(port: int = 9999, trace_dir: Optional[str] = None
                 ) -> http.server.ThreadingHTTPServer:
    """Serve ``GET /trace?ms=N`` on 127.0.0.1:``port`` (0: any free port,
    read back from ``server.server_address``) from a daemon thread; traces
    go to ``trace_dir``, else ``$VIDCAP_TRACE_DIR``, else a new temporary
    directory. Returns the server (``shutdown()`` stops it)."""
    server = http.server.ThreadingHTTPServer(("127.0.0.1", port),
                                             _TraceHandler)
    server.daemon_threads = True
    server.trace_dir = (trace_dir or os.environ.get("VIDCAP_TRACE_DIR")
                        or tempfile.mkdtemp(prefix="vidcap_trace_"))
    os.makedirs(server.trace_dir, exist_ok=True)
    server.busy = threading.Lock()
    threading.Thread(target=server.serve_forever, name="vidcap-profiler",
                     daemon=True).start()
    return server


class NanCheck(TorchDispatchMode):
    """Raises ``FloatingPointError`` after the first operation whose
    floating-point output holds a NaN, naming it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and (
                    t.is_floating_point() or t.is_complex()) \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out

    def disable(self) -> None:
        """Turn the check off again."""
        self.__exit__(None, None, None)


def enable_nan_debugging() -> NanCheck:
    """Check every operation's output for NaN from now on, forward and
    backward (the autograd engine runs the backward under the caller's
    modes), in the calling thread; returns the check, whose ``disable()``
    ends it. Each check reads the output on the host, so a step under it
    is slower, and CUDA-graph capture cannot run under it (a capture
    forbids that read)."""
    check = NanCheck()
    check.__enter__()
    return check
