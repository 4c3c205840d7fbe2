"""Tracing and profiling hooks, the counterparts of
``vidcap_tpu/utils/profiling.py``'s four names.

``trace`` records a ``torch.profiler`` trace (CPU, and CUDA where a card is
visible) of the enclosed region, which TensorBoard's profiler plugin and
Perfetto read; ``annotate`` names a region in such traces (and in Nsight's,
through an NVTX range on a CUDA device); ``start_server`` stands in for
``jax.profiler.start_server``, which PyTorch has no counterpart of: a
local HTTP endpoint that records the next N ms of the process on request;
``enable_nan_debugging`` is ``jax_debug_nans``: the first operation whose
floating-point output holds a NaN raises.
"""
from __future__ import annotations

import contextlib
import http.server
import json
import os
import tempfile
import threading
import time
import urllib.parse
from typing import Iterator, Optional

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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range of the enclosed region: a ``record_function`` in
    ``torch.profiler`` traces, and an NVTX range where a card is visible."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


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
