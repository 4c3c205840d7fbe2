"""Serving: stdin paths or HTTP requests → micro-batched captions, as
``vidcap_tpu/serving.py``.

``CaptionServer`` reads feature ``.npy`` paths line by line from a stream,
micro-batches them to the flush batch size and writes ``path\\tcaption``
lines: one ``Captioner.decode_batch`` per flushed batch, zero-padded rows
(frame mask 0) filling a partial batch, so the card always sees the same
batch shape.

  * ``max_wait_ms`` bounds head-of-line blocking: a partial batch flushes
    when its OLDEST request has waited that long. A reader thread stamps
    each line's arrival and feeds a queue; the main loop batches with a
    deadline.
  * per-request latency (arrival → flush complete) is kept over a window;
    p50/p99 print at shutdown and come from ``latency_percentiles()``.
  * ``warmup()`` pays before serving what the first decode would pay
    (``Captioner.warmup``): on the card the nvcc build of the kernels the
    method launches, the weights' casts to the kernels' layouts, K3's W_out
    mode probe, and one decode of the flush shape.
  * ``pipeline_depth > 0`` decodes on a worker thread, so batch N+1's input
    loading overlaps batch N's decode; one worker draining a bounded queue
    keeps the output in order.

``make_http_server`` puts the same batching core behind the stdlib
``ThreadingHTTPServer``: POST /caption with raw ``.npy`` bytes (or JSON
``{"path": ...}`` under a ``path_root``) blocks until its micro-batch
decodes; GET /healthz and /stats report the served count and p50/p99.

One thread touches the card. In the stdin loop with ``pipeline_depth > 0``
only the decode worker decodes (else the main thread); in the HTTP server
only the batcher thread calls ``decode_batch``, and the handler threads
parse and load features and nothing else. ``decode_batch`` runs under
``torch.inference_mode``, which is per thread, and the kernel wrappers
launch on ``torch.cuda.current_stream``, also per thread. ctypes releases
the GIL during a kernel launch and so does a device sync, so the loading
thread's ``np.load`` runs while the decode waits on the card.

A raw video path (``.mp4``, ``.avi``, ``.mkv``, ``.webm``, ``.mov``) is
decoded on the host through cv2, then preprocessed and encoded on the
captioner's device by a full-width IRv2 backbone built once, from
``load_backbone_params`` (ImageNet weights where the file exists, else a
seeded init with a warning), as the reference's loader does
(``data/frames.py::make_video_encoder``). Without cv2, or for a file cv2
cannot decode, the loader raises the reference's ``RuntimeError``: the
stdin loop skips the line with its message, as any unreadable path; the
HTTP path mode answers a JSON 500 and no caption. The encode runs on the
thread that loads the input.
"""
from __future__ import annotations

import collections
import os
import queue
import sys
import threading
import time
from typing import IO, List, Optional

import numpy as np

from vidcap_tpu_torch.config import Config
from vidcap_tpu_torch.data.frames import VIDEO_EXTS as _VIDEO_EXTS
from vidcap_tpu_torch.utils import profiling

_EOF = object()

# long-lived servers: percentiles over the most recent window of latencies
_LATENCY_WINDOW = 65_536
# the HTTP batcher's /stats percentiles: over its last 10,000 requests
_STATS_WINDOW = 10_000


class ServerOverloaded(RuntimeError):
    """Raised by ``BatchingCaptioner.submit`` when the bounded request queue
    is full; the HTTP front end answers 429, so overload sheds load instead
    of growing the queue and every caller's latency without bound."""


class _FeatureLoader:
    """path → f32[T', D] features from a ``.npy`` file of [T', D] or a video
    file (cv2, then the IRv2 backbone on ``device``, built on first use and
    kept); shared by ``caption --inputs``, the stdin loop and the HTTP path
    mode, so all three take the same inputs. ``device`` None means the
    card."""

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.device = device
        self._encode_video = None
        self._lock = threading.Lock()

    def __call__(self, path: str) -> np.ndarray:
        if path.lower().endswith(_VIDEO_EXTS):
            from vidcap_tpu_torch.data.frames import (decode_video_frames,
                                                      make_video_encoder)
            frames = decode_video_frames(path, self.cfg.data.num_frames)
            with self._lock:   # HTTP handler threads share one backbone
                if self._encode_video is None:
                    self._encode_video = make_video_encoder(self.cfg,
                                                            self.device)
            return self._encode_video(frames)
        feats = np.load(path)
        if feats.ndim != 2:
            raise ValueError(f"{path}: expected [T, D] features, "
                             f"got {feats.shape}")
        D = self.cfg.data.feature_dim
        if feats.shape[1] != D:
            raise ValueError(f"{path}: feature dim {feats.shape[1]} != "
                             f"configured {D}")
        return feats.astype(np.float32)


def _pad_batch(cfg: Config, feats: List[np.ndarray], batch_size: int):
    """Zero-pad a list of [T', D] feature arrays into one fixed-shape
    (batch f32[B, T, D], frame_mask f32[B, T]) pair. Inputs longer than
    ``cfg.data.num_frames`` are cut to it. The mask marks the real frames,
    so attention and the pooled decoder init ignore the padding; the filler
    rows past ``len(feats)`` keep an all-zero mask."""
    T, D = cfg.data.num_frames, cfg.data.feature_dim
    batch = np.zeros((batch_size, T, D), np.float32)
    mask = np.zeros((batch_size, T), np.float32)
    for i, f in enumerate(feats):
        t = min(f.shape[0], T)
        batch[i, :t] = f[:t]
        mask[i, :t] = 1.0
    return batch, mask


class CaptionServer:
    def __init__(self, cfg: Config, captioner, batch_size: int = 32,
                 method: str = "greedy", beam_width: int = 5,
                 max_wait_ms: Optional[float] = None,
                 pipeline_depth: int = 1):
        self.cfg = cfg
        self.captioner = captioner
        self.batch_size = batch_size
        self.method = method
        self.beam_width = beam_width
        self.max_wait_ms = max_wait_ms
        self.pipeline_depth = pipeline_depth
        self._loader = _FeatureLoader(cfg, getattr(captioner, "device",
                                                    None))
        self._latencies_ms = collections.deque(maxlen=_LATENCY_WINDOW)

    # ------------------------------------------------------------ input loading

    def _load_features(self, path: str) -> np.ndarray:
        return self._loader(path)

    # ------------------------------------------------------------ serving loop

    def _flush(self, paths: List[str], feats: List[np.ndarray],
               arrivals: List[float], out: IO) -> None:
        if not paths:
            return
        n = len(paths)
        batch, mask = _pad_batch(self.cfg, feats, self.batch_size)
        toks = self.captioner.decode_batch(
            batch, method=self.method, beam_width=self.beam_width,
            frame_mask=mask)
        vocab = self.captioner.dataset.vocab
        for i in range(n):
            out.write(f"{paths[i]}\t{vocab.decode_str(toks[i])}\n")
        out.flush()
        done = time.perf_counter()
        self._latencies_ms.extend((done - a) * 1e3 for a in arrivals)

    def latency_percentiles(self):
        """(p50_ms, p99_ms) over the requests served so far (None, None when
        nothing has been served)."""
        if not self._latencies_ms:
            return None, None
        arr = np.asarray(self._latencies_ms)
        return float(np.percentile(arr, 50)), float(np.percentile(arr, 99))

    def _report(self, served: int) -> None:
        p50, p99 = self.latency_percentiles()
        lat = (f" latency p50={p50:.0f}ms p99={p99:.0f}ms"
               if p50 is not None else "")
        print(f"[vidcap] served {served} captions{lat}", file=sys.stderr)

    # one reader thread feeds the queue so the batcher can wait WITH a deadline
    def _reader(self, inp: IO, q: "queue.Queue",
                err: List[BaseException]) -> None:
        try:
            for line in inp:
                # arrival is stamped HERE, not when the main loop dequeues:
                # while a flush blocks, waiting lines still accrue deadline
                # and their reported latency covers the full queue time
                q.put((time.perf_counter(), line))
        except BaseException as e:
            # record and STILL signal EOF: a dead reader that never enqueues
            # _EOF would hang run() forever at q.get()
            err.append(e)
        finally:
            q.put(_EOF)

    def warmup(self) -> None:
        self.captioner.warmup(self.method, self.batch_size, self.beam_width)

    def run(self, inp: Optional[IO] = None, out: Optional[IO] = None,
            warmup: bool = True) -> int:
        inp = inp or sys.stdin
        out = out or sys.stdout
        if warmup:
            self.warmup()
        paths: List[str] = []
        feats: List[np.ndarray] = []
        arrivals: List[float] = []
        served = 0
        max_wait = (self.max_wait_ms / 1e3
                    if self.max_wait_ms is not None else None)

        q: "queue.Queue" = queue.Queue()
        read_err: List[BaseException] = []
        t = threading.Thread(target=self._reader, args=(inp, q, read_err),
                             daemon=True)
        t.start()

        # decode worker: batch N+1's input loading overlaps batch N's decode;
        # a single worker draining a bounded FIFO preserves output order
        decode_q: Optional["queue.Queue"] = None
        worker: Optional[threading.Thread] = None
        worker_err: List[BaseException] = []
        if self.pipeline_depth > 0:
            decode_q = queue.Queue(maxsize=self.pipeline_depth)

            def drain():
                while True:
                    item = decode_q.get()
                    if item is _EOF:
                        return
                    if worker_err:
                        continue    # after a failure keep DRAINING (discard):
                        # exiting would leave the bounded queue full and the
                        # main thread blocked forever on put()
                    try:
                        self._flush(*item, out)
                    except BaseException as e:   # surface in the main thread
                        worker_err.append(e)

            worker = threading.Thread(target=drain, daemon=True)
            worker.start()

        def flush():
            nonlocal served, paths, feats, arrivals
            if paths and decode_q is not None:
                if worker_err:
                    raise worker_err[0]
                decode_q.put((paths, feats, arrivals))
            else:
                self._flush(paths, feats, arrivals, out)
            served += len(paths)
            paths, feats, arrivals = [], [], []

        while True:
            if max_wait is not None and arrivals:
                # flush when the OLDEST queued request hits the deadline
                timeout = max(0.0, arrivals[0] + max_wait - time.perf_counter())
            else:
                timeout = None          # block: nothing pending, or no bound
            try:
                msg = q.get(timeout=timeout)
            except queue.Empty:
                flush()                 # deadline hit with a partial batch
                continue
            if msg is _EOF:
                break
            t_arr, line = msg               # reader-stamped arrival time
            path = line.strip()
            if not path:
                continue
            try:
                feats.append(self._load_features(path))
                paths.append(path)
                arrivals.append(t_arr)
            except Exception as e:
                print(f"[vidcap] skip {path}: {e}", file=sys.stderr)
                continue
            if len(paths) == self.batch_size:
                flush()
        flush()
        if worker is not None:
            decode_q.put(_EOF)
            worker.join()
            if worker_err:
                raise worker_err[0]
        if read_err:
            raise read_err[0]
        self._report(served)
        return served


# --------------------------------------------------------------- HTTP serving

class BatchingCaptioner:
    """Thread-safe micro-batching front end over ``Captioner.decode_batch``:
    concurrent ``submit(feats)`` calls coalesce into batches of up to
    ``batch_size`` (what is queued, and what arrives within ``max_wait_ms``
    of the oldest request), decode on ONE batcher thread, and each caller
    blocks until its caption is ready. The card only ever sees full
    fixed-shape batches.

    :meth:`stats` (``/stats``) reports, besides the served and refused
    counts, ``flushes`` (batches decoded), ``rows_decoded`` (the batch
    rows the card decoded, ``batch_size`` a flush whose decode returned)
    and ``rows_padded`` (the part of them that filled a partial batch),
    and ``queue_wait_p50_ms`` (a request's arrival to its flush's start).
    Its percentiles cover the last 10,000 requests. Each flush is a
    ``batcher.flush`` span (``utils/profiling.py``; ``id`` the flush's
    number) while tracing is on."""

    def __init__(self, cfg: Config, captioner, batch_size: int = 32,
                 method: str = "greedy", beam_width: int = 5,
                 max_wait_ms: float = 20.0, max_queue: Optional[int] = None):
        self.cfg = cfg
        self.captioner = captioner
        self.batch_size = batch_size
        self.method = method
        self.beam_width = beam_width
        self.max_wait = max_wait_ms / 1e3
        # BOUNDED request queue: overload raises ServerOverloaded (HTTP 429)
        # instead of growing the queue and the latency without bound.
        # Default headroom: 4 batches beyond the one in flight. max_queue <= 0
        # would mean queue.Queue's UNBOUNDED sentinel, the failure the bound
        # prevents, so it is rejected, not passed on.
        if max_queue is not None and max_queue <= 0:
            raise ValueError(f"max_queue must be >= 1, got {max_queue} "
                             "(0 would disable overload protection)")
        self.max_queue = max_queue if max_queue is not None else 4 * batch_size
        self._q: "queue.Queue" = queue.Queue(maxsize=self.max_queue)
        self._latencies_ms = collections.deque(maxlen=_STATS_WINDOW)
        self._queue_wait_ms = collections.deque(maxlen=_STATS_WINDOW)
        self._served = 0
        self._rejected = 0
        self._flushes = 0
        self._rows_decoded = 0
        self._rows_padded = 0
        self._closed = False
        self._lock = threading.Lock()
        self._loader = _FeatureLoader(cfg, getattr(captioner, "device",
                                                    None))
        self._thread = threading.Thread(target=self._batcher, daemon=True)
        self._thread.start()

    def warmup(self) -> None:
        self.captioner.warmup(self.method, self.batch_size, self.beam_width)

    def load_features(self, path: str) -> np.ndarray:
        """The stdin loop's loader, for the HTTP path mode."""
        return self._loader(path)

    def submit(self, feats: np.ndarray, timeout: Optional[float] = None
               ) -> str:
        """feats: f32[T', D] (T' ≤ configured frames). Blocks until decoded.
        Raises ServerOverloaded when the bounded queue is full, TimeoutError
        on the deadline (the queued item is marked cancelled, so the batcher
        skips it instead of decoding a discarded request)."""
        D = self.cfg.data.feature_dim
        if feats.ndim != 2 or feats.shape[1] != D:
            raise ValueError(f"expected [T, {D}] features, got {feats.shape}")
        item = {"event": threading.Event(), "feats": feats,
                "t": time.perf_counter(), "caption": None, "error": None,
                "cancelled": False}
        # closed-check + enqueue under ONE lock, mirroring close()'s
        # set-flag + enqueue-EOF: an item can only land in the queue BEFORE
        # the _EOF sentinel, so the batcher's post-EOF drain always reaches
        # it; else a submit racing close() could enqueue after the batcher
        # exited and block for its full timeout
        with self._lock:
            if self._closed:
                raise RuntimeError("server is shut down")
            try:
                self._q.put_nowait(item)
            except queue.Full:
                self._rejected += 1
                raise ServerOverloaded(
                    f"request queue full ({self.max_queue} pending)") from None
        if not item["event"].wait(timeout):
            item["cancelled"] = True    # batcher will skip it (best effort)
            raise TimeoutError("decode timed out")
        if item["error"] is not None:
            raise item["error"]
        return item["caption"]

    def _batcher(self) -> None:
        vocab = self.captioner.dataset.vocab
        while True:
            first = self._q.get()
            if first is _EOF:
                # drain anything that raced past the closed flag so no caller
                # blocks for its full timeout on a dead batcher
                while True:
                    try:
                        it = self._q.get_nowait()
                    except queue.Empty:
                        return
                    if it is not _EOF:
                        it["error"] = RuntimeError("server is shut down")
                        it["event"].set()
            items = [first] if not first["cancelled"] else []
            deadline = first["t"] + self.max_wait
            while len(items) < self.batch_size:
                # past the deadline, still take what is already queued: when
                # a decode outlasts max_wait, the next oldest request is past
                # its deadline before the batcher sees it, and stopping there
                # would decode every batch with one request (ROADMAP Queue 3)
                left = deadline - time.perf_counter()
                try:
                    nxt = (self._q.get(timeout=left) if left > 0
                           else self._q.get_nowait())
                except queue.Empty:
                    break
                if nxt is _EOF:
                    self._q.put(_EOF)   # re-post for the outer loop
                    break
                if not nxt["cancelled"]:
                    items.append(nxt)
            if not items:
                continue
            start = time.perf_counter()
            with self._lock:
                flush = self._flushes
                self._flushes += 1
                self._queue_wait_ms.extend((start - it["t"]) * 1e3
                                           for it in items)
            with profiling.annotate("batcher.flush", flush):
                self._flush(items, vocab)

    def _flush(self, items: list, vocab) -> None:
        """Decode one batch of requests and answer each caller."""
        batch, mask = _pad_batch(self.cfg, [it["feats"] for it in items],
                                 self.batch_size)
        try:
            toks = self.captioner.decode_batch(
                batch, method=self.method, beam_width=self.beam_width,
                frame_mask=mask)
            done = time.perf_counter()
            with self._lock:
                for i, it in enumerate(items):
                    it["caption"] = vocab.decode_str(toks[i])
                    self._latencies_ms.append((done - it["t"]) * 1e3)
                self._served += len(items)
                self._rows_decoded += self.batch_size
                self._rows_padded += self.batch_size - len(items)
        except BaseException as e:   # deliver the failure to every caller
            for it in items:
                it["error"] = e
        finally:
            for it in items:
                it["event"].set()

    def stats(self):
        """The counters above; ``p50_ms``/``p99_ms`` (arrival to caption)
        and ``queue_wait_p50_ms`` over the last 10,000 requests, None
        before the first."""
        def pct(window, q):
            return (round(float(np.percentile(np.asarray(window), q)), 1)
                    if window else None)

        with self._lock:
            return {
                "served": self._served,
                "rejected": self._rejected,
                "queue_depth": self._q.qsize(),
                "p50_ms": pct(self._latencies_ms, 50),
                "p99_ms": pct(self._latencies_ms, 99),
                "flushes": self._flushes,
                "rows_decoded": self._rows_decoded,
                "rows_padded": self._rows_padded,
                "queue_wait_p50_ms": pct(self._queue_wait_ms, 50),
            }

    def close(self) -> None:
        with self._lock:                # see submit(): flag + EOF atomically
            self._closed = True         # fail-fast for racing submits
            self._q.put(_EOF)
        self._thread.join(timeout=5)


def make_http_server(cfg: Config, captioner, port: int = 0,
                     batch_size: int = 32, method: str = "greedy",
                     beam_width: int = 5, max_wait_ms: float = 20.0,
                     max_queue: Optional[int] = None,
                     max_body_bytes: int = 64 << 20,
                     path_root: Optional[str] = None):
    """HTTP captioning endpoint on the stdlib ThreadingHTTPServer. Returns
    (server, service) after the service's warmup; call
    ``server.serve_forever()`` (the CLI does) and read
    ``server.server_address[1]`` for the bound port (port=0: the OS picks).

      POST /caption   body = raw .npy bytes (np.save) of f32[T, D] features,
                      or JSON {"path": "file.npy"} (path mode) →
                      {"caption": "..."}
      GET  /healthz | /stats → {"served": n, "rejected": n, "p50_ms": ...}

    Hardening:
      * the request queue is bounded: overload answers 429; a decode
        deadline answers 503;
      * bodies beyond ``max_body_bytes`` answer 413 without being buffered;
      * path mode is DISABLED unless ``path_root`` is set; paths resolve
        inside that root (realpath + prefix check, so no probing of other
        server-readable files) and accept the stdin loop's inputs;
      * an unexpected decode failure answers a JSON 500 instead of a
        dropped connection.
    """
    import io as _io
    import json as _json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    svc = BatchingCaptioner(cfg, captioner, batch_size=batch_size,
                            method=method, beam_width=beam_width,
                            max_wait_ms=max_wait_ms, max_queue=max_queue)
    svc.warmup()
    real_root = (os.path.realpath(path_root) if path_root is not None
                 else None)

    def _resolve_path(rel: str) -> str:
        if real_root is None:
            raise PermissionError(
                "path mode is disabled (start the server with a path root "
                "to enable it)")
        full = os.path.realpath(os.path.join(real_root, rel))
        if full != real_root and not full.startswith(real_root + os.sep):
            raise PermissionError(f"path {rel!r} escapes the serving root")
        return full

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj) -> None:
            body = _json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/healthz", "/stats"):
                self._json(200, svc.stats())
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/caption":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > max_body_bytes:
                    # drain (bounded, chunked, never buffered) so the client
                    # receives a clean 413 instead of a broken pipe mid-send;
                    # beyond the drain cap skip the response (writing into a
                    # still-uploading socket is the broken pipe the drain
                    # avoids) and just close the connection
                    if n <= 4 * max_body_bytes:
                        remaining = n
                        while remaining > 0:
                            chunk = self.rfile.read(min(remaining, 1 << 20))
                            if not chunk:
                                break
                            remaining -= len(chunk)
                        self._json(413,
                                   {"error": f"body of {n} bytes exceeds "
                                             f"the {max_body_bytes} limit"})
                    self.close_connection = True
                    return
                body = self.rfile.read(n)
                if "json" in (self.headers.get("Content-Type") or ""):
                    feats = svc.load_features(
                        _resolve_path(_json.loads(body)["path"]))
                else:
                    feats = np.load(_io.BytesIO(body))
                caption = svc.submit(np.asarray(feats, np.float32),
                                     timeout=120.0)
                self._json(200, {"caption": caption})
            except PermissionError as e:
                self._json(403, {"error": str(e)})
            except ServerOverloaded as e:
                self._json(429, {"error": str(e)})
            except TimeoutError as e:
                # before OSError: builtin TimeoutError IS an OSError, and a
                # decode deadline is a server-side 503, not a client 400
                self._json(503, {"error": str(e)})
            except (ValueError, KeyError, OSError) as e:
                self._json(400, {"error": str(e)})
            except Exception as e:   # noqa: BLE001 — a decode failure (or a
                # video cv2 cannot read, RuntimeError) must reach the client
                # as a 5xx, not a dropped connection and a dead handler thread
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):   # quiet: stderr stays for stats
            pass

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    server.vidcap_service = svc          # tests/CLI reach the service here
    return server, svc
