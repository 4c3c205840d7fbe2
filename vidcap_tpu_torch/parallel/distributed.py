"""Joining a process group, as ``vidcap_tpu/parallel/distributed.py``'s
``initialize_multihost``: NCCL between cards, gloo on the CPU.

``initialize_multihost`` joins the group a launcher describes in the
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as
``torchrun`` sets them, and ``LOCAL_RANK`` for the card); without such an
environment it returns False, so every entry point may call it. The CLI's
``--sharded`` is its own launcher (:func:`launch`): one command starts one
worker process a card, each the same command with the environment set.
:func:`spawn` runs a function in a group of worker processes (the tests,
``dryrun_multigpu``); :func:`init_group` joins a group of this process
alone or of known ranks (a world of one on one card).
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_group(device, world: int = 1, rank: int = 0,
               addr: str = "localhost", port: Optional[int] = None) -> None:
    """Join the group of ``world`` processes at ``addr:port`` as ``rank``:
    NCCL when ``device`` is a card (which becomes this process's current
    card), gloo on the CPU. A failed initialization raises."""
    device = torch.device(device)
    port = port if port is not None else free_port()
    kw = {}
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        backend = "nccl"
        kw["device_id"] = device
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=rank, **kw)


def initialize_multihost(device=None) -> bool:
    """Join the launcher's group when ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` are set (``device``: "cpu" for
    gloo; else the card ``LOCAL_RANK`` names, over NCCL); True once joined
    (or already in one), False without a launcher's environment."""
    if dist.is_initialized():
        return True
    if not all(os.environ.get(k) for k in _ENV):
        return False
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    init_group(dev, world=int(os.environ["WORLD_SIZE"]),
               rank=int(os.environ["RANK"]),
               addr=os.environ["MASTER_ADDR"],
               port=int(os.environ["MASTER_PORT"]))
    return True


def shutdown() -> None:
    """Leave the group, once every rank has come here."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _worker(fn, rank: int, world: int, port: int, device: str, args,
            results) -> None:
    try:
        dev = torch.device(device if device == "cpu" else f"cuda:{rank}")
        init_group(dev, world=world, rank=rank, port=port)
        try:
            results.put((rank, True, fn(rank, world, *args)))
        finally:
            shutdown()
    except Exception:   # reported to the caller, which ends the group
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, args: Sequence = (),
          device: str = "cpu", timeout: float = 300.0) -> List:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes joined
    in one group (gloo on the CPU, NCCL with ``device="cuda"``, rank r on
    card r); returns the values by rank. ``fn`` must be importable by name
    (a module-level function), and its values picklable. Raises with the
    failing rank's traceback, or after ``timeout`` seconds; every worker is
    ended before it returns."""
    import multiprocessing as mp
    import queue
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(fn, r, world, port, device, tuple(args),
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world and not errors:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    errors.append(f"ranks {dead} died (exit codes "
                                  f"{[procs[r].exitcode for r in dead]})")
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"spawn: no result from {world - len(out)} of "
                        f"{world} workers in {timeout} s")
                continue
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("spawn: a worker failed\n" + "\n".join(errors))
    return [out[r] for r in range(world)]


def _relay(src, dst, prefix: str = "") -> None:
    for line in iter(src.readline, ""):
        dst.write(prefix + line)
        dst.flush()
    src.close()


def _feed(dst) -> None:
    try:
        for line in iter(sys.stdin.readline, ""):
            dst.write(line)
            dst.flush()
    except (BrokenPipeError, ValueError):
        pass
    finally:
        try:
            dst.close()
        except BrokenPipeError:
            pass


def launch(argv: Sequence[str], world: int, stdin: bool = False) -> int:
    """Run ``python -m vidcap_tpu_torch *argv`` as ``world`` worker
    processes on this machine, each with a launcher's environment (rank r on
    card r, or gloo where the command says ``--device cpu``). With
    ``stdin`` rank 0 reads this process's stdin. Rank 0 writes its stdout;
    every rank's stderr comes through, the other ranks' lines marked with
    their rank. Returns the first nonzero exit code, or 0;
    a worker that fails ends the others."""
    port = free_port()
    procs = []
    env0 = {k: v for k, v in os.environ.items() if k not in _ENV}
    # the workers import this package from wherever they start
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env0["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env0.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    for r in range(world):
        env = {**env0, "RANK": str(r), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "vidcap_tpu_torch", *argv], env=env,
            stdin=subprocess.PIPE if r == 0 and stdin
            else subprocess.DEVNULL,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    threads = [threading.Thread(target=_feed, args=(procs[0].stdin,),
                                daemon=True)] if stdin else []
    for r, p in enumerate(procs):
        if r == 0:
            threads.append(threading.Thread(target=_relay, args=(
                p.stdout, sys.stdout), daemon=True))
        else:
            threads.append(threading.Thread(target=_relay, args=(
                p.stdout, sys.stderr, f"[rank {r}] "), daemon=True))
        threads.append(threading.Thread(target=_relay, args=(
            p.stderr, sys.stderr, f"[rank {r}] " if r else ""),
            daemon=True))
    for t in threads:
        t.start()
    rc = 0
    try:
        pending = list(procs)
        while pending:
            for p in list(pending):
                try:
                    code = p.wait(timeout=0.2)
                except subprocess.TimeoutExpired:
                    continue
                pending.remove(p)
                if code and not rc:
                    rc = code
                    for q in pending:   # the group cannot go on
                        q.terminate()
    except KeyboardInterrupt:
        import signal
        if procs[0].poll() is None:   # rank 0 ends its server and the others
            procs[0].send_signal(signal.SIGINT)
        for p in procs:
            p.wait()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for t in threads[1 if stdin else 0:]:
            t.join(timeout=5)
    return rc
