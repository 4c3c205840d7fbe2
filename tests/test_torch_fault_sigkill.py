"""Fault injection, as tests/test_fault_sigkill.py does for the JAX
package: SIGKILL a `python -m vidcap_tpu_torch train --device cpu` process
mid-run, resume from its checkpoints in a fresh process, and check that the
greedy captions of the result equal those of an uninterrupted run (a pure
function of the final parameters). The kill comes on a sign of progress,
the first log row past the resumed checkpoint, not after a fixed sleep."""
import json
import os
import signal
import subprocess
import sys
import time

from test_torch_slice import PYTHONPATH

TRAIN = [sys.executable, "-m", "vidcap_tpu_torch", "train", "--preset",
         "synthetic_tiny", "--device", "cpu", "--log-every", "1",
         "--log-file", "log.jsonl"]


def _start(cwd, *args):
    return subprocess.Popen([*TRAIN, *args], cwd=cwd,
                            env={**os.environ, "PYTHONPATH": PYTHONPATH},
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc):
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err


def _caption(cwd):
    return subprocess.Popen(
        [sys.executable, "-m", "vidcap_tpu_torch", "caption", "--preset",
         "synthetic_tiny", "--method", "greedy", "--device", "cpu", "--out",
         "caps.json"], cwd=cwd, env={**os.environ, "PYTHONPATH": PYTHONPATH},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def _rows(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.endswith("\n")]


def test_sigkill_resume_gives_the_uninterrupted_captions(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    # uninterrupted to step 25 (the preset checkpoints every 10 steps and
    # at the end), beside the interrupted run's first leg to step 5
    full, first = _start(a, "--steps", "25"), _start(b, "--steps", "5")
    _finish(first)

    # the second leg resumes at 5; killed once it logs a step past 5, long
    # before its end (~20 ms a step)
    doomed = _start(b, "--steps", "25", "--resume")
    _finish(full)
    caps_a = _caption(a)
    log = b / "log.jsonl"
    deadline = time.monotonic() + 240
    while not any(r["step"] > 5 for r in _rows(log)):
        assert doomed.poll() is None, "the run ended before it was killed"
        assert time.monotonic() < deadline, "no progress to kill on"
        time.sleep(0.02)
    doomed.send_signal(signal.SIGKILL)
    doomed.wait(timeout=60)
    assert doomed.returncode == -signal.SIGKILL
    assert "ckpt_25.pt" not in os.listdir(b / "checkpoints")

    # a fresh process resumes from what survived and finishes
    _finish(_start(b, "--steps", "25", "--resume"))
    caps_b = _caption(b)
    for proc in (caps_a, caps_b):
        _finish(proc)
    got = json.loads((b / "caps.json").read_text())
    assert got == json.loads((a / "caps.json").read_text())
    assert len(got) > 0
