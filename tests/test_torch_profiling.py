"""The port's profiling hooks (vidcap_tpu_torch/utils/profiling.py), the
counterparts of vidcap_tpu/utils/profiling.py, on the CPU: a trace names
an annotated range, no directory records nothing, the trace server answers
a request with a trace, and NaN debugging raises forward and backward and
ends when disabled."""
import json
import os
import threading
import urllib.error
import urllib.request

import pytest
import torch

from vidcap_tpu_torch.utils import profiling


def _work():
    a = torch.randn(32, 32)
    return (a @ a).sum()


def test_trace_writes_a_trace_naming_the_annotated_range(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("decoder_step_region"):
            _work()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    events = json.loads((tmp_path / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "decoder_step_region" for e in events)


def test_trace_without_a_directory_records_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("VIDCAP_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.trace():
        with profiling.annotate("unrecorded"):
            _work()
    assert os.listdir(tmp_path) == []


def test_trace_reads_the_directory_from_the_environment(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("VIDCAP_TRACE_DIR", str(tmp_path))
    with profiling.trace():
        _work()
    assert [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]


def test_server_answers_a_request_with_a_trace(tmp_path):
    server = profiling.start_server(0, trace_dir=str(tmp_path))
    try:
        port = server.server_address[1]
        got = {}

        def ask():
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/trace?ms=200", timeout=60) as r:
                got["status"], got["body"] = r.status, json.loads(r.read())

        asker = threading.Thread(target=ask)
        asker.start()
        while asker.is_alive():
            _work()
            asker.join(0.01)
        assert not asker.is_alive()
        assert got["status"] == 200
        path = got["body"]["trace"]
        assert os.path.dirname(path) == str(tmp_path)
        assert "traceEvents" in json.loads(open(path).read())
        with pytest.raises(urllib.error.HTTPError) as bad:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/trace?ms=0",
                                   timeout=60)
        assert bad.value.code == 400
    finally:
        server.shutdown()
        server.server_close()


@pytest.fixture
def nan_check():
    check = profiling.enable_nan_debugging()
    yield check
    check.disable()


def test_nan_debugging_raises_forward(nan_check):
    x = torch.ones(4)
    assert torch.isfinite(torch.log(x)).all()
    with pytest.raises(FloatingPointError, match="log"):
        torch.log(-x)


def test_nan_debugging_raises_on_a_nan_gradient(nan_check):
    # finite forward (sqrt(0) * 0 = 0); backward 0 / (2 sqrt(0)) = NaN
    x = torch.zeros(3, requires_grad=True)
    y = (torch.sqrt(x) * 0).sum()
    assert float(y.detach()) == 0.0
    with pytest.raises(FloatingPointError):
        y.backward()


def test_nan_debugging_is_off_again_after_disable():
    assert torch.isnan(torch.log(-torch.ones(2))).all()
    check = profiling.enable_nan_debugging()
    check.disable()
    assert torch.isnan(torch.log(-torch.ones(2))).all()
