"""``info``, the preflight census, against the JAX package's: the parameter
census of every preset (the port builds the model on the meta device, the
JAX package traces ``init`` with ``jax.eval_shape``: nothing allocated on
either side), the train-memory and beam-buffer estimates, and the command's
JSON keys. Tolerance: equal."""
import json

import pytest
import torch

from vidcap_tpu.cli.main import main as jax_main
from vidcap_tpu.config import PRESETS as JAX_PRESETS
from vidcap_tpu.utils import meminfo as jax_meminfo
from vidcap_tpu_torch.cli.main import main as cli_main
from vidcap_tpu_torch.config import PRESETS
from vidcap_tpu_torch.models import model as model_mod
from vidcap_tpu_torch.utils import meminfo

JAX_ONLY = {"jax"}           # the JAX package's version
PORT_ONLY = {"torch", "cuda"}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_census_and_estimates_equal_jax(name, monkeypatch):
    built = []
    real = model_mod.create_model
    monkeypatch.setattr(model_mod, "create_model",
                        lambda *a, **k: built.append(real(*a, **k))
                        or built[-1])
    census = meminfo.param_census(PRESETS[name])
    want = jax_meminfo.param_census(JAX_PRESETS[name])
    assert census == want and list(census) == list(want)   # and its order
    assert all(p.is_meta for p in built[0].parameters())   # nothing allocated
    assert meminfo.train_memory_estimate(PRESETS[name], census["_total"]) \
        == jax_meminfo.train_memory_estimate(JAX_PRESETS[name],
                                             census["_total"])
    assert meminfo.decode_buffer_estimate(PRESETS[name]) == \
        jax_meminfo.decode_buffer_estimate(JAX_PRESETS[name])


def _info_json(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("preset,extra", [
    ("msrvtt_attn_beam5", []),
    ("e2e_scst_multitask", ["--set", "train.grad_accum=2"])])
def test_info_json_has_the_jax_commands_keys(preset, extra, capsys):
    argv = ["info", "--preset", preset, "--json", "--no-devices", *extra]
    want = _info_json(jax_main, argv, capsys)
    got = _info_json(cli_main, argv, capsys)
    assert set(got) == set(want) - JAX_ONLY | PORT_ONLY
    assert got["torch"] == torch.__version__
    for k in ("preset", "mode", "stage", "dims", "decode", "params",
              "train_step_hbm_estimate_bytes", "beam_logits_buffer"):
        assert got[k] == want[k], k
    assert set(got["compile_cache"]) == {"path", "entries", "bytes"}
    assert got["compile_cache"]["path"].endswith("build/vidcap_tpu_torch")


def test_info_reports_the_devices(capsys):
    """Without ``--no-devices``: the card's name, count and memory, or, with
    none visible, that there is none; the text form prints the census."""
    info = _info_json(cli_main, ["info", "--preset", "msvd_greedy",
                                 "--json"], capsys)
    b = info["backend"]
    if torch.cuda.is_available():
        assert b["platform"] == "cuda" and b["n_devices"] >= 1
        assert b["total_memory_bytes"] > 0
    else:
        assert b == {"platform": "cpu", "device_kind": "no CUDA device "
                     "visible", "n_devices": 0}
    assert cli_main(["info", "--preset", "synthetic_tiny"]) == 0
    out = capsys.readouterr().out
    assert "[info] params: attr_head 0.00M, decoder 0.04M" in out
    assert "kernel build cache" in out
