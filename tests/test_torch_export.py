"""The port's export (``vidcap_tpu_torch/export.py``, ``export``, ``caption``
and ``serve --from-export``) against the JAX package's
(``vidcap_tpu/export.py``) on the CPU: a counterpart of each test of
tests/test_export.py, with the port's artifact decoding the tokens of the
JAX package's artifact (``export_decoder(..., platforms=["cpu"])``) on the
same features, and the port's refusals.

Both packages run in process at ``synthetic_tiny`` size in float32, the
port on JAX ``init_params`` weights (tests/test_torch_serving.py's
fixtures). Tolerance: identical tokens, captions and JSON.
"""
import dataclasses
import io
import json
import sys
import threading

import numpy as np
import pytest
import torch

from test_torch_serving import (F32, cap, cfg, jax_side, post_npy,  # noqa: F401
                                port_captioner)
from test_torch_slice import kernel_route  # noqa: F401
from vidcap_tpu.cli.main import main as jax_main
from vidcap_tpu.export import ExportedCaptioner as JaxExported
from vidcap_tpu.export import export_decoder as jax_export_decoder
from vidcap_tpu_torch.cli.main import main as cli_main
from vidcap_tpu_torch.convert import flatten_tree, save_weights
from vidcap_tpu_torch.export import ExportedCaptioner, export_decoder
from vidcap_tpu_torch.serving import CaptionServer, make_http_server


@pytest.fixture(scope="module")
def jax_artifact(jax_side, tmp_path_factory):
    """(method, batch) → the directory of the JAX package's artifact of
    the module's weights (batch 0: polymorphic), each made once."""
    jcfg, jcap = jax_side
    made = {}

    def get(method, batch):
        if (method, batch) not in made:
            out = str(tmp_path_factory.mktemp(f"jax_{method}_{batch}"))
            jax_export_decoder(jcap, out, batch_size=batch or None,
                               method=method, beam_width=3,
                               platforms=["cpu"])
            made[method, batch] = out
        return made[method, batch]
    return get


def feats_of(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, cfg.data.num_frames, cfg.data.feature_dim)
                      ).astype(np.float32)


def port_artifact(cap, tmp_path, method, batch, name="exp"):
    out = str(tmp_path / name)
    export_decoder(cap, out, batch_size=batch, method=method, beam_width=3)
    return ExportedCaptioner.load(out, device="cpu")


def jax_tokens(jax_artifact, method, batch, feats, mask=None):
    ec = JaxExported.load(jax_artifact(method, batch))
    return np.asarray(ec.decode_batch(feats, frame_mask=mask))


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_export_round_trip_token_parity(cfg, cap, jax_side, jax_artifact,
                                        tmp_path, method):
    """B=8: the port's artifact decodes the live decode's tokens and the JAX
    artifact's; its vocab decodes the JAX artifact's captions; its weights
    file holds the JAX parameters under their Flax paths."""
    feats = feats_of(cfg, 8)
    live = cap.decode_batch(feats, method=method, beam_width=3)
    ec = port_artifact(cap, tmp_path, method, 8)
    assert ec.meta["schema"] == 1 and ec.meta["batch_size"] == 8
    assert ec.meta["format"] == "vidcap_tpu_torch"
    assert ec.meta["platforms"] == ["cpu"]
    got = ec.decode_batch(feats)
    np.testing.assert_array_equal(got, live)
    np.testing.assert_array_equal(got, jax_tokens(jax_artifact, method, 8,
                                                  feats))
    jec = JaxExported.load(jax_artifact(method, 8))
    assert ec.caption(feats) == jec.caption(feats)
    assert {k: ec.meta[k] for k in jec.meta} == jec.meta
    with np.load(tmp_path / "exp" / "weights.npz") as f:
        flat = flatten_tree(jax_side[1].params)
        assert sorted(f.files) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(f[k], np.asarray(flat[k]))


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_export_round_trip_token_parity_on_the_kernel_route(
        cfg, jax_side, jax_artifact, tmp_path, kernel_route, method):
    """The same tokens with the f32 decoder on the kernel decoder's steps,
    live and from the artifact (K1/K2's and K3's plain versions here)."""
    test_export_round_trip_token_parity(
        cfg, port_captioner(cfg, jax_side[1]), jax_side, jax_artifact,
        tmp_path, method)
    # the live decode, the artifact's tokens and its captions
    assert kernel_route["fused_beam_step" if method == "beam"
                        else "model_rollout"] == 3


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_export_partial_batch_and_chunking(cfg, cap, jax_artifact, tmp_path,
                                           method):
    """B=4: N < B zero-pads with mask 0 (the JAX artifact's tokens and the
    live padded decode); N > B is refused by decode_batch and chunked by
    caption(), as the JAX artifact's; wrong dims are refused."""
    ec = port_artifact(cap, tmp_path, method, 4)
    T = cfg.data.num_frames
    feats = feats_of(cfg, 3, seed=1)
    live = cap.decode_batch(
        np.concatenate([feats, np.zeros_like(feats[:1])]), method=method,
        beam_width=3, frame_mask=np.concatenate(
            [np.ones((3, T), np.float32), np.zeros((1, T), np.float32)]))[:3]
    got = ec.decode_batch(feats)
    np.testing.assert_array_equal(got, live)
    np.testing.assert_array_equal(got, jax_tokens(jax_artifact, method, 4,
                                                  feats))
    many = feats_of(cfg, 10, seed=2)
    assert ec.caption(many) == JaxExported.load(
        jax_artifact(method, 4)).caption(many)
    with pytest.raises(ValueError, match="exceeds exported size"):
        ec.decode_batch(feats_of(cfg, 5))
    with pytest.raises(ValueError, match="don't match exported"):
        ec.decode_batch(np.zeros((2, T, 7), np.float32))


def test_export_rejects_sample_pixels_and_tpu(cfg, cap, tmp_path):
    with pytest.raises(ValueError, match="greedy/beam"):
        export_decoder(cap, str(tmp_path / "e1"), method="sample")
    pixels = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_backbone=True))
    with pytest.raises(ValueError, match="feature-mode"):
        export_decoder(type(cap)(pixels, cap.model, cap.dataset, cap.device),
                       str(tmp_path / "e2"))
    with pytest.raises(ValueError, match="tpu"):
        export_decoder(cap, str(tmp_path / "e3"), platforms=["tpu", "cpu"])
    assert not any((tmp_path / e).exists() for e in ("e1", "e2", "e3"))


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_export_batch_polymorphic(cfg, cap, jax_artifact, tmp_path, method):
    """batch 0: one artifact decodes any N exactly, no padding: the live
    decode's tokens and the JAX polymorphic artifact's."""
    ec = port_artifact(cap, tmp_path, method, 0)
    assert ec.meta["batch_size"] is None and ec.batch_size is None
    for n in (1, 3, 8):
        feats = feats_of(cfg, n, seed=n)
        got = ec.decode_batch(feats)
        np.testing.assert_array_equal(got, cap.decode_batch(
            feats, method=method, beam_width=3), err_msg=f"N={n}")
        np.testing.assert_array_equal(got, jax_tokens(
            jax_artifact, method, 0, feats), err_msg=f"N={n}")
    assert len(ec.caption(feats_of(cfg, 5, seed=99))) == 5


def test_serve_from_export_artifact(cfg, cap, tmp_path):
    """CaptionServer runs off the artifact: the live model's lines; a
    method or feature-shape mismatch is an error."""
    ec = port_artifact(cap, tmp_path, "greedy", 4)
    ec.check_config(cfg)
    rng = np.random.default_rng(3)
    paths = []
    for i in range(5):                       # 1¼ batches
        p = tmp_path / f"f{i}.npy"
        np.save(p, rng.normal(size=(int(rng.integers(1, 10)), 64))
                .astype(np.float32))
        paths.append(str(p))
    inp = "\n".join(paths) + "\n"
    out_live, out_exp = io.StringIO(), io.StringIO()
    CaptionServer(cfg, cap, batch_size=4).run(inp=io.StringIO(inp),
                                              out=out_live)
    CaptionServer(cfg, ec, batch_size=4, method="greedy").run(
        inp=io.StringIO(inp), out=out_exp)
    assert out_exp.getvalue() == out_live.getvalue()
    assert ec.decode_calls == 3      # the warmup and two flushes
    with pytest.raises(ValueError, match="method"):
        ec.decode_batch(feats_of(cfg, 2), method="beam")
    bad = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, feature_dim=7))
    with pytest.raises(ValueError, match="artifact was exported for"):
        ec.check_config(bad)


def test_http_serve_from_export(cfg, cap, tmp_path):
    ec = port_artifact(cap, tmp_path, "greedy", 4)
    server, svc = make_http_server(cfg, ec, port=0, batch_size=4,
                                   method="greedy", max_wait_ms=20.0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        feats = feats_of(cfg, 1, seed=9)[0]
        status, body = post_npy(port, feats)
        assert status == 200
        live = cap.dataset.vocab.decode_str(
            cap.decode_batch(feats[None], method="greedy")[0])
        assert body["caption"] == live
    finally:
        server.shutdown()
        svc.close()


def test_caption_from_export_rejects_conflicting_method(cap, tmp_path):
    port_artifact(cap, tmp_path, "greedy", 4)
    with pytest.raises(SystemExit, match="conflicts with the artifact"):
        cli_main(["caption", "--preset", "synthetic_tiny", "--from-export",
                  str(tmp_path / "exp"), "--method", "beam", "--device",
                  "cpu"])


def _inputs(tmp_path):
    """Seven feature files of 1-12 frames (synthetic_tiny keeps 8)."""
    d = tmp_path / "inputs"
    d.mkdir()
    g = np.random.default_rng(5)
    for i in range(7):
        np.save(d / f"clip_{i}.npy", g.normal(size=(int(g.integers(1, 13)),
                                                    64)).astype(np.float32))
    return str(d)


@pytest.mark.parametrize("method,batch", [("greedy", 4), ("beam", 0)])
def test_export_cli_round_trip(cfg, jax_side, jax_artifact, tmp_path,
                               capsys, method, batch):
    """``export --weights`` then ``caption --from-export`` on the split and
    with ``--inputs``: the JSON of the JAX CLI's ``caption --from-export``
    on the JAX artifact of the same weights."""
    weights = str(tmp_path / "w.npz")
    save_weights(port_captioner(cfg, jax_side[1]).model, weights)
    art = str(tmp_path / "artifact")
    assert cli_main(["export", "--preset", "synthetic_tiny", "--weights",
                     weights, "--out", art, "--batch", str(batch),
                     "--method", method, "--beam", "3", "--device", "cpu",
                     "--set", F32[0]]) == 0
    inputs = _inputs(tmp_path)
    for name, extra in (("split", []), ("inputs", ["--inputs", inputs])):
        want, got = tmp_path / f"jax_{name}.json", tmp_path / f"{name}.json"
        assert jax_main(["caption", "--preset", "synthetic_tiny",
                         "--from-export", jax_artifact(method, batch),
                         "--out", str(want)] + extra) == 0
        assert cli_main(["caption", "--preset", "synthetic_tiny",
                         "--from-export", art, "--out", str(got),
                         "--device", "cpu"] + extra) == 0
        assert json.loads(got.read_text()) == json.loads(want.read_text())
    err = capsys.readouterr().err
    assert f"[vidcap] {method}: " in err and "kernel launches" in err


def test_export_from_checkpoint_equals_live_caption(tmp_path, monkeypatch,
                                                    capsys):
    """``train`` writes a checkpoint; ``export --checkpoint-dir`` of it and
    ``caption --from-export`` give the JSON of ``caption
    --checkpoint-dir``."""
    monkeypatch.chdir(tmp_path)
    common = ["--preset", "synthetic_tiny", "--device", "cpu", "--set",
              F32[0]]
    assert cli_main(["train", *common, "--steps", "2", "--eval-every",
                     "0"]) == 0
    assert cli_main(["export", *common, "--out", "art",
                     "--method", "beam", "--batch", "32"]) == 0
    assert cli_main(["caption", *common, "--from-export", "art", "--out",
                     "exp.json"]) == 0
    assert cli_main(["caption", *common, "--method", "beam", "--out",
                     "live.json"]) == 0
    assert json.loads((tmp_path / "exp.json").read_text()) == \
        json.loads((tmp_path / "live.json").read_text())


def test_serve_from_export_rejects_conflicting_flags(cap, tmp_path):
    port_artifact(cap, tmp_path, "greedy", 4)
    port_artifact(cap, tmp_path, "beam", 4, name="beam")
    for art, flags in (("exp", ["--method", "beam"]),
                       ("beam", ["--beam", "5"])):
        with pytest.raises(SystemExit, match="conflicts with the artifact"):
            cli_main(["serve", "--preset", "synthetic_tiny", "--from-export",
                      str(tmp_path / art), "--device", "cpu", *flags])


def test_exported_decode_rejects_pixel_inputs(cfg, cap, tmp_path):
    ec = port_artifact(cap, tmp_path, "greedy", 4)
    pixels = np.zeros((2, cfg.data.num_frames, 8, 8, 3), np.float32)
    with pytest.raises(ValueError, match="FEATURES"):
        ec.decode_batch(pixels)


def test_load_refuses_a_jax_artifact(jax_artifact, capsys):
    """The JAX package's artifact is a StableHLO graph: the port names it
    and exits 2, from the API and from the CLI."""
    art = jax_artifact("greedy", 4)
    with pytest.raises(FileNotFoundError, match="artifact of the JAX package"):
        ExportedCaptioner.load(art, device="cpu")
    assert cli_main(["caption", "--preset", "synthetic_tiny",
                     "--from-export", art, "--device", "cpu"]) == 2
    assert "artifact of the JAX package" in capsys.readouterr().err


def test_load_holds_the_artifact_to_its_platforms(cap, tmp_path):
    out = str(tmp_path / "exp")
    export_decoder(cap, out, batch_size=4, platforms=["cuda"])
    with pytest.raises(ValueError, match=r"exported for \['cuda'\], not cpu"):
        ExportedCaptioner.load(out, device="cpu")
    with pytest.raises(SystemExit, match="not cpu"):
        cli_main(["serve", "--preset", "synthetic_tiny", "--from-export",
                  out, "--device", "cpu"])


def test_export_refuses_the_random_init(tmp_path, monkeypatch, capsys):
    """Without a checkpoint or --weights there is nothing trained to
    export: exit 2, no artifact."""
    monkeypatch.chdir(tmp_path)
    assert cli_main(["export", "--preset", "synthetic_tiny", "--out", "art",
                     "--device", "cpu"]) == 2
    assert "no checkpoint found" in capsys.readouterr().err
    assert not (tmp_path / "art").exists()


@pytest.mark.parametrize("argv", [
    ["serve", "--weights", "w.npz"],
    ["export", "--weights", "w.npz", "--out", "art"],
    ["caption", "--from-export", "art"],
    ["serve", "--from-export", "art"]])
def test_entry_points_need_the_card_unless_asked(cap, tmp_path, monkeypatch,
                                                 capsys, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device exists")
    monkeypatch.chdir(tmp_path)
    save_weights(cap.model, "w.npz")
    export_decoder(cap, "art", batch_size=4, platforms=["cpu", "cuda"])
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    assert cli_main([argv[0], "--preset", "synthetic_tiny", *argv[1:]]) == 2
    assert "no CUDA device" in capsys.readouterr().err
