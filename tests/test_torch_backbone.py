"""The port's pixel front end against the JAX package on the CPU: frame
sampling and preprocessing, the IRv2 backbone (f32 in process, bf16 with
XLA's excess precision off in a subprocess), the remat stride, the weight
bridge's HWIO ↔ OIHW transposes, and the TF-slim conversion.

The backbone is the JAX tests' tiny variant (width 1/16, depth (1, 1, 1)),
its weights from JAX ``init`` through ``convert.from_flax``, its inputs
from a numpy seed.

Tolerances, and why:
* frame indices: equal (integer results of the same f32 arithmetic).
* ``preprocess_frames``: 1e-5 absolute on [-1, 1], the same weights applied
  in another summation order. At 240×320 → 299 the JAX package's own
  result is 2.6e-5 from the exact (f64) resize, so there the port is held
  to the exact resize (1e-6) instead.
* the backbone in f32: outputs and the gradient norm 1e-4 relative (the
  same products summed in another order; measured 3.9e-7).
* the backbone in bf16: relative L2 1e-3. The rounding points are the same
  (the conv rounded once from f32, the f32 epilogue, the residual and the
  average pool's additions rounded one by one as XLA does): measured
  identical, but an f32 conv sum next to a bf16 rounding boundary may round
  one ulp apart in another summation order, and the ulp travels.
* ``remat_every`` ∈ {0, 1, 2}: identical outputs and gradients.
* the bridge and the slim conversion: identical arrays.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import PYTHONPATH
from vidcap_tpu import convert as jax_convert
from vidcap_tpu.data import frames as jax_frames
from vidcap_tpu.models import backbone as jax_bb
from vidcap_tpu_torch import convert
from vidcap_tpu_torch.data import frames
from vidcap_tpu_torch.models import backbone as bb

jax.config.update("jax_platforms", "cpu")

TINY = dict(width_mult=0.0625, depth=(1, 1, 1))
S = 75


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small convolutions on a shared CPU: one thread each is many times
    faster than contending for all cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_f32():
    """(the JAX backbone, its f32 params as numpy, pixels f32[2, S, S, 3])."""
    net = jax_bb.InceptionResNetV2(compute_dtype=jnp.float32, **TINY)
    params = jax.jit(lambda k: net.init(k, jnp.zeros((1, S, S, 3))))(
        jax.random.key(0))["params"]
    x = np.random.default_rng(0).normal(size=(2, S, S, 3)).astype(np.float32)
    return net, with_bn(jax.tree_util.tree_map(np.asarray, params)), x


def with_bn(params, seed: int = 6):
    """``params`` with every batch-norm scale drawn from U(0.5, 1.5) and
    every offset from N(0, 0.1), in path order from a numpy seed: init sets
    them to 1 and 0, where a ConvBN that mixed them up, or a bridge that
    put one channel's under another's, would give the same outputs."""
    rng = np.random.default_rng(seed)
    flat = convert.flatten_tree(params)
    for k in sorted(flat):
        if k.endswith("/bn_scale"):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
        elif k.endswith("/bn_offset"):
            flat[k] = rng.normal(0.0, 0.1, flat[k].shape).astype(np.float32)
    return convert.unflatten_tree(flat)


def _port(params, dtype=torch.float32, **kw):
    net = bb.InceptionResNetV2(compute_dtype=dtype, **{**TINY, **kw})
    return convert.from_flax(net, params)


# ------------------------------------------------------------------ frames

@pytest.mark.parametrize("total,num", [(0, 4), (1, 5), (7, 7), (26, 26),
                                       (100, 26), (13, 40), (299, 8)])
def test_uniform_frame_indices_equal(total, num):
    np.testing.assert_array_equal(frames.uniform_frame_indices(total, num),
                                  jax_frames.uniform_frame_indices(total, num))


def test_sample_frames_device_equal():
    """Frames in × frames out, with points half way between two frames
    (11 → 7, 6 → 5, 26 → 8 ...) and ones a rounding off it."""
    for t in (1, 2, 4, 6, 11, 26, 40, 64):
        x = np.arange(t)
        for n in (1, 3, 5, 7, 8, 26, 30):
            want = np.asarray(jax_frames.sample_frames_device(
                jnp.asarray(x), n))
            got = frames.sample_frames_device(torch.as_tensor(x), n).numpy()
            assert (got == want).all(), (t, n, got, want)


@pytest.mark.parametrize("shape,out", [((2, 120, 160, 3), 75),    # down
                                       ((2, 50, 70, 3), 75),      # up
                                       ((2, 30, 400, 3), 64),     # both
                                       ((1, 75, 75, 3), 75)])     # none
def test_preprocess_frames_matches_jax(shape, out):
    u8 = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(jax_frames.preprocess_frames(jnp.asarray(u8), out))
    got = frames.preprocess_frames(torch.as_tensor(u8), out).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_preprocess_frames_exact_at_video_size():
    """240×320 → 299 against the exact resize in f64 (the weights of
    ``jax.image.resize``, applied without rounding)."""
    u8 = np.random.default_rng(2).integers(0, 256, (2, 240, 320, 3),
                                           dtype=np.uint8)
    x = u8.astype(np.float64) / 255.0
    x = np.einsum("thwc,ho->towc", x, frames.resize_weights(240, 299)
                  .astype(np.float64), optimize=True)
    x = np.einsum("thwc,wo->thoc", x, frames.resize_weights(320, 299)
                  .astype(np.float64), optimize=True)
    got = frames.preprocess_frames(torch.as_tensor(u8), 299).numpy()
    np.testing.assert_allclose(got, x * 2 - 1, atol=1e-6, rtol=0)
    from jax._src.image.scale import (_fill_triangle_kernel,
                                      compute_weight_mat)
    for n in (240, 320):
        np.testing.assert_array_equal(frames.resize_weights(n, 299), np.asarray(
            compute_weight_mat(n, 299, 299 / n, 0.0, _fill_triangle_kernel,
                               True)))


# ------------------------------------------------------------------ backbone

def test_backbone_f32_matches_jax(jax_f32):
    net, params, x = jax_f32
    want = np.asarray(jax.jit(lambda p, x: net.apply({"params": p}, x))(
        params, x))
    g = jax.jit(jax.grad(lambda p: net.apply({"params": p}, x).sum()))(
        params)
    want_gn = float(np.sqrt(sum(np.sum(np.square(np.asarray(v, np.float64)))
                                for v in jax.tree_util.tree_leaves(g))))
    port = _port(params)
    out = port(torch.as_tensor(x))
    out.sum().backward()
    got_gn = float(torch.sqrt(sum(torch.sum(p.grad.double() ** 2)
                                  for p in port.parameters())))
    assert out.shape == (2, 96) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(got_gn, want_gn, rtol=1e-4)


_JAX_BF16 = """
import sys, numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from vidcap_tpu.models.backbone import InceptionResNetV2
out = sys.argv[2]
x = np.load(out + "/x.npy")
net = InceptionResNetV2(compute_dtype=jnp.bfloat16, width_mult=0.0625,
                        depth=(1, 1, 1))
p = dict(np.load(out + "/p.npz"))
import flax
params = flax.traverse_util.unflatten_dict(
    {tuple(k.split("/")): v for k, v in p.items()})
np.save(out + "/y.npy", np.asarray(jax.jit(
    lambda p, x: net.apply({"params": p}, x))(params, x)))
"""


def test_backbone_bf16_matches_jax(jax_f32, tmp_path):
    """The default compute dtype, against the JAX package with XLA's
    excess precision off (tests/test_torch_slice.py says why)."""
    _, params, x = jax_f32
    np.save(tmp_path / "x.npy", x)
    np.savez(tmp_path / "p.npz", **convert.flatten_tree(params))
    env = {**os.environ, "PYTHONPATH": PYTHONPATH, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false"}
    r = subprocess.run([sys.executable, "-c", _JAX_BF16, "{}",
                        str(tmp_path)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    want = np.load(tmp_path / "y.npy")
    with torch.no_grad():
        got = _port(params, torch.bfloat16)(torch.as_tensor(x)).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-3, rel


@pytest.mark.parametrize("stride", [0, 1, 2])
def test_remat_every_changes_nothing(jax_f32, stride):
    """The remat stride recomputes blocks in the backward pass: the
    parameters, the outputs and the gradients stay those of no remat."""
    x = jax_f32[2]
    runs = []
    for s in (stride, 0):
        port = _port_deep(s)
        out = port(torch.as_tensor(x[:1]))
        out.sum().backward()
        runs.append((out.detach(), {k: p.grad.clone()
                                    for k, p in port.named_parameters()}))
    (a, ga), (b, gb) = runs
    assert sorted(ga) == sorted(gb)
    assert torch.equal(a, b)
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k


def _port_deep(remat_every):
    """A depth-(2, 2, 3) port (so that a stride of 2 skips blocks) from the
    seeded init."""
    net = bb.InceptionResNetV2(compute_dtype=torch.float32,
                               width_mult=0.0625, depth=(2, 2, 3),
                               remat_every=remat_every)
    bb.init_backbone(net, np.random.default_rng(3))
    return net


# ------------------------------------------------------------------ bridge

def test_bridge_round_trip_is_exact(jax_f32):
    _, params, _ = jax_f32
    port = _port(params)
    assert port.stem_conv1.conv.kernel.shape == (8, 3, 3, 3)   # OIHW
    flat = convert.to_flat(port)
    want = convert.flatten_tree(params)
    assert sorted(flat) == sorted(want)
    for k in want:
        assert flat[k].shape == want[k].shape, k
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)


def test_backbone_npz_both_ways(jax_f32, tmp_path, monkeypatch):
    """A JAX ``save_backbone_params`` file loads into the port's
    ``load_backbone_params`` (and ``$VIDCAP_IRV2_WEIGHTS``), and the port's
    file applies in the JAX package to the same outputs."""
    net, params, x = jax_f32
    jax_file = str(tmp_path / "jax.npz")
    jax_bb.save_backbone_params(params, jax_file)
    monkeypatch.setenv("VIDCAP_IRV2_WEIGHTS", jax_file)
    from vidcap_tpu_torch.config import get_preset
    port = bb.load_backbone_params(
        bb.InceptionResNetV2(compute_dtype=torch.float32, **TINY),
        get_preset("e2e_irv2"))
    port_file = str(tmp_path / "port.npz")
    bb.save_backbone_params(port, port_file)
    import flax
    restored = flax.traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v)
         for k, v in np.load(port_file).items()})
    want = np.asarray(net.apply({"params": params}, x))
    np.testing.assert_array_equal(
        np.asarray(net.apply({"params": restored}, x)), want)
    with torch.no_grad():
        got = port(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_fresh_init_warns_and_is_seeded(capsys, tmp_path):
    from vidcap_tpu_torch.config import apply_overrides, get_preset
    cfg = apply_overrides(get_preset("e2e_irv2"),
                          [f"data.data_dir={tmp_path}"])
    nets = [bb.load_backbone_params(bb.InceptionResNetV2(**TINY), cfg,
                                    weights_path=str(tmp_path / "no.npz"))
            for _ in range(2)]
    assert "randomly initialized" in capsys.readouterr().err
    k = nets[0].stem_conv1.conv.kernel
    assert torch.equal(k, nets[1].stem_conv1.conv.kernel)
    assert abs(float(k.detach().std()) - 1 / np.sqrt(27)) < 0.05
    assert torch.equal(nets[0].conv7b.bn_scale, torch.ones(96))


# ------------------------------------------------------------------ slim

def _slim_vars(params, depth):
    """Slim-named variables that convert back to ``params`` (the BN fold
    inverted: mean 0, var = 1/scale² - eps, beta = offset)."""
    tf_vars = {}
    for path, slim in jax_convert.irv2_slim_name_map(depth).items():
        node = params
        for part in path.split("/"):
            node = node[part]
        base = f"{jax_convert.SLIM_PREFIX}/{slim}"
        tf_vars[f"{base}/weights"] = np.asarray(node["conv"]["kernel"])
        if path.endswith("/up"):
            tf_vars[f"{base}/biases"] = np.asarray(node["bn_offset"]) + 0.5
        else:
            scale = np.asarray(node["bn_scale"]) * 1.5
            tf_vars[f"{base}/BatchNorm/moving_variance"] = (
                1.0 / scale ** 2 - jax_convert.BN_EPS).astype(np.float64)
            tf_vars[f"{base}/BatchNorm/moving_mean"] = np.full_like(
                scale, 0.25)
            tf_vars[f"{base}/BatchNorm/beta"] = np.asarray(
                node["bn_offset"]) - 0.1
    return tf_vars


def _assert_trees_equal(a, b):
    fa, fb = convert.flatten_tree(a), convert.flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_slim_conversion_identical(jax_f32):
    _, params, _ = jax_f32
    assert convert.irv2_slim_name_map((1, 1, 1)) == \
        jax_convert.irv2_slim_name_map((1, 1, 1))
    tf_vars = _slim_vars(params, (1, 1, 1))
    _assert_trees_equal(convert.convert_irv2(tf_vars, params),
                        jax_convert.convert_irv2(tf_vars, params))
    flat = {k[len("InceptionResnetV2/"):]: v for k, v in tf_vars.items()}
    _assert_trees_equal(convert.convert_irv2(flat, params, prefix=""),
                        jax_convert.convert_irv2(flat, params, prefix=""))
    rng = np.random.default_rng(4)
    w, b = rng.normal(size=(12, 16)), rng.normal(size=(16,))
    for got, want in zip(convert.tf_lstm_gates_to_flax(w, b),
                         jax_convert.tf_lstm_gates_to_flax(w, b)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fault", ["missing", "mismatch"])
def test_slim_conversion_errors_as_reference(jax_f32, fault):
    _, params, _ = jax_f32
    tf_vars = _slim_vars(params, (1, 1, 1))
    key = "InceptionResnetV2/Conv2d_1a_3x3/weights"
    if fault == "missing":
        del tf_vars[key]
        del tf_vars["InceptionResnetV2/Block8/Conv2d_1x1/biases"]
        err = KeyError
    else:
        tf_vars[key] = tf_vars[key][:, :, :, :4]
        err = ValueError
    with pytest.raises(err) as want:
        jax_convert.convert_irv2(tf_vars, params)
    with pytest.raises(err) as got:
        convert.convert_irv2(tf_vars, params)
    assert str(got.value) == str(want.value)


def test_decoder_conversion_identical():
    from vidcap_tpu.config import apply_overrides, get_preset
    from vidcap_tpu.models.model import create_model, init_params
    cfg = apply_overrides(get_preset("synthetic_tiny"), [])
    model = create_model(cfg, 100)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: init_params(model, cfg, k))(jax.random.key(0)))["decoder"]
    rng = np.random.default_rng(5)
    d = params["lstm0"]["w"].shape
    tf_vars = {"Wemb": rng.normal(size=(100, 32)),
               "lstm/basic_lstm_cell/kernel": rng.normal(size=d),
               "lstm/basic_lstm_cell/bias": rng.normal(size=d[1:]),
               "embed_word_W": rng.normal(size=(32, 100)),
               "embed_word_b": rng.normal(size=(100,)),
               "encode_image_W": rng.normal(
                   size=params["feat_proj"]["kernel"].shape)}
    _assert_trees_equal(
        convert.convert_decoder(tf_vars, params, vocab_size=100),
        jax_convert.convert_decoder(tf_vars, params, vocab_size=100))


def test_convert_cli_matches_jax(jax_f32, tmp_path, monkeypatch):
    """``convert`` through both CLIs on a TF1 checkpoint of slim-named
    variables (written with TF's compat.v1 Saver, the reference's format):
    the same ``.npz``. Then the port's loads into the tiny backbone."""
    tf = pytest.importorskip("tensorflow")
    _, params, _ = jax_f32
    ckpt = str(tmp_path / "irv2.ckpt")
    with tf.Graph().as_default():
        for name, v in _slim_vars(params, (1, 1, 1)).items():
            tf.compat.v1.get_variable(name, initializer=v)
        saver = tf.compat.v1.train.Saver()
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, ckpt)
    from vidcap_tpu.cli.main import main as jax_main
    from vidcap_tpu_torch.cli.main import main as port_main
    jax_orig, port_orig = jax_bb.InceptionResNetV2, bb.InceptionResNetV2
    monkeypatch.setattr(jax_bb, "InceptionResNetV2",
                        lambda **kw: jax_orig(**{**TINY, **kw}))
    monkeypatch.setattr(bb, "InceptionResNetV2",
                        lambda **kw: port_orig(**{**TINY, **kw}))
    outs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        outs[name] = str(tmp_path / f"{name}.npz")
        assert main(["convert", "--preset", "e2e_irv2", "--set",
                     f"data.frame_size={S}", "--tf-checkpoint", ckpt,
                     "--out", outs[name]]) == 0
    with np.load(outs["jax"]) as a, np.load(outs["port"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    bb.load_backbone_params(bb.InceptionResNetV2(), None,
                            weights_path=outs["port"])
