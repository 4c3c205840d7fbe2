"""The int8 vocab projection (``decode.int8_vocab_projection``) of the port
against the JAX package's (``vidcap_tpu/ops/int8_proj.py``, which XLA
compiles: the JAX package has no Pallas kernel for it), K2-int8's
split-vocab decomposition against the one-pass plain version, and the int8
beam through ``Captioner`` and an exported artifact against the JAX
package's.

Tolerances: the quantized weights, scales and bias bit for bit; the int32
sums identical; the logits within one bf16 ulp. Measured: every logit
identical, so XLA's CPU backend contracts nothing here into a fused
multiply-add (the test reports any that differ). Beam tokens and caption
JSON identical in f32 (the int8 logits are bf16, so exact ties are many,
and both sides break them to the smaller column); in bf16 ≥ 90% of the
rows, as ``tests/test_torch_slice.py``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serving import F32, cfg, jax_side, port_captioner  # noqa: F401
from test_torch_slice import kernel_route  # noqa: F401
from test_torch_slice import run_jax_scripts
from vidcap_tpu.config import apply_overrides as jax_apply_overrides
from vidcap_tpu.export import ExportedCaptioner as JaxExported
from vidcap_tpu.export import export_decoder as jax_export_decoder
from vidcap_tpu.inference import Captioner as JaxCaptioner
from vidcap_tpu.ops import int8_proj as jax_int8
from vidcap_tpu_torch.config import apply_overrides, get_preset
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.export import ExportedCaptioner, export_decoder
from vidcap_tpu_torch.inference import Captioner
from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.ops.int8_proj import (TILE_ROWS, Int8Projection,
                                            int8_logits_plain, int8_sums,
                                            int8_topk_project_chunked_plain,
                                            int8_topk_project_plain,
                                            quantize_out_proj, quantize_rows,
                                            topk_project_int8)
from vidcap_tpu_torch.ops.limits import H100_SMS
from vidcap_tpu_torch.ops.topk_project import TILE_N, chunk_layout

INT8 = ["decode.int8_vocab_projection=true"]


def _weights(H, Vp, seed, rows=40):
    g = np.random.default_rng(seed)
    W = (g.normal(size=(H, Vp)) * g.uniform(0.01, 0.5, size=Vp)
         ).astype(np.float32)
    W[:, 3] = 0.0                     # a zero column: the 1e-8 guard
    b = (g.normal(size=Vp) * 0.1).astype(np.float32)
    h = np.tanh(g.normal(size=(rows, H)) * 2).astype(np.float32)
    h[5] = 0.0                        # a zero row: hscale 0, h8 0
    return W, b, h


def _jax_quantized(W, b, vocab):
    return jax_int8.quantize_out_proj(
        {"decoder": {"out_proj": {"kernel": jnp.asarray(W),
                                  "bias": jnp.asarray(b)}}}, vocab)


def _port_quantized(W, b, vocab):
    W8, ws, bq = quantize_out_proj(torch.tensor(W), torch.tensor(b), vocab)
    return W8, ws, bq, Int8Projection(W8.t().contiguous(), ws, bq)


@pytest.mark.parametrize("H,Vp,vocab", [(64, 384, 300), (32, 264, 264)])
def test_quantize_out_proj_bit_for_bit(H, Vp, vocab):
    W, b, _ = _weights(H, Vp, seed=H + Vp)
    jW8, jws, jbq = _jax_quantized(W, b, vocab)
    W8, ws, bq, _ = _port_quantized(W, b, vocab)
    assert W8.dtype == torch.int8
    np.testing.assert_array_equal(W8.numpy(), np.asarray(jW8))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws)[0])
    np.testing.assert_array_equal(bq.numpy(), np.asarray(jbq))
    assert (bq[vocab:] == -1e30).all()


@pytest.mark.parametrize("H,Vp,vocab", [(64, 384, 300), (32, 264, 264)])
def test_int8_logits_match_jax(H, Vp, vocab):
    """The quantized rows and the int32 sums identical to the JAX
    package's; the bf16 logits within one bf16 ulp (measured: identical)."""
    W, b, h = _weights(H, Vp, seed=H * Vp)
    jW8, jws, jbq = _jax_quantized(W, b, vocab)
    _, _, _, proj = _port_quantized(W, b, vocab)
    hj = jnp.asarray(h)
    hs_j = jnp.max(jnp.abs(hj), -1, keepdims=True) / 127.0
    h8_j = jnp.clip(jnp.round(hj / jnp.maximum(hs_j, 1e-8)), -127,
                    127).astype(jnp.int8)
    h8, hs = quantize_rows(torch.tensor(h))
    np.testing.assert_array_equal(h8.numpy(), np.asarray(h8_j))
    np.testing.assert_array_equal(hs.numpy(), np.asarray(hs_j)[:, 0])
    acc_j = jax.lax.dot_general(h8_j, jW8, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(int8_sums(h8, proj.w8t).numpy(),
                                  np.asarray(acc_j))
    want = np.asarray(jax.jit(jax_int8.int8_logits)(hj, jW8, jws, jbq)
                      .astype(jnp.float32))
    got = int8_logits_plain(torch.tensor(h), proj).numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()
    print(f"int8 logits differing from XLA's: {(got != want).sum()} of "
          f"{got.size}")


def _layout(rows, Vp):
    """The kernel's chunk width at ``rows`` rows on the H100's 132 SMs
    (128-row tiles): 264 rows are 3 row tiles, so 44 chunks."""
    per_chunk, _ = chunk_layout(rows, Vp, H100_SMS, TILE_ROWS)
    return pytest.param(rows, Vp, per_chunk * TILE_N,
                        id=f"rows{rows}-{Vp}-{per_chunk * TILE_N}")


@pytest.mark.parametrize("K", [1, 5, 6, 8])
@pytest.mark.parametrize("rows,Vp,chunk_cols", [
    pytest.param(40, 1024, 128, id="1024-128"),
    pytest.param(40, 1000, 256, id="1000-256"),
    pytest.param(40, 264, 128, id="264-128"),
    _layout(264, 16_000), _layout(264, 1000)])
def test_chunked_int8_matches_one_pass(rows, Vp, chunk_cols, K):
    """K2-int8's split-vocab decomposition (per chunk max, exp-sum and
    top-K, then the merge) against the one pass: the same columns, values
    within 1e-6 (``tests/test_torch_topk_chunks.py``'s rule). The int8
    logits are bf16, so ties are many: both take the smaller column."""
    W, b, h = _weights(64, Vp, seed=Vp + K, rows=rows)
    _, _, _, proj = _port_quantized(W, b, Vp - 7)
    ht = torch.tensor(h)
    v_p, i_p = int8_topk_project_plain(ht, proj, K)
    v_c, i_c = int8_topk_project_chunked_plain(ht, proj, K, chunk_cols)
    assert torch.equal(i_c, i_p)
    assert (v_c - v_p).abs().max().item() <= 1e-6


def test_wrapper_runs_plain_on_cpu():
    """A CPU tensor takes the plain version, counts no launch, and returns
    the rows as quantized when asked."""
    W, b, h = _weights(32, 264, seed=3)
    _, _, _, proj = _port_quantized(W, b, 260)
    before = dict(_build.launch_counts)
    v, i, h8, hs = topk_project_int8(torch.tensor(h), proj, 6,
                                     return_quantized=True)
    assert _build.launch_counts == before
    vp, ip = int8_topk_project_plain(torch.tensor(h), proj, 6)
    assert torch.equal(v, vp) and torch.equal(i, ip)
    assert (i < 260).all() and h8.dtype == torch.int8 and hs.shape == (40,)


# ------------------------------------------------ the beam, live and exported

@pytest.fixture(scope="module")
def int8_pair(jax_side):
    """(JAX Captioner, port config) in f32 with the flag on, on the JAX
    ``init_params`` weights of tests/test_torch_serving.py."""
    jcfg, jcap = jax_side
    jcfg8 = jax_apply_overrides(jcfg, INT8)
    return (JaxCaptioner(jcfg8, jcap.model, jcap.params, jcap.dataset),
            apply_overrides(get_preset("synthetic_tiny"), F32 + INT8))


def _feats(cfg, n, seed):
    return np.random.default_rng(seed).normal(
        size=(n, cfg.data.num_frames, cfg.data.feature_dim)).astype(
            np.float32)


@pytest.mark.parametrize("beam,nbest", [(5, 1), (3, 3)])
def test_int8_beam_identical_to_jax_float32(int8_pair, jax_side, beam,
                                            nbest):
    jcap8, cfg8 = int8_pair
    cap = port_captioner(cfg8, jax_side[1])
    feats = _feats(cfg8, 8, seed=beam)
    want = np.asarray(jcap8.decode_batch(feats, method="beam",
                                         beam_width=beam, nbest=nbest))
    np.testing.assert_array_equal(
        cap.decode_batch(feats, beam_width=beam, nbest=nbest), want)
    plain = port_captioner(cfg8, jax_side[1])
    plain.cfg = apply_overrides(plain.cfg, ["decode.int8_vocab_projection="
                                            "false"])
    assert not np.array_equal(plain.decode_batch(feats, beam_width=beam,
                                                 nbest=nbest), want), \
        "the int8 flag changed nothing: the test would not see it"


@pytest.mark.parametrize("beam,nbest", [(5, 1), (3, 3)])
def test_int8_beam_identical_to_jax_float32_on_the_kernel_route(
        int8_pair, jax_side, kernel_route, beam, nbest):
    """The same tokens through the kernel decoder's beam step, the
    projection through K2-int8's wrapper (its plain version here)."""
    jcap8, cfg8 = int8_pair
    cap = port_captioner(cfg8, jax_side[1])
    feats = _feats(cfg8, 8, seed=beam)
    want = np.asarray(jcap8.decode_batch(feats, method="beam",
                                         beam_width=beam, nbest=nbest))
    np.testing.assert_array_equal(
        cap.decode_batch(feats, beam_width=beam, nbest=nbest), want)
    assert kernel_route["fused_beam_step"] == 1
    assert cap._vocab_proj.kernel == "topk_project_int8"


def test_exported_int8_artifact_equals_jax_artifact(int8_pair, jax_side,
                                                    tmp_path):
    """An int8 beam artifact (the flag rides in the meta's decode section)
    decodes the JAX int8 artifact's tokens, and the live decode's."""
    jcap8, cfg8 = int8_pair
    cap = port_captioner(cfg8, jax_side[1])
    jax_export_decoder(jcap8, str(tmp_path / "jax"), batch_size=8,
                       method="beam", beam_width=3, platforms=["cpu"])
    export_decoder(cap, str(tmp_path / "port"), batch_size=8, method="beam",
                   beam_width=3)
    ec = ExportedCaptioner.load(str(tmp_path / "port"), device="cpu")
    assert ec.meta["decode"]["int8_vocab_projection"] is True
    feats = _feats(cfg8, 8, seed=11)
    want = np.asarray(JaxExported.load(str(tmp_path / "jax"))
                      .decode_batch(feats))
    got = ec.decode_batch(feats)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, cap.decode_batch(feats, beam_width=3))


_JAX_INT8_BF16 = """
import json, sys
import jax, numpy as np
jax.config.update("jax_platforms", "cpu")
from vidcap_tpu.config import apply_overrides, get_preset
from vidcap_tpu.data.loader import CaptionDataset
from vidcap_tpu.inference import Captioner
over, out = json.loads(sys.argv[1]), sys.argv[2]
cfg = apply_overrides(get_preset("synthetic_tiny"), over)
cap = Captioner.from_checkpoint(cfg, CaptionDataset.synthetic(cfg.data),
                                checkpoint_dir=None)
flat = {}
def walk(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            walk(v, prefix + k + "/")
        else:
            flat[prefix + k] = np.asarray(v)
walk(cap.params)
np.savez(out + "/w.npz", **flat)
with open(out + "/caps.json", "w") as f:
    json.dump(cap.caption_dataset(method="beam", beam_width=5), f)
"""


def test_int8_beam_matches_jax_bfloat16(tmp_path):
    """bf16, the kernel decoder: K1's plain version then K2-int8's on the
    CPU against the JAX package's XLA beam with ``int8_logits``."""
    run_jax_scripts(_JAX_INT8_BF16, [(INT8, tmp_path)])
    want = json.loads((tmp_path / "caps.json").read_text())
    cfg = apply_overrides(get_preset("synthetic_tiny"), INT8)
    cap = Captioner.from_checkpoint(cfg, CaptionDataset.synthetic(cfg.data),
                                    weights=str(tmp_path / "w.npz"),
                                    device="cpu")
    assert cap.kernels("beam") == ("beam_core", "topk_project_int8")
    got = cap.caption_dataset(method="beam", beam_width=5)
    assert got.keys() == want.keys()
    same = sum(got[v] == want[v] for v in want)
    assert same >= 0.9 * len(want), (same, len(want))
