"""The route by the kernels' limits (``ops/limits.py``): each kernel says
which shapes it takes, from the constants its wrapper raises on, and
``models/decoding.py::route`` sends a shape no kernel takes through the
model's modules, as the JAX package decodes every width through XLA. On CPU-only shape tables (the H100's SMs and
shared memory for K3), then through ``Captioner`` on the CPU: the shapes
the kernels refuse (beam 9, the pool at beam 8, hidden 2080 for K2, 1024
for K3) decode through
the module route, with the tokens of the kernels' plain versions forced on
the same shapes (which have no limits on the CPU).
"""
import numpy as np
import pytest
import torch

from vidcap_tpu_torch.config import PRESETS, apply_overrides, get_preset
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.inference import Captioner
from test_torch_slice import force_kernel_route
from vidcap_tpu_torch.models import decoding
from vidcap_tpu_torch.models.model import create_model, init_params
from vidcap_tpu_torch.ops import limits
from vidcap_tpu_torch.ops.int8_proj import (MIN_STAGES, s8_smem_bytes,
                                            s8_stages)
from vidcap_tpu_torch.ops.limits import (beam_core_takes, rollout_takes,
                                         topk_project_int8_takes,
                                         topk_project_takes)


@pytest.mark.parametrize("beam,e,h,a,takes", [
    (5, 512, 512, 512, True), (8, 512, 512, 512, True),
    (9, 512, 512, 512, False), (0, 512, 512, 512, False),
    (5, 512, 1024, 512, True), (5, 512, 1000, 512, False),
    (5, 500, 512, 512, False), (5, 512, 512, 48, False)])
def test_k1_table(beam, e, h, a, takes):
    assert beam_core_takes(beam, e, h, a) is takes


@pytest.mark.parametrize("k,h,vp,k2,k2_int8", [
    (5, 512, 16_000, True, True), (8, 512, 12_032, True, True),
    (9, 512, 16_000, False, False), (6, 1024, 16_000, True, True),
    (5, 544, 16_000, True, True), (5, 520, 16_000, False, False),
    (5, 512, 16_004, False, True), (5, 512, 4, False, False),
    # K2-int8's edge: its block holds H/128 boxes of rows and >= 4 stages;
    # K2 streams rows past 512 up to 2,048
    (5, 1024, 16_000, True, True), (5, 1152, 16_000, True, True),
    (5, 1184, 16_000, True, False), (6, 2048, 16_000, True, False),
    (5, 2048, 163_840, True, False), (5, 2080, 16_000, False, False)])
def test_k2_and_k2_int8_tables(k, h, vp, k2, k2_int8):
    assert topk_project_takes(k, h, vp) is k2
    assert topk_project_int8_takes(k, h, vp) is k2_int8


def test_k2_int8_takes_exactly_what_its_shared_memory_holds():
    """Every multiple of 32 up to 4,096: K2-int8's predicate says yes
    exactly where the Python mirror of the kernel's shared memory fits in
    the H100's block, which is where its ring has at least 4 stages."""
    for h in range(32, 4097, 32):
        fits = s8_smem_bytes(h) <= limits.H100_SMEM
        assert topk_project_int8_takes(5, h, 16_000) is fits, h
        assert fits is (s8_stages(h) >= MIN_STAGES), h
    assert not topk_project_int8_takes(5, 1000, 16_000)


def test_k2_int8_shared_memory_mirrors_the_kernel_source():
    """ops/int8_proj.py's constants are those of csrc/topk_project.cu
    (kS8*, kProjRows, kProjCols), so the route and the kernel cannot
    disagree on what fits."""
    import os
    import re
    from vidcap_tpu_torch.ops import _build, int8_proj
    src = open(os.path.join(_build.CSRC, "topk_project.cu")).read()
    src += open(os.path.join(_build.CSRC, "projection.cuh")).read()
    src += open(os.path.join(_build.CSRC, "hopper.cuh")).read()

    def const(name):
        m = re.search(rf"constexpr int [^;]*\b{name} = ([^;,]+)[;,]", src)
        assert m, name
        return m.group(1).strip()

    env = {}
    for name in ("kSlabCols", "kWgCols", "kProjRows", "kProjCols", "kS8Rows",
                 "kS8Box", "kS8BTile", "kS8MinStages", "kS8MaxStages",
                 "kS8Side", "kS8SideBytes", "kS8Fixed", "kS8SmemCap"):
        env[name] = eval(const(name), {}, env)
    assert env["kS8Rows"] == int8_proj.TILE_ROWS
    assert env["kS8Box"] == int8_proj.DEPTH_BOX
    assert env["kS8BTile"] == int8_proj.STAGE_BYTES
    assert (env["kS8MinStages"], env["kS8MaxStages"]) == (
        int8_proj.MIN_STAGES, int8_proj.MAX_STAGES)
    assert env["kS8Fixed"] == int8_proj.FIXED
    assert env["kS8SmemCap"] == limits.H100_SMEM


@pytest.mark.parametrize("e,h,a,vp,t,takes", [
    (512, 512, 512, 12_032, 26, True),     # msvd_greedy / scst_cider
    (512, 512, 512, 65_536, 26, True),     # streamed W_out
    (512, 1024, 512, 16_000, 26, False),   # hidden over MAX_WIDTH
    (512, 512, 544, 16_000, 26, False),    # attention over MAX_WIDTH
    (520, 512, 512, 16_000, 26, False),    # embedding not a multiple of 32
    (512, 512, 512, 16_004, 26, False)])   # vocab not a multiple of 8
def test_k3_table_on_the_h100(e, h, a, vp, t, takes):
    assert rollout_takes(e, h, a, vp, t) is takes


def test_k3_takes_the_cards_sms_and_shared_memory():
    """A card with too few SMs, or too little shared memory for even the
    streamed mode, refuses what the H100 takes."""
    args = (512, 512, 512, 12_032, 26)
    assert rollout_takes(*args, sms=132, smem=limits.H100_SMEM)
    assert not rollout_takes(*args, sms=2 * limits.ROWS - 1)
    assert not rollout_takes(*args, smem=64 * 1024)


def _cfg(*over):
    return apply_overrides(get_preset("msrvtt_attn_beam5"), list(over))


def test_every_preset_takes_the_kernels_at_its_widths():
    """The presets' decoders at their widths, beam widths, frames and
    vocab: K1, K2 and K3 take them all, so their routes do not change."""
    for cfg in PRESETS.values():
        d, T = cfg.decode, cfg.data.num_frames
        with torch.device("meta"):
            dec = create_model(cfg, cfg.data.vocab_size).decoder
        assert dec.widths.lstm
        beam = decoding.route(dec, d, "beam", d.beam_width, T, "cpu")
        assert beam.recurrent == "beam_core"
        assert decoding.route(dec, d, "greedy", 1, T, "cpu").recurrent \
            == "rollout"
        assert beam.projection == ("topk_project_int8"
                                   if d.int8_vocab_projection
                                   else "topk_project")


@pytest.mark.parametrize("over,beam,want", [
    ([], 5, {"beam": ("beam_core", "topk_project"), "greedy": ("rollout",)}),
    ([], 9, {"beam": (), "greedy": ("rollout",)}),
    (["decode.finished_pool=on"], 7,
     {"beam": ("beam_core", "topk_project")}),
    (["decode.finished_pool=on"], 8, {"beam": ("beam_core",)}),
    (["model.hidden_dim=1024"], 5,
     {"beam": ("beam_core", "topk_project"), "greedy": ()}),
    (["model.hidden_dim=2080"], 5, {"beam": ("beam_core",), "greedy": ()}),
    (["model.hidden_dim=1024", "decode.int8_vocab_projection=true"], 5,
     {"beam": ("beam_core", "topk_project_int8")}),
    (["decode.int8_vocab_projection=true"], 9, {"beam": ()})])
def test_captioner_reports_the_route(over, beam, want):
    """``Captioner.kernels`` at msrvtt_attn_beam5's widths (on the meta
    device: nothing allocated): what launches on the card for each shape."""
    cfg = _cfg(*over)
    ds = CaptionDataset.synthetic(cfg.data, num_videos=2)
    with torch.device("meta"):
        model = create_model(cfg, cfg.data.vocab_size)
    cap = Captioner(cfg, model, ds, torch.device("cpu"))
    for method, kernels in want.items():
        assert cap.kernels(method, beam) == kernels, method


def _tiny(over):
    cfg = apply_overrides(get_preset("synthetic_tiny"), over)
    ds = CaptionDataset.synthetic(cfg.data, num_videos=4)
    return Captioner(cfg, init_params(create_model(cfg, ds.vocab.size),
                                      seed=2).eval(), ds,
                     torch.device("cpu"), seed=3)


@pytest.mark.parametrize("over,beam,method,route", [
    ([], 9, "beam", "module_beam_step"),
    (["decode.finished_pool=on"], 8, "beam", "fused_beam_step"),
    (["decode.int8_vocab_projection=true"], 9, "beam",
     "module_beam_step"),
    (["model.hidden_dim=2080"], 3, "beam", "fused_beam_step"),
    (["model.hidden_dim=1024"], 3, "greedy", "greedy_decode")])
def test_refused_shapes_decode_through_the_modules(monkeypatch, over, beam,
                                                   method, route):
    """On the CPU, at synthetic_tiny's vocab (hidden 2080 or 1024 where
    named):
    the step each refused shape takes, a projection through no kernel, and
    the tokens of the kernels' plain versions forced on the same shape."""
    cap = _tiny(over)
    feats = np.random.default_rng(1).normal(size=(4, 8, 64)).astype(
        np.float32)
    calls = []
    import vidcap_tpu_torch.inference as inference
    import vidcap_tpu_torch.models.model as model_mod
    # K1's step is the Captioner's; the module step the model's beam
    # surface; the greedy loop the rollout's (models/decoding.py)
    for mod, name in ((inference, "fused_beam_step"),
                      (model_mod, "module_beam_step"),
                      (decoding, "greedy_decode")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name,
                            **k: (calls.append(_n), _r(*a, **k))[1])
    got = cap.decode_batch(feats, method=method, beam_width=beam)
    assert calls == [route]
    if method == "beam":
        assert cap._vocab_proj.kernel is None
    # the kernels' plain versions on the same shape: the same tokens
    forced = _tiny(over)
    force_kernel_route(monkeypatch)
    np.testing.assert_array_equal(
        forced.decode_batch(feats, method=method, beam_width=beam), got)

