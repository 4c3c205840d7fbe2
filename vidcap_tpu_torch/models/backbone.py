"""Inception-ResNet-v2 video-frame encoder, in PyTorch.

Mirrors ``vidcap_tpu/models/backbone.py`` module for module and rounding
point for rounding point: stem → mixed_5b → ``depth[0]``× Block35 →
reduction-A → ``depth[1]``× Block17 → reduction-B → ``depth[2]``× Block8
(the last with scale 1.0 and no ReLU) → 1×1 conv to ``1536·width_mult`` →
global average pool. Output: the pooled per-frame feature f32[N, D].

* Parameters are named as the Flax tree (``stem_conv1/conv/kernel``,
  ``block35_0/b0_1x1/bn_scale`` …). Conv kernels are stored as PyTorch's
  OIHW; ``convert.py`` transposes them from and to Flax's HWIO.
* ``ConvBN``: the convolution in ``compute_dtype``, its output rounded to
  it; then f32 ``* bn_scale + bn_offset`` (frozen-statistics batch norm),
  ReLU and a cast back to ``compute_dtype``.
* Residuals ``x + scale · up`` and the average pool (which counts the
  padding, as Flax's ``avg_pool(..., "SAME")`` does) round in
  ``compute_dtype`` at each addition; the global pool is an f32 mean. On
  the CPU, bf16 outputs equal the JAX package's bit for bit (XLA's excess
  precision off).
* ``width_mult`` scales the stem, the reductions and ``conv7b`` only; the
  blocks' inner widths are fixed, as in the reference.
* ``remat_every`` = N recomputes every Nth residual block in the backward
  pass (``torch.utils.checkpoint``) instead of keeping its activations; it
  changes neither the parameters nor the outputs.

Activations are logically NCHW and channels-last in memory: the reference's
NHWC input permuted to NCHW is already channels-last, which is the layout
cuDNN's bf16 convolutions take.
"""
from __future__ import annotations

import os
import sys
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


class Conv(nn.Module):
    """Flax ``nn.Conv(use_bias=False)``: ``kernel`` f32[out, in, kh, kw]."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int]):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cout, cin, *kernel))


def _conv(x: torch.Tensor, w: torch.Tensor, stride, padding, cd):
    """The convolution in ``cd``, its output rounded to ``cd``. The CPU's
    bf16 convolution rounds partial sums where XLA and cuDNN accumulate in
    f32 and round once, so on the CPU it runs in f32 on the rounded operands
    and rounds after."""
    w = w.to(cd)
    if x.is_cuda or cd == torch.float32:
        return F.conv2d(x, w.contiguous(memory_format=torch.channels_last),
                        stride=stride, padding=padding)
    return F.conv2d(x.float(), w.float(), stride=stride,
                    padding=padding).to(cd)


class ConvBN(nn.Module):
    """conv → frozen-statistics batch norm (scale, offset) → ReLU."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), strides=(1, 1),
                 padding: str = "SAME", use_relu: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if padding == "SAME" and tuple(strides) != (1, 1):
            raise ValueError("SAME padding is used at stride 1 only")
        self.conv = Conv(cin, cout, kernel)
        self.bn_scale = nn.Parameter(torch.ones(cout))
        self.bn_offset = nn.Parameter(torch.zeros(cout))
        self.strides = tuple(strides)
        # SAME at stride 1 with odd kernels: k // 2 on each side
        self.padding = ((kernel[0] // 2, kernel[1] // 2) if padding == "SAME"
                        else (0, 0))
        self.use_relu = use_relu
        self.cd = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv(x, self.conv.kernel, self.strides, self.padding, self.cd)
        y = y.float() * self.bn_scale[:, None, None] \
            + self.bn_offset[:, None, None]
        if self.use_relu:
            y = torch.relu(y)
        return y.to(self.cd)


def _scalar(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``: JAX casts a Python scalar to the array's
    dtype before the product, PyTorch multiplies by it in f32. Rounded on
    the CPU, so that a model built on the meta device (``info``'s census)
    can hold it."""
    return float(torch.tensor(v, dtype=dtype, device="cpu"))


class Block35(nn.Module):
    """Inception-A residual block (35×35 grid)."""

    def __init__(self, c: int, scale: float = 0.17,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cd = dict(compute_dtype=compute_dtype)
        self.b0_1x1 = ConvBN(c, 32, (1, 1), **cd)
        self.b1_1x1 = ConvBN(c, 32, (1, 1), **cd)
        self.b1_3x3 = ConvBN(32, 32, (3, 3), **cd)
        self.b2_1x1 = ConvBN(c, 32, (1, 1), **cd)
        self.b2_3x3a = ConvBN(32, 48, (3, 3), **cd)
        self.b2_3x3b = ConvBN(48, 64, (3, 3), **cd)
        self.up = ConvBN(128, c, (1, 1), use_relu=False, **cd)
        self.scale = _scalar(scale, compute_dtype)

    def forward(self, x):
        mixed = torch.cat([self.b0_1x1(x), self.b1_3x3(self.b1_1x1(x)),
                           self.b2_3x3b(self.b2_3x3a(self.b2_1x1(x)))], 1)
        return torch.relu(x + self.scale * self.up(mixed))


class Block17(nn.Module):
    """Inception-B residual block (17×17 grid)."""

    def __init__(self, c: int, scale: float = 0.10,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cd = dict(compute_dtype=compute_dtype)
        self.b0_1x1 = ConvBN(c, 192, (1, 1), **cd)
        self.b1_1x1 = ConvBN(c, 128, (1, 1), **cd)
        self.b1_1x7 = ConvBN(128, 160, (1, 7), **cd)
        self.b1_7x1 = ConvBN(160, 192, (7, 1), **cd)
        self.up = ConvBN(384, c, (1, 1), use_relu=False, **cd)
        self.scale = _scalar(scale, compute_dtype)

    def forward(self, x):
        mixed = torch.cat([self.b0_1x1(x),
                           self.b1_7x1(self.b1_1x7(self.b1_1x1(x)))], 1)
        return torch.relu(x + self.scale * self.up(mixed))


class Block8(nn.Module):
    """Inception-C residual block (8×8 grid)."""

    def __init__(self, c: int, scale: float = 0.20, use_relu: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cd = dict(compute_dtype=compute_dtype)
        self.b0_1x1 = ConvBN(c, 192, (1, 1), **cd)
        self.b1_1x1 = ConvBN(c, 192, (1, 1), **cd)
        self.b1_1x3 = ConvBN(192, 224, (1, 3), **cd)
        self.b1_3x1 = ConvBN(224, 256, (3, 1), **cd)
        self.up = ConvBN(448, c, (1, 1), use_relu=False, **cd)
        self.scale = _scalar(scale, compute_dtype)
        self.use_relu = use_relu

    def forward(self, x):
        mixed = torch.cat([self.b0_1x1(x),
                           self.b1_3x1(self.b1_1x3(self.b1_1x1(x)))], 1)
        out = x + self.scale * self.up(mixed)
        return torch.relu(out) if self.use_relu else out


def _maxpool(x):
    return F.max_pool2d(x, 3, 2)


def _avgpool_same(x):
    """Flax ``avg_pool(x, (3, 3), (1, 1), "SAME")``: the window's nine
    values (the padding as zeros) added one by one in the input dtype, in
    row-major window order as XLA's reduce-window adds them, then divided
    by 9."""
    H, W = x.shape[2:]
    xp = F.pad(x, (1, 1, 1, 1))
    s = xp[:, :, :H, :W]
    for i in range(3):
        for j in range(3):
            if i or j:
                s = s + xp[:, :, i:i + H, j:j + W]
    return s / 9


class InceptionResNetV2(nn.Module):
    """``forward(x)``: f32[N, H, W, 3] in [-1, 1] → f32[N, 1536·width_mult]."""

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16,
                 width_mult: float = 1.0,
                 depth: Tuple[int, int, int] = (10, 20, 10),
                 remat_every: int = 1):
        super().__init__()
        self.cd = compute_dtype
        self.depth = tuple(depth)
        self.remat_every = remat_every
        w = lambda f: max(int(f * width_mult), 8)
        cd = dict(compute_dtype=compute_dtype)
        valid = dict(padding="VALID", **cd)
        add = self.add_module
        # stem (299 → 35 grid)
        add("stem_conv1", ConvBN(3, w(32), (3, 3), (2, 2), **valid))
        add("stem_conv2", ConvBN(w(32), w(32), (3, 3), **valid))
        add("stem_conv3", ConvBN(w(32), w(64), (3, 3), **cd))
        add("stem_conv4", ConvBN(w(64), w(80), (1, 1), **valid))
        add("stem_conv5", ConvBN(w(80), w(192), (3, 3), **valid))
        # mixed_5b
        c = w(192)
        add("m5b_b0", ConvBN(c, w(96), (1, 1), **cd))
        add("m5b_b1a", ConvBN(c, w(48), (1, 1), **cd))
        add("m5b_b1b", ConvBN(w(48), w(64), (5, 5), **cd))
        add("m5b_b2a", ConvBN(c, w(64), (1, 1), **cd))
        add("m5b_b2b", ConvBN(w(64), w(96), (3, 3), **cd))
        add("m5b_b2c", ConvBN(w(96), w(96), (3, 3), **cd))
        add("m5b_b3", ConvBN(c, w(64), (1, 1), **cd))
        c35 = w(96) + w(64) + w(96) + w(64)
        for i in range(depth[0]):
            add(f"block35_{i}", Block35(c35, **cd))
        # reduction-A (35 → 17)
        add("redA_b0", ConvBN(c35, w(384), (3, 3), (2, 2), **valid))
        add("redA_b1a", ConvBN(c35, w(256), (1, 1), **cd))
        add("redA_b1b", ConvBN(w(256), w(256), (3, 3), **cd))
        add("redA_b1c", ConvBN(w(256), w(384), (3, 3), (2, 2), **valid))
        c17 = w(384) + w(384) + c35
        for i in range(depth[1]):
            add(f"block17_{i}", Block17(c17, **cd))
        # reduction-B (17 → 8)
        add("redB_b0a", ConvBN(c17, w(256), (1, 1), **cd))
        add("redB_b0b", ConvBN(w(256), w(384), (3, 3), (2, 2), **valid))
        add("redB_b1a", ConvBN(c17, w(256), (1, 1), **cd))
        add("redB_b1b", ConvBN(w(256), w(288), (3, 3), (2, 2), **valid))
        add("redB_b2a", ConvBN(c17, w(256), (1, 1), **cd))
        add("redB_b2b", ConvBN(w(256), w(288), (3, 3), **cd))
        add("redB_b2c", ConvBN(w(288), w(320), (3, 3), (2, 2), **valid))
        c8 = w(384) + w(288) + w(320) + c17
        for i in range(depth[2] - 1):
            add(f"block8_{i}", Block8(c8, **cd))
        # the last block8: unscaled, no ReLU, never recomputed
        add(f"block8_{depth[2] - 1}", Block8(c8, scale=1.0, use_relu=False,
                                             **cd))
        add("conv7b", ConvBN(c8, w(1536), (1, 1), **cd))
        self.out_dim = w(1536)

    def _blocks(self, x, kind: str, n: int):
        for i in range(n):
            block = getattr(self, f"{kind}_{i}")
            if self.remat_every and i % self.remat_every == 0:
                # the backbone draws no random numbers: no RNG state to keep
                # (reading it is not allowed inside a CUDA graph capture)
                x = checkpoint(block, x, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = block(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.cd).permute(0, 3, 1, 2)    # NCHW, channels-last memory
        x = self.stem_conv3(self.stem_conv2(self.stem_conv1(x)))
        x = self.stem_conv5(self.stem_conv4(_maxpool(x)))
        x = _maxpool(x)
        x = torch.cat([self.m5b_b0(x), self.m5b_b1b(self.m5b_b1a(x)),
                       self.m5b_b2c(self.m5b_b2b(self.m5b_b2a(x))),
                       self.m5b_b3(_avgpool_same(x))], 1)
        x = self._blocks(x, "block35", self.depth[0])
        x = torch.cat([self.redA_b0(x),
                       self.redA_b1c(self.redA_b1b(self.redA_b1a(x))),
                       _maxpool(x)], 1)
        x = self._blocks(x, "block17", self.depth[1])
        x = torch.cat([self.redB_b0b(self.redB_b0a(x)),
                       self.redB_b1b(self.redB_b1a(x)),
                       self.redB_b2c(self.redB_b2b(self.redB_b2a(x))),
                       _maxpool(x)], 1)
        x = self._blocks(x, "block8", self.depth[2] - 1)
        x = getattr(self, f"block8_{self.depth[2] - 1}")(x)
        x = self.conv7b(x)
        return x.float().mean(dim=(2, 3))          # global average pool


@torch.no_grad()
def init_backbone(backbone: nn.Module, rng: np.random.Generator) -> None:
    """Flax's initializers: conv kernels lecun-normal (truncated, std
    1/sqrt(kh·kw·in)), ``bn_scale`` 1, ``bn_offset`` 0. The draws differ
    from JAX's."""
    from vidcap_tpu_torch.models.model import truncated_normal
    for mod in backbone.modules():
        if isinstance(mod, Conv):
            o, i, kh, kw = mod.kernel.shape
            mod.kernel.copy_(torch.from_numpy(truncated_normal(
                rng, (o, i, kh, kw), 1.0 / np.sqrt(kh * kw * i))))
        elif isinstance(mod, ConvBN):
            mod.bn_scale.fill_(1.0)
            mod.bn_offset.zero_()


def load_backbone_params(backbone: nn.Module, cfg,
                         weights_path: Optional[str] = None,
                         seed: int = 0) -> nn.Module:
    """Fill ``backbone`` from ImageNet weights in an ``.npz`` (``weights_path``,
    else ``$VIDCAP_IRV2_WEIGHTS``, else ``{data_dir}/irv2_imagenet.npz``:
    the layout :func:`save_backbone_params` and the JAX package's write),
    else from a fresh init drawn from ``seed``, with a warning."""
    from vidcap_tpu_torch.convert import load_flat
    weights_path = weights_path or os.environ.get(
        "VIDCAP_IRV2_WEIGHTS",
        os.path.join(cfg.data.data_dir, "irv2_imagenet.npz"))
    if os.path.exists(weights_path):
        with np.load(weights_path) as f:
            load_flat(backbone, {k: f[k] for k in f.files})
        print(f"[vidcap] loaded backbone weights from {weights_path}",
              file=sys.stderr)
    else:
        init_backbone(backbone, np.random.default_rng(seed))
        print(f"[vidcap] WARNING: no ImageNet weights at {weights_path}; "
              f"backbone is randomly initialized", file=sys.stderr)
    return backbone


def save_backbone_params(backbone: nn.Module, path: str) -> None:
    """The backbone's parameters as a flat ``.npz`` of "/"-joined Flax paths,
    conv kernels in Flax's HWIO (what ``load_backbone_params`` reads, here
    and in the JAX package)."""
    from vidcap_tpu_torch.convert import to_flat
    np.savez(path, **to_flat(backbone))
