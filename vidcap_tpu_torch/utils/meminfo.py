"""Preset preflight census for the CLI ``info`` command, a copy of
``vidcap_tpu/utils/meminfo.py`` for the port.

Parameter counts come from the real model built on the ``meta`` device: no
weight is allocated, so ``info`` answers at once even for the 76M-parameter
pixel presets. The memory numbers are the JAX package's rough estimates of
the dominant live buffers (the same formulas), not an accounting of the
card's allocator: they catch "this preset cannot fit this card" before a
run, and size the batch and ``grad_accum``. The port's counterpart of the
JAX compile cache is the nvcc build directory of its kernels
(``ops/_build.py``: ``build/vidcap_tpu_torch`` at the root of the checkout).
"""
from __future__ import annotations

import os
from typing import Dict

import torch


def param_census(cfg, vocab_size: int | None = None) -> Dict[str, int]:
    """{top-level parameter group (``backbone``, ``decoder``,
    ``attr_head``): parameter count} + '_total', with every tensor on the
    meta device."""
    from vidcap_tpu_torch.models.model import create_model

    with torch.device("meta"):
        model = create_model(cfg, vocab_size=vocab_size
                             or cfg.data.vocab_size)
    census: Dict[str, int] = {}
    for name, p in model.named_parameters():
        group = name.split(".", 1)[0]
        census[group] = census.get(group, 0) + p.numel()
    census = dict(sorted(census.items()))   # the Flax tree's order
    census["_total"] = sum(census.values())
    return census


def train_memory_estimate(cfg, n_params: int) -> Dict[str, float]:
    """Rough dominant-buffer bytes for one train step at the preset's
    (micro)batch. Pixel presets count the IRv2 remat-boundary activations;
    feature presets the XE logits and their gradient (the only activation
    of consequence at T <= 45, L <= 30)."""
    B = max(1, cfg.train.batch_size // max(1, cfg.train.grad_accum))
    T, L = cfg.data.num_frames, cfg.data.max_caption_len
    pv = cfg.data.padded_vocab
    params = n_params * 4.0              # f32 master
    adam = n_params * 8.0                # m + v
    grads = n_params * 4.0
    if cfg.model.use_backbone:
        S = cfg.data.frame_size
        frames = B * T
        stem = 147 * 147 * 32 + 73 * 73 * 80 + 35 * 35 * 320
        saved = (10 * 35 * 35 * 320 + 20 * 17 * 17 * 1088
                 + 10 * 8 * 8 * 2080)    # remat-boundary block inputs
        acts = frames * (stem + saved) * 4.0
        inputs = frames * S * S * 3 * 4.0
    else:
        acts = B * L * pv * 8.0          # XE logits f32 + their grad
        inputs = B * T * cfg.data.feature_dim * 4.0
    total = params + adam + grads + acts + inputs
    return {"params": params, "optimizer": adam, "grads": grads,
            "activations": acts, "inputs": inputs, "total": total}


def decode_buffer_estimate(cfg) -> Dict[str, float]:
    """The [B·K, padded_vocab] per-step logits of a beam decode at the
    preset's batch, had they been written out (K2 keeps them in registers;
    the decoders no kernel covers write them)."""
    B, K = cfg.train.batch_size, cfg.decode.beam_width
    pv = cfg.data.padded_vocab
    itemsize = 2 if cfg.model.compute_dtype == "bfloat16" else 4
    return {"beam_logits_rows": float(B * K), "padded_vocab": float(pv),
            "beam_logits_bytes": float(B * K * pv * itemsize)}


def build_cache_stats() -> Dict[str, float]:
    """Entries and bytes of the kernels' nvcc build directory."""
    from vidcap_tpu_torch.ops._build import BUILD_DIR
    if not os.path.isdir(BUILD_DIR):
        return {"path": BUILD_DIR, "entries": 0, "bytes": 0}
    entries, size = 0, 0
    for root, _dirs, files in os.walk(BUILD_DIR):
        for f in files:
            entries += 1
            try:
                size += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return {"path": BUILD_DIR, "entries": entries, "bytes": size}
