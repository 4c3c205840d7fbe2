"""Weight bridge between the Flax parameter tree and the PyTorch model.

The port names its parameters as the Flax tree does (``decoder/embed/
embedding``, ``decoder/feat_proj/kernel``, ``decoder/lstm0/w``,
``decoder/attention/query/kernel``, ``decoder/out_proj/{kernel,bias}``,
``attr_head/fc1/kernel`` …) and keeps Flax's ``[in, out]`` kernel layout, so
a tree maps onto ``state_dict`` by joining the path with "." — no transposes.

The file format is a flat ``.npz`` whose keys are the "/"-joined Flax paths:
a file written from JAX by ``np.savez(path, **flat)`` loads here, and
:func:`save_weights` writes the same layout.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts of arrays → {"a/b/c": np.ndarray}."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, path + "/"))
        else:
            flat[path] = np.asarray(v)
    return flat


def load_flat(model: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Fill ``model`` from "/"-keyed arrays. Every parameter must be present
    with its exact shape, and no key may be left over."""
    params = dict(model.named_parameters())
    want = {name.replace(".", "/"): p for name, p in params.items()}
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"weight names do not match the model: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    with torch.no_grad():
        for key, p in want.items():
            arr = np.asarray(flat[key], dtype=np.float32)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{key}: shape {arr.shape} in the weights, "
                                 f"{tuple(p.shape)} in the model")
            p.copy_(torch.tensor(arr))
    return model


def from_flax(model: nn.Module, tree: Mapping) -> nn.Module:
    """Fill ``model`` from the JAX package's parameter tree (nested dicts of
    numpy arrays, as ``init_params`` or a checkpoint restore returns it)."""
    return load_flat(model, flatten_tree(tree))


def to_flat(model: nn.Module) -> Dict[str, np.ndarray]:
    return {name.replace(".", "/"): p.detach().cpu().numpy()
            for name, p in model.named_parameters()}


def save_weights(model: nn.Module, path: str) -> None:
    np.savez(path, **to_flat(model))


def load_weights(model: nn.Module, path: str) -> nn.Module:
    with np.load(path) as f:
        return load_flat(model, {k: f[k] for k in f.files})
