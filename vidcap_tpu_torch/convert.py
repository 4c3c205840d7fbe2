"""Weight bridge between the Flax parameter tree and the PyTorch model, and
the conversion of TF-slim / TF1 checkpoints into it.

The port names its parameters as the Flax tree does (``decoder/embed/
embedding``, ``decoder/feat_proj/kernel``, ``decoder/lstm0/w``,
``decoder/attention/query/kernel``, ``decoder/out_proj/{kernel,bias}``,
``attr_head/fc1/kernel``, ``backbone/stem_conv1/conv/kernel`` …), so a tree
maps onto ``state_dict`` by joining the path with ".". Dense kernels keep
Flax's ``[in, out]`` layout. Convolution kernels (4-D ``…/conv/kernel``) are
PyTorch's OIHW in the model and Flax's HWIO in every file and tree: the
bridge (:func:`load_flat`, :func:`to_flat` and the functions on them)
transposes them, and nothing else.

The file format is a flat ``.npz`` whose keys are the "/"-joined Flax paths:
a file written from JAX by ``np.savez(path, **flat)`` (or the JAX package's
``save_backbone_params``) loads here, and :func:`save_weights` writes the
same layout.

The TF-slim conversion is a copy of ``vidcap_tpu/convert.py``'s, on nested
dicts of numpy arrays:

  * :func:`convert_irv2` — TF-slim IRv2 variables → backbone params. Batch
    norm is folded into ConvBN's (scale, offset): ``scale = gamma /
    sqrt(var + eps)``, ``offset = beta - mean * scale`` (slim's IRv2 uses
    scale=False → gamma ≡ 1). The residual up-projections (``Conv2d_1x1``
    in block35/17/8) have a bias and no BN in slim: ``scale = 1, offset =
    bias``.
  * :func:`convert_decoder` — TF1 decoder variables → decoder params,
    including the LSTM gate permutation: TF ``BasicLSTMCell`` orders gates
    (i, j, f, o), the decoder (i, f, g≡j, o). Both add +1.0 to the forget
    gate at run time, so biases move with the same permutation only.

Checkpoints are read with TF2's ``tf.train.load_checkpoint`` (TF1 .ckpt
V1/V2) when TF is importable, and as plain ``.npz`` name→array archives
otherwise. The slim name map follows the public tf-slim
``nets/inception_resnet_v2.py`` layout, as the reference's does.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

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


def _is_conv_kernel(key: str, arr) -> bool:
    return key.endswith("conv/kernel") and np.ndim(arr) == 4


def _hwio_to_oihw(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1)))


def _oihw_to_hwio(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0)))


def load_flat(model: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Fill ``model`` from "/"-keyed arrays (conv kernels in HWIO). Every
    parameter must be present with its exact shape, and no key may be left
    over."""
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
            if _is_conv_kernel(key, arr):
                arr = _hwio_to_oihw(arr)
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
    """The model's parameters as "/"-keyed arrays, conv kernels in HWIO."""
    flat = {}
    for name, p in model.named_parameters():
        key, arr = name.replace(".", "/"), p.detach().cpu().numpy()
        flat[key] = _oihw_to_hwio(arr) if _is_conv_kernel(key, arr) else arr
    return flat


def save_weights(model: nn.Module, path: str) -> None:
    np.savez(path, **to_flat(model))


def load_weights(model: nn.Module, path: str) -> nn.Module:
    with np.load(path) as f:
        return load_flat(model, {k: f[k] for k in f.files})


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict:
    """{"a/b/c": array} → nested dicts (the inverse of :func:`flatten_tree`)."""
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def _copy_tree(tree: Mapping) -> Dict:
    return {k: _copy_tree(v) if isinstance(v, Mapping)
            else np.array(v, copy=True) for k, v in tree.items()}


# ------------------------------------------------- TF-slim / TF1 checkpoints

BN_EPS = 0.001   # slim inception arg_scope batch_norm epsilon
SLIM_PREFIX = "InceptionResnetV2"


def read_tf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """name → np.ndarray from a TF checkpoint (V1/V2 .ckpt) or .npz archive."""
    if path.endswith(".npz"):
        return dict(np.load(path))
    import tensorflow as tf  # TF 2.x reads TF1 checkpoints
    reader = tf.train.load_checkpoint(path)
    shapes = reader.get_variable_to_shape_map()
    return {name: np.asarray(reader.get_tensor(name)) for name in shapes}


def fold_batchnorm(mean: np.ndarray, var: np.ndarray, beta: np.ndarray,
                   gamma: Optional[np.ndarray] = None, eps: float = BN_EPS
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Frozen-stats BN → the (scale, offset) pair ConvBN applies after the
    conv."""
    g = gamma if gamma is not None else np.ones_like(mean)
    scale = g / np.sqrt(var + eps)
    return scale.astype(np.float32), (beta - mean * scale).astype(np.float32)


def _block_maps() -> Dict[str, Dict[str, str]]:
    return {
        "block35": {"b0_1x1": "Branch_0/Conv2d_1x1",
                    "b1_1x1": "Branch_1/Conv2d_0a_1x1",
                    "b1_3x3": "Branch_1/Conv2d_0b_3x3",
                    "b2_1x1": "Branch_2/Conv2d_0a_1x1",
                    "b2_3x3a": "Branch_2/Conv2d_0b_3x3",
                    "b2_3x3b": "Branch_2/Conv2d_0c_3x3",
                    "up": "Conv2d_1x1"},
        "block17": {"b0_1x1": "Branch_0/Conv2d_1x1",
                    "b1_1x1": "Branch_1/Conv2d_0a_1x1",
                    "b1_1x7": "Branch_1/Conv2d_0b_1x7",
                    "b1_7x1": "Branch_1/Conv2d_0c_7x1",
                    "up": "Conv2d_1x1"},
        "block8": {"b0_1x1": "Branch_0/Conv2d_1x1",
                   "b1_1x1": "Branch_1/Conv2d_0a_1x1",
                   "b1_1x3": "Branch_1/Conv2d_0b_1x3",
                   "b1_3x1": "Branch_1/Conv2d_0c_3x1",
                   "up": "Conv2d_1x1"},
    }


def irv2_slim_name_map(depth: Tuple[int, int, int] = (10, 20, 10)
                       ) -> Dict[str, str]:
    """Backbone module path → slim variable scope (without the prefix): the
    slim conv scope whose ``weights`` + ``BatchNorm/*`` (or ``biases``) the
    ConvBN folds."""
    m: Dict[str, str] = {
        "stem_conv1": "Conv2d_1a_3x3",
        "stem_conv2": "Conv2d_2a_3x3",
        "stem_conv3": "Conv2d_2b_3x3",
        "stem_conv4": "Conv2d_3b_1x1",
        "stem_conv5": "Conv2d_4a_3x3",
        "m5b_b0": "Mixed_5b/Branch_0/Conv2d_1x1",
        "m5b_b1a": "Mixed_5b/Branch_1/Conv2d_0a_1x1",
        "m5b_b1b": "Mixed_5b/Branch_1/Conv2d_0b_5x5",
        "m5b_b2a": "Mixed_5b/Branch_2/Conv2d_0a_1x1",
        "m5b_b2b": "Mixed_5b/Branch_2/Conv2d_0b_3x3",
        "m5b_b2c": "Mixed_5b/Branch_2/Conv2d_0c_3x3",
        "m5b_b3": "Mixed_5b/Branch_3/Conv2d_0b_1x1",
        "redA_b0": "Mixed_6a/Branch_0/Conv2d_1a_3x3",
        "redA_b1a": "Mixed_6a/Branch_1/Conv2d_0a_1x1",
        "redA_b1b": "Mixed_6a/Branch_1/Conv2d_0b_3x3",
        "redA_b1c": "Mixed_6a/Branch_1/Conv2d_1a_3x3",
        "redB_b0a": "Mixed_7a/Branch_0/Conv2d_0a_1x1",
        "redB_b0b": "Mixed_7a/Branch_0/Conv2d_1a_3x3",
        "redB_b1a": "Mixed_7a/Branch_1/Conv2d_0a_1x1",
        "redB_b1b": "Mixed_7a/Branch_1/Conv2d_1a_3x3",
        "redB_b2a": "Mixed_7a/Branch_2/Conv2d_0a_1x1",
        "redB_b2b": "Mixed_7a/Branch_2/Conv2d_0b_3x3",
        "redB_b2c": "Mixed_7a/Branch_2/Conv2d_1a_3x3",
        "conv7b": "Conv2d_7b_1x1",
    }
    blocks = _block_maps()
    for i in range(depth[0]):
        for sub, slim in blocks["block35"].items():
            m[f"block35_{i}/{sub}"] = f"Repeat/block35_{i + 1}/{slim}"
    for i in range(depth[1]):
        for sub, slim in blocks["block17"].items():
            m[f"block17_{i}/{sub}"] = f"Repeat_1/block17_{i + 1}/{slim}"
    for i in range(depth[2] - 1):
        for sub, slim in blocks["block8"].items():
            m[f"block8_{i}/{sub}"] = f"Repeat_2/block8_{i + 1}/{slim}"
    # the final, unscaled block8 sits outside Repeat_2 in slim
    for sub, slim in blocks["block8"].items():
        m[f"block8_{depth[2] - 1}/{sub}"] = f"Block8/{slim}"
    return m


def convert_irv2(tf_vars: Mapping[str, np.ndarray], flax_template,
                 prefix: str = SLIM_PREFIX, eps: float = BN_EPS):
    """TF-slim IRv2 variables → backbone params (nested dicts, conv kernels
    HWIO) matching ``flax_template``, which gives the module inventory and
    the shapes. Raises KeyError listing the missing slim variables,
    ValueError on a shape mismatch."""
    name_map = irv2_slim_name_map(_infer_depth(flax_template))
    missing: List[str] = []
    out = _copy_tree(flax_template)

    def full_name(name):
        return f"{prefix}/{name}" if prefix else name

    def get(name):
        full = full_name(name)
        if full not in tf_vars:
            missing.append(full)
            return None
        return np.asarray(tf_vars[full])

    for flax_path, slim_scope in name_map.items():
        node = out
        for part in flax_path.split("/"):
            if part not in node:
                raise ValueError(
                    f"flax template has no module {flax_path!r} "
                    f"(missing {part!r}); template/map out of sync")
            node = node[part]
        kernel = get(f"{slim_scope}/weights")            # HWIO, as Flax
        if full_name(f"{slim_scope}/BatchNorm/moving_mean") in tf_vars:
            mean = get(f"{slim_scope}/BatchNorm/moving_mean")
            var = get(f"{slim_scope}/BatchNorm/moving_variance")
            beta = get(f"{slim_scope}/BatchNorm/beta")
            gkey = full_name(f"{slim_scope}/BatchNorm/gamma")
            gamma = np.asarray(tf_vars[gkey]) if gkey in tf_vars else None
            if mean is None or var is None or beta is None:
                continue
            scale, offset = fold_batchnorm(mean, var, beta, gamma, eps)
        else:
            bias = get(f"{slim_scope}/biases")           # up-convs: bias, no BN
            if bias is None:
                continue
            scale = np.ones_like(bias, np.float32)
            offset = bias.astype(np.float32)
        if kernel is None:
            continue
        _check_shape(flax_path + "/conv/kernel",
                     node["conv"]["kernel"].shape, kernel.shape)
        _check_shape(flax_path + "/bn_scale",
                     node["bn_scale"].shape, scale.shape)
        node["conv"]["kernel"] = kernel.astype(np.float32)
        node["bn_scale"] = scale
        node["bn_offset"] = offset

    if missing:
        raise KeyError(f"{len(missing)} slim variables absent from the "
                       f"checkpoint, first 10: {missing[:10]}")
    return out


def _infer_depth(flax_template) -> Tuple[int, int, int]:
    keys = list(flax_template)
    d = lambda kind: sum(1 for k in keys if re.fullmatch(rf"{kind}_\d+", k))
    return (d("block35"), d("block17"), d("block8"))


def _check_shape(what: str, want, got) -> None:
    if tuple(want) != tuple(got):
        raise ValueError(f"{what}: template shape {tuple(want)} != "
                         f"checkpoint shape {tuple(got)}")


def tf_lstm_gates_to_flax(w: np.ndarray, b: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """TF BasicLSTMCell fused kernel [(in+H), 4H], gate order (i, j, f, o) →
    the decoder's (i, f, g≡j, o). The forget bias stays as it is: both add
    +1.0 at run time."""
    four_h = w.shape[-1]
    if four_h % 4:
        raise ValueError(f"LSTM kernel of shape {w.shape}: the gate axis is "
                         "not a multiple of 4")
    H = four_h // 4
    i, j, f, o = (w[:, k * H:(k + 1) * H] for k in range(4))
    bi, bj, bf, bo = (b[k * H:(k + 1) * H] for k in range(4))
    return (np.concatenate([i, f, j, o], axis=-1),
            np.concatenate([bi, bf, bj, bo], axis=-1))


#: Default TF1 variable names of this research lineage's decoders; override
#: with the real names of a given checkpoint.
DEFAULT_DECODER_MAP = {
    "embed": "Wemb",
    "lstm_kernel": "lstm/basic_lstm_cell/kernel",
    "lstm_bias": "lstm/basic_lstm_cell/bias",
    "out_w": "embed_word_W",
    "out_b": "embed_word_b",
    "feat_w": "encode_image_W",
    "feat_b": "encode_image_b",
    "attn_key_w": "attention/key_W",
    "attn_query_w": "attention/query_W",
    "attn_u": "attention/v",
    "init_w": "init_state_W",
    "init_b": "init_state_b",
}


def convert_decoder(tf_vars: Mapping[str, np.ndarray], flax_decoder_params,
                    name_map: Optional[Mapping[str, str]] = None,
                    vocab_size: Optional[int] = None):
    """TF1 decoder variables → decoder params (nested dicts).

    The vocab axis is padded (``padded_vocab ≥ vocab_size``): checkpoint rows
    fill the first ``vocab_size`` entries and the padding keeps the
    template's values (its logits are masked). Entries absent from the
    checkpoint are skipped (e.g. attention-free configs); present ones of
    the wrong shape raise."""
    nm = dict(DEFAULT_DECODER_MAP)
    if name_map:
        nm.update(name_map)
    out = _copy_tree(flax_decoder_params)

    def take(key):
        name = nm.get(key)
        return np.asarray(tf_vars[name]) if name and name in tf_vars else None

    emb = take("embed")
    if emb is not None:
        tgt = out["embed"]["embedding"]
        V = vocab_size or emb.shape[0]
        _check_shape("embed dim", tgt.shape[1:], emb.shape[1:])
        tgt[:V] = emb[:V]
    w, b = take("lstm_kernel"), take("lstm_bias")
    if w is not None and b is not None:
        wf, bf_ = tf_lstm_gates_to_flax(w, b)
        _check_shape("lstm0/w", out["lstm0"]["w"].shape, wf.shape)
        out["lstm0"]["w"] = wf.astype(np.float32)
        out["lstm0"]["b"] = bf_.astype(np.float32)
    ow, ob = take("out_w"), take("out_b")
    if ow is not None:
        tgt = out["out_proj"]["kernel"]
        V = vocab_size or ow.shape[1]
        _check_shape("out_proj in-dim", tgt.shape[:1], ow.shape[:1])
        tgt[:, :V] = ow[:, :V]
        if ob is not None:
            out["out_proj"]["bias"][:V] = ob[:V]
    fw, fb = take("feat_w"), take("feat_b")
    if fw is not None:
        _check_shape("feat_proj/kernel", out["feat_proj"]["kernel"].shape,
                     fw.shape)
        out["feat_proj"]["kernel"] = fw.astype(np.float32)
        if fb is not None:
            out["feat_proj"]["bias"] = fb.astype(np.float32)
    kw = take("attn_key_w")
    if kw is not None and "key_proj" in out:
        _check_shape("key_proj/kernel", out["key_proj"]["kernel"].shape,
                     kw.shape)
        out["key_proj"]["kernel"] = kw.astype(np.float32)
    qw, u = take("attn_query_w"), take("attn_u")
    if qw is not None and "attention" in out:
        _check_shape("attention/query/kernel",
                     out["attention"]["query"]["kernel"].shape, qw.shape)
        out["attention"]["query"]["kernel"] = qw.astype(np.float32)
        if u is not None:
            out["attention"]["u"] = u.reshape(-1).astype(np.float32)
    iw, ib = take("init_w"), take("init_b")
    if iw is not None:
        _check_shape("init_proj/kernel", out["init_proj"]["kernel"].shape,
                     iw.shape)
        out["init_proj"]["kernel"] = iw.astype(np.float32)
        if ib is not None:
            out["init_proj"]["bias"] = ib.astype(np.float32)
    return out


def convert_irv2_checkpoint_to_npz(ckpt_path: str, out_path: str) -> str:
    """Read a TF-slim IRv2 ImageNet checkpoint, convert it, and write the
    ``.npz`` that ``load_backbone_params`` reads. Returns ``out_path``."""
    from vidcap_tpu_torch.models import backbone as backbone_mod
    tf_vars = read_tf_checkpoint(ckpt_path)
    template = unflatten_tree(to_flat(backbone_mod.InceptionResNetV2()))
    params = convert_irv2(tf_vars, template)
    np.savez(out_path, **flatten_tree(params))
    return out_path
