"""The benchmark's weights: random, made on the device from the seed, in
f32 (the port keeps its parameters in f32 and casts them for its kernels),
named as the port's parameters so that they load into its model by name.
The same tensors go to the reference, which reads them by these names.

One generator on the device draws one N(0, 1) buffer for every parameter
in a single call; each parameter is its slice, scaled to the standard
deviation of its initializer kind (lecun-normal kernels, 1/sqrt(features)
embedding, glorot-normal LSTM kernel, u at 0.05) and biases at 0.02, so
that the bias paths are checked too.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def sizes(cfg: Dict) -> Dict[str, int]:
    """The widths of a configuration file: E, H, A, D, T, V, Vp, NA, L."""
    V = cfg["vocab_size"]
    return dict(E=cfg["embed_dim"], H=cfg["hidden_dim"], A=cfg["attn_dim"],
                D=cfg["feature_dim"], T=cfg["num_frames"], V=V,
                Vp=-(-V // 128) * 128, NA=cfg["num_attributes"],
                L=cfg["max_len"])


def table(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, standard deviation) of every parameter."""
    s = sizes(cfg)
    E, H, A, D, Vp, NA = s["E"], s["H"], s["A"], s["D"], s["Vp"], s["NA"]
    b = 0.02
    return [
        ("decoder.embed.embedding", (Vp, E), 1 / math.sqrt(E)),
        ("decoder.feat_proj.kernel", (D, H), 1 / math.sqrt(D)),
        ("decoder.feat_proj.bias", (H,), b),
        ("decoder.key_proj.kernel", (H, A), 1 / math.sqrt(H)),
        ("decoder.init_proj.kernel", (H, 2 * H), 1 / math.sqrt(H)),
        ("decoder.init_proj.bias", (2 * H,), b),
        ("decoder.lstm0.w", (E + 2 * H, 4 * H),
         math.sqrt(2 / (E + 2 * H + 4 * H))),
        ("decoder.lstm0.b", (4 * H,), b),
        ("decoder.attention.u", (A,), 0.05),
        ("decoder.attention.query.kernel", (H, A), 1 / math.sqrt(H)),
        ("decoder.out_proj.kernel", (H, Vp), 1 / math.sqrt(H)),
        ("decoder.out_proj.bias", (Vp,), b),
        ("attr_head.fc1.kernel", (H, H), 1 / math.sqrt(H)),
        ("attr_head.fc1.bias", (H,), b),
        ("attr_head.fc2.kernel", (H, NA), 1 / math.sqrt(H)),
        ("attr_head.fc2.bias", (NA,), b),
    ]


def make(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter from ``seed``, on ``device``, in one draw."""
    tab = table(cfg)
    total = sum(math.prod(shape) for _, shape, _ in tab)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, pos = {}, 0
    for name, shape, std in tab:
        n = math.prod(shape)
        out[name] = flat[pos:pos + n].view(shape).mul_(std)
        pos += n
    return out


@torch.no_grad()
def load_into(model: torch.nn.Module, w: Dict[str, torch.Tensor]) -> None:
    """Copy the weights into the program's model by parameter name; the
    names must be the same set."""
    params = dict(model.named_parameters())
    if set(params) != set(w):
        raise ValueError(
            "the program's parameters are not the benchmark's: missing "
            f"{sorted(set(w) - set(params))}, extra "
            f"{sorted(set(params) - set(w))}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(w[name].shape):
            raise ValueError(f"{name}: program {tuple(p.shape)}, benchmark "
                             f"{tuple(w[name].shape)}")
        p.copy_(w[name])
