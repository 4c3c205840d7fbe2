"""The plain reference of the captioner: the temporal-attention LSTM decoder
and the attribute head, written out in PyTorch operations from the model's
description, on the benchmark's weights by name (``benchmark/weights.py``).
It imports nothing of the program.

Arithmetic: every tensor is float32; at the points where the model
computes in its compute dtype the value is rounded to that dtype (``cd``:
bfloat16 as the configuration states, or a lower one for the control) and
back, and products accumulate in float32, with TF32 off:

* a dense layer: ``y = rnd(rnd(x) @ rnd(W))``, then ``rnd(y + rnd(b))``;
* attention: ``q = dense(h)``, ``s = rnd(tanh(rnd(keys + q)))``, scores
  ``s . rnd(u)``, masked frames at -1e30, softmax over frames, context
  ``rnd(attn) . values``;
* the LSTM: ``gates = rnd([emb; ctx; h]) @ rnd(W) + b`` (bias in f32), gate
  order i, f, g, o, forget gate ``sigmoid(f + 1)``;
* the initial state ``tanh(dense(mean of the projected frames))``, the
  attention keys ``dense(values)``, both held in ``cd``;
* logits ``dense(h)``, columns at or past the vocabulary size at -1e30.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

NEG = -1e30
P = "decoder."


def full_f32() -> None:
    """Products in full f32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rnd(x: torch.Tensor, cd: Optional[torch.dtype]) -> torch.Tensor:
    return x if cd is None else x.to(cd).float()


def dense(x, w, b, cd):
    y = rnd(rnd(x, cd) @ rnd(w, cd), cd)
    return y if b is None else rnd(y + rnd(b, cd), cd)


class State:
    """h, c f32[N, H]; keys, values (rounded to cd) [N, T, A|H]; mask
    f32[N, T]."""

    def __init__(self, h, c, keys, values, mask):
        self.h, self.c, self.keys, self.values, self.mask = \
            h, c, keys, values, mask


def encode(W: Dict, feats: torch.Tensor, mask: torch.Tensor, cd
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(projected frames f32[N, T, H], their masked mean f32[N, H])."""
    values = dense(feats, W[P + "feat_proj.kernel"], W[P + "feat_proj.bias"],
                   cd)
    denom = torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
    return values, (values * mask[..., None]).sum(1) / denom


def init_state(W: Dict, feats: torch.Tensor, mask: torch.Tensor, cd
               ) -> State:
    values, pooled = encode(W, feats, mask, cd)
    H = values.shape[-1]
    hc = rnd(torch.tanh(dense(pooled, W[P + "init_proj.kernel"],
                              W[P + "init_proj.bias"], cd)), cd)
    keys = dense(values, W[P + "key_proj.kernel"], None, cd)
    return State(hc[:, :H], hc[:, H:], rnd(keys, cd), rnd(values, cd),
                 mask.float())


def step(W: Dict, st: State, token: torch.Tensor, vocab: int, cd
         ) -> Tuple[State, torch.Tensor]:
    """One step for every row on its previous token → (state, logits
    f32[N, Vp])."""
    emb = W[P + "embed.embedding"][token]
    q = dense(st.h, W[P + "attention.query.kernel"], None, cd)
    s = rnd(torch.tanh(rnd(st.keys + q[:, None, :], cd)), cd)
    scores = s @ rnd(W[P + "attention.u"], cd)
    scores = torch.where(st.mask > 0, scores, torch.full_like(scores, NEG))
    attn = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("nt,ntd->nd", rnd(attn, cd), st.values)
    xh = rnd(torch.cat([emb, ctx, st.h], dim=-1), cd)
    gates = xh @ rnd(W[P + "lstm0.w"], cd) + W[P + "lstm0.b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * st.c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    logits = dense(h, W[P + "out_proj.kernel"], W[P + "out_proj.bias"], cd)
    col = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(col < vocab, logits, torch.full_like(logits, NEG))
    return State(h, c, st.keys, st.values, st.mask), logits


def teacher_forced(W: Dict, feats: torch.Tensor, mask: torch.Tensor,
                   inputs: torch.Tensor, vocab: int, cd) -> torch.Tensor:
    """Logits f32[N, L, Vp] at every position of ``inputs`` (the tokens fed
    in, <bos> first)."""
    st = init_state(W, feats, mask, cd)
    out = []
    for t in range(inputs.shape[1]):
        st, lg = step(W, st, inputs[:, t].long(), vocab, cd)
        out.append(lg)
    return torch.stack(out, 1)


def attribute_logits(W: Dict, feats: torch.Tensor, mask: torch.Tensor, cd
                     ) -> torch.Tensor:
    _, pooled = encode(W, feats, mask, cd)
    x = torch.relu(dense(pooled, W["attr_head.fc1.kernel"],
                         W["attr_head.fc1.bias"], cd))
    return dense(x, W["attr_head.fc2.kernel"], W["attr_head.fc2.bias"], cd)
