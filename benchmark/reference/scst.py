"""The reference's SCST step, in plain PyTorch on the benchmark's weights:
the self-critical policy gradient (Rennie et al., CVPR 2017) with the
greedy rollout as baseline and CIDEr-D as reward, plus ``xe_mix`` times
the teacher-forced cross-entropy of the ground-truth caption and
``attr_weight`` times the attribute BCE, then a global-norm clip and Adam
(Kingma & Ba; b1 0.9, b2 0.999, eps 1e-8 outside the square root).

    loss = -sum_b (r(sample_b) - r(greedy_b)) sum_t log p(w_bt) m_bt
           / sum m  +  xe_mix * XE  +  attr_weight * BCE

A rollout's mask holds its tokens up to and including the first <eos>.
The step takes the sampled and greedy tokens as given (the program's, to
be judged); :func:`rollouts` draws its own for the control.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import model as ref
from benchmark.reference.captions import BOS, EOS, PAD, Corpus

B1, B2, EPS = 0.9, 0.999, 1e-8


def rollout_mask(tokens: torch.Tensor) -> torch.Tensor:
    """1.0 up to and including each row's first <eos>."""
    is_eos = (tokens == EOS).int()
    before = torch.cumsum(is_eos, 1) - is_eos
    return (before == 0).float()


def shift_in(tokens: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.full_like(tokens[:, :1], BOS), tokens[:, :-1]], 1)


def seq_logp(W, feats, mask_f, tokens, vocab, cd, temperature=1.0):
    """log p of each token under teacher forcing: f32[N, L]."""
    lg = ref.teacher_forced(W, feats, mask_f, shift_in(tokens), vocab, cd)
    lp = torch.log_softmax(lg / temperature, -1)
    return lp.gather(-1, tokens.long()[..., None])[..., 0]


def loss(W: Dict, corpus: Corpus, feats: torch.Tensor, vidx: np.ndarray,
         gt: torch.Tensor, sample: torch.Tensor, greedy: torch.Tensor,
         attrs: torch.Tensor, cfg: Dict, cd) -> Tuple[torch.Tensor, Dict]:
    """The step's loss and its parts; ``feats`` f32[B, T, D], ``gt`` the
    ground-truth tokens, ``sample`` and ``greedy`` the rollouts' tokens."""
    vocab = cfg["vocab_size"]
    mask_f = torch.ones(feats.shape[:2], device=feats.device)
    r_s = torch.tensor([corpus.cider(int(v), t) for v, t in
                        zip(vidx, sample.cpu().tolist())], device=feats.device)
    r_g = torch.tensor([corpus.cider(int(v), t) for v, t in
                        zip(vidx, greedy.cpu().tolist())], device=feats.device)
    m = rollout_mask(sample)
    lp = seq_logp(W, feats, mask_f, sample, vocab, cd,
                  cfg.get("temperature", 1.0))
    pg = -((r_s - r_g) * (lp * m).sum(-1)).sum() / torch.clamp(m.sum(), 1.0)
    total = pg
    parts = {"pg": pg, "reward_sample": r_s.mean(), "reward_greedy": r_g.mean()}
    if cfg["scst_xe_mix"] > 0:
        gm = (gt != PAD).float()
        xe = -(seq_logp(W, feats, mask_f, gt, vocab, cd) * gm).sum() \
            / torch.clamp(gm.sum(), 1.0)
        total = total + cfg["scst_xe_mix"] * xe
        parts["xe"] = xe
    if cfg["attribute_loss_weight"] > 0:
        z = ref.attribute_logits(W, feats, mask_f, cd)
        bce = (-attrs * F.logsigmoid(z) - (1 - attrs) * F.logsigmoid(-z)).mean()
        total = total + cfg["attribute_loss_weight"] * bce
        parts["bce"] = bce
    return total, parts


def clipped_grads(W: Dict, total: torch.Tensor, clip: float
                  ) -> Dict[str, torch.Tensor]:
    names = sorted(W)
    g = torch.autograd.grad(total, [W[n] for n in names], allow_unused=True)
    g = {n: torch.zeros_like(W[n]) if x is None else x
         for n, x in zip(names, g)}
    norm = torch.sqrt(sum((x * x).sum() for x in g.values()))
    if norm >= clip:
        g = {n: x / norm * clip for n, x in g.items()}
    return g


class Adam:
    def __init__(self, W: Dict, lr: float):
        self.lr = lr
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in W.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in W.items()}

    @torch.no_grad()
    def update(self, W: Dict, g: Dict) -> None:
        c = self.count + 1
        bc1 = 1 - np.float32(B1) ** np.float32(c)
        bc2 = 1 - np.float32(B2) ** np.float32(c)
        for n, p in W.items():
            self.mu[n].mul_(B1).add_((1 - B1) * g[n])
            self.nu[n].mul_(B2).add_((1 - B2) * g[n] * g[n])
            u = (self.mu[n] / float(bc1)) / (
                torch.sqrt(self.nu[n] / float(bc2)) + EPS)
            p.add_(u * (-self.lr))
        self.count = c


@torch.no_grad()
def rollouts(W: Dict, feats: torch.Tensor, cfg: Dict, cd,
             gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sampled, greedy) tokens i32[B, L] of the reference itself: the
    control's own rollouts. A finished row emits <pad>."""
    vocab, L = cfg["vocab_size"], cfg["max_len"]
    mask_f = torch.ones(feats.shape[:2], device=feats.device)
    out: List[torch.Tensor] = []
    for sample in (True, False):
        st = ref.init_state(W, feats, mask_f, cd)
        prev = torch.full((feats.shape[0],), BOS, dtype=torch.long,
                          device=feats.device)
        done = torch.zeros_like(prev, dtype=torch.bool)
        toks = []
        for _ in range(L):
            st, lg = ref.step(W, st, prev, vocab, cd)
            if sample:
                tok = torch.multinomial(torch.softmax(
                    lg / cfg.get("temperature", 1.0), -1), 1,
                    generator=gen)[:, 0]
            else:
                tok = lg.argmax(-1)
            tok = torch.where(done, torch.full_like(tok, PAD), tok)
            toks.append(tok)
            done = done | (tok == EOS)
            prev = tok
        out.append(torch.stack(toks, 1).int())
    return out[0], out[1]
