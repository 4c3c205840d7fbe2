"""The benchmark's calls into the program for the language-model decode
cell: the program's decoder configuration from the configuration file,
the weights from the seed, a ``Captioner`` on them, a recorded decode of
judged rows' batches (each step's tokens, lineage, experts and top-n
log-probs), and the reference's judgement of them through the experts the
program chose (``reference/kimi_vl_lm.py``).

Weights: one generator on the device draws every parameter of the
reference's table (``param_table``) in its order, in f32, N(0, 0.02)
(DeepSeek-V3's ``initializer_range``), then rounds it to bf16; norms one,
biases zero, ``e_score_correction_bias`` N(0, 0.01) in f32. The program's
parameters become these tensors (no copy), and the reference reads the
same ones once the program is gone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from benchmark.program import vocab_words
from benchmark.reference import kimi_vl_lm as ref

STD, CORRECTION_STD = 0.02, 0.01


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter from ``seed``, on ``device``: bf16, the score
    correction f32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape, kind in ref.param_table(cfg):
        if kind == "one":
            out[name] = torch.ones(shape, dtype=torch.bfloat16, device=device)
        elif kind == "zero":
            out[name] = torch.zeros(shape, dtype=torch.bfloat16,
                                    device=device)
        elif kind == "correction":
            out[name] = torch.randn(shape, generator=gen,
                                    device=device) * CORRECTION_STD
        else:
            out[name] = torch.randn(shape, generator=gen, device=device).mul_(
                STD).to(torch.bfloat16)
    return out


def lm_config(cfg: Dict):
    """The program's ``LMDecoderConfig`` from the file's keys."""
    from vidcap_tpu_torch.models.lm_decoder import LMDecoderConfig
    names = {f.name for f in dataclasses.fields(LMDecoderConfig)}
    return LMDecoderConfig(**{k: v for k, v in cfg.items() if k in names})


def captioner(r) -> Tuple[object, Dict[str, torch.Tensor]]:
    """(a ``Captioner`` of the configuration on the seed's weights, the
    weights)."""
    from vidcap_tpu_torch.config import apply_overrides, get_preset
    from vidcap_tpu_torch.data.loader import CaptionDataset
    from vidcap_tpu_torch.data.vocab import Vocab
    from vidcap_tpu_torch.inference import Captioner
    from vidcap_tpu_torch.models.lm_decoder import (create_lm_model,
                                                    load_lm_weights)
    c = r.cfg
    V, T, D = c["vocab_size"], c["num_frames"], c["feature_dim"]
    cfg = apply_overrides(get_preset(c["preset"]), [
        f"data.feature_dim={D}", f"data.num_frames={T}",
        f"data.vocab_size={V}", f"decode.max_len={c['max_len']}",
        f"decode.beam_width={c['beam_width']}"])
    words = vocab_words(V)
    vocab = Vocab({w: i for i, w in enumerate(words)}, words)
    ds = CaptionDataset(np.zeros((1, T, D), np.float32), ["v0"],
                        {"v0": [words[4]]}, cfg.data, vocab=vocab)
    W = make_weights(c, r.seed, r.device)
    model = load_lm_weights(create_lm_model(lm_config(c), device="meta"), W)
    return Captioner(cfg, model.eval(), ds, r.device), W


def record_decode(cap, feats: np.ndarray, K: int, n: int) -> Dict:
    """One more ``cap.decode_batch(feats, "beam", K)``, recording what the
    check needs of each step: the tokens fed, the lineage table before it,
    each expert layer's experts of every row (a forward hook on each
    router), and the step's top-``n`` log-probs through the Captioner's
    own head. The prefill's experts are kept per video. Returns the
    decode's tokens and the record, on the host."""
    from vidcap_tpu_torch.data.vocab import BOS
    model, cur = cap.model, []
    moe = [l.index for l in model.layers if not l.dense]
    hooks = [model.layers[i].mlp.gate.register_forward_hook(
        lambda mod, inp, out: cur.append(out[0].to(torch.int16)))
        for i in moe]
    init, step_hidden = model.init_beam, model.step_hidden
    prefill, steps = [], []

    def init_beam(f, m, k, max_len):
        cur.clear()
        st = init(f, m, k, max_len)
        prefill.extend(r.view(f.shape[0], f.shape[1], -1) for r in cur)
        return st

    def step(state, tok):
        cur.clear()
        lineage = state.lineage[:, :, :state.t].clone()
        state, h = step_hidden(state, tok)
        v, i = cap._vocab_proj.topk(h, n)
        steps.append((tok.clone(), lineage, torch.stack(cur, 1), v, i))
        return state, h

    model.init_beam, model.step_hidden = init_beam, step
    try:
        toks = cap.decode_batch(feats, method="beam", beam_width=K)
    finally:
        del model.init_beam, model.step_hidden
        for hk in hooks:
            hk.remove()
    host = lambda t: t.cpu().numpy()
    return {"tokens": toks, "K": K, "bos": BOS, "layers": moe,
            "prefill": np.stack([host(r) for r in prefill], 1),
            "fed": np.stack([host(s[0]) for s in steps]),
            "lineage": [host(s[1]) for s in steps],
            "routes": [host(s[2]) for s in steps],
            "logp": np.stack([host(s[3]) for s in steps]),
            "ids": np.stack([host(s[4]) for s in steps])}


def follow(rec: Dict, b: int, seq: np.ndarray, length: int):
    """The rows of video ``b`` that fed ``seq``'s prefix at each of its
    first ``length`` steps in the recorded decode (``record_decode``), or
    None where no row did: the tokens are no path of that decode."""
    K, fed = rec["K"], rec["fed"]
    if length > len(fed):
        return None
    want = np.concatenate([[rec["bos"]], seq[:max(length - 1, 0)]])
    rows = []
    for j in range(length):
        lin = rec["lineage"][j][b]                          # [K, j]
        hist = np.concatenate([fed[np.arange(j)[None, :], b * K + lin],
                               fed[j, b * K:(b + 1) * K, None]], 1)
        ok = np.flatnonzero((hist == want[None, :j + 1]).all(1))
        if not len(ok):
            return None
        rows.append(b * K + ok[0])
    return rows


def program_side(recs: Dict, where, tokens: np.ndarray,
                 lengths: np.ndarray, T: int) -> Dict:
    """For the judged rows (``where``: each row's pool batch and video):
    ``found`` whether the row is a path of its batch's recorded decode;
    the program's top-n log-probs and ids at each of its positions; and
    its experts at each position, expert layer → i16[R, T + L, k], −1
    where there is none (positions past the row's end, rows not found)."""
    R, L = tokens.shape
    any_rec = next(iter(recs.values()))
    n, k = any_rec["logp"].shape[-1], any_rec["prefill"].shape[-1]
    found = np.zeros(R, bool)
    v, i = np.zeros((R, L, n), np.float32), np.zeros((R, L, n), np.int64)
    routes = {l: np.full((R, T + L, k), -1, np.int16)
              for l in any_rec["layers"]}
    for r, (pb, b) in enumerate(where):
        rec = recs[pb]
        rows = follow(rec, b, tokens[r], int(lengths[r]))
        if rows is None:
            continue
        found[r] = True
        j = np.arange(len(rows))
        v[r, j], i[r, j] = rec["logp"][j, rows], rec["ids"][j, rows]
        for x, l in enumerate(rec["layers"]):
            routes[l][r, :T] = rec["prefill"][b, x]
            routes[l][r, T + j] = np.stack(
                [rec["routes"][s][rows[s], x] for s in j])
    return {"found": found, "logp": v, "ids": i, "routes": routes}


def judge(cfg: Dict, W: Dict[str, torch.Tensor], feats: np.ndarray,
          tokens: np.ndarray, lengths: np.ndarray, prog: Dict,
          margin: float, device, rows: int = 64) -> Dict[str, float]:
    """The reference's full forward over each judged row's frames, <bos>
    and tokens, in blocks of ``rows``, each token through the experts the
    program chose for it (``program_side``), compared at the rows' real
    positions (up to and including the first <eos>) of the rows found:
    ``rows_not_found``; ``off_beam_tokens``, the share of the tokens whose
    reference log-prob is below the reference's 5th best there by more
    than ``margin``; ``logp_gap``, the largest |program − reference| of
    the log-probs at the program's top-n ids; ``route_gap``, the largest
    over the positions (frames too) and layers of the route gap
    (``reference/kimi_vl_lm.py::experts``). For the record (``record``):
    the share off the beam at other margins, the gaps' quantiles."""
    keep = np.flatnonzero(prog["found"])
    below, gaps, routed = [np.zeros(0)], [np.zeros(0)], [np.zeros(0)]
    for a in range(0, len(keep), rows):
        sel = keep[a:a + rows]
        tok = torch.as_tensor(tokens[sel]).long()
        f = torch.as_tensor(feats[sel])
        logits, rg = ref.forward(
            W, cfg, f, torch.ones(f.shape[:2]), tok, device,
            routes={l: r[sel] for l, r in prog["routes"].items()})
        lp = torch.log_softmax(logits, -1)
        real = torch.as_tensor(np.arange(tok.shape[1])[None, :]
                               < lengths[sel, None], device=lp.device)
        fifth = lp.topk(5, -1).values[..., 4]
        mine = lp.gather(2, tok.to(lp.device)[..., None])[..., 0]
        below.append((fifth - mine)[real].cpu().numpy())
        at = lp.gather(2, torch.as_tensor(prog["ids"][sel],
                                          device=lp.device).long())
        gap = (at - torch.as_tensor(prog["logp"][sel], device=lp.device)
               ).abs().amax(-1)
        gaps.append(gap[real].cpu().numpy())
        routed.append(rg.cpu().numpy().ravel())
        del lp, logits
    below, gaps, routed = (np.concatenate(x) for x in (below, gaps, routed))
    big = lambda x: float(x.max()) if len(x) else 0.0
    q = lambda x: ({p: float(np.quantile(x, p)) for p in (0.5, 0.9, 0.99)}
                   if len(x) else {})
    return {"rows_not_found": float(len(tokens) - len(keep)),
            "off_beam_tokens": float((below > margin).mean()) if len(below)
            else 1.0,
            "logp_gap": big(gaps), "route_gap": big(routed),
            "record": {
                "positions": int(len(gaps)),
                "off_beam_by_margin": {m: float((below > m).mean())
                                       for m in (0.01, 0.05, 0.2, 0.5)}
                if len(below) else {},
                "logp_gap_quantiles": q(gaps),
                "route_gap_quantiles": q(routed)}}
