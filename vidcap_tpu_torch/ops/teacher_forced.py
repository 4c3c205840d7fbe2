"""K4: the teacher-forced pass of the one-layer bf16 attention decoder,
forward and backward, as Hopper kernels (csrc/teacher_forced.cu).

Replaces no Pallas kernel: the JAX package leaves the scan body of its
teacher-forced pass (``vidcap_tpu/models/decoder.py:313``) and its gradient
to XLA. ``CaptionDecoder.xe_logits`` runs it on the card where the route
(``models/decoding.py::route``) says so; every other call keeps the module
loop. The function is the loop's, with every rounding point where the loop
has it:

    q = bf16(bf16(h)·bf16(Wq)); s = bf16(tanh(bf16(keys + q)))
    attn = softmax_T(Σ_A s·bf16(u), masked frames −1e30)
    xh = bf16([emb; Σ_T bf16(attn)·values; h])
    c', h' = LSTM(xh·bf16(W) + b, c)
    logits = bf16(bf16(bf16(h')·bf16(W_out)) + bf16(b_out)),
             columns ≥ vocab −1e30

and its backward is autograd's of that loop: each ``bf16(·)`` rounds the
cotangent on its way back (the backward of ``x.to(bf16).float()``), each
weight's gradient is rounded to bf16 at every timestep before the f32 sum
over timesteps, last to first, and the keys' and values' cotangents are
summed in bf16, as autograd sums a bf16 tensor's.

:class:`_TeacherForced` is one ``torch.autograd.Function`` with one host
loop each way (:func:`_forward`, :func:`_backward`) over two sets of
pieces: the kernels (:class:`_Kernels`, CUDA tensors only) and the plain
version (:class:`_Plain`, any device), so that both decompose the pass
alike. The
products stay f32 ``torch.mm`` of bf16-valued operands, each weight cast
once a pass. A timestep is four launches each way (the q product, the
attention kernel, the gate product, the LSTM kernel; backward the LSTM
kernel, the gate operand's product, the attention kernel, the q product);
the output projection, its cotangent's product and the weight gradients run
once for all timesteps. The plain version runs the loop's own operations
timestep by timestep where a batched product would sum in another order,
so that on the CPU it equals the loop bit for bit (tests/
test_torch_teacher_forced.py). :func:`teacher_forced` counts one launch a
forward and one a backward (``_build.launch_counts["teacher_forced"]``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.ops.cell import NEG, lstm_update, rnd
from vidcap_tpu_torch.ops.limits import (TF_MAX_FRAMES, TF_MAX_WIDTH,
                                         teacher_forced_takes)

BF16 = torch.bfloat16
KERNEL = "teacher_forced"


def _r(x: torch.Tensor) -> torch.Tensor:
    return rnd(x, BF16)


def _einsum_grads(eq: str, a: torch.Tensor, b: torch.Tensor,
                  g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cotangents of ``einsum(eq, a, b)``'s operands as autograd takes
    them (the same contractions in the same order as the loop's)."""
    with torch.enable_grad():
        a = a.detach().requires_grad_()
        b = b.detach().requires_grad_()
        return torch.autograd.grad(torch.einsum(eq, a, b), (a, b), g)


class _Plain:
    """The pieces in PyTorch, on any device: the module loop's operations,
    one timestep at a time."""

    @staticmethod
    def round(x, out=None):
        return _r(x) if out is None else out.copy_(_r(x))

    @staticmethod
    def mm(a, b, out):
        out.copy_(a.contiguous() @ b)

    @staticmethod
    def attn_fwd(qraw, keys, values, fmask, u, emb, rh, xh, attn):
        q = _r(qraw)
        s = _r(torch.tanh(_r(keys.float() + q[:, None, :])))
        scores = torch.einsum("bta,a->bt", s, _r(u))
        scores = torch.where(fmask > 0, scores, torch.full_like(scores, NEG))
        p = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bt,btd->bd", _r(p), values.float())
        xh.copy_(_r(torch.cat([emb, ctx, rh], -1)))
        attn.copy_(p)

    @staticmethod
    def lstm_fwd(g, b, c, c_out, rh_out, ho_out):
        h, nc = lstm_update(g + b, c)
        c_out.copy_(nc)
        rh_out.copy_(_r(h))
        ho_out.copy_(rh_out)

    @staticmethod
    def project(ho, rwo):
        return torch.stack([ho[:, t].contiguous() @ rwo
                            for t in range(ho.shape[1])], 1)

    @staticmethod
    def logits(p, b_out, vocab):
        col = torch.arange(p.shape[-1], device=p.device)
        p.copy_(torch.where(col < vocab, _r(_r(p) + _r(b_out)),
                            torch.full_like(p, NEG)))

    @staticmethod
    def logits_bwd(dl, vocab):
        col = torch.arange(dl.shape[-1], device=dl.device)
        return _r(torch.where(col < vocab, dl, torch.zeros_like(dl)))

    @staticmethod
    def project_back(dp, rwo):
        return torch.stack([dp[:, t].contiguous().mm(rwo.t())
                            for t in range(dp.shape[1])], 1)

    @staticmethod
    def lstm_bwd(g, b, c, dhl, ga, gc, dc_next, dg, dc_out):
        i, f, gg, o = (g + b).chunk(4, dim=-1)
        si, sf = torch.sigmoid(i), torch.sigmoid(f + 1.0)
        tg, so = torch.tanh(gg), torch.sigmoid(o)
        tc = torch.tanh(sf * c + si * tg)
        dh = _r(dhl)
        if ga is not None:
            dh = (_r(ga) + gc) + dh
        dnc = torch.ops.aten.tanh_backward(dh * so, tc)
        if dc_next is not None:
            dnc = dnc + dc_next
        sig_b, tanh_b = (torch.ops.aten.sigmoid_backward,
                         torch.ops.aten.tanh_backward)
        dc_out.copy_(dnc * sf)
        dg.copy_(torch.cat([sig_b(dnc * tg, si), sig_b(dnc * c, sf),
                            tanh_b(dnc * si, tg), sig_b(dh * tc, so)], -1))

    @staticmethod
    def attn_bwd(dxh, keys, values, fmask, u, qraw, attn, d_emb, gc, dk, dv,
                 dq, pu, first):
        """``dk``, ``dv``: bf16 sums, written at the ``first`` timestep
        (the last), added to after. ``pu``: the whole sum of u's cotangent
        in row 0 (the kernel writes each row's share); the column sum over
        rows reads both alike."""
        E, H = d_emb.shape[-1], gc.shape[-1]
        r = _r(dxh)
        d_emb.copy_(r[:, :E])
        gc.copy_(r[:, E + H:])
        d_ra, d_v = _einsum_grads("bt,btd->bd", _r(attn), values.float(),
                                  r[:, E:E + H])
        dv.copy_(d_v if first else dv + d_v.to(BF16))
        d_sm = torch._softmax_backward_data(_r(d_ra), attn, -1, torch.float32)
        d_sc = torch.where(fmask > 0, d_sm, torch.zeros_like(d_sm))
        th = torch.tanh(_r(keys.float() + _r(qraw)[:, None, :]))
        d_s, d_u = _einsum_grads("bta,a->bt", _r(th), _r(u), d_sc)
        d_kq = _r(torch.ops.aten.tanh_backward(_r(d_s), th))
        dk.copy_(d_kq if first else dk + d_kq.to(BF16))
        dq.copy_(_r(d_kq.sum(1)))
        pu.zero_()
        pu[0] = d_u

    @staticmethod
    def colsum(y, round_: bool):
        acc = None
        for t in reversed(range(y.shape[0])):
            s = y[t].contiguous().sum(0)
            s = _r(s) if round_ else s
            acc = s if acc is None else acc + s
        return acc

    @staticmethod
    def wgrad(x, y):
        acc = None
        for t in reversed(range(x.shape[0])):
            p = _r(x[t].contiguous().t().mm(y[t].contiguous()))
            acc = p if acc is None else acc + p
        return acc

    @staticmethod
    def dh0(ga, gc):
        return _r(ga) + gc


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


class _Kernels:
    """The pieces as launches of csrc/teacher_forced.cu on the current
    stream; the products in ``torch.mm``."""

    @staticmethod
    def _call(part: str, ptrs, ints, like: torch.Tensor):
        fn = _build.entry(KERNEL, len(ptrs), len(ints), part=part)
        _build.check(fn(*ptrs, *ints,
                        torch.cuda.current_stream(like.device).cuda_stream),
                     f"{KERNEL} {part}")

    @classmethod
    def round(cls, x, out=None):
        out = torch.empty_like(x) if out is None else out
        cls._call("round", (x.data_ptr(), out.data_ptr()), (x.numel(),), x)
        return out

    @staticmethod
    def mm(a, b, out):
        torch.mm(a, b, out=out)

    @classmethod
    def attn_fwd(cls, qraw, keys, values, fmask, u, emb, rh, xh, attn):
        B, T, A = keys.shape
        E, H = emb.shape[-1], rh.shape[-1]
        cls._call("attn_fwd", tuple(map(_ptr, (
            qraw, keys, values, fmask, u, emb, rh, xh, attn))),
            (B, T, E, H, A, emb.stride(0)), keys)

    @classmethod
    def lstm_fwd(cls, g, b, c, c_out, rh_out, ho_out):
        B, H = c.shape
        cls._call("lstm_fwd", tuple(map(_ptr, (
            g, b, c, c_out, rh_out, ho_out))), (B, H, ho_out.stride(0)), c)

    @staticmethod
    def project(ho, rwo):
        B, L, H = ho.shape
        return torch.mm(ho.view(B * L, H), rwo).view(B, L, -1)

    @classmethod
    def logits(cls, p, b_out, vocab):
        B, L, Vp = p.shape
        cls._call("logits", (p.data_ptr(), b_out.data_ptr()),
                  (B * L, Vp, vocab), p)

    @classmethod
    def logits_bwd(cls, dl, vocab):
        if not dl.is_contiguous() or dl.data_ptr() % 16:
            dl = dl.clone(memory_format=torch.contiguous_format)
        B, L, Vp = dl.shape
        dp = torch.empty_like(dl)
        cls._call("logits_bwd", (dl.data_ptr(), dp.data_ptr()),
                  (B * L, Vp, vocab), dl)
        return dp

    @staticmethod
    def project_back(dp, rwo):
        B, L, Vp = dp.shape
        return torch.mm(dp.view(B * L, Vp), rwo.t()).view(B, L, -1)

    @classmethod
    def lstm_bwd(cls, g, b, c, dhl, ga, gc, dc_next, dg, dc_out):
        B, H = c.shape
        cls._call("lstm_bwd", tuple(map(_ptr, (
            g, b, c, dhl, ga, gc, dc_next, dg, dc_out))),
            (B, H, dhl.stride(0)), c)

    @classmethod
    def attn_bwd(cls, dxh, keys, values, fmask, u, qraw, attn, d_emb, gc, dk,
                 dv, dq, pu, first):
        B, T, A = keys.shape
        E, H = d_emb.shape[-1], gc.shape[-1]
        cls._call("attn_bwd", tuple(map(_ptr, (
            dxh, keys, values, fmask, u, qraw, attn, d_emb, gc, dk, dv, dq,
            pu))), (B, T, E, H, A, d_emb.stride(0), int(first)), keys)

    @classmethod
    def colsum(cls, y, round_: bool):
        L, B, N = y.shape
        out = torch.empty(N, device=y.device)
        cls._call("colsum", (y.data_ptr(), out.data_ptr()),
                  (y.stride(0), y.stride(1), L, B, N, int(round_)), y)
        return out

    @classmethod
    def wgrad(cls, x, y):
        L, B, M = x.shape
        N = y.shape[2]
        out = torch.empty(M, N, device=x.device)
        cls._call("wgrad", (x.data_ptr(), y.data_ptr(), out.data_ptr()),
                  (x.stride(0), x.stride(1), y.stride(0), y.stride(1), L, B,
                   M, N), x)
        return out

    @classmethod
    def dh0(cls, ga, gc):
        out = torch.empty_like(ga)
        cls._call("dh0", (ga.data_ptr(), gc.data_ptr(), out.data_ptr()),
                  (ga.numel(),), ga)
        return out


def _forward(P, vocab: int, embs, keys, values, fmask, h0, c0, wq, u, w, b,
             w_out, b_out) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    B, L, E = embs.shape
    T, A = keys.shape[1:]
    H = h0.shape[1]
    dev = embs.device
    rwq, rw, rwo = P.round(wq), P.round(w), P.round(w_out)
    empty = lambda *s: torch.empty(*s, device=dev)
    xh, g = empty(L, B, E + 2 * H), empty(L, B, 4 * H)
    # c'_t; bf16(h_t) from h0 on (the q products' rows), bf16(h'_t) by row
    c, rh, ho = empty(L, B, H), empty(L + 1, B, H), empty(B, L, H)
    qraw, attn = empty(L, B, A), empty(L, B, T)
    P.round(h0, rh[0])
    for t in range(L):
        P.mm(rh[t], rwq, qraw[t])
        P.attn_fwd(qraw[t], keys, values, fmask, u, embs[:, t], rh[t], xh[t],
                   attn[t])
        P.mm(xh[t], rw, g[t])
        P.lstm_fwd(g[t], b, c0 if t == 0 else c[t - 1], c[t], rh[t + 1],
                   ho[:, t])
    logits = P.project(ho, rwo)
    P.logits(logits, b_out, vocab)
    return logits, dict(keys=keys, values=values, fmask=fmask, c0=c0, u=u,
                        b=b, rwq=rwq, rw=rw, rwo=rwo, xh=xh, g=g, c=c, rh=rh,
                        ho=ho, qraw=qraw, attn=attn)


def _backward(P, vocab: int, s: Dict[str, torch.Tensor], dlogits):
    keys, values, xh, ho = s["keys"], s["values"], s["xh"], s["ho"]
    L, B, _ = xh.shape
    H, A = ho.shape[2], keys.shape[2]
    E = xh.shape[2] - 2 * H
    dev = xh.device
    dp = P.logits_bwd(dlogits, vocab)                 # [B, L, Vp]
    dhl = P.project_back(dp, s["rwo"])                # [B, L, H], raw
    empty = lambda *sh: torch.empty(*sh, device=dev)
    d_embs, dg = empty(B, L, E), empty(L, B, 4 * H)
    dq, pu = empty(L, B, A), empty(L, B, A)
    dk, dv = torch.empty_like(keys), torch.empty_like(values)
    dxh, ga, gc, dc = empty(B, E + 2 * H), empty(B, H), empty(B, H), \
        empty(2, B, H)
    for t in reversed(range(L)):
        last = t == L - 1
        c_prev = s["c0"] if t == 0 else s["c"][t - 1]
        P.lstm_bwd(s["g"][t], s["b"], c_prev, dhl[:, t],
                   None if last else ga, None if last else gc,
                   None if last else dc[(t + 1) % 2], dg[t], dc[t % 2])
        P.mm(dg[t], s["rw"].t(), dxh)
        P.attn_bwd(dxh, keys, values, s["fmask"], s["u"], s["qraw"][t],
                   s["attn"][t], d_embs[:, t], gc, dk, dv, dq[t], pu[t], last)
        P.mm(dq[t], s["rwq"].t(), ga)
    d_h0, d_c0 = P.dh0(ga, gc), dc[0]
    d_wq = P.wgrad(s["rh"][:L], dq)
    d_u = P.colsum(pu, True)
    d_w = P.wgrad(xh, dg)
    d_b = P.colsum(dg, False)
    d_wo = P.wgrad(ho.transpose(0, 1), dp.transpose(0, 1))
    d_bo = P.colsum(dp.transpose(0, 1), True)
    return (d_embs, dk, dv, None, d_h0, d_c0, d_wq, d_u, d_w, d_b, d_wo,
            d_bo)


class _TeacherForced(torch.autograd.Function):

    @staticmethod
    def forward(ctx, P, vocab, *tensors):
        with torch.no_grad():
            logits, ctx.saved = _forward(P, vocab, *tensors)
        ctx.P, ctx.vocab = P, vocab
        if P is _Kernels:
            _build.count_launch(KERNEL)
        return logits

    @staticmethod
    @once_differentiable
    def backward(ctx, dlogits):
        grads = _backward(ctx.P, ctx.vocab, ctx.saved, dlogits)
        ctx.saved = None
        if ctx.P is _Kernels:
            _build.count_launch(KERNEL)
        return (None, None) + grads


def _inputs(params, state, embs):
    return (embs, state.keys, state.values, state.frame_mask, state.h[0],
            state.c[0], *params)


def teacher_forced_plain(params, vocab_size: int, state, embs: torch.Tensor
                         ) -> torch.Tensor:
    """The plain version, on any device: the teacher-forced logits f32[B, L,
    Vp] of one bf16 LSTM layer with attention, whose parameters ``params``
    are (Wq, u, W, b, W_out, b_out) (``models/decoding.py::KernelWeights.
    teacher_forced``), from ``state`` (``CaptionDecoder.init_state``) and
    the inputs' embeddings f32[B, L, E], differentiable, as
    ``CaptionDecoder.xe_logits``'s loop computes them."""
    return _TeacherForced.apply(_Plain, vocab_size,
                                *_inputs(params, state, embs))


def teacher_forced(params, vocab_size: int, state, embs: torch.Tensor
                   ) -> torch.Tensor:
    """:func:`teacher_forced_plain` on the kernels, for CUDA tensors; raises
    ValueError for what the kernels do not take (``ops/limits.py::
    teacher_forced_takes``, CPU tensors included)."""
    xs = _inputs(params, state, embs)
    B, L, E = embs.shape
    _, T, A = state.keys.shape
    H = state.h.shape[-1]
    Vp = params[4].shape[1]
    if L < 1 or not teacher_forced_takes(H, A, T, Vp):
        raise ValueError(f"{KERNEL}: hidden {H} and attention {A} widths "
                         f"must be multiples of 8 up to {TF_MAX_WIDTH}, the "
                         f"{T} frames in 1..{TF_MAX_FRAMES}, the vocab width "
                         f"{Vp} a multiple of 4 and the length {L} at least 1")
    f32 = torch.float32
    _build.require(KERNEL, zip(xs, (
        "embs", "keys", "values", "frame_mask", "h0", "c0", "wq", "u", "w",
        "b", "w_out", "b_out"), (f32, BF16, BF16) + (f32,) * 9, (
        (B, L, E), (B, T, A), (B, T, H), (B, T), (B, H), (B, H), (H, A), (A,),
        (E + 2 * H, 4 * H), (4 * H,), (H, Vp), (Vp,))))
    return _TeacherForced.apply(_Kernels, vocab_size, *xs)
