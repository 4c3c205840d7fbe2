"""Sharded train and decode steps over a (data, model) mesh of ranks, as
``vidcap_tpu/parallel/sharding.py``, on ``torch.distributed``.

Layout, the reference's:
  * batch rows: ``P('data')``: every rank draws the same global batch from
    the deterministic batcher and keeps its rows (:func:`shard_batch`);
  * parameters: replicated, except the vocab seam when the model axis is
    > 1: the embedding [V, E] by rows, the output projection's kernel
    [H, V] by columns and its bias [V] likewise; the optimizer moments
    follow their parameters (:func:`place_state`).

Where GSPMD inserts collectives for the reference, the port calls them
(:class:`DataParallel`): the losses are means over the global batch, so each
rank's loss is its share of the global numerator over the global
denominator (an all-reduce of the token count, not a mean of per-rank
means), and the gradients are summed over the data axis by one all-reduce
of one flat bucket. On the card the step is one CUDA graph with the
all-reduces inside it (train/steps.py::Captured). The vocab seam
(:class:`VocabShard`): the embedding lookup is vocab-parallel (mask, look up,
all-reduce over the model axis), the teacher-forced logits stay sharded by
column, and the log-softmax of the XE loss and the SCST re-score is
vocab-parallel (the max and the exp-sum all-reduced, the target's logit
taken from the shard that owns it). The SCST rollouts gather the whole
W_out, b_out and embedding once a step, without gradient, and run K3 over
the whole vocab, as GSPMD computes the reference's.

The decode (:func:`make_sharded_decode`) splits the video batch over the
data axis; each rank decodes its rows through the single-card route (K1/K2
or K2-int8 for beam, K3 for greedy, or the modules where a kernel refuses
the shape) on replicated parameters, and the tokens are all-gathered.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vidcap_tpu_torch.models.model import create_model
from vidcap_tpu_torch.parallel.mesh import Mesh, OneRank
from vidcap_tpu_torch.train.state import optax_global_norm
from vidcap_tpu_torch.train.steps import make_banked_step, make_step

Grads = Dict[str, torch.Tensor]
# the vocab seam's parameters and the axis each is split along
SEAM = {"decoder.embed.embedding": 0, "decoder.out_proj.kernel": 1,
        "decoder.out_proj.bias": 0}
# metrics that are the global value on every rank (the rest are each
# rank's share of a global sum)
GLOBAL_METRICS = ("tokens", "advantage_std")


# --------------------------------------------------------------- the seam

class _SumOver(torch.autograd.Function):
    """All-reduce sum over ``group`` forward; the gradient passes as it is
    (each rank holds the same loss, so each takes the whole cotangent)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyIn(torch.autograd.Function):
    """Identity forward; the gradient is all-reduced over ``group`` (a
    replicated input whose use is split over the ranks)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _max_over(x: torch.Tensor, group) -> torch.Tensor:
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def _gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The ``n`` ranks' ``x`` concatenated along ``dim`` in rank order
    (no gradient)."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


@dataclasses.dataclass
class VocabShard:
    """This rank's columns [v0, v1) of the padded vocab, over the model
    axis's ``group`` of ``n`` ranks."""

    v0: int
    v1: int
    n: int
    group: object

    def lookup(self, table: torch.Tensor, token: torch.Tensor
               ) -> torch.Tensor:
        """The embedding rows of ``token`` from the row shard ``table``:
        zero where another rank owns the token, then summed over the
        model axis (one owner: the sum is that row, exactly)."""
        local = token.long() - self.v0
        inside = (local >= 0) & (local < self.v1 - self.v0)
        rows = table[torch.where(inside, local, 0)]
        rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
        return _SumOver.apply(rows, self.group)

    def copy_in(self, h: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(h, self.group)

    def columns(self, n: int, device) -> torch.Tensor:
        return torch.arange(self.v0, self.v0 + n, device=device)

    def gather_columns(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole vocab's logits from each rank's columns (decode: no
        gradient)."""
        return _gather(logits, self.group, self.n, logits.dim() - 1)

    def token_logp(self, logits: torch.Tensor, targets: torch.Tensor
                   ) -> torch.Tensor:
        """log_softmax(logits)[targets] over the whole vocab from this
        rank's columns: the max and the exp-sum all-reduced over the model
        axis, the target's logit from the rank that owns it."""
        m = _max_over(logits.max(-1, keepdim=True).values, self.group)
        s = _SumOver.apply(torch.exp(logits - m).sum(-1, keepdim=True),
                           self.group)
        local = targets.long() - self.v0
        inside = (local >= 0) & (local < logits.shape[-1])
        picked = logits.gather(-1, torch.where(inside, local, 0)[..., None])
        picked = _SumOver.apply(torch.where(inside[..., None], picked,
                                            torch.zeros_like(picked)),
                                self.group)
        return (picked - m - torch.log(s))[..., 0]

    def full(self, model) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
        """(embedding [Vp, E], out_proj kernel [H, Vp], bias [Vp]) of the
        whole vocab, gathered without gradient: K3's weights."""
        dec = model.decoder
        return (_gather(dec.embed.embedding, self.group, self.n, 0),
                _gather(dec.out_proj.kernel, self.group, self.n, 1),
                _gather(dec.out_proj.bias, self.group, self.n, 0))


# ------------------------------------------------------- data parallelism

class DataParallel(OneRank):
    """A step body's collectives on ``mesh`` (``OneRank``'s, over the data
    axis): the global row offset of a rank's rows, sums over the data axis,
    the gradient all-reduce (one flat bucket, names in order), the global
    gradient norm and the metrics."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.nd = mesh.num_data
        self.vocab: Optional[VocabShard] = None   # place_state sets it

    def row0(self, rows: int) -> int:
        """The global row of this rank's first row, ``rows`` a rank."""
        return self.mesh.data_index * rows

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the data axis, without gradient."""
        y = x.detach().clone()
        dist.all_reduce(y, group=self.mesh.data_group)
        return y

    def reduce_grads(self, grads: Grads) -> Grads:
        names = sorted(grads)
        flat = torch.cat([grads[k].reshape(-1) for k in names])
        dist.all_reduce(flat, group=self.mesh.data_group)
        out, i = {}, 0
        for k in names:
            n = grads[k].numel()
            out[k] = flat[i:i + n].view_as(grads[k])
            i += n
        return out

    def global_norm(self, grads: Grads) -> torch.Tensor:
        """The norm of the whole gradient: the seam's shards summed over
        the model axis."""
        if self.vocab is None:
            return optax_global_norm(grads)
        rep = sum(torch.sum(grads[k] * grads[k]) for k in sorted(grads)
                  if k not in SEAM)
        seam = sum(torch.sum(grads[k] * grads[k]) for k in sorted(SEAM))
        return torch.sqrt(rep + _SumOver.apply(seam, self.vocab.group))

    def reduce_metrics(self, metrics: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """Each rank's shares summed over the data axis, in one all-reduce;
        :data:`GLOBAL_METRICS` are global already."""
        keys = sorted(k for k in metrics if k not in GLOBAL_METRICS)
        if not keys:
            return dict(metrics)
        vec = self.sum(torch.stack([metrics[k].float().reshape(())
                                    for k in keys]))
        return {**metrics, **{k: vec[i] for i, k in enumerate(keys)}}


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh, accum: int = 1
                ) -> Dict[str, np.ndarray]:
    """This rank's rows of the global batch (``P('data')``): rows
    [d·B/nd, (d+1)·B/nd) of every leaf, d the rank's data index. With
    ``accum`` (``train.grad_accum``) microbatches, the rank's share of each
    global microbatch in turn: rows m·B/K + [d·b, (d+1)·b), b = B/(K·nd),
    for m < K, so that the rank's microbatch m holds its rows of the one
    process's microbatch m."""
    nd, out = mesh.num_data, {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % (nd * accum):
            raise ValueError(
                f"batch of {B} rows does not divide over the {nd}-way data "
                f"axis" + (f" in {accum} microbatches" if accum > 1 else ""))
        b = B // (nd * accum)
        out[k] = v.reshape(accum, nd, b, *v.shape[1:])[
            :, mesh.data_index].reshape(accum * b, *v.shape[1:])
    return out


def _slice(t: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    n = t.shape[dim] // mesh.num_model
    return t.narrow(dim, mesh.model_index * n, n).contiguous()


def place_state(state, mesh: Mesh, dp: Optional[DataParallel] = None):
    """The train state on ``mesh``, in place: with a model axis > 1 the
    seam's parameters (:data:`SEAM`) and their moments become this rank's
    shard, and the decoder computes through :class:`VocabShard`; the rest
    stays replicated. ``dp``: the step's collectives, which learn the
    seam. Returns the state."""
    if mesh.num_model == 1:
        return state
    dec = state.model.decoder
    vp = dec.padded_vocab
    if vp % mesh.num_model:
        raise ValueError(f"the padded vocab {vp} does not divide over the "
                         f"{mesh.num_model}-way model axis")
    n = vp // mesh.num_model
    shard = VocabShard(mesh.model_index * n, (mesh.model_index + 1) * n,
                       mesh.num_model, mesh.model_group)
    mods = dict(state.model.named_modules())
    with torch.no_grad():
        for name, dim in SEAM.items():
            mod_name, attr = name.rsplit(".", 1)
            mod = mods[mod_name]
            setattr(mod, attr, torch.nn.Parameter(
                _slice(getattr(mod, attr), mesh, dim)))
            for m in ("mu", "nu"):
                state.opt_state[m][name] = _slice(state.opt_state[m][name],
                                                  mesh, dim)
    dec.vocab_shard = dec.embed.shard = shard
    if dp is not None:
        dp.vocab = shard
    return state


def full_tensors(state, mesh: Mesh) -> Optional[Tuple[Dict, Dict, Dict]]:
    """(params, mu, nu) of the whole model, the seam's shards gathered over
    the model axis (a collective: every rank calls it); None without a
    seam."""
    shard = getattr(state.model.decoder, "vocab_shard", None)
    if shard is None:
        return None
    out = []
    for tree in (state.params, state.opt_state["mu"], state.opt_state["nu"]):
        out.append({k: _gather(v, shard.group, shard.n, SEAM[k])
                    if k in SEAM else v.detach() for k, v in tree.items()})
    return tuple(out)


def full_model(state, mesh: Mesh, replica=None):
    """A model with the whole vocab for decoding (the reference replicates
    the parameters for its decode): the state's own without a seam, else
    ``replica`` (a model of the same configuration, made here when None)
    with the gathered parameters. A collective under a seam."""
    tensors = full_tensors(state, mesh)
    if tensors is None:
        return state.model
    if replica is None:
        m = state.model
        replica = create_model(m.cfg, m.vocab_size).to(mesh.device)
    with torch.no_grad():
        for k, p in replica.named_parameters():
            p.copy_(tensors[0][k])
    return replica.train(state.model.training)


# ---------------------------------------------------------- sharded steps

def make_sharded_step(mesh: Mesh, body):
    """Wrap a train-step body (XE, e2e or SCST: train/steps.py,
    train/scst.py) for ``mesh``: the body takes this rank's rows
    (:func:`shard_batch`) and runs its collectives through
    :class:`DataParallel`; on the card each step is one CUDA graph
    (``make_step``). Returns ``(step_fn, dp)``; pass ``dp`` to
    :func:`place_state`."""
    body.dp = DataParallel(mesh)
    return make_step(body, mesh.device), body.dp


def make_sharded_banked_step(mesh: Mesh, body, dataset, banks=None):
    """The sharded step with the device feature bank (``--feature-bank
    --sharded``): every rank keeps its own replica of the banks, so each
    gather stays on its card; the batch carries this rank's token rows and
    ``video_idx``. Returns ``(step_fn, banks, dp)``."""
    body.dp = DataParallel(mesh)
    step_fn, banks = make_banked_step(body, dataset, banks=banks,
                                      device=mesh.device)
    return step_fn, banks, body.dp


# ---------------------------------------------------------- sharded decode

def make_sharded_decode(captioner, mesh: Mesh, method: str = "beam",
                        beam_width: int = 5) -> Callable:
    """``fn(feats [B, T, D], frame_mask [B, T]) → tokens i32[B, L]``
    (numpy), the video batch split over the data axis: every rank calls it
    with the same batch, decodes its B/nd rows through ``captioner``'s
    single-card route (which honours ``decode.finished_pool`` and
    ``decode.int8_vocab_projection``), and the tokens are all-gathered
    over the data axis. B must divide by the data axis's size."""
    if method not in ("greedy", "beam"):
        raise ValueError(f"the sharded decode runs greedy or beam, not "
                         f"{method!r}")

    def run(feats, frame_mask):
        B = feats.shape[0]
        if B % mesh.num_data:
            raise ValueError(f"batch of {B} videos does not divide over "
                             f"the {mesh.num_data}-way data axis")
        n = B // mesh.num_data
        rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
        toks = captioner.decode_local(feats[rows], method=method,
                                      beam_width=beam_width,
                                      frame_mask=frame_mask[rows])
        toks = torch.as_tensor(np.ascontiguousarray(toks),
                               device=mesh.device)
        parts = [torch.empty_like(toks) for _ in range(mesh.num_data)]
        dist.all_gather(parts, toks, group=mesh.data_group)
        return torch.cat(parts).cpu().numpy()

    return run


# ----------------------------------------------------------------- serving

_STOP = {"stop": True}


def lead(method: str, beam_width: int, feats: np.ndarray,
         frame_mask: np.ndarray, mesh: Mesh) -> None:
    """Rank 0 of ``serve --sharded``: send the flush's method, features and
    mask to every rank (:func:`follow` receives them)."""
    hdr = [{"method": method, "beam_width": beam_width,
            "shape": list(feats.shape)}]
    dist.broadcast_object_list(hdr, src=0, device=_obj_device(mesh))
    for x in (feats, frame_mask):
        t = torch.as_tensor(np.ascontiguousarray(x, np.float32),
                            device=mesh.device)
        dist.broadcast(t, src=0)


def stop_followers(mesh: Mesh) -> None:
    dist.broadcast_object_list([_STOP], src=0, device=_obj_device(mesh))


def follow(captioner) -> int:
    """Ranks > 0 of ``serve --sharded``: decode every flush rank 0 sends,
    through the sharded decode, until it says stop. Returns the flushes
    decoded. Ignores SIGINT: rank 0 takes the interrupt and stops them."""
    import signal
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    mesh = captioner.mesh
    served = 0
    while True:
        hdr: List = [None]
        dist.broadcast_object_list(hdr, src=0, device=_obj_device(mesh))
        if hdr[0].get("stop"):
            return served
        shape = hdr[0]["shape"]
        feats = torch.empty(shape, device=mesh.device)
        mask = torch.empty(shape[:2], device=mesh.device)
        for t in (feats, mask):
            dist.broadcast(t, src=0)
        captioner.decode_batch(feats.cpu().numpy(), method=hdr[0]["method"],
                               beam_width=hdr[0]["beam_width"],
                               frame_mask=mask.cpu().numpy())
        served += 1


def _obj_device(mesh: Mesh):
    return mesh.device if mesh.device.type == "cuda" else None
