"""The (data, model) grid of ranks, as ``vidcap_tpu/parallel/mesh.py``'s
``make_mesh``: data parallelism shards the batch over the ``data`` axis (the
gradients are summed over it by an all-reduce), and the optional ``model``
axis carries the vocab seam (the embedding's rows and the output
projection's columns split over it; parallel/sharding.py).

Rank ``r`` sits at data index ``r // num_model`` and model index
``r % num_model``, the reference's ``devices.reshape(num_data,
num_model)``. Every process of the group calls :func:`make_mesh` in the same
order, since each subgroup is made collectively.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from vidcap_tpu_torch.config import MeshConfig
from vidcap_tpu_torch.train.state import optax_global_norm


@dataclasses.dataclass
class Mesh:
    """This rank's place in the grid, its device and the process groups of
    its two axes (None for an axis of size 1, which needs no collective)."""

    num_data: int
    num_model: int
    rank: int
    device: torch.device
    data_group: Optional[object]    # the ranks that share this model index
    model_group: Optional[object]   # the ranks that share this data index

    @property
    def world(self) -> int:
        return self.num_data * self.num_model

    @property
    def data_index(self) -> int:
        return self.rank // self.num_model

    @property
    def model_index(self) -> int:
        return self.rank % self.num_model

    @property
    def shape(self) -> dict:
        return {"data": self.num_data, "model": self.num_model}


class OneRank:
    """A step body's collectives in one process: a data axis of one rank,
    where every sum over it is the identity and no vocab is split
    (parallel/sharding.py::DataParallel is a mesh's)."""

    nd = 1
    vocab = None

    def row0(self, rows: int) -> int:
        """The global row of this rank's first row, ``rows`` a rank."""
        return 0

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the data axis, without gradient."""
        return x.detach()

    def reduce_grads(self, grads):
        return grads

    def reduce_metrics(self, metrics):
        return metrics

    def global_norm(self, grads) -> torch.Tensor:
        return optax_global_norm(grads)


ONE_RANK = OneRank()


def make_mesh(cfg: Optional[MeshConfig] = None,
              num_data: Optional[int] = None,
              num_model: Optional[int] = None,
              device=None) -> Mesh:
    """The grid over the ranks of the initialized process group
    (parallel/distributed.py): ``num_model`` from ``cfg.num_model``,
    ``num_data`` from ``cfg.num_data`` (-1: the world over ``num_model``);
    raises where the grid does not cover the world. ``device``: this rank's
    device (default: the card ``LOCAL_RANK`` names when the group is NCCL,
    else the CPU). On the data axis the gradient all-reduce runs even for
    one data rank, so that a world of one runs the collectives too."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel/distributed.py::initialize_multihost)")
    cfg = cfg or MeshConfig()
    world, rank = dist.get_world_size(), dist.get_rank()
    nm = num_model if num_model is not None else cfg.num_model
    nd = num_data if num_data is not None else cfg.num_data
    if nd == -1:
        nd = world // nm
    if nd < 1 or nm < 1 or nd * nm != world:
        raise ValueError(f"mesh {nd}x{nm} does not cover {world} "
                         "processes")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    data_group = model_group = None
    if nm == 1:
        data_group = dist.group.WORLD
    else:
        for m in range(nm):   # every rank makes every group, in one order
            g = dist.new_group([d * nm + m for d in range(nd)])
            if rank % nm == m:
                data_group = g
        for d in range(nd):
            g = dist.new_group([d * nm + m for m in range(nm)])
            if rank // nm == d:
                model_group = g
    return Mesh(num_data=nd, num_model=nm, rank=rank,
                device=torch.device(device), data_group=data_group,
                model_group=model_group)
