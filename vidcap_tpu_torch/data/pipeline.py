"""Deterministic, checkpointable batch stream, as
``vidcap_tpu/data/pipeline.py``: every epoch's permutation is a pure function
of (seed, epoch) with the same numpy generator, so the two packages draw the
same batches from the same seed, and resuming from (epoch, position) replays
the exact remaining stream. Background prefetch is not ported (ROADMAP
Queue 1 item 12)."""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from vidcap_tpu_torch.data.loader import Batch, CaptionDataset


@dataclasses.dataclass
class IteratorState:
    """The stream's position, saved with each checkpoint."""

    seed: int
    epoch: int
    position: int


class DeterministicBatcher:
    """Shuffled caption batches of a fixed size; an epoch's tail shorter
    than a batch is skipped."""

    def __init__(self, dataset: CaptionDataset, batch_size: int,
                 state: Optional[IteratorState] = None, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.state = state or IteratorState(seed=seed, epoch=0, position=0)

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.state.seed, epoch]))
        return rng.permutation(self.dataset.num_captions)

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        if self.dataset.num_captions < self.batch_size:
            raise ValueError(f"{self.dataset.num_captions} captions cannot "
                             f"fill a batch of {self.batch_size}")
        st = self.state
        order = self._perm(st.epoch)
        if st.position + self.batch_size > len(order):
            self.state = IteratorState(st.seed, st.epoch + 1, 0)
            return self.__next__()
        sel = order[st.position: st.position + self.batch_size]
        self.state = IteratorState(st.seed, st.epoch,
                                   st.position + self.batch_size)
        ds = self.dataset
        vidx = ds.caption_video_idx[sel]
        return Batch(features=ds.features[vidx], tokens=ds.tokens[sel],
                     mask=ds.mask[sel], attributes=ds.attributes[vidx],
                     video_idx=vidx)
