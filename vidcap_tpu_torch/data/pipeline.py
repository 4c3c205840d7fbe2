"""Deterministic, checkpointable batch stream, as
``vidcap_tpu/data/pipeline.py``: every epoch's permutation is a pure function
of (seed, epoch) with the same numpy generator, so the two packages draw the
same batches from the same seed, and resuming from (epoch, position) replays
the exact remaining stream. ``PrefetchBatcher`` draws ahead on a background
thread (``train.prefetch_depth``) and keeps the position of what its
consumer has taken, so a checkpoint of it resumes exactly."""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from vidcap_tpu_torch.data.loader import Batch, CaptionDataset


@dataclasses.dataclass
class IteratorState:
    """The stream's position, saved with each checkpoint."""

    seed: int
    epoch: int
    position: int

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d) -> "IteratorState":
        return cls(int(d["seed"]), int(d["epoch"]), int(d["position"]))


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


class PrefetchBatcher:
    """A batcher drawn ``depth`` batches ahead on a background thread.

    The producer ships each batch with the batcher's state after drawing
    it, so ``.state`` is the position after the last batch the consumer
    took, however far the producer has run ahead: a checkpoint of it
    replays exactly the batches the train loop has not seen. An error of
    the batcher reaches the consumer at the batch where it happened."""

    def __init__(self, batcher: DeterministicBatcher, depth: int = 2):
        self.batcher = batcher
        self._state = batcher.state          # the consumer's resume point
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self) -> None:
        while not self._stop.is_set():
            try:
                item = (next(self.batcher), self.batcher.state, None)
            except Exception as e:   # handed to the consumer, raised there
                self._put((None, None, e))
                return
            if not self._put(item):
                return

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        batch, state_after, err = self._q.get()
        if err is not None:
            raise err
        self._state = state_after
        return batch

    @property
    def state(self) -> IteratorState:
        """The resume point after everything the consumer has taken."""
        return self._state

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
