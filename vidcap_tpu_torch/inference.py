"""Inference API of the PyTorch package: weights → decode a dataset, greedy,
sampled or beam.

Runs on the card unless the caller asks for the CPU (``device="cpu"``). With
no card and no such request it raises; it never carries on on the CPU.
For the one-layer bf16 attention decoder (``models/decoding.py::
kernel_decoder``) greedy and sampled decode run through K3
(``ops/rollout.py``), beam through K1 and K2 (or K2's int8 variant with
``decode.int8_vocab_projection``), wherever the kernel takes the shape
(``ops/limits.py``: the beam width, the candidates a row, the widths, K3's
SMs and shared memory). Every other decoder, and every shape a kernel
refuses, runs its recurrent step through the model's modules on the same
device, as the JAX package runs such decoders through XLA, and its beam's
projection through K2 or K2-int8 wherever one takes it. With a mesh
(``Captioner(mesh=...)``, parallel/) greedy and beam split each batch over
the data axis; sampling stays on the rank. The beam takes the
finished-hypothesis pool (``beam_decode_pool``) where ``use_finished_pool``
says so, as the JAX package does. With ``model.use_backbone`` a batch may
be frame pixels f32[B, T, S, S, 3]: the decode encodes them through the
IRv2 backbone first (``model.init_state``), then runs the same kernels.
Host arrays reach the card through the Captioner's ring of page-locked
buffers (``StagingRing``), a chunk's copy under the host's work on the next;
the features of a bf16 model cross as bf16, which is what the model's
first operation on them rounds them to.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vidcap_tpu_torch.config import Config
from vidcap_tpu_torch.convert import load_weights
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.models.decoding import (BeamWeights,
                                              VocabProjection, beam_decode,
                                              beam_decode_pool,
                                              fused_beam_step, greedy_decode,
                                              kernel_decoder,
                                              module_beam_step,
                                              projection_kernel,
                                              require_full_f32, sample_decode,
                                              tile_recurrent,
                                              use_finished_pool)
from vidcap_tpu_torch.models.model import (VidCapModel, create_model,
                                           init_params)
from vidcap_tpu_torch.ops import _build
from vidcap_tpu_torch.ops.rollout import (RolloutWeights, model_rollout,
                                          resident_mode)
from vidcap_tpu_torch.parallel import sharding
from vidcap_tpu_torch.utils import profiling


# The staged upload of host inputs (``StagingRing``): page-locked buffers of
# 16 MiB, three of them. One holds the serving flush of 32 videos (2.5 MB
# bf16) whole and an eighth of a bulk batch of 1,472 (118 MB bf16: 8 chunks
# of 184 videos), so the host's converting copy of one chunk overlaps the
# copy to the card of the one before it, and the ring costs 48 MiB of
# pinned memory once, whatever the batch.
STAGING_BYTES = 16 << 20
STAGING_SLOTS = 3


def staging_dtype(compute_dtype: torch.dtype, ndim: int) -> torch.dtype:
    """The dtype a host input crosses to the device in: bf16 for features
    (rank 3) of a bf16 model, whose first operation on them (``feat_proj``,
    ``models/decoder.py::Dense``) rounds them to bf16, to nearest even on
    the host as on the card; f32 for pixels, which the backbone reads, and
    for an f32 model."""
    return (torch.bfloat16 if compute_dtype == torch.bfloat16 and ndim == 3
            else torch.float32)


def staging_chunks(n: int, itemsize: int) -> List[Tuple[int, int]]:
    """The ``[a, b)`` element ranges that cut ``n`` elements of
    ``itemsize`` bytes into the fewest near-even chunks that each fit one
    staging buffer."""
    chunks = max(1, -(-n // (STAGING_BYTES // itemsize)))
    step = max(1, -(-n // chunks))
    return [(a, min(a + step, n)) for a in range(0, n, step)]


class StagingRing:
    """Page-locked host buffers that every upload of one :class:`Captioner`
    reuses, allocated in its first upload (``warmup``'s decode) and kept.
    An upload cuts its array into chunks (:func:`staging_chunks`). Each
    chunk is written into the next buffer by one torch copy on the host's
    threads (converting f32 to the upload's dtype), then copied to the card
    on the current stream without blocking, and an event recorded after
    that copy says when the buffer may be written again. So a chunk crosses
    to the card while the host writes the next one. Nothing waits at the
    end: the decode follows the copies on the same stream. One upload at a
    time: a Captioner decodes one batch at a time."""

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs: List[torch.Tensor] = []
        self._free = [torch.cuda.Event() for _ in range(STAGING_SLOTS)]
        self._slot = 0

    def upload(self, x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """``x`` (f32 on the host) as ``dtype`` on the device."""
        if not self._bufs:
            self._bufs = [torch.empty(STAGING_BYTES, dtype=torch.uint8,
                                      pin_memory=True)
                          for _ in range(STAGING_SLOTS)]
        src = torch.from_numpy(np.ascontiguousarray(x).reshape(-1))
        out = torch.empty(x.shape, dtype=dtype, device=self.device)
        dst = out.view(-1)
        stream = torch.cuda.current_stream(self.device)
        size = dtype.itemsize
        for a, b in staging_chunks(src.numel(), size):
            slot = self._slot
            self._slot = (slot + 1) % STAGING_SLOTS
            self._free[slot].synchronize()   # its last copy has left
            buf = self._bufs[slot][:(b - a) * size].view(dtype)
            buf.copy_(src[a:b])
            dst[a:b].copy_(buf, non_blocking=True)
            self._free[slot].record(stream)
        return out


class NoDeviceError(RuntimeError):
    """The card was asked for (or implied) and none is visible."""


def resolve_device(device: Optional[str]) -> torch.device:
    """``None`` means the card. Raises when the card is asked for (or
    implied) and none is visible."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device is visible; vidcap_tpu_torch runs on the GPU "
            "unless asked for the CPU (device='cpu', CLI --device cpu)")
    return dev


class Captioner:
    """A model with its decode weights prepared once for the kernels.

    Host inputs reach the card through the Captioner's own
    :class:`StagingRing`. One ring is enough because calls to
    :meth:`decode_batch` run one at a time: the servers call it from one
    thread (``serving.py``)."""

    def __init__(self, cfg: Config, model: VidCapModel,
                 dataset: CaptionDataset, device: torch.device,
                 seed: Optional[int] = None, mesh=None):
        self.cfg = cfg
        # a mesh of ranks (parallel/mesh.py): greedy and beam split each
        # batch over its data axis (parallel/sharding.py); ``lead``: this
        # rank first sends each batch to the others (serve --sharded)
        self.mesh = mesh
        self.lead = False
        self._sharded: Dict[tuple, object] = {}
        self.model = model
        self.dataset = dataset
        self.device = device
        self.max_len = cfg.decode.max_len
        self.seed = seed              # None → wall-clock-seeded sampling
        self._sample_calls = 0        # makes successive sample seeds differ
        self._beam_weights: Optional[BeamWeights] = None
        self._vocab_proj: Optional[VocabProjection] = None   # other decoders
        self._rollout_weights: Optional[RolloutWeights] = None
        # K3's W_out mode of the last greedy/sample decode: True resident in
        # shared memory, False streamed from L2 (ops/rollout.py)
        self.rollout_resident: Optional[bool] = None
        self._feature_bank: Optional[torch.Tensor] = None
        self._staging: Optional[StagingRing] = None
        self.decode_calls = 0   # decode_batch calls run so far
        self.staged_uploads = 0   # of them, those whose features went
        #   through the staging ring (host arrays on the card)
        self.decode_steps = 0   # decode steps run so far, any method (early
        #   exit ends some beam decodes; a greedy/sample rollout runs max_len)

    @classmethod
    def from_checkpoint(cls, cfg: Config, dataset: CaptionDataset,
                        weights: Optional[str] = None,
                        device: Optional[str] = None,
                        seed: Optional[int] = None,
                        checkpoint_dir: Optional[str] = None,
                        mesh=None) -> "Captioner":
        """The parameters of the newest ``ckpt_<step>.pt`` in
        ``checkpoint_dir`` (train/checkpoint.py), or of ``weights``, a
        ``.npz`` of "/"-joined Flax paths (convert.py); with neither, the
        seeded init (``cfg.train.seed``). A named directory that holds no
        checkpoint raises FileNotFoundError rather than decoding random
        weights. ``seed`` makes sampled decodes reproducible. ``mesh``: this
        process is a rank of it, on its device; the parameters are
        replicated (``Captioner.decode_batch``)."""
        if weights and checkpoint_dir:
            raise ValueError("give weights or checkpoint_dir, not both")
        dev = mesh.device if mesh is not None else resolve_device(device)
        model = init_params(create_model(cfg, vocab_size=dataset.vocab.size),
                            seed=cfg.train.seed)
        if weights:
            load_weights(model, weights)
        elif checkpoint_dir:
            from vidcap_tpu_torch.train.checkpoint import CheckpointManager
            from vidcap_tpu_torch.train.state import create_train_state
            # (the manager makes its directory: never for an absent one)
            mgr = (CheckpointManager(checkpoint_dir)
                   if os.path.isdir(checkpoint_dir) else None)
            if mgr is None or mgr.latest_step() is None:
                raise FileNotFoundError(
                    f"no checkpoint found in {checkpoint_dir!r} — train "
                    "first, point --checkpoint-dir at a trained run, or pass "
                    "--weights W.npz")
            try:
                mgr.restore_params_only(create_train_state(cfg, model))
            except ValueError as e:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir!r} does not match the "
                    f"model built from this preset/dataset (vocab size "
                    f"{dataset.vocab.size} — wrong split or synthetic "
                    f"fallback?): {e}") from e
        return cls(cfg, model.to(dev).eval(), dataset, dev, seed=seed,
                   mesh=mesh)

    @classmethod
    def from_state(cls, cfg: Config, dataset: CaptionDataset, state,
                   mesh=None, model=None) -> "Captioner":
        """A captioner on a train state's model and device, sharing its
        parameters: the kernels' cast weights are made on the first decode,
        so call :meth:`reload_weights` (or build a new one) after the
        parameters change. ``model``: decode with this one instead (a rank's
        replica of the whole vocab under the seam); ``mesh``: as
        :meth:`from_checkpoint`."""
        model = model if model is not None else state.model
        return cls(cfg, model, dataset, next(model.parameters()).device,
                   mesh=mesh)

    def reload_weights(self) -> None:
        """Drop the kernels' cast weights: the next decode casts the
        parameters as they are then."""
        self._beam_weights = self._rollout_weights = self._vocab_proj = None

    def _sample_seed(self, seed: Optional[int]) -> int:
        """The caller's seed; else one derived from ``self.seed`` and a
        per-captioner call counter (distinct and reproducible); else the
        wall clock."""
        if seed is not None:
            return seed
        if self.seed is not None:
            self._sample_calls += 1
            return (self.seed * 1000003 + self._sample_calls) % (1 << 31)
        return time.time_ns() % (1 << 31)

    def decode_batch(self, feats: np.ndarray, method: str = "beam",
                     beam_width: int = 5, temperature: float = 1.0,
                     seed: Optional[int] = None,
                     frame_mask: Optional[np.ndarray] = None,
                     nbest: int = 1) -> np.ndarray:
        """feats f32[B, T, D] (numpy, or a tensor on the captioner's
        device), or pixels f32[B, T, S, S, 3] with ``model.use_backbone``
        (encoded first) → token ids i32[B, L]; with nbest > 1 (beam only)
        the nbest best hypotheses per video, i32[B, nbest, L], best first.
        ``temperature`` and ``seed`` apply to method="sample"; the seed goes
        to the card as a device int64, where K3 reads it. With a mesh,
        greedy and beam go through the sharded decode (every rank calls
        this with the same batch; B divides by the data axis) and sampling
        stays on this rank, as the reference routes them."""
        if self.mesh is None or method not in ("greedy", "beam"):
            return self.decode_local(feats, method, beam_width, temperature,
                                     seed, frame_mask, nbest)
        if nbest > 1:
            raise ValueError("nbest > 1 is single-device only — the sharded "
                             "decode returns the best hypothesis per video")
        if frame_mask is None:
            frame_mask = np.ones(feats.shape[:2], np.float32)
        if self.lead:
            host = lambda x: x.cpu().numpy() if torch.is_tensor(x) else x
            sharding.lead(method, beam_width, host(feats), host(frame_mask),
                          self.mesh)
        key = (method, beam_width)
        if key not in self._sharded:
            self._sharded[key] = sharding.make_sharded_decode(
                self, self.mesh, method, beam_width)
        return self._sharded[key](feats, frame_mask)

    @torch.inference_mode()
    def decode_local(self, feats: np.ndarray, method: str = "beam",
                     beam_width: int = 5, temperature: float = 1.0,
                     seed: Optional[int] = None,
                     frame_mask: Optional[np.ndarray] = None,
                     nbest: int = 1) -> np.ndarray:
        """:meth:`decode_batch` on this process's device alone. While
        tracing is on (``utils/profiling.py``) it records the spans
        ``captioner.decode`` around the call, ``captioner.upload`` (features
        and mask to the device: on the card the host's part of the staged
        upload, whose last copy may end after the span) and
        ``captioner.download`` (the tokens to the host), each with the
        call's number (:attr:`decode_calls` before it) as ``id``."""
        if method not in ("greedy", "sample", "beam"):
            raise ValueError(f"unknown decode method {method!r}")
        if nbest > 1 and method != "beam":
            raise ValueError(f"nbest={nbest} requires method='beam' "
                             "(greedy/sample decode one hypothesis)")
        if frame_mask is None:
            frame_mask = np.ones(feats.shape[:2], np.float32)
        call = self.decode_calls
        with profiling.annotate("captioner.decode", call):
            with profiling.annotate("captioner.upload", call):
                f = self._upload(feats, features=True)
                m = self._upload(frame_mask)
            toks = self._decode(f, m, method, beam_width, temperature, seed,
                                nbest)
            with profiling.annotate("captioner.download", call):
                return toks.cpu().numpy()

    def _upload(self, x, features: bool = False) -> torch.Tensor:
        """``x`` on the device. A tensor goes as f32. A host array is made
        f32 first, from any other dtype, then the ``features`` take
        :func:`staging_dtype` and the rest stay f32; on the card it goes
        through the staging ring."""
        if torch.is_tensor(x):
            return x.to(self.device, torch.float32)
        x = np.asarray(x, np.float32)
        dtype = (staging_dtype(self.model.decoder.feat_proj.compute_dtype,
                               x.ndim) if features else torch.float32)
        if self.device.type != "cuda":
            return torch.as_tensor(x).to(dtype)
        if self._staging is None:
            self._staging = StagingRing(self.device)
        if features:
            self.staged_uploads += 1
        return self._staging.upload(x, dtype)

    def _decode(self, f: torch.Tensor, m: torch.Tensor, method: str,
                beam_width: int, temperature: float, seed: Optional[int],
                nbest: int) -> torch.Tensor:
        """The decode of features ``f`` and mask ``m`` on the device: the
        token ids, still on the device."""
        if method == "beam":
            return self._beam(f, m, beam_width, nbest)
        sample = method == "sample"
        seed_t = (torch.tensor(self._sample_seed(seed), dtype=torch.int64,
                               device=self.device) if sample else 0)
        if not self._k3_takes(method, f.shape[1]):
            return self._module_rollout(f, m, sample, seed_t, temperature)
        if self._rollout_weights is None:
            self._rollout_weights = RolloutWeights.from_model(self.model)
        self.rollout_resident = resident_mode(self._rollout_weights,
                                              f.shape[1], self.device)
        r = model_rollout(self.model, f, m, self.max_len, sample=sample,
                          seed=seed_t,
                          temperature=temperature if sample else 1.0,
                          weights=self._rollout_weights,
                          resident_wout=self.rollout_resident)
        self.decode_calls += 1
        self.decode_steps += self.max_len
        return r.tokens

    def _counted(self, step):
        def counted_step(st, tok):
            self.decode_steps += 1
            return step(st, tok)
        return counted_step

    def _module_rollout(self, f: torch.Tensor, m: torch.Tensor, sample: bool,
                        seed: torch.Tensor, temperature: float
                        ) -> torch.Tensor:
        """Greedy or sampled decode of a decoder no kernel covers: the
        loops of ``models/decoding.py`` over ``CaptionDecoder.step`` (the
        JAX package's XLA path); the sampled noise is K3's counter hash."""
        require_full_f32(self.model, f.device)
        state = self.model.init_state(f, m)
        step = self._counted(self.model.decoder.step)
        if sample:
            r = sample_decode(step, state, f.shape[0], self.max_len, seed,
                              temperature)
        else:
            r = greedy_decode(step, state, f.shape[0], self.max_len,
                              early_exit=self.cfg.decode.early_exit,
                              with_logp=False)
        self.decode_calls += 1
        return r.tokens

    def _k3_takes(self, method: str, frames: int) -> bool:
        """Whether greedy/sampled decode of ``frames`` frames runs on K3
        (:func:`kernel_decoder` with this card's limits)."""
        return kernel_decoder(self.cfg.model, method, frames=frames,
                              padded_vocab=self.model.decoder.padded_vocab,
                              device=self.device)

    def _beam_route(self, beam_width: int):
        """(K1 takes the beam, the projection's kernel or None, candidates
        a row) for a beam of ``beam_width`` under this configuration."""
        n = beam_width + 1 if use_finished_pool(self.cfg.decode) \
            else beam_width
        return (kernel_decoder(self.cfg.model, "beam", beam_width),
                projection_kernel(self.cfg, n,
                                  self.model.decoder.padded_vocab), n)

    def kernels(self, method: str, beam_width: Optional[int] = None
                ) -> tuple:
        """The kernels ``method`` launches on the card for this model,
        decode configuration and shape (``beam_width``, default the
        preset's; the preset's frame count): :func:`kernel_decoder`,
        :func:`projection_kernel`. A shape a kernel refuses runs its step
        through the modules instead (ops/limits.py)."""
        if method != "beam":
            return (("rollout",) if self._k3_takes(
                method, self.cfg.data.num_frames) else ())
        recurrent, proj, _ = self._beam_route(
            beam_width or self.cfg.decode.beam_width)
        return (("beam_core",) if recurrent else ()) + ((proj,) if proj
                                                         else ())

    def warmup(self, method: str, batch_size: int, beam_width: int = 5
               ) -> None:
        """Pay before the first request what the first decode would pay:
        on the card the nvcc build of the kernels ``method`` launches (in
        parallel), then one decode of the flush shape, which casts the
        weights to the kernels' layouts and, for greedy/sample, probes K3's
        W_out mode. The servers call it before they take requests."""
        if self.device.type == "cuda":
            _build.build_all(self.kernels(method))
        T, D = self.cfg.data.num_frames, self.cfg.data.feature_dim
        self.decode_batch(np.zeros((batch_size, T, D), np.float32),
                          method=method, beam_width=beam_width,
                          frame_mask=np.ones((batch_size, T), np.float32))

    def _beam(self, f: torch.Tensor, m: torch.Tensor, beam_width: int,
              nbest: int) -> torch.Tensor:
        d = self.cfg.decode
        K = beam_width
        if not 1 <= nbest <= K:
            raise ValueError(f"nbest={nbest} must be in [1, beam_width={K}] "
                             "— the beam only carries K hypotheses")
        pool = use_finished_pool(d)
        recurrent, kernel, n = self._beam_route(K)   # n: candidates a row
        int8 = d.int8_vocab_projection
        if recurrent:
            w = self._beam_weights
            if w is None:
                w = BeamWeights.from_model(self.model, kernel, int8)
            elif w.proj.kernel != kernel:   # the same weights, cast once
                w = dataclasses.replace(w, proj=dataclasses.replace(
                    w.proj, kernel=kernel))
            self._beam_weights = w
            step = fused_beam_step(w, K, n)
        else:
            p = self._vocab_proj
            if p is None:
                p = VocabProjection.from_model(self.model, kernel, int8)
            elif p.kernel != kernel:
                p = dataclasses.replace(p, kernel=kernel)
            self._vocab_proj = p
            step = module_beam_step(self.model, K, p, n)
        B = f.shape[0]
        state = tile_recurrent(self.model.init_state(f, m), K)
        toks, _ = (beam_decode_pool if pool else beam_decode)(
            self._counted(step), state, batch=B, max_len=self.max_len,
            beam_width=K, length_penalty=d.length_penalty,
            early_exit=d.early_exit, return_all=nbest > 1)
        self.decode_calls += 1
        return toks[:, :nbest] if nbest > 1 else toks

    def caption_dataset(self, method: str = "beam", beam_width: int = 5,
                        temperature: float = 1.0, batch_size: int = 32,
                        nbest: int = 1, device_bank: bool = False
                        ) -> Dict[str, List[str]]:
        """Decode every video in the dataset → {video_id: [caption, ...]}
        (the nbest hypotheses best-first, or just the winner).

        device_bank: put the whole feature tensor on the device once (kept
        for later calls) and gather each batch's rows there by video index,
        as training's ``device_feature_bank`` does; the same rows, so the
        same captions."""
        results: Dict[str, List[str]] = {}
        vocab = self.dataset.vocab
        bank = None
        if device_bank and self.dataset.features.ndim == 3:
            if self._feature_bank is None:
                self._feature_bank = torch.as_tensor(
                    np.asarray(self.dataset.features, np.float32),
                    device=self.device)
            bank = self._feature_bank
        for batch in self.dataset.video_batches(batch_size):
            feats = batch.features if bank is None else bank.index_select(
                0, torch.as_tensor(batch.video_idx, device=self.device))
            toks = self.decode_batch(feats, method=method,
                                     beam_width=beam_width,
                                     temperature=temperature, nbest=nbest)
            for row, vidx in zip(toks, batch.video_idx):
                vid = self.dataset.video_ids[int(vidx)]
                if vid not in results:   # padded tail rows repeat the last video
                    results[vid] = ([vocab.decode_str(r) for r in row]
                                    if nbest > 1 else [vocab.decode_str(row)])
        return results
