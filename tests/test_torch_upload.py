"""The Captioner's upload of host inputs (``inference.py``) on the CPU: the
dtype features cross in, the chunks of the staging ring, and the rule that
any other dtype becomes f32 first. Features of a bf16 model go as bf16,
which the model's first operation would round them to, so the decode is the
same bit for bit. The ring itself runs on the card
(``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from vidcap_tpu_torch.config import get_preset
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.inference import (STAGING_BYTES, Captioner,
                                        staging_chunks, staging_dtype)

BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture(scope="module")
def cap():
    cfg = get_preset("synthetic_tiny")
    return Captioner.from_checkpoint(
        cfg, CaptionDataset.synthetic(cfg.data, num_videos=12), device="cpu")


def _inputs(cap, B=6, seed=0):
    T, D = cap.cfg.data.num_frames, cap.cfg.data.feature_dim
    g = np.random.default_rng(seed)
    feats = g.normal(size=(B, T, D)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, T // 2:] = 0.0          # masked tail frames
    return feats, mask


def test_init_state_from_bf16_features_equals_f32_bit_for_bit(cap):
    feats, mask = _inputs(cap)
    f, m = torch.from_numpy(feats), torch.from_numpy(mask)
    assert not torch.equal(f, f.to(BF16).float())   # the rounding is real
    a = cap.model.init_state(f, m)
    b = cap.model.init_state(f.to(BF16), m)
    for name in ("h", "c", "keys", "values"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("method,temperature,seed", [
    ("beam", 1.0, None), ("greedy", 1.0, None), ("sample", 0.7, 3)])
def test_decode_of_bf16_features_equals_f32(cap, method, temperature, seed):
    """The tokens from bf16 features equal those from f32 features, and
    ``decode_batch`` on host arrays (which uploads bf16) gives them too."""
    feats, mask = _inputs(cap)
    m = torch.from_numpy(mask)
    with torch.inference_mode():
        a, b = (cap._decode(f, m, method, 5, temperature, seed, 1)
                for f in (torch.from_numpy(feats),
                          torch.from_numpy(feats).to(BF16)))
    assert torch.equal(a, b)
    host = cap.decode_batch(feats, method=method, temperature=temperature,
                            seed=seed, frame_mask=mask)
    assert np.array_equal(host, a.numpy())
    assert cap.staged_uploads == 0   # no ring on the CPU


@pytest.mark.parametrize("compute_dtype,ndim,want", [
    (BF16, 3, BF16),    # features of a bf16 model
    (F32, 3, F32),      # features of an f32 model
    (BF16, 5, F32),     # pixels, which the backbone reads
    (F32, 5, F32)])
def test_staging_dtype(compute_dtype, ndim, want):
    assert staging_dtype(compute_dtype, ndim) == want


def test_the_captioner_uploads_features_bf16_and_the_rest_f32(cap):
    feats, mask = _inputs(cap)
    assert cap._upload(feats, features=True).dtype == BF16
    assert cap._upload(mask).dtype == F32
    assert cap._upload(np.zeros((2, 2, 4, 4, 3)), features=True).dtype == F32
    dev = torch.from_numpy(feats)
    assert cap._upload(dev, features=True).dtype == F32   # a tensor stays


def test_f64_features_round_to_f32_before_bf16(cap):
    """Rounded once, this f64 value goes to bf16's 1 + 2**-7; rounded to
    f32 first it lands on the midpoint 1 + 2**-8, which bf16 rounds to the
    even 1. The upload keeps the two roundings of the f32 path."""
    x = 1.0 + 2.0 ** -8 + 2.0 ** -30
    assert abs(x - (1 + 2 ** -7)) < abs(x - 1)       # the direct rounding
    assert float(np.float32(x)) == 1 + 2 ** -8
    T, D = cap.cfg.data.num_frames, cap.cfg.data.feature_dim
    feats = np.full((2, T, D), x, np.float64)
    got = cap._upload(feats, features=True)
    assert got.dtype == BF16 and bool((got.float() == 1.0).all())
    assert torch.equal(got, torch.from_numpy(feats.astype(np.float32)).to(BF16))


@pytest.mark.parametrize("n,itemsize", [
    (0, 2), (1, 4),
    (32 * 26 * 1536, 2),            # the serving flush: one chunk
    (1472 * 26 * 1536, 2),          # the bulk batch
    (1472 * 26 * 1536, 4),
    (STAGING_BYTES // 2 + 1, 2),    # one element past a buffer
    (100_000_007, 4)])
def test_staging_chunks_cover_the_input_in_the_fewest_that_fit(n, itemsize):
    chunks = staging_chunks(n, itemsize)
    ends = [0] + [b for _, b in chunks]
    assert [a for a, _ in chunks] == ends[:-1] and ends[-1] == n
    sizes = [b - a for a, b in chunks]
    assert all(0 < s * itemsize <= STAGING_BYTES for s in sizes)
    assert len(chunks) == -(-n * itemsize // STAGING_BYTES)
    assert all(s == sizes[0] for s in sizes[:-1])    # only the last ragged


def test_the_bulk_batch_is_eight_chunks_of_184_videos():
    video = 26 * 1536
    assert staging_chunks(1472 * video, 2) == [
        (i * 184 * video, (i + 1) * 184 * video) for i in range(8)]
    assert staging_chunks(32 * video, 2) == [(0, 32 * video)]
