"""The port's device reward against the JAX package: the n-gram hash bit for
bit, the reward tables equal, CIDEr-D and BLEU-4 within 1e-5 of the JAX
reward and of the host oracles (``vidcap_tpu/metrics/cider.py``,
``metrics/bleu.py``), on the corpora of tests/test_reward.py.

Tolerance: both rewards are f32 sums of the same products in another order
(einsum/bmm here, XLA's dots there); 1e-5 absolute plus 1e-5 relative covers
that and fails any wrong count, weight or norm (each moves a reward by
> 1e-3). The host oracles compute in float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidcap_tpu.data.loader import CaptionDataset as JaxDataset
from vidcap_tpu.metrics.bleu import sentence_bleu4
from vidcap_tpu.metrics.cider import CiderScorer
from vidcap_tpu.objectives import reward as jax_reward
from vidcap_tpu.objectives.reward_tables import \
    build_reward_tables as jax_build_tables
from vidcap_tpu.objectives.reward_tables import \
    tables_from_dataset as jax_tables_from_dataset
from vidcap_tpu.ops.ngram_hash import device_ngram_keys as jax_device_keys
from vidcap_tpu.ops.ngram_hash import host_ngram_key as jax_host_key
from vidcap_tpu_torch.config import get_preset
from vidcap_tpu_torch.data.loader import CaptionDataset
from vidcap_tpu_torch.objectives.reward import (bleu4_reward, cider_reward,
                                                scst_reward)
from vidcap_tpu_torch.objectives.reward_tables import (build_reward_tables,
                                                       tables_from_dataset)
from vidcap_tpu_torch.ops.ngram_hash import device_ngram_keys, host_ngram_key

TOL = dict(rtol=1e-5, atol=1e-5)


def _random_corpus(rng, n_videos=12, vocab=50, n_refs=(1, 4),
                   len_range=(3, 12)):
    """tests/test_reward.py's corpus."""
    refs = []
    for _ in range(n_videos):
        k = rng.integers(n_refs[0], n_refs[1] + 1)
        refs.append([rng.integers(4, vocab, size=rng.integers(*len_range))
                     .tolist() for _ in range(k)])
    return refs


def _pad_candidates(cands, L=16, eos=2):
    """Rollout-style rows: the caption, <eos>, then padding; the mask
    covers the <eos>."""
    toks = np.zeros((len(cands), L), np.int32)
    mask = np.zeros((len(cands), L), np.float32)
    for i, c in enumerate(cands):
        c = c[: L - 1]
        toks[i, : len(c)] = c
        toks[i, len(c)] = eos
        mask[i, : len(c) + 1] = 1.0
    return toks, mask


def _candidates(rng, refs, videos):
    """Per video: a reference itself, a perturbed one and random junk."""
    cands, vids = [], []
    for v in videos:
        base = list(refs[v][0])
        pert = list(base)
        if len(pert) > 2:
            pert[1] = int(rng.integers(4, 50))
        cands += [base, pert, rng.integers(4, 50, size=6).tolist()]
        vids += [v, v, v]
    return cands, vids


def _both(fn_port, fn_jax, refs, cands, vids):
    toks, mask = _pad_candidates(cands)
    port = fn_port(build_reward_tables(refs), torch.tensor(vids),
                   torch.tensor(toks), torch.tensor(mask)).numpy()
    ref = np.asarray(fn_jax(jax_build_tables(refs), jnp.asarray(vids),
                            jnp.asarray(toks), jnp.asarray(mask)))
    return port, ref


def test_hash_matches_jax_bit_for_bit():
    """Device keys over token ids up to 2^31-1 (the uint32 wrap) equal the
    JAX package's device keys and both host keys, per order and lane."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 30_000, size=(4, 11)).astype(np.int32)
    toks[0, :4] = 2**31 - 1
    los, his = device_ngram_keys(torch.tensor(toks))
    jlos, jhis = jax_device_keys(jnp.asarray(toks))
    for n in range(1, 5):
        np.testing.assert_array_equal(los[n - 1].numpy(),
                                      np.asarray(jlos[n - 1]).astype(np.int64))
        np.testing.assert_array_equal(his[n - 1].numpy(),
                                      np.asarray(jhis[n - 1]).astype(np.int64))
        for b in range(4):
            for i in range(11 - n + 1):
                gram = toks[b, i: i + n].tolist()
                key = host_ngram_key(gram, n)
                assert key == jax_host_key(gram, n)
                assert key == (int(los[n - 1][b, i]), int(his[n - 1][b, i]))
    with pytest.raises(ValueError):
        host_ngram_key([1, 2], 3)


def _canonical(t):
    """A table's content independent of slot order (the JAX package may
    count a reference's n-grams in its native extension, in another entry
    order): per (video, reference) the sorted (order, lo, hi, tf, idf)
    entries; the norms, lengths and counts; the IDF table as a dict."""
    a = {f: np.asarray(getattr(t, f) if not hasattr(getattr(t, f), "numpy")
                       else getattr(t, f).numpy())
         for f in ("ref_key_lo", "ref_key_hi", "ref_tf", "ref_idf",
                   "ref_order", "ref_norm", "ref_len", "ref_valid",
                   "num_refs", "idf_key_lo", "idf_key_hi", "idf_val")}
    V, R, G = a["ref_order"].shape
    entries = [[sorted((int(a["ref_order"][v, r, g]),
                        int(a["ref_key_lo"][v, r, g]),
                        int(a["ref_key_hi"][v, r, g]),
                        float(a["ref_tf"][v, r, g]),
                        float(a["ref_idf"][v, r, g]))
                       for g in range(G) if a["ref_order"][v, r, g] > 0)
                for r in range(R)] for v in range(V)]
    idf = {(int(lo), int(hi)): float(w) for lo, hi, w in zip(
        a["idf_key_lo"], a["idf_key_hi"], a["idf_val"]) if lo or hi}
    return entries, idf, {f: a[f] for f in ("ref_norm", "ref_len",
                                            "ref_valid", "num_refs")}


def test_tables_equal_jax_tables():
    """The tables of a random corpus with ref-less videos, and of the
    synthetic dataset, hold the JAX package's entries, IDF weights, norms,
    lengths and counts."""
    from vidcap_tpu.config import get_preset as jax_get_preset
    refs = _random_corpus(np.random.default_rng(4)) + [[], []]
    cfg = get_preset("synthetic_tiny").data
    pairs = [(build_reward_tables(refs), jax_build_tables(refs)),
             (tables_from_dataset(CaptionDataset.synthetic(cfg)),
              jax_tables_from_dataset(JaxDataset.synthetic(
                  jax_get_preset("synthetic_tiny").data)))]
    for port, ref in pairs:
        assert port.log_n == ref.log_n
        (pe, pi, pa), (je, ji, ja) = _canonical(port), _canonical(ref)
        assert pe == je and pi == ji
        for name in pa:   # norms: float64 sums in entry order, then f32
            np.testing.assert_allclose(pa[name], ja[name], rtol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("seed,refless", [(0, 0), (1, 0), (2, 0), (7, 3)])
def test_cider_matches_jax_and_host_oracle(seed, refless):
    """Random corpora (tests/test_reward.py), one with ref-less videos
    appended: the port's CIDEr-D equals the JAX reward and the oracle."""
    rng = np.random.default_rng(seed)
    refs = _random_corpus(rng)
    cands, vids = _candidates(rng, refs, range(len(refs)))
    refs = refs + [[]] * refless
    port, ref = _both(cider_reward, jax_reward.cider_reward, refs, cands,
                      vids)
    oracle = CiderScorer({str(v): [list(map(int, r)) for r in rs]
                          for v, rs in enumerate(refs)})
    host = np.array([oracle.score(str(v), c) for v, c in zip(vids, cands)])
    np.testing.assert_allclose(port, ref, **TOL)
    np.testing.assert_allclose(port, host, **TOL)
    assert (host > 1.0).any() and (host < 0.5).any()   # not a trivial corpus


@pytest.mark.parametrize("seed", [0, 3])
def test_bleu4_matches_jax_and_host_oracle(seed):
    rng = np.random.default_rng(seed)
    refs = _random_corpus(rng)
    cands, vids = _candidates(rng, refs, range(len(refs)))
    port, ref = _both(bleu4_reward, jax_reward.bleu4_reward, refs, cands,
                      vids)
    host = np.array([sentence_bleu4([list(r) for r in refs[v]], c)
                     for v, c in zip(vids, cands)])
    np.testing.assert_allclose(port, ref, **TOL)
    np.testing.assert_allclose(port, host, **TOL)


def test_empty_candidate_and_bleu_mix():
    """An immediate <eos> scores 0 in both rewards; the cider_bleu mix is
    (1 - m)·CIDEr + m·BLEU-4, as the JAX package's."""
    refs = [[[5, 6, 7]], [[8, 9]]]
    t = build_reward_tables(refs)
    toks = torch.tensor([[2, 0, 0, 0]])
    mask = torch.tensor([[1.0, 0, 0, 0]])
    vid = torch.tensor([0])
    assert cider_reward(t, vid, toks, mask).item() == pytest.approx(0, abs=1e-6)
    assert bleu4_reward(t, vid, toks, mask).item() == pytest.approx(0, abs=1e-6)
    rng = np.random.default_rng(5)
    refs = _random_corpus(rng)
    cands, vids = _candidates(rng, refs, range(4))
    toks, mask = _pad_candidates(cands)
    args = (torch.tensor(vids), torch.tensor(toks), torch.tensor(mask))
    port = scst_reward(build_reward_tables(refs), *args, bleu_mix=0.3)
    ref = jax_reward.scst_reward(jax_build_tables(refs), jnp.asarray(vids),
                                 jnp.asarray(toks), jnp.asarray(mask), 0.3)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)
