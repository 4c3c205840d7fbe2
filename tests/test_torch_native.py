"""The port's native host library (vidcap_tpu_torch/native.py, built from
its own copy vidcap_tpu_torch/csrc/host/vidcap_native.cpp) against the
port's Python versions and the JAX package's library (vidcap_tpu.native):
the n-gram hash bit for bit, PTB tokenization, a reference's n-gram
entries (the same entries in the same order as the JAX library's), the
batch packer; the build (keyed under build/vidcap_tpu_torch/, two
processes building at once) and the Python fallback without g++."""
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

from test_torch_slice import PYTHONPATH, REPO
from vidcap_tpu import native as jax_native
from vidcap_tpu_torch import native
from vidcap_tpu_torch.data.vocab import ptb_tokenize
from vidcap_tpu_torch.objectives import reward_tables
from vidcap_tpu_torch.ops.ngram_hash import host_ngram_key


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.available():
        pytest.skip("no g++: the native library cannot be built")


def test_library_is_the_ports_own_build():
    so = native.so_path()
    assert os.path.dirname(so) == os.path.join(REPO, "build",
                                               "vidcap_tpu_torch")
    assert os.path.exists(so)
    assert native.SOURCE == os.path.join(
        REPO, "vidcap_tpu_torch", "csrc", "host", "vidcap_native.cpp")
    assert "-march=native" not in native.GXX_FLAGS
    # the code below the header comment is the JAX package's
    body = open(native.SOURCE).read().split("#include <cstdint>", 1)[1]
    ref = open(os.path.join(REPO, "native", "vidcap_native.cpp")).read()
    assert ref.split("#include <cstdint>", 1)[1] == body


def test_hash_parity():
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 5))
        toks = rng.integers(0, 30000, size=n).tolist()
        key = native.ngram_hash(toks, n)
        assert key == host_ngram_key(toks, n) == jax_native.ngram_hash(toks, n)
    with pytest.raises(ValueError):
        native.ngram_hash([1, 2], 3)


TEXTS = ["A man, is PLAYING guitar!", "  hello   world  ",
         "don't stop-me_now (ok)?", "x &amp; y &lt;z&gt;", "...", "",
         "The quick/brown\\fox", "tabs\tand\nnewlines"]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_parity(text):
    assert native.tokenize(text) == ptb_tokenize(text) == \
        jax_native.tokenize(text)


def test_tokenizer_lowercases_bytes_as_the_jax_library_does():
    """Both C++ copies lowercase byte by byte (ASCII only), where Python's
    ``str.lower`` lowercases every letter: a property of the reference's
    library, kept."""
    text = "Ünïcode CAFÉ 42"
    assert native.tokenize(text) == jax_native.tokenize(text) == \
        ["Ünïcode", "cafÉ", "42"]
    assert ptb_tokenize(text) == ["ünïcode", "café", "42"]


def test_ref_ngrams_match_python_and_the_jax_library():
    rng = np.random.default_rng(1)
    for _ in range(50):
        toks = rng.integers(4, 60, size=int(rng.integers(0, 20))).tolist()
        lo, hi, tf, order = native.ref_ngrams(toks)
        jlo, jhi, jtf, jorder = jax_native.ref_ngrams(toks)
        for a, b in ((lo, jlo), (hi, jhi), (tf, jtf), (order, jorder)):
            assert a.dtype == b.dtype and np.array_equal(a, b)   # same order
        entries = reward_tables._ref_entries(toks)
        assert entries == list(zip(lo.tolist(), hi.tolist(), tf.tolist(),
                                   order.tolist()))
        assert sorted(entries) == sorted(reward_tables._ref_entries_plain(toks))
        want = Counter((n, tuple(toks[i:i + n])) for n in range(1, 5)
                       for i in range(len(toks) - n + 1))
        assert sum(tf) == sum(want.values()) and len(tf) == len(want)


def test_encode_batch_packs_and_pads():
    rows = [[5, 6, 7], [8], [9, 10, 11, 12, 13, 14]]
    L, eos = 5, 2
    tokens = np.full((3, L), -1, np.int32)
    mask = np.full((3, L), -1, np.float32)
    flat = np.array(sum(rows, []), np.int32)
    lens = np.array([len(r) for r in rows], np.int32)
    i32 = native._i32p
    native._load().vc_encode_batch(
        flat.ctypes.data_as(i32), lens.ctypes.data_as(i32), 3, L, eos,
        tokens.ctypes.data_as(i32), mask.ctypes.data_as(native._f32p))
    np.testing.assert_array_equal(tokens, [[5, 6, 7, 2, 0], [8, 2, 0, 0, 0],
                                           [9, 10, 11, 12, 2]])
    np.testing.assert_array_equal(mask, [[1, 1, 1, 1, 0], [1, 1, 0, 0, 0],
                                         [1, 1, 1, 1, 1]])


_BUILD_ONE = """
import sys
from vidcap_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
assert native.available()
assert native.ngram_hash([7, 8, 9], 3) == (%d, %d)
print(native.so_path())
"""


def test_two_processes_building_at_once_both_load_a_good_library(tmp_path):
    code = _BUILD_ONE % host_ngram_key([7, 8, 9], 3)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env={**os.environ, "PYTHONPATH": PYTHONPATH},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert "unavailable" not in err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert os.listdir(tmp_path) == [os.path.basename(paths.pop())]


def test_without_gxx_python_counts(tmp_path, monkeypatch, capfd):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available()
    err = capfd.readouterr().err
    assert err.count("[vidcap] native lib unavailable") == 1
    assert native.ngram_hash([3, 4], 2) == host_ngram_key([3, 4], 2)
    assert native.ref_ngrams([3, 4, 5]) is None
    assert native.tokenize("a b") is None
    t = reward_tables.build_reward_tables([[[5, 6, 7], [5, 6]], [[8, 9]]])
    assert t.counter == "python"
    assert capfd.readouterr().err == ""   # the line is printed once
    assert os.listdir(tmp_path) == []
