"""64-bit n-gram hashing, bit-identical on the host (Python ints) and the
device (torch), and to ``vidcap_tpu/ops/ngram_hash.py``.

The device CIDEr/BLEU reward (objectives/reward.py) matches candidate
n-grams against the reference tables by hashed key. A key is two
independent 32-bit lanes (an effective 64-bit key), each an FNV/xorshift
rolling mix over the token ids, seeded per n-gram order so that no two
orders collide. torch has no uint32 arithmetic: the device lanes are int64
tensors holding values in [0, 2³²), and the multiply wraps through
``ops/rollout.py::_mul32``, as K3's counter hash does.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from vidcap_tpu_torch.ops.rollout import _mul32

_M1 = 0x01000193        # FNV-1a prime, lane 1
_M2 = 0x85EBCA6B        # murmur3 c1, lane 2
_ADD = 0x9E3779B9       # golden-ratio constant
_SEED1 = [0x811C9DC5, 0x1000193F, 0x2F0E1B85, 0x5BD1E995]   # per order, lane 1
_SEED2 = [0xC2B2AE35, 0x27D4EB2F, 0x165667B1, 0x9E3779B1]   # per order, lane 2
_MASK = 0xFFFFFFFF


def _mix_host(h: int, t: int, m: int) -> int:
    h = (h ^ ((t + _ADD) & _MASK)) & _MASK
    h = (h * m) & _MASK
    h ^= h >> 15
    return h & _MASK


def host_ngram_key(tokens: Sequence[int], order: int) -> Tuple[int, int]:
    """Hash an n-gram of ``order`` token ids → (lo, hi), each in [0, 2³²).
    ``tokens`` must have exactly ``order`` elements."""
    if len(tokens) != order or not 1 <= order <= 4:
        raise ValueError(f"host_ngram_key: {len(tokens)} tokens for an "
                         f"n-gram of order {order} (1..4)")
    h1, h2 = _SEED1[order - 1], _SEED2[order - 1]
    for t in tokens:
        h1 = _mix_host(h1, int(t), _M1)
        h2 = _mix_host(h2, int(t), _M2)
    return h1, h2


def _mix_device(h: torch.Tensor, t: torch.Tensor, m: int) -> torch.Tensor:
    h = h ^ ((t + _ADD) & _MASK)
    h = _mul32(h, m)
    return h ^ (h >> 15)


def device_ngram_keys(tokens: torch.Tensor, max_order: int = 4
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """tokens int[..., L] → (lo_keys, hi_keys), each a list of ``max_order``
    int64 tensors shaped like ``tokens``: element n-1 holds at position i
    the hash of tokens[..., i:i+n]. Positions with i+n > L hold garbage
    (the window wraps); callers mask them with the validity mask."""
    t = tokens.long() & _MASK
    los, his = [], []
    for n in range(1, max_order + 1):
        h1 = torch.full_like(t, _SEED1[n - 1])
        h2 = torch.full_like(t, _SEED2[n - 1])
        for k in range(n):
            # the token at position i+k, shifted into alignment with i
            tk = torch.roll(t, -k, dims=-1) if k else t
            h1 = _mix_device(h1, tk, _M1)
            h2 = _mix_device(h2, tk, _M2)
        los.append(h1)
        his.append(h2)
    return los, his
