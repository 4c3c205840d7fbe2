"""Shared pieces of the benchmark's tests: the checkout on ``sys.path``,
and cells shrunk to sizes the CPU holds (the widths of the program's
``synthetic_tiny`` preset, small batches, a small corpus)."""
from __future__ import annotations

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = dict(embed_dim=32, hidden_dim=32, attn_dim=32, feature_dim=64,
            num_frames=8, vocab_size=256, num_attributes=32,
            max_caption_len=12, max_len=12)
TRAFFIC = {   # by traffic kind
    "closed_beam": dict(batch=8, pool_batches=2, check_rows=48,
                        warm_decodes=1),
    "scst_train": dict(corpus=dict(
        videos=300, captions_per_video=5, pool_words=2000, zipf_s=1.0,
        length_min=3, length_nb_r=3, length_nb_mean=6.0, length_max=40)),
}


def tiny_cell(name: str):
    """Cell ``name`` at the synthetic_tiny widths and CPU-sized traffic,
    with its own limits."""
    from benchmark import common
    cell = copy.deepcopy(common.load_cell(name))
    cell["cfg"].update(TINY)
    cell["traffic_params"].update(copy.deepcopy(TRAFFIC[cell["traffic"]]))
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
