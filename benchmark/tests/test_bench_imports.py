"""The import boundary: no module under benchmark/ imports JAX, Flax,
Optax, Orbax or the JAX package (compared by whole top-level names, so
vidcap_tpu_torch is not vidcap_tpu), and the reference imports nothing of
the program either."""
from __future__ import annotations

import ast
import os

import pytest

from benchmark import common

FORBIDDEN = {"jax", "flax", "optax", "orbax", "vidcap_tpu"}


def _modules():
    for base, _, files in os.walk(common.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, common.HERE))
def test_no_jax(path):
    assert not set(_top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    p for p in _modules() if os.sep + "reference" + os.sep in p),
    ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert "vidcap_tpu_torch" not in set(_top_names(path))


def test_the_match_is_by_whole_names():
    assert "vidcap_tpu_torch".split(".", 1)[0] not in FORBIDDEN
