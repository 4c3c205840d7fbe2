"""Metrics logging, as ``vidcap_tpu/utils/logging.py``: one JSON line per
logged step in a file, and a short line on stderr. (The JAX package's
optional TensorBoard writer needs TensorFlow and is not ported.)"""
from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional


def _to_float(v) -> float:
    return float(v.item()) if hasattr(v, "item") else float(v)


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, quiet: bool = False):
        self._f = open(path, "a") if path else None
        self.quiet = quiet
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, object],
            prefix: str = "train") -> None:
        row = {"step": int(step), "wall_s": round(time.time() - self._t0, 3),
               "prefix": prefix}
        row.update({k: _to_float(v) for k, v in metrics.items()})
        if self._f:
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()
        if not self.quiet:
            kv = " ".join(f"{k}={row[k]:.4g}" for k in metrics)
            print(f"[{prefix} {step}] {kv}", file=sys.stderr)

    def close(self) -> None:
        if self._f:
            self._f.close()
