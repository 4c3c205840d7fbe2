"""Checkpoint and resume on ``torch.save``, as ``vidcap_tpu/train/
checkpoint.py`` does on orbax: the whole train state (parameters, optimizer
state, step, generator state) with the batch stream's position, one file a
step, ``{directory}/ckpt_<step>.pt``.

A save writes a temporary file and renames it over the target, so a crash
leaves the previous checkpoint whole; the newest ``max_to_keep`` are kept. A
``stage.json`` sidecar records the stage ("xe", "e2e", "scst") that wrote each
kept step, so that a resume sees a stage change and re-initialises the
optimizer instead of carrying the previous objective's moments.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

import torch

from vidcap_tpu_torch.data.pipeline import IteratorState
from vidcap_tpu_torch.train.state import TrainState

_FILE = re.compile(r"^ckpt_(\d+)\.pt$")


def _cpu(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tree.items()}


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _FILE.match(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, iter_state: Optional[IteratorState]
             = None, stage: Optional[str] = None, tensors=None) -> None:
        """iter_state: the batch stream's position after the batch this
        state consumed, so a resumed run replays the exact remaining stream
        (always written; [-1, -1, -1] when absent). stage: the stage that
        produced this state, for the sidecar. tensors: (params, mu, nu) to
        write in place of the state's (a rank's shards gathered into the
        whole model: parallel/sharding.py::full_tensors)."""
        opt = state.opt_state
        params, mu, nu = tensors or (dict(state.model.named_parameters()),
                                     opt["mu"], opt["nu"])
        payload = {
            "params": _cpu(params),
            "opt_state": {"count": int(opt["count"]), "mu": _cpu(mu),
                          "nu": _cpu(nu)},
            "step": state.step,
            "generator": state.generator.get_state(),
            "iter_state": ([iter_state.seed, iter_state.epoch,
                            iter_state.position] if iter_state is not None
                           else [-1, -1, -1]),
        }
        path = self._path(state.step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        if stage is not None:
            self._record_stage(state.step, stage)

    # ------------------------------------------------------------ stage sidecar

    def _stage_path(self) -> str:
        return os.path.join(self.directory, "stage.json")

    def _record_stage(self, step: int, stage: str) -> None:
        try:
            with open(self._stage_path()) as f:
                rec = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            rec = {}
        rec[str(step)] = stage
        # entries for the kept steps only; written atomically, since a torn
        # sidecar would hide a stage change from the next resume
        kept = {str(s) for s in self.all_steps()}
        rec = {k: v for k, v in rec.items() if k in kept}
        tmp = self._stage_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self._stage_path())

    def saved_stage(self, step: Optional[int] = None) -> Optional[str]:
        """The stage recorded for ``step`` (default: the latest), or None."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        try:
            with open(self._stage_path()) as f:
                return json.load(f).get(str(step))
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    # ------------------------------------------------------------ restore

    def _load(self, step: Optional[int]) -> dict:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    @staticmethod
    def _iter_state(raw) -> Optional[IteratorState]:
        s, e, p = (int(x) for x in raw)
        return IteratorState(seed=s, epoch=e, position=p) if s >= 0 else None

    @staticmethod
    def _verify_params_tree(template: Dict[str, torch.Tensor],
                            restored) -> None:
        """Raise unless the checkpoint's parameters have the template's
        names and shapes."""
        if not isinstance(restored, dict):
            raise ValueError("checkpoint has no 'params' entry — corrupt or "
                             "foreign checkpoint")
        if sorted(template) != sorted(restored):
            raise ValueError(
                "checkpoint params tree does not match the model template:\n"
                f"  template: {sorted(template)}\n"
                f"  checkpoint: {sorted(restored)}")
        for name, p in template.items():
            if tuple(p.shape) != tuple(restored[name].shape):
                raise ValueError(
                    f"checkpoint param {name} has shape "
                    f"{tuple(restored[name].shape)}, model expects "
                    f"{tuple(p.shape)}")

    @staticmethod
    def _restore_common(state: TrainState, payload: dict) -> None:
        params = state.params
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(payload["params"][name])
        state.step = int(payload["step"])
        state.generator.set_state(payload["generator"])

    def restore(self, state: TrainState, step: Optional[int] = None,
                with_iter: bool = False):
        """Restore into ``state`` (built with the same config), in place:
        parameters, optimizer state, step and generator; every tensor is
        written into the state's own, so nothing that holds their
        addresses (a captured step) goes stale. Returns the
        state, or (state, IteratorState | None) with ``with_iter``."""
        payload = self._load(step)
        self._verify_params_tree(state.params, payload.get("params"))
        opt = payload["opt_state"]
        if sorted(opt["mu"]) != sorted(state.opt_state["mu"]):
            raise ValueError("checkpoint optimizer state does not match this "
                             "stage's optimizer")
        self._restore_common(state, payload)
        mine = state.opt_state
        with torch.no_grad():
            mine["count"].fill_(int(opt["count"]))
            for m in ("mu", "nu"):
                for k, v in opt[m].items():
                    mine[m][k].copy_(v)
        if not with_iter:
            return state
        return state, self._iter_state(payload["iter_state"])

    def restore_params_only(self, state: TrainState,
                            step: Optional[int] = None,
                            with_iter: bool = False):
        """Cross-stage restore: parameters, step and generator from the
        checkpoint, the optimizer state reset to its initial values in
        place. The parameter tree is checked against the model's, so
        a mismatched checkpoint fails here."""
        payload = self._load(step)
        self._verify_params_tree(state.params, payload.get("params"))
        self._restore_common(state, payload)
        state.tx.reset(state.opt_state)
        if not with_iter:
            return state
        return state, self._iter_state(payload["iter_state"])
