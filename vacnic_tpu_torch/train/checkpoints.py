"""Checkpoint and resume (port of vacnic_tpu/train/checkpoints.py, same
surface: save, restore, restore_raw, latest_step, wait, close, load_config).

The format is the port's own: `<directory>/<step>/state.pt`, one
`torch.save` of the whole TrainState (params, teacher, optimizer moments and
counts, step and the dropout seed), `metrics.json` beside it, and
`<directory>/config.json`, the config sidecar that both packages'
`VacnicConfig.from_json` read. Orbax's format is not read. A save is written
under a temporary name and renamed into place, so a step directory is
either whole or absent; the oldest steps beyond `max_to_keep` are deleted.
Saves are synchronous, so `wait` and `close` have nothing to do.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch

from vacnic_tpu_torch.core.config import VacnicConfig
from vacnic_tpu_torch.core.tree import leaves_with_path, tree_map
from vacnic_tpu_torch.train.optim import trainable
from vacnic_tpu_torch.train.train_step import TrainState

CONFIG_FILE = "config.json"
STATE_FILE = "state.pt"
FIELDS = ("step", "params", "teacher", "opt_state", "rng")


def _detached(tree: Any) -> Any:
    return tree_map(lambda _, x: x.detach() if isinstance(x, torch.Tensor) else x, tree)


def _mismatch(got: Any, want: Any, name: str) -> str | None:
    """The first difference in structure, shape or dtype between two trees."""
    g, w = leaves_with_path(got), leaves_with_path(want)
    if [p for p, _ in g] != [p for p, _ in w]:
        diff = sorted(set(p for p, _ in g) ^ set(p for p, _ in w), key=str)
        return f"{name}: the tree's structure differs (first at {diff[:1] or 'order'})"
    for (path, a), (_, b) in zip(g, w):
        if isinstance(a, torch.Tensor) != isinstance(b, torch.Tensor):
            return f"{name}{list(path)}: a tensor against a {type(b).__name__}"
        if isinstance(a, torch.Tensor) and (a.shape != b.shape or a.dtype != b.dtype):
            return (f"{name}{list(path)}: saved {tuple(a.shape)} {a.dtype}, "
                    f"template {tuple(b.shape)} {b.dtype}")
    return None


class CheckpointManager:
    def __init__(self, directory: str, cfg: VacnicConfig | None = None, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        if cfg is not None:
            with open(os.path.join(self.directory, CONFIG_FILE), "w") as f:
                f.write(cfg.to_json())

    def _steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit()
                      and os.path.isfile(os.path.join(self.directory, n, STATE_FILE)))

    def save(self, step: int, state: TrainState, metrics: dict | None = None) -> None:
        """Write the state at `step` (replacing a save of the same step), then
        drop the oldest steps beyond max_to_keep."""
        final = os.path.join(self.directory, str(int(step)))
        tmp = os.path.join(self.directory, f".tmp-{int(step)}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({f: _detached(getattr(state, f)) for f in FIELDS},
                   os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, "metrics.json"), "w") as f:
            json.dump({k: float(v) for k, v in (metrics or {}).items()}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def _load(self, step: int, device) -> dict:
        return torch.load(os.path.join(self.directory, str(step), STATE_FILE),
                          map_location=device, weights_only=True)

    def restore(self, state_template: TrainState, step: int | None = None
                ) -> tuple[TrainState, int]:
        """-> (a new TrainState on the template's device, step); the template
        itself when there is no checkpoint. The saved trees must match the
        template's structure, shapes and dtypes (ValueError naming the first
        leaf that does not); params' floating leaves require grad as the
        template's do."""
        step = self.latest_step() if step is None else step
        if step is None:
            return state_template, 0
        dev = state_template.params["model"]["shared"]["weight"].device
        raw = self._load(step, dev)
        for f in ("params", "teacher", "opt_state"):
            bad = _mismatch(raw[f], getattr(state_template, f), f)
            if bad:
                raise ValueError(f"checkpoint step {step}: {bad}")
        for (_, p), (_, t) in zip(leaves_with_path(raw["params"]),
                                  leaves_with_path(state_template.params)):
            if trainable(p):
                p.requires_grad_(t.requires_grad)
        return TrainState(**{f: raw[f] for f in FIELDS}), step

    def restore_raw(self, step: int | None = None) -> tuple[Any, int]:
        """Template-free restore: the saved dict {"step", "params", "teacher",
        "opt_state", "rng"} on the CPU, exactly as written, for callers whose
        tree the template cannot predict (an optional params["clip_text"])."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, 0
        return self._load(step, "cpu"), step

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing is held open between saves."""

    @staticmethod
    def load_config(directory: str) -> VacnicConfig:
        with open(os.path.join(directory, CONFIG_FILE)) as f:
            return VacnicConfig.from_json(f.read())
