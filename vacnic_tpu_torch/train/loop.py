"""The training loop (port of `fit`, vacnic_tpu/train/loop.py:47-134):
train steps, the cross-epoch teacher cache, validation with the greedy
`logit_output` dump, best and last checkpoints, `max_steps`.

`generate_captions` (beam decoding of a loader with caption metrics) waits
for the port of eval/caption_metrics and data/datasets, and its `mesh`
argument for multi-GPU decoding.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Iterable

import numpy as np
import torch

from vacnic_tpu_torch.core.config import VacnicConfig
from vacnic_tpu_torch.core.logging import MetricsLogger, get_logger
from vacnic_tpu_torch.train.checkpoints import CheckpointManager
from vacnic_tpu_torch.train.train_step import TrainState, device_of, eval_step

log = get_logger(__name__)


def _to_host(m: dict[str, torch.Tensor]) -> dict[str, Any]:
    """One device-to-host copy for all of a step's scalar metrics (a float()
    per metric would wait for the device once each); "teacher_pooled" comes
    back as a float32 array."""
    out = {}
    pooled = m.pop("teacher_pooled", None)
    if pooled is not None:
        out["teacher_pooled"] = pooled.float().cpu().numpy()
    keys = list(m)
    if keys:
        out.update(zip(keys, torch.stack([m[k].float() for k in keys]).tolist()))
    return out


def fit(cfg: VacnicConfig, state: TrainState, step_fn, train_loader: Iterable,
        val_loader: Iterable, out_dir: str, *, metrics: MetricsLogger | None = None,
        max_steps: int | None = None, tokenizer=None) -> TrainState:
    """Train for cfg.train.num_epochs (or max_steps), validating and saving
    `best` (min val loss, with val_outputs.json) and `last` after each epoch.
    The state is updated in place (step_fn's contract) and returned."""
    metrics = metrics or MetricsLogger(out_dir)
    ckpt_best = CheckpointManager(os.path.join(out_dir, "best"), cfg, max_to_keep=1)
    ckpt_last = CheckpointManager(os.path.join(out_dir, "last"), cfg, max_to_keep=2)
    dev = device_of(state.params["model"])

    min_val = float("inf")
    steps = 0
    # The frozen teacher is deterministic, so its pooled state per dataset row
    # is a constant: cached after its first computation (fp32, one d_model
    # vector a row, host memory), epochs >= 2 skip its forward.
    teacher_vecs: dict[int, np.ndarray] = {}
    use_tcache = cfg.train.teacher_cache and cfg.train.alpha > 0
    for epoch in range(cfg.train.num_epochs):
        t0 = time.time()
        for batch in train_loader:
            feed = dict(batch)
            idxs = None
            if use_tcache and "sample_idx" in batch:
                idxs = [int(i) for i in np.asarray(batch["sample_idx"])]
                if all(i in teacher_vecs for i in idxs):
                    feed["teacher_pooled"] = np.stack([teacher_vecs[i] for i in idxs])
            state, m = step_fn(state, feed)
            steps += 1
            m = _to_host(m)
            pooled = m.pop("teacher_pooled", None)
            if idxs is not None and pooled is not None:
                for j, i in enumerate(idxs):
                    teacher_vecs[i] = pooled[j]
            metrics.log(m, step=steps)
            if max_steps is not None and steps >= max_steps:
                break

        val_losses, out_dict = [], {}
        for vstep, batch in enumerate(val_loader):
            m = eval_step({"model": state.params["model"], "clip": state.params.get("clip")},
                          batch, cfg, device=dev)
            val_losses.append(float(m["val_loss"]))
            out_dict[vstep] = {"gt_cap": batch.get("caption", [])}
            if tokenizer is not None:
                # the reference decodes without skipping special tokens
                ids = m["argmax_ids"].cpu().numpy()
                out_dict[vstep]["logit_output"] = [
                    tokenizer.decode(ids[i], skip_special_tokens=False)
                    for i in range(ids.shape[0])]
        val_loss = float(np.mean(val_losses)) if val_losses else float("nan")
        metrics.log({"val_loss": val_loss, "epoch": epoch})
        log.info("epoch %d: val_loss %.4f (%.1fs)", epoch, val_loss, time.time() - t0)

        ckpt_last.save(steps, state, {"val_loss": val_loss})
        if val_loss < min_val:
            min_val = val_loss
            ckpt_best.save(steps, state, {"val_loss": val_loss})
            with open(os.path.join(out_dir, "val_outputs.json"), "w") as f:
                json.dump(out_dict, f)
            metrics.log({"min val loss": min_val})
        if max_steps is not None and steps >= max_steps:
            break
    ckpt_best.wait()
    ckpt_last.wait()
    return state
