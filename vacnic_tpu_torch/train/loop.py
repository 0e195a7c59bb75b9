"""The training loop (port of vacnic_tpu/train/loop.py): `fit` (train
steps, the cross-epoch teacher cache, validation with the greedy
`logit_output` dump, best and last checkpoints, `max_steps`) and
`generate_captions` (beam decoding of a loader, then the caption metrics,
as `{step: {gt, gen}}` + "bleu" + "other metrics").

Batches may hold numpy arrays or tensors on any device, as
data/pipeline.PrefetchLoader gives them; `sample_idx` is read back to the
host with one copy. `generate_captions` runs on "cuda" unless the caller
passes device="cpu", or over a `core/mesh.Mesh` when it is given one.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Iterable

import numpy as np
import torch

from vacnic_tpu_torch.core.config import VacnicConfig, dtype_of
from vacnic_tpu_torch.core.device import as_tensor, resolve_device
from vacnic_tpu_torch.core.logging import MetricsLogger, get_logger
from vacnic_tpu_torch.data.datasets import ascii_fold
from vacnic_tpu_torch.eval.caption_metrics import compute_caption_metrics
from vacnic_tpu_torch.core.mesh import Sharded
from vacnic_tpu_torch.infer.generate import generate_mm, generate_mm_sharded
from vacnic_tpu_torch.models.weights_io import tree_to
from vacnic_tpu_torch.train.checkpoints import CheckpointManager
from vacnic_tpu_torch.train.train_step import (TrainState, _image_features, create_mask,
                                               device_of, eval_step, face_mask_from_emb)

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
                idxs = torch.as_tensor(batch["sample_idx"]).tolist()  # one host copy
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


def _rowwise(fn, x):
    """fn on a tensor, or on each shard of a `Sharded` batch."""
    return x.map(fn) if isinstance(x, Sharded) else fn(x)


@torch.no_grad()
def generate_captions(cfg: VacnicConfig, params: dict, loader: Iterable, tokenizer, *,
                      out_path: str | None = None, compute_metrics: bool = True, mesh=None,
                      data_axis: str = "data", device=None) -> dict:
    """Beam-decode a loader -> `{step: {gt, gen}}` (+ metrics), written to
    `out_path` as JSON when given (gen_caption_from_loader_bart,
    train...match.py:480-559). Image features come from the batch's
    `image_cls`, else from params["clip"] on its `pixels`; the dtype is
    cfg.train.compute_dtype. The tree is moved to the device once, before
    the loop.

    With `mesh` (and no `device`), a batch whose rows divide the data axis
    decodes through `generate_mm_sharded`, each device running the search on
    its shard (the SPMD counterpart of the reference's per-rank DDP
    inference), and any other batch (a tail) through `generate_mm` on the
    axis's first device, as in JAX. Batches may be `Sharded`, as a
    `PrefetchLoader(sharding=)` gives them; the CLIP tower (pixels) runs on
    the first device."""
    if mesh is not None:
        if device is not None:
            raise ValueError("generate_captions: pass a mesh or a device, not both")
        n_data = len(mesh.data_devices(data_axis))
        dev = mesh.data_devices(data_axis)[0]
    else:
        dev = resolve_device(device)
    dtype = dtype_of(cfg.train.compute_dtype)
    params = tree_to(params, dev)
    out_dict: dict[Any, Any] = {}
    step_idx = 0
    for batch in loader:
        feed = {k: v if isinstance(v, Sharded) else as_tensor(v, dev)
                for k, v in batch.items() if not isinstance(v, (list, str))}
        sharded = mesh is not None and feed["article_ids"].shape[0] % n_data == 0
        if not sharded:
            feed = {k: v.gather(dev) if isinstance(v, Sharded) else v for k, v in feed.items()}
        if isinstance(feed.get("pixels"), Sharded):
            feed["pixels"] = feed["pixels"].gather(dev)
        src_ids = feed["article_ids"]
        img_cls = _image_features(params, feed, cfg, dtype)
        kwargs = {}
        if not cfg.fusion.only_image:
            kwargs = dict(face_features=feed["face_emb"],
                          face_mask=_rowwise(face_mask_from_emb, feed["face_emb"]),
                          name_ids=feed["names_art_ids"],
                          name_mask=_rowwise(create_mask, feed["names_art_ids"]))
        if sharded:
            seqs, _ = generate_mm_sharded(mesh, params["model"], src_ids,
                                          _rowwise(create_mask, src_ids), img_cls, cfg.bart,
                                          cfg.fusion, cfg.decode, dtype=dtype,
                                          data_axis=data_axis, **kwargs)
        else:
            seqs, _ = generate_mm(params["model"], src_ids, create_mask(src_ids), img_cls,
                                  cfg.bart, cfg.fusion, cfg.decode, dtype=dtype, device=dev,
                                  **kwargs)
        seqs = seqs.cpu().numpy()
        gts = batch.get("caption", [""] * seqs.shape[0])
        for i in range(seqs.shape[0]):
            gen = tokenizer.decode(seqs[i], skip_special_tokens=True)
            out_dict[step_idx] = {"gt": ascii_fold(gts[i]), "gen": ascii_fold(gen)}
            step_idx += 1

    if compute_metrics and out_dict:
        out_dict.update(compute_caption_metrics([(v["gen"], v["gt"]) for v in out_dict.values()]))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out_dict, f)
    return out_dict
