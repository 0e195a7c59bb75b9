"""Two-group AdamW with linear warmup (port of vacnic_tpu/train/optim.py).

Group "bart" (everything but the CLIP towers) at lr_bart, group "clip"
(params["clip"] and params["clip_text"]) at lr_clip or frozen
(freeze_clip, the default: the reference never steps its CLIP optimizer).
Each group does what the JAX package's optax chain does, in its order:
optional global-norm clipping (bart only; off by default), Adam with bias
correction and eps outside the square root, weight decay added after Adam,
then the scaling by -schedule(count). A frozen group is left untouched
(optax's set_to_zero).

`torch.optim.AdamW` has no bf16 moments over f32 parameters and sums in
another order on its fused and foreach paths, so the update is written here
over the parameter tree as plain torch ops, in float32, and applied in
place: each operation elementwise, in optax's order, over lists of leaves
(torch._foreach_*), which round as the same operation leaf by leaf does.
Its state is a tree of tensors (and the step count) that a checkpoint saves
as it is.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from vacnic_tpu_torch.core.config import TrainConfig
from vacnic_tpu_torch.core.tree import leaves_with_path, tree_map

CLIP_KEYS = ("clip", "clip_text")
# leaves a round of the update takes as one list: torch's _foreach ops run
# each operation over the list in one call (a few launches, not one per
# leaf: the update was host-bound), and the chunk bounds the temporaries
CHUNK = 64


def linear_warmup_schedule(base_lr: float, num_training_steps: int, warmup_rate: float):
    """HF get_linear_schedule_with_warmup: 0 -> lr over the warmup steps,
    lr -> 0 over the rest; count -> np.float32, computed in float32 as the
    JAX schedule is (so lr is exactly 0 at count 0)."""
    warmup = max(1, int(warmup_rate * num_training_steps))
    f32 = np.float32

    def sched(count: int) -> np.float32:
        step = min(int(count), num_training_steps)
        if step < warmup:
            frac = f32(step) / f32(warmup)
        else:
            frac = max(f32(0.0), f32(num_training_steps - step)
                       / f32(max(1, num_training_steps - warmup)))
        return f32(base_lr) * f32(frac)

    return sched


def is_clip(path: tuple) -> bool:
    """The CLIP group: any key of the path is "clip" (vision tower) or
    "clip_text" (text tower)."""
    return any(k in CLIP_KEYS for k in path if isinstance(k, str))


def trainable(leaf: Any) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor given (None skipped):
    each tensor's norm in one list call, then the norm of those."""
    norms = torch._foreach_norm([t.float() for t in tensors if t is not None])
    return torch.linalg.vector_norm(torch.stack(norms))


_add, _mul = torch._foreach_add, torch._foreach_mul


def _as(x: float, dtype: torch.dtype) -> float:
    """x rounded to `dtype` (a Python float times a bf16 tensor in JAX)."""
    return float(torch.tensor(x, dtype=dtype))


class _Group:
    def __init__(self, lr: float, num_training_steps: int, warmup_rate: float, cfg: TrainConfig,
                 clip_norm: float | None, mu_dtype, nu_dtype):
        self.sched = linear_warmup_schedule(lr, num_training_steps, warmup_rate)
        self.cfg = cfg
        self.clip_norm = clip_norm
        self.mu_dtype = mu_dtype or torch.float32
        # a bf16 second moment takes the low-precision recipe of
        # vacnic_tpu/train/optim.py:30-69 (its own order of operations)
        self.low_precision = nu_dtype is not None
        self.nu_dtype = nu_dtype or torch.float32

    def init(self, params, member) -> dict:
        def zeros(dtype):
            return tree_map(lambda path, p: torch.zeros_like(p, dtype=dtype)
                            if trainable(p) and member(path) else None, params)

        return {"count": 0, "mu": zeros(self.mu_dtype), "nu": zeros(self.nu_dtype)}

    @torch.no_grad()
    def step_(self, params, grads, state) -> None:
        c = self.cfg
        b1, b2, eps, wd = c.adam_b1, c.adam_b2, c.adam_eps, c.weight_decay
        mus = leaves_with_path(state["mu"])
        nus = leaves_with_path(state["nu"])
        ps = [p for _, p in leaves_with_path(params)]
        rows = [(p, g, m, n) for p, g, (_, m), (_, n) in zip(ps, grads, mus, nus)
                if m is not None]
        rows = [(p, torch.zeros_like(p) if g is None else g.float(), m, n)
                for p, g, m, n in rows]
        if self.clip_norm is not None:
            g_norm = global_norm([g for _, g, _, _ in rows])
            keep = g_norm < self.clip_norm
            rows = [(p, torch.where(keep, g, (g / g_norm) * self.clip_norm), m, n)
                    for p, g, m, n in rows]
        count = state["count"] + 1
        f32 = np.float32
        c1 = float(f32(1) - f32(b1) ** f32(count))
        c2 = float(f32(1) - f32(b2) ** f32(count))
        neg_lr = -float(self.sched(state["count"]))
        for i in range(0, len(rows), CHUNK):
            p_, g_, m_, n_ = (list(x) for x in zip(*rows[i:i + CHUNK]))
            if self.low_precision:
                m32 = _add(_mul([m.float() for m in m_], b1), _mul(g_, 1 - b1))
                n32 = _add(_mul([n.float() for n in n_], b2), _mul(_mul(g_, 1 - b2), g_))
            else:  # optax.scale_by_adam: JAX's weak typing rounds b1 to m's dtype first
                m32 = _add(_mul(g_, 1 - b1), _mul(m_, _as(b1, m_[0].dtype)))
                n32 = _add(_mul(_mul(g_, g_), 1 - b2), _mul(n_, _as(b2, n_[0].dtype)))
            u = torch._foreach_div(torch._foreach_div(m32, c1), _add(
                torch._foreach_sqrt(torch._foreach_div(n32, c2)), eps))
            u = _mul(_add(u, _mul(p_, wd)), neg_lr)
            torch._foreach_add_(p_, u)
            torch._foreach_copy_(m_, m32)
            torch._foreach_copy_(n_, n32)
        state["count"] = count


class Optimizer:
    """The two groups over a tree {"model": ..., "clip"?: ..., "clip_text"?:
    ...}. `init(params)` -> state; `step_(params, grads, state)` updates
    params and state in place, grads being the list of leaf gradients in
    `leaves_with_path(params)` order (None: no gradient, taken as zero)."""

    def __init__(self, cfg: TrainConfig, num_training_steps: int, train_clip: bool = False,
                 mu_dtype=None, nu_dtype=None):
        self.bart = _Group(cfg.lr_bart, num_training_steps, cfg.warmup_rate, cfg,
                           None if cfg.no_clip_norm else cfg.clip_norm, mu_dtype, nu_dtype)
        self.clip = (_Group(cfg.lr_clip, num_training_steps, cfg.warmup_rate, cfg, None,
                            None, None) if train_clip else None)

    def init(self, params) -> dict:
        state = {"bart": self.bart.init(params, lambda path: not is_clip(path))}
        if self.clip is not None:
            state["clip"] = self.clip.init(params, is_clip)
        return state

    def step_(self, params, grads: list, state: dict) -> None:
        self.bart.step_(params, grads, state["bart"])
        if self.clip is not None:
            self.clip.step_(params, grads, state["clip"])


def make_optimizer(cfg: TrainConfig, num_training_steps: int, train_clip: bool = False,
                   mu_dtype=None, nu_dtype=None) -> Optimizer:
    """`mu_dtype=torch.bfloat16` keeps the first moment in bf16;
    `nu_dtype=torch.bfloat16` the second too (the low-precision Adam: update
    math in f32, only the carried state in bf16)."""
    return Optimizer(cfg, num_training_steps, train_clip, mu_dtype, nu_dtype)
