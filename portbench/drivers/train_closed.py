"""The released training step in a closed loop: back-to-back steps of the
port's `make_train_step` (bf16 compute over f32 trees, remat, dropout 0.1,
the CoLaM teacher, SECLA, CLIP frozen on 224-px pixels), each step on a
batch of its own drawn from the seed.

Set-up: the kernel library, the trees on the card from the seed (f32), the
step function and its state, and the first three steps through the
window's own call on batches of their own: these warm every shape, the
check reads the program's state after them, and the third one's time sizes
the pool of distinct batches the window draws on (as many as the window
would take at that pace, and POOL_SPARE more). Window: steps until
--seconds have passed; every step's samples count, over the time until
the last one ended.

End-to-end: train_samples_per_s, setup_s. Traced run: the untraced window
gives the model FLOP rate (mfu), then `trace_steps` steps under the
profiler.

Correct: the plain reference (portbench/reference/train.py, float32) runs
the first three steps from the same trees, seed and batches. Read: each
step's loss (the largest gap over the three, relative to the reference's),
the first step's gradient of each bart leaf (from the program's first
moment after one step, mu / (1 - b1)), and each bart leaf's change over the
three steps; the gradient and the change by the worst leaf and by the
median leaf: the gap between the program's norm and the reference's over
the larger of the reference's norm of that leaf and of the median leaf.
Leaves whose reference gradient is under a thousandth of the median leaf's
are left out. The cell's `limits` name the numbers compared; the others
are printed."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import costs, harness, weights
from portbench.reference import model as ref
from portbench.reference import train as reft
from portbench.trace import capture
from portbench.traffic.synthetic import synthetic_batch

CHECKED_STEPS = 3
POOL_SPARE = 3  # batches beyond the window's pace: a run a tenth faster still finds fresh ones


def _leaves(tree):
    return [t for _, t in reft._leaves(tree)]


def draw_batch(ctx, i: int) -> dict:
    """The i-th training batch of the run, from the seed, on the device."""
    s = ctx.sizes
    b = synthetic_batch(s, int(s["train_batch_size"]), seed=ctx.sub_seed(1, i), with_pixels=True)
    return {k: torch.from_numpy(v).to(ctx.device) for k, v in b.items()}


def build(ctx: harness.Context):
    from vacnic_tpu_torch.train.train_step import make_train_step

    cfg = ctx.port_config()
    if ctx.device.startswith("cuda"):
        from vacnic_tpu_torch.kernels import _build

        _build.lib()
    params, teacher = weights.make_training_trees(ctx.sizes, ctx.sub_seed(0), ctx.device)
    init_fn, step_fn = make_train_step(cfg, int(ctx.spec["num_training_steps"]),
                                       device=ctx.device)
    state = init_fn(params, teacher, ctx.sub_seed(3))
    return cfg, state, step_fn, [draw_batch(ctx, i) for i in range(CHECKED_STEPS)]


def program_readings(ctx, state, step_fn, batches) -> tuple[dict, float]:
    """The first CHECKED_STEPS steps of the program, and what the check
    reads of them: each step's loss, the first step's gradient norms (from
    the first moment), the bart leaves' change norms after the last;
    and the last step's seconds."""
    b1 = ctx.sizes["adam_b1"]
    losses, grad_norms = [], None
    for i in range(CHECKED_STEPS):
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[i])
        losses.append(float(m["loss"]))  # waits for the step
        step_s = time.perf_counter() - t0
        if i == 0:
            mu = _leaves(state.opt_state["bart"]["mu"]["model"])
            grad_norms = [float(torch.linalg.vector_norm(t.float())) / (1 - b1) for t in mu]
    p0, _ = weights.make_training_trees(ctx.sizes, ctx.sub_seed(0), ctx.device)
    with torch.no_grad():
        change = [float(torch.linalg.vector_norm(a.detach() - b))
                  for a, b in zip(_leaves(state.params["model"]), _leaves(p0["model"]))]
    del p0
    return {"loss": losses, "grad_norms": grad_norms, "change": change}, step_s


def reference_readings(ctx, batches, prec: str = "f32", rows: int | None = None) -> dict:
    """The same readings of the plain reference (in `prec`; on the first
    `rows` rows of each batch where given: the half-batch fault)."""
    params, teacher = weights.make_training_trees(ctx.sizes, ctx.sub_seed(0), ctx.device)
    p0 = [t.clone() for t in _leaves(params["model"])]
    r = ref.Model(ctx.sizes, prec, rate=ctx.sizes["dropout"])
    use = batches[:CHECKED_STEPS] if rows is None else [
        {k: v[:rows] for k, v in b.items()} for b in batches[:CHECKED_STEPS]]
    out = reft.train(r, params, teacher, use, ctx.sub_seed(3), CHECKED_STEPS,
                     int(ctx.spec["num_training_steps"]))
    with torch.no_grad():
        change = [float(torch.linalg.vector_norm(a - b)) for a, b in zip(out["bart"], p0)]
    return {"loss": out["loss"], "grad_norms": out["grad_norms"], "change": change}


def leaf_gaps(got: dict, want: dict, key: str) -> tuple[np.ndarray, np.ndarray]:
    """(each kept bart leaf's gap of `key` norms, over the larger of the
    reference's norm of that leaf and of the median leaf; the kept leaves'
    indices). Kept: the leaves whose reference gradient is at least a
    thousandth of the median leaf's."""
    g_ref = np.asarray(want["grad_norms"])
    kept = np.flatnonzero(g_ref >= 1e-3 * np.median(g_ref))
    p, r = np.asarray(got[key])[kept], np.asarray(want[key])[kept]
    return np.abs(p - r) / np.maximum(r, np.median(r)), kept


def compare(got: dict, want: dict) -> dict:
    """The check's numbers (module docstring): the worst leaf's gaps, and
    the median leaf's beside them."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
    grad, kept = leaf_gaps(got, want, "grad_norms")
    change, _ = leaf_gaps(got, want, "change")
    return {"loss_gap": loss, "grad_norm_gap": float(grad.max()),
            "change_norm_gap": float(change.max()),
            "grad_median_gap": float(np.median(grad)),
            "change_median_gap": float(np.median(change)),
            "leaves_left_out": int(len(want["grad_norms"]) - len(kept))}


def leaf_names(sizes: dict) -> list[str]:
    """The bart leaves' paths, in the trees' order."""
    return ["/".join(map(str, p)) for p, _ in reft._leaves(weights._multimodal(weights._Plan(),
                                                                                sizes))]


def worst_leaves(got: dict, want: dict, names: list[str], n: int = 3) -> dict:
    """Which leaves the worst-leaf numbers come from: for the first
    gradient and the change, the n largest gaps with their leaf's path and
    its reference norm over the median leaf's."""
    out = {}
    for key in ("grad_norms", "change"):
        gaps, kept = leaf_gaps(got, want, key)
        r = np.asarray(want[key])[kept]
        out[key] = [[names[kept[i]], float(gaps[i]), float(r[i] / np.median(r))]
                    for i in np.argsort(-gaps)[:n]]
    return out


def free_cache() -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(ctx: harness.Context) -> harness.Outcome:
    _, state, step_fn, batches = build(ctx)
    got, step_s = program_readings(ctx, state, step_fn, batches)  # steps `state` in place
    n_pool = int(math.ceil(ctx.seconds / max(step_s, 1e-3))) + POOL_SPARE
    pool = [draw_batch(ctx, CHECKED_STEPS + i) for i in range(n_pool)]
    harness.sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start

    t0 = time.perf_counter()
    steps = 0
    while True:
        state, _ = step_fn(state, pool[steps % n_pool])
        steps += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    harness.sync(ctx.device)
    secs = time.perf_counter() - t0
    bsz = int(ctx.sizes["train_batch_size"])
    peak = harness.memory_peak(ctx.device)

    records = None
    if ctx.trace:
        units = int(ctx.spec["trace_steps"])
        holder = {"state": state}

        def one():
            holder["state"], _ = step_fn(holder["state"], pool[0])

        records = capture(one, units, lambda: harness.sync(ctx.device))
        if ctx.device.startswith("cuda"):  # a device's share: never from a CPU run
            records.extra["mfu"] = (100.0 * costs.train_step_flops(ctx.sizes, bsz) * steps
                                    / (secs * costs.PEAK_BF16_FLOPS))
        state = holder.pop("state")
    state = step_fn = None  # the program's state goes before the reference runs
    free_cache()
    want = reference_readings(ctx, batches)
    nums = compare(got, want)
    lim = ctx.spec["limits"]
    checks = [(k, nums[k], float(lim[k])) for k in nums if k in lim]
    return harness.Outcome(
        e2e={"train_samples_per_s": steps * bsz / secs, "setup_s": setup_s},
        attempted=steps * bsz, failed=0, checks=checks, memory_peak_bytes=peak, records=records,
        notes={"window_s": secs, "steps": steps, "pool": n_pool, "losses": got["loss"],
               "reference_losses": want["loss"],
               "unchecked": {k: v for k, v in nums.items() if k not in lim}})


def control(ctx: harness.Context, _batches: int, with_control: bool) -> dict:
    """The limits' readings on one seed (portbench/control.py; the batch
    count is the captioning drivers' and is not used here): the
    program's first three steps against the reference, and, with
    `with_control`, the control (the reference on float8 operands in the
    program's place) and the half-batch fault (the reference on the first
    half of each batch, its mean over those rows) against the reference."""
    _, state, step_fn, batches = build(ctx)
    got, _ = program_readings(ctx, state, step_fn, batches)
    state = step_fn = None
    free_cache()
    want = reference_readings(ctx, batches)
    names = leaf_names(ctx.sizes)
    row = {"program": compare(got, want), "leaves": {"program": worst_leaves(got, want, names)}}
    if with_control:
        fp8 = reference_readings(ctx, batches, "fp8")
        row["control"] = compare(fp8, want)
        row["leaves"]["control"] = worst_leaves(fp8, want, names)
        half = int(ctx.sizes["train_batch_size"]) // 2
        row["fault_half_batch"] = compare(reference_readings(ctx, batches, rows=half), want)
    return row
