"""Captioning in a closed loop: back-to-back `generate_mm` batches of the
cell's batch size, each batch's articles drawn fresh from the seed.

Set-up: the kernel library (built in the checkout on its first run), the
weights on the card from the cell's `weight_seed` (bf16, as served), two
warm-up batches on inputs of their own (the first warms the cell's one
shape, the second's time sizes the pool), then the pool of distinct input
batches from the seed: as many as the window would take at the second
batch's pace, and POOL_SPARE more. The weights are one model for every
--seed: a batch's work hangs on the tokens the weights make (the beam
search's host work follows them), and runs of one seed read alike where
models drawn from different seeds read up to 18% apart. Window: batches until --seconds have passed; every
caption of the batches it started counts, over the time until the last one
ended.

End-to-end: captions_per_s, setup_s. Traced run (--trace 1): the untraced
window gives the model FLOP rate (mfu); then `trace_batches` batches run
under the profiler for the device metrics.

Correct: `check_rows` captions drawn from the seed among all the window's
captions, teacher-forced through the plain reference (float32) over their
served tokens: the widest gap, in nats over the caption, between the
port's beam score (times its length penalty) and the reference's sum of the
same tokens' log-probabilities (portbench/reference/model.py)."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import costs, harness, weights
from portbench.reference import model as ref
from portbench.trace import capture
from portbench.traffic.synthetic import synthetic_batch

POOL_SPARE = 3  # batches beyond the window's pace: a run a tenth faster still finds fresh ones


def build(ctx: harness.Context):
    """(port config, generate function, weights, draw) of the cell, where
    draw(i) is the i-th input batch of the run, on the device."""
    from vacnic_tpu_torch.infer.generate import generate_mm

    cfg = ctx.port_config()
    dev = ctx.device
    on_card = dev.startswith("cuda")
    if on_card:
        from vacnic_tpu_torch.kernels import _build

        _build.lib()
    dtype = torch.bfloat16 if on_card else torch.float32
    model = weights.make_model(ctx.sizes, int(ctx.spec["weight_seed"]), dev, dtype)
    batch = int(ctx.spec["batch"])

    def draw(i: int) -> dict:
        return harness.model_inputs(synthetic_batch(ctx.sizes, batch, seed=ctx.sub_seed(1, i)),
                                    dev, ctx.sizes["only_image"])

    def generate(x):
        return generate_mm(model, cfg=cfg.bart, fcfg=cfg.fusion, dcfg=cfg.decode, dtype=dtype,
                           device=dev, **x)

    return cfg, generate, model, draw


def window(ctx, generate, pool):
    """-> (outputs [(pool index, seqs, scores)], seconds)."""
    harness.sync(ctx.device)
    t0 = time.perf_counter()
    outs, i = [], 0
    while True:
        k = i % len(pool)
        seqs, scores = generate(pool[k])
        outs.append((k, seqs, scores))
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    harness.sync(ctx.device)
    return outs, time.perf_counter() - t0


def sample(ctx, outs, n: int) -> list[tuple[int, int]]:
    """n (output index, row) pairs drawn from the seed, without repeats."""
    rows = outs[0][1].shape[0]
    rng = np.random.RandomState(ctx.sub_seed(2) % (2 ** 32))
    picks = rng.choice(len(outs) * rows, size=min(n, len(outs) * rows), replace=False)
    return [(int(p) // rows, int(p) % rows) for p in sorted(picks)]


def picked(outs, pool, part):
    """The inputs, served captions and scores of (output, row) pairs."""
    x = {key: torch.stack([pool[outs[o][0]][key][row] for o, row in part])
         for key in pool[0] if pool[0][key] is not None}
    seqs = torch.stack([outs[o][1][row] for o, row in part])
    scores = torch.stack([outs[o][2][row] for o, row in part]).float()
    return x, seqs, scores


def sums(ctx, model, pool, outs, picks, prec: str = "f32", block: int = 8):
    """(the port's score x length**lp, the reference's sum of the scored
    log-probabilities of the same tokens, computed in `prec`) for each
    picked caption, in nats; the reference in blocks of rows."""
    r = ref.Model(ctx.sizes, prec)
    lp = ctx.sizes["length_penalty"]
    port, reference = [], []
    with torch.no_grad():
        for b0 in range(0, len(picks), block):
            x, seqs, scores = picked(outs, pool, picks[b0:b0 + block])
            _, length = ref.scored_positions(seqs, ctx.sizes)
            port.append((scores * length ** lp).cpu().numpy())
            reference.append(ref.caption_sums(r, model, x, seqs).cpu().numpy())
    return np.concatenate(port), np.concatenate(reference)


def control(ctx: harness.Context, batches: int, with_control: bool) -> dict:
    """The limit's readings on one seed (portbench/control.py): `batches`
    batches of the timed path, the check's number on its sample, and the
    control's (the reference on float8 operands in the program's place)."""
    _, generate, model, draw = build(ctx)
    pool = [draw(k) for k in range(batches)]
    outs = [(k, *generate(pool[k])) for k in range(batches)]
    harness.sync(ctx.device)
    picks = sample(ctx, outs, int(ctx.spec["check_rows"]))
    port, f32 = sums(ctx, model, pool, outs, picks)
    row = {"program": {"score_gap_nats": float(np.abs(port - f32).max())}}
    if with_control:
        _, fp8 = sums(ctx, model, pool, outs, picks, "fp8")
        row["control"] = {"score_gap_nats": float(np.abs(fp8 - f32).max())}
        # two faults read at the cell's size: each row answered with the
        # caption and score of the row half a batch away; a token altered
        half = [(k, s.roll(s.shape[0] // 2, 0), c.roll(s.shape[0] // 2, 0)) for k, s, c in outs]
        port_h, ref_h = sums(ctx, model, pool, half, picks)
        row["fault_half_batch"] = {"score_gap_nats": float(np.abs(port_h - ref_h).max())}
        eos, vocab = ctx.sizes["eos_token_id"], ctx.sizes["vocab_size"]
        altered = []
        for k, s, c in outs:
            s = s.clone()
            t = (s[:, 3] + 1) % vocab
            s[:, 3] = torch.where(t == eos, (t + 1) % vocab, t)
            altered.append((k, s, c))
        port_t, ref_t = sums(ctx, model, pool, altered, picks)
        row["fault_token_altered"] = {"score_gap_nats": float(np.abs(port_t - ref_t).max())}
    return row


def run(ctx: harness.Context) -> harness.Outcome:
    cfg, generate, model, draw = build(ctx)
    generate(draw(0))  # warm-up: the cell's one shape
    harness.sync(ctx.device)
    t0 = time.perf_counter()
    generate(draw(1))
    harness.sync(ctx.device)
    n_pool = int(math.ceil(ctx.seconds / max(time.perf_counter() - t0, 1e-3))) + POOL_SPARE
    pool = [draw(2 + i) for i in range(n_pool)]
    harness.sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start
    outs, secs = window(ctx, generate, pool)
    batch = outs[0][1].shape[0]
    captions = len(outs) * batch
    peak = harness.memory_peak(ctx.device)

    records = None
    if ctx.trace:
        flops = costs.caption_flops(ctx.sizes, batch)
        units = int(ctx.spec["trace_batches"])
        records = capture(lambda: generate(pool[0]), units, lambda: harness.sync(ctx.device))
        gemm_s, _, gemm_n = costs.caption_gemm_bf16(ctx.sizes, batch)
        cross_s, cross_n = costs.caption_dec_cross(ctx.sizes, batch)
        if ctx.device.startswith("cuda"):  # a device's share: never from a CPU run
            records.extra["mfu"] = 100.0 * flops * len(outs) / (secs * costs.PEAK_BF16_FLOPS)
        records.extra.update(
            products_least_s=costs.products_least_s(costs.caption_products(ctx.sizes, batch))
            * units,
            gemm_bf16_least_s=gemm_s * units, gemm_bf16_launches=gemm_n * units,
            dec_cross_least_s=cross_s * units, dec_cross_launches=cross_n * units)

    picks = sample(ctx, outs, int(ctx.spec["check_rows"]))
    port, f32 = sums(ctx, model, pool, outs, picks)
    gaps = np.abs(port - f32)
    limit = float(ctx.spec["limits"]["score_gap_nats"])
    return harness.Outcome(
        e2e={"captions_per_s": captions / secs, "setup_s": setup_s},
        attempted=captions, failed=0,
        checks=[("score_gap_nats", float(gaps.max()), limit)],
        memory_peak_bytes=peak, records=records,
        notes={"window_s": secs, "batches": len(outs), "pool": n_pool,
               "checked_captions": len(picks)})
