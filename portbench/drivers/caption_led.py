"""Captioning of long articles in a closed loop (configuration vacnic_led,
VACNIC on LED-large-16384): back-to-back `generate_mm` batches of the
cell's batch size over articles of the configuration's 16384-token bucket,
each batch's articles drawn fresh from the seed. It is caption_closed's
loop, window, sample and check (taken from that driver, which it leaves as
it is), with LED's weights (portbench/weights_led.py), reference
(portbench/reference/led.py) and costs (portbench/costs/led.py).

Set-up: the port's configuration first (a port without the `led_full`
preset fails here, before anything is built or drawn), the kernel
library, the weights from the cell's `weight_seed`, two warm-up batches,
then the pool of input batches, as caption_closed's.

End-to-end: captions_per_s, setup_s. Traced run: mfu over the untraced
window (the window attention's real operations, not S^2), then
`trace_batches` batches under the profiler, with the least times of every
matrix product (costs.caption_products at S 16384 and the global rows'
two), of the window attention and global rows, the decoder's long cross
K/V and the split dec_cross_attention for their rooflines
(portbench/costs/led's parts on costs.bound). The `.caption` readers of
the spans (encode, decode cache, beam step, select, syncs, fallbacks)
read this cell unchanged.

Correct: as caption_closed's, against the LED reference: the widest gap,
in nats over a caption, between the port's beam score times its length
penalty and the reference's sum of the same tokens' log-probabilities."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import costs, harness, weights_led
from portbench.costs import led as led_costs
from portbench.reference import led as ref_led
from portbench.reference import model as ref
from portbench.trace import capture
from portbench.traffic.synthetic import synthetic_batch

CLOSED = harness.driver_module("caption_closed")
POOL_SPARE = CLOSED.POOL_SPARE


def least_s(parts) -> float:
    """The least seconds of (operations, bytes) parts on the H100, each at
    whichever of its two bounds it meets."""
    return sum(costs.bound(b, o)[0] for o, b in parts) / 1e3


def build(ctx: harness.Context):
    """(port config, generate function, weights, draw), as caption_closed.build."""
    cfg = ctx.port_config()
    from vacnic_tpu_torch.infer.generate import generate_mm

    dev = ctx.device
    on_card = dev.startswith("cuda")
    if on_card:
        from vacnic_tpu_torch.kernels import _build

        _build.lib()
    dtype = torch.bfloat16 if on_card else torch.float32
    model = weights_led.make_model(ctx.sizes, int(ctx.spec["weight_seed"]), dev, dtype)
    batch = int(ctx.spec["batch"])

    def draw(i: int) -> dict:
        return harness.model_inputs(synthetic_batch(ctx.sizes, batch, seed=ctx.sub_seed(1, i)),
                                    dev, ctx.sizes["only_image"])

    def generate(x):
        return generate_mm(model, cfg=cfg.bart, fcfg=cfg.fusion, dcfg=cfg.decode, dtype=dtype,
                           device=dev, **x)

    return cfg, generate, model, draw


def sums(ctx, model, pool, outs, picks, prec: str = "f32", block: int = 8):
    """caption_closed.sums with the LED reference."""
    r = ref_led.LedModel(ctx.sizes, prec)
    lp = ctx.sizes["length_penalty"]
    port, reference = [], []
    with torch.no_grad():
        for b0 in range(0, len(picks), block):
            x, seqs, scores = CLOSED.picked(outs, pool, picks[b0:b0 + block])
            _, length = ref.scored_positions(seqs, ctx.sizes)
            port.append((scores * length ** lp).cpu().numpy())
            reference.append(ref.caption_sums(r, model, x, seqs).cpu().numpy())
    return np.concatenate(port), np.concatenate(reference)


def control(ctx: harness.Context, batches: int, with_control: bool) -> dict:
    """The limit's readings on one seed, as caption_closed.control's."""
    _, generate, model, draw = build(ctx)
    pool = [draw(k) for k in range(batches)]
    outs = [(k, *generate(pool[k])) for k in range(batches)]
    harness.sync(ctx.device)
    picks = CLOSED.sample(ctx, outs, int(ctx.spec["check_rows"]))
    port, f32 = sums(ctx, model, pool, outs, picks)
    row = {"program": {"score_gap_nats": float(np.abs(port - f32).max())}}
    if with_control:
        _, fp8 = sums(ctx, model, pool, outs, picks, "fp8")
        row["control"] = {"score_gap_nats": float(np.abs(fp8 - f32).max())}
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
    outs, secs = CLOSED.window(ctx, generate, pool)
    batch = outs[0][1].shape[0]
    captions = len(outs) * batch
    peak = harness.memory_peak(ctx.device)

    records = None
    if ctx.trace:
        units = int(ctx.spec["trace_batches"])
        records = capture(lambda: generate(pool[0]), units, lambda: harness.sync(ctx.device))
        lengths = [int(n) for n in pool[0]["attention_mask"].sum(1).tolist()]
        cross_s, cross_n = costs.caption_dec_cross(ctx.sizes, batch)
        if ctx.device.startswith("cuda"):  # a device's share: never from a CPU run
            flops = (costs.caption_flops(ctx.sizes, batch)
                     + led_costs.attention_flops_change(ctx.sizes, batch))
            records.extra["mfu"] = 100.0 * flops * len(outs) / (secs * costs.PEAK_BF16_FLOPS)
        records.extra.update(
            products_least_s=costs.products_least_s(
                costs.caption_products(ctx.sizes, batch)
                + led_costs.global_products(ctx.sizes, batch)) * units,
            window_least_s=ctx.sizes["encoder_layers"] * units
            * least_s(led_costs.window_parts(ctx.sizes, lengths)),
            window_launches=ctx.sizes["encoder_layers"] * units,
            cross_kv_least_s=ctx.sizes["decoder_layers"] * units
            * least_s([led_costs.cross_kv_layer(ctx.sizes, batch)]),
            cross_kv_launches=ctx.sizes["decoder_layers"] * units,
            dec_cross_least_s=cross_s * units, dec_cross_launches=cross_n * units)

    picks = CLOSED.sample(ctx, outs, int(ctx.spec["check_rows"]))
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
