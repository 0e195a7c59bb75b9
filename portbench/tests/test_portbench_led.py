"""The LED cell (vacnic_led.caption_b32_s16k, driver caption_led) at a tiny
LED configuration on the CPU: the result line has the contract's keys and
`correct` true, end to end and traced (where every device metric is
silent); the planted faults read far above a sound run; LED's weights are
the port's tree; a port without the `led_full` preset fails at once; and
the costs' band count is the band's."""

import time

import pytest
import torch

from portbench import harness, weights_led
from portbench.costs import led as led_costs
from portbench.tests.runs import ROOT, SEED
from portbench.tests.tiny import TINY_SIZES, tiny_config, tiny_spec

CELL = "vacnic_led.caption_b32_s16k"
LED = {"attention_window": 8, "max_encoder_position_embeddings": 64, "position_offset": 0}


def tiny_led_cell(seconds: float = 1.0, trace: bool = False):
    bench = harness.load_manifest(ROOT)
    cell = harness.find_cell(bench, CELL)
    spec = tiny_spec(harness.cell_spec(CELL))
    spec.update(check_rows=12, limits={"score_gap_nats": 0.02})
    config = tiny_config()
    config["sizes"] = dict(TINY_SIZES, article_max_length=32, global_tokens=1, **LED)
    config["port_overrides"]["bart"] = dict(LED)
    config["port_overrides"]["data"] = {"article_max_length": 32}
    ctx = harness.Context(name=CELL, spec=spec, config=config, seed=SEED, seconds=seconds,
                          trace=trace, device="cpu", t_start=time.perf_counter())
    return bench, cell, spec, config, ctx


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
def test_tiny_led_run(trace):
    bench, cell, spec, config, _ = tiny_led_cell()
    line = harness.execute(bench, cell, seed=SEED, seconds=1.0, trace=trace, device="cpu",
                           t_start=time.perf_counter(), spec=spec, config=config)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    if not trace:
        assert set(line["metrics"]) == {"captions_per_s", "setup_s"}
    else:
        traced = {m["name"] for m in bench["per_layer"] if m["source"] == "device_trace"}
        assert not set(line["metrics"]) & traced  # no card: silent, never 0
        assert set(line["metrics"]) <= {m["name"] for m in harness.per_layer_for(bench, CELL)}


def test_tiny_led_control_reads_the_faults():
    _, _, _, _, ctx = tiny_led_cell()
    driver = harness.driver_module("caption_led")
    row = driver.control(ctx, 1, with_control=True)
    sound = row["program"]["score_gap_nats"]
    assert sound < 0.02
    assert row["fault_half_batch"]["score_gap_nats"] > 10 * sound
    assert row["fault_token_altered"]["score_gap_nats"] > 10 * sound


def test_led_weights_are_the_ports_tree():
    from vacnic_tpu_torch.core.config import VacnicConfig
    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.models.fusion import multimodal_bart_init

    _, _, _, config, ctx = tiny_led_cell()
    cfg = ctx.port_config()
    assert cfg.bart.attention_window == 8 and isinstance(cfg, VacnicConfig)
    ours = weights_led.make_model(config["sizes"], 3, "cpu", torch.float32)
    port = multimodal_bart_init(make_generator(0), cfg.bart, cfg.fusion)

    def shapes(t, pre=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items() for k2, v2 in shapes(v, f"{pre}/{k}").items()}
        if isinstance(t, tuple):
            return {k2: v2 for i, v in enumerate(t) for k2, v2 in shapes(v, f"{pre}/{i}").items()}
        return {pre: tuple(t.shape)}

    assert shapes(ours) == shapes(port)


def test_a_port_without_led_fails_at_once(monkeypatch):
    from vacnic_tpu_torch.core.config import VacnicConfig

    monkeypatch.delattr(VacnicConfig, "led_full")
    bench = harness.load_manifest(ROOT)
    cell = harness.find_cell(bench, CELL)
    t0 = time.perf_counter()
    with pytest.raises(AttributeError):
        harness.execute(bench, cell, seed=SEED, seconds=1.0, trace=False, device="cpu",
                        t_start=t0)
    assert time.perf_counter() - t0 < 30


def test_band_keys():
    for s_len, w, g in ((40, 5, 1), (64, 8, 2), (30, 100, 3)):
        want = sum(len({j for j in range(s_len) if abs(i - j) <= w or j < g})
                   for i in range(s_len))
        assert led_costs.band_keys(s_len, w, g, s_len) == want
    sizes = dict(TINY_SIZES, article_max_length=32, global_tokens=1, **LED)
    ops, byts = led_costs.window_layer(sizes, [32, 20])
    assert ops == 4.0 * 32 * (led_costs.band_keys(32, 4, 1, 32) + led_costs.band_keys(32, 4, 1, 20))
    assert byts == 2 * 32 * 4 * 32 * 2


def test_global_products():
    sizes = dict(TINY_SIZES, article_max_length=32, global_tokens=1, **LED)
    d, layers = sizes["d_model"], sizes["encoder_layers"]
    assert led_costs.global_products(sizes, 3) == [("global_q", 3, d, d, layers),
                                                   ("global_kv", 3 * 32, d, 2 * d, layers)]
    assert led_costs.global_products(dict(sizes, global_tokens=0), 3) == []
