"""The limits' readings at the cells' own sizes, on the card: on three
seeds, a sound run of the program reads under each cell's limit, and the
control (the reference on float8 operands in the program's place) and the
planted faults read over it. Marked `cuda`: on a machine without a card
they skip; on the card run them with

    python -m pytest -m cuda portbench/tests/test_portbench_cuda.py -q
"""

import time

import pytest
import torch

from portbench import harness

SEEDS = (3_100_000_001, 3_100_000_002, 3_100_000_003)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def context(cell: str, seed: int) -> harness.Context:
    bench = harness.load_manifest(".")
    c = harness.find_cell(bench, cell)
    return harness.Context(name=cell, spec=harness.cell_spec(cell),
                           config=harness.config_file(c["config"]), seed=seed, seconds=0.0,
                           trace=False, device="cuda", t_start=time.perf_counter())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["vacnic_full.caption_b256", "vacnic_onlyvis.caption_b256"])
def test_caption_limit_separates_program_from_control_and_faults(card, cell, seed):
    ctx = context(cell, seed)
    row = harness.driver_module("caption_closed").control(ctx, 2, with_control=True)
    limit = ctx.spec["limits"]["score_gap_nats"]
    assert row["program"]["score_gap_nats"] <= limit
    for group in ("control", "fault_half_batch", "fault_token_altered"):
        assert row[group]["score_gap_nats"] > limit, (group, row)
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_train_limits_separate_program_from_control_and_faults(card, seed):
    ctx = context("vacnic_full.train_b32", seed)
    row = harness.driver_module("train_closed").control(ctx, 0, with_control=True)
    limits = ctx.spec["limits"]
    for k, lim in limits.items():
        assert row["program"][k] <= lim, (k, row)
    for group in ("control", "fault_half_batch"):
        assert any(row[group][k] > lim for k, lim in limits.items()), (group, row)
    torch.cuda.empty_cache()
