"""The check against the plain reference at the tiny configuration: a
sound run passes, each fault a cell can have, planted under the timed
path, makes `correct` false, and the control (the reference on float8
operands in the program's place) reads far above a sound run. The same
readings at the cells' own sizes are taken on the card
(test_portbench_cuda.py, `python3 -m portbench.control`)."""

import copy

import pytest
import torch

from portbench import harness, weights
from portbench.tests.runs import CELLS, tiny_context, tiny_run
from portbench.tests.tiny import TINY_SIZES


def _alter_token(seqs):
    seqs = seqs.clone()
    t = seqs[:, 3]
    seqs[:, 3] = torch.where((t + 1) % 128 == 2, t + 2, t + 1) % 128
    return seqs


def _half_batch(seqs, scores):
    """The second half of the rows answered with the first half's."""
    seqs, scores = seqs.clone(), scores.clone()
    n = seqs.shape[0]
    h = n // 2
    seqs[h:], scores[h:] = seqs[:n - h], scores[:n - h]
    return seqs, scores


@pytest.mark.parametrize("fault", ["token_altered", "half_batch"])
@pytest.mark.parametrize("cell", [CELLS[0], CELLS[1]])
def test_caption_fault_is_not_correct(cell, fault, monkeypatch):
    import vacnic_tpu_torch.infer.generate as G

    real = G.generate_mm

    def broken(*a, **kw):
        seqs, scores = real(*a, **kw)
        if fault == "token_altered":
            return _alter_token(seqs), scores
        return _half_batch(seqs, scores)

    monkeypatch.setattr(G, "generate_mm", broken)
    line = tiny_run(cell)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", ["token_altered", "half_batch"])
def test_serve_fault_is_not_correct(fault, monkeypatch):
    from vacnic_tpu_torch.serve import CaptionService

    real = CaptionService._decode_rows

    def broken(self, rows, bucket=None):
        out = real(self, rows, bucket)
        out = copy.deepcopy(out)
        if fault == "token_altered":
            for r in out:
                r["tokens"][3] = (r["tokens"][3] + 1) % 128 or 3
        else:
            for r in out[(len(out) + 1) // 2:]:
                r.update(copy.deepcopy(out[0]))
        return out

    monkeypatch.setattr(CaptionService, "_decode_rows", broken)
    line = tiny_run(CELLS[3])
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_train_fault_is_not_correct(fault, monkeypatch):
    import vacnic_tpu_torch.train.train_step as TS

    real = TS.make_train_step

    def broken(cfg, n, **kw):
        init_fn, step_fn = real(cfg, n, **kw)

        def step(state, batch):
            if fault == "state_unchanged":
                _, m = step_fn(copy.deepcopy(state), batch)
                return state, m
            half = batch["article_ids"].shape[0] // 2
            return step_fn(state, {k: v[:half] for k, v in batch.items()})

        return init_fn, step

    monkeypatch.setattr(TS, "make_train_step", broken)
    line = tiny_run(CELLS[2])
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", [CELLS[0], CELLS[1]])
def test_caption_control_reads_far_above_a_sound_run(cell):
    driver = harness.driver_module("caption_closed")
    row = driver.control(tiny_context(cell), 2, with_control=True)
    prog, ctrl = row["program"]["score_gap_nats"], row["control"]["score_gap_nats"]
    assert ctrl > 5 * prog and ctrl > 0.02 > prog


def test_train_control_and_half_batch_read_far_above_a_sound_run():
    driver = harness.driver_module("train_closed")
    row = driver.control(tiny_context(CELLS[2]), 0, with_control=True)
    for group in ("control", "fault_half_batch"):
        assert row[group]["loss_gap"] > 1e-4 > row["program"]["loss_gap"]


@pytest.mark.parametrize("only_image", [False, True])
def test_weights_have_the_port_layout(only_image):
    """The benchmark's trees have the port's init trees' structure, order
    and shapes."""
    from vacnic_tpu_torch.core.config import VacnicConfig
    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.core.tree import leaves_with_path
    from vacnic_tpu_torch.models.bart import bart_init
    from vacnic_tpu_torch.models.clip_vit import clip_vision_init
    from vacnic_tpu_torch.models.fusion import multimodal_bart_init

    cfg = VacnicConfig.tiny(only_image=only_image)
    sizes = dict(TINY_SIZES, only_image=only_image)
    g = make_generator(0)
    want = {"model": multimodal_bart_init(g, cfg.bart, cfg.fusion),
            "clip": clip_vision_init(g, cfg.clip)}
    teacher_want = bart_init(g, cfg.bart)
    got, teacher = weights.make_training_trees(sizes, 1, "cpu")

    def shapes(tree):
        return [(p, tuple(t.shape)) for p, t in leaves_with_path(tree)]

    assert shapes(got) == shapes(want) and shapes(teacher) == shapes(teacher_want)
    model = weights.make_model(sizes, 1, "cpu", torch.float32)
    assert shapes(model) == shapes(want["model"])
