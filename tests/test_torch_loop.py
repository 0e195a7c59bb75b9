"""The port's training loop, checkpoints and logging
(vacnic_tpu_torch/train/loop.py, train/checkpoints.py, core/logging.py) on
VacnicConfig.tiny() on the CPU:

* `fit` for 2 steps and 1 validation pass writes best/ and last/ (the step
  and config.json), val_outputs.json with `gt_cap` and the greedy
  `logit_output`, and the metrics file;
* the teacher cache: the second epoch skips the teacher's forward and gives
  the losses the teacher forward gives (rtol 1e-6);
* restore-then-step equals step-through, bit for bit, with dropout on (the
  seed state is restored too); retention, `latest_step`, `restore_raw`, an
  empty directory, and a template that does not match;
* the config sidecar reads in both packages, each way;
* `MetricsLogger(use_wandb=True)` raises, naming wandb, where it is missing.
"""

import dataclasses
import json
import os
import sys

import pytest
import torch

from vacnic_tpu.core.config import VacnicConfig as JC
from vacnic_tpu.train.checkpoints import CheckpointManager as JCheckpointManager
from vacnic_tpu_torch.core.config import VacnicConfig
from vacnic_tpu_torch.core.logging import MetricsLogger
from vacnic_tpu_torch.core.rng import make_generator
from vacnic_tpu_torch.core.tree import leaves_with_path
from vacnic_tpu_torch.data.synthetic import synthetic_batch
from vacnic_tpu_torch.models import bart as B
from vacnic_tpu_torch.models import fusion as F
from vacnic_tpu_torch.train import loop
from vacnic_tpu_torch.train.checkpoints import CheckpointManager
from vacnic_tpu_torch.train.train_step import make_train_step


def tiny(dropout=0.0, **train):
    cfg = VacnicConfig.tiny()
    return dataclasses.replace(
        cfg, bart=dataclasses.replace(cfg.bart, dropout=dropout),
        train=dataclasses.replace(cfg.train, **dict(dict(compute_dtype="float32"), **train)))


def fresh(cfg, seed=0):
    g = make_generator(seed)
    return {"model": F.multimodal_bart_init(g, cfg.bart, cfg.fusion)}, B.bart_init(g, cfg.bart)


def batches(cfg, n, seed=0, idx=False):
    out = []
    for i in range(n):
        b = synthetic_batch(cfg, 2, seed=seed + i)
        b["caption"] = ["a caption", "another"]
        if idx:
            b["sample_idx"] = torch.tensor([2 * i, 2 * i + 1])
        out.append(b)
    return out


class Tok:
    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def test_fit_writes_best_last_and_val_outputs(tmp_path):
    cfg = tiny(num_epochs=3)
    init_fn, step_fn = make_train_step(cfg, 10, device="cpu")
    state = init_fn(*fresh(cfg), 0)
    out = loop.fit(cfg, state, step_fn, batches(cfg, 4), batches(cfg, 1, seed=9), str(tmp_path),
                   max_steps=2, tokenizer=Tok())
    assert out is state and state.step == 2
    for sub in ("best", "last"):
        assert CheckpointManager(tmp_path / sub).latest_step() == 2
        assert CheckpointManager.load_config(str(tmp_path / sub)) == cfg
    vo = json.loads((tmp_path / "val_outputs.json").read_text())
    assert list(vo) == ["0"] and vo["0"]["gt_cap"] == ["a caption", "another"]
    assert len(vo["0"]["logit_output"]) == 2
    assert len(vo["0"]["logit_output"][0].split()) == cfg.data.caption_max_length
    lines = [json.loads(x) for x in (tmp_path / "run.metrics.jsonl").read_text().splitlines()]
    assert [x["_step"] for x in lines[:2]] == [1, 2] and "grad_norm" in lines[0]
    assert any("val_loss" in x for x in lines) and any("min val loss" in x for x in lines)


class Recorder(MetricsLogger):
    """A MetricsLogger that also keeps every record it logs."""

    def __init__(self, out_dir):
        super().__init__(out_dir)
        self.records = []

    def log(self, metrics, step=None):
        self.records.append(dict(metrics))
        super().log(metrics, step)


def test_fit_teacher_cache_skips_the_teacher(tmp_path, monkeypatch):
    calls = []
    real = B.bart_forward
    monkeypatch.setattr(B, "bart_forward", lambda *a, **k: calls.append(1) or real(*a, **k))
    margins = {}
    for cache in (True, False):
        cfg = tiny(num_epochs=2, teacher_cache=cache)
        init_fn, step_fn = make_train_step(cfg, 10, device="cpu")
        rec = Recorder(str(tmp_path / str(cache)))
        calls.clear()
        loop.fit(cfg, init_fn(*fresh(cfg), 0), step_fn, batches(cfg, 2, idx=True), [],
                 str(tmp_path / str(cache)), metrics=rec)
        # with the cache, epoch 2 reads it: two teacher forwards, not four
        assert len(calls) == (2 if cache else 4)
        steps = [m for m in rec.records if "margin_loss" in m]
        assert len(steps) == 4 and all("teacher_pooled" not in m for m in steps)
        margins[cache] = [m["margin_loss"] for m in steps]
    assert margins[True] == pytest.approx(margins[False], rel=1e-6)


def params_of(state):
    return [p.detach().clone() for _, p in leaves_with_path(state.params)]


def test_restore_then_step_equals_step_through(tmp_path):
    cfg = tiny(dropout=0.1)
    data = batches(cfg, 3)
    init_fn, step_fn = make_train_step(cfg, 10, device="cpu")
    state = init_fn(*fresh(cfg), 7)
    for b in data[:2]:
        state, _ = step_fn(state, b)
    mgr = CheckpointManager(tmp_path / "ck", cfg, max_to_keep=2)
    mgr.save(state.step, state, {"loss": 1.5})
    state, m_through = step_fn(state, data[2])

    template = init_fn(*fresh(cfg, seed=1), 0)  # other weights, other seed
    restored, step = mgr.restore(template)
    assert step == 2 and restored.step == 2 and restored is not template
    assert all(p.requires_grad for _, p in leaves_with_path(restored.params))
    restored, m_restored = step_fn(restored, data[2])
    assert all(torch.equal(a, b) for a, b in zip(params_of(state), params_of(restored)))
    assert torch.equal(m_through["loss"], m_restored["loss"])
    assert restored.rng == state.rng and restored.opt_state["bart"]["count"] == 3
    assert json.loads((tmp_path / "ck" / "2" / "metrics.json").read_text()) == {"loss": 1.5}


def test_checkpoint_manager_surface(tmp_path):
    cfg = tiny()
    init_fn, step_fn = make_train_step(cfg, 10, device="cpu")
    state = init_fn(*fresh(cfg), 0)
    mgr = CheckpointManager(str(tmp_path / "m"), cfg, max_to_keep=2)
    assert mgr.latest_step() is None
    assert mgr.restore(state) == (state, 0) and mgr.restore_raw() == (None, 0)
    for s in (1, 2, 3):
        mgr.save(s, state)
    assert sorted(os.listdir(tmp_path / "m")) == ["2", "3", "config.json"]
    assert mgr.latest_step() == 3
    raw, step = mgr.restore_raw()
    assert step == 3 and set(raw) == {"step", "params", "teacher", "opt_state", "rng"}
    assert raw["params"]["model"]["shared"]["weight"].device.type == "cpu"
    _, step = mgr.restore(state, step=2)
    assert step == 2
    other = init_fn({"model": F.multimodal_bart_init(
        make_generator(0), dataclasses.replace(cfg.bart, d_model=48), cfg.fusion)},
        fresh(cfg)[1], 0)
    with pytest.raises(ValueError, match="checkpoint step 3"):
        mgr.restore(other)
    mgr.wait()
    mgr.close()


def test_config_sidecar_reads_in_both_packages(tmp_path):
    cfg = tiny(alpha=0.25)
    CheckpointManager(str(tmp_path / "port"), cfg)
    jcfg = JCheckpointManager.load_config(str(tmp_path / "port"))
    assert json.loads(jcfg.to_json()) == json.loads(cfg.to_json())
    assert jcfg.train.alpha == 0.25
    jdir = tmp_path / "jax"
    j = dataclasses.replace(JC.tiny(), train=dataclasses.replace(JC.tiny().train, margin=0.7))
    JCheckpointManager(str(jdir), j).close()  # the JAX package writes its sidecar
    got = CheckpointManager.load_config(str(jdir))
    assert got.train.margin == 0.7 and json.loads(got.to_json()) == json.loads(j.to_json())


def test_metrics_logger_without_wandb(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb -> ImportError
    with pytest.raises(ImportError, match="wandb"):
        MetricsLogger(str(tmp_path), use_wandb=True)
    m = MetricsLogger(str(tmp_path), run_name="r")
    m.log({"loss": torch.tensor(2.5), "note": "x"})
    m.log({"loss": 1.0}, step=7)
    m.close()
    lines = [json.loads(x) for x in (tmp_path / "r.metrics.jsonl").read_text().splitlines()]
    assert [(x["_step"], x["loss"]) for x in lines] == [(0, 2.5), (7, 1.0)]
    assert lines[0]["note"] == "x"
