"""The modules the port's command line brings, against the JAX package, on
the CPU:

* `core/rng`: `set_random_seed` leaves Python's and numpy's generators in
  JAX's state (the same draws) and seeds torch's; `split_like` has JAX's keys;
  both PRNG implementation names are accepted, others refused;
* `core/profiling`: `StepTimer.summary()` has JAX's keys; `trace` writes a
  Chrome trace holding an `annotate` range; `sync` passes CPU tensors;
* `convert_checkpoint`: a tree JAX's `save_tree` writes loads in the port
  (bf16 leaves bit for bit as torch.bfloat16, tuples kept, the int "heads"
  leaf), and the port's loads in JAX's `load_tree` (bf16 widened to f32);
* `models/fusion.tie_fusion_attn_weights`: bit-identical to JAX's on the
  same tree, and the one code path of `multimodal_bart_init`;
* `serve.watch_checkpoints` on a CPU service: hot-swaps a newer step,
  ignores older and equal steps, survives a failing `load_params`, stops
  when the service closes (tests/test_serve.py's watcher test, mirrored);
* `cli._prune_to_structure` and `cli._restore_watch_params`
  (tests/test_cli_end_to_end.py's, mirrored, on the port's checkpoints).

Tolerance: exact."""

import dataclasses
import importlib.util
import json
import random
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from vacnic_tpu.core import profiling as JPROF
from vacnic_tpu.core import rng as JRNG
from vacnic_tpu.core.config import VacnicConfig as JCfg
from vacnic_tpu.models import fusion as JF
from vacnic_tpu_torch import cli
from vacnic_tpu_torch import convert_checkpoint as TCC
from vacnic_tpu_torch.core import profiling as TPROF
from vacnic_tpu_torch.core import rng as TRNG
from vacnic_tpu_torch.core.config import VacnicConfig
from vacnic_tpu_torch.core.tree import leaves_with_path
from vacnic_tpu_torch.models import fusion as TF
from vacnic_tpu_torch.models.layers import fold_in
from vacnic_tpu_torch.models.weights_io import params_from_jax
from vacnic_tpu_torch.serve import CaptionService, ServeConfig, watch_checkpoints
from vacnic_tpu_torch.train.checkpoints import CheckpointManager
from vacnic_tpu_torch.train.train_step import TrainState

REPO = Path(__file__).resolve().parents[1]


def _jax_cc():
    """scripts/convert_checkpoint.py as a module (scripts/ is no package)."""
    spec = importlib.util.spec_from_file_location("convert_checkpoint",
                                                  REPO / "scripts" / "convert_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_tree(a, b) -> None:
    la, lb = leaves_with_path(a), leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert type(x) is type(y), path
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path


@pytest.fixture
def threefry():
    prev = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", prev)


# ---------------------------------------------------------------------------
# core/rng and core/profiling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 42, 684331, 2**33 + 5])
def test_set_random_seed_draws_repeat_jax(seed, threefry):
    JRNG.set_random_seed(seed, "threefry2x32")
    want = (random.random(), np.random.rand(3).tolist())
    root = TRNG.set_random_seed(seed, "rbg")
    assert root == seed
    assert (random.random(), np.random.rand(3).tolist()) == want
    a = torch.rand(4)
    TRNG.set_random_seed(seed)
    assert torch.equal(torch.rand(4), a)


def test_set_random_seed_refuses_unknown_impl():
    for impl in (None, "threefry2x32", "rbg"):
        TRNG.set_random_seed(1, impl)
    with pytest.raises(ValueError, match="PRNG implementation"):
        TRNG.set_random_seed(1, "philox")


@pytest.mark.parametrize("names", [("a",), ("dropout", "teacher", "clip"), tuple("abcdefgh")])
def test_split_like(names):
    jkeys = JRNG.split_like(jax.random.PRNGKey(7), names)
    tkeys = TRNG.split_like(7, names)
    assert list(tkeys) == list(jkeys) == list(names)
    assert [tkeys[n] for n in names] == [fold_in(7, i) for i in range(len(names))]
    assert len(set(tkeys.values())) == len(names)


def test_step_timer_summary_keys():
    j, t = JPROF.StepTimer(warmup=1), TPROF.StepTimer(warmup=1)
    assert t.summary() == j.summary() == {"steps": 0}
    for timer, leaf in ((j, jax.numpy.ones(2)), (t, torch.ones(2))):
        for _ in range(4):
            with timer.step(leaf):
                time.sleep(0.001)
    assert list(t.summary()) == list(j.summary())
    assert t.summary()["steps"] == 3 and t.summary()["steps_per_sec"] > 0


def test_trace_writes_chrome_trace(tmp_path):
    with TPROF.trace(str(tmp_path)):
        with TPROF.annotate("vacnic.test_range"):
            TPROF.sync({"x": torch.ones(8) * 2, "n": 3})
    trace = json.loads((tmp_path / TPROF.TRACE_FILE).read_text())
    assert any(e.get("name") == "vacnic.test_range" for e in trace["traceEvents"])


# ---------------------------------------------------------------------------
# convert_checkpoint's .npz trees, both directions
# ---------------------------------------------------------------------------

def _jax_tree():
    rng = np.random.RandomState(0)
    bf = jax.numpy.asarray(rng.randn(3, 5).astype(np.float32)).astype(jax.numpy.bfloat16)
    return {"shared": {"weight": jax.numpy.asarray(rng.randn(6, 4).astype(np.float32))},
            "half": bf,
            "layers": ({"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)},
                       {"kernel": np.ones((2, 3), np.float32)}),
            "ids": np.arange(4, dtype=np.int32),
            "heads": 8}


def test_jax_npz_loads_in_the_port(tmp_path):
    jtree = _jax_tree()
    _jax_cc().save_tree(jtree, str(tmp_path / "j.npz"))
    got = TCC.load_tree(str(tmp_path / "j.npz"))
    assert isinstance(got["layers"], tuple) and len(got["layers"]) == 2
    assert got["half"].dtype == torch.bfloat16
    want_bits = np.asarray(jtree["half"]).view(np.int16)
    assert np.array_equal(got["half"].view(torch.int16).numpy(), want_bits)
    np.testing.assert_array_equal(got["shared"]["weight"].numpy(),
                                  np.asarray(jtree["shared"]["weight"]))
    np.testing.assert_array_equal(got["layers"][0]["kernel"].numpy(), jtree["layers"][0]["kernel"])
    assert got["ids"].dtype == torch.int32 and int(got["heads"]) == 8


def test_port_npz_loads_in_jax(tmp_path):
    g = torch.Generator().manual_seed(0)
    ttree = {"shared": {"weight": torch.randn(6, 4, generator=g)},
             "half": torch.randn(3, 5, generator=g).to(torch.bfloat16),
             "layers": ({"kernel": torch.randn(2, 3, generator=g)},
                        {"kernel": torch.zeros(2, 3)}),
             "heads": 8}
    TCC.save_tree(ttree, str(tmp_path / "t.npz"))
    got = _jax_cc().load_tree(str(tmp_path / "t.npz"))
    assert isinstance(got["layers"], tuple)
    assert got["half"].dtype == np.float32  # widened: numpy has no bfloat16
    np.testing.assert_array_equal(got["half"], ttree["half"].float().numpy())
    np.testing.assert_array_equal(got["layers"][0]["kernel"],
                                  ttree["layers"][0]["kernel"].numpy())
    assert int(got["heads"]) == 8
    back = TCC.load_tree(str(tmp_path / "t.npz"))  # and the port reads its own
    assert torch.equal(back["half"], ttree["half"].float())
    assert set(TCC.flatten(ttree)) == set(_jax_cc().flatten(got))  # the same leaf names


# ---------------------------------------------------------------------------
# fusion.tie_fusion_attn_weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("only_image", [False, True])
def test_tie_fusion_attn_weights_matches_jax(only_image, threefry):
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    cfg = JCfg.tiny(only_image=only_image)
    fcfg = dataclasses.replace(cfg.fusion, fusion_layers=(0, 1, 7))  # 7: past the depth
    rng = np.random.RandomState(3)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.randn(*np.shape(x)).astype(np.float32),
        JF.multimodal_bart_init(jax.random.PRNGKey(0), cfg.bart, fcfg))  # untied values
    port_in = params_from_jax(tree)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, JF.tie_fusion_attn_weights(
        jax.tree_util.tree_map(np.asarray, tree), fcfg)))
    got = TF.tie_fusion_attn_weights(port_in, fcfg)
    _same_tree(got, want)
    lp = got["encoder"]["layers"][0]
    assert lp["cross_attn_img_ner"]["q_proj"]["kernel"] is not lp["self_attn"]["q_proj"]["kernel"]
    assert torch.equal(lp["cross_attn_img_ner"]["q_proj"]["kernel"],
                       lp["self_attn"]["q_proj"]["kernel"])


def test_multimodal_init_ties_through_the_function(monkeypatch):
    from vacnic_tpu_torch.core.rng import make_generator

    calls = []
    real = TF.tie_fusion_attn_weights
    monkeypatch.setattr(TF, "tie_fusion_attn_weights",
                        lambda p, f: calls.append(f) or real(p, f))
    cfg = VacnicConfig.tiny()
    fcfg = dataclasses.replace(cfg.fusion, init_attn_weight=True)
    params = TF.multimodal_bart_init(make_generator(0), cfg.bart, fcfg)
    assert len(calls) == 1
    for i in cfg.fusion.fusion_layers:
        lp = params["encoder"]["layers"][i]
        for name in ("cross_attn_img_ner", "self_attn_img_name"):
            _same_tree(lp[name], lp["self_attn"])


# ---------------------------------------------------------------------------
# serve.watch_checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_service_params():
    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.models.clip_vit import clip_vision_init

    cfg = VacnicConfig.tiny()
    params = {"model": TF.multimodal_bart_init(make_generator(0), cfg.bart, cfg.fusion),
              "clip": clip_vision_init(make_generator(1), cfg.clip)}
    params_b = {"model": TF.multimodal_bart_init(make_generator(5), cfg.bart, cfg.fusion),
                "clip": params["clip"]}
    return cfg, params, params_b


def test_watch_checkpoints_hot_swaps_new_step(tiny_service_params, monkeypatch):
    import vacnic_tpu_torch.train.checkpoints as C

    cfg, params, params_b = tiny_service_params
    steps = [3, 2, 3, 7]  # polls: unchanged, older, unchanged, then a new step (for good)

    class StubMgr:
        def __init__(self, directory, *a, **k):
            pass

        def latest_step(self):
            return steps.pop(0) if steps else 7

        def close(self):
            pass

    monkeypatch.setattr(C, "CheckpointManager", StubMgr)
    loaded = []

    def load_params(step):
        loaded.append(step)
        if len(loaded) == 1:
            raise OSError("checkpoint half-written")  # retried at the next poll
        return params_b

    svc = CaptionService(cfg, params, serve_cfg=ServeConfig(buckets=(1,)), device="cpu")
    try:
        th = watch_checkpoints(svc, "/nonexistent", load_params, poll_s=0.05, initial_step=3)
        deadline = time.monotonic() + 10
        while svc.stats()["weights_version"] == 0:
            assert time.monotonic() < deadline, "watcher never swapped"
            time.sleep(0.05)
        time.sleep(0.3)  # more polls of step 7: no second swap
    finally:
        svc.close()
    assert loaded == [7, 7]  # the failed load, then the swap; never for steps 2 or 3
    assert svc.stats()["weights_version"] == 1
    _same_tree(svc.params, params_b)
    th.join(timeout=5)
    assert not th.is_alive()  # stops when the service closes


def test_watch_checkpoints_on_real_checkpoints(tiny_service_params, tmp_path):
    """The CLI's wiring: a CheckpointManager directory and
    cli._restore_watch_params; a step saved after the watcher started swaps in."""
    cfg, params, params_b = tiny_service_params
    ckpt = str(tmp_path / "ckpt")
    mgr = CheckpointManager(ckpt, cfg)
    mgr.save(1, TrainState(step=1, params=params, teacher={}, opt_state={}, rng=0))
    svc = CaptionService(cfg, params, serve_cfg=ServeConfig(buckets=(1,)), device="cpu")
    try:
        watch_checkpoints(svc, ckpt, lambda s: cli._restore_watch_params(ckpt, s, svc.params),
                          poll_s=0.05, initial_step=mgr.latest_step())
        time.sleep(0.3)
        assert svc.stats()["weights_version"] == 0
        mgr.save(2, TrainState(step=2, params=params_b, teacher={}, opt_state={}, rng=0))
        deadline = time.monotonic() + 10
        while svc.stats()["weights_version"] == 0:
            assert time.monotonic() < deadline, "watcher never swapped"
            time.sleep(0.05)
    finally:
        svc.close()
    _same_tree(svc.params, params_b)


# ---------------------------------------------------------------------------
# cli._prune_to_structure and cli._restore_watch_params
# ---------------------------------------------------------------------------

def test_prune_to_structure():
    served = {"model": {"layers": ({"w": 1}, {"w": 2}), "emb": 3}, "clip": 4}
    ckpt = {"model": {"layers": [{"w": 10, "junk": 0}, {"w": 20}],
                      "emb": 30, "clip_text": {"tower": 9}},
            "clip": 40, "extra": 5}
    out = cli._prune_to_structure(ckpt, served)
    assert out == {"model": {"layers": ({"w": 10}, {"w": 20}), "emb": 30}, "clip": 40}
    assert isinstance(out["model"]["layers"], tuple)
    with pytest.raises(KeyError):
        cli._prune_to_structure({"model": {}}, served)
    with pytest.raises(ValueError, match="length"):
        cli._prune_to_structure({"model": {"layers": [{"w": 1}], "emb": 3}, "clip": 4}, served)


def test_restore_watch_params_raw_roundtrip(tmp_path):
    state = TrainState(
        step=7,
        params={"model": {"layers": [{"w": torch.ones(2, 2)}, {"w": torch.full((2, 2), 2.0)}]},
                "clip": {"p": torch.zeros(3)}, "clip_text": {"tower": torch.zeros(1)}},
        teacher={}, opt_state={"mu": torch.zeros(4)}, rng=0)
    ckpt_dir = str(tmp_path / "ckpt")
    CheckpointManager(ckpt_dir).save(7, state)
    served = {"model": {"layers": ({"w": torch.zeros(2, 2)}, {"w": torch.zeros(2, 2)})},
              "clip": {"p": torch.zeros(3)}}
    got = cli._restore_watch_params(ckpt_dir, 7, served)
    assert set(got) == {"model", "clip"}  # clip_text pruned
    assert isinstance(got["model"]["layers"], tuple)
    assert torch.equal(got["model"]["layers"][1]["w"], torch.full((2, 2), 2.0))
    assert got["model"]["layers"][1]["w"].device.type == "cpu"
    with pytest.raises(Exception):
        cli._restore_watch_params(ckpt_dir, 99, served)  # no such step
