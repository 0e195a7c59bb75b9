"""The data-parallel training step on the CPU (train/train_step.
make_train_step(group=), loss_and_grads, train/losses with a group,
models/layers.RowShardSeed, core/distributed): gloo groups of 2 and 4
processes against the one-process step on the same global batch of 8 rows,
and against the JAX package's step sharded over its 8 virtual CPU devices.

Each group is spawned by chip_smoke.run_dp_group (the card's mesh phase
runs the same worker in NCCL ranks): a file store under tmp_path, every
rank's collectives bounded by init_process_group(timeout=) and every rank
joined within a deadline, so a hang fails the tests that read that group.
The trees are JAX's init carried across by weights_io.params_from_jax, the
batch JAX's synthetic_batch, in f32.

Tolerances: loss terms and the gradient norm at JAX's 2e-5
(tests/test_train_step.py:99-103), with dropout on (0.1 on the residuals
and the activations: the ranks' masks are the global batch's rows) and
clipping on; each reduced gradient leaf within 1e-5 of that leaf's
largest |gradient| + 1e-9 (f32 sums in another order; the key biases'
gradients are f32 noise near 1e-13); the steps after the first update
equal too. Against JAX's 8-device step (dropout off: the masks are not
JAX's, ROADMAP C.5): the loss terms and the gradient norm within 1e-4, the
port-against-JAX tolerance of tests/test_torch_train_step.py."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vacnic_tpu.core.config import VacnicConfig as JC
from vacnic_tpu.data.synthetic import synthetic_batch as j_batch
from vacnic_tpu.models import bart as JB
from vacnic_tpu.models import fusion as JF
from vacnic_tpu.models.clip_text import clip_text_init as j_clip_text_init
from vacnic_tpu.models.clip_vit import clip_vision_init as j_clip_vision_init
from vacnic_tpu.train import train_step as JT
from vacnic_tpu_torch.core import distributed as D
from vacnic_tpu_torch.core.config import VacnicConfig as TC
from vacnic_tpu_torch.core.tree import leaves_with_path, tree_map
from vacnic_tpu_torch.models.layers import RowShardSeed, dropout, fold_in, split
from vacnic_tpu_torch.models.weights_io import params_from_jax
from vacnic_tpu_torch.train import losses as L
from vacnic_tpu_torch.train import train_step as TT

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # the spawned ranks import chip_smoke by name
    sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

BATCH = 8
STEPS = 3  # step 0's warmup lr is 0: step 2 reads the first update
DEADLINE_S = 120


def configs(dropout_on: bool, **train):
    """The tiny config in both packages, f32, no remat, clipping on."""
    out = []
    rate = 0.1 if dropout_on else 0.0
    for C in (JC, TC):
        c = C.tiny()
        out.append(dataclasses.replace(
            c, bart=dataclasses.replace(c.bart, dropout=rate, activation_dropout=rate),
            train=dataclasses.replace(c.train, **dict(dict(
                compute_dtype="float32", grad_checkpoint=False, no_clip_norm=False,
                clip_norm=1.0), **train))))
    return out


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    jc, _ = configs(False)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    jp = to_np({"model": JF.multimodal_bart_init(keys[0], jc.bart, jc.fusion)})
    jt = to_np(JB.bart_init(keys[1], jc.bart))
    batch = {k: np.asarray(v) for k, v in j_batch(jc, BATCH, seed=1).items()}
    # the CLIP loss case: both towers, pixels and CLIP token ids
    tower = j_clip_text_init(keys[3], vocab_size=64, context_length=16, width=32, layers=2,
                             heads=jc.clip.text_heads, output_dim=jc.clip.output_dim)
    jp_clip = dict(jp, clip=to_np(j_clip_vision_init(keys[2], jc.clip)),
                   clip_text=to_np({k: v for k, v in tower.items() if k != "heads"}))
    batch_clip = {k: np.asarray(v) for k, v in
                  j_batch(jc, BATCH, seed=1, with_pixels=True).items()}
    batch_clip["caption_ids_clip"] = np.random.RandomState(3).randint(
        1, 63, (BATCH, 16)).astype(np.int32)
    return jp, jt, batch, jp_clip, batch_clip


def cases(trees):
    """name -> (port config, worker case)."""
    _, _, _, jp_clip, batch_clip = trees
    out = {}
    for name, drop, train, grads, steps, extra in (
            ("dropout", True, {}, True, STEPS, {}),
            ("remat", True, dict(grad_checkpoint=True), True, 1, {}),
            ("infonce", True, dict(use_secla=False), False, 1, {}),
            ("clip_loss", True, dict(no_clip_loss=False), True, 1,
             dict(params=params_from_jax(jp_clip), batch=batch_clip)),
            ("no_dropout", False, {}, False, 1, {})):
        tc = configs(drop, **train)[1]
        out[name] = (tc, dict(cfg=tc, steps=steps, grads=grads, **extra))
    return out


GROUPS = {2: ("dropout", "remat"), 4: ("dropout", "infonce", "clip_loss", "no_dropout")}


@pytest.fixture(scope="module")
def groups(trees, tmp_path_factory):
    """world -> {case name: rank 0's results} of one spawned gloo group each."""
    jp, jt, batch, _, _ = trees
    all_cases = cases(trees)
    out = {}
    for world, names in GROUPS.items():
        spec = dict(device="cpu", threads=1, params=params_from_jax(jp),
                    teacher=params_from_jax(jt), rng=5, batch=batch,
                    cases=[all_cases[n][1] for n in names])
        res = chip_smoke.run_dp_group(world, spec, str(tmp_path_factory.mktemp(f"dp{world}")),
                                      DEADLINE_S)
        out[world] = dict(zip(names, res))
    return out


def fresh(tree):
    return tree_map(lambda _, t: t.detach().clone() if isinstance(t, torch.Tensor) else t, tree)


@pytest.fixture(scope="module")
def one_process(trees):
    """case name -> the one-process results on the global batch, as the
    worker reports them."""
    jp, jt, batch, _, _ = trees
    out = {}
    for name, (tc, case) in cases(trees).items():
        init_fn, step_fn = TT.make_train_step(tc, 100, device="cpu")
        state = init_fn(fresh(case.get("params", params_from_jax(jp))),
                        params_from_jax(jt), 5)
        b = case.get("batch", batch)
        res = {"steps": []}
        if case["grads"]:
            m, grads = TT.loss_and_grads(state.params, state.teacher, b, tc,
                                         split(state.rng)[1])
            res["grads"], res["grad_metrics"] = grads, {k: float(v) for k, v in m.items()}
            res["paths"] = [p for p, _ in leaves_with_path(state.params)]
        for _ in range(case["steps"]):
            state, m = step_fn(state, b)
            res["steps"].append({k: float(v) for k, v in m.items()})
        out[name] = res
    return out


def assert_metrics(got: dict, want: dict, tol: float, tag: str):
    assert set(got) == set(want), tag
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=f"{tag} {k}")


def group_cases():
    return [(w, n) for w, names in GROUPS.items() for n in names]


@pytest.mark.parametrize("world,case", group_cases())
def test_dp_loss_terms_match_one_process(groups, one_process, world, case):
    got, want = groups[world][case], one_process[case]
    assert len(got["steps"]) == len(want["steps"])
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        assert_metrics(g, w, 2e-5, f"{world} ranks, {case}, step {i}")
    if case == "dropout":  # the first update moved the losses: step 2 is not step 0
        assert got["steps"][2]["loss"] != got["steps"][0]["loss"]
    if case == "clip_loss":
        assert "clip_loss" in got["steps"][0]
    if case == "infonce":
        assert "face_name_loss" in got["steps"][0]


@pytest.mark.parametrize("world,case", [(w, n) for w, n in group_cases()
                                        if n in ("dropout", "remat", "clip_loss")])
def test_dp_gradients_match_one_process(groups, one_process, world, case):
    got, want = groups[world][case], one_process[case]
    assert_metrics(got["grad_metrics"], want["grad_metrics"], 2e-5, f"{world} ranks, {case}")
    assert len(got["grads"]) == len(want["grads"])
    trained = 0
    for path, g, w in zip(want["paths"], got["grads"], want["grads"]):
        assert (g is None) == (w is None), path
        if w is None:
            continue
        trained += 1
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()) + 1e-9, err_msg=str(path))
    assert trained > 20
    if case == "clip_loss":  # the gather's backward reaches the text tower's scale
        i = want["paths"].index(("clip_text", "logit_scale"))
        assert float(got["grads"][i].abs()) > 0


def test_dp_matches_jax_sharded_step(groups, trees):
    """The 4-rank step with dropout off against JAX's step_fn on a batch
    sharded over its 8 virtual devices (tests/test_train_step.py:77-104)."""
    jp, jt, batch, _, _ = trees
    jc = configs(False)[0]
    init_fn, step_fn = JT.make_train_step(jc, 100)
    state = init_fn(jp, jt, jax.random.PRNGKey(5))
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8, 1), ("data", "model"))
    sharded = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("data")))
               for k, v in batch.items()}
    _, m8 = jax.jit(step_fn)(jax.device_put(state, NamedSharding(mesh, P())), sharded)
    got = groups[4]["no_dropout"]["steps"][0]
    assert_metrics(got, {k: float(v) for k, v in m8.items()}, 1e-4, "4 ranks against JAX")


@pytest.mark.parametrize("world", [2, 4])
def test_row_shard_dropout_draws_the_global_rows(world):
    """Each rank's mask is its rows of the one-process mask, for a [B, T, d]
    and a flattened [B * T, d] activation; fold_in and split keep the
    shard."""
    x = torch.randn(8, 5, 6, generator=torch.Generator().manual_seed(0)) + 3.0
    seed = fold_in(123, 7)
    for shape in (x.shape, (40, 6)):
        xs = x.reshape(shape)
        whole = dropout(xs, 0.3, seed)
        n = xs.shape[0] // world
        parts = [dropout(xs[r * n:(r + 1) * n], 0.3, RowShardSeed(seed, r, world))
                 for r in range(world)]
        assert torch.equal(torch.cat(parts), whole)
        assert 0 < int((whole == 0).sum()) < whole.numel()
    s = RowShardSeed(seed, 1, world)
    a, b = split(s)
    for d in (fold_in(s, 3), a, b):
        assert isinstance(d, RowShardSeed) and (d.rank, d.world) == (1, world)
    assert int(fold_in(s, 3)) == fold_in(seed, 3)
    with pytest.raises(ValueError, match="rank 4 of 4"):
        RowShardSeed(seed, 4, 4)


def test_initialize_in_a_single_process(monkeypatch):
    """No address given or found: no group, and one process asked for; more
    than one without an address raises, as JAX's initialize does."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not torch.distributed.is_initialized()
    D.initialize(device="cpu")
    D.initialize(num_processes=1, device="cpu")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="2 processes asked for"):
        D.initialize(num_processes=2, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="4 processes asked for"):
        D.initialize(device="cpu")
    with pytest.raises(ValueError, match="needs num_processes and process_id"):
        D.initialize("127.0.0.1:1", device="cpu")
    assert D.is_primary() and D.process_count() == 1 and D.process_index() == 0
    assert D.local_batch_slice(8) == slice(0, 8)


def test_losses_without_a_group_are_the_one_process_losses():
    x = torch.randn(4, 3)
    assert L.gather_rows(x) is x and L.world_size() == 1
    h, t = torch.randn(4, 5, 8), L.l2_normalize(torch.randn(4, 8))
    mask = torch.ones(4, 5, dtype=torch.int32)
    assert torch.equal(L.colam_margin_from_pooled(h, t, mask, 1.0),
                       torch.clamp(1.0 - (L.l2_normalize(L.pool(h, mask)) * t).sum(-1),
                                   min=0.0).mean())
