"""Tensor parallelism on the CPU (core/tensor_parallel, core/distributed.
grid_groups, the layers' column/row forms, models/layers.ColShardSeed,
train/optim.global_norm(cut=, tp=), make_train_step(model_group=)), on the
TP-divisible tiny config of JAX's __graft_entry__._dryrun_body (d 64, 4
heads, ffn 128, dim_common 64, img_size 64; the CLIP vision tower 64 wide
to feed it), f32, no remat unless asked, clipping on:

* spawned gloo groups (chip_smoke.run_dp_group, as
  tests/test_torch_distributed.py spawns them): tp 2 in 2 processes, dp 2 x
  tp 2 and tp 4 in one group of 4, dp 4 x tp 2 in 8, each rank a
  (data, model) place of core/distributed.grid_groups;
* against the one-process port step on the same global batch of 8, with
  dropout on (0.1 on the residuals and the activations: a rank draws its
  rows and columns of the one-process masks): loss terms and the gradient
  norm within 2e-5 (tests/test_train_step.py:99-103), each gradient leaf
  (the cut ones gathered whole) within 1e-5 of its largest |gradient| (a
  key bias, whose gradient is f32 noise around zero: of its attention's
  largest; chip_smoke.grad_errors), the named leaves after the updates
  within 1e-6 absolute (f32 sums in another order through Adam's
  normalised steps);
* against JAX's step on its 8 virtual CPU devices with param_shardings
  placed as __graft_entry__.py:153-165 does (a 4 x 2 mesh), dropout off:
  loss terms and the gradient norm within 1e-4, the port-against-JAX
  tolerance of tests/test_torch_train_step.py;
* in bf16 (the tp 2 group): the loss terms within 2e-5 of one bf16
  process, and chip_smoke.bf16_witness: the gradients no further from the
  f32 one-process step than one bf16 process's, by the ratio the tp phase
  holds on the card;
* one process: shard shapes against JAX's addressable shards, the head
  shard of mha, the row-parallel bias added once, a column shard's dropout
  mask, and the refusals."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from vacnic_tpu.core import mesh as JM
from vacnic_tpu.core.config import MeshConfig as JMeshConfig, VacnicConfig as JC
from vacnic_tpu.data.synthetic import synthetic_batch as j_batch
from vacnic_tpu.models import bart as JB
from vacnic_tpu.models import fusion as JF
from vacnic_tpu.models.clip_text import clip_text_init as j_clip_text_init
from vacnic_tpu.models.clip_vit import clip_vision_init as j_clip_vision_init
from vacnic_tpu.train import train_step as JT
from vacnic_tpu_torch.core import tensor_parallel as TP
from vacnic_tpu_torch.core.config import VacnicConfig as TC
from vacnic_tpu_torch.core.mesh import param_dim
from vacnic_tpu_torch.core.tree import leaves_with_path, tree_map
from vacnic_tpu_torch.models import layers as TL
from vacnic_tpu_torch.models.weights_io import params_from_jax
from vacnic_tpu_torch.train import optim as TO
from vacnic_tpu_torch.train import train_step as TT

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # the spawned ranks import chip_smoke by name
    sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

BATCH = 8
STEPS = 3  # step 0's warmup lr is 0: steps 1 and 2 read the updates
DEADLINE_S = 150
LEAVES = ("model/decoder/layers/0/fc1/kernel", "model/decoder/layers/0/fc2/kernel",
          "model/decoder/layers/0/final_layer_norm/scale",
          "model/encoder/layers/0/img_up/kernel", "model/encoder/layers/0/img_down/kernel",
          "model/encoder/layers/0/img_layer_norm/scale",
          "model/encoder/layers/1/ner_map_up/bias",
          "model/encoder/prompt_mlp/prompt_fc1/kernel",
          "model/encoder/prompt_mlp/prompt_fc2/kernel")


def configs(dropout_on: bool, **train):
    """_dryrun_body's TP-divisible tiny config in both packages."""
    out = []
    rate = 0.1 if dropout_on else 0.0
    for C in (JC, TC):
        c = C.tiny()
        out.append(dataclasses.replace(
            c, bart=dataclasses.replace(c.bart, d_model=64, encoder_ffn_dim=128,
                                        decoder_ffn_dim=128, encoder_attention_heads=4,
                                        decoder_attention_heads=4, dropout=rate,
                                        activation_dropout=rate),
            fusion=dataclasses.replace(c.fusion, dim_common=64, img_size=64),
            clip=dataclasses.replace(c.clip, width=64),
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
    """name -> (port config, worker case without its grid)."""
    _, _, _, jp_clip, batch_clip = trees
    out = {}
    for name, drop, train, grads, steps, extra in (
            ("dropout", True, {}, True, STEPS, dict(leaves=LEAVES)),
            ("remat", True, dict(grad_checkpoint=True), True, 1, {}),
            ("infonce", True, dict(use_secla=False), False, 1, {}),
            ("clip_loss", True, dict(no_clip_loss=False), True, 1,
             dict(params=params_from_jax(jp_clip), batch=batch_clip)),
            ("no_dropout", False, {}, False, 1, {}),
            ("bf16", True, dict(compute_dtype="bfloat16"), True, 1, {})):
        tc = configs(drop, **train)[1]
        out[name] = (tc, dict(cfg=tc, steps=steps, grads=grads, **extra))
    return out


# world -> [(grid, case name)], one spawned group a world
GROUPS = {2: [((1, 2), "dropout"), ((1, 2), "remat"), ((1, 2), "infonce"),
              ((1, 2), "clip_loss"), ((1, 2), "bf16")],
          4: [((2, 2), "dropout"), ((1, 4), "dropout"), ((1, 4), "clip_loss")],
          8: [((4, 2), "no_dropout")]}
DECODE = dict(batch=4, seed=1, dtype=torch.float32)


@pytest.fixture(scope="module")
def groups(trees, tmp_path_factory):
    """(grid, case name) -> rank 0's results, three spawned gloo groups."""
    jp, jt, batch, _, _ = trees
    all_cases = cases(trees)
    out = {}
    for world, runs in GROUPS.items():
        specs = []
        for grid, name in runs:
            case = dict(all_cases[name][1], grid=grid)
            if (grid, name) == ((1, 2), "dropout"):
                case["decode"] = DECODE
            specs.append(case)
        spec = dict(device="cpu", threads=1, params=params_from_jax(jp),
                    teacher=params_from_jax(jt), rng=5, batch=batch, cases=specs)
        res = chip_smoke.run_dp_group(world, spec, str(tmp_path_factory.mktemp(f"tp{world}")),
                                      DEADLINE_S)
        out.update({(grid, name): r for (grid, name), r in zip(runs, res)})
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
                                         TL.split(state.rng)[1])
            res["grads"], res["grad_metrics"] = grads, {k: float(v) for k, v in m.items()}
            res["paths"] = [p for p, _ in leaves_with_path(state.params)]
        for _ in range(case["steps"]):
            state, m = step_fn(state, b)
            res["steps"].append({k: float(v) for k, v in m.items()})
        res["leaves"] = {k: chip_smoke._at(state.params, k).detach().clone()
                         for k in case.get("leaves", ())}
        out[name] = res
    return out


def assert_metrics(got: dict, want: dict, tol: float, tag: str):
    assert set(got) == set(want), tag
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=f"{tag} {k}")


def runs_of(*names):
    return [(g, n) for runs in GROUPS.values() for g, n in runs if n in names]


@pytest.mark.parametrize("grid,case", runs_of("dropout", "remat", "infonce", "clip_loss"))
def test_tp_loss_terms_match_one_process(groups, one_process, grid, case):
    got, want = groups[(grid, case)], one_process[case]
    assert len(got["steps"]) == len(want["steps"])
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        assert_metrics(g, w, 2e-5, f"grid {grid}, {case}, step {i}")
    if case == "clip_loss":
        assert "clip_loss" in got["steps"][0]
    if case == "infonce":
        assert "face_name_loss" in got["steps"][0]


@pytest.mark.parametrize("grid,case", runs_of("dropout", "remat", "clip_loss"))
def test_tp_gradients_match_one_process(groups, one_process, grid, case):
    """Every gradient leaf (the cut ones gathered whole) against one process,
    and every replicated leaf's gradient bit-identical across the model
    ranks (a column-parallel input without copy_to_model_parallel would
    break it silently)."""
    got, want = groups[(grid, case)], one_process[case]
    assert_metrics(got["grad_metrics"], want["grad_metrics"], 2e-5, f"{grid}, {case}")
    assert got["tp"]["replicated_grads_agree"]
    # a key bias's gradient is zero but for f32 noise (softmax ignores a
    # shift of the scores), so its scale is its attention's largest
    errs = chip_smoke.grad_errors(want["paths"], got["grads"], want["grads"])
    assert len(errs) > 20
    assert all(e <= 1e-5 for e in errs.values()), max(errs.items(), key=lambda kv: kv[1])


def test_tp_bf16_is_as_close_to_f32_as_one_process(groups, one_process):
    """The bf16 witness (chip_smoke.bf16_witness, the tp phase's bf16 check):
    the bf16 tp 2 step's gradients, loss terms and gradient norm are no
    further from the f32 one-process step than TP_BF16_RATIO times one bf16
    process's (TP_BF16_LEAF_RATIO leaf by leaf); a fault confined to one
    small leaf (a cut bias's gradient from one rank only) fails it. The loss terms are those
    of one bf16 process within 2e-5 (the gradient norm is the witness's:
    the ranks' input gradients round to bf16 before their sum)."""
    f32, bf16, tp = one_process["dropout"], one_process["bf16"], groups[((1, 2), "bf16")]
    terms = {k: v for k, v in bf16["steps"][0].items() if k != "grad_norm"}
    assert_metrics({k: tp["steps"][0][k] for k in terms}, terms, 2e-5, "bf16 tp 2")
    args = (f32["paths"], f32["grads"], bf16["grads"])
    metrics = (f32["grad_metrics"], bf16["grad_metrics"], tp["grad_metrics"])
    w = chip_smoke.bf16_witness(*args, tp["grads"], *metrics)
    assert w["ok"], w
    assert 0 < w["all"][1] <= chip_smoke.TP_BF16_RATIO * w["all"][0]
    assert len(w["leaves"]) > 20 and set(w["terms"]) >= {"txt_loss", "loss", "grad_norm"}
    bad = list(tp["grads"])
    i = f32["paths"].index(("model", "encoder", "layers", 1, "ner_map_up", "bias"))
    bad[i] = bad[i].clone()
    bad[i][bad[i].shape[0] // 2:] = 0
    assert not chip_smoke.bf16_witness(*args, bad, *metrics)["ok"]


def test_one_process_data_group_keeps_the_data_parallel_path(trees, monkeypatch):
    """make_train_step(group=) with a data group of one process runs the
    data-parallel path (init_fn broadcasts over it, the step sums over it);
    only under a model group is such a data group (a dp 1 grid) no group."""
    jp, jt, batch, _, _ = trees
    tc = configs(False)[1]
    data, model = object(), object()
    calls = []
    monkeypatch.setattr(TT.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(TT.dist, "get_world_size", lambda group=None: 1)
    monkeypatch.setattr(TT.dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(TT.dist, "get_global_rank", lambda group, rank: 0)
    monkeypatch.setattr(TT.dist, "broadcast", lambda t, src, group: calls.append(("b", group)))
    monkeypatch.setattr(TT.dist, "all_reduce",
                        lambda t, op=None, group=None: calls.append(("r", group)))
    monkeypatch.setattr(TT.dist, "all_gather", lambda parts, t, group=None: (
        parts[0].copy_(t), calls.append(("g", group))))
    for model_group in (None, model):
        calls.clear()
        init_fn, step_fn = TT.make_train_step(tc, 10, device="cpu", group=data,
                                              model_group=model_group)
        step_fn(init_fn(params_from_jax(jp), params_from_jax(jt), 0), batch)
        if model_group is None:
            assert {c for c, _ in calls} >= {"b", "r"} and all(g is data for _, g in calls)
        else:
            assert calls == []


@pytest.mark.parametrize("grid,case", runs_of("dropout", "clip_loss"))
def test_tp_shards_and_gather(groups, grid, case):
    """Each rank holds its shards and nothing more (storage bytes against the
    sum of its shard shapes); gather_params of the teacher gives back the
    whole teacher bit for bit."""
    t = groups[(grid, case)]["tp"]
    assert t["param_bytes"] == t["shard_bytes"]
    assert t["teacher_gathered"]


def test_tp_updated_leaves_match_one_process(groups, one_process):
    """The named leaves after three steps (a column-parallel, a row-parallel
    and a replicated leaf of BART and of fusion; a cut bias; the clipcap
    mapper's pair), gathered whole, against one process."""
    got, want = groups[((1, 2), "dropout")]["leaves"], one_process["dropout"]["leaves"]
    assert set(got) == set(LEAVES)
    for k in LEAVES:
        assert got[k].shape == want[k].shape, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6, msg=k)


def test_tp_decode_after_training(groups):
    """The gathered tree decoded over a data mesh (generate_mm_sharded) as
    JAX's _dryrun_body does: identical to generate_mm of the same tree."""
    d = groups[((1, 2), "dropout")]["decode"]
    assert d["identical"] and d["finite"]
    assert tuple(d["tokens"].shape) == (DECODE["batch"], configs(False)[1].decode.max_length)


def test_dp4_tp2_matches_jax_gspmd_step(groups, trees):
    """The 8-rank dp 4 x tp 2 step with dropout off against JAX's step_fn
    with state.params and state.teacher placed by param_shardings on a 4 x 2
    mesh and the batch over the data axis (__graft_entry__.py:153-165)."""
    jp, jt, batch, _, _ = trees
    jc = configs(False)[0]
    init_fn, step_fn = JT.make_train_step(jc, 100)
    state = init_fn(jp, jt, jax.random.PRNGKey(5))
    mesh = JM.make_mesh(JMeshConfig(model_parallel=2), devices=jax.devices()[:8])
    repl = NamedSharding(mesh, P())
    state = state._replace(
        params=jax.device_put(state.params, JM.param_shardings(state.params, mesh)),
        teacher=jax.device_put(state.teacher, JM.param_shardings(state.teacher, mesh)),
        opt_state=jax.device_put(state.opt_state, repl), step=jax.device_put(state.step, repl),
        rng=jax.device_put(state.rng, repl))
    sharded = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("data")))
               for k, v in batch.items()}
    with mesh:
        _, m = jax.jit(step_fn)(state, sharded)
    got = groups[((4, 2), "no_dropout")]["steps"][0]
    assert_metrics(got, {k: float(v) for k, v in m.items()}, 1e-4, "dp 4 x tp 2 against JAX")


def test_tp_flash_launches_recorded(groups):
    """Every rank reports its step times and its step's flash_attention
    launches (none on the CPU: the kernel runs on the card)."""
    for (grid, _), res in groups.items():
        assert len(res["ranks"]) == grid[0] * grid[1]
        for r in res["ranks"]:
            assert r["flash_attention"] == 0 and len(r["step_ms"]) == len(res["steps"])


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mp", [2, 4])
def test_shard_shapes_match_jax(trees, mp):
    """shard_params(ModelShard(rank, mp)) gives each leaf the shape of JAX's
    addressable shard on the mesh's model-axis device `rank` (a (8/mp) x mp
    mesh), for the model, both CLIP towers and the teacher."""
    _, jt, _, jp_clip, _ = trees
    mesh = JM.make_mesh(JMeshConfig(model_parallel=mp), devices=jax.devices()[:8])
    for jtree in (jp_clip, jt):
        placed = jax.device_put(jtree, JM.param_shardings(jtree, mesh))
        want = {jax.tree_util.keystr(p): {s.device: tuple(s.data.shape)
                                          for s in leaf.addressable_shards}
                for p, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]}
        full = params_from_jax(jtree)
        whole = {path: tuple(t.shape) for path, t in leaves_with_path(full)}
        n_cut = 0
        for rank in range(mp):
            got = leaves_with_path(TP.shard_params(full, TP.ModelShard(rank, mp)))
            assert len(got) == len(want)
            for path, t in got:
                key = "".join(f"['{k}']" if isinstance(k, str) else f"[{k}]" for k in path)
                assert tuple(t.shape) == want[key][mesh.devices[0, rank]], path
                n_cut += rank == 0 and tuple(t.shape) != whole[path]
        assert n_cut > 10


def test_shards_concatenate_to_the_whole(trees):
    """The ranks' shards laid side by side along the rule's dimension are the
    whole leaf; each cut shard owns its storage (the whole can be freed)."""
    _, _, _, jp_clip, _ = trees
    full = params_from_jax(jp_clip)
    shards = [TP.shard_params(full, TP.ModelShard(r, 2)) for r in range(2)]
    for (path, whole), (_, a), (_, b) in zip(*(leaves_with_path(t) for t in [full] + shards)):
        if TP.is_cut(path, whole):
            assert a.untyped_storage().nbytes() == a.numel() * a.element_size()
            assert torch.equal(torch.cat([a, b], dim=param_dim(path, whole)), whole)
        else:
            assert a is whole and b is whole


def test_head_shard_mha_is_those_heads():
    """mha on a model rank's shard (2 of 4 heads, collectives skipped: the
    row-parallel output is the rank's partial product plus the bias) summed
    over the ranks, less the extra biases, is the one-process mha: the
    heads keep head_dim (trap 1) and its scaling (trap 2). The 256-token
    masked self-attention takes flash_attention's route (its plain twin
    here) on the head shard under no_grad."""
    g = torch.Generator().manual_seed(0)
    d, heads = 256, 4  # head_dim 64: flash_eligible
    p = TL.mha_init(g, d)
    for name in p:
        p[name]["bias"] = torch.randn(d, generator=g) * 0.1
    x = torch.randn(2, 256, d, generator=g)
    mask = torch.zeros(2, 1, 256, 256)
    mask[1, :, :, 200:] = torch.finfo(torch.float32).min
    for kv, m in ((None, mask), (torch.randn(2, 7, d, generator=g), None)):
        with torch.no_grad():
            want = TL.mha(p, x, key_value=kv, mask=m, num_heads=heads)
            parts = [TL.mha(TP.shard_params({"a": p}, TP.ModelShard(r, 2))["a"], x,
                            key_value=kv, mask=m, num_heads=heads, tp=TP.ModelShard(r, 2))
                     for r in range(2)]
        torch.testing.assert_close(parts[0] + parts[1] - p["out_proj"]["bias"], want,
                                   rtol=1e-5, atol=1e-5)


def test_row_linear_adds_the_bias_once(monkeypatch):
    """row_linear sums the ranks' f32 partial products (the reduction
    emulated here over the ranks' recorded partials), then adds the bias
    once and rounds once: the one-process linear, in bf16 and f32."""
    g = torch.Generator().manual_seed(1)
    p = {"kernel": torch.randn(32, 8, generator=g), "bias": torch.full((8,), 100.0)}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(5, 32, generator=g).to(dtype)
        partials = []
        monkeypatch.setattr(TL, "reduce_from_model_parallel",
                            lambda y, tp: partials.append(y) or y)
        shards = [TP.shard_params({"fc2": p}, TP.ModelShard(r, 2))["fc2"] for r in range(2)]
        for r in range(2):
            TL.row_linear(shards[r], x[:, 16 * r:16 * (r + 1)], TP.ModelShard(r, 2))
        assert all(y.dtype == torch.float32 for y in partials)
        monkeypatch.setattr(TL, "reduce_from_model_parallel", lambda y, tp: sum(partials))
        got = TL.row_linear(shards[0], x[:, :16], TP.ModelShard(0, 2))
        want = TL.linear(p, x)
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=1e-4 if dtype == torch.float32 else 0.5)


@pytest.mark.parametrize("world", [1, 2])
def test_column_shard_dropout_draws_the_whole_columns(world):
    """A ColShardSeed's mask is its columns of the one-process mask, along
    the last dimension ([B, T, ffn]) and along the heads ([B, H, T, S]); with
    a RowShardSeed under it, its rows too."""
    x = torch.randn(4, 6, 4, 8, generator=torch.Generator().manual_seed(0)) + 3.0
    seed = TL.fold_in(11, 2)
    for dim in (-1, 1):
        whole = TL.dropout(x, 0.3, seed)
        n_rows = x.shape[0] // world
        for r in range(world):
            base = TL.RowShardSeed(seed, r, world) if world > 1 else seed
            rows = x[r * n_rows:(r + 1) * n_rows]
            cols = [TL.dropout(rows.narrow(dim, c * (x.shape[dim] // 2), x.shape[dim] // 2),
                               0.3, TL.ColShardSeed(base, c, 2, dim)) for c in range(2)]
            assert torch.equal(torch.cat(cols, dim=dim), whole[r * n_rows:(r + 1) * n_rows])
        assert 0 < int((whole == 0).sum()) < whole.numel()
    s = TL.column_seed(TL.RowShardSeed(seed, 1, 2), TP.ModelShard(1, 2))
    assert isinstance(s, TL.ColShardSeed) and (s.rank, s.world, s.col_rank) == (1, 2, 1)
    assert type(TL.fold_in(s, 3)) is TL.RowShardSeed  # the column shard stays at its site
    assert TL.column_seed(None, TP.ModelShard(0, 2)) is None and TL.column_seed(5, None) == 5


def test_global_norm_counts_cut_leaves_over_the_group():
    """Without a group, the squares of a rank's cut leaves plus the
    replicated ones: the two ranks' norms combine to the one-process norm
    once the cut squares are summed (what the model group's all-reduce
    does)."""
    g = torch.Generator().manual_seed(2)
    whole = [torch.randn(8, 6, generator=g), torch.randn(6, generator=g)]
    halves = [whole[0][:, :3], whole[0][:, 3:]]
    per_rank = [TO.global_norm([h, whole[1]], [True, False], TP.ModelShard(r, 2))
                for r, h in enumerate(halves)]
    rep = float(whole[1].square().sum())
    got = (sum(float(n) ** 2 - rep for n in per_rank) + rep) ** 0.5
    np.testing.assert_allclose(got, float(TO.global_norm(whole)), rtol=1e-6)


def test_refusals(trees):
    """A model group that does not divide an attention's heads, or a cut
    dimension, is refused naming the layer or leaf (JAX would reshard or
    replicate); an mha shard of part of a head too; without a card the
    tensor-parallel step refuses the default device; no group is the
    one-process path."""
    jp, _, _, _, _ = trees
    tc = configs(False)[1]
    full = params_from_jax(jp)
    with pytest.raises(ValueError, match=r"does not divide the 4 heads of "
                                         r"model/\w+/layers/\d+/\w+$"):
        TP.check_heads(full, 8, TT.heads_of(tc))
    TP.check_heads(full, 4, TT.heads_of(tc))
    with pytest.raises(ValueError, match="model_parallel=3 does not divide dimension"):
        TP.shard_params(full, TP.ModelShard(0, 3))
    p = TL.mha_init(torch.Generator().manual_seed(0), 64)
    with pytest.raises(ValueError, match="not whole heads"):
        TL.mha(TP.shard_params({"a": p}, TP.ModelShard(0, 8))["a"], torch.zeros(1, 3, 64),
               num_heads=4, tp=TP.ModelShard(0, 8))
    if not torch.cuda.is_available():  # the card by default, never a fall back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.make_train_step(tc, 10, model_group=object())
    assert TP.model_shard(None) is None and TP.shard_params(full, None) is full
    x = torch.ones(3)
    assert TP.copy_to_model_parallel(x, None) is x and TP.reduce_from_model_parallel(x, None) is x
