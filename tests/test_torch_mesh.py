"""Multi-device decoding, serving and evaluation over a `core/mesh.Mesh` on
the CPU (vacnic_tpu_torch/core/mesh.py, infer/generate.generate_mm_sharded,
serve.CaptionService(mesh=), train/loop.generate_captions(mesh=),
data/pipeline.PrefetchLoader(sharding=)), at VacnicConfig.tiny() over
virtual CPU devices (a mesh of repeated torch.device("cpu")), against the
JAX package over its 8 virtual CPU devices (tests/conftest.py):

* make_mesh's shapes and errors, and param_shardings' spec a leaf, equal
  to JAX's on the same tree with model_parallel 1 and 2;
* generate_mm_sharded over 8 devices (and 4 x 2): tokens identical to JAX's
  generate_mm (its Pallas decode and encoder selected, in interpret mode)
  and the port's generate_mm, scores within 1e-5 (f32 sums over another
  batch size); a batch the axis does not divide is refused;
* the sharded CaptionService: tokens identical to JAX's sharded service on
  the same rows and weights, scores within 1e-4 (the tolerance of
  tests/test_torch_serve.py); buckets validated as JAX validates them; an
  update_params swap reaches every shard;
* generate_captions(mesh=) with a batch the axis divides and one it does
  not, and PrefetchLoader(sharding=) batches: the same captions as one
  device.

The weights are JAX's init with a wider spread (as tests/test_torch_serve.py
makes them), carried across by weights_io.params_from_jax."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from vacnic_tpu.core import mesh as JM
from vacnic_tpu.core.config import MeshConfig as JMeshConfig, VacnicConfig as JC
from vacnic_tpu.data.synthetic import synthetic_batch as j_batch
from vacnic_tpu.infer.generate import generate_mm as j_generate
from vacnic_tpu.models import fusion as JF
from vacnic_tpu.serve import CaptionService as JService, ServeConfig as JServeConfig
from vacnic_tpu.train.train_step import create_mask as j_mask, face_mask_from_emb as j_face
from vacnic_tpu_torch.core import mesh as TM
from vacnic_tpu_torch.core.config import MeshConfig, VacnicConfig
from vacnic_tpu_torch.core.tree import leaves_with_path
from vacnic_tpu_torch.data.pipeline import PrefetchLoader, shard_for_data_parallel
from vacnic_tpu_torch.data.synthetic import synthetic_batch
from vacnic_tpu_torch.infer import generate as G
from vacnic_tpu_torch.models.weights_io import params_from_jax
from vacnic_tpu_torch.serve import CaptionService, ServeConfig
from vacnic_tpu_torch.train import loop as TL
from vacnic_tpu_torch.train.train_step import create_mask, face_mask_from_emb

CPU = torch.device("cpu")
SAMPLE_KEYS = ("article_ids", "image_cls", "face_emb", "names_art_ids")


def cpu_mesh(n: int = 8, model_parallel: int = 1) -> TM.Mesh:
    return TM.make_mesh(MeshConfig(model_parallel=model_parallel), devices=[CPU] * n)


def jax_mesh(n: int = 8) -> JMesh:
    return JMesh(np.asarray(jax.devices()[:n]).reshape(n, 1), ("data", "model"))


@pytest.fixture(scope="module")
def setup():
    jcfg = JC.tiny()
    rng = np.random.RandomState(1)
    jp = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.3 * rng.randn(*np.shape(x)).astype(np.float32),
        JF.multimodal_bart_init(jax.random.PRNGKey(0), jcfg.bart, jcfg.fusion))
    return jcfg, VacnicConfig.tiny(), jp, params_from_jax(jp)


def decode_inputs(tcfg, n: int, seed: int = 0):
    b = synthetic_batch(tcfg, n, seed=seed)
    return (b["article_ids"], create_mask(b["article_ids"]), b["image_cls"]), dict(
        face_features=b["face_emb"], face_mask=face_mask_from_emb(b["face_emb"]),
        name_ids=b["names_art_ids"], name_mask=create_mask(b["names_art_ids"]))


# ---------------------------------------------------------------------------
# make_mesh and param_shardings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp,mp", [(-1, 1), (-1, 2), (4, 2), (2, 4), (1, 8), (8, 1)])
def test_make_mesh_shapes_match_jax(dp, mp):
    jm = JM.make_mesh(JMeshConfig(data_parallel=dp, model_parallel=mp), jax.devices()[:8])
    tm = TM.make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp), [CPU] * 8)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape)
    assert tm.devices.shape == jm.devices.shape and tm.size == jm.size == 8
    assert tm.data_devices() == [CPU] * jm.shape["data"]


@pytest.mark.parametrize("dp,mp", [(3, 1), (3, 2), (-1, 3), (16, 1)])
def test_make_mesh_errors_match_jax(dp, mp):
    with pytest.raises(ValueError, match="does not cover 8 devices") as jerr:
        JM.make_mesh(JMeshConfig(data_parallel=dp, model_parallel=mp), jax.devices()[:8])
    with pytest.raises(ValueError, match="does not cover 8 devices") as terr:
        TM.make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp), [CPU] * 8)
    assert str(terr.value) == str(jerr.value)


def test_make_mesh_refusals():
    card = torch.device("cuda", 0)  # a description only: nothing touches a card
    with pytest.raises(ValueError, match="appears twice"):
        TM.make_mesh(devices=[card, card])
    with pytest.raises(ValueError, match="with its index"):
        TM.make_mesh(devices=["cuda"])
    with pytest.raises(ValueError, match="CUDA devices or CPU devices"):
        TM.make_mesh(devices=[card, CPU])
    with pytest.raises(ValueError, match="no 'batch' axis"):
        cpu_mesh(2).data_devices("batch")
    if not torch.cuda.is_available():  # the default is every visible card, never the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.make_mesh()


def _spec_of(named_sharding) -> tuple | None:
    """A JAX NamedSharding's spec as (dim, axis), or None when replicated."""
    cut = [(d, ax) for d, ax in enumerate(named_sharding.spec) if ax is not None]
    assert len(cut) <= 1
    return cut[0] if cut else None


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_param_shardings_match_jax(setup, mp):
    jcfg, _, jp, tp = setup
    jm = JM.make_mesh(JMeshConfig(model_parallel=mp), jax.devices()[:8])
    want = {jax.tree_util.keystr(p): _spec_of(s) for p, s in
            jax.tree_util.tree_flatten_with_path(JM.param_shardings(jp, jm))[0]}
    got = {}
    for path, spec in leaves_with_path(TM.param_shardings(tp, cpu_mesh(8, mp))):
        key = "".join(f"['{k}']" if isinstance(k, str) else f"[{k}]" for k in path)
        got[key] = None if spec.dim is None else (spec.dim, spec.axis)
    assert got == want
    cut = [v for v in got.values() if v is not None]
    assert (len(cut) > 0) == (mp > 1) and {d for d, _ in cut} <= {0, 1}


def test_batch_sharding_and_replicated():
    m = cpu_mesh(4, 2)
    assert TM.batch_sharding(m) == TM.ShardSpec(m, 0, "data") == shard_for_data_parallel(m)
    assert TM.replicated(m) == TM.ShardSpec(m, None, None)


# ---------------------------------------------------------------------------
# generate_mm_sharded
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_kernels(monkeypatch):
    """JAX's Pallas decode and encoder kernels selected (interpret mode on
    the CPU), the paths the port's decode mirrors, as in
    tests/test_torch_generate.py: its XLA path differs by ~1e-4 in score."""
    monkeypatch.setenv("VACNIC_PALLAS_DECODE", "1")
    monkeypatch.setenv("VACNIC_PALLAS_ENCODER", "1")


@pytest.mark.parametrize("mp", [1, 2])
def test_generate_mm_sharded_matches_jax_and_port(setup, mp, jax_kernels):
    jcfg, tcfg, jp, tp = setup
    dcfg_j = dataclasses.replace(jcfg.decode, num_beams=3, max_length=10)
    dcfg_t = dataclasses.replace(tcfg.decode, num_beams=3, max_length=10)
    jb = j_batch(jcfg, 8, seed=0)
    js, jsc = j_generate(jp, jb["article_ids"], j_mask(jb["article_ids"]), jb["image_cls"],
                         jcfg.bart, jcfg.fusion, dcfg_j, face_features=jb["face_emb"],
                         face_mask=j_face(jb["face_emb"]), name_ids=jb["names_art_ids"],
                         name_mask=j_mask(jb["names_art_ids"]))
    args, kw = decode_inputs(tcfg, 8)
    ts, tsc = G.generate_mm(tp, *args, tcfg.bart, tcfg.fusion, dcfg_t, device="cpu", **kw)
    ss, ssc = G.generate_mm_sharded(cpu_mesh(8, mp), tp, *args, tcfg.bart, tcfg.fusion, dcfg_t,
                                    **kw)
    np.testing.assert_array_equal(ss.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ss.numpy(), ts.numpy())
    assert len(np.unique(ss.numpy())) > 4  # the beams chose varied tokens
    np.testing.assert_allclose(ssc.numpy(), np.asarray(jsc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ssc.numpy(), tsc.numpy(), rtol=1e-5, atol=1e-5)
    assert ss.device == CPU and ss.shape == (8, 10) and ssc.shape == (8,)


def test_generate_mm_sharded_refuses_a_batch_the_axis_does_not_divide(setup):
    _, tcfg, _, tp = setup
    args, kw = decode_inputs(tcfg, 6)
    with pytest.raises(ValueError, match="6 rows does not divide over the 8-device"):
        G.generate_mm_sharded(cpu_mesh(8), tp, *args, tcfg.bart, tcfg.fusion, tcfg.decode,
                              **kw)
    with pytest.raises(ValueError, match="no 'batch' axis"):
        G.generate_mm_sharded(cpu_mesh(2), tp, *args, tcfg.bart, tcfg.fusion, tcfg.decode,
                              data_axis="batch", **kw)


def test_generate_mm_sharded_takes_sharded_batches_and_raises_a_workers_error(setup):
    """Inputs already cut into row shards (what PrefetchLoader(sharding=)
    yields) give the tokens of whole tensors; a shard the worker cannot
    decode raises in the caller."""
    _, tcfg, _, tp = setup
    dcfg = dataclasses.replace(tcfg.decode, num_beams=2, max_length=8)
    mesh = cpu_mesh(4)
    args, kw = decode_inputs(tcfg, 8, seed=3)
    whole = G.generate_mm_sharded(mesh, tp, *args, tcfg.bart, tcfg.fusion, dcfg, **kw)
    devs = mesh.data_devices()
    shard = lambda x: TM.Sharded(tuple(torch.chunk(x, len(devs))))  # noqa: E731
    cut = G.generate_mm_sharded(mesh, tp, *map(shard, args), tcfg.bart, tcfg.fusion, dcfg,
                                **{k: shard(v) for k, v in kw.items()})
    assert torch.equal(whole[0], cut[0]) and torch.equal(whole[1], cut[1])
    with pytest.raises(ValueError, match="3 shards on a data axis of 4"):
        G.generate_mm_sharded(mesh, tp, TM.Sharded(tuple(torch.chunk(args[0], 3))), *args[1:],
                              tcfg.bart, tcfg.fusion, dcfg, **kw)
    bad = dict(kw, face_features=kw["face_features"][:, :, :-1])  # one feature short
    with pytest.raises(RuntimeError):
        G.generate_mm_sharded(mesh, tp, *args, tcfg.bart, tcfg.fusion, dcfg, **bad)


def test_replicas_are_made_once_and_refreshed_after_an_in_place_change(setup):
    _, tcfg, jp, _ = setup
    tp = params_from_jax(jp)  # this test's own tree: it is changed in place
    mesh = cpu_mesh(4)
    first = G.replicate(tp, mesh)
    assert len(first) == 4 and G.replicate(tp, mesh) is first
    assert first[0]["shared"]["weight"] is tp["shared"]["weight"]  # on its device: not copied
    with torch.no_grad():
        tp["shared"]["weight"].add_(1.0)  # an optimizer step's kind of change
    second = G.replicate(tp, mesh)
    assert second is not first and G.replicate(tp, mesh) is second
    other = dict(tp, shared={"weight": tp["shared"]["weight"].clone()})  # a leaf replaced
    assert G.replicate(other, mesh) is not G.replicate(tp, mesh)
    G.drop_replicas(tp)
    G.drop_replicas(other)
    assert all(v[0] is not tp and v[0] is not other for v in G._REPLICAS.values())
    for i in range(G._REPLICAS_MAX + 2):  # bounded, oldest out first
        G.replicate(dict(tp), cpu_mesh(2))
    assert len(G._REPLICAS) <= G._REPLICAS_MAX


# ---------------------------------------------------------------------------
# CaptionService(mesh=)
# ---------------------------------------------------------------------------

def _rows(cfg, n, seed):
    b = synthetic_batch(cfg, n, seed=seed)
    return [{k: b[k][i].numpy() for k in SAMPLE_KEYS} for i in range(n)]


def _serve(svc, rows):
    try:
        futs = [svc.submit(r) for r in rows]
        return [f.result(timeout=300) for f in futs]
    finally:
        svc.close()


def test_sharded_service_matches_jax_sharded_service(setup, jax_kernels):
    """tests/test_serve.py:279-304 on both packages: 5 requests padded to
    the 8-bucket over an 8-way data axis."""
    jcfg, tcfg, jp, tp = setup
    rows = _rows(tcfg, 5, seed=11)
    svc = CaptionService(tcfg, {"model": tp}, mesh=cpu_mesh(8),
                         serve_cfg=ServeConfig(buckets=(8,), max_wait_ms=5000))
    got = _serve(svc, rows)
    st = svc.stats()
    assert st["requests"] == 5 and st["padded_rows"] == 3
    jsvc = JService(jcfg, {"model": jp}, mesh=jax_mesh(8),
                    serve_cfg=JServeConfig(buckets=(8,), max_wait_ms=5000))
    want = _serve(jsvc, rows)
    for g, w in zip(got, want):
        assert g["tokens"] == w["tokens"]
        assert g["score"] == pytest.approx(w["score"], rel=1e-4, abs=1e-4)
    assert len({t for g in got for t in g["tokens"]}) > 4


def test_sharded_bucket_divisibility_validated(setup):
    _, tcfg, _, tp = setup
    with pytest.raises(ValueError, match=r"buckets \[1\] not divisible by the 'data' mesh axis"):
        CaptionService(tcfg, {"model": tp}, mesh=cpu_mesh(8),
                       serve_cfg=ServeConfig(buckets=(1, 8)))
    with pytest.raises(ValueError, match="mesh has no 'batch' axis"):
        CaptionService(tcfg, {"model": tp}, mesh=cpu_mesh(8), data_axis="batch",
                       serve_cfg=ServeConfig(buckets=(8,)))
    with pytest.raises(ValueError, match="a mesh or a device, not both"):
        CaptionService(tcfg, {"model": tp}, mesh=cpu_mesh(2), device="cpu",
                       serve_cfg=ServeConfig(buckets=(2,)))


def test_sharded_update_params_reaches_every_replica(setup):
    """After a swap, all 8 rows -- two on each of the 4 shards -- decode with
    the new weights (equal to a direct generate_mm on them, and not to the
    old weights' tokens), and the old tree's replicas are dropped."""
    jcfg, tcfg, jp, tp = setup
    rng = np.random.RandomState(5)
    new = params_from_jax(jax.tree_util.tree_map(
        lambda x: x + 0.3 * rng.randn(*np.shape(x)).astype(np.float32), jp))
    old = {"model": params_from_jax(jp)}
    rows = _rows(tcfg, 8, seed=4)
    mesh = cpu_mesh(4)
    svc = CaptionService(tcfg, old, mesh=mesh,
                         serve_cfg=ServeConfig(buckets=(8,), max_wait_ms=5000))
    try:
        before = [svc.submit(r) for r in rows]
        before = [f.result(timeout=300)["tokens"] for f in before]
        assert svc.update_params({"model": new}) == 1
        after = [f.result(timeout=300)["tokens"] for f in [svc.submit(r) for r in rows]]
    finally:
        svc.close()
    b = {k: torch.from_numpy(np.stack([r[k] for r in rows])) for k in SAMPLE_KEYS}
    want, _ = G.generate_mm(new, b["article_ids"], create_mask(b["article_ids"]),
                            b["image_cls"], tcfg.bart, tcfg.fusion, tcfg.decode,
                            face_features=b["face_emb"],
                            face_mask=face_mask_from_emb(b["face_emb"]),
                            name_ids=b["names_art_ids"], name_mask=create_mask(b["names_art_ids"]),
                            device="cpu")
    assert after == want.tolist()
    for shard in range(4):  # every shard's rows changed
        assert before[2 * shard:2 * shard + 2] != after[2 * shard:2 * shard + 2]
    assert all(v[0] is not old["model"] for v in G._REPLICAS.values())


# ---------------------------------------------------------------------------
# generate_captions(mesh=) and PrefetchLoader(sharding=)
# ---------------------------------------------------------------------------

class IdTokenizer:
    """decode: the ids as text (no vocabulary needed for a token comparison)."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


class Rows:
    def __init__(self, cfg, n):
        b = synthetic_batch(cfg, n, seed=7)
        self.rows = [{k: b[k][i].numpy() for k in SAMPLE_KEYS} for i in range(n)]

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return dict(self.rows[i], caption=f"row {i}")


def collate(rows):
    out = {k: np.stack([r[k] for r in rows]) for k in SAMPLE_KEYS}
    out["caption"] = [r["caption"] for r in rows]
    return out


def test_generate_captions_over_a_mesh(setup, monkeypatch):
    """10 rows at batch 4 on a 4-way axis: two batches through
    generate_mm_sharded, the tail of 2 through generate_mm; the captions
    equal one device's, whether the loader shards the batches or not."""
    _, tcfg, _, tp = setup
    mesh, tok = cpu_mesh(4), IdTokenizer()
    calls = []

    def counting(*a, **kw):
        calls.append(len(a[2]) if not isinstance(a[2], TM.Sharded) else a[2].shape[0])
        return G.generate_mm_sharded(*a, **kw)

    monkeypatch.setattr(TL, "generate_mm_sharded", counting)

    def loader(**kw):
        return PrefetchLoader(Rows(tcfg, 10), 4, collate, shuffle=False, drop_last=False,
                              num_workers=2, **kw)

    params = {"model": tp}
    want = TL.generate_captions(tcfg, params, loader(device="cpu"), tok, compute_metrics=False,
                                device="cpu")
    plain = TL.generate_captions(tcfg, params, loader(device="cpu"), tok, compute_metrics=False,
                                 mesh=mesh)
    assert calls == [4, 4]
    sharded_loader = loader(sharding=shard_for_data_parallel(mesh))
    kinds = [type(b["article_ids"]).__name__ for b in sharded_loader]
    assert kinds == ["Sharded", "Sharded", "Tensor"]
    cut = TL.generate_captions(tcfg, params, sharded_loader, tok, compute_metrics=False,
                               mesh=mesh)
    assert calls == [4, 4, 4, 4]
    assert plain == want and cut == want and len(want) == 10
    assert want[9]["gt"] == "row 9" and len(set(v["gen"] for v in want.values())) > 1
    with pytest.raises(ValueError, match="a mesh or a device, not both"):
        TL.generate_captions(tcfg, params, [], tok, mesh=mesh, device="cpu")


def test_sharded_loader_copies_each_shard_to_its_device():
    """Row shards of every array whose leading dimension is the batch's,
    contiguous and in order; the loader refuses a device beside a
    sharding, and a sharding that does not cut the batch dimension."""
    cfg = VacnicConfig.tiny()
    mesh = cpu_mesh(2)
    ds = Rows(cfg, 4)
    batch = next(iter(PrefetchLoader(ds, 4, collate, shuffle=False, num_workers=1,
                                     sharding=shard_for_data_parallel(mesh))))
    whole = collate([ds[i] for i in range(4)])
    for k in SAMPLE_KEYS:
        assert isinstance(batch[k], TM.Sharded) and len(batch[k].shards) == 2
        assert batch[k].shape == whole[k].shape
        np.testing.assert_array_equal(batch[k].gather(CPU).numpy(), whole[k])
    assert batch["caption"] == whole["caption"]
    with pytest.raises(ValueError, match="sharding= or device="):
        PrefetchLoader(ds, 4, collate, sharding=shard_for_data_parallel(mesh), device="cpu")
    with pytest.raises(ValueError, match="must cut the batch dimension"):
        PrefetchLoader(ds, 4, collate, sharding=TM.replicated(mesh))


def test_launch_counts_are_exact_under_threads(monkeypatch):
    """One host thread a card bumps the launch counts at once: 16 threads x
    2000 launches through `_launch` (its library entry faked: no card here)
    under a 1 us switch interval, and no count is lost."""
    import sys
    import threading

    from vacnic_tpu_torch.kernels import _build
    from vacnic_tpu_torch.kernels import primitives as K

    class FakeLib:
        def vt_fake(self, *args):
            return 0

    monkeypatch.setattr(_build, "lib", lambda: FakeLib())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(K, "_stream", lambda device=None: None)
    card = torch.device("cuda", 0)  # a description: the fake entry takes no pointer
    K.reset_launch_counts()
    threads, n = 16, 2000

    def work():
        for _ in range(n):
            K._launch("gemm_bf16", "vt_fake", card, variant=(K.GEMM_VARIANT_LAUNCHES, "small_m"))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert K.launch_counts()["gemm_bf16"] == threads * n
    assert K.gemm_variant_counts() == {"large_m": 0, "small_m": threads * n, "mid_m": 0}
    K.reset_launch_counts()
