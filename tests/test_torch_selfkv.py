"""The quantized self cache of the port (infer/decode_fast with an int8 or
fp8 e4m3 self cache, read by kernels/primitives.dec_self_attention's twin on
the CPU) against the JAX package in f32: the row quantizer and the fp8
store, single kernel steps on caches whose values the quantization holds
exactly, five-step rolls through the real write path, generate_mm end to
end, and the choice of cache types (generate.cache_plan).

Tolerances: bit-identical where the quantization is exact on both sides of
a comparison within the port (power-of-two int8 scales, values on the fp8
grid); 1e-4 against JAX, whose kernel step computes the same f32 recipe in
another order (interpret mode)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from test_torch_decode import BATCH, BEAMS, MAX_LEN, jax_steps, setup, t  # noqa: F401
from test_torch_generate import inputs
from vacnic_tpu.infer import decode_fast as JDF
from vacnic_tpu.infer.generate import generate_mm as j_generate
from vacnic_tpu_torch.infer import decode_fast as TDF
from vacnic_tpu_torch.infer import generate as TG
from vacnic_tpu_torch.kernels import primitives as K

FP8 = jnp.float8_e4m3fn


# --------------------------------------------------------------------------
# the quantizers
# --------------------------------------------------------------------------

def test_quantize_self_rows_matches_jax():
    """Random rows, a head of exact ties (scale 1: x / scale lands on .5),
    and an all-zero row (the 1e-12 floor): int8 values bit-identical to
    JAX's, round half to even, scales within rtol 1e-6."""
    rng = np.random.RandomState(0)
    rows = rng.randn(2, 6, 32).astype(np.float32)
    rows[0, 0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5, -126.5]
    rows[1, 2] = 0.0
    qt, st = TDF.quantize_self_rows(t(rows), 4)
    qj, sj = JDF.quantize_self_rows(jnp.asarray(rows), 4)
    assert qt.dtype == torch.int8 and tuple(st.shape) == (2, 6, 4)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert_close(st, sj, atol=0, rtol=1e-6)
    np.testing.assert_array_equal(qt[0, 0, :8].numpy(), [127, 0, 2, 2, 0, -2, 64, -126])
    assert np.all(st[1, 2].numpy() == np.float32(1e-12)) and not qt[1, 2].any()


def test_fp8_store_matches_jax():
    """clamp(+-448) then cast, against JAX's clip(+-448).astype(e4m3) on a
    grid of the edges: the largest finite value and past it, subnormals, a
    tie at the smallest subnormal and ties between normal neighbours."""
    grid = np.array([0.0, 448.0, -448.0, 449.0, -449.0, 464.0, 465.0, 1000.0, -1000.0,
                     2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -10, 5 * 2.0 ** -10, 2.0 ** -7,
                     1.0625, 1.1875, 17.0, 19.0, -0.3, 3.1415927, 1e-30], np.float32)
    got = TDF.to_fp8(t(grid))
    assert got.dtype == torch.float8_e4m3fn
    ref = jnp.clip(jnp.asarray(grid), -448.0, 448.0).astype(FP8).astype(jnp.float32)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref))
    assert float(got.float().abs().max()) == 448.0


# --------------------------------------------------------------------------
# single kernel steps on exactly quantized caches
# --------------------------------------------------------------------------

def ker_cache(tp, enc, tcfg, **kw):
    """The port's time-major cache of the shared fixture's shape."""
    return TDF.build_decode_cache(tp, t(enc), BEAMS, MAX_LEN, tcfg, torch.float32, pad_to=16,
                                  time_major=True, **kw)


def _pal(jcfg, jp, j, enc_bias):
    return jax_steps(jcfg, jp, j, enc_bias)[1]


def _past_only(x, pos):
    """Rows t >= pos zero: the cache holds only what earlier steps wrote."""
    x = x.copy()
    x[:, pos:] = 0.0
    return x


def test_selfkv_fp8_exact_when_representable(setup):
    """Past rows already on the fp8 grid: the fp8 cache's step is
    bit-identical to the f32 cache's (the step reads its own row from the
    QKV output, never from the cache), within 1e-4 of JAX's fp8 step, and
    the step's row lands clamped and cast."""
    jcfg, tcfg, jp, tp, enc, enc_bias, j = setup
    bk, pos = BATCH * BEAMS, 3
    rng = np.random.RandomState(3)
    shape = tuple(j["cache_tm"].self_k.shape)
    grid_k, grid_v = (_past_only(TDF.to_fp8(t(rng.randn(*shape).astype(np.float32) * 2)).float()
                                 .numpy(), pos) for _ in range(2))
    dp = TDF.build_decode_params(tp, torch.float32)
    base = ker_cache(tp, enc, tcfg)
    base = base._replace(self_k=t(grid_k), self_v=t(grid_v))
    quant = ker_cache(tp, enc, tcfg, self_kv_fp8=True)
    quant.self_k.copy_(t(grid_k).to(torch.float8_e4m3fn))
    quant.self_v.copy_(t(grid_v).to(torch.float8_e4m3fn))
    tok = np.full((bk, 1), 7, np.int32)
    lb, base = TDF.decode_step_kernel(dp, tp, base, t(tok), pos, t(enc_bias), tcfg, torch.float32)
    lq, quant = TDF.decode_step_kernel(dp, tp, quant, t(tok), pos, t(enc_bias), tcfg,
                                       torch.float32)
    assert torch.equal(lq, lb)
    assert torch.equal(quant.self_k[:, :pos].float(), base.self_k[:, :pos])
    assert torch.equal(quant.self_k[:, pos].float(), TDF.to_fp8(base.self_k[:, pos]).float())
    jq = j["cache_tm"]._replace(self_k=jnp.asarray(grid_k).astype(FP8),
                                self_v=jnp.asarray(grid_v).astype(FP8))
    lj, cj = _pal(jcfg, jp, j, enc_bias)(jq, jnp.asarray(tok), jnp.int32(pos))
    assert_close(lq, lj)
    np.testing.assert_array_equal(quant.self_k.float().numpy(),
                                  np.asarray(cj.self_k.astype(jnp.float32)))


def _int8_pow2(seed, shape, heads):
    """int8 values at rows t < 3, power-of-two per-row scales, and the
    dequantized f32 cache they stand for."""
    rng = np.random.RandomState(seed)
    n_l, n_t, bk, d = shape
    ints = [_past_only(rng.randint(-127, 128, shape).astype(np.float32), 3) for _ in range(2)]
    scales = [(2.0 ** rng.randint(-3, 3, (n_l, n_t, bk, heads))).astype(np.float32)
              for _ in range(2)]
    deq = [(i.reshape(n_l, n_t, bk, heads, -1) * s[..., None]).reshape(shape)
           for i, s in zip(ints, scales)]
    return ints, scales, deq


@pytest.mark.parametrize("reorder", [False, True], ids=["identity", "reordered"])
def test_selfkv_int8_pow2_exact(setup, reorder):
    """int8 past rows with power-of-two scales: the step is bit-identical to
    the f32 cache of the dequantized values (each scale multiplies exactly
    and commutes with every rounding), under the identity ancestry and after
    two random beam selections, where a scale read through the wrong row
    would show; within 1e-4 of JAX's int8 step on the same cache."""
    jcfg, tcfg, jp, tp, enc, enc_bias, j = setup
    bk, heads = BATCH * BEAMS, tcfg.decoder_attention_heads
    shape = tuple(j["cache_tm"].self_k.shape)
    (ik, iv), (sk, sv), (dk, dv) = _int8_pow2(11 if reorder else 5, shape, heads)
    dp = TDF.build_decode_params(tp, torch.float32)
    base = ker_cache(tp, enc, tcfg)
    base = base._replace(self_k=t(dk), self_v=t(dv), pos=2)
    quant = ker_cache(tp, enc, tcfg, self_kv_int8=True)
    quant = quant._replace(self_k=t(ik).to(torch.int8), self_v=t(iv).to(torch.int8),
                           self_k_scale=t(sk), self_v_scale=t(sv), pos=2)
    jq = j["cache_tm"]._replace(self_k=jnp.asarray(ik).astype(jnp.int8),
                                self_v=jnp.asarray(iv).astype(jnp.int8),
                                self_k_scale=jnp.asarray(sk), self_v_scale=jnp.asarray(sv),
                                pos=jnp.int32(2))
    if reorder:
        for seed in (0, 1):
            r2 = np.random.RandomState(seed)
            sel = np.arange(bk).reshape(BATCH, BEAMS)
            sel = np.stack([g[r2.randint(0, BEAMS, BEAMS)] for g in sel]).reshape(-1)
            base, quant = TDF.reorder_anc(base, t(sel)), TDF.reorder_anc(quant, t(sel))
            jq = JDF.reorder_anc(jq, jnp.asarray(sel, jnp.int32))
        assert not np.array_equal(quant.anc[:3].numpy(), np.asarray(j["cache_tm"].anc[:3]))
        np.testing.assert_array_equal(quant.anc.numpy(), np.asarray(jq.anc))
    tok = np.full((bk, 1), 7, np.int32)
    lb, _ = TDF.decode_step_kernel(dp, tp, base, t(tok), 3, t(enc_bias), tcfg, torch.float32)
    lq, quant = TDF.decode_step_kernel(dp, tp, quant, t(tok), 3, t(enc_bias), tcfg,
                                       torch.float32)
    assert torch.equal(lq, lb)
    np.testing.assert_array_equal(quant.self_k[:, :3].numpy(), ik[:, :3].astype(np.int8))
    assert bool((quant.self_k_scale[:, 3] > 0).all())
    lj, cj = _pal(jcfg, jp, j, enc_bias)(jq, jnp.asarray(tok), jnp.int32(3))
    assert_close(lq, lj)
    np.testing.assert_array_equal(quant.self_k.numpy(), np.asarray(cj.self_k))
    assert_close(quant.self_k_scale, cj.self_k_scale, atol=0, rtol=1e-6)


# --------------------------------------------------------------------------
# five steps through the write path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_five_step_roll_matches_jax(setup, kind):
    """Five greedy steps from zero caches: each step quantizes its rows at
    the write (int8 with their scale rows, fp8 clamped and cast) and the
    next steps read them. Tokens equal JAX's roll at every step, the
    logits stay within 1e-4, and the caches agree."""
    jcfg, tcfg, jp, tp, enc, enc_bias, j = setup
    bk = BATCH * BEAMS
    flag = {"self_kv_int8": True} if kind == "int8" else {"self_kv_fp8": True}
    dp = TDF.build_decode_params(tp, torch.float32)
    ker = ker_cache(tp, enc, tcfg, **flag)
    jc = JDF.build_decode_cache(jp, jnp.asarray(enc), BEAMS, MAX_LEN, jcfg, dtype=jnp.float32,
                                pad_to=16, time_major=True, **flag)
    assert ker.self_k.dtype == (torch.int8 if kind == "int8" else torch.float8_e4m3fn)
    pal = _pal(jcfg, jp, j, enc_bias)
    tok_t = tok_j = np.full((bk, 1), 2, np.int32)
    for pos in range(5):
        lt, ker = TDF.decode_step_kernel(dp, tp, ker, t(tok_t), pos, t(enc_bias), tcfg,
                                         torch.float32)
        lj, jc = pal(jc, jnp.asarray(tok_j), jnp.int32(pos))
        assert_close(lt, lj, msg=f"{kind} step {pos}")
        tok_t = lt.argmax(-1).numpy().astype(np.int32)[:, None]
        tok_j = np.asarray(lj).argmax(-1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(tok_t, tok_j)
    np.testing.assert_array_equal(ker.self_k.float().numpy(),
                                  np.asarray(jc.self_k.astype(jnp.float32)))
    if kind == "int8":
        assert_close(ker.self_v_scale, jc.self_v_scale, atol=0, rtol=1e-6)


# --------------------------------------------------------------------------
# generate_mm end to end, and the cache plan
# --------------------------------------------------------------------------

def _generate_both(monkeypatch, kind, env):
    """Port generate_mm(self_kv=kind, device="cpu") and JAX generate_mm with
    its Pallas decode kernel and the opt-in self cache: tiny config, batch
    4 x beams 2 (one 8-row chunk, which the JAX gate needs), max_length 8.
    -> (port, JAX, port's cache flags, JAX's cache flags)."""
    from vacnic_tpu.data.synthetic import synthetic_batch as j_batch
    from vacnic_tpu.train.train_step import create_mask as j_mask, face_mask_from_emb as j_face
    from vacnic_tpu_torch.data.synthetic import synthetic_batch as t_batch
    from vacnic_tpu_torch.train.train_step import create_mask as t_mask
    from vacnic_tpu_torch.train.train_step import face_mask_from_emb as t_face

    jcfg, tcfg, jargs, _, targs, _ = inputs(False, seed=4)
    jb, tb = j_batch(jcfg, 4, seed=4), t_batch(tcfg, 4, seed=4)
    jargs = [jargs[0], jb["article_ids"], j_mask(jb["article_ids"]), jb["image_cls"]]
    targs = [targs[0], tb["article_ids"], t_mask(tb["article_ids"]), tb["image_cls"]]
    jkw = dict(face_features=jb["face_emb"], face_mask=j_face(jb["face_emb"]),
               name_ids=jb["names_art_ids"], name_mask=j_mask(jb["names_art_ids"]))
    tkw = dict(face_features=tb["face_emb"], face_mask=t_face(tb["face_emb"]),
               name_ids=tb["names_art_ids"], name_mask=t_mask(tb["names_art_ids"]))
    for k, v in {"VACNIC_PALLAS_DECODE": "1", "VACNIC_PALLAS_ENCODER": "1", **env}.items():
        monkeypatch.setenv(k, v)
    seen_t, seen_j = {}, {}

    def spy(real, seen):
        def build(*a, **kw):
            seen.update(kw)
            return real(*a, **kw)
        return build

    monkeypatch.setattr(TDF, "build_decode_cache", spy(TDF.build_decode_cache, seen_t))
    monkeypatch.setattr(JDF, "build_decode_cache", spy(JDF.build_decode_cache, seen_j))
    dec = dict(num_beams=2, max_length=8)
    js, jsc = j_generate(*jargs, jcfg.bart, jcfg.fusion, dataclasses.replace(jcfg.decode, **dec),
                         dtype=jnp.float32, **jkw)
    ts, tsc = TG.generate_mm(*targs, tcfg.bart, tcfg.fusion,
                             dataclasses.replace(tcfg.decode, **dec), device="cpu",
                             self_kv=kind, **tkw)
    return (ts, tsc), (js, jsc), seen_t, seen_j


@pytest.mark.parametrize("kind,env", [
    ("int8", {"VACNIC_SELFKV_INT8": "1", "VACNIC_INT8_SUB8": "1"}),
    ("fp8", {"VACNIC_SELFKV_FP8": "1", "VACNIC_FP8_SUB8": "1"})])
def test_generate_mm_self_kv_matches_jax(monkeypatch, kind, env):
    """generate_mm(self_kv=...) on the CPU builds the quantized self cache
    (a spy on build_decode_cache) and is token-identical to JAX's
    generate_mm on its opt-in self cache, scores within 1e-4; no kernel
    launches."""
    before = K.launch_counts()
    (ts, tsc), (js, jsc), seen_t, seen_j = _generate_both(monkeypatch, kind, env)
    assert K.launch_counts() == before
    assert seen_t[f"self_kv_{kind}"] is True and seen_j[f"self_kv_{kind}"] is True
    assert seen_t["cross_kv_int8"] is False  # unquantized cross K/V on the CPU, as JAX's
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-4, atol=1e-4)
    assert len(np.unique(ts.numpy())) > 4


@pytest.mark.parametrize("batch,beams", [(1, 5), (32, 5)])
@pytest.mark.parametrize("self_kv", [None, "int8", "fp8"])
def test_cache_plan(batch, beams, self_kv):
    """On the card: bf16 stacks and int8 cross K/V at every batch and beam
    count, batch 1 x beam 5 included (by design: the JAX package's
    exception there is a Mosaic chunking rule); on the CPU: the caller's
    dtype and unquantized cross K/V. The self cache is the caller's choice
    on both, and the plan's cache builds at the shape."""
    from vacnic_tpu_torch.core.config import VacnicConfig
    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.models.bart import bart_init

    card = TG.cache_plan(True, self_kv, torch.float32)
    assert card == TG.CachePlan(torch.bfloat16, True, self_kv)
    assert TG.cache_plan(False, self_kv, torch.float32) == TG.CachePlan(torch.float32, False,
                                                                         self_kv)
    cfg = VacnicConfig.tiny().bart
    tp = bart_init(make_generator(0), cfg)
    enc = torch.randn(batch, 8, cfg.d_model, generator=make_generator(1))
    c = TDF.build_decode_cache(tp, enc, beams, 8, cfg, card.dtype, pad_to=16, time_major=True,
                               cross_kv_int8=card.cross_kv_int8,
                               self_kv_int8=card.self_kv == "int8",
                               self_kv_fp8=card.self_kv == "fp8")
    assert c.cross_k.dtype == torch.int8 and tuple(c.cross_k_scale.shape)[:2] == (2, batch)
    want = {None: torch.bfloat16, "int8": torch.int8, "fp8": torch.float8_e4m3fn}[self_kv]
    assert c.self_k.dtype == want and tuple(c.self_k.shape) == (2, 16, batch * beams, 32)
    assert (c.self_k_scale is not None) == (self_kv == "int8")


def test_unknown_self_kv_is_refused():
    """Any other self_kv raises, before any work; so do the two quantized
    caches together and a quantized batch-major cache."""
    from vacnic_tpu_torch.core.config import VacnicConfig
    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.models.bart import bart_init

    for bad in ("bf16", "int4", "INT8", ""):
        with pytest.raises(ValueError, match="self_kv"):
            TG.cache_plan(False, bad, torch.float32)
    cfg = VacnicConfig.tiny()
    ids = torch.ones(1, 4, dtype=torch.int64)
    with pytest.raises(ValueError, match="self_kv"):
        TG.generate_mm({}, ids, ids, torch.zeros(1, 32), cfg.bart, cfg.fusion, cfg.decode,
                       device="cpu", self_kv="int4")
    with pytest.raises(ValueError, match="self_kv"):
        TG.generate_text_bart({}, ids, ids, cfg.bart, cfg.decode, device="cpu", self_kv="e5m2")
    tp = bart_init(make_generator(0), cfg.bart)
    enc = torch.zeros(1, 8, cfg.bart.d_model)
    with pytest.raises(ValueError, match="exclude"):
        TDF.build_decode_cache(tp, enc, 2, 8, cfg.bart, time_major=True, self_kv_int8=True,
                               self_kv_fp8=True)
    with pytest.raises(ValueError, match="time_major"):
        TDF.build_decode_cache(tp, enc, 2, 8, cfg.bart, self_kv_int8=True)
