"""Port decode step (infer/decode_fast + kernels/decode_layer, plain twins on
the CPU) against the JAX package at a tiny config in f32: the kernel step
against JAX decode_step_pallas in interpret mode, the reference step
against JAX decode_step, over single steps, several steps with beam
reorders through the ancestry, and int8 cross K/V.

Tolerances: 1e-4 where both sides compute the same f32 recipe; the kernel
step rounds the embedded token to bf16 (as the JAX kernel step does), so
against the XLA step it is held to 3e-2, JAX's own bound for that pair."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from vacnic_tpu.core.config import VacnicConfig as JC
from vacnic_tpu.infer import decode_fast as JDF
from vacnic_tpu.kernels.decode_layer import ChunkPlan
from vacnic_tpu.models import bart as JB
from vacnic_tpu_torch.core.config import VacnicConfig as TC
from vacnic_tpu_torch.infer import decode_fast as TDF
from vacnic_tpu_torch.kernels import decode_layer as DL
from vacnic_tpu_torch.kernels import primitives as K
from vacnic_tpu_torch.models.weights_io import params_from_jax

BATCH, BEAMS, MAX_LEN, S = 4, 2, 14, 16  # cache T pads 14 -> 16
PLAN = ChunkPlan(n_self=2, n_cross=2, n_ffn=2)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = JC.tiny().bart, TC.tiny().bart
    rng = np.random.RandomState(0)
    jp = JB.bart_init(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.randn(*np.shape(x)).astype(np.float32), jp)
    tp = params_from_jax(jp)
    enc = rng.randn(BATCH, S, jcfg.d_model).astype(np.float32)
    bias = np.where(np.arange(S) < S - 3, 0.0, np.finfo(np.float32).min).astype(np.float32)
    enc_bias = np.broadcast_to(bias[None, None, None, :], (BATCH, 1, 1, S)).copy()
    j = dict(dp=JDF.build_decode_params(jp, dtype=jnp.float32),
             cache=JDF.build_decode_cache(jp, jnp.asarray(enc), BEAMS, MAX_LEN, jcfg,
                                          dtype=jnp.float32, pad_to=16),
             cache_tm=JDF.build_decode_cache(jp, jnp.asarray(enc), BEAMS, MAX_LEN, jcfg,
                                             dtype=jnp.float32, pad_to=16, time_major=True))
    return jcfg, tcfg, jp, tp, enc, enc_bias, j


def port_caches(tp, enc, tcfg, **kw):
    ref = TDF.build_decode_cache(tp, t(enc), BEAMS, MAX_LEN, tcfg, torch.float32, pad_to=16, **kw)
    ker = TDF.build_decode_cache(tp, t(enc), BEAMS, MAX_LEN, tcfg, torch.float32, pad_to=16,
                                 time_major=True, **kw)
    return ref, ker


def jax_steps(jcfg, jp, j, enc_bias):
    ref = jax.jit(lambda c, tk, p: JDF.decode_step(j["dp"], jp, c, tk, p, jnp.asarray(enc_bias),
                                                  jcfg, dtype=jnp.float32))
    pal = jax.jit(lambda c, tk, p: JDF.decode_step_pallas(
        j["dp"], jp, c, tk, p, jnp.asarray(enc_bias), jcfg, dtype=jnp.float32, plan=PLAN,
        interpret=True))
    return ref, pal


def test_cache_build_and_quantize(setup):
    jcfg, tcfg, jp, tp, enc, enc_bias, j = setup
    _, ker = port_caches(tp, enc, tcfg)
    assert tuple(ker.self_k.shape) == tuple(j["cache_tm"].self_k.shape)
    assert_close(ker.cross_k, j["cache_tm"].cross_k)
    assert_close(ker.cross_v, j["cache_tm"].cross_v)
    np.testing.assert_array_equal(ker.anc.numpy(), np.asarray(j["cache_tm"].anc))
    qt, st = TDF.quantize_cross_kv(ker.cross_k)
    qj, sj = JDF.quantize_cross_kv(j["cache_tm"].cross_k)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert_close(st, sj, atol=0, rtol=1e-6)
    # round half to even on both sides
    half = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)[None, None, None, None, :]
    np.testing.assert_array_equal(TDF.quantize_cross_kv(t(half))[0].numpy(),
                                  np.asarray(JDF.quantize_cross_kv(jnp.asarray(half))[0]))


def test_single_step(setup):
    jcfg, tcfg, jp, tp, enc, enc_bias, j = setup
    bk = BATCH * BEAMS
    tok = np.full((bk, 1), 5, np.int32)
    jref, jpal = jax_steps(jcfg, jp, j, enc_bias)
    lj_ref, cj_ref = jref(j["cache"], jnp.asarray(tok), jnp.int32(0))
    lj_pal, cj_pal = jpal(j["cache_tm"], jnp.asarray(tok), jnp.int32(0))
    dp = TDF.build_decode_params(tp, torch.float32)
    ref, ker = port_caches(tp, enc, tcfg)
    before = K.launch_counts()
    lt_ker, ker = TDF.decode_step_kernel(dp, tp, ker, t(tok), 0, t(enc_bias), tcfg, torch.float32)
    assert K.launch_counts() == before
    lt_ref, ref = TDF.decode_step(dp, tp, ref, t(tok), 0, t(enc_bias), tcfg, torch.float32)
    assert_close(lt_ker, lj_pal)
    assert_close(lt_ref, lj_ref)
    assert_close(lt_ker, lj_ref, atol=3e-2, rtol=3e-2)
    assert_close(ker.self_k[:, 0], cj_pal.self_k[:, 0])
    assert_close(ref.self_k[:, :, 0], cj_ref.self_k[:, :, 0])
    assert ker.pos == 0


def test_lm_head_rounds_tied_weights_to_dtype(setup, monkeypatch):
    """f32 parameters decoded with dtype=bf16: the step's logits are JAX's
    x_out @ shared.astype(bf16)ᵀ + bias with f32 accumulation
    (vacnic_tpu/infer/decode_fast.py:761-763), not a product with the f32
    tied weights."""
    jcfg, tcfg, jp, tp, enc, enc_bias, j = setup
    bf = torch.bfloat16
    dp = TDF.build_decode_params(tp, bf)
    cache = TDF.build_decode_cache(tp, t(enc), BEAMS, MAX_LEN, tcfg, bf, pad_to=16,
                                   time_major=True)
    seen = {}
    real = DL.decode_stack

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen["x_out"] = out[0]
        return out

    monkeypatch.setattr(DL, "decode_stack", spy)
    tok = torch.full((BATCH * BEAMS, 1), 5)
    logits, _ = TDF.decode_step_kernel(dp, tp, cache, tok, 0, t(enc_bias), tcfg, bf)
    x = seen["x_out"].float()
    ref = x @ tp["shared"]["weight"].to(bf).float().t() + tp["final_logits_bias"]
    assert_close(logits, ref, atol=1e-5, rtol=0)
    f32_head = x @ tp["shared"]["weight"].t() + tp["final_logits_bias"]
    assert float((ref - f32_head).abs().max()) > 1e-4  # the two heads differ here


def test_decode_stack_plain_direct(setup):
    """decode_stack (CPU -> plain twin) at a later position with a
    non-identity ancestry equals decode_stack_plain and returns the step's
    K/V rows."""
    jcfg, tcfg, jp, tp, enc, enc_bias, j = setup
    rng = np.random.RandomState(7)
    dp = TDF.build_decode_params(tp, torch.float32)
    _, ker = port_caches(tp, enc, tcfg)
    ker.self_k.copy_(torch.from_numpy(rng.randn(*ker.self_k.shape).astype(np.float32)))
    ker.self_v.copy_(torch.from_numpy(rng.randn(*ker.self_v.shape).astype(np.float32)))
    group = (np.arange(BATCH * BEAMS) // BEAMS) * BEAMS
    anc = torch.from_numpy((group[None, :] + rng.randint(0, BEAMS, (16, BATCH * BEAMS)))
                           .astype(np.int32))
    x0 = torch.from_numpy(rng.randn(BATCH * BEAMS, 32).astype(np.float32))
    args = (dp, x0, 6, ker.self_k, ker.self_v, anc, ker.cross_k, ker.cross_v,
            t(enc_bias[:, 0, 0]), 4)
    out = DL.decode_stack(*args)
    ref = DL.decode_stack_plain(*args)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert out[1].shape == (2, BATCH * BEAMS, 32)


def test_beam_reorder_ancestry(setup):
    """Random within-group beam selections over 5 steps: the port's kernel
    step with reorder_anc tracks JAX's pallas step with reorder_anc, and the
    port's reference step with a physical reorder tracks JAX's XLA step."""
    jcfg, tcfg, jp, tp, enc, enc_bias, j = setup
    bk = BATCH * BEAMS
    jref, jpal = jax_steps(jcfg, jp, j, enc_bias)
    dp = TDF.build_decode_params(tp, torch.float32)
    ref, ker = port_caches(tp, enc, tcfg)
    cj_ref, cj_pal = j["cache"], j["cache_tm"]
    rng = np.random.RandomState(0)
    tok = np.full((bk, 1), 2, np.int32)
    for pos in range(5):
        lj_ref, cj_ref = jref(cj_ref, jnp.asarray(tok), jnp.int32(pos))
        lj_pal, cj_pal = jpal(cj_pal, jnp.asarray(tok), jnp.int32(pos))
        lt_ref, ref = TDF.decode_step(dp, tp, ref, t(tok), pos, t(enc_bias), tcfg, torch.float32)
        lt_ker, ker = TDF.decode_step_kernel(dp, tp, ker, t(tok), pos, t(enc_bias), tcfg,
                                             torch.float32)
        assert_close(lt_ker, lj_pal, msg=f"kernel step {pos}")
        assert_close(lt_ref, lj_ref, msg=f"reference step {pos}")
        sel = np.arange(bk).reshape(BATCH, BEAMS)
        sel = np.stack([g[rng.randint(0, BEAMS, BEAMS)] for g in sel]).reshape(-1)
        cj_ref = cj_ref._replace(self_k=jnp.take(cj_ref.self_k, jnp.asarray(sel), axis=1),
                                 self_v=jnp.take(cj_ref.self_v, jnp.asarray(sel), axis=1))
        cj_pal = JDF.reorder_anc(cj_pal, jnp.asarray(sel, jnp.int32))
        ref = TDF.reorder_batch_major(ref, t(sel))
        ker = TDF.reorder_anc(ker, t(sel))
        np.testing.assert_array_equal(ker.anc.numpy(), np.asarray(cj_pal.anc))
        tok = np.asarray(lj_ref).argmax(-1).astype(np.int32)[sel][:, None]


def test_crosskv_int8_exact_when_representable(setup):
    """Cross K/V that are exact int8 multiples of their scales: the int8
    kernel step equals the unquantized one (the scale folds are exact), and
    equals JAX's int8 pallas step."""
    jcfg, tcfg, jp, tp, enc, enc_bias, j = setup
    bk = BATCH * BEAMS
    tok = np.full((bk, 1), 5, np.int32)
    rng = np.random.RandomState(1)
    shp = tuple(j["cache_tm"].cross_k.shape)  # [L, B, H, hd, S]
    ints_k = rng.randint(-127, 128, shp).astype(np.float32)
    ints_v = rng.randint(-127, 128, shp).astype(np.float32)
    ints_k[..., 0] = 127.0
    ints_v[..., 0] = 127.0
    ck = ints_k * rng.uniform(0.005, 0.02, shp[:-1]).astype(np.float32)[..., None]
    cv = ints_v * rng.uniform(0.005, 0.02, shp[:-1]).astype(np.float32)[..., None]

    dp = TDF.build_decode_params(tp, torch.float32)
    _, base = port_caches(tp, enc, tcfg)
    base = base._replace(cross_k=t(ck), cross_v=t(cv))
    _, quant = port_caches(tp, enc, tcfg)
    ck8, sk8 = TDF.quantize_cross_kv(t(ck))
    cv8, sv8 = TDF.quantize_cross_kv(t(cv))
    np.testing.assert_array_equal(ck8.numpy().astype(np.int32), ints_k.astype(np.int32))
    quant = quant._replace(cross_k=ck8, cross_v=cv8, cross_k_scale=sk8, cross_v_scale=sv8)
    lb, _ = TDF.decode_step_kernel(dp, tp, base, t(tok), 0, t(enc_bias), tcfg, torch.float32)
    lq, _ = TDF.decode_step_kernel(dp, tp, quant, t(tok), 0, t(enc_bias), tcfg, torch.float32)
    assert_close(lq, lb, atol=2e-3, rtol=2e-3)

    jq = j["cache_tm"]
    qk, qsk = JDF.quantize_cross_kv(jnp.asarray(ck))
    qv, qsv = JDF.quantize_cross_kv(jnp.asarray(cv))
    jq = jq._replace(cross_k=qk, cross_v=qv, cross_k_scale=qsk, cross_v_scale=qsv)
    _, jpal = jax_steps(jcfg, jp, j, enc_bias)
    lj, _ = jpal(jq, jnp.asarray(tok), jnp.int32(0))
    assert_close(lq, lj)


def test_int8_cache_layout():
    """build_decode_cache's int8 options store int8 values with f32 scales of
    the JAX layouts: cross [L, B, H, hd], self [L, T, BK, H] (zero until a
    step writes its row)."""
    tcfg = TC.tiny().bart
    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.models.bart import bart_init

    tp = bart_init(make_generator(0), tcfg)
    enc = torch.randn(2, 8, 32, generator=make_generator(1))
    c = TDF.build_decode_cache(tp, enc, 3, 8, tcfg, torch.bfloat16, pad_to=16, time_major=True,
                               cross_kv_int8=True)
    assert c.cross_k.dtype == torch.int8 and c.cross_k_scale.dtype == torch.float32
    assert tuple(c.cross_k_scale.shape) == (2, 2, 4, 8)
    assert tuple(c.self_k.shape) == (2, 16, 6, 32) and c.self_k.dtype == torch.bfloat16
    assert c.self_k_scale is None and c.self_v_scale is None
    c = TDF.build_decode_cache(tp, enc, 3, 8, tcfg, torch.bfloat16, pad_to=16, time_major=True,
                               self_kv_int8=True)
    assert c.self_k.dtype == c.self_v.dtype == torch.int8 and c.cross_k_scale is None
    for sc in (c.self_k_scale, c.self_v_scale):
        assert sc.dtype == torch.float32 and tuple(sc.shape) == (2, 16, 6, 4)
        assert not sc.any()


def test_wrappers_refuse_other_devices():
    x = torch.empty(4, 64, device="meta")
    with pytest.raises(RuntimeError):
        K.gemm(x, torch.empty(64, 64, device="meta"))
    with pytest.raises(RuntimeError):
        DL.decode_stack(None, x, 0, x, x, x, x, x, x, 4)
