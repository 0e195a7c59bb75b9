"""The in-stack LM head (kernels/lm_head, decode_stack with w_lm/b_lm,
decode_step_kernel(lm_head="stack"), generate_mm / generate_text_bart
(lm_head="stack")) against the JAX package's n_lm > 0 path, f32 on the CPU.

* `lm_head_plain` (what CPU tensors take) against numpy at ragged BK:
  within 1e-4 (f32 sum order against a float64 product).
* The port's `decode_stack_plain` with the head against JAX `decode_stack`
  in interpret mode with n_lm 4 and 8 (8 pads the plan's phases) at
  tests/test_decode_kernel.py's shapes (d 128, two layers): logits_p, x_out,
  k_new and v_new within 1e-4.
* `decode_step_kernel(lm_head="stack")` against JAX `decode_step_pallas`
  with n_lm 4 at pos 0 and 2 (a beam reorder between): within 1e-4.
* `generate_mm` and `generate_text_bart` with lm_head="stack" against JAX
  with VACNIC_PALLAS_DECODE=1 VACNIC_PALLAS_ENCODER=1 VACNIC_PLAN_NLM=4:
  tokens identical, scores within 1e-4; no CUDA launch counted.
* JAX's two heads read different x at f32 (the in-stack head its f32
  carried residual, the library head x_out, which is bf16): a case where
  they disagree, and the port's "stack" follows the in-stack one.
* The refusals: lm_head="stack" with lm_stats=True, an unknown value, the
  stats step, a missing padded head.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from test_torch_generate import inputs
from vacnic_tpu.core.config import VacnicConfig as JC
from vacnic_tpu.infer import decode_fast as JDF
from vacnic_tpu.infer import generate as JG
from vacnic_tpu.kernels import decode_layer as JDL
from vacnic_tpu.kernels.decode_layer import ChunkPlan
from vacnic_tpu.models import bart as JB
from vacnic_tpu_torch.core.config import VacnicConfig as TC
from vacnic_tpu_torch.infer import decode_fast as TDF
from vacnic_tpu_torch.infer import generate as TG
from vacnic_tpu_torch.kernels import decode_layer as DL
from vacnic_tpu_torch.kernels import lm_head as LH
from vacnic_tpu_torch.kernels import primitives as K
from vacnic_tpu_torch.models.weights_io import params_from_jax

BATCH, BEAMS, MAX_LEN, S = 4, 2, 14, 128  # tests/test_decode_kernel.py's shapes
PLAN = ChunkPlan(n_self=2, n_cross=2, n_ffn=2)
SMALL = dict(d_model=128, decoder_attention_heads=2, encoder_attention_heads=2,
             decoder_ffn_dim=256, encoder_ffn_dim=256, decoder_layers=2, encoder_layers=2)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("bk", [1, 5, 37])
def test_lm_head_plain_matches_numpy(bk):
    rng = np.random.RandomState(bk)
    d, vp = 64, 256
    x = rng.randn(bk, d).astype(np.float32)
    w = rng.randn(vp, d).astype(np.float32)
    b = rng.randn(vp).astype(np.float32)
    ref = x.astype(np.float64) @ w.astype(np.float64).T + b
    before = K.launch_counts()
    out = LH.lm_head(t(x), t(w), t(b))
    assert K.launch_counts() == before  # CPU tensors: the plain twin
    assert out.shape == (bk, vp) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(out, LH.lm_head_plain(t(x), t(w), t(b)))


@pytest.fixture(scope="module")
def small():
    jcfg = dataclasses.replace(JC.tiny().bart, **SMALL)
    tcfg = dataclasses.replace(TC.tiny().bart, **SMALL)
    rng = np.random.RandomState(0)
    jp = JB.bart_init(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*np.shape(a)).astype(np.float32), jp)
    enc = rng.randn(BATCH, S, jcfg.d_model).astype(np.float32)
    bias = np.where(np.arange(S) < S - 8, 0.0, np.finfo(np.float32).min).astype(np.float32)
    enc_bias = np.broadcast_to(bias[None, None, None, :], (BATCH, 1, 1, S)).copy()
    return jcfg, tcfg, jp, params_from_jax(jp), enc, enc_bias


@pytest.mark.parametrize("n_lm", [4, 8])
def test_decode_stack_head_matches_jax(small, n_lm):
    """One stack call at pos 3 over random cache rows t < 3 and a
    within-group ancestry; n_lm 8 (with n_t 1) pads the plan's phases."""
    jcfg, tcfg, jp, tp, enc, enc_bias = small
    plan = PLAN._replace(n_lm=n_lm) if n_lm == 4 else PLAN._replace(n_t=1, n_lm=n_lm)
    bk, pos, d = BATCH * BEAMS, 3, jcfg.d_model
    jcache = JDF.build_decode_cache(jp, jnp.asarray(enc), BEAMS, MAX_LEN, jcfg,
                                    dtype=jnp.float32, pad_to=16, time_major=True)
    n_layers, t_len = jcache.self_k.shape[:2]
    rng = np.random.RandomState(n_lm)
    sk = rng.randn(n_layers, t_len, bk, d).astype(np.float32)
    sv = rng.randn(n_layers, t_len, bk, d).astype(np.float32)
    sk[:, pos:] = sv[:, pos:] = 0.0  # rows from pos on are unwritten (the TPU kernel counts on it)
    group = (np.arange(bk) // BEAMS) * BEAMS
    anc = (group[None, :] + rng.randint(0, BEAMS, (t_len, bk))).astype(np.int32)
    x0 = rng.randn(bk, d).astype(np.float32)
    jw, jb = JDF.build_lm_head(jp, jnp.float32)
    bkc = bk // plan.n_self
    anc_hot = jax.nn.one_hot(anc - ((np.arange(bk) // bkc) * bkc)[None, :], bkc,
                             dtype=jnp.float32)
    jout = jax.jit(lambda *a: JDL.decode_stack(
        JDF.build_decode_params(jp, dtype=jnp.float32), *a, jcfg, plan=plan, interpret=True))(
        jnp.asarray(x0), jnp.int32(pos), jnp.asarray(sk), jnp.asarray(sv), anc_hot,
        jcache.cross_k, jcache.cross_v, jnp.asarray(enc_bias[:, 0, 0, :]), jw, jb)
    tw, tb = TDF.build_lm_head(tp, torch.float32)
    tcache = TDF.build_decode_cache(tp, t(enc), BEAMS, MAX_LEN, tcfg, torch.float32, pad_to=16,
                                    time_major=True)
    args = (TDF.build_decode_params(tp, torch.float32), t(x0), pos, t(sk), t(sv), t(anc),
            tcache.cross_k, tcache.cross_v, t(enc_bias[:, 0, 0]), jcfg.decoder_attention_heads)
    before = K.launch_counts()
    tout = DL.decode_stack(*args, w_lm=tw, b_lm=tb)
    assert K.launch_counts() == before
    assert len(tout) == 4 and tout[0].shape == (bk, tw.shape[0])
    for name, a, b in zip(("logits_p", "x_out", "k_new", "v_new"), tout, jout):
        assert_close(a, b, msg=name)
    for a, b in zip(tout, DL.decode_stack_plain(*args, w_lm=tw, b_lm=tb)):
        assert torch.equal(a, b)
    for a, b in zip(tout[1:], DL.decode_stack(*args)):  # the head changes nothing else
        assert torch.equal(a, b)
    assert bool((tout[0][:, jcfg.vocab_size:] < -1e8).all())  # the pad columns


def test_decode_step_stack_head_matches_jax(small):
    """Three steps with a beam reorder after each; the logits at pos 0 and
    2 against JAX's n_lm = 4 step, and the cache rows it wrote."""
    jcfg, tcfg, jp, tp, enc, enc_bias = small
    bk = BATCH * BEAMS
    jdp = JDF.build_decode_params(jp, dtype=jnp.float32)
    jstep = jax.jit(lambda c, tk, p: JDF.decode_step_pallas(
        jdp, jp, c, tk, p, jnp.asarray(enc_bias), jcfg, dtype=jnp.float32,
        plan=PLAN._replace(n_lm=4), interpret=True))
    jcache = JDF.build_decode_cache(jp, jnp.asarray(enc), BEAMS, MAX_LEN, jcfg,
                                    dtype=jnp.float32, pad_to=16, time_major=True)
    dp = TDF.ensure_lm_head(TDF.build_decode_params(tp, torch.float32), tp, torch.float32)
    tcache = TDF.build_decode_cache(tp, t(enc), BEAMS, MAX_LEN, tcfg, torch.float32, pad_to=16,
                                    time_major=True)
    rng = np.random.RandomState(5)
    tok = np.full((bk, 1), 5, np.int32)
    for pos in range(3):
        lj, jcache = jstep(jcache, jnp.asarray(tok), jnp.int32(pos))
        lt, tcache = TDF.decode_step_kernel(dp, tp, tcache, t(tok), pos, t(enc_bias), tcfg,
                                            torch.float32, lm_head="stack")
        assert lt.shape == (bk, jcfg.vocab_size)
        if pos in (0, 2):
            assert_close(lt, lj, msg=f"step {pos}")
            assert_close(tcache.self_k[:, pos], jcache.self_k[:, pos], msg=f"k row {pos}")
        sel = np.arange(bk).reshape(BATCH, BEAMS)
        sel = np.stack([g[rng.randint(0, BEAMS, BEAMS)] for g in sel]).reshape(-1)
        jcache = JDF.reorder_anc(jcache, jnp.asarray(sel, jnp.int32))
        tcache = TDF.reorder_anc(tcache, t(sel))
        tok = np.asarray(lj).argmax(-1).astype(np.int32)[sel][:, None]


def _jax_generate(fn, args, kw, env):
    """JAX generation with the environment variables `env` set for the call."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return [np.asarray(a) for a in fn(*args, **kw)]
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


PALLAS = {"VACNIC_PALLAS_DECODE": "1", "VACNIC_PALLAS_ENCODER": "1"}


@functools.lru_cache(maxsize=None)  # two tests read the "full" runs
def mm_runs(mode: str):
    """JAX generate_mm with the in-stack head (VACNIC_PLAN_NLM=4) and with
    the library head, and the port's arguments, at test_torch_generate's
    inputs with max_length 10."""
    jcfg, tcfg, jargs, jkw, targs, tkw = inputs(False)
    jd = dataclasses.replace(jcfg.decode, max_length=10)
    td = dataclasses.replace(tcfg.decode, max_length=10)
    env = dict(PALLAS, VACNIC_BEAM_LOGIC=mode)
    jargs = [*jargs, jcfg.bart, jcfg.fusion, jd]
    stack = _jax_generate(JG.generate_mm, jargs, jkw, dict(env, VACNIC_PLAN_NLM="4"))
    library = _jax_generate(JG.generate_mm, jargs, jkw, env)
    return stack, library, [*targs, tcfg.bart, tcfg.fusion, td], tkw


@pytest.mark.parametrize("mode", ["full", "shortlist"])
def test_generate_mm_stack_head_matches_jax(mode):
    (js, jsc), _, targs, tkw = mm_runs(mode)
    calls = []
    real = TDF.decode_step_kernel

    def spy(*a, **kw):
        calls.append(kw.get("lm_head"))
        return real(*a, **kw)

    TDF.decode_step_kernel = spy
    before = K.launch_counts()
    try:
        ts, tsc = TG.generate_mm(*targs, device="cpu", cand_mode=mode, lm_head="stack", **tkw)
    finally:
        TDF.decode_step_kernel = real
    assert K.launch_counts() == before  # no CUDA launch on the CPU
    assert calls == ["stack"] * 9  # every one of the max_length - 1 steps
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_allclose(tsc.numpy(), jsc, rtol=0, atol=1e-4)
    assert len(np.unique(ts.numpy())) > 4


def test_stack_head_follows_jax_in_stack_head():
    """At f32 JAX's heads disagree here (the library head multiplies x_out,
    rounded to bf16; the in-stack head the f32 residual): the port's two
    heads follow JAX's two."""
    (js, jsc), (jl, jlsc), targs, tkw = mm_runs("full")
    assert not np.array_equal(js, jl) or float(np.abs(jsc - jlsc).max()) > 1e-3
    ts, tsc = TG.generate_mm(*targs, device="cpu", cand_mode="full", lm_head="stack", **tkw)
    tl, tlsc = TG.generate_mm(*targs, device="cpu", cand_mode="full", **tkw)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_allclose(tsc.numpy(), jsc, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_allclose(tlsc.numpy(), jlsc, rtol=0, atol=1e-4)


def test_generate_text_bart_stack_head_matches_jax():
    jcfg, tcfg = JC.tiny().bart, TC.tiny().bart
    rng = np.random.RandomState(0)
    jp = JB.bart_init(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.3 * rng.randn(*np.shape(a)).astype(np.float32), jp)
    ids = rng.randint(4, jcfg.vocab_size, (3, 16)).astype(np.int32)
    ids[:, 0] = jcfg.bos_token_id
    mask = np.ones((3, 16), np.int32)
    for i, n in enumerate((16, 11, 7)):
        ids[i, n - 1] = jcfg.eos_token_id
        ids[i, n:] = jcfg.pad_token_id
        mask[i, n:] = 0
    jd = dataclasses.replace(JC.tiny().decode, max_length=10)
    td = dataclasses.replace(TC.tiny().decode, max_length=10)
    js, jsc = _jax_generate(JG.generate_text_bart, [jp, jnp.asarray(ids), jnp.asarray(mask),
                                                    jcfg, jd], {},
                            {"VACNIC_PALLAS_DECODE": "1", "VACNIC_PLAN_NLM": "4"})
    before = K.launch_counts()
    ts, tsc = TG.generate_text_bart(params_from_jax(jp), ids, mask, tcfg, td, device="cpu",
                                    lm_head="stack")
    assert K.launch_counts() == before
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_allclose(tsc.numpy(), jsc, rtol=0, atol=1e-4)
    assert len(np.unique(ts.numpy())) > 4


def test_lm_head_refusals(small):
    _, tcfg, _, _, targs, tkw = inputs(False)
    targs = [*targs, tcfg.bart, tcfg.fusion, tcfg.decode]
    with pytest.raises(ValueError, match="exclude each other"):
        TG.generate_mm(*targs, device="cpu", lm_stats=True, cand_mode="shortlist",
                       lm_head="stack", **tkw)
    with pytest.raises(ValueError, match="lm_head must be one of"):
        TG.generate_mm(*targs, device="cpu", lm_head="xla", **tkw)
    with pytest.raises(ValueError, match="lm_head must be one of"):
        TG.generate_text_bart(targs[0], *targs[1:3], targs[4], targs[6], device="cpu",
                              lm_head="in_kernel")
    jcfg, tcfg, jp, tp, enc, enc_bias = small
    dp = TDF.build_decode_params(tp, torch.float32)
    cache = TDF.build_decode_cache(tp, t(enc), BEAMS, MAX_LEN, tcfg, torch.float32, pad_to=16,
                                   time_major=True)
    tok = torch.full((BATCH * BEAMS, 1), 5)
    step = (tp, cache, tok, 0, t(enc_bias), tcfg, torch.float32)
    with pytest.raises(ValueError, match="ensure_lm_head"):
        TDF.decode_step_kernel(dp, *step, lm_head="stack")
    with pytest.raises(ValueError, match="lm_head must be one of"):
        TDF.decode_step_kernel(dp, *step, lm_head="pallas")
    with pytest.raises(ValueError, match="stats head replaces"):
        TDF.decode_step_kernel_stats(TDF.ensure_lm_head(dp, tp, torch.float32), *step,
                                     lm_head="stack")
    w, b = TDF.build_lm_head(tp, torch.float32)
    with pytest.raises(ValueError, match="travel together"):
        DL.decode_stack(dp, torch.zeros(BATCH * BEAMS, jcfg.d_model), 0, cache.self_k,
                        cache.self_v, cache.anc, cache.cross_k, cache.cross_v,
                        t(enc_bias[:, 0, 0]), 2, w_lm=w)
