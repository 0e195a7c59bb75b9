"""Port kernels/lm_stats and the stats beam path against the JAX package.

* `lm_stats_plain` (what CPU tensors take) against JAX `lm_stats` in
  interpret mode on the same bf16-representable inputs: logits and the block
  maxima within 1e-4 absolute (f32 sum order over d), the exp-sums within
  1e-5 relative.
* The port's stage 2, `lm_stats_topk`, fed JAX's own stage-1 outputs, equals
  JAX `lm_stats_topk` exactly in values and indices (planted ties
  included), the logsumexp within 3e-5.
* `generate_mm(..., lm_stats=True, device="cpu")` against JAX generate_mm
  with VACNIC_PALLAS_DECODE=1 and VACNIC_LM_STATS=1 on the tiny config with
  vocab 16500: tokens identical, scores within 1e-4; the call raises where
  the stats gate fails.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vacnic_tpu.core.config import VacnicConfig as JC
from vacnic_tpu.data.synthetic import synthetic_batch as j_batch
from vacnic_tpu.infer.generate import generate_mm as j_generate
from vacnic_tpu.kernels import lm_stats as JLS
from vacnic_tpu.models import fusion as JF
from vacnic_tpu.train.train_step import create_mask as j_mask, face_mask_from_emb as j_face
from vacnic_tpu_torch.core.config import VacnicConfig as TC
from vacnic_tpu_torch.data.synthetic import synthetic_batch as t_batch
from vacnic_tpu_torch.infer import decode_fast as TDF
from vacnic_tpu_torch.infer.generate import generate_mm as t_generate
from vacnic_tpu_torch.kernels import lm_stats as TLS
from vacnic_tpu_torch.kernels import primitives as K
from vacnic_tpu_torch.models.weights_io import params_from_jax
from vacnic_tpu_torch.train.train_step import create_mask as t_mask, face_mask_from_emb as t_face

V = 50267


def head(bk: int, d: int, v: int, seed: int):
    """bf16-representable x [bk, d], padded w [vp, d] and bias [vp] (pad -1e9)."""
    rng = np.random.RandomState(seed)
    vp = -(-v // 4096) * 4096

    def bf16(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    x = bf16(rng.randn(bk, d).astype(np.float32)).copy()
    w = np.zeros((vp, d), np.float32)
    w[:v] = bf16(rng.randn(v, d).astype(np.float32))
    b = np.full((vp,), -1e9, np.float32)
    b[:v] = 0.1 * rng.randn(v).astype(np.float32)
    return x, w, b


def jax_stats(x, w, b):
    out = JLS.lm_stats(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                       jnp.asarray(b)[None, :], interpret=True)
    return [np.array(a) for a in out]


@pytest.mark.parametrize("bk", [40, 4])
def test_lm_stats_plain_matches_jax(bk):
    x, w, b = head(bk, 128, V, seed=bk)
    jl, jm, js = jax_stats(x, w, b)
    before = K.launch_counts()
    tl, tm, ts = TLS.lm_stats(*(torch.from_numpy(a) for a in (x, w, b)))
    assert K.launch_counts() == before  # CPU tensors: the plain twin
    assert tl.shape == (bk, w.shape[0]) and tm.shape == (bk, w.shape[0] // TLS.VBLOCK)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=0)
    assert (tm.numpy()[:, -2:] == np.float32(-1e9)).all()  # the all-pad blocks
    assert (ts.numpy()[:, -2:] == 1024.0).all()


@pytest.mark.parametrize("ties", [False, True], ids=["plain", "planted_ties"])
def test_lm_stats_topk_matches_jax(ties):
    x, w, b = head(8 if ties else 24, 128, V, seed=3)
    jl, jm, js = jax_stats(x, w, b)
    if ties:  # equal values far apart, in different vocab blocks
        jl[:, 30000:30008] = jl[:, 100:108]
        r3 = jl.reshape(jl.shape[0], -1, TLS.VBLOCK)
        jm = r3.max(-1)
        js = np.exp(r3 - jm[..., None]).sum(-1).astype(np.float32)
    jv, ji, jlse = (np.asarray(a) for a in JLS.lm_stats_topk(
        jnp.asarray(jl), jnp.asarray(jm), jnp.asarray(js), 16, V))
    tv, ti, tlse = TLS.lm_stats_topk(torch.from_numpy(jl), torch.from_numpy(jm),
                                     torch.from_numpy(js), 16, V)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tlse.numpy(), jlse, rtol=0, atol=3e-5)
    vals, idx = TLS.top_k(torch.from_numpy(jl[:, :V]), 16)
    np.testing.assert_array_equal(ti.numpy(), idx.numpy())
    np.testing.assert_array_equal(tv.numpy(), vals.numpy())


def test_build_lm_head_matches_jax():
    from vacnic_tpu.infer import decode_fast as JDF

    rng = np.random.RandomState(0)
    tree = {"shared": {"weight": rng.randn(5000, 32).astype(np.float32)},
            "final_logits_bias": rng.randn(5000).astype(np.float32)}
    jw, jb = JDF.build_lm_head(jax.tree_util.tree_map(jnp.asarray, tree), jnp.float32)
    tw, tb = TDF.build_lm_head(params_from_jax(tree), torch.float32)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb)[0])
    dp = TDF.DecodeParams(*([None] * 15))
    assert dp.w_lm is None
    built = TDF.ensure_lm_head(dp, params_from_jax(tree), torch.float32)
    assert TDF.ensure_lm_head(built, None).w_lm is built.w_lm  # built once


def stats_inputs(seed: int = 0):
    jcfg, tcfg = JC.tiny(), TC.tiny()
    jcfg = dataclasses.replace(jcfg, bart=dataclasses.replace(jcfg.bart, vocab_size=16500))
    tcfg = dataclasses.replace(tcfg, bart=dataclasses.replace(tcfg.bart, vocab_size=16500))
    rng = np.random.RandomState(seed + 1)
    jp = JF.multimodal_bart_init(jax.random.PRNGKey(seed), jcfg.bart, jcfg.fusion)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.3 * rng.randn(*np.shape(a)).astype(np.float32), jp)
    jb, tb = j_batch(jcfg, 2, seed=seed), t_batch(tcfg, 2, seed=seed)
    jargs = [jp, jb["article_ids"], j_mask(jb["article_ids"]), jb["image_cls"], jcfg.bart,
             jcfg.fusion, dataclasses.replace(jcfg.decode, num_beams=2, max_length=8)]
    targs = [params_from_jax(jp), tb["article_ids"], t_mask(tb["article_ids"]), tb["image_cls"],
             tcfg.bart, tcfg.fusion, dataclasses.replace(tcfg.decode, num_beams=2, max_length=8)]
    jkw = dict(face_features=jb["face_emb"], face_mask=j_face(jb["face_emb"]),
               name_ids=jb["names_art_ids"], name_mask=j_mask(jb["names_art_ids"]))
    tkw = dict(face_features=tb["face_emb"], face_mask=t_face(tb["face_emb"]),
               name_ids=tb["names_art_ids"], name_mask=t_mask(tb["names_art_ids"]))
    return jargs, jkw, targs, tkw


def test_generate_mm_stats_matches_jax(monkeypatch):
    jargs, jkw, targs, tkw = stats_inputs()
    monkeypatch.setenv("VACNIC_PALLAS_DECODE", "1")
    monkeypatch.setenv("VACNIC_LM_STATS", "1")
    js, jsc = j_generate(*jargs, **jkw)
    calls = []
    real = TDF.decode_step_kernel_stats
    monkeypatch.setattr(TDF, "decode_step_kernel_stats",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ts, tsc = t_generate(*targs, device="cpu", lm_stats=True, **tkw)
    assert len(calls) == 7  # every one of the max_length - 1 steps took the stats head
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=0, atol=1e-4)
    plain, plain_sc = t_generate(*targs, device="cpu", **tkw)
    np.testing.assert_array_equal(ts.numpy(), plain.numpy())
    np.testing.assert_allclose(tsc.numpy(), plain_sc.numpy(), rtol=0, atol=1e-4)


def test_generate_mm_stats_gate_raises():
    _, _, targs, tkw = stats_inputs()
    with pytest.raises(ValueError, match="lm_stats"):
        t_generate(*targs, device="cpu", lm_stats=True, cand_mode="full", **tkw)
    small = TC.tiny()  # vocab 128: 4 vocab blocks < the 16-wide shortlist
    with pytest.raises(ValueError, match="lm_stats"):
        t_generate({"shared": {"weight": torch.zeros(128, 32)}}, *targs[1:4], small.bart,
                   small.fusion, small.decode, device="cpu", lm_stats=True,
                   cand_mode="shortlist", **tkw)
