"""Port models/layers and models/bart against the JAX functions on the same
numpy inputs and weights (tiny config, f32, atol = rtol = 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from vacnic_tpu.core.config import BartConfig as JBart
from vacnic_tpu.models import bart as JB
from vacnic_tpu.models import layers as JL
from vacnic_tpu_torch.core.config import BartConfig as TBart
from vacnic_tpu_torch.models import bart as TB
from vacnic_tpu_torch.models import layers as TL
from vacnic_tpu_torch.models.weights_io import params_from_jax

JCFG, TCFG = JBart.tiny(), TBart.tiny()


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    rng = np.random.RandomState(0)
    jp = JB.bart_init(jax.random.PRNGKey(0), JCFG)
    # perturb every leaf so biases and layer norms are not trivial
    jp = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.randn(*np.shape(x)).astype(np.float32), jp)
    return jp, params_from_jax(np_tree(jp))


def t(x):
    return torch.from_numpy(np.array(x))


def test_linear_layernorm_gelu():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 32).astype(np.float32)
    p = {"kernel": rng.randn(32, 16).astype(np.float32), "bias": rng.randn(16).astype(np.float32)}
    ln = {"scale": rng.randn(32).astype(np.float32), "bias": rng.randn(32).astype(np.float32)}
    assert_close(TL.linear({k: t(v) for k, v in p.items()}, t(x)), JL.linear(p, jnp.asarray(x)))
    assert_close(TL.layernorm({k: t(v) for k, v in ln.items()}, t(x)),
                 JL.layernorm(ln, jnp.asarray(x)))
    for name in ("gelu", "gelu_new", "relu", "tanh", "quick_gelu"):
        assert_close(TL.ACT2FN[name](t(x)), JL.ACT2FN[name](jnp.asarray(x)), msg=name)


def test_expand_mask_and_attention_core():
    rng = np.random.RandomState(2)
    mask = (rng.rand(2, 7) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    assert_close(TL.expand_mask(t(mask), 4), JL.expand_mask(jnp.asarray(mask), 4), rtol=0, atol=0)
    q, k, v = (rng.randn(2, 4, 4 if i == 0 else 7, 8).astype(np.float32) for i in range(3))
    m = np.asarray(JL.expand_mask(jnp.asarray(mask), 4))
    assert_close(TL.attention_core(t(q), t(k), t(v), t(m)),
                 JL.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m)))


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_mha(params, cross):
    jp, tp = params
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, 32).astype(np.float32)
    kv = rng.randn(2, 9, 32).astype(np.float32) if cross else None
    mask = np.ones((2, 9 if cross else 6), np.int32)
    mask[1, -2:] = 0
    m = JL.expand_mask(jnp.asarray(mask), 6)
    pj = jp["decoder"]["layers"][0]["encoder_attn" if cross else "self_attn"]
    pt = tp["decoder"]["layers"][0]["encoder_attn" if cross else "self_attn"]
    ref, _ = JL.mha(pj, jnp.asarray(x), None if kv is None else jnp.asarray(kv), m, num_heads=4)
    out = TL.mha(pt, t(x), None if kv is None else t(kv), t(np.asarray(m)), num_heads=4)
    assert_close(out, ref)


def test_embed_encoder_decoder_layers_and_lm_head(params):
    jp, tp = params
    rng = np.random.RandomState(4)
    ids = rng.randint(4, 128, size=(2, 10)).astype(np.int32)
    amask = np.ones((2, 10), np.int32)
    amask[0, 7:] = 0
    enc_j, enc_t = jp["encoder"], tp["encoder"]
    xj = JB.embed_and_norm(jp["shared"], enc_j["embed_positions"], enc_j["layernorm_embedding"],
                           jnp.asarray(ids), JCFG, JL.RngStream(None), jnp.float32)
    xt = TB.embed_and_norm(tp["shared"], enc_t["embed_positions"], enc_t["layernorm_embedding"],
                           t(ids), TCFG, torch.float32)
    assert_close(xt, xj)
    mj = JL.expand_mask(jnp.asarray(amask))
    hj = JB.encoder_layer_fwd(enc_j["layers"][0], xj, mj, JCFG, JL.RngStream(None))
    ht = TB.encoder_layer_fwd(enc_t["layers"][0], xt, t(np.asarray(mj)), TCFG)
    assert_close(ht, hj)

    dec_ids = rng.randint(4, 128, size=(2, 6)).astype(np.int32)
    dj, _ = JB.decoder_fwd(jp, jnp.asarray(dec_ids), hj, jnp.asarray(amask), JCFG)
    dt = TB.decoder_fwd(tp, t(dec_ids), ht, t(amask), TCFG)
    assert_close(dt, dj)
    assert_close(TB.lm_logits(tp, dt), JB.lm_logits(jp, dj))
