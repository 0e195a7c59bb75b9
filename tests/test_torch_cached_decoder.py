"""The general KV-cached decoder of the port (models/bart.init_cache,
decoder_fwd(cache=, cache_index=), decoder_layer_fwd(cache=) and
models/layers.mha(cache=)) and decoder_fwd(decoder_attention_mask=)
against the JAX package's (vacnic_tpu/models/bart.py, layers.py), f32 on
the CPU, inputs from numpy seeds and JAX's trees carried across with
weights_io.params_from_jax:

* init_cache: the cross K/V projected once, the self K/V zeros, JAX's
  values and shapes;
* the cached decoder step by step over every position: the hidden states
  and the logits within 1e-5 of JAX's cached decoder, the cache written in
  place equal to the cache JAX returns; equal to the uncached teacher-forced
  decoder at each position (1e-4, tests/test_bart_parity.py's tolerance);
* decoder_attention_mask: JAX's padded causal mask (1e-5);
* the cross K/V read from the cache, never recomputed; remat off with a
  cache, as in JAX; cache= with tp= refused."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from vacnic_tpu.core.config import BartConfig as JBart
from vacnic_tpu.models import bart as JB
from vacnic_tpu_torch.core import tensor_parallel as TP
from vacnic_tpu_torch.core.config import BartConfig
from vacnic_tpu_torch.models import bart as B
from vacnic_tpu_torch.models import layers as L
from vacnic_tpu_torch.models.weights_io import params_from_jax

BSZ, SRC, TGT = 3, 11, 7


def cfgs():
    return JBart.tiny(), BartConfig.tiny()


@pytest.fixture(scope="module")
def setup():
    """JAX's tiny BART (weights widened by numpy draws), its encoder output
    on a padded batch, and the decoder's input ids."""
    jcfg, tcfg = cfgs()
    rng = np.random.RandomState(0)
    jp = JB.bart_init(jax.random.PRNGKey(3), jcfg)
    jp = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*np.shape(x)).astype(np.float32), jp)
    src = rng.randint(4, jcfg.vocab_size, (BSZ, SRC)).astype(np.int32)
    src[0, -3:] = jcfg.pad_token_id
    mask = (src != jcfg.pad_token_id).astype(np.int32)
    tgt = rng.randint(4, jcfg.vocab_size, (BSZ, TGT)).astype(np.int32)
    enc = np.array(JB.encoder_fwd(jp, jnp.asarray(src), jnp.asarray(mask), jcfg))
    return jp, params_from_jax(jp), mask, tgt, enc


def j_steps(jp, mask, tgt, enc, max_len: int, step: int = 1):
    """JAX's cached decoder over the sequence, `step` tokens a call ->
    (hidden states [B, T, d], logits [B, T, V], the last cache)."""
    jcfg = cfgs()[0]
    cache = JB.init_cache(jp, BSZ, max_len, jnp.asarray(enc), jcfg)
    hs, logits = [], []
    for t in range(0, tgt.shape[1], step):
        h, cache = JB.decoder_fwd(jp, jnp.asarray(tgt[:, t:t + step]), jnp.asarray(enc),
                                  jnp.asarray(mask), jcfg, cache=cache,
                                  cache_index=jnp.int32(t))
        hs.append(np.asarray(h))
        logits.append(np.asarray(JB.lm_logits(jp, h)))
    return np.concatenate(hs, 1), np.concatenate(logits, 1), cache


def t_steps(tp, mask, tgt, enc, max_len: int, step: int = 1, **kw):
    tcfg = cfgs()[1]
    enc_t = torch.from_numpy(enc)
    cache = B.init_cache(tp, BSZ, max_len, enc_t, tcfg)
    hs, logits = [], []
    for t in range(0, tgt.shape[1], step):
        h = B.decoder_fwd(tp, torch.from_numpy(tgt[:, t:t + step]), enc_t,
                          torch.from_numpy(mask), tcfg, cache=cache, cache_index=t, **kw)
        hs.append(h)
        logits.append(B.lm_logits(tp, h))
    return torch.cat(hs, 1), torch.cat(logits, 1), cache


def test_init_cache_matches_jax(setup):
    jp, tp, _, _, enc = setup
    jcfg, tcfg = cfgs()
    jc = JB.init_cache(jp, BSZ, 9, jnp.asarray(enc), jcfg)
    tc = B.init_cache(tp, BSZ, 9, torch.from_numpy(enc), tcfg)
    hd = tcfg.d_model // tcfg.decoder_attention_heads
    assert len(tc["layers"]) == tcfg.decoder_layers
    for jl, tl in zip(jc["layers"], tc["layers"]):
        for part, n in (("self", 9), ("cross", SRC)):
            for k in ("k", "v"):
                assert tuple(tl[part][k].shape) == (BSZ, tcfg.decoder_attention_heads, n, hd)
                assert tl[part][k].dtype == torch.float32
                assert_close(tl[part][k], jl[part][k], atol=1e-6, rtol=1e-6, msg=f"{part} {k}")
        assert not tl["self"]["k"].any() and not tl["self"]["v"].any()
    bf = B.init_cache(tp, 2, 5, torch.from_numpy(enc[:2]), tcfg, torch.bfloat16)
    assert bf["layers"][0]["self"]["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("max_len,step", [(TGT, 1), (TGT + 5, 1), (8, 2)],
                         ids=["exact", "longer_cache", "two_tokens_a_call"])
def test_cached_decoder_matches_jax(setup, max_len, step):
    """Every step's hidden states and logits within 1e-5 of JAX's cached
    decoder, and the port's cache, written in place, equal to the one JAX
    returns after the last step (rows past the sequence still zero)."""
    jp, tp, mask, tgt, enc = setup
    tgt = tgt if tgt.shape[1] % step == 0 else tgt[:, :tgt.shape[1] // step * step]
    jh, jl, jc = j_steps(jp, mask, tgt, enc, max_len, step)
    th, tl, tc = t_steps(tp, mask, tgt, enc, max_len, step)
    assert_close(th, jh, atol=1e-5, rtol=1e-5, msg="hidden")
    assert_close(tl, jl, atol=1e-5, rtol=1e-5, msg="logits")
    for jlay, tlay in zip(jc["layers"], tc["layers"]):
        for part in ("self", "cross"):
            for k in ("k", "v"):
                assert_close(tlay[part][k], jlay[part][k], atol=1e-5, rtol=1e-5,
                             msg=f"{part} {k}")
        assert not tlay["self"]["k"][:, :, tgt.shape[1]:].any()


def test_cached_steps_equal_the_teacher_forced_decoder(setup):
    """Step t of the cached decoder is position t of the uncached decoder
    over the whole sequence (the JAX package's
    tests/test_bart_parity.py::test_incremental_decode_matches_full)."""
    _, tp, mask, tgt, enc = setup
    tcfg = cfgs()[1]
    full = B.decoder_fwd(tp, torch.from_numpy(tgt), torch.from_numpy(enc),
                         torch.from_numpy(mask), tcfg)
    _, tl, _ = t_steps(tp, mask, tgt, enc, TGT)
    assert_close(tl, B.lm_logits(tp, full), atol=1e-4, rtol=1e-4)


def test_decoder_attention_mask_matches_jax(setup):
    """The teacher-forced decoder with a padded decoder mask: JAX's causal +
    expand_mask sum (1e-5); the mask moves the output."""
    jp, tp, mask, tgt, enc = setup
    jcfg, tcfg = cfgs()
    dmask = np.ones((BSZ, TGT), np.int32)
    dmask[0, -2:] = 0
    dmask[2, 3:] = 0
    jh, _ = JB.decoder_fwd(jp, jnp.asarray(tgt), jnp.asarray(enc), jnp.asarray(mask), jcfg,
                           decoder_attention_mask=jnp.asarray(dmask))
    args = (tp, torch.from_numpy(tgt), torch.from_numpy(enc), torch.from_numpy(mask), tcfg)
    th = B.decoder_fwd(*args, decoder_attention_mask=torch.from_numpy(dmask))
    assert_close(th, jh, atol=1e-5, rtol=1e-5)
    plain = B.decoder_fwd(*args)
    assert float((plain - th).abs().max()) > 1e-3
    assert torch.equal(B.decoder_fwd(*args, decoder_attention_mask=torch.ones(BSZ, TGT)),
                       plain)


def test_cross_kv_come_from_the_cache(setup):
    """With a cache the cross-attention reads the cache's K/V: an encoder
    output that is zeros at the step gives the same states; and remat is off
    (the cache written by the step either way)."""
    _, tp, mask, tgt, enc = setup
    tcfg = cfgs()[1]
    ids, m = torch.from_numpy(tgt[:, :1]), torch.from_numpy(mask)
    enc_t = torch.from_numpy(enc)
    c1 = B.init_cache(tp, BSZ, 4, enc_t, tcfg)
    c2 = B.init_cache(tp, BSZ, 4, enc_t, tcfg)
    a = B.decoder_fwd(tp, ids, enc_t, m, tcfg, cache=c1, cache_index=0)
    b = B.decoder_fwd(tp, ids, torch.zeros_like(enc_t), m, tcfg, cache=c2, cache_index=0,
                      remat=True)
    assert torch.equal(a, b)
    assert torch.equal(c1["layers"][1]["self"]["k"], c2["layers"][1]["self"]["k"])
    assert c1["layers"][1]["self"]["k"][:, :, 0].abs().sum() > 0
    uncached = B.decoder_fwd(tp, ids, torch.zeros_like(enc_t), m, tcfg)
    assert float((uncached - a).abs().max()) > 1e-3


def test_cached_mha_matches_jax():
    """mha(cache=, cache_index=) alone: a self step at index 2 writes its
    rows there and attends over the cache; a cross step reads the cache."""
    from vacnic_tpu.models import layers as JL

    rng = np.random.RandomState(5)
    d, h, n = 16, 4, 6
    jp = jax.tree_util.tree_map(np.asarray, JL.mha_init(jax.random.PRNGKey(1), d))
    tp = params_from_jax(jp)
    x = rng.randn(2, 1, d).astype(np.float32)
    ck = rng.randn(2, h, n, d // h).astype(np.float32)
    cv = rng.randn(2, h, n, d // h).astype(np.float32)
    mask = np.where(np.arange(n)[None, None, None, :] <= 2, 0.0,
                    np.finfo(np.float32).min).astype(np.float32)
    jout, jc = JL.mha(jp, jnp.asarray(x), mask=jnp.asarray(mask), num_heads=h,
                      cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                      cache_index=jnp.int32(2))
    tc = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    tout = L.mha(tp, torch.from_numpy(x), mask=torch.from_numpy(mask), num_heads=h, cache=tc,
                 cache_index=2)
    assert_close(tout, jout, atol=1e-5, rtol=1e-5)
    assert_close(tc["k"], jc["k"], atol=1e-6, rtol=1e-6)
    assert_close(tc["v"], jc["v"], atol=1e-6, rtol=1e-6)
    kv = rng.randn(2, 5, d).astype(np.float32)
    jout, _ = JL.mha(jp, jnp.asarray(x), key_value=jnp.asarray(kv), num_heads=h,
                     cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)})
    tout = L.mha(tp, torch.from_numpy(x), key_value=torch.from_numpy(kv), num_heads=h,
                 cache={"k": torch.from_numpy(ck), "v": torch.from_numpy(cv)})
    assert_close(tout, jout, atol=1e-5, rtol=1e-5)


def test_cache_with_tp_is_refused(setup):
    """cache= runs on whole weights: with tp= both mha and decoder_fwd
    raise a ValueError (JAX's GSPMD would run it; no path of either package
    needs it)."""
    _, tp, mask, tgt, enc = setup
    tcfg = cfgs()[1]
    shard = TP.ModelShard(0, 2)
    cache = B.init_cache(tp, BSZ, 4, torch.from_numpy(enc), tcfg)
    with pytest.raises(ValueError, match="tp="):
        L.mha(tp["decoder"]["layers"][0]["self_attn"], torch.zeros(BSZ, 1, tcfg.d_model),
              num_heads=tcfg.decoder_attention_heads, tp=shard,
              cache=cache["layers"][0]["self"], cache_index=0)
    with pytest.raises(ValueError, match="tp="):
        B.decoder_fwd(TP.shard_params(tp, shard), torch.from_numpy(tgt[:, :1]),
                      torch.from_numpy(enc), torch.from_numpy(mask),
                      tcfg, cache=cache, cache_index=0, tp=shard)


@pytest.mark.parametrize("t_len,index", [(1, 6), (2, 5)], ids=["one_token_at_end",
                                                                "two_tokens_straddling"])
def test_step_past_the_cache_end_is_refused(t_len, index):
    """A cached self step that would end past L_max: a one-token step at
    cache_index == L_max (the slice write would broadcast into nothing and
    attend without its own K/V) and a two-token step straddling the end.
    Both raise a ValueError naming cache_index, t and L_max before anything
    is written; JAX's dynamic_update_slice clamps the start instead."""
    from vacnic_tpu.models import layers as JL

    rng = np.random.RandomState(6)
    d, h, l_max = 16, 4, 6
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, JL.mha_init(jax.random.PRNGKey(2), d)))
    ck = rng.randn(2, h, l_max, d // h).astype(np.float32)
    cv = rng.randn(2, h, l_max, d // h).astype(np.float32)
    tc = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    x = torch.from_numpy(rng.randn(2, t_len, d).astype(np.float32))
    with pytest.raises(ValueError, match=rf"t={t_len}\b.*cache_index={index}\b.*L_max={l_max}\b"):
        L.mha(tp, x, num_heads=h, cache=tc, cache_index=index)
    assert np.array_equal(tc["k"].numpy(), ck) and np.array_equal(tc["v"].numpy(), cv)
    L.mha(tp, x, num_heads=h, cache=tc, cache_index=l_max - t_len)  # the last step that fits
    assert not np.array_equal(tc["k"].numpy()[:, :, l_max - t_len:], ck[:, :, l_max - t_len:])
