"""The order of work of two CUDA kernels, emulated in PyTorch on the CPU
against the plain twins that define their results and against the JAX
package. Their launch geometry (shared memory, passes, grid) is decided in
csrc/lm_head.cu and csrc/enc_attention.cu alone; the cuda tests hold the
built library to it.

lm_stats_kernel (csrc/lm_head.cu): the logits are the LM head's; a warp
holds 16 vocab rows, and a lane reads one x row's 16 values back whole: their
max, and their exp-sum as a tree (pairs, then fours, then the four sums in
pairs); the warpgroup's
four warps combine in warp order into a 64-row unit's (m, s); the last of a
1024-block's 16 arrivals combines the 16 unit partials in unit order:
m = max m_u, s = sum s_u exp(m_u - m). The partials do not depend on the
pass an x row falls in, so the emulation needs no passes.

enc_cross_attn_kernel (csrc/enc_attention.cu): one (item, head) at a time,
64-row q tiles (zero rows past S), K and V zero-padded to 64 keys; q scaled
and rounded to the inputs' dtype; S = q K^T in f32 with the keys at or past
KV set to -inf before the row max; exp(s - m) times the reciprocal of the
row sum, rounded to the inputs' dtype; P V summed one 16-key step after
another in f32 and rounded once.

Tolerances. lm_stats: the emulation's logits are the twin's (identical);
its m equals the max of its own logits bit for bit; its s is within 2e-6
relative of the twin's (f32 sums in another order over 1024 values); against
JAX in interpret mode the limits of tests/test_torch_lm_stats.py (logits and
m within 1e-4 absolute, f32 sums over d in another order; s within 1e-5
relative). enc_cross: f32 emulation within 1e-6 of the twin (outputs of order
one; the twin divides by the row sum where the kernel multiplies by its
reciprocal); bf16 within two bf16 ulps of the output's largest magnitude
plus 2^-8 of the largest |V| (a probability may round the other way at a
bf16 tie); inside the JAX encoder stack (interpret mode) the limits of
tests/test_torch_encoder.py against the Pallas kernel, 2e-4 absolute and
relative.
"""

import dataclasses
import runpy
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from vacnic_tpu.core.config import VacnicConfig as JC
from vacnic_tpu.kernels import encoder_stack as JES
from vacnic_tpu.kernels import lm_stats as JLS
from vacnic_tpu_torch.core.config import VacnicConfig as TC
from vacnic_tpu_torch.kernels import encoder_stack as ES
from vacnic_tpu_torch.kernels import lm_stats as LS
from vacnic_tpu_torch.kernels import primitives as K

# --------------------------------------------------------------------------
# lm_stats
# --------------------------------------------------------------------------


def lm_stats_tiles(x, w, b):
    """lm_stats_kernel's order of work -> (logits, m, s, unit m, unit s)."""
    y = torch.matmul(x.float(), w.float().t()) + b.float()  # the head's logits
    bk, vp = y.shape
    v4 = y.view(bk, vp // 16, 4, 4)  # [x row, warp slice, four fours of values]
    pm = v4.amax(-1).amax(-1)  # the lane's max: exact in any order
    e = torch.exp(v4 - pm[..., None, None])
    s4 = (e[..., 0] + e[..., 1]) + (e[..., 2] + e[..., 3])
    ps = (s4[..., 0] + s4[..., 1]) + (s4[..., 2] + s4[..., 3])
    wm, ws = pm.view(bk, vp // 64, 4), ps.view(bk, vp // 64, 4)  # a unit's four warps
    um = wm.amax(-1)
    es = ws * torch.exp(wm - um[..., None])
    us = ((es[..., 0] + es[..., 1]) + es[..., 2]) + es[..., 3]
    bm, bs = um.view(bk, -1, 16), us.view(bk, -1, 16)  # a 1024-block's 16 units
    m = bm.amax(-1)
    s = torch.zeros_like(m)
    for k in range(16):  # in unit order
        s = s + bs[..., k] * torch.exp(bm[..., k] - m)
    return y, m, s, um, us


def head(bk: int, d: int, v: int, vp: int, seed: int):
    """bf16-representable x [bk, d], padded w [vp, d] and bias [vp]: pad rows
    zero, pad bias -1e9, so the blocks past v are all pad."""
    rng = np.random.RandomState(seed)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float()

    x = bf16(rng.randn(bk, d))
    w = torch.zeros(vp, d)
    w[:v] = bf16(rng.randn(v, d))
    b = torch.full((vp,), -1e9)
    b[:v] = torch.from_numpy((0.1 * rng.randn(v)).astype(np.float32))
    return x, w, b


@pytest.mark.parametrize("bk", [1, 5, 37, 300])
def test_lm_stats_tiles_match_plain_and_jax(bk):
    """BK 1, 5 and 37 in one pass, 300 in two; a partly padded block and
    three all-pad blocks."""
    x, w, b = head(bk, 128, 5000, 8192, seed=bk)
    y, m, s, um, _ = lm_stats_tiles(x, w, b)
    py, pm, ps = LS.lm_stats_plain(x, w, b)
    assert torch.equal(y, py)
    assert torch.equal(m, y.view(bk, -1, LS.VBLOCK).amax(-1))
    assert torch.equal(m, pm)
    assert float(((s - ps).abs() / ps).max()) <= 2e-6
    assert torch.equal(um.view(bk, -1, 16).amax(-1), m)  # the units' maxima carry it
    assert bool((m[:, 5:] == -1e9).all()) and bool((s[:, 5:] == 1024.0).all())
    jl, jm, js = (np.array(a) for a in JLS.lm_stats(
        jnp.asarray(x.numpy(), jnp.bfloat16), jnp.asarray(w.numpy(), jnp.bfloat16),
        jnp.asarray(b.numpy())[None, :], interpret=True))
    np.testing.assert_allclose(y.numpy(), jl, rtol=0, atol=1e-4)
    np.testing.assert_allclose(m.numpy(), jm, rtol=0, atol=1e-4)
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-5, atol=0)


def test_lm_stats_tiles_all_pad_head():
    """A head whose every block is pad: m = -1e9 and s = 1024 in every
    block, never NaN (the unit and block combines see only equal maxima)."""
    x, w, b = head(7, 64, 0, 2048, seed=1)
    _, m, s, um, us = lm_stats_tiles(x, w, b)
    assert bool((m == -1e9).all()) and bool((s == 1024.0).all())
    assert bool((um == -1e9).all()) and bool((us == 64.0).all())


def test_lm_stats_tiles_stage2_exact():
    """Stage 2 on the emulation's output is exact: the top-C of its logits
    and their logsumexp within 1e-5."""
    x, w, b = head(37, 128, 5000, 8192, seed=9)
    y, m, s, _, _ = lm_stats_tiles(x, w, b)
    cv, ci, lse = LS.lm_stats_topk(y, m, s, 6, 5000)
    tv, ti = LS.top_k(y[:, :5000], 6)
    assert torch.equal(cv, tv) and torch.equal(ci, ti)
    assert float((lse - torch.logsumexp(y[:, :5000], -1)).abs().max()) <= 1e-5


def test_cpu_lm_stats_takes_the_twin_and_counts_nothing():
    x, w, b = head(5, 64, 1500, 2048, seed=4)
    K.reset_launch_counts()
    out = LS.lm_stats(x, w, b)
    assert all(torch.equal(a, r) for a, r in zip(out, LS.lm_stats_plain(x, w, b)))
    assert K.launch_counts()["lm_stats"] == 0
    assert not LS._COUNTERS  # no counters are made for the CPU


# --------------------------------------------------------------------------
# enc_cross_attention
# --------------------------------------------------------------------------


def enc_cross_tiles(q, ck, cv, batch: int, seq: int, heads: int):
    """enc_cross_attn_kernel's order of work, head dim 64."""
    dt = q.dtype
    d = q.shape[1]
    kv = cv.shape[1]
    qt = q.reshape(batch, seq, heads, 64)
    k_pad = torch.zeros(batch, heads, 64, 64)  # [item, head, hd, key]
    k_pad[..., :kv] = ck.float().reshape(batch, heads, 64, kv)
    v_pad = torch.zeros(batch, heads, 64, 64)  # [item, head, key, hd]
    v_pad[:, :, :kv] = cv.float().reshape(batch, kv, heads, 64).transpose(1, 2)
    out = torch.empty(batch, seq, heads, 64, dtype=dt)
    for q0 in range(0, seq, 64):
        rows = min(64, seq - q0)
        tile = torch.zeros(batch, heads, 64, 64)  # rows past S read as zeros
        tile[:, :, :rows] = qt[:, q0:q0 + rows].float().transpose(1, 2)
        tile = (tile * 64 ** -0.5).to(dt).float()
        s = torch.matmul(tile, k_pad)
        s[..., kv:] = float("-inf")
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        p = (e * (1.0 / e.sum(-1, keepdim=True))).to(dt).float()
        o = torch.zeros(batch, heads, 64, 64)
        for c in range(0, 64, 16):  # one wgmma k-step after another
            o = o + torch.matmul(p[..., c:c + 16], v_pad[:, :, c:c + 16])
        out[:, q0:q0 + rows] = o[:, :, :rows].transpose(1, 2).to(dt)
    return out.reshape(batch * seq, d)


def cross_inputs(seed, batch, seq, heads, kv, dt):
    rng = np.random.RandomState(seed)
    d = heads * 64
    q = torch.from_numpy(rng.randn(batch * seq, d).astype(np.float32)).to(dt)
    ck = torch.from_numpy(rng.randn(batch, d, kv).astype(np.float32)).to(dt)
    cv = torch.from_numpy(rng.randn(batch, kv, d).astype(np.float32)).to(dt)
    return q, ck, cv


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kv", [1, 8, 40, 64])
@pytest.mark.parametrize("seq", [1, 63, 64, 130, 512])
def test_enc_cross_tiles_match_plain(seq, kv, dt):
    """One short tile, a tile one row short, whole tiles, a ragged third tile
    and the main path's 512; one key to a full tile of keys."""
    q, ck, cv = cross_inputs(seq * 100 + kv, 3, seq, 2, kv, dt)
    out = enc_cross_tiles(q, ck, cv, 3, seq, 2)
    ref = K.enc_cross_attention_plain(q, ck, cv, 3, seq, 2)
    err = float((out.float() - ref.float()).abs().max())
    if dt == torch.float32:
        assert err <= 1e-6, err
    else:
        top = float(ref.float().abs().max())
        ulp = float(torch.exp2(torch.floor(torch.log2(torch.tensor(top))) - 7))
        assert err <= 2 * ulp + float(cv.float().abs().max()) * 2.0 ** -8, (err, ulp)
    if kv == 1:  # one key: every probability is 1 and the output is V's row
        v_row = cv.float().reshape(3, 1, 2, 64)[:, 0]
        got = out.float().reshape(3, seq, 2, 64)
        assert torch.equal(got, v_row[:, None].expand_as(got).to(dt).float())


def jax_stack_inputs(seed, seq, kv, heads=2, batch=2, ffn=256):
    """One encoder layer at head dim 64: random f32 weights, embedded
    tokens, the cross K/V and a pad bias, as numpy."""
    rng = np.random.RandomState(seed)
    d = heads * 64

    def rn(*shape, std=0.05):
        return (std * rng.randn(*shape)).astype(np.float32)

    def ln():
        return np.stack([1 + rn(1, d, std=0.1)[0], rn(1, d, std=0.1)[0]])[None]

    sp = dict(w_qkv=rn(1, d, 3 * d), b_qkv=rn(1, 1, 3 * d), w_so=rn(1, d, d), b_so=rn(1, 1, d),
              ln_s=ln(), w_cq=rn(1, d, d), b_cq=rn(1, 1, d), w_co=rn(1, d, d),
              b_co=rn(1, 1, d), ln_c=ln(), w_fc1=rn(1, d, ffn), b_fc1=rn(1, 1, ffn),
              w_fc2=rn(1, ffn, d), b_fc2=rn(1, 1, d), ln_f=ln())
    x0 = rng.randn(batch, seq, d).astype(np.float32)
    ck = rng.randn(1, batch, d, kv).astype(np.float32)
    cv = rng.randn(1, batch, kv, d).astype(np.float32)
    keep = np.arange(seq)[None, :] < np.array([[seq], [max(1, seq // 2)]])
    sbias = np.where(keep, 0.0, np.finfo(np.float32).min).astype(np.float32)
    return sp, x0, ck, cv, sbias


@pytest.mark.parametrize("seq,kv", [(1, 1), (63, 8), (64, 40), (130, 64), (130, 40),
                                    (512, 40), (63, 64)])
def test_enc_cross_tiles_inside_the_jax_stack(seq, kv):
    """The port's text stack with its cross-attention replaced by the tile
    emulation, against JAX encoder_text_stack (interpret mode) on the same
    one-layer weights: the emulation is what the Pallas kernel's
    cross-attention computes, inside a whole layer."""
    sp, x0, ck, cv, sbias = jax_stack_inputs(seq * 10 + kv, seq, kv)
    jcfg = dataclasses.replace(JC.tiny().bart, d_model=128, encoder_attention_heads=2,
                               encoder_ffn_dim=256)
    tcfg = dataclasses.replace(TC.tiny().bart, d_model=128, encoder_attention_heads=2,
                               encoder_ffn_dim=256)
    ref = JES.encoder_text_stack(JES.EncStackParams(**{k: jnp.asarray(v) for k, v in sp.items()}),
                                 jnp.asarray(x0), jnp.asarray(ck), jnp.asarray(cv),
                                 jnp.asarray(sbias), jnp.zeros((2, kv)), jcfg, interpret=True)
    tsp = ES.EncStackParams(**{k: torch.from_numpy(v[:, 0] if k.startswith("b_") else v)
                               for k, v in sp.items()})
    ops = SimpleNamespace(**{**vars(ES.PLAIN_OPS), "cross_attn": enc_cross_tiles})
    out = ES._layers(tsp, torch.from_numpy(x0), torch.from_numpy(ck), torch.from_numpy(cv),
                     torch.from_numpy(sbias), tcfg, ops)
    assert_close(out, np.asarray(ref), atol=2e-4, rtol=2e-4)


SMOKE = runpy.run_path(str(Path(__file__).resolve().parents[1] / "chip_smoke.py"),
                       run_name="chip_smoke_imported")


@pytest.mark.parametrize("seq,kv", [(1, 1), (63, 8), (130, 40), (512, 64)])
def test_chip_smoke_emulation_is_the_tiles(seq, kv):
    """chip_smoke.py's order-of-work emulation, which its accuracy phase
    holds the kernel to on the card, is this file's tile emulation bit for
    bit (it leaves out the q tiles, which only group rows)."""
    q, ck, cv = cross_inputs(seq + kv, 3, seq, 2, kv, torch.bfloat16)
    assert torch.equal(SMOKE["enc_cross_tiles"](q, ck, cv, 3, seq, 2),
                       enc_cross_tiles(q, ck, cv, 3, seq, 2))


@pytest.mark.parametrize("seed", [8, 9, 10])
def test_accuracy_reading_tells_a_fault_from_rounding(seed):
    """The accuracy phase's limit of 4 bf16 ulps of the sum's scale: the
    twin and the tile emulation stay under one, a kernel that drops the
    last key lands far beyond it."""
    q, ck, cv = cross_inputs(seed, 2, 130, 2, 40, torch.bfloat16)
    ref, scale = SMOKE["enc_cross_reference"](q, ck, cv, 2, 130, 2)
    ulp = SMOKE["bf16_ulp"](scale)

    def reading(out):
        return float(((out.double() - ref).abs() / ulp).max())

    assert reading(K.enc_cross_attention_plain(q, ck, cv, 2, 130, 2)) <= 1.0
    assert reading(enc_cross_tiles(q, ck, cv, 2, 130, 2)) <= 1.0
    dropped = K.enc_cross_attention_plain(q, ck[..., :-1].contiguous(), cv[:, :-1].contiguous(),
                                          2, 130, 2)
    assert reading(dropped) > 4.0


def test_cpu_enc_cross_takes_the_twin_and_counts_nothing():
    q, ck, cv = cross_inputs(3, 2, 40, 2, 40, torch.float32)
    K.reset_launch_counts()
    out = K.enc_cross_attention(q, ck, cv, 2, 40, 2)
    assert torch.equal(out, K.enc_cross_attention_plain(q, ck, cv, 2, 40, 2))
    assert K.launch_counts()["enc_cross_attention"] == 0
