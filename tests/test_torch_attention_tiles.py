"""The tile algorithms of the two 512-token self-attention kernels
(csrc/enc_attention.cu, csrc/flash_attn.cu), emulated in PyTorch on the CPU
and held against the plain twins that define their results.

Both kernels walk the keys in tiles of 64 and keep only per-row statistics
between tiles:

  enc_self   two passes. Pass 1: running (max, denominator) over the tiles of
             q k^T + bias. Pass 2: the scores again, p = exp(s - m) * (1 / l)
             rounded to the matmul dtype, then p v accumulated in f32.
  flash      one pass, online softmax: the running max starts at
             finfo(f32).min, the f32 output is rescaled by exp(m_old - m_new)
             before each tile's p v (p rounded to the matmul dtype,
             un-normalised), and divided by max(l, 1e-30) at the end.

Tolerances. In f32 the emulations differ from the twins only in the order of
the sums and in 1 / l against a division: 1e-6 absolute on outputs of order
one. In bf16 the output may round the other way, and so may probabilities
(the online loop rounds exp(s - running max), the twin exp(s - final max)):
one bf16 ulp of the output, taken at the tensor's largest magnitude, because
every output is a sum of terms of that scale, also one that is near zero.
"""

import numpy as np
import pytest
import torch

from vacnic_tpu_torch.kernels import flash_attn as FA
from vacnic_tpu_torch.kernels import primitives as K

KT = 64
F32_MIN = float(torch.finfo(torch.float32).min)
BF16_MIN = float(torch.finfo(torch.bfloat16).min)


def enc_self_tiles(qkv, bias, batch, seq, heads):
    """The loop structure of enc_self_attn_kernel."""
    dt = qkv.dtype
    d = qkv.shape[1] // 3
    hd = d // heads
    x = qkv.reshape(batch, seq, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q = (x[0].float() * hd ** -0.5).to(dt).float()
    k, v = x[1].float(), x[2].float()
    bias = bias.float()[:, None, None, :]

    def scores(kt):
        return q @ k[:, :, kt:kt + KT].transpose(-1, -2) + bias[..., kt:kt + KT]

    m = torch.full((batch, heads, seq), F32_MIN)
    l = torch.zeros(batch, heads, seq)
    for kt in range(0, seq, KT):
        s = scores(kt)
        mn = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - mn) + torch.exp(s - mn[..., None]).sum(-1)
        m = mn
    inv = 1.0 / l
    o = torch.zeros(batch, heads, seq, hd)
    for kt in range(0, seq, KT):
        p = (torch.exp(scores(kt) - m[..., None]) * inv[..., None]).to(dt)
        o = o + p.float() @ v[:, :, kt:kt + KT]
    return o.to(dt).permute(0, 2, 1, 3).reshape(batch * seq, d)


def flash_tiles(q, k, v, bias):
    """The loop structure of flash_attn_kernel."""
    dt = q.dtype
    b, h, t, d = q.shape
    s_len = k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    bias = bias.float().expand(b, h, t, s_len)
    m = torch.full((b, h, t), F32_MIN)
    l = torch.zeros(b, h, t)
    o = torch.zeros(b, h, t, d)
    for kt in range(0, s_len, KT):
        s = qf @ kf[:, :, kt:kt + KT].transpose(-1, -2) + bias[..., kt:kt + KT]
        mn = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mn)
        p = torch.exp(s - mn[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p.to(dt).float() @ vf[:, :, kt:kt + KT]
        m = mn
    return (o * (1.0 / torch.clamp(l, min=1e-30))[..., None]).to(dt)


def assert_close(out, ref, dt):
    err = (out.float() - ref.float()).abs()
    if dt == torch.float32:
        assert float(err.max()) <= 1e-6, float(err.max())
        return
    ulp = float(torch.exp2(torch.floor(torch.log2(ref.float().abs().max())) - 7))
    assert float(err.max()) <= ulp, (float(err.max()), ulp)


def pad_bias(rng, batch, seq):
    """Item 0 keeps every key; the others lose a random tail, at the clamped
    finfo(bf16).min the encoder stack hands to the kernel."""
    bias = np.zeros((batch, seq), np.float32)
    for b in range(1, batch):
        bias[b, seq - rng.randint(1, seq // 2):] = BF16_MIN
    return torch.from_numpy(bias)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("seq", [64, 192, 512])
def test_enc_self_two_pass_tiles_match_plain(seq, dt):
    rng = np.random.RandomState(seq)
    batch, heads = 3, 2
    qkv = torch.from_numpy(rng.randn(batch * seq, 3 * heads * 64).astype(np.float32)).to(dt)
    bias = pad_bias(rng, batch, seq)
    out = enc_self_tiles(qkv, bias, batch, seq, heads)
    ref = K.enc_self_attention_plain(qkv, bias, batch, seq, heads)
    assert out.dtype == dt and out.shape == ref.shape
    assert bool(torch.isfinite(out.float()).all())
    assert_close(out, ref, dt)


def test_enc_self_single_kept_key():
    """Every key but the first at the pad bias: the first tile holds the only
    weight, later tiles add exp(-3.4e38) = 0 to the denominator."""
    rng = np.random.RandomState(5)
    batch, seq, heads = 2, 192, 2
    qkv = torch.from_numpy(rng.randn(batch * seq, 3 * heads * 64).astype(np.float32))
    bias = torch.zeros(batch, seq)
    bias[:, 1:] = BF16_MIN
    out = enc_self_tiles(qkv, bias, batch, seq, heads)
    assert_close(out, K.enc_self_attention_plain(qkv, bias, batch, seq, heads), torch.float32)
    v0 = qkv.reshape(batch, seq, 3, heads * 64)[:, 0, 2]  # the kept key's value row
    assert_close(out.reshape(batch, seq, -1), v0[:, None, :].expand(batch, seq, -1),
                 torch.float32)


def flash_inputs(rng, t, s_len, dt, bias_dt):
    b, h = 2, 3
    q = torch.from_numpy((rng.randn(b, h, t, 64) * 0.125).astype(np.float32)).to(dt)
    k = torch.from_numpy(rng.randn(b, h, s_len, 64).astype(np.float32)).to(dt)
    v = torch.from_numpy(rng.randn(b, h, s_len, 64).astype(np.float32)).to(dt)
    bias = torch.zeros(b, 1, t, s_len)
    bias[1, :, :, s_len - 23:] = float(torch.finfo(bias_dt).min)
    return q, k, v, bias.to(bias_dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("seq", [64, 192, 512])
def test_flash_online_tiles_match_plain(seq, dt):
    rng = np.random.RandomState(100 + seq)
    q, k, v, bias = flash_inputs(rng, seq, seq, dt, torch.float32)
    out = flash_tiles(q, k, v, bias)
    ref = FA.flash_attention_plain(q, k, v, bias)
    assert out.dtype == dt and out.shape == ref.shape
    assert_close(out, ref, dt)


@pytest.mark.parametrize("seq", [64, 192, 512])
@pytest.mark.parametrize("masked", ["finite", "-inf"])
def test_flash_tiles_fully_masked_row(seq, masked):
    """A row whose keys all carry finfo.min weighs them uniformly; a row of
    -inf gives zeros. Neither gives NaN, in the tile loop as in the twin."""
    rng = np.random.RandomState(200 + seq)
    q, k, v, bias = flash_inputs(rng, seq, seq, torch.float32, torch.float32)
    bias[0, :, 5, :] = F32_MIN if masked == "finite" else float("-inf")
    out = flash_tiles(q, k, v, bias)
    assert bool(torch.isfinite(out).all())
    assert_close(out, FA.flash_attention_plain(q, k, v, bias), torch.float32)
    want = v[0].mean(dim=1) if masked == "finite" else torch.zeros(3, 64)
    assert_close(out[0, :, 5], want, torch.float32)


def test_flash_tiles_bf16_bias_and_rectangular():
    """T != S and a bf16 bias whose pad value is finfo(bf16).min."""
    rng = np.random.RandomState(7)
    q, k, v, bias = flash_inputs(rng, 128, 320, torch.bfloat16, torch.bfloat16)
    assert_close(flash_tiles(q, k, v, bias), FA.flash_attention_plain(q, k, v, bias),
                 torch.bfloat16)
