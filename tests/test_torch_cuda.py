"""The port's CUDA kernels against their plain twins on the card, at small
shapes the kernels accept (head_dim 64). Marked `cuda`: they skip where
torch sees no CUDA device; on a GPU machine run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(`--noconftest`: the suite's conftest imports jax, which a GPU machine
need not have).

Tolerance: bf16 outputs within 2e-2 + 2e-2 * |plain| (one bf16 rounding),
f32 outputs within 2e-3 + 2e-3 * |plain| (sum order)."""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def close(out, ref, bf16: bool):
    a, r = (2e-2, 2e-2) if bf16 else (2e-3, 2e-3)
    err = (out.float() - ref.float()).abs()
    assert bool((err <= a + r * ref.float().abs()).all()), float(err.max())


def rn(g, *shape, std=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)


def test_gemm_and_layernorm(dev):
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(0)
    for m in (37, 2048):
        a, w, b = rn(g, m, 256, dtype=torch.bfloat16), rn(g, 256, 384, std=0.05,
                                                         dtype=torch.bfloat16), rn(g, 384)
        r = rn(g, m, 384)
        close(K.gemm(a, w, b, act=K.GELU, out_dtype=torch.bfloat16),
              K.gemm_plain(a, w, b, act=K.GELU, out_dtype=torch.bfloat16), True)
        close(K.gemm(a, w, b, residual=r), K.gemm_plain(a, w, b, residual=r), False)
        gb = torch.stack([rn(g, 384), rn(g, 384)]).contiguous()
        y32, y16 = K.layernorm(r, gb, torch.bfloat16)
        p32, p16 = K.layernorm_plain(r, gb, torch.bfloat16)
        close(y32, p32, False)
        close(y16, p16, True)


def test_attention_tile_fragments(dev):
    """One warpgroup, one 64 x 64 x 64 tile (16 x 64 x 64 a warp) through the
    wgmma fragment and descriptor code of csrc/attn_tiles.cuh: s = q k^T and
    o = bf16(s) v against torch.matmul. Non-symmetric random inputs, so a
    K / V transposition mix-up cannot pass. Tolerance: f32 sum order only."""
    from vacnic_tpu_torch.kernels import _build
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16
    q, k, v = rn(g, 64, 64, dtype=bf), rn(g, 64, 64, dtype=bf), rn(g, 64, 64, dtype=bf)
    s_out = torch.empty(64, 64, device=dev)
    o_out = torch.empty(64, 64, device=dev)
    rc = _build.lib().vt_attn_tile_check(K._p(q), K._p(k), K._p(v), K._p(s_out), K._p(o_out),
                                         K._stream())
    assert rc == 0
    torch.cuda.synchronize()
    s_ref = q.float() @ k.float().T
    close(s_out, s_ref, False)
    # the kernel rounds its own scores; hold its output to them
    close(o_out, s_out.to(bf).float() @ v.float(), False)
    close(o_out, s_ref.to(bf).float() @ v.float(), True)


@pytest.mark.parametrize("B,S,H", [(3, 64, 2), (2, 192, 4), (2, 512, 16), (1, 1024, 2)])
def test_enc_self_attention_kernel(dev, B, S, H):
    """Padded keys at finfo(bf16).min (clamped, f32) on every item but the
    first; one, three, eight and sixteen 64-key tiles (S = 1024 is longer
    than the encoder's 512 tokens)."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(10 + S)
    bf = torch.bfloat16
    qkv = rn(g, B * S, 3 * H * 64, dtype=bf)
    bias = torch.zeros(B, S, device=dev)
    for b in range(1, B):
        bias[b, S - 17 * b:] = torch.finfo(bf).min
    before = K.launch_counts()["enc_self_attention"]
    out = K.enc_self_attention(qkv, bias, B, S, H)
    assert K.launch_counts()["enc_self_attention"] == before + 1
    assert bool(torch.isfinite(out.float()).all())
    close(out, K.enc_self_attention_plain(qkv, bias, B, S, H), True)


def test_attention_kernels(dev):
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    B, S, H, KV = 2, 128, 4, 24
    d = H * 64
    qkv = rn(g, B * S, 3 * d, dtype=bf)
    bias = torch.zeros(B, S, device=dev)
    bias[1, 100:] = torch.finfo(bf).min
    close(K.enc_self_attention(qkv, bias, B, S, H),
          K.enc_self_attention_plain(qkv, bias, B, S, H), True)
    # one key kept: every other carries the clamped pad bias
    bias[0, 1:] = torch.finfo(bf).min
    close(K.enc_self_attention(qkv, bias, B, S, H),
          K.enc_self_attention_plain(qkv, bias, B, S, H), True)
    q, ck, cv = rn(g, B * S, d, dtype=bf), rn(g, B, d, KV, dtype=bf), rn(g, B, KV, d, dtype=bf)
    close(K.enc_cross_attention(q, ck, cv, B, S, H),
          K.enc_cross_attention_plain(q, ck, cv, B, S, H), True)

    beams, T = 3, 16
    bk = B * beams
    cache_k, cache_v = rn(g, T, bk, d, dtype=bf), rn(g, T, bk, d, dtype=bf)
    group = torch.arange(bk, device=dev) // beams * beams
    anc = (group[None] + torch.randint(0, beams, (T, bk), device=dev, generator=g)).int()
    qkv_d = rn(g, bk, 3 * d, dtype=bf)
    for pos in (0, 5, T - 1):
        close(K.dec_self_attention(qkv_d, cache_k, cache_v, anc, pos, H),
              K.dec_self_attention_plain(qkv_d, cache_k, cache_v, anc, pos, H), True)
    qd = rn(g, bk, d, dtype=bf)
    ebias = torch.zeros(B, S, device=dev)
    ebias[0, 90:] = torch.finfo(torch.float32).min
    kb, vb = rn(g, B, H, 64, S, dtype=bf), rn(g, B, H, 64, S, dtype=bf)
    close(K.dec_cross_attention(qd, kb, vb, None, None, ebias, H),
          K.dec_cross_attention_plain(qd, kb, vb, None, None, ebias, H), True)
    k8 = torch.randint(-127, 128, (B, H, 64, S), device=dev, generator=g).to(torch.int8)
    v8 = torch.randint(-127, 128, (B, H, 64, S), device=dev, generator=g).to(torch.int8)
    ks, vs = rn(g, B, H, 64).abs() * 0.01 + 1e-3, rn(g, B, H, 64).abs() * 0.01 + 1e-3
    close(K.dec_cross_attention(qd, k8, v8, ks, vs, ebias, H),
          K.dec_cross_attention_plain(qd, k8, v8, ks, vs, ebias, H), True)


def test_launch_counts_move(dev):
    from vacnic_tpu_torch.kernels import primitives as K

    K.reset_launch_counts()
    a = torch.zeros(64, 64, device=dev, dtype=torch.bfloat16)
    K.gemm(a, a)
    K.gemm_plain(a, a)
    assert K.launch_counts()["gemm_bf16"] == 1


def test_lm_stats_kernel(dev):
    """Ragged rows, a partly padded block and three all-pad blocks: the
    logits and statistics against the plain twin; all-pad blocks give
    m = -1e9 and s = 1024; stage 2 is exact on the kernel's own logits."""
    from vacnic_tpu_torch.kernels import lm_stats as LS
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(2)
    bk, d, v, vp = 37, 256, 5000, 8192
    x = rn(g, bk, d, dtype=torch.bfloat16)
    w = torch.zeros(vp, d, device=dev, dtype=torch.bfloat16)
    w[:v] = rn(g, v, d, std=0.1, dtype=torch.bfloat16)
    b = torch.full((vp,), -1e9, device=dev)
    b[:v] = rn(g, v, std=0.1)
    before = K.launch_counts()["lm_stats"]
    logits, m, s = LS.lm_stats(x, w, b)
    assert K.launch_counts()["lm_stats"] == before + 1
    pl, pm, ps = LS.lm_stats_plain(x, w, b)
    close(logits, pl, False)
    close(m, pm, False)
    close(s, ps, False)
    assert bool((m[:, 5:] == -1e9).all()) and bool((s[:, 5:] == 1024.0).all())
    assert torch.equal(m, logits.reshape(bk, -1, LS.VBLOCK).amax(-1))
    cv, ci, lse = LS.lm_stats_topk(logits, m, s, 8, v)
    tv, ti = LS.top_k(logits[:, :v], 8)
    assert torch.equal(cv, tv) and torch.equal(ci, ti)
    assert float((lse - torch.logsumexp(logits[:, :v], -1)).abs().max()) <= 1e-5


@pytest.mark.parametrize("bias_dtype,per_head", [(torch.bfloat16, False), (torch.float32, True)])
def test_flash_attention_kernel(dev, bias_dtype, per_head):
    """Head-split views of [B, T, H*D] projections (read through their
    strides), a [B, 1, T, S] or [B, H, T, S] bias with padded keys and one
    fully masked query row, against the plain twin; attention_core takes the
    kernel for f32 inputs too, in bf16."""
    from vacnic_tpu_torch.kernels import flash_attn as FA
    from vacnic_tpu_torch.kernels import primitives as K
    from vacnic_tpu_torch.models import layers as TL

    g = torch.Generator(device=dev).manual_seed(3)
    B, H, T, S, d = 2, 4, 256, 512, 64
    bf = torch.bfloat16

    def heads(n):
        return rn(g, B, n, H * d, dtype=bf).view(B, n, H, d).permute(0, 2, 1, 3)

    q = (heads(T).float() * d ** -0.5).to(bf)
    k, v = heads(S), heads(S)
    neg = torch.finfo(bias_dtype).min
    bias = torch.zeros(B, H if per_head else 1, T, S, device=dev)
    bias[1, :, :, 300:] = neg
    bias[0, :, 7, :] = neg
    bias = bias.to(bias_dtype)
    before = K.launch_counts()["flash_attention"]
    out = FA.flash_attention(q, k, v, bias)
    assert K.launch_counts()["flash_attention"] == before + 1
    assert out.shape == (B, H, T, d) and bool(torch.isfinite(out.float()).all())
    close(out, FA.flash_attention_plain(q, k, v, bias), True)
    out32 = TL.attention_core(q.float(), k.float(), v.float(), bias)
    assert out32.dtype == torch.float32
    assert K.launch_counts()["flash_attention"] == before + 2
    close(out32, out, True)


@pytest.mark.parametrize("T,S", [(64, 64), (192, 192), (512, 512), (256, 1024)])
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_shapes_and_masked_rows(dev, T, S, bias_dtype):
    """One to sixteen key tiles, T != S, padded keys, one fully masked row
    with a finite bias (uniform weights) and one with -inf (zeros), against
    the plain twin."""
    from vacnic_tpu_torch.kernels import flash_attn as FA

    g = torch.Generator(device=dev).manual_seed(T + S)
    B, H, d = 2, 3, 64
    bf = torch.bfloat16
    q = (rn(g, B, T, H * d).view(B, T, H, d).permute(0, 2, 1, 3) * d ** -0.5).to(bf)
    k = rn(g, B, S, H * d, dtype=bf).view(B, S, H, d).permute(0, 2, 1, 3)
    v = rn(g, B, S, H * d, dtype=bf).view(B, S, H, d).permute(0, 2, 1, 3)
    neg = torch.finfo(bias_dtype).min
    bias = torch.zeros(B, 1, T, S, device=dev)
    bias[1, :, :, S - 23:] = neg
    bias[0, :, 5, :] = neg
    bias[1, :, T - 1, :] = float("-inf")
    bias = bias.to(bias_dtype)
    out = FA.flash_attention(q, k, v, bias)
    assert bool(torch.isfinite(out.float()).all())
    close(out, FA.flash_attention_plain(q, k, v, bias), True)
    close(out[0, :, 5], v[0].float().mean(dim=1), True)   # uniform over the keys
    assert bool((out[1, :, T - 1] == 0).all())


def test_flash_attention_refuses_misaligned_bias(dev):
    from vacnic_tpu_torch.kernels import flash_attn as FA

    x = torch.zeros(1, 1, 64, 64, device=dev, dtype=torch.bfloat16)
    bias = torch.zeros(1, 1, 64, 66, device=dev)[..., 1:65]  # rows start 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention(x, x, x, bias)
