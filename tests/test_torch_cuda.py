"""The port's CUDA kernels against their plain twins on the card, at small
shapes the kernels accept (head_dim 64). Marked `cuda`: they skip where
torch sees no CUDA device; on a GPU machine run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(`--noconftest`: the suite's conftest imports jax, which a GPU machine
need not have).

Tolerance: bf16 outputs within 2e-2 + 2e-2 * |plain| (one bf16 rounding),
f32 outputs within 2e-3 + 2e-3 * |plain| (sum order)."""

import ctypes

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


GEMM_EPILOGUES = [(False, False, None, torch.float32), (True, False, None, torch.bfloat16),
                  (True, True, None, torch.float32), (True, False, "gelu", torch.bfloat16),
                  (True, True, "gelu", torch.float32), (False, True, "gelu", torch.bfloat16)]


@pytest.mark.parametrize("m", [1, 37, 160, 161, 256, 257, 1280, 2048 + 37])
@pytest.mark.parametrize("k,n", [(256, 384), (32, 64), (96, 192), (1024, 1024)])
def test_gemm_shape_sweep(dev, m, k, n):
    """Ragged rows through the three kernels (M <= 256: split-K cluster; up
    to GEMM_MID_M_MAX: 128-row TMA tiles with split-K; above: 256 x 128 TMA
    tiles), a k tail of 32, a last column tile half empty, every epilogue
    kind, against the twin; the launch counts by kernel move with the plan."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(m * 7 + n)
    a, w = rn(g, m, k, dtype=torch.bfloat16), rn(g, k, n, std=0.05, dtype=torch.bfloat16)
    b, r = rn(g, n), rn(g, m, n)
    variant = K.gemm_plan(m, n, k).variant
    assert variant == ("small_m" if m <= 256 else "mid_m" if m <= K.GEMM_MID_M_MAX
                       else "large_m")
    for has_b, has_r, act, out in GEMM_EPILOGUES:
        before = K.gemm_variant_counts()[variant]
        got = K.gemm(a, w, b if has_b else None, r if has_r else None, act, out)
        assert K.gemm_variant_counts()[variant] == before + 1
        assert got.dtype == out and got.shape == (m, n)
        close(got, K.gemm_plain(a, w, b if has_b else None, r if has_r else None, act, out),
              out == torch.bfloat16)


@pytest.mark.parametrize("n,split", [(133 * 64, 1), (4096, 2), (1024, 4)])
def test_gemm_small_m_splits_are_repeatable(dev, n, split):
    """Every split of the small-M kernel, each through a decode-sized shape
    whose plan picks it: right, and bit-identical from call to call (the
    partial sums are combined in rank order, without atomics)."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(11)
    m, k = 160, 1024
    assert K.gemm_plan(m, n, k) == K.GemmPlan("small_m", split)
    a, w = rn(g, m, k, dtype=torch.bfloat16), rn(g, k, n, std=0.05, dtype=torch.bfloat16)
    b, r = rn(g, n), rn(g, m, n)
    first = K.gemm(a, w, b, r, K.GELU, torch.float32)
    close(first, K.gemm_plain(a, w, b, r, K.GELU, torch.float32), False)
    for _ in range(3):
        assert torch.equal(first, K.gemm(a, w, b, r, K.GELU, torch.float32))


def test_gemm_large_m_tiles_and_clusters(dev):
    """The smem-descriptor wgmma forms and the TMA multicast of the large-M
    kernel on one and on several tiles: non-symmetric random A and W (a
    transposed operand cannot pass), an odd number of column tiles (the grid
    is padded to whole clusters), f32 out against torch.matmul (sum order
    only). These shapes now take mid_m, so the large-M plan is launched
    through the private entry; the last shape is the plan's own large_m."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(5)
    large = K.GemmPlan("large_m")
    for m, k, n in ((257, 64, 128), (256 * 3 + 5, 320, 384), (700, 1024, 1024),
                    (K.GEMM_MID_M_MAX + 1, 320, 384)):
        a, w = rn(g, m, k, dtype=torch.bfloat16), rn(g, k, n, std=0.05, dtype=torch.bfloat16)
        before = K.gemm_variant_counts()["large_m"]
        close(K._gemm_planned(large, a, w), a.float() @ w.float(), False)
        b, r = rn(g, n), rn(g, m, n)
        close(K._gemm_planned(large, a, w, b, r, K.GELU, torch.bfloat16),
              K.gemm_plain(a, w, b, r, K.GELU, torch.bfloat16), True)
        assert K.gemm_variant_counts()["large_m"] == before + 2
    assert K.gemm_plan(K.GEMM_MID_M_MAX + 1, 384, 320) == large


MID_PLANS = [(bn, split) for bn in (64, 128) for split in (1, 2, 4)]


@pytest.mark.parametrize("bn,split", MID_PLANS)
@pytest.mark.parametrize("m", [257, 320, 511, 1280, "max", "max+1"])
def test_gemm_mid_m_every_plan(dev, m, bn, split):
    """mid_m at every tile width and split, through the private entry, at
    ragged rows on each side of its range (257: a warpgroup with one live
    row; 320: a dead warpgroup; GEMM_MID_M_MAX + 1 past it), K 1056 (17 k
    tiles, the last a tail of 32: uneven slabs) and N 1088 (a half-empty
    last 128-column tile), every epilogue kind, against the twin."""
    from vacnic_tpu_torch.kernels import primitives as K

    m = {"max": K.GEMM_MID_M_MAX, "max+1": K.GEMM_MID_M_MAX + 1}.get(m, m)
    k, n = 1056, 1088
    g = torch.Generator(device=dev).manual_seed(m + 7 * split + bn)
    a, w = rn(g, m, k, dtype=torch.bfloat16), rn(g, k, n, std=0.05, dtype=torch.bfloat16)
    b, r = rn(g, n), rn(g, m, n)
    plan = K.GemmPlan("mid_m", split, bn)
    for has_b, has_r, act, out in GEMM_EPILOGUES:
        before = K.gemm_variant_counts()["mid_m"]
        got = K._gemm_planned(plan, a, w, b if has_b else None, r if has_r else None, act, out)
        assert K.gemm_variant_counts()["mid_m"] == before + 1
        assert got.dtype == out and got.shape == (m, n)
        close(got, K.gemm_plain(a, w, b if has_b else None, r if has_r else None, act, out),
              out == torch.bfloat16)


@pytest.mark.parametrize("m,n,k", [(320, 1024, 1024), (640, 1024, 4096), (1280, 3072, 1024),
                                   (1024, 4096, 1024)])
def test_gemm_mid_m_plans_are_repeatable(dev, m, n, k):
    """The decoder's and the encoder's shapes as gemm_plan cuts them, and
    every split at the first: bit-identical from call to call (the partial
    tiles are summed in rank order, without atomics)."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(13)
    a, w = rn(g, m, k, dtype=torch.bfloat16), rn(g, k, n, std=0.05, dtype=torch.bfloat16)
    b, r = rn(g, n), rn(g, m, n)
    plans = [K.gemm_plan(m, n, k)]
    assert plans[0].variant == "mid_m"
    if m == 320:
        plans += [K.GemmPlan("mid_m", split, bn) for bn, split in MID_PLANS]
    for plan in plans:
        first = K._gemm_planned(plan, a, w, b, r, K.GELU, torch.float32)
        close(first, K.gemm_plain(a, w, b, r, K.GELU, torch.float32), False)
        for _ in range(3):
            assert torch.equal(first, K._gemm_planned(plan, a, w, b, r, K.GELU, torch.float32))
    assert torch.equal(K.gemm(a, w, b, r, K.GELU, torch.float32),
                       K._gemm_planned(plans[0], a, w, b, r, K.GELU, torch.float32))


@pytest.mark.parametrize("m", [1, 64, 65, 160, 256, 257, 320, 1280, 2048, 2049, 16384])
def test_gemm_shared_memory_fits_a_block(dev, m):
    """The ring (and, for the TMA kernels, its barriers) of the kernel a
    shape takes, as the built library states it, fits the 227 KB a block can
    have and holds at least three slots of (rows + columns) x 64 k in bf16;
    mid_m's, at both tile widths, lets two blocks share an SM's 228 KB."""
    from vacnic_tpu_torch.kernels import _build
    from vacnic_tpu_torch.kernels import primitives as K

    plan = K.gemm_plan(m, 1024, 1024)
    smem = K.gemm_smem_bytes(m, 1024, 1024)
    rows, cols = {"large_m": (256, 128), "mid_m": (128, plan.bn),
                  "small_m": (64 * -(-m // 64), 64)}[plan.variant]
    assert 3 * (rows + cols) * 64 * 2 <= smem <= 232448
    for bn in (64, 128):
        mid = _build.lib().vt_gemm_smem_bytes(3, m, bn)
        assert 3 * (128 + bn) * 64 * 2 <= mid and 2 * (mid + 1024) <= 233472
    assert _build.lib().vt_gemm_smem_bytes(3, m, 96) == 0


def test_gemm_refuses_other_shapes(dev):
    from vacnic_tpu_torch.kernels import primitives as K

    a = torch.zeros(300, 48, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(48, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K % 32"):
        K.gemm(a, w)


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


@pytest.mark.parametrize("d", [32, 384, 768, 1022, 1024, 1030, 2048])
@pytest.mark.parametrize("rows", [1, 37, 160, 6000])
def test_layernorm_shape_sweep(dev, rows, d):
    """Both kernels (the warp kernel to d = 1024, a block a row past it), a
    scalar tail (1022, 1030), one row to more than a resident wave of warps:
    both outputs against the twin, bit-identical over two calls, and the
    launch counted under the plan's kernel."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(rows + d)
    x = rn(g, rows, d, std=2.0) + 0.5
    gb = torch.stack([1 + rn(g, d, std=0.1), rn(g, d, std=0.1)]).contiguous()
    variant = K.layernorm_plan(rows, d).variant
    before = K.layernorm_variant_counts()[variant]
    y32, y16 = K.layernorm(x, gb, torch.bfloat16)
    assert K.layernorm_variant_counts()[variant] == before + 1
    p32, p16 = K.layernorm_plain(x, gb, torch.bfloat16)
    close(y32, p32, False)
    close(y16, p16, True)
    a32, a16 = K.layernorm(x, gb, torch.bfloat16)
    assert torch.equal(a32, y32) and torch.equal(a16, y16)


@pytest.mark.parametrize("d", [1024, 1030])
def test_layernorm_in_place(dev, d):
    """y32 == x is legal in both kernels: a warp (a block) reads its row
    before it writes it."""
    from vacnic_tpu_torch.kernels import _build
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(d)
    x = rn(g, 300, d)
    gb = torch.stack([1 + rn(g, d, std=0.1), rn(g, d, std=0.1)]).contiguous()
    p32, p16 = K.layernorm_plain(x, gb, torch.bfloat16)
    y16 = torch.empty(300, d, device=dev, dtype=torch.bfloat16)
    plan = K.layernorm_plan(300, d)
    rc = _build.lib().vt_layernorm(K._p(x), K._p(gb), K._p(x), K._p(y16), 300, d,
                                   ctypes.c_float(1e-5), K._LN_VARIANT_ID[plan.variant],
                                   plan.slots, K._stream())
    assert rc == 0
    torch.cuda.synchronize()
    close(x, p32, False)
    close(y16, p16, True)


def cross_case(g, items, heads, beams, s_len, kind):
    """Item 0 has every key masked (uniform weights), item 1 half of them."""
    keep = torch.full((items, 1), s_len, device="cuda")
    keep[0], keep[1] = 0, (s_len + 1) // 2
    bias = torch.where(torch.arange(s_len, device="cuda")[None, :] < keep, 0.0,
                       torch.finfo(torch.float32).min).float().contiguous()
    q = rn(g, items * beams, heads * 64, dtype=torch.bfloat16)
    shape = (items, heads, 64, s_len)
    if kind == "int8":
        k, v = (torch.randint(-127, 128, shape, device="cuda", generator=g).to(torch.int8)
                for _ in range(2))
        ks, vs = (rn(g, items, heads, 64).abs() * 0.01 + 1e-3 for _ in range(2))
    else:
        k, v = rn(g, *shape, dtype=torch.bfloat16), rn(g, *shape, dtype=torch.bfloat16)
        ks = vs = None
    return q, k, v, ks, vs, bias


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("s_len", [1, 40, 130, 512])
@pytest.mark.parametrize("beams", [1, 5, 8])
def test_dec_cross_attention_sweep(dev, beams, s_len, kind):
    """One tile, ragged last tiles (40, 130), the main path's eight, beams 1,
    5, 8, int8 and bf16, a fully masked item: against the twin, and
    bit-identical over two calls (the sums run in a fixed order)."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(beams * 1000 + s_len)
    args = cross_case(g, 3, 4, beams, s_len, kind)
    before = K.launch_counts()["dec_cross_attention"]
    out = K.dec_cross_attention(*args, 4)
    assert K.launch_counts()["dec_cross_attention"] == before + 1
    assert bool(torch.isfinite(out.float()).all())
    close(out, K.dec_cross_attention_plain(*args, 4), True)
    assert torch.equal(out, K.dec_cross_attention(*args, 4))


@pytest.mark.parametrize("beams,s_len,kind", [(1, 12224, "bf16"), (1, 12224, "int8"),
                                             (8, 1472, "bf16"), (4, 3008, "int8")])
def test_dec_cross_attention_long_s(dev, beams, s_len, kind):
    """The longest S the kernel before took (12288 / beams - 64): scores and
    probabilities of all S in one block's shared memory, repeatable."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(s_len)
    args = cross_case(g, 2, 2, beams, s_len, kind)
    out = K.dec_cross_attention(*args, 2)
    close(out, K.dec_cross_attention_plain(*args, 2), True)
    assert torch.equal(out, K.dec_cross_attention(*args, 2))


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("items,heads,s_len", [(3, 4, 130), (3, 4, 512), (32, 16, 512)])
@pytest.mark.parametrize("beams", [9, 11, 16, 17])
def test_dec_cross_attention_wide_beams(dev, beams, items, heads, s_len, kind):
    """Past 8 beams the kernel runs in groups of 8 (a ragged last group at 9,
    11 and 17), counted by beams: against the twin, repeatable, and each
    group's rows bit-identical to the kernel of that many beams on those q
    rows alone (a beam's sums do not depend on the beams beside it)."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(beams * 7 + s_len + items)
    q, *rest = cross_case(g, items, heads, beams, s_len, kind)
    before = K.dec_cross_beam_counts().get(beams, 0)
    out = K.dec_cross_attention(q, *rest, heads)
    assert K.dec_cross_beam_counts()[beams] == before + 1
    assert bool(torch.isfinite(out.float()).all())
    close(out, K.dec_cross_attention_plain(q, *rest, heads), True)
    assert torch.equal(out, K.dec_cross_attention(q, *rest, heads))
    q3, o3 = q.view(items, beams, -1), out.view(items, beams, -1)
    for lo in range(0, beams, 8):
        n = min(8, beams - lo)
        alone = K.dec_cross_attention(q3[:, lo:lo + n].reshape(items * n, -1).contiguous(),
                                      *rest, heads)
        assert torch.equal(o3[:, lo:lo + n].reshape(items * n, -1), alone), (lo, n)


@pytest.mark.parametrize("kind,s_len", [("bf16", 1472), ("int8", 3008)])
def test_dec_cross_attention_wide_beams_long_s(dev, kind, s_len):
    """16 beams keep the limit on S of 8 (a block holds 8 beams): S 1472 in
    bf16 and 3008 in int8 run, and one tile more is refused."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(s_len)
    args = cross_case(g, 2, 2, 16, s_len, kind)
    out = K.dec_cross_attention(*args, 2)
    close(out, K.dec_cross_attention_plain(*args, 2), True)
    s_next = s_len + 64
    while K.dec_cross_smem_bytes(8, s_next, 2 if kind == "bf16" else 1) <= K.SMEM_MAX:
        s_next += 64
    with pytest.raises(ValueError, match="shared memory"):
        K.dec_cross_attention(*cross_case(g, 2, 2, 16, s_next, kind), 2)


@pytest.mark.parametrize("beams,variant", [(5, "beams"), (11, "grouped"), (11, "wide"),
                                           (16, "wide"), (24, "wide"), (16, "grouped")])
def test_dec_cross_launcher_takes_only_its_plan(dev, beams, variant):
    """The launcher makes its grid of the plan's blocks and its shared
    memory of the plan's bytes, for the plan's variant: the plan itself
    launches; a block more or less, other bytes or another variant are
    refused before any launch."""
    from vacnic_tpu_torch.kernels import _build
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(beams)
    q, k, v, ks, vs, bias = cross_case(g, 2, 2, beams, 130, "int8")
    out = torch.empty_like(q)
    plan = K.dec_cross_variant_plan(variant, beams, 130, 1)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launch(variant, groups, smem):
        return _build.lib().vt_dec_cross_attention(
            *(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, ks, vs, bias, out)), 2, beams,
            K.DEC_CROSS_VARIANTS.index(variant), groups, smem, 2, 130, 1,
            ctypes.c_float(64 ** -0.5), stream)

    assert launch(plan.variant, plan.groups, plan.smem) == 0
    torch.cuda.synchronize()
    close(out, K.dec_cross_attention_plain(q, k, v, ks, vs, bias, 2), True)
    other = "grouped" if plan.variant == "wide" else "wide"
    for variant, groups, smem in ((plan.variant, plan.groups + 1, plan.smem),
                                  (plan.variant, plan.groups - 1, plan.smem),
                                  (plan.variant, plan.groups, plan.smem + 16),
                                  (other, plan.groups, plan.smem)):
        assert launch(variant, groups, smem) != 0, (variant, groups, smem)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("items,s_len", [(3, 130), (8, 512)])
@pytest.mark.parametrize("beams", [9, 11, 16, 17, 24])
def test_dec_cross_wide_matches_grouped(dev, beams, items, s_len, kind):
    """The wide block and the groups of 8 through explicit plans at one
    shape: against the twin, each variant counted as itself, and the wide
    outputs bit-identical to the grouped ones and from call to call (every
    beam's sums are those of its group of 8 in either launch)."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(beams * 31 + s_len + items)
    args = cross_case(g, items, 16, beams, s_len, kind)
    eb = 1 if kind == "int8" else 2
    grouped, wide = (K.dec_cross_variant_plan(v, beams, s_len, eb) for v in ("grouped", "wide"))
    K.reset_launch_counts()
    want = K._dec_cross_planned(grouped, *args, 16)
    got = K._dec_cross_planned(wide, *args, 16)
    assert K.dec_cross_variant_counts() == {"beams": 0, "wide": 1, "grouped": 1, "split": 0}
    close(want, K.dec_cross_attention_plain(*args, 16), True)
    assert torch.equal(got, want)
    assert torch.equal(K._dec_cross_planned(wide, *args, 16), got)


def test_variant_counters_add_up(dev):
    """Launches by kernel add up to the family's count, for gemm_bf16 and
    layernorm."""
    from vacnic_tpu_torch.kernels import primitives as K

    K.reset_launch_counts()
    for m in (37, 300):
        a = torch.zeros(m, 64, device=dev, dtype=torch.bfloat16)
        K.gemm(a, torch.zeros(64, 64, device=dev, dtype=torch.bfloat16))
    for d in (64, 1024, 1030, 4096):
        K.layernorm(torch.ones(5, d, device=dev), torch.ones(2, d, device=dev), torch.bfloat16)
    counts = K.launch_counts()
    assert sum(K.gemm_variant_counts().values()) == counts["gemm_bf16"] == 2
    assert K.layernorm_variant_counts() == {"warp": 2, "block": 2}
    assert sum(K.layernorm_variant_counts().values()) == counts["layernorm"] == 4


def self_case(g, bk, heads, t_len, kind):
    """dec_self_attention inputs: qkv bf16, a cache of the kind (int8 with
    per-row scales [T, BK, H]; fp8 of values up to a few units), a random
    ancestry over all rows."""
    bf = torch.bfloat16
    d = heads * 64
    shape = (t_len, bk, d)
    qkv = rn(g, bk, 3 * d, dtype=bf)
    ks = vs = None
    if kind == "int8":
        ck, cv = (torch.randint(-127, 128, shape, device="cuda", generator=g).to(torch.int8)
                  for _ in range(2))
        ks, vs = (rn(g, t_len, bk, heads).abs() * 0.01 + 1e-3 for _ in range(2))
    elif kind == "fp8":
        ck, cv = (rn(g, *shape, std=2.0).clamp(-448, 448).to(torch.float8_e4m3fn)
                  for _ in range(2))
    else:
        ck, cv = rn(g, *shape, dtype=bf), rn(g, *shape, dtype=bf)
    anc = torch.randint(0, bk, (t_len, bk), device="cuda", generator=g).int()
    return qkv, ck, cv, anc, ks, vs


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("bk,heads", [(1, 4), (5, 16), (8, 4), (37, 4), (160, 16), (640, 16)])
def test_dec_self_attention_sweep(dev, kind, bk, heads):
    """Each cache type at any row count, 4 and 16 heads, the step's row alone
    (pos 0) up to pos = T - 1, a random ancestry: against the twin, counted
    under its own type, bit-identical over two calls."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(bk * 100 + heads)
    qkv, ck, cv, anc, ks, vs = self_case(g, bk, heads, 64, kind)
    for pos in (0, 1, 31, 49, 63):
        before = K.dec_self_variant_counts()[kind]
        out = K.dec_self_attention(qkv, ck, cv, anc, pos, heads, ks, vs)
        assert K.dec_self_variant_counts()[kind] == before + 1
        assert bool(torch.isfinite(out.float()).all())
        close(out, K.dec_self_attention_plain(qkv, ck, cv, anc, pos, heads, ks, vs), True)
        assert torch.equal(out, K.dec_self_attention(qkv, ck, cv, anc, pos, heads, ks, vs))


def test_dec_self_int8_pow2_is_bf16_on_the_dequantized_cache(dev):
    """Power-of-two scales: the int8 instance gives the bf16 instance's
    result on the dequantized cache bit for bit."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(7)
    t_len, bk, heads = 64, 160, 16
    qkv, ck, cv, anc, _, _ = self_case(g, bk, heads, t_len, "int8")
    ks, vs = (torch.exp2(torch.randint(-3, 3, (t_len, bk, heads), device=dev,
                                       generator=g).float()) for _ in range(2))

    def deq(c, s):
        return (c.float().view(t_len, bk, heads, 64) * s[..., None]).view(c.shape).to(
            torch.bfloat16)

    for pos in (0, 5, 31, 49, 63):
        assert torch.equal(K.dec_self_attention(qkv, ck, cv, anc, pos, heads, ks, vs),
                           K.dec_self_attention(qkv, deq(ck, ks), deq(cv, vs), anc, pos, heads))


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_dec_self_attention_long_cache(dev, kind):
    """T = 4096, the longest the wrapper takes (86 KB of shared memory)."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(4096)
    args = self_case(g, 5, 4, 4096, kind)
    for pos in (1000, 4095):
        out = K.dec_self_attention(*args[:4], pos, 4, *args[4:])
        close(out, K.dec_self_attention_plain(*args[:4], pos, 4, *args[4:]), True)


def test_dec_self_attention_refuses(dev):
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(3)
    qkv, ck, cv, anc, ks, vs = self_case(g, 5, 4, 16, "int8")
    bad = [lambda: K.dec_self_attention(qkv, ck, cv, anc, 3, 4),            # no scales
           lambda: K.dec_self_attention(qkv, ck.half(), cv.half(), anc, 3, 4),
           lambda: K.dec_self_attention(qkv, ck, cv, anc, 16, 4, ks, vs),   # pos == T
           lambda: K.dec_self_attention(qkv, ck, cv, anc, 3, 2, ks, vs)]    # head_dim 128
    qkv2, ck2, cv2, anc2, _, _ = self_case(g, 2, 4, 4097, "bf16")
    bad.append(lambda: K.dec_self_attention(qkv2, ck2, cv2, anc2, 3, 4))   # T > 4096
    for call in bad:
        with pytest.raises(ValueError):
            call()


@pytest.fixture(scope="module")
def lm_weights(dev):
    """The full model's padded head: V 50267 real rows of 53248, d 1024,
    pad rows zero, pad bias -1e9."""
    g = torch.Generator(device=dev).manual_seed(11)
    v, vp, d = 50267, 53248, 1024
    w = torch.zeros(vp, d, device=dev, dtype=torch.bfloat16)
    w[:v] = rn(g, v, d, std=0.02, dtype=torch.bfloat16)
    b = torch.full((vp,), -1e9, device=dev)
    b[:v] = rn(g, v, std=0.02)
    return w, b


@pytest.mark.parametrize("vp", [4096, 53248])
@pytest.mark.parametrize("bk", [1, 5, 37, 160, 320, 640])
def test_lm_head_kernel(dev, lm_weights, bk, vp):
    """Ragged BK through one pass (N 64 ... 256) and several (320, 640),
    against the twin; bit-identical over two calls; one launch counted."""
    from vacnic_tpu_torch.kernels import lm_head as LH
    from vacnic_tpu_torch.kernels import primitives as K

    w, b = (a[:vp] for a in lm_weights)
    x = rn(torch.Generator(device=dev).manual_seed(bk), bk, 1024, dtype=torch.bfloat16)
    before = K.launch_counts()["lm_head"]
    out = LH.lm_head(x, w, b)
    assert K.launch_counts()["lm_head"] == before + 1
    close(out, LH.lm_head_plain(x, w, b), False)
    assert torch.equal(out, LH.lm_head(x, w, b))


@pytest.mark.parametrize("bk,d,vp", [(160, 768, 4096), (37, 96, 256), (300, 32, 128)])
def test_lm_head_other_widths(dev, bk, d, vp):
    """d 768, a k tail of 32 (d 96, d 32), and heads of 4 and 2 vocab units
    (a block with one unit leaves its second warpgroup idle)."""
    from vacnic_tpu_torch.kernels import lm_head as LH

    g = torch.Generator(device=dev).manual_seed(d)
    x, w, b = rn(g, bk, d, dtype=torch.bfloat16), rn(g, vp, d, std=0.1, dtype=torch.bfloat16), \
        rn(g, vp)
    out = LH.lm_head(x, w, b)
    close(out, LH.lm_head_plain(x, w, b), False)
    assert torch.equal(out, LH.lm_head(x, w, b))


def test_lm_head_refuses(dev):
    from vacnic_tpu_torch.kernels import lm_head as LH

    x = torch.zeros(8, 64, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(256, 64, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(256, device=dev)
    bad = [lambda: LH.lm_head(x, w.cpu(), b),                   # CPU weights, CUDA x
           lambda: LH.lm_head(x, w, b.cpu()),
           lambda: LH.lm_head(x.float(), w, b),                 # not bf16
           lambda: LH.lm_head(x, w.float(), b),
           lambda: LH.lm_head(x, w, b.to(torch.bfloat16)),      # bias not f32
           lambda: LH.lm_head(x[:, :48].contiguous(), w[:, :48].contiguous(), b),  # d % 32
           lambda: LH.lm_head(x, w[:200], b[:200])]             # Vp % 128
    for call in bad:
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("vp", [1024, 4096, 53248])
@pytest.mark.parametrize("bk", [1, 5, 37, 160, 320, 640])
def test_lm_stats_tiles(dev, lm_weights, bk, vp):
    """lm_stats_kernel (the LM head's kernel with the statistics epilogue)
    at one to three passes over BK, against the twin; m the max of its own
    logits bit for bit; Vp 53248's last two blocks all pad (m = -1e9, s =
    1024); bit-identical over two calls; the arrival counters zero after a
    launch; one launch counted."""
    from vacnic_tpu_torch.kernels import lm_stats as LS
    from vacnic_tpu_torch.kernels import primitives as K

    w, b = (a[:vp] for a in lm_weights)
    x = rn(torch.Generator(device=dev).manual_seed(bk + vp), bk, 1024, dtype=torch.bfloat16)
    before = K.launch_counts()["lm_stats"]
    logits, m, s = LS.lm_stats(x, w, b)
    assert K.launch_counts()["lm_stats"] == before + 1
    torch.cuda.synchronize()
    assert not bool(LS.counters(dev).any())
    pl, pm, ps = LS.lm_stats_plain(x, w, b)
    close(logits, pl, False)
    close(m, pm, False)
    close(s, ps, False)
    assert torch.equal(m, logits.view(bk, -1, LS.VBLOCK).amax(-1))
    if vp == 53248:
        assert bool((m[:, -2:] == -1e9).all()) and bool((s[:, -2:] == 1024.0).all())
    again = LS.lm_stats(x, w, b)
    assert all(torch.equal(a, o) for a, o in zip(again, (logits, m, s)))


def test_lm_stats_graph_replay(dev, lm_weights):
    """The counters reset themselves: replays of one captured launch give the
    eager launch's statistics."""
    from vacnic_tpu_torch.kernels import lm_stats as LS

    w, b = (a[:8192] for a in lm_weights)
    x = rn(torch.Generator(device=dev).manual_seed(3), 160, 1024, dtype=torch.bfloat16)
    eager = LS.lm_stats(x, w, b)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = LS.lm_stats(x, w, b)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, o) for a, o in zip(out, eager))


def test_lm_stats_refuses(dev):
    from vacnic_tpu_torch.kernels import lm_stats as LS

    x = torch.zeros(8, 64, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(2048, 64, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(2048, device=dev)
    off = torch.zeros(8 * 64 + 1, device=dev, dtype=torch.bfloat16)
    bad = [lambda: LS.lm_stats(x, w.cpu(), b),                    # CPU weights, CUDA x
           lambda: LS.lm_stats(x.float(), w, b),                  # not bf16
           lambda: LS.lm_stats(x, w, b.to(torch.bfloat16)),       # bias not f32
           lambda: LS.lm_stats(x[:, :48].contiguous(), w[:, :48].contiguous(), b),  # d % 32
           lambda: LS.lm_stats(x, w[:1536], b[:1536]),            # Vp % 1024
           lambda: LS.lm_stats(x[:0], w, b),                      # BK 0
           lambda: LS.lm_stats(off[1:].view(8, 64), w, b)]        # x off 16 bytes
    for call in bad:
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("nb", [1, 2, 3, 4])
def test_lm_head_smem_from_the_library(dev, nb):
    """The library states each instance's shared memory: the statistics'
    4 KB exchange and flags sit beside the LM head's ring without taking a
    slot from it, inside the 227 KB a block may have; other N are refused."""
    from vacnic_tpu_torch.kernels import _build
    from vacnic_tpu_torch.kernels import primitives as K

    lib = _build.lib()
    plain, stats = lib.vt_lm_head_smem_bytes(nb, 0), lib.vt_lm_head_smem_bytes(nb, 1)
    assert stats == plain + 4096 + 16 <= K.SMEM_MAX
    assert lib.vt_lm_head_smem_bytes(0, 1) == lib.vt_lm_head_smem_bytes(5, 0) == -1


def test_enc_cross_smem_from_the_library(dev):
    """Four blocks of the cross-attention (K, V, three q tiles and the
    output tile, + 1024 to align) fit an SM's 228 KB, 1 KB a block kept by
    the card."""
    from vacnic_tpu_torch.kernels import _build

    smem = _build.lib().vt_enc_cross_smem_bytes()
    assert smem == 1024 + 6 * 64 * 128
    assert 4 * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("kv", [1, 8, 16, 20, 36, 40, 64])
@pytest.mark.parametrize("s_len", [1, 63, 64, 130, 512])
def test_enc_cross_tiles(dev, s_len, kv):
    """The tensor-core cross-attention against its twin at every KV <= 64
    (the configs' 40, 20, 36 and 16 among them: K rows 80, 40, 72 and 32
    bytes apart) and ragged S (a last q tile of 1, 63, 2 rows),
    bit-identical over two calls, each launch counted under its KV; and at
    batch 32, whose one (item, head) block walks all eight q tiles of S
    512, and batch 1, eight blocks of one q tile each."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(s_len * 100 + kv)
    bf = torch.bfloat16
    # the launcher gives an (item, head) as many blocks as fill the card: one
    # at batch 32 x 16 heads, one a q tile at batch 1 x 4 heads
    for b_sz, heads in ((3, 4), (32, 16), (1, 4)) if s_len == 512 else ((3, 4),):
        d = heads * 64
        q = rn(g, b_sz * s_len, d, dtype=bf)
        ck, cv = rn(g, b_sz, d, kv, dtype=bf), rn(g, b_sz, kv, d, dtype=bf)
        before = K.launch_counts()["enc_cross_attention"]
        before_kv = K.enc_cross_kv_counts().get(kv, 0)
        out = K.enc_cross_attention(q, ck, cv, b_sz, s_len, heads)
        assert K.launch_counts()["enc_cross_attention"] == before + 1
        assert K.enc_cross_kv_counts()[kv] == before_kv + 1
        close(out, K.enc_cross_attention_plain(q, ck, cv, b_sz, s_len, heads), True)
        assert torch.equal(out, K.enc_cross_attention(q, ck, cv, b_sz, s_len, heads))


def test_enc_cross_refuses(dev):
    from vacnic_tpu_torch.kernels import primitives as K

    bf = torch.bfloat16
    q = torch.zeros(2 * 8, 128, device=dev, dtype=bf)
    ck, cv = torch.zeros(2, 128, 8, device=dev, dtype=bf), torch.zeros(2, 8, 128, device=dev,
                                                                       dtype=bf)
    ck65, cv65 = torch.zeros(2, 128, 65, device=dev, dtype=bf), torch.zeros(2, 65, 128,
                                                                           device=dev, dtype=bf)
    bad = [lambda: K.enc_cross_attention(q, ck65, cv65, 2, 8, 2),          # KV > 64
           lambda: K.enc_cross_attention(q, ck[:, :, :0].contiguous(), cv[:, :0].contiguous(),
                                         2, 8, 2),                          # KV 0
           lambda: K.enc_cross_attention(q.float(), ck, cv, 2, 8, 2),       # not bf16
           lambda: K.enc_cross_attention(q, ck, cv, 2, 8, 4)]               # head_dim 32
    for call in bad:
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("batch,s_len,d", [(256, 512, 1024), (1, 512, 1024), (8, 512, 1024),
                                           (32, 512, 1024), (3, 333, 1024), (2, 1024, 768),
                                           (3, 7, 256), (2, 256, 256), (5, 257, 256)])
def test_cross_kv_kernel(dev, batch, s_len, d, int8):
    """cross_kv_gemm_kernel against the plain twin at the cells' shape (B
    256 x S 512), the service's buckets 1 / 8 / 32, S that is no whole row
    tile (7, 257, 333) and BART's longest (1024 at d 768), two layers: int8
    within +-1 on at most 1% of the entries, scales within 2^-7, bf16 within
    one ulp (chip_smoke.cross_kv_gaps); the int8 form equal, bit for bit, to
    quantize_cross_kv of the kernel's own bf16 form; one launch a layer."""
    import chip_smoke
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(batch * 7 + s_len)
    x, w, b = chip_smoke.cross_kv_inputs(g, batch, s_len, d, layers=2)
    before = K.launch_counts()["cross_kv"]
    got = K.cross_kv(x, w, b, d // 64, int8)
    assert K.launch_counts()["cross_kv"] == before + 2
    gaps = chip_smoke.cross_kv_gaps(got, K.cross_kv_plain(x, w, b, d // 64, int8))
    assert gaps["ok"], gaps
    if int8:
        k16, v16, _, _ = K.cross_kv(x, w, b, d // 64, False)
        for q, sc, y in ((got[0], got[2], k16), (got[1], got[3], v16)):
            q_ref, sc_ref = K.quantize_cross_kv(y)
            assert torch.equal(q, q_ref) and torch.equal(sc, sc_ref)
    again = K.cross_kv(x, w, b, d // 64, int8)
    assert all(torch.equal(a, o) for a, o in zip(again, got) if a is not None)


def test_cross_kv_refuses(dev):
    from vacnic_tpu_torch.kernels import primitives as K

    bf = torch.bfloat16
    x = torch.zeros(2, 40, 256, device=dev, dtype=bf)
    w = torch.zeros(3, 256, 512, device=dev, dtype=bf)
    b = torch.zeros(3, 512, device=dev)
    bad = [lambda: K.cross_kv(x.float(), w, b, 4, True),                        # x not bf16
           lambda: K.cross_kv(x, w.float(), b, 4, True),                        # w not bf16
           lambda: K.cross_kv(x, w[:, :, :256].contiguous(), b, 4, True),       # w not [d, 2d]
           lambda: K.cross_kv(x, w, b[:2], 4, True),                            # b of 2 layers
           lambda: K.cross_kv(x.transpose(0, 1), w, b, 4, True),                # not contiguous
           lambda: K.cross_kv(torch.zeros(1, 16385, 256, device=dev, dtype=bf), w, b, 4, True),
           lambda: K.cross_kv(torch.zeros(1, 8, 96, device=dev, dtype=bf),
                              torch.zeros(1, 96, 192, device=dev, dtype=bf),
                              torch.zeros(1, 192, device=dev), 1, True),        # d % 64
           lambda: K.cross_kv(x, w, b, 3, True),                                # 3 heads of 256
           lambda: K.cross_kv(x[0], w, b, 4, True),                             # not [B, S, d]
           lambda: K.cross_kv(torch.zeros(2 * 40 * 256 + 1, device=dev, dtype=bf)[1:]
                              .view(2, 40, 256), w, b, 4, True)]                # off 16 bytes
    for call in bad:
        with pytest.raises(ValueError):
            call()
    with pytest.raises(RuntimeError):  # no backward
        K.cross_kv(x, w.clone().requires_grad_(), b, 4, True)


def card_config():
    """VacnicConfig.tiny() widened to shapes the kernels take (head_dim 64
    with four heads, d 256; S = 64): the config `cli smoke` runs."""
    from vacnic_tpu_torch.cli import _smoke_config

    return _smoke_config()


@pytest.mark.parametrize("input_kind", ["image_cls", "pixels"])
def test_caption_service_on_the_card(dev, input_kind):
    """CaptionService(device="cuda") with three requests in a 4-bucket:
    tokens and scores identical to a direct generate_mm (after
    clip_vision_fwd for pixels) of the same padded batch on the card, with
    the encoder and decode stacks' kernels launched."""
    import numpy as np

    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.data.synthetic import synthetic_batch
    from vacnic_tpu_torch.infer.generate import generate_mm
    from vacnic_tpu_torch.kernels import primitives as K
    from vacnic_tpu_torch.models.clip_vit import clip_vision_fwd, clip_vision_init
    from vacnic_tpu_torch.models.fusion import multimodal_bart_init
    from vacnic_tpu_torch.serve import CaptionService, ServeConfig
    from vacnic_tpu_torch.train.train_step import create_mask, face_mask_from_emb

    cfg = card_config()
    params = {"model": multimodal_bart_init(make_generator(0, dev), cfg.bart, cfg.fusion,
                                            device=dev),
              "clip": clip_vision_init(make_generator(1, dev), cfg.clip, device=dev)}
    pixels = input_kind == "pixels"
    b = synthetic_batch(cfg, 3, seed=5, with_pixels=pixels)
    keys = ("article_ids", input_kind, "face_emb", "names_art_ids")
    rows = [{k: b[k][i].numpy() for k in keys} for i in range(3)]
    svc = CaptionService(cfg, params, device="cuda",
                         serve_cfg=ServeConfig(buckets=(4,), max_wait_ms=5000,
                                               input_kind=input_kind))
    try:
        K.reset_launch_counts()
        results = [f.result(timeout=600) for f in [svc.submit(r) for r in rows]]
        counts = K.launch_counts()
    finally:
        svc.close()
    for k in ("gemm_bf16", "layernorm", "enc_self_attention", "enc_cross_attention",
              "dec_self_attention", "dec_cross_attention"):
        assert counts[k] > 0, (k, counts)
    x = {k: torch.from_numpy(np.stack([r[k] for r in rows + rows[:1]])).to(dev) for k in keys}
    img = x.get("image_cls")
    if pixels:
        _, img = clip_vision_fwd(params["clip"], x["pixels"], cfg.clip, torch.float32)
    seqs, scores = generate_mm(
        params["model"], x["article_ids"], create_mask(x["article_ids"]), img, cfg.bart,
        cfg.fusion, cfg.decode, face_features=x["face_emb"],
        face_mask=face_mask_from_emb(x["face_emb"]), name_ids=x["names_art_ids"],
        name_mask=create_mask(x["names_art_ids"]), dtype=torch.float32, device="cuda")
    for i, res in enumerate(results):
        assert res["tokens"] == seqs[i].tolist()
        assert res["score"] == float(scores[i])


class LoaderRows:
    """Rows of numpy arrays at the main path's widths (512-token articles,
    [n, 512] faces, 224 px pixels), made from the row's index."""

    def __len__(self):
        return 48

    def __getitem__(self, i):
        import numpy as np

        rng = np.random.RandomState(int(i))
        return {"article_ids": rng.randint(0, 50265, rng.randint(3, 600)).tolist(),
                "caption_ids": rng.randint(0, 50265, rng.randint(2, 40)).tolist(),
                "names_art_ids": [0, 11, 50265, 12, 2], "names_ids_flatten": [0, 13, 2],
                "names_ids": [[0, 14, 2]] * (i % 3),
                "face_emb": rng.randn(i % 4, 512).astype(np.float32),
                "pixels": rng.randn(224, 224, 3).astype(np.float32),
                "caption": f"caption {i}", "sample_idx": int(i)}


def test_prefetch_loader_on_the_card(dev):
    """Batches on the card equal host collate bit for bit, with numpy's
    dtypes, from pinned memory. Epoch 1 keeps the current stream busy
    before it reads each batch and drops it: without record_stream the
    producer's next copies could land in its memory first. Epoch 2 reads
    each batch at once: without the wait on the copy's event the read could
    see the copy unfinished. An abandoned iterator leaves no thread."""
    import threading
    import time

    import numpy as np

    from vacnic_tpu_torch.data.collate import collate
    from vacnic_tpu_torch.data.pipeline import THREAD_NAME, PrefetchLoader

    rows, bs = LoaderRows(), 8
    loader = PrefetchLoader(rows, bs, collate, shuffle=False, num_workers=4, device="cuda")
    host = [collate([rows[i] for i in range(k * bs, (k + 1) * bs)]) for k in range(len(loader))]
    for busy in (True, False):
        copies = []
        for b in loader:
            if busy:
                torch.cuda._sleep(5_000_000)
            copies.append({k: v.clone() for k, v in b.items() if isinstance(v, torch.Tensor)})
            assert all(v.is_cuda for v in copies[-1].values())
            del b
        torch.cuda.synchronize()
        assert len(copies) == len(host)
        for got, want in zip(copies, host):
            arrays = {k: v for k, v in want.items() if isinstance(v, np.ndarray)}
            assert set(got) == set(arrays)
            for k, v in arrays.items():
                w = torch.from_numpy(v)
                assert got[k].dtype == w.dtype and torch.equal(got[k].cpu(), w), k
    assert loader.pinned_bytes == 2 * sum(v.nbytes for h in host for v in h.values()
                                          if isinstance(v, np.ndarray))
    it = iter(loader)
    next(it)
    it.close()
    deadline = time.time() + 10.0
    while time.time() < deadline and any(t.name.startswith(THREAD_NAME)
                                         for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name.startswith(THREAD_NAME) and t.is_alive()
                   for t in threading.enumerate())


def test_cli_smoke_and_generate_on_the_card(dev, tmp_path, capsys):
    """`python -m vacnic_tpu_torch.cli smoke` and `generate` on the card (the
    default device): smoke launches the slice's kernels; generate from a
    CheckpointManager directory writes the file train/loop.generate_captions
    writes for the same tree and loader (card_config, a 4-row fixture from
    chip_smoke.py's writers)."""
    import dataclasses
    import json
    import runpy
    from pathlib import Path

    from vacnic_tpu_torch import cli
    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.kernels import primitives as K
    from vacnic_tpu_torch.models.clip_vit import clip_vision_init
    from vacnic_tpu_torch.models.fusion import multimodal_bart_init
    from vacnic_tpu_torch.train import loop
    from vacnic_tpu_torch.train.checkpoints import CheckpointManager
    from vacnic_tpu_torch.train.train_step import TrainState

    slice_kernels = ("gemm_bf16", "layernorm", "enc_self_attention", "enc_cross_attention",
                     "dec_self_attention", "dec_cross_attention")
    K.reset_launch_counts()
    assert cli.main(["smoke"]) == 0
    assert "smoke ok" in capsys.readouterr().out
    assert all(K.launch_counts()[k] > 0 for k in slice_kernels), K.launch_counts()

    smoke = runpy.run_path(str(Path(__file__).resolve().parents[1] / "chip_smoke.py"),
                           run_name="chip_smoke_helpers")
    vocab, merges = smoke["write_bpe_vocab"](str(tmp_path), size=None)
    cfg = card_config()
    base, dicts = smoke["write_news_fixture"](str(tmp_path), splits=(("test", 4),),
                                              image_size=cfg.clip.image_size,
                                              face_dim=cfg.fusion.face_feature_dim,
                                              article_words=80, caption_words=6)
    n_vocab = len(json.load(open(vocab))) + 8
    cfg = dataclasses.replace(
        cfg, bart=dataclasses.replace(cfg.bart, vocab_size=n_vocab),
        fusion=dataclasses.replace(cfg.fusion, ner_vocab_size=n_vocab),
        data=dataclasses.replace(cfg.data, data_dir=str(tmp_path), num_workers=2),
        train=dataclasses.replace(cfg.train, val_batch_size=4))
    params = {"model": multimodal_bart_init(make_generator(0, dev), cfg.bart, cfg.fusion,
                                            device=dev),
              "clip": clip_vision_init(make_generator(1, dev), cfg.clip, device=dev)}
    ckpt = str(tmp_path / "ckpt")
    CheckpointManager(ckpt, cfg).save(0, TrainState(step=0, params=params, teacher={},
                                                    opt_state={}, rng=0))
    tok = smoke["news_tokenizer"](vocab, merges)
    loader = smoke["news_loader"](cfg, tok, base, dicts["test"], False, "cuda")
    loop.generate_captions(cfg, params, loader, tok, out_path=str(tmp_path / "ref.json"),
                           device="cuda")
    K.reset_launch_counts()
    assert cli.main(["generate", "--ckpt-dir", ckpt, "--data-dict",
                     str(tmp_path / "GoodNews" / "test_dict.json"), "--vocab", vocab,
                     "--merges", merges, "--out", str(tmp_path / "gen.json")]) == 0
    assert all(K.launch_counts()[k] > 0 for k in slice_kernels), K.launch_counts()
    assert (tmp_path / "gen.json").read_text() == (tmp_path / "ref.json").read_text()


def mesh_inputs(dev, rows: int = 8):
    """card_config()'s model from seed 0 on `dev` and a batch of `rows`."""
    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.data.synthetic import synthetic_batch
    from vacnic_tpu_torch.models.fusion import multimodal_bart_init
    from vacnic_tpu_torch.train.train_step import create_mask, face_mask_from_emb

    cfg = card_config()
    params = multimodal_bart_init(make_generator(0, dev), cfg.bart, cfg.fusion, device=dev)
    b = {k: v.to(dev) for k, v in synthetic_batch(cfg, rows, seed=2).items()}
    x = dict(input_ids=b["article_ids"], attention_mask=create_mask(b["article_ids"]),
             image_features=b["image_cls"], face_features=b["face_emb"],
             face_mask=face_mask_from_emb(b["face_emb"]), name_ids=b["names_art_ids"],
             name_mask=create_mask(b["names_art_ids"]))
    return cfg, params, x


def two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")


def test_mesh_one_card_matches_generate_mm(dev):
    """generate_mm_sharded over a one-card mesh: the program generate_mm
    runs, at the same shapes: tokens and scores identical, the decode
    kernels launched."""
    from vacnic_tpu_torch.core.mesh import make_mesh
    from vacnic_tpu_torch.infer.generate import generate_mm, generate_mm_sharded
    from vacnic_tpu_torch.kernels import primitives as K

    cfg, params, x = mesh_inputs(dev)
    seqs, scores = generate_mm(params, cfg=cfg.bart, fcfg=cfg.fusion, dcfg=cfg.decode,
                               device=dev, **x)
    K.reset_launch_counts()
    mseqs, mscores = generate_mm_sharded(make_mesh(devices=["cuda:0"]), params, cfg=cfg.bart,
                                         fcfg=cfg.fusion, dcfg=cfg.decode, **x)
    torch.cuda.synchronize()
    assert K.launch_counts()["dec_cross_attention"] > 0
    assert torch.equal(seqs, mseqs) and torch.equal(scores, mscores)


def test_mesh_two_cards_match(dev):
    """A 2-card mesh: each shard identical to generate_mm of its rows on its
    card, the tokens of the whole batch on one card."""
    from vacnic_tpu_torch.core.mesh import make_mesh
    from vacnic_tpu_torch.infer.generate import generate_mm, generate_mm_sharded

    two_cards()
    cfg, params, x = mesh_inputs(dev)
    kw = dict(cfg=cfg.bart, fcfg=cfg.fusion, dcfg=cfg.decode)
    mseqs, mscores = generate_mm_sharded(make_mesh(devices=["cuda:0", "cuda:1"]), params,
                                         **kw, **x)
    assert mseqs.device == torch.device("cuda", 0)
    whole, _ = generate_mm(params, device="cuda:0", **kw, **x)
    assert torch.equal(mseqs, whole)
    for i, d in enumerate(("cuda:0", "cuda:1")):
        s, c = generate_mm(params, device=d, **kw, **{k: v[4 * i:4 * i + 4] for k, v in x.items()})
        assert torch.equal(mseqs[4 * i:4 * i + 4], s.to(mseqs.device))
        assert torch.equal(mscores[4 * i:4 * i + 4], c.to(mscores.device))


def test_kernel_on_a_second_card_from_a_thread_on_the_first(dev):
    """A wrapper launches on its operands' card and that card's stream,
    whatever device the calling thread has current; the thread's device is
    left as it was."""
    import threading

    from vacnic_tpu_torch.kernels import primitives as K

    two_cards()
    d1 = torch.device("cuda", 1)
    out = {}

    def work():
        torch.cuda.set_device(0)
        g = torch.Generator(device=d1).manual_seed(3)
        a = (torch.randn(160, 256, generator=g, device=d1)).to(torch.bfloat16)
        w = (torch.randn(256, 384, generator=g, device=d1) * 0.05).to(torch.bfloat16)
        r = torch.randn(160, 384, generator=g, device=d1)
        gb = torch.stack([1 + 0.1 * torch.randn(384, generator=g, device=d1),
                          0.1 * torch.randn(384, generator=g, device=d1)]).contiguous()
        out["gemm"] = (K.gemm(a, w, residual=r), K.gemm_plain(a, w, residual=r))
        out["ln"] = (K.layernorm(r, gb, torch.bfloat16)[0], K.layernorm_plain(r, gb,
                                                                              torch.bfloat16)[0])
        torch.cuda.synchronize(d1)
        out["current"] = torch.cuda.current_device()

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and out["current"] == 0
    for got, want in (out["gemm"], out["ln"]):
        assert got.device == d1
        close(got, want, False)


def test_two_rank_nccl_dp_step_equals_one_rank(dev, tmp_path):
    """The data-parallel step in 2 NCCL ranks (chip_smoke.run_dp_group) on
    card_config() in f32 with dropout 0.1: loss terms within 2e-5 of one
    process on the same global batch of 8, each reduced gradient leaf within
    1e-4 of that leaf's largest |gradient| (sum order on the card)."""
    import dataclasses
    import sys
    from pathlib import Path

    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.core.tree import leaves_with_path
    from vacnic_tpu_torch.data.synthetic import synthetic_batch
    from vacnic_tpu_torch.models.bart import bart_init
    from vacnic_tpu_torch.models.fusion import multimodal_bart_init
    from vacnic_tpu_torch.models.layers import split
    from vacnic_tpu_torch.models.weights_io import tree_to
    from vacnic_tpu_torch.train import train_step as TT

    two_cards()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    cfg = card_config()
    cfg = dataclasses.replace(cfg, bart=dataclasses.replace(cfg.bart, dropout=0.1),
                              train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    g = make_generator(0)
    params = {"model": multimodal_bart_init(g, cfg.bart, cfg.fusion)}
    teacher = bart_init(g, cfg.bart)
    batch = {k: v.numpy() for k, v in synthetic_batch(cfg, 8, seed=1).items()}
    (res,) = chip_smoke.run_dp_group(2, dict(device="cuda", params=params, teacher=teacher,
                                             rng=5, batch=batch,
                                             cases=[dict(cfg=cfg, steps=2, grads=True)]),
                                     str(tmp_path), timeout_s=300)
    init_fn, step_fn = TT.make_train_step(cfg, 100, device=dev)
    state = init_fn(tree_to(params, dev), tree_to(teacher, dev), 5)
    m, grads = TT.loss_and_grads(state.params, state.teacher, batch, cfg, split(state.rng)[1])
    for k, v in m.items():
        assert abs(res["grad_metrics"][k] - float(v)) <= 2e-5 * (1 + abs(float(v))), k
    for path, got, want in zip(leaves_with_path(state.params), res["grads"], grads):
        assert (got is None) == (want is None), path[0]
        if want is not None:
            tol = 1e-4 * float(want.abs().max()) + 1e-9
            assert float((got.to(dev) - want).abs().max()) <= tol, path[0]
    for i in range(2):
        state, m = step_fn(state, batch)
        for k, v in m.items():
            assert abs(res["steps"][i][k] - float(v)) <= 2e-5 * (1 + abs(float(v))), (i, k)


@pytest.mark.parametrize("heads", [8, 4])
def test_flash_attention_on_head_shards(dev, heads):
    """The teacher's encoder self-attention on a model rank (tp 2: 8 of 16
    heads, tp 4: 4): head-split views of [B, T, heads*64] projections with a
    [B, 1, T, S] bias of padded keys, at T = S = 512, against the plain
    twin; attention_core takes the kernel at these shapes (flash_eligible)."""
    from vacnic_tpu_torch.kernels import flash_attn as FA
    from vacnic_tpu_torch.kernels import primitives as K
    from vacnic_tpu_torch.models import layers as TL

    g = torch.Generator(device=dev).manual_seed(heads)
    B, T, d = 4, 512, 64
    bf = torch.bfloat16

    def shard():
        return rn(g, B, T, heads * d, dtype=bf).view(B, T, heads, d).permute(0, 2, 1, 3)

    q = (shard().float() * d ** -0.5).to(bf)
    k, v = shard(), shard()
    bias = torch.zeros(B, 1, T, T, device=dev)
    bias[1, :, :, 300:] = torch.finfo(torch.float32).min
    bias = bias.to(bf)
    assert FA.flash_eligible(q, k, bias)
    before = K.launch_counts()["flash_attention"]
    out = TL.attention_core(q, k, v, bias)
    assert K.launch_counts()["flash_attention"] == before + 1
    assert out.shape == (B, heads, T, d) and bool(torch.isfinite(out.float()).all())
    close(out, FA.flash_attention_plain(q, k, v, bias), True)


def test_two_rank_tp_step_on_one_card(dev, tmp_path):
    """The tensor-parallel step in 2 ranks (chip_smoke.run_dp_group, grid dp 1
    x tp 2: gloo when the ranks share one card, NCCL on two) on
    card_config() in f32 with dropout 0.1: loss terms within 2e-5 of one
    process on the same global batch of 8, each gradient leaf (the cut ones
    gathered whole) within 1e-4 of that leaf's largest |gradient| (sum order
    on the card; a key bias: of its attention's largest;
    chip_smoke.grad_errors), the replicated leaves' gradients bit-identical
    across the two ranks, each rank's storage its shards'."""
    import dataclasses
    import sys
    from pathlib import Path

    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.core.tree import leaves_with_path
    from vacnic_tpu_torch.data.synthetic import synthetic_batch
    from vacnic_tpu_torch.models.bart import bart_init
    from vacnic_tpu_torch.models.fusion import multimodal_bart_init
    from vacnic_tpu_torch.models.layers import split
    from vacnic_tpu_torch.models.weights_io import tree_to
    from vacnic_tpu_torch.train import train_step as TT

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    cfg = card_config()
    cfg = dataclasses.replace(cfg, bart=dataclasses.replace(cfg.bart, dropout=0.1),
                              train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    g = make_generator(0)
    params = {"model": multimodal_bart_init(g, cfg.bart, cfg.fusion)}
    teacher = bart_init(g, cfg.bart)
    batch = {k: v.numpy() for k, v in synthetic_batch(cfg, 8, seed=1).items()}
    (res,) = chip_smoke.run_dp_group(2, dict(device="cuda", params=params, teacher=teacher,
                                             rng=5, batch=batch,
                                             cases=[dict(cfg=cfg, steps=2, grads=True,
                                                         grid=(1, 2))]),
                                     str(tmp_path), timeout_s=300)
    assert res["tp"]["replicated_grads_agree"]
    assert res["tp"]["param_bytes"] == res["tp"]["shard_bytes"] and res["tp"]["teacher_gathered"]
    init_fn, step_fn = TT.make_train_step(cfg, 100, device=dev)
    state = init_fn(tree_to(params, dev), tree_to(teacher, dev), 5)
    m, grads = TT.loss_and_grads(state.params, state.teacher, batch, cfg, split(state.rng)[1])
    for k, v in m.items():
        assert abs(res["grad_metrics"][k] - float(v)) <= 2e-5 * (1 + abs(float(v))), k
    paths = [p for p, _ in leaves_with_path(state.params)]
    errs = chip_smoke.grad_errors(paths, res["grads"],
                                  [None if w is None else w.cpu() for w in grads])
    assert len(errs) > 20
    assert all(e <= 1e-4 for e in errs.values()), max(errs.items(), key=lambda kv: kv[1])
    for i in range(2):
        state, m = step_fn(state, batch)
        for k, v in m.items():
            assert abs(res["steps"][i][k] - float(v)) <= 2e-5 * (1 + abs(float(v))), (i, k)


# ---------------------------------------------------------------------------
# LED (VacnicConfig.led_full): the window attention, the global rows, the
# cross K/V past 1024 positions and the split dec_cross_attention
# ---------------------------------------------------------------------------

def window_case(g, batch, s_len, heads, lengths):
    """qkv [B*S, 3d] bf16 ~ N(0, 1) and the pad bias of items of `lengths`."""
    qkv = rn(g, batch * s_len, 3 * heads * 64, dtype=torch.bfloat16)
    keep = torch.arange(s_len, device="cuda")[None, :] < torch.tensor(lengths, device="cuda")[:, None]
    bias = torch.where(keep, 0.0, torch.finfo(torch.float32).min).float().contiguous()
    return qkv, bias


@pytest.mark.parametrize("batch,s_len,heads,w,glob,lengths", [
    (3, 256, 2, 64, 1, (256, 100, 1)), (2, 512, 4, 100, 2, (512, 300)),
    (2, 1024, 2, 512, 1, (1024, 513)), (2, 192, 2, 0, 0, (192, 70)),
    (2, 640, 2, 17, 64, (640, 65)), (1, 128, 2, 1000, 3, (120,))])
def test_enc_window_attention_kernel(dev, batch, s_len, heads, w, glob, lengths):
    """enc_window_kernel against the twin: bands that are and are not whole
    tiles, one to 64 global tokens, a band wider than S, padded tails that
    end inside a tile and tiles wholly padded (zero rows); repeatable."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(s_len + w)
    qkv, bias = window_case(g, batch, s_len, heads, lengths)
    before = K.launch_counts()["enc_window_attention"]
    out = K.enc_window_attention(qkv, bias, batch, s_len, heads, w, glob)
    assert K.launch_counts()["enc_window_attention"] == before + 1
    ref = K.enc_window_attention_plain(qkv, bias, batch, s_len, heads, w, glob)
    close(out, ref, True)
    pad = (bias != 0).reshape(-1)
    assert bool((out[pad] == 0).all())
    assert torch.equal(out, K.enc_window_attention(qkv, bias, batch, s_len, heads, w, glob))


def test_enc_window_attention_led_size(dev):
    """LED's cell shape, B 32 x S 16384 x H 16, w 512, global <s>, lengths
    in [8192, 16384): against the twin on four items of the batch."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(16384)
    lengths = [8192 + 256 * i + 7 * i for i in range(32)]
    qkv, bias = window_case(g, 32, 16384, 16, lengths)
    out = K.enc_window_attention(qkv, bias, 32, 16384, 16, 512, 1)
    for item in (0, 5, 17, 31):
        rows = slice(item * 16384, (item + 1) * 16384)
        ref = K.enc_window_attention_plain(qkv[rows], bias[item:item + 1], 1, 16384, 16, 512, 1)
        close(out[rows], ref, True)


@pytest.mark.parametrize("batch,s_len,d", [(2, 512, 256), (3, 1280, 256), (32, 16384, 1024)])
def test_led_global_rows_on_the_card(dev, batch, s_len, d):
    """The fused stack's LED self-attention (the window kernel, then the
    global rows by gemm, the long or short cross_kv in bf16 and
    dec_cross_attention at one query an item) against the same steps
    through the plain twins."""
    from vacnic_tpu_torch.core.config import BartConfig
    from vacnic_tpu_torch.kernels import encoder_stack as ES
    from vacnic_tpu_torch.kernels import primitives as K

    heads = d // 64
    cfg = BartConfig(d_model=d, encoder_attention_heads=heads, attention_window=1024,
                     position_offset=0)
    g = torch.Generator(device=dev).manual_seed(batch + s_len)
    xb = rn(g, batch * s_len, d, dtype=torch.bfloat16)
    w_qkv = rn(g, d, 3 * d, std=0.02, dtype=torch.bfloat16)
    qkv = K.gemm(xb, w_qkv, rn(g, 3 * d, std=0.02), out_dtype=torch.bfloat16)
    _, bias = window_case(g, batch, s_len, heads, [s_len - 37 * i for i in range(batch)])
    sp = ES.EncStackParams(*([None] * 15), w_qg=rn(g, 1, d, d, std=0.02, dtype=torch.bfloat16),
                           b_qg=rn(g, 1, d, std=0.02),
                           w_kvg=rn(g, 1, d, 2 * d, std=0.02, dtype=torch.bfloat16),
                           b_kvg=rn(g, 1, 2 * d, std=0.02))
    got = ES._window_attention(sp, 0, qkv, xb, bias, batch, s_len, cfg, ES.KERNEL_OPS)
    items = range(batch) if batch <= 3 else (0, 9, 31)
    for item in items:
        rows = slice(item * s_len, (item + 1) * s_len)
        ref = ES._window_attention(sp, 0, qkv[rows], xb[rows], bias[item:item + 1], 1, s_len,
                                   cfg, ES.PLAIN_OPS)
        close(got[rows], ref, True)


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("batch,s_len,d", [(2, 1025, 256), (3, 1280, 256), (2, 4097, 512),
                                           (32, 16384, 1024)])
def test_cross_kv_long_kernel(dev, batch, s_len, d, int8):
    """cross_kv past 1024 positions (clusters of the column pair, then
    cross_kv_quant_kernel) against the twin, as test_cross_kv_kernel: int8
    within +-1 on a small share, scales within 2^-7, bf16 within an ulp; the
    int8 form equal, bit for bit, to quantize_cross_kv of the kernel's bf16
    form; a product and (int8) a quantization a layer; repeatable."""
    import chip_smoke
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(batch * 7 + s_len)
    layers = 1 if batch == 32 else 2
    x, w, b = chip_smoke.cross_kv_inputs(g, batch, s_len, d, layers=layers)
    before = K.launch_counts()
    got = K.cross_kv(x, w, b, d // 64, int8)
    after = K.launch_counts()
    assert after["cross_kv"] == before["cross_kv"] + layers
    assert after["cross_kv_quant"] == before["cross_kv_quant"] + (layers if int8 else 0)
    if batch == 32:  # the twin's f32 temporaries of one layer at 16384 positions: a few items
        sub = slice(0, 4)
        ref = K.cross_kv_plain(x[sub].contiguous(), w, b, d // 64, int8)
        got_sub = tuple(None if t is None else t[:, sub] for t in got)
        gaps = chip_smoke.cross_kv_gaps(got_sub, ref)
    else:
        gaps = chip_smoke.cross_kv_gaps(got, K.cross_kv_plain(x, w, b, d // 64, int8))
    assert gaps["ok"], gaps
    if int8:
        k16, v16, _, _ = K.cross_kv(x, w, b, d // 64, False)
        for q, sc, y in ((got[0], got[2], k16), (got[1], got[3], v16)):
            q_ref, sc_ref = K.quantize_cross_kv(y)
            assert torch.equal(q, q_ref) and torch.equal(sc, sc_ref)
    again = K.cross_kv(x, w, b, d // 64, int8)
    assert all(torch.equal(a, o) for a, o in zip(again, got) if a is not None)


@pytest.mark.parametrize("items,heads,beams,s_len,kind", [
    (2, 2, 5, 6000, "int8"), (3, 2, 8, 9000, "bf16"), (2, 4, 1, 22000, "bf16"),
    (2, 2, 3, 16384, "int8"), (32, 16, 5, 16384, "int8")])
def test_dec_cross_split_kernel(dev, items, heads, beams, s_len, kind):
    """The split dec_cross_attention (S over a cluster) where the plan takes
    it: against the twin, a fully masked item and a half-masked one,
    bit-identical over two calls; every split that fits agrees with the
    plan's within one bf16 rounding."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(beams * s_len)
    args = cross_case(g, items, heads, beams, s_len, kind)
    plan = K.dec_cross_plan(beams, s_len, 1 if kind == "int8" else 2)
    assert plan.variant == "split"
    before = K.dec_cross_variant_counts()["split"]
    out = K.dec_cross_attention(*args, heads)
    assert K.dec_cross_variant_counts()["split"] == before + 1
    assert bool(torch.isfinite(out.float()).all())
    close(out, K.dec_cross_attention_plain(*args, heads), True)
    assert torch.equal(out, K.dec_cross_attention(*args, heads))
    for n in K.DEC_CROSS_SPLITS:
        other = K.dec_cross_variant_plan("split", beams, s_len, 1 if kind == "int8" else 2, n)
        if other.smem <= K.SMEM_MAX and (n - 1) * K.dec_cross_split_positions(s_len, n) < s_len:
            close(K._dec_cross_planned(other, *args, heads), out, True)


def test_dec_cross_split_matches_the_unsplit_block(dev):
    """Where both fit (5 beams at S 2000), a split over 2, 4 and 8 blocks
    against the unsplit block of the same beams."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(2000)
    for kind in ("int8", "bf16"):
        args = cross_case(g, 4, 4, 5, 2000, kind)
        one = K.dec_cross_attention(*args, 4)
        for n in K.DEC_CROSS_SPLITS:
            plan = K.dec_cross_variant_plan("split", 5, 2000, 1 if kind == "int8" else 2, n)
            close(K._dec_cross_planned(plan, *args, 4), one, True)
