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
    """Ragged rows through both kernels (M <= 256: split-K cluster; above:
    TMA tiles), a k tail of 32, a last column tile
    half empty, every epilogue kind, against the twin; the launch counts by
    kernel move with the plan."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(m * 7 + n)
    a, w = rn(g, m, k, dtype=torch.bfloat16), rn(g, k, n, std=0.05, dtype=torch.bfloat16)
    b, r = rn(g, n), rn(g, m, n)
    variant = K.gemm_plan(m, n, k).variant
    assert variant == ("small_m" if m <= 256 else "large_m")
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
    only)."""
    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device=dev).manual_seed(5)
    for m, k, n in ((257, 64, 128), (256 * 3 + 5, 320, 384), (700, 1024, 1024)):
        assert K.gemm_plan(m, n, k).variant == "large_m"
        a, w = rn(g, m, k, dtype=torch.bfloat16), rn(g, k, n, std=0.05, dtype=torch.bfloat16)
        close(K.gemm(a, w), a.float() @ w.float(), False)
        b, r = rn(g, n), rn(g, m, n)
        close(K.gemm(a, w, b, r, K.GELU, torch.bfloat16),
              K.gemm_plain(a, w, b, r, K.GELU, torch.bfloat16), True)


@pytest.mark.parametrize("m", [1, 64, 65, 160, 256, 257, 16384])
def test_gemm_shared_memory_fits_a_block(dev, m):
    """The ring (and, for large M, its barriers) of the kernel a shape takes,
    as the built library states it, fits the 227 KB a block can have and holds
    at least three slots of (rows + 64 columns) x 64 k in bf16."""
    from vacnic_tpu_torch.kernels import primitives as K

    smem = K.gemm_smem_bytes(m, 1024, 1024)
    rows, cols = (256, 128) if m > 256 else (64 * -(-m // 64), 64)
    assert 3 * (rows + cols) * 64 * 2 <= smem <= 232448


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
