"""The plan that picks kernel and split of a gemm_bf16 product
(kernels/primitives.gemm_plan), held to what the CUDA launcher
(csrc/gemm_bf16.cu, vt_gemm_bf16) accepts, and the split-K order of its
small-M and mid-M kernels, emulated in PyTorch on the CPU against the plain
twin that defines the result: block r of a cluster accumulates the k tiles
[r per, (r + 1) per) of 64 in f32; the partial tiles are summed in rank
order 0, 1, ..; then bias -> gelu -> residual -> rounding. The gelu is not
linear, so nothing of the epilogue may touch a partial sum. The mid-M
kernel does this on 128-row tiles of 64 or 128 columns, what lies past M, N
and K read as zeros, block r of a tile finishing its 128 / split rows.

Tolerances. The emulations differ from the twin only in the order of the f32
sums: 1e-5 on f32 outputs of order one (K up to 1024, inputs of std 1 and
0.05); a bf16 output may round the other way: one bf16 ulp at the tensor's
largest magnitude.
"""

import itertools

import numpy as np
import pytest
import torch

from vacnic_tpu_torch.kernels import primitives as K

BK = K.GEMM_BK


def k_tiles(a, w, first, count):
    """f32 sum over k tiles first .. first + count - 1, as one block accumulates."""
    lo, hi = first * BK, min((first + count) * BK, a.shape[1])
    if lo >= hi:
        return torch.zeros(a.shape[0], w.shape[1])
    return a[:, lo:hi].float() @ w[lo:hi].float()


def epilogue(y, bias, residual, act, out_dtype):
    if bias is not None:
        y = y + bias.float()
    if act == K.GELU:
        y = torch.nn.functional.gelu(y, approximate="none")
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def split_k_gemm(a, w, bias, residual, act, out_dtype, split):
    """gemm_small_kernel: partial tiles by cluster rank, combined in rank order."""
    n_tiles = -(-a.shape[1] // BK)
    per = -(-n_tiles // split)
    partials = [k_tiles(a, w, r * per, max(0, min(per, n_tiles - r * per))) for r in range(split)]
    total = torch.zeros_like(partials[0])
    for p in partials:  # always 0, 1, ..: the result does not depend on timing
        total = total + p
    return epilogue(total, bias, residual, act, out_dtype)


def mid_m_gemm(a, w, bias, residual, act, out_dtype, plan):
    """gemm_mid_kernel: A and W zero-filled past M, N and K to whole tiles
    (TMA's fill), each 128 x bn output tile's `split` partial tiles by
    cluster rank, block r summing rows [r 128 / split, (r + 1) 128 / split)
    over the ranks in rank order, then the epilogue, only rows < M and
    columns < N stored."""
    m, k = a.shape
    n = w.shape[1]
    bm, bn = K.GEMM_MID_BM, plan.bn
    mp, np_, kp = -(-m // bm) * bm, -(-n // bn) * bn, -(-k // BK) * BK
    ap = torch.zeros(mp, kp)
    ap[:m, :k] = a.float()
    wp = torch.zeros(kp, np_)
    wp[:k, :n] = w.float()
    n_tiles, rows = kp // BK, bm // plan.split
    per = -(-n_tiles // plan.split)
    out = torch.full((m, n), float("nan")).to(out_dtype)
    for m0 in range(0, mp, bm):
        for n0 in range(0, np_, bn):
            parts = [k_tiles(ap[m0:m0 + bm], wp[:, n0:n0 + bn], r * per,
                             max(0, min(per, n_tiles - r * per))) for r in range(plan.split)]
            c1 = min(n0 + bn, n)
            for r in range(plan.split):
                lo = m0 + r * rows
                hi = min(lo + rows, m)
                if lo >= m:
                    continue
                total = torch.zeros(rows, bn)
                for p in parts:  # always 0, 1, ..
                    total = total + p[r * rows:(r + 1) * rows]
                out[lo:hi, n0:c1] = epilogue(
                    total[:hi - lo, :c1 - n0], None if bias is None else bias[n0:c1],
                    None if residual is None else residual[lo:hi, n0:c1], act, out_dtype)
    return out


def assert_close(out, ref):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    err = float((out.float() - ref.float()).abs().max())
    if ref.dtype == torch.float32:
        assert err <= 1e-5, err
    else:
        ulp = float(torch.exp2(torch.floor(torch.log2(ref.float().abs().max())) - 7))
        assert err <= ulp, (err, ulp)


def inputs(seed, m, k, n, dt):
    rng = np.random.RandomState(seed)
    a = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dt)
    w = torch.from_numpy((rng.randn(k, n) * 0.05).astype(np.float32)).to(dt)
    bias = torch.from_numpy(rng.randn(n).astype(np.float32))
    res = torch.from_numpy(rng.randn(m, n).astype(np.float32))
    return a, w, bias, res


EPILOGUES = list(itertools.product((False, True), (False, True), (None, K.GELU),
                                   (torch.float32, torch.bfloat16)))


def epilogue_id(e):
    return "-".join(("bias" if e[0] else "nobias", "res" if e[1] else "nores", e[2] or "noact",
                     "f32" if e[3] == torch.float32 else "bf16"))


@pytest.mark.parametrize("epi", EPILOGUES, ids=epilogue_id)
@pytest.mark.parametrize("m,split", [(37, 2), (161, 4)])
def test_split_k_matches_plain(m, split, epi):
    has_bias, has_res, act, out = epi
    a, w, bias, res = inputs(m + split, m, 1024, 128, torch.bfloat16)
    b, r = (bias if has_bias else None), (res if has_res else None)
    assert_close(split_k_gemm(a, w, b, r, act, out, split), K.gemm_plain(a, w, b, r, act, out))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k,split", [(32, 1), (96, 2), (320, 4)])
def test_split_k_slabs_and_k_tail(k, split, dt):
    """A k tail of 32 in the last tile, slabs that do not divide the tiles
    evenly (5 tiles over 4 blocks: the last block gets none) and inputs of
    both dtypes the twin takes."""
    a, w, bias, res = inputs(k, 37, k, 64, dt)
    for act, out in ((K.GELU, torch.float32), (None, torch.bfloat16)):
        assert_close(split_k_gemm(a, w, bias, res, act, out, split),
                     K.gemm_plain(a, w, bias, res, act, out))


MID_PLANS = [K.GemmPlan("mid_m", split, bn) for bn in (64, 128) for split in (1, 2, 4)]


def plan_id(plan):
    return f"bn{plan.bn}-split{plan.split}"


@pytest.mark.parametrize("plan", MID_PLANS, ids=plan_id)
@pytest.mark.parametrize("epi", EPILOGUES, ids=epilogue_id)
def test_mid_m_matches_plain(epi, plan):
    """M 320 (the last row tile's second warpgroup past M), K 288 (five k
    tiles, the last a tail of 32: split 4 gives slabs of 2, 2, 1, 0) and N
    192 (N % 128 == 64: a half-empty last 128-column tile)."""
    has_bias, has_res, act, out = epi
    a, w, bias, res = inputs(320 + plan.bn + plan.split, 320, 288, 192, torch.bfloat16)
    b, r = (bias if has_bias else None), (res if has_res else None)
    assert_close(mid_m_gemm(a, w, b, r, act, out, plan), K.gemm_plain(a, w, b, r, act, out))


@pytest.mark.parametrize("plan", MID_PLANS, ids=plan_id)
@pytest.mark.parametrize("m", [257, 383])
def test_mid_m_ragged_rows(m, plan):
    """257: one live row in the last tile's first warpgroup; 383: the last
    tile's second warpgroup with 63 live rows. K 1056 % 64 == 32, N 1088 %
    128 == 64, inputs of both dtypes the twin takes."""
    for dt in (torch.float32, torch.bfloat16):
        a, w, bias, res = inputs(m + plan.split, m, 1056, 1088, dt)
        for act, out in ((K.GELU, torch.float32), (None, torch.bfloat16)):
            assert_close(mid_m_gemm(a, w, bias, res, act, out, plan),
                         K.gemm_plain(a, w, bias, res, act, out))


def test_epilogue_before_the_sum_would_be_wrong():
    """What the order protects: a gelu applied to the partial sums differs
    from the twin by far more than the tolerance."""
    a, w, bias, _ = inputs(3, 64, 256, 64, torch.float32)
    n_tiles = 256 // BK
    wrong = sum(torch.nn.functional.gelu(k_tiles(a, w, r, 1) + bias / n_tiles)
                for r in range(n_tiles))
    ref = K.gemm_plain(a, w, bias, None, K.GELU, torch.float32)
    assert float((wrong - ref).abs().max()) > 1e-2
    assert_close(split_k_gemm(a, w, bias, None, K.GELU, torch.float32, n_tiles), ref)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

D, F = 1024, 4096
LAYER_PRODUCTS = {"qkv": (D, 3 * D), "self_out": (D, D), "cross_q": (D, D), "cross_out": (D, D),
                  "fc1": (D, F), "fc2": (F, D)}  # name -> (K, N), six a layer


def launcher_accepts(plan, m, n, k):
    """The checks of vt_gemm_bf16 on what the wrapper passes down."""
    assert plan.variant in K.GEMM_VARIANTS
    if plan.variant == "small_m":
        assert m <= 256 and plan.split in (1, 2, 4) and plan.bn == 0
        assert (64 * -(-m // 64)) % plan.split == 0  # the rows each block of a cluster finishes
    elif plan.variant == "mid_m":
        assert plan.split in (1, 2, 4) and plan.bn in (64, 128)
        assert -(-m // K.GEMM_MID_BM) * plan.split <= 65535  # the grid's y extent
    else:
        assert plan.split == 1 and plan.bn == 0


def small_m_blocks(plan, n):
    return n // 64 * plan.split  # a 64-column slab a block, `split` blocks along K


@pytest.mark.parametrize("name", LAYER_PRODUCTS)
@pytest.mark.parametrize("m", [160, 40], ids=["batch32x5", "batch8x5"])
def test_plan_decode_products(name, m):
    """The decoder's products take the split-K kernel (one block covers every
    row), the k slabs divide K evenly, and the grid is one wave of the
    132 SMs, 64 blocks or more and never over 132 (a block takes an SM's
    whole shared memory, so a second wave waits for the first; measured
    1.5-2x slower, see PERF.md)."""
    k, n = LAYER_PRODUCTS[name]
    plan = K.gemm_plan(m, n, k)
    launcher_accepts(plan, m, n, k)
    assert plan.variant == "small_m" and m <= K.GEMM_SMALL_M_MAX
    assert (k // BK) % plan.split == 0
    assert 64 <= small_m_blocks(plan, n) <= K.GEMM_SMS
    assert plan.split <= 4  # clusters of 8 are not placed 16 at a time


def mid_m_max_blocks(m, n, k):
    """The most blocks any mid_m plan of the shape has."""
    k_tiles = -(-k // BK)
    return -(-m // K.GEMM_MID_BM) * (n // 64) * max(s for s in (1, 2, 4) if k_tiles % s == 0)


@pytest.mark.parametrize("name", LAYER_PRODUCTS)
@pytest.mark.parametrize("m", [320, 512, 640, 1280, 513, 1024],
                         ids=["batch64x5", "batch32x16-or-enc-batch1", "batch128x5",
                              "batch256x5", "ragged513", "enc-batch2"])
def test_plan_mid_products(name, m):
    """The decoder's products at BK 320-1280 (batch 64-256 x beam 5, 32 x 16
    beams) and the encoder's at batch 1 and 2 (M 512 and 1024; 513
    ragged) take the 128-row TMA kernel with split-K: slabs that divide the
    k tiles, clusters of at most 4, and a grid of at least
    GEMM_MID_MIN_BLOCKS (128 of the 132 SMs) wherever a plan of the shape
    has one."""
    k, n = LAYER_PRODUCTS[name]
    plan = K.gemm_plan(m, n, k)
    launcher_accepts(plan, m, n, k)
    assert plan.variant == "mid_m" and K.GEMM_SMALL_M_MAX < m <= K.GEMM_MID_M_MAX
    assert (k // BK) % plan.split == 0 and plan.split <= 4
    if mid_m_max_blocks(m, n, k) >= K.GEMM_MID_MIN_BLOCKS:
        assert K.mid_m_blocks(plan, m, n) >= K.GEMM_MID_MIN_BLOCKS


@pytest.mark.parametrize("m,variant", [(256, "small_m"), (257, "mid_m"), (1280, "mid_m"),
                                       ("max", "mid_m"), ("max+1", "large_m"),
                                       (32 * 512, "large_m")])
def test_plan_boundaries(m, variant):
    """small_m up to 256 rows, mid_m from 257 to GEMM_MID_M_MAX (at least
    the decoder's 1280 at batch 256 x beam 5), large_m past it and at batch
    32's 16384 encoder rows, for each of a layer's products."""
    assert K.GEMM_MID_M_MAX >= 1280
    m = {"max": K.GEMM_MID_M_MAX, "max+1": K.GEMM_MID_M_MAX + 1}.get(m, m)
    for k, n in LAYER_PRODUCTS.values():
        plan = K.gemm_plan(m, n, k)
        launcher_accepts(plan, m, n, k)
        assert plan.variant == variant


@pytest.mark.parametrize("name", LAYER_PRODUCTS)
def test_plan_encoder_products(name):
    """The encoder's products take the TMA kernel, whole."""
    k, n = LAYER_PRODUCTS[name]
    plan = K.gemm_plan(32 * 512, n, k)
    launcher_accepts(plan, 32 * 512, n, k)
    assert plan == K.GemmPlan("large_m", 1)


@pytest.mark.parametrize("n,k,split", [(1024, 1024, 4), (4096, 1024, 2), (3072, 1024, 2),
                                       (133 * 64, 1024, 1), (1024, 128, 2), (64, 32, 1),
                                       (64, 192, 1), (384, 256, 4)])
def test_plan_split_by_shape(n, k, split):
    """Every split the small-M kernel has is reached by a shape: the largest
    of 1, 2, 4 that divides the k tiles within one wave of blocks."""
    assert K.gemm_plan(160, n, k) == K.GemmPlan("small_m", split)


@pytest.mark.parametrize("m", [1, 37, 64, 65, 160, 256, 257, 1280, 2047, 2048, 16384 + 5])
@pytest.mark.parametrize("k,n", [(32, 64), (96, 192), (256, 384), (4096, 1024), (1024, 53248)])
def test_every_accepted_shape_has_a_plan(m, k, n):
    """K % 32 == 0 and N % 64 == 0 with any M: what gemm took before the
    redesign it still takes, by shape alone."""
    plan = K.gemm_plan(m, n, k)
    launcher_accepts(plan, m, n, k)
    assert plan.variant == ("small_m" if m <= K.GEMM_SMALL_M_MAX else
                            "mid_m" if m <= K.GEMM_MID_M_MAX else "large_m")
    if plan.variant == "small_m" and plan.split > 1:
        assert small_m_blocks(plan, n) <= K.GEMM_SMS
    if plan.variant == "mid_m" and mid_m_max_blocks(m, n, k) >= K.GEMM_MID_MIN_BLOCKS:
        assert K.mid_m_blocks(plan, m, n) >= K.GEMM_MID_MIN_BLOCKS


@pytest.mark.parametrize("m,k,n", [(0, 64, 64), (8, 48, 64), (8, 0, 64), (8, 64, 96), (8, 64, 0)])
def test_plan_refuses_other_shapes(m, k, n):
    with pytest.raises(ValueError, match="K % 32 == 0 and N % 64 == 0"):
        K.gemm_plan(m, n, k)


def test_cpu_gemm_takes_the_twin_and_counts_nothing():
    a, w, bias, res = inputs(0, 5, 64, 64, torch.float32)
    K.reset_launch_counts()
    out = K.gemm(a, w, bias, res, K.GELU, torch.float32)
    assert torch.equal(out, K.gemm_plain(a, w, bias, res, K.GELU, torch.float32))
    assert K.launch_counts()["gemm_bf16"] == 0
    assert K.gemm_variant_counts() == {"large_m": 0, "small_m": 0, "mid_m": 0}
