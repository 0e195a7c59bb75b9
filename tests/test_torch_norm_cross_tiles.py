"""The order of work of two CUDA kernels, emulated in PyTorch on the CPU
against the plain twins that define their results, and the plans that pick
their instances (kernels/primitives.layernorm_plan) and the shared memory
dec_cross_attention's blocks take (dec_cross_smem_bytes), held to what the
launchers in csrc/layernorm.cu and csrc/dec_cross_attention.cu accept.

layernorm_warp_kernel: a warp a row; lane l keeps float4 number l + 32 i
(scalar element l + 32 i where d % 4 != 0), sums its slots in order, and the
lanes' sums meet by the xor butterfly 16, 8, 4, 2, 1; slots past d are left
out of both sums. layernorm_block_kernel: 256 threads stride over the row,
the eight warps' butterfly sums are added in warp order.

dec_cross_kernel: one block an (item, head) streams 64-position tiles of K,
then of V; a tile's scores are tensor-core sums over all 64 channels (int8 K
turned into bf16 exactly) plus the bias; the softmax runs over all S, and
the probabilities are normalised before they are rounded; P V accumulates
one 16-position step after another over all S.

Tolerances. f32 emulations differ from the twin only in the order of f32
sums: 2e-6 relative to the output's largest magnitude for LayerNorm (d up to
2048), 1e-5 for attention outputs of order one. With bf16 inputs a
probability may round the other way at a bf16 tie (the f32 softmax differs
in its last bit): an output moves by at most one bf16 ulp of a probability
times the largest |V|, so bf16 outputs are held to two bf16 ulps of the
output's largest magnitude plus 2^-8 of the largest |V| over S.
"""

import numpy as np
import pytest
import torch

from vacnic_tpu_torch.kernels import primitives as K

F32_MIN = torch.finfo(torch.float32).min


# --------------------------------------------------------------------------
# layernorm
# --------------------------------------------------------------------------

def butterfly(lanes):
    """[rows, 32] per-lane sums -> the warp's sum as every lane holds it
    (v += shfl_xor(v, o) for o = 16 .. 1), read from lane 0."""
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ o]
    return lanes[:, 0]


def warp_lane_sums(vals, d, vec, slots):
    """Per-lane sums of `vals` [rows, d] in the order a lane adds its slots,
    masked slots left out. vec: lane l slot i is the float4 at element
    4 (l + 32 i), summed ((x + y) + z) + w; else element l + 32 i."""
    rows = vals.shape[0]
    lanes = torch.zeros(rows, 32)
    for lane in range(32):
        acc = torch.zeros(rows)
        for i in range(slots if vec else 4 * slots):
            if vec:
                c = 4 * (lane + 32 * i)
                if c < d:
                    v = vals[:, c:c + 4]
                    acc = acc + (((v[:, 0] + v[:, 1]) + v[:, 2]) + v[:, 3])
            else:
                c = lane + 32 * i
                if c < d:
                    acc = acc + vals[:, c]
        lanes[:, lane] = acc
    return lanes


def ln_finish(x, mean, var, gb, eps):
    rstd = torch.rsqrt(var + eps)
    return (x - mean[:, None]) * rstd[:, None] * gb[0] + gb[1]


def warp_layernorm(x, gb, eps=1e-5, masked=True):
    """layernorm_warp_kernel's order of work; masked=False is what the
    kernel would compute if it let the zero slots past d into the variance."""
    rows, d = x.shape
    plan = K.layernorm_plan(rows, d)
    assert plan.variant == "warp"
    vec = d % 4 == 0
    mean = butterfly(warp_lane_sums(x, d, vec, plan.slots)) / d
    sq = (x - mean[:, None]).square()
    var = butterfly(warp_lane_sums(sq, d, vec, plan.slots)) / d
    if not masked:
        slots = 128 * plan.slots
        var = var + (slots - d) * mean.square() / d
    return ln_finish(x, mean, var, gb, eps)


def block_layernorm(x, gb, eps=1e-5):
    """layernorm_block_kernel's order: thread t sums the float4s (elements)
    t, t + 256, ..; each warp's butterfly; the eight warps in order."""
    rows, d = x.shape
    vec = d % 4 == 0
    n = d // 4 if vec else d

    def block_sum(vals):
        per_thread = torch.zeros(rows, 256)
        for t in range(256):
            acc = torch.zeros(rows)
            for i in range(t, n, 256):
                if vec:
                    v = vals[:, 4 * i:4 * i + 4]
                    acc = acc + (((v[:, 0] + v[:, 1]) + v[:, 2]) + v[:, 3])
                else:
                    acc = acc + vals[:, i]
            per_thread[:, t] = acc
        total = torch.zeros(rows)
        for w in range(8):
            total = total + butterfly(per_thread[:, 32 * w:32 * w + 32])
        return total

    mean = block_sum(x) / d
    var = block_sum((x - mean[:, None]).square()) / d
    return ln_finish(x, mean, var, gb, eps)


def ln_inputs(seed, rows, d):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(rows, d) * 2 + 0.5).astype(np.float32))
    gb = torch.from_numpy(np.stack([1 + 0.1 * rng.randn(d), 0.1 * rng.randn(d)]).astype(np.float32))
    return x, gb


def assert_ln_close(out, ref, rel=2e-6):
    err = float((out - ref).abs().max())
    assert err <= rel * float(ref.abs().max()), err


@pytest.mark.parametrize("d", [32, 100, 384, 765, 768, 1022, 1024])
@pytest.mark.parametrize("rows", [1, 37])
def test_warp_layernorm_matches_plain(rows, d):
    """Every slot count's mask, a scalar tail at d % 4 != 0 (100, 765, 1022)
    and a last slot only partly filled (765: 5 full float4 rows of lanes and
    a 31-lane sixth)."""
    x, gb = ln_inputs(rows + d, rows, d)
    ref, _ = K.layernorm_plain(x, gb, torch.float32)
    assert_ln_close(warp_layernorm(x, gb), ref)


def test_warp_layernorm_needs_the_mask():
    """What the mask protects: with the zero slots past d in the variance the
    result is far off the twin (d = 700: the sixth slot of 128 is 60 full)."""
    x, gb = ln_inputs(2, 4, 700)
    x = x + 3.0
    ref, _ = K.layernorm_plain(x, gb, torch.float32)
    assert_ln_close(warp_layernorm(x, gb, masked=True), ref)
    assert float((warp_layernorm(x, gb, masked=False) - ref).abs().max()) > 1e-2


@pytest.mark.parametrize("d", [1025, 1030, 2048])
def test_block_layernorm_matches_plain(d):
    x, gb = ln_inputs(d, 3, d)
    ref, _ = K.layernorm_plain(x, gb, torch.float32)
    assert_ln_close(block_layernorm(x, gb), ref)


@pytest.mark.parametrize("d,plan", [(1, ("warp", 1)), (32, ("warp", 1)), (128, ("warp", 1)),
                                    (129, ("warp", 2)), (384, ("warp", 3)), (768, ("warp", 6)),
                                    (1022, ("warp", 8)), (1024, ("warp", 8)),
                                    (1025, ("block", 0)), (4096, ("block", 0))])
def test_layernorm_plan_by_width(d, plan):
    """Each instance is reached by a width that picks it: the warp kernel
    with the fewest float4 slots a lane that cover the row, the block kernel
    past 1024."""
    assert K.layernorm_plan(160, d) == K.LayernormPlan(*plan)


@pytest.mark.parametrize("rows", [1, 160, 16384, 10 ** 6])
@pytest.mark.parametrize("d", [1, 3, 33, 1000, 1024, 1025, 5000, 65536])
def test_layernorm_plan_takes_every_shape(rows, d):
    """Any rows >= 1 and any d, as the kernel before took: the launcher's
    checks (variant 1: 1 <= slots <= 8 and exactly ceil(d / 128); variant 2:
    slots 0) hold, and the plan does not depend on the row count."""
    plan = K.layernorm_plan(rows, d)
    if plan.variant == "warp":
        assert 1 <= plan.slots <= 8 and 128 * (plan.slots - 1) < d <= 128 * plan.slots
    else:
        assert plan == K.LayernormPlan("block", 0) and d > K.LN_WARP_MAX_D
    assert plan == K.layernorm_plan(1, d)


@pytest.mark.parametrize("rows,d", [(0, 8), (4, 0)])
def test_layernorm_plan_refuses_empty(rows, d):
    with pytest.raises(ValueError, match="rows >= 1"):
        K.layernorm_plan(rows, d)


def test_cpu_layernorm_takes_the_twin_and_counts_nothing():
    x, gb = ln_inputs(0, 5, 64)
    K.reset_launch_counts()
    y32, y16 = K.layernorm(x, gb, torch.bfloat16)
    p32, p16 = K.layernorm_plain(x, gb, torch.bfloat16)
    assert torch.equal(y32, p32) and torch.equal(y16, p16)
    assert K.launch_counts()["layernorm"] == 0
    assert K.layernorm_variant_counts() == {"warp": 0, "block": 0}


# --------------------------------------------------------------------------
# dec_cross_attention
# --------------------------------------------------------------------------

def tiled_dec_cross(q, ck, cv, ks, vs, bias, heads):
    """dec_cross_kernel's order of work: scores tile by tile (64 positions,
    sums over all 64 channels), plus the bias; the softmax over all S; the
    normalised probabilities rounded to the inputs' dtype; P V accumulated
    one 16-position step after another over all S."""
    dt = q.dtype
    b, _, hd, s_len = ck.shape
    beams = q.shape[0] // b
    qh = (q.float() * hd ** -0.5).to(dt).reshape(b, beams, heads, hd)
    if ks is not None:
        qh = (qh.float() * ks.float()[:, None]).to(dt)
    q32 = qh.float()
    tiles = [torch.einsum("bkhd,bhdn->bkhn", q32, ck[..., lo:lo + 64].float())
             for lo in range(0, s_len, 64)]
    s = torch.cat(tiles, -1) + bias.float()[:, None, None, :]
    m = s.amax(-1, keepdim=True)
    inv = 1.0 / torch.exp(s - m).sum(-1, keepdim=True)
    p = (torch.exp(s - m) * inv).to(dt).float()
    out = torch.zeros(b, beams, heads, hd)
    for c in range(0, s_len, 16):  # one mma k-step after another
        out = out + torch.einsum("bkhn,bhdn->bkhd", p[..., c:c + 16], cv[..., c:c + 16].float())
    if vs is not None:
        out = out * vs.float()[:, None]
    return out.to(dt).reshape(b * beams, heads * hd)


def cross_inputs(seed, b, beams, heads, s_len, kind, dt):
    """Item 0 has every key masked, item 1 the first half of them."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b * beams, heads * 64).astype(np.float32)).to(dt)
    shape = (b, heads, 64, s_len)
    if kind == "int8":
        ck, cv = (torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8)) for _ in range(2))
        ks, vs = (torch.from_numpy((np.abs(rng.randn(b, heads, 64)) * 0.01 + 1e-3)
                                   .astype(np.float32)) for _ in range(2))
    else:
        ck, cv = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dt) for _ in range(2))
        ks = vs = None
    keep = np.full((b, 1), s_len)
    keep[0] = 0
    if b > 1:
        keep[1] = (s_len + 1) // 2
    bias = torch.from_numpy(np.where(np.arange(s_len)[None, :] < keep, 0.0, F32_MIN)
                            .astype(np.float32))
    return q, ck, cv, ks, vs, bias


def assert_cross_close(out, ref, cv, vs):
    err = float((out.float() - ref.float()).abs().max())
    top = float(ref.float().abs().max())
    if ref.dtype == torch.float32:
        assert err <= 1e-5 * max(top, 1.0), err
    else:
        vmax = float(cv.float().abs().max()) * (float(vs.max()) if vs is not None else 1.0)
        ulp = float(torch.exp2(torch.floor(torch.log2(torch.tensor(top))) - 7))
        assert err <= 2 * ulp + vmax * 2.0 ** -8, (err, ulp)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("beams", [1, 5, 8])
@pytest.mark.parametrize("s_len", [1, 40, 63, 64, 65, 130, 512, 1000])
def test_tiled_matches_plain(s_len, beams, dt, kind):
    """One tile, a ragged last tile (40, 63, 65, 130, 1000), whole tiles (64,
    512), the fully masked item, int8 with its scales and bf16 K/V, in f32
    and bf16."""
    if kind == "bf16" and dt == torch.float32:
        kind = "f32"  # the K/V take the inputs' dtype
    q, ck, cv, ks, vs, bias = cross_inputs(s_len * 10 + beams, 3, beams, 2, s_len, kind, dt)
    out = tiled_dec_cross(q, ck, cv, ks, vs, bias, 2)
    assert_cross_close(out, K.dec_cross_attention_plain(q, ck, cv, ks, vs, bias, 2), cv, vs)
    # the fully masked item attends uniformly, as the twin's softmax does
    uniform = cv[0].float().mean(-1) * (vs[0] if vs is not None else 1.0)  # [H, 64]
    got = out.float().reshape(3, beams, 2, 64)[0]
    assert float((got - uniform[None].to(dt).float()).abs().max()) <= (
        1e-5 if dt == torch.float32 else 2e-2 * max(1.0, float(uniform.abs().max())))


def test_int8_to_bf16_is_exact():
    """The kernel's conversion of every int8 value: its byte XOR 0x80 as the
    low mantissa byte of 2^23, minus 2^23 + 128, gives the value in f32, and
    the top half of those f32 bits is the value's bf16."""
    v = np.arange(-128, 128, dtype=np.int64)
    u = (v & 0xFF) ^ 0x80
    f = (np.uint32(0x4B000000) | u.astype(np.uint32)).view(np.float32) - np.float32(8388736.0)
    assert np.array_equal(f, v.astype(np.float32))
    top = (f.view(np.uint32) >> 16).astype(np.uint16)
    bf = torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16).view(torch.int16).numpy()
    assert np.array_equal(top, bf.view(np.uint16))
    assert not np.any(f.view(np.uint32) & 0xFFFF)  # nothing is lost in the low half


def byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4 i) & 7 of
    the eight bytes x (0-3) then y (4-7)."""
    both = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(both[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def quad_to_bf16(w):
    """csrc/dec_cross_attention.cu's quad_to_bf16: four int8 -> two words of
    bf16 pairs, the lower byte in the low half."""
    u = w ^ 0x80808080
    f = [np.array([0x4B000000 | byte_perm(u, 0x4B000000, 0x7440 + i) & 0xFF],
                  np.uint32).view(np.float32)[0] - np.float32(8388736.0) for i in range(4)]
    top = [int(np.array([v], np.float32).view(np.uint32)[0]) >> 16 for v in f]
    return top[0] | top[1] << 16, top[2] | top[3] << 16


def bf16_bits(v):
    return int(torch.tensor([float(v)]).to(torch.bfloat16).view(torch.int16).item()) & 0xFFFF


def test_wide_int8_operands_in_registers():
    """The wide block's int8 operands, made in the lanes' registers. K:
    ldmatrix.trans of byte pairs hands lane (g, t) of an 8-channel x
    16-position matrix the word (K[2t][2g], K[2t][2g+1], K[2t+1][2g],
    K[2t+1][2g+1]); byte_perm 0x3120 and the quad conversion must give the
    bf16 pairs of channels 2t, 2t + 1 at position 2g and at 2g + 1, the A
    rows g and g + 8. V: the byte pairs at positions 2t and 2t + 8 of a
    channel row, one word, must give that row's pairs (2t, 2t + 1) and (2t +
    8, 2t + 9), the k slots of the bf16 kernel's operands."""
    rng = np.random.RandomState(5)
    k = rng.randint(-128, 128, (8, 16))
    kb = k.astype(np.int64) & 0xFF
    for g in range(8):
        for t in range(4):
            w = (kb[2 * t][2 * g] | kb[2 * t][2 * g + 1] << 8 | kb[2 * t + 1][2 * g] << 16
                 | kb[2 * t + 1][2 * g + 1] << 24)
            x, y = quad_to_bf16(byte_perm(int(w), 0, 0x3120))
            for word, pos in ((x, 2 * g), (y, 2 * g + 1)):
                assert word & 0xFFFF == bf16_bits(k[2 * t][pos])
                assert word >> 16 == bf16_bits(k[2 * t + 1][pos])
    v = rng.randint(-128, 128, 16)
    vb = v.astype(np.int64) & 0xFF
    for t in range(4):
        lo = vb[2 * t] | vb[2 * t + 1] << 8
        hi = vb[2 * t + 8] | vb[2 * t + 9] << 8
        x, y = quad_to_bf16(int(lo | hi << 16))
        assert (x & 0xFFFF, x >> 16) == (bf16_bits(v[2 * t]), bf16_bits(v[2 * t + 1]))
        assert (y & 0xFFFF, y >> 16) == (bf16_bits(v[2 * t + 8]), bf16_bits(v[2 * t + 9]))


@pytest.mark.parametrize("elem_bytes", [1, 2], ids=["int8", "bf16"])
def test_main_path_is_one_resident_wave(elem_bytes):
    """Five beams over the 512 article tokens: four blocks fit a SM's 228 KB
    (1 KB a block reserved), so the 32 x 16 = 512 (item, head) blocks are one
    wave on the 132 SMs and every block streams from start to end."""
    smem = K.dec_cross_smem_bytes(5, 512, elem_bytes)
    assert 4 * (smem + 1024) <= 228 * 1024 and 132 * 4 >= 32 * 16


@pytest.mark.parametrize("elem_bytes", [1, 2], ids=["int8", "bf16"])
@pytest.mark.parametrize("beams", range(1, 9))
def test_takes_what_the_kernel_before_took(beams, elem_bytes):
    """The kernel before kept [beams][64 + S] f32 in 48 KB of shared memory:
    every S up to 12288 / beams - 64 still fits a block."""
    for s_len in (1, 15, 16, 17, 40, 130, 511, 512, 513, 12288 // beams - 64):
        assert K.dec_cross_smem_bytes(beams, s_len, elem_bytes) <= K.SMEM_MAX


def test_refuses_what_no_block_holds():
    assert K.dec_cross_smem_bytes(8, 16384, 2) > K.SMEM_MAX


def test_cpu_dec_cross_takes_the_twin_and_counts_nothing():
    q, ck, cv, ks, vs, bias = cross_inputs(3, 2, 5, 2, 40, "int8", torch.float32)
    K.reset_launch_counts()
    out = K.dec_cross_attention(q, ck, cv, ks, vs, bias, 2)
    assert torch.equal(out, K.dec_cross_attention_plain(q, ck, cv, ks, vs, bias, 2))
    assert K.launch_counts()["dec_cross_attention"] == 0
