"""The order of work of csrc/dec_attention.cu's dec_self_kernel, emulated in
PyTorch on the CPU against kernels/primitives.dec_self_attention_plain, the
twin that defines its result, for the bf16, int8 and fp8 self caches; and
the shared memory its launcher asks for, held to the card's limit.

dec_self_kernel: a warp a (beam row, head). Lane (g, c) = (lane / 8,
lane % 8) holds channels 8c .. 8c + 7 of the rows t = g, g + 4, ...: its
partial score is a product chain over its eight channels, and a row's score
is the butterfly sum (xor 4, 2, 1) over the row's eight lanes, times the
row's K scale for int8. The step's own row (t == pos) comes from qkv,
unscaled. The softmax: the exact max, lane l summing exp over t = l,
l + 32, ..., the lanes' sums meeting by the butterfly 16 .. 1, the
normalised probabilities rounded to the inputs' dtype. P V: row group g sums
t = g, g + 4, ... < pos in order (int8: the probability times the row's V
scale, then times the value), and group pos % 4 adds the step's own row
last; the groups' partial outputs meet as (g0 + g1) + (g2 + g3).

Tolerances, as for the other attention emulations: f32 outputs within 1e-5
of the output's largest magnitude (sum order only); bf16 outputs within two
bf16 ulps of it plus 2^-8 of the largest |V| (a probability may round the
other way at a bf16 tie). Power-of-two int8 scales give the emulation on
the dequantized cache bit for bit.
"""

import numpy as np
import pytest
import torch

from vacnic_tpu_torch.infer.decode_fast import to_fp8
from vacnic_tpu_torch.kernels import primitives as K


def butterfly(lanes, width):
    """[..., width] per-lane values -> the sum lane 0 holds after
    v += shfl_xor(v, o) for o = width / 2 .. 1."""
    idx = torch.arange(width)
    o = width // 2
    while o:
        lanes = lanes + lanes[..., idx ^ o]
        o //= 2
    return lanes[..., 0]


def tiled_dec_self(qkv, ck, cv, anc, pos, heads, ks=None, vs=None):
    dt = qkv.dtype
    bk = qkv.shape[0]
    d = qkv.shape[1] // 3
    q = (qkv[:, :d].float() * 64 ** -0.5).to(dt).float().reshape(bk, heads, 8, 8)

    def lanes(x):  # [BK, d] -> [BK, H, 8 lanes, 8 channels] f32
        return x.float().reshape(bk, heads, 8, 8)

    def score(k):
        part = q[..., 0] * k[..., 0]
        for j in range(1, 8):
            part = part + q[..., j] * k[..., j]
        return butterfly(part, 8)  # [BK, H]

    def row(cache, t):
        return cache[t, anc[t].long()]

    s = torch.empty(bk, heads, pos + 1)
    for t in range(pos):
        s[..., t] = score(lanes(row(ck, t)))
        if ks is not None:
            s[..., t] = s[..., t] * row(ks, t).float()
    s[..., pos] = score(lanes(qkv[:, d:2 * d]))
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    lane_sums = torch.zeros(bk, heads, 32)
    for t in range(pos + 1):
        lane_sums[..., t % 32] += e[..., t]
    p = (e * (1.0 / butterfly(lane_sums, 32))[..., None]).to(dt).float()

    parts = []
    for g in range(4):
        acc = torch.zeros(bk, heads, 64)
        for t in range(g, pos, 4):
            pt = p[..., t] if vs is None else p[..., t] * row(vs, t).float()
            acc = acc + pt[..., None] * row(cv, t).float().reshape(bk, heads, 64)
        if pos % 4 == g:
            acc = acc + p[..., pos, None] * qkv[:, 2 * d:].float().reshape(bk, heads, 64)
        parts.append(acc)
    return ((parts[0] + parts[1]) + (parts[2] + parts[3])).to(dt).reshape(bk, d)


def self_inputs(seed, bk, heads, t_len, kind, dt):
    """qkv in dt; a cache of the kind (bf16: the inputs' dtype; int8 with
    per-row scales; fp8 e4m3 of values up to a few units) and a random
    ancestry over all rows."""
    rng = np.random.RandomState(seed)
    d = heads * 64
    qkv = torch.from_numpy(rng.randn(bk, 3 * d).astype(np.float32)).to(dt)
    shape = (t_len, bk, d)
    ks = vs = None
    if kind == "int8":
        ck, cv = (torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8)) for _ in range(2))
        ks, vs = (torch.from_numpy((np.abs(rng.randn(t_len, bk, heads)) * 0.01 + 1e-3)
                                   .astype(np.float32)) for _ in range(2))
    elif kind == "fp8":
        ck, cv = (to_fp8(torch.from_numpy(rng.randn(*shape).astype(np.float32) * 2))
                  for _ in range(2))
    else:
        ck, cv = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dt) for _ in range(2))
    anc = torch.from_numpy(rng.randint(0, bk, (t_len, bk)).astype(np.int32))
    return qkv, ck, cv, anc, ks, vs


def assert_self_close(out, ref, cv, vs):
    err = float((out.float() - ref.float()).abs().max())
    top = float(ref.float().abs().max())
    if ref.dtype == torch.float32:
        assert err <= 1e-5 * max(top, 1.0), err
    else:
        vmax = float(cv.float().abs().max()) * (float(vs.max()) if vs is not None else 1.0)
        ulp = float(torch.exp2(torch.floor(torch.log2(torch.tensor(top))) - 7))
        assert err <= 2 * ulp + vmax * 2.0 ** -8, (err, ulp)


@pytest.mark.parametrize("pos", [0, 5, 15])
@pytest.mark.parametrize("bk,heads", [(1, 4), (7, 4), (160, 16)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_tiled_matches_plain(kind, dt, bk, heads, pos):
    """The step's row alone (pos 0), an odd pos, pos = T - 1; one row, an
    odd row count, the main path's 160 rows of 16 heads; in f32 and bf16."""
    args = self_inputs(pos * 100 + bk + heads, bk, heads, 16, kind, dt)
    out = tiled_dec_self(*args[:4], pos, heads, *args[4:])
    ref = K.dec_self_attention_plain(*args[:4], pos, heads, *args[4:])
    assert out.dtype == dt
    assert_self_close(out, ref, args[2], args[5])


def test_tiled_at_the_main_path_shape():
    """BK 160 x 16 heads, T 64, pos 49: the slice's last steps, in bf16."""
    for kind in ("bf16", "int8", "fp8"):
        args = self_inputs(49, 160, 16, 64, kind, torch.bfloat16)
        assert_self_close(tiled_dec_self(*args[:4], 49, 16, *args[4:]),
                          K.dec_self_attention_plain(*args[:4], 49, 16, *args[4:]),
                          args[2], args[5])


def pow2_pair(seed, bk, heads, t_len, dt):
    """An int8 cache with power-of-two per-row scales, and the cache of its
    dequantized values in dt (exact: at most seven significant bits)."""
    qkv, ck, cv, anc, _, _ = self_inputs(seed, bk, heads, t_len, "int8", dt)
    rng = np.random.RandomState(seed + 1)
    ks, vs = (torch.from_numpy((2.0 ** rng.randint(-3, 3, (t_len, bk, heads))).astype(np.float32))
              for _ in range(2))

    def deq(c, s):
        return (c.float().reshape(t_len, bk, heads, 64) * s[..., None]).reshape(c.shape).to(dt)

    return (qkv, ck, cv, anc, ks, vs), (qkv, deq(ck, ks), deq(cv, vs), anc)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pos", [1, 6, 15])
def test_int8_pow2_is_the_dequantized_cache(dt, pos):
    """Power-of-two scales commute with every rounding of the recipe: the
    kernel's order of work on the int8 cache equals it on the dequantized
    cache bit for bit, and so does the twin."""
    (qkv, ck, cv, anc, ks, vs), deq = pow2_pair(pos, 9, 8, 16, dt)
    assert torch.equal(tiled_dec_self(qkv, ck, cv, anc, pos, 8, ks, vs),
                       tiled_dec_self(*deq, pos, 8))
    assert torch.equal(K.dec_self_attention_plain(qkv, ck, cv, anc, pos, 8, ks, vs),
                       K.dec_self_attention_plain(*deq, pos, 8))


def test_fp8_cache_is_its_values():
    """An fp8 cache reads as the f32 cache of its values."""
    qkv, ck, cv, anc, _, _ = self_inputs(3, 10, 4, 16, "fp8", torch.float32)
    assert torch.equal(K.dec_self_attention_plain(qkv, ck, cv, anc, 9, 4),
                       K.dec_self_attention_plain(qkv, ck.float(), cv.float(), anc, 9, 4))


@pytest.mark.parametrize("elem_bytes", [2, 1], ids=["bf16", "int8_fp8"])
def test_shared_memory_fits_at_the_longest_cache(elem_bytes):
    """T = 4096, the longest cache the wrapper takes, fits a block (the
    launcher raises the limit to that size once per device); at the main
    path's T = 64 five blocks fit a SM's 228 KB (1 KB a block reserved), so
    shared memory leaves the 160 x 4 blocks one wave on the 132 SMs."""
    longest = K.dec_self_smem_bytes(K.DEC_SELF_MAX_T, elem_bytes)
    assert longest == 4 * (64 * 64 * elem_bytes + 256 + 8 * 4096) <= K.SMEM_MAX
    for t_len in range(1, 70):  # every warp's region starts on 16 bytes
        assert K.dec_self_smem_bytes(t_len, elem_bytes) % 64 == 0
    assert 5 * (K.dec_self_smem_bytes(64, elem_bytes) + 1024) <= 228 * 1024
    assert 5 * 132 >= 160 * 16 // 4


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_cpu_dec_self_takes_the_twin_and_counts_nothing(kind):
    qkv, ck, cv, anc, ks, vs = self_inputs(4, 6, 4, 16, kind, torch.float32)
    K.reset_launch_counts()
    out = K.dec_self_attention(qkv, ck, cv, anc, 7, 4, ks, vs)
    assert torch.equal(out, K.dec_self_attention_plain(qkv, ck, cv, anc, 7, 4, ks, vs))
    assert K.launch_counts()["dec_self_attention"] == 0
    assert K.dec_self_variant_counts() == {"bf16": 0, "int8": 0, "fp8": 0}
