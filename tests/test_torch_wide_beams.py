"""Decoding past 8 beams: the port against the JAX package on the CPU, and the
launch plan of dec_cross_attention's groups of 8 beams.

(a) One kernel decode step (infer/decode_fast.decode_step_kernel, the
    stack's plain twins on the CPU) at 11 beams against JAX's
    decode_step_pallas in interpret mode, on tests/test_decode_kernel.py's
    wide-beam inputs (d 128, 2 heads, 2 layers, S 128 with 8 pad positions,
    f32) with the encoder output scaled x100, so that a step that loses the
    cross-attention of beams 8+ reads ~1.8 off: held to that test's 5e-2 on
    all beams and on beams 8+ alone, and to 1e-5 (both sides compute the
    same f32 recipe); the same step with the cross-attention of beams 8+
    zeroed must miss it by more than 0.5.
(b) generate_mm at 11 and 17 beams in the three candidate modes (full, opt,
    shortlist) on VacnicConfig.tiny(): tokens identical to JAX's generate_mm
    with its Pallas decode and encoder (interpret mode), scores within 1e-5
    (both sides run the same f32 recipe; against JAX's default XLA decode
    they agree only to 1.1e-4, since the kernel decode rounds the embedded
    token to bf16 even in f32, ROADMAP C.4).
(c) kernels/primitives.dec_cross_plan, the pure plan the CUDA launcher
    follows (groups of 8 beams, the last one ragged, every block with the
    shared memory of min(beams, 8) beams), and the grouped order of work
    emulated on the CPU: each group's rows b * beams + 8 g + j computed as a
    block of <= 8 beams, against the plain twin (tolerances of
    tests/test_torch_norm_cross_tiles.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_generate import inputs as generate_inputs
from test_torch_norm_cross_tiles import assert_cross_close, cross_inputs, tiled_dec_cross
from vacnic_tpu.core.config import VacnicConfig as JC
from vacnic_tpu.infer import decode_fast as JDF
from vacnic_tpu.infer.generate import generate_mm as j_generate
from vacnic_tpu.kernels.decode_layer import ChunkPlan
from vacnic_tpu.models import bart as JB
from vacnic_tpu_torch.infer import decode_fast as TDF
from vacnic_tpu_torch.infer.generate import generate_mm as t_generate
from vacnic_tpu_torch.kernels import decode_layer as DL
from vacnic_tpu_torch.kernels import primitives as K
from vacnic_tpu_torch.models.weights_io import params_from_jax

WIDE, BATCH, MAX_LEN, S = 11, 4, 14, 128  # 11 > 8 and not a multiple of 8


# --------------------------------------------------------------------------
# (a) one decode step at 11 beams against JAX's Pallas step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wide_step():
    """JAX's interpret-mode kernel step and the port's kernel step at 11
    beams on the same tree, encoder output and tokens -> (JAX logits, port
    step as a function of the port's cross-attention op), [B, beams, V]."""
    from vacnic_tpu_torch.core.config import BartConfig

    jcfg = dataclasses.replace(JC.tiny().bart, d_model=128, decoder_attention_heads=2,
                               encoder_attention_heads=2, decoder_ffn_dim=256,
                               encoder_ffn_dim=256, decoder_layers=2, encoder_layers=2)
    tcfg = BartConfig(**dataclasses.asdict(jcfg))
    jp = jax.tree_util.tree_map(np.asarray, JB.bart_init(jax.random.PRNGKey(0), jcfg))
    tp = params_from_jax(jp)
    rng = np.random.RandomState(9)
    enc = (rng.randn(BATCH, S, jcfg.d_model) * 100.0).astype(np.float32)
    bias = np.where(np.arange(S) < S - 8, 0.0, np.finfo(np.float32).min).astype(np.float32)
    enc_bias = np.broadcast_to(bias[None, None, None, :], (BATCH, 1, 1, S)).copy()
    tok = np.full((BATCH * WIDE, 1), 5, np.int32)

    jdp = JDF.build_decode_params(jp, dtype=jnp.float32)
    jcache = JDF.build_decode_cache(jp, jnp.asarray(enc), WIDE, MAX_LEN, jcfg,
                                    dtype=jnp.float32, pad_to=16, time_major=True)
    plan = ChunkPlan(n_self=2, n_cross=2, n_ffn=2)  # whole beam groups of 11
    jlogits, _ = jax.jit(lambda c, t, p: JDF.decode_step_pallas(
        jdp, jp, c, t, p, jnp.asarray(enc_bias), jcfg, dtype=jnp.float32, plan=plan,
        interpret=True))(jcache, jnp.asarray(tok), jnp.int32(0))

    def port(cross_attn=K.dec_cross_attention_plain):
        dp = TDF.build_decode_params(tp, torch.float32)
        cache = TDF.build_decode_cache(tp, torch.from_numpy(enc), WIDE, MAX_LEN, tcfg,
                                       torch.float32, pad_to=16, time_major=True)
        real = DL.PLAIN_OPS.cross_attn
        DL.PLAIN_OPS.cross_attn = cross_attn
        try:
            logits, _ = TDF.decode_step_kernel(dp, tp, cache, torch.from_numpy(tok), 0,
                                               torch.from_numpy(enc_bias), tcfg, torch.float32)
        finally:
            DL.PLAIN_OPS.cross_attn = real
        return logits.numpy().reshape(BATCH, WIDE, -1)

    return np.asarray(jlogits).reshape(BATCH, WIDE, -1), port


def zero_wide_beams(q, *args):
    """The regression the x100 input is there to catch: the cross-attention
    of beams 8+ lost."""
    out = K.dec_cross_attention_plain(q, *args)
    return out.reshape(BATCH, WIDE, -1).index_fill(1, torch.arange(8, WIDE), 0.0).reshape(
        out.shape)


@pytest.mark.parametrize("case", ["all_beams", "beams_8_up", "lost_cross_is_caught"])
def test_wide_beam_step_matches_jax(wide_step, case):
    want, port = wide_step
    if case == "lost_cross_is_caught":
        got = port(zero_wide_beams)
        assert np.abs(got[:, 8:] - want[:, 8:]).max() > 0.5
        np.testing.assert_allclose(got[:, :8], want[:, :8], atol=5e-2, rtol=5e-2)
        return
    got = port()
    rows = slice(None) if case == "all_beams" else slice(8, None)
    np.testing.assert_allclose(got[:, rows], want[:, rows], atol=5e-2, rtol=5e-2)
    assert np.abs(got[:, rows] - want[:, rows]).max() < 1e-5  # the same f32 recipe on both


# --------------------------------------------------------------------------
# (b) generate_mm past 8 beams against JAX's generate_mm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "opt", "shortlist"])
@pytest.mark.parametrize("beams", [11, 17])
def test_generate_mm_wide_beams_matches_jax(beams, mode, monkeypatch):
    jcfg, tcfg, jargs, jkw, targs, tkw = generate_inputs(False)
    dec = dict(max_length=10, num_beams=beams)
    monkeypatch.setenv("VACNIC_PALLAS_DECODE", "1")
    monkeypatch.setenv("VACNIC_PALLAS_ENCODER", "1")
    monkeypatch.setenv("VACNIC_BEAM_LOGIC", mode)
    js, jsc = j_generate(*jargs, jcfg.bart, jcfg.fusion,
                         dataclasses.replace(jcfg.decode, **dec), **jkw)
    K.reset_launch_counts()
    ts, tsc = t_generate(*targs, tcfg.bart, tcfg.fusion, dataclasses.replace(tcfg.decode, **dec),
                         device="cpu", cand_mode=mode, **tkw)
    assert K.launch_counts()["dec_cross_attention"] == 0  # the CPU takes the twins
    assert ts.shape == (2, 10) and ts.dtype == torch.int64
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=0, atol=1e-5)
    assert len(np.unique(ts.numpy())) > 4  # the beams chose varied tokens


# --------------------------------------------------------------------------
# (c) the plan of the grouped launch, and its order of work
# --------------------------------------------------------------------------

@pytest.mark.parametrize("elem_bytes", [1, 2], ids=["int8", "bf16"])
@pytest.mark.parametrize("beams", [1, 5, 8, 9, 11, 15, 16, 17, 24, 33])
def test_plan_groups_of_eight(beams, elem_bytes):
    """Up to 8 beams one block an (item, head) with room for exactly those
    beams (the kernel before's instance); 9-24 one wide block an (item,
    head) holding all of them; past 24 ceil(beams / 8) groups, the last one
    ragged, each block with 8 beams' shared memory at any beam count. The
    last n8 operand holds the beams past the whole groups of 8 in every
    variant."""
    plan = K.dec_cross_plan(beams, 512, elem_bytes)
    variant = "beams" if beams <= 8 else "wide" if beams <= 24 else "grouped"
    assert plan.variant == variant
    assert plan.groups == (-(-beams // 8) if variant == "grouped" else 1)
    assert plan.group_beams == (8 if variant == "grouped" else beams)
    assert 1 <= plan.last_beams <= 8
    assert 8 * (-(-beams // 8) - 1) + plan.last_beams == beams
    assert plan.smem == K.dec_cross_smem_bytes(plan.group_beams, 512, elem_bytes,
                                               variant) <= K.SMEM_MAX


@pytest.mark.parametrize("elem_bytes", [1, 2], ids=["int8", "bf16"])
def test_plan_keeps_the_limit_on_s(elem_bytes):
    """The largest S a block of 8 beams holds is held at 11, 16 and 64
    beams too (by the groups of 8 where the wide block's scores do not
    fit). Past it only a wide block takes more (at 11 beams its scores take
    fewer bytes than a block of 8's scores, probabilities, q and bias), and
    the first S that no block holds is refused at every such count past 8
    beams; at 8 beams that S is split over a cluster (LED's long articles)."""
    s_max = max(s for s in range(1, 8193) if K.dec_cross_smem_bytes(8, s, elem_bytes)
                <= K.SMEM_MAX)
    for beams in (8, 11, 16, 64):
        assert K.dec_cross_plan(beams, s_max, elem_bytes).smem <= K.SMEM_MAX
        if beams <= K.DEC_CROSS_GROUP:
            plan = K.dec_cross_plan(beams, s_max + 1, elem_bytes)
            assert plan.variant == "split" and plan.smem <= K.SMEM_MAX
            continue
        s_limit = s_max
        while True:
            try:
                plan = K.dec_cross_plan(beams, s_limit + 1, elem_bytes)
            except ValueError as e:
                assert "shared memory" in str(e)
                break
            assert plan.variant == "wide" and plan.smem <= K.SMEM_MAX, (beams, s_limit + 1)
            s_limit += 1
        with pytest.raises(ValueError, match="shared memory"):
            K.dec_cross_plan(beams, s_limit + 1, elem_bytes)
        assert (s_limit > s_max) == (beams == 11), (beams, s_limit, s_max)


@pytest.mark.parametrize("beams,s_len,elem_bytes", [(0, 512, 1), (5, 0, 1), (5, 512, 4),
                                                    (11, 0, 1)])
def test_plan_refusals(beams, s_len, elem_bytes):
    with pytest.raises(ValueError):
        K.dec_cross_plan(beams, s_len, elem_bytes)


def grouped_dec_cross(q, ck, cv, ks, vs, bias, heads):
    """The grouped launch's order of work: for every item and group g the
    block takes q rows b * beams + 8 g + j (j < the group's beams), pads
    them with zero rows to 8 as the kernel's q pad does, computes them as a
    block of 8 beams (tiled_dec_cross) and writes back only its own rows."""
    b = ck.shape[0]
    beams = q.shape[0] // b
    plan = K.dec_cross_variant_plan("grouped", beams, ck.shape[-1], ck.element_size())
    out = torch.empty_like(q)
    q3, o3 = q.reshape(b, beams, -1), out.reshape(b, beams, -1)
    for g in range(plan.groups):
        lo = 8 * g
        n = plan.last_beams if g == plan.groups - 1 else 8
        block_q = torch.zeros(b, plan.group_beams, q.shape[1], dtype=q.dtype)
        block_q[:, :n] = q3[:, lo:lo + n]
        o = tiled_dec_cross(block_q.reshape(-1, q.shape[1]), ck, cv, ks, vs, bias, heads)
        o3[:, lo:lo + n] = o.reshape(b, plan.group_beams, -1)[:, :n]
    return out


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("s_len", [40, 130])
@pytest.mark.parametrize("beams", [9, 11, 16, 17])
def test_grouped_order_matches_plain(beams, s_len, kind):
    """Every beam of every group, the ragged last group, the fully masked
    item and the half-masked one, against the twin."""
    q, ck, cv, ks, vs, bias = cross_inputs(beams * 100 + s_len, 3, beams, 2, s_len, kind,
                                           torch.bfloat16)
    out = grouped_dec_cross(q, ck, cv, ks, vs, bias, 2)
    assert_cross_close(out, K.dec_cross_attention_plain(q, ck, cv, ks, vs, bias, 2), cv, vs)


def wide_dec_cross(q, ck, cv, ks, vs, bias, heads):
    """The wide block's order of work: one block an (item, head) for all its
    beams, q padded with zero rows to ceil(beams / 8) n8 operands of 8 rows;
    each 64-position K tile taken once and multiplied by every operand in
    turn (scores over all 64 channels, plus the bias); the softmax a beam at
    a time over all S, as a block of 8 takes it (each operand's rows in one
    piece); the normalised probabilities rounded to the inputs' dtype; P V
    one 16-position step after another, every operand in turn; the V scale;
    only the item's own beams written back."""
    dt = q.dtype
    b, _, hd, s_len = ck.shape
    beams = q.shape[0] // b
    ops = -(-beams // 8)
    qp = torch.zeros(b, 8 * ops, q.shape[1], dtype=dt)
    qp[:, :beams] = q.reshape(b, beams, -1)
    qh = (qp.float() * hd ** -0.5).to(dt).reshape(b, 8 * ops, heads, hd)
    if ks is not None:
        qh = (qh.float() * ks.float()[:, None]).to(dt)
    q32 = [qh[:, 8 * o:8 * o + 8].float().contiguous() for o in range(ops)]
    tiles = [[] for _ in range(ops)]
    for lo in range(0, s_len, 64):  # a K tile once, every operand in turn
        kt = ck[..., lo:lo + 64].float()
        for o in range(ops):
            tiles[o].append(torch.einsum("bkhd,bhdn->bkhn", q32[o], kt))
    outs = []
    probs = []
    for o in range(ops):
        s = torch.cat(tiles[o], -1) + bias.float()[:, None, None, :]
        m = s.amax(-1, keepdim=True)
        inv = 1.0 / torch.exp(s - m).sum(-1, keepdim=True)
        probs.append((torch.exp(s - m) * inv).to(dt).float())
        outs.append(torch.zeros(b, 8, heads, hd))
    for c in range(0, s_len, 16):  # one mma k-step after another, every operand in turn
        vt = cv[..., c:c + 16].float()
        for o in range(ops):
            outs[o] = outs[o] + torch.einsum("bkhn,bhdn->bkhd", probs[o][..., c:c + 16], vt)
    out = torch.cat(outs, 1)
    if vs is not None:
        out = out * vs.float()[:, None]
    return out.to(dt)[:, :beams].reshape(b * beams, heads * hd)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("s_len", [40, 130])
@pytest.mark.parametrize("beams", [9, 11, 16, 17, 24])
def test_wide_order_matches_grouped(beams, s_len, kind):
    """The wide block's order of work, bit for bit the groups of 8's (every
    beam's sums are those of its group of 8), and within the twin's
    tolerance: two and three operands, whole and ragged last ones, the fully
    masked item and the half-masked one."""
    q, ck, cv, ks, vs, bias = cross_inputs(beams * 300 + s_len, 3, beams, 2, s_len, kind,
                                           torch.bfloat16)
    out = wide_dec_cross(q, ck, cv, ks, vs, bias, 2)
    assert torch.equal(out, grouped_dec_cross(q, ck, cv, ks, vs, bias, 2))
    assert_cross_close(out, K.dec_cross_attention_plain(q, ck, cv, ks, vs, bias, 2), cv, vs)


@pytest.mark.parametrize("elem_bytes", [1, 2], ids=["int8", "bf16"])
@pytest.mark.parametrize("s_len", [1, 40, 130, 512, 1472, 3008, 3776])
@pytest.mark.parametrize("beams", [1, 8, 9, 11, 16, 17, 24, 25, 64])
def test_plan_variant_by_shape(beams, s_len, elem_bytes):
    """The variant at each (beams, S), the same at every B (the readings at
    B 8, 16 and 32 favoured the wide block alike): the kernel of that beam
    count to 8; from 9 to 24 the wide block wherever it fits a SM, else the
    groups of 8; the groups past 24."""
    plan = K.dec_cross_plan(beams, s_len, elem_bytes)
    wide = K.dec_cross_smem_bytes(beams, s_len, elem_bytes, "wide")
    want = ("beams" if beams <= 8 else
            "wide" if beams <= K.DEC_CROSS_WIDE_MAX and wide <= K.SMEM_MAX else "grouped")
    assert plan.variant == want
    assert plan == K.dec_cross_variant_plan(want, beams, s_len, elem_bytes)


@pytest.mark.parametrize("variant,beams", [("beams", 8), ("wide", 9), ("wide", 11), ("wide", 16),
                                           ("wide", 24), ("grouped", 16)])
@pytest.mark.parametrize("elem_bytes", [1, 2], ids=["int8", "bf16"])
def test_largest_s_of_each_variant(variant, beams, elem_bytes):
    """Each variant's largest S is the last whole tile its block's bytes
    allow (the bytes grow by one tile's rows at each 64 positions). Past a
    wide block's, dec_cross_plan turns to the groups of 8 where they fit
    and refuses the shape where they do not."""
    def fits(s, variant=variant):
        return K.dec_cross_smem_bytes(beams, s, elem_bytes, variant) <= K.SMEM_MAX

    s_max = max(s for s in range(1, 8193) if fits(s))
    assert s_max % 64 == 0 and not fits(s_max + 1)
    assert all(fits(s) for s in range(s_max - 63, s_max + 1))
    if variant == "wide":
        assert K.dec_cross_plan(beams, s_max, elem_bytes).variant == "wide"
        if fits(s_max + 1, "grouped"):
            assert K.dec_cross_plan(beams, s_max + 1, elem_bytes).variant == "grouped"
        else:
            with pytest.raises(ValueError, match="shared memory"):
                K.dec_cross_plan(beams, s_max + 1, elem_bytes)


@pytest.mark.parametrize("elem_bytes", [1, 2], ids=["int8", "bf16"])
@pytest.mark.parametrize("s_len", [1, 64, 130, 512])
@pytest.mark.parametrize("beams", [1, 5, 8, 9, 16, 24])
def test_smem_bytes_of_every_variant(beams, s_len, elem_bytes):
    """dec_cross_smem_bytes by variant, against the blocks' layouts counted
    piece by piece (csrc/dec_cross_attention.cu's smem_bytes and
    wide_smem_bytes): the ring, scores and probabilities of the block's
    beams, the zero row, then a block of <= 8 beams' int8 strips, q, bias,
    V scales and softmax statistics, or the wide block's V scales and its
    four warps' score maxima (its probabilities over its scores)."""
    sp = 64 * -(-s_len // 64)
    ring = 4 * 64 * 80 if elem_bytes == 1 else 3 * 64 * 144
    strips = 4 * 3072 if elem_bytes == 1 else 0
    scores, probs = 4 * (sp + 4), 2 * (sp + 8)
    small = 16 + 8 * 68 * 4 + 4 * sp + 64 * 4 + 8 * 8
    if beams <= 8:
        assert K.dec_cross_smem_bytes(beams, s_len, elem_bytes) == (
            ring + strips + beams * (scores + probs) + small)
    assert K.dec_cross_smem_bytes(beams, s_len, elem_bytes, "grouped") == (
        ring + strips + 8 * (scores + probs) + small)
    assert K.dec_cross_smem_bytes(beams, s_len, elem_bytes, "wide") == (
        ring + beams * (scores + 4 * 4) + 16 + 64 * 4)
    # the wide block's probability row fits in the first half of its score row
    assert 2 * sp <= scores


@pytest.mark.parametrize("variant,beams", [("grouped", 5), ("wide", 8), ("wide", 25),
                                           ("beams", 9), ("wide", 11)])
def test_explicit_plans_refuse_the_cpu(variant, beams):
    """A plan that the launcher has no instance for (groups of 8 at 8 beams
    or fewer, a wide block of one operand or of four, the kernel of a beam
    count past 8) is still made (the launcher refuses it on the card,
    tests/test_torch_cuda.py), and no explicit plan reaches a CPU tensor:
    the planned entry takes only the card's tensors."""
    q, ck, cv, ks, vs, bias = cross_inputs(7, 2, beams, 2, 40, "int8", torch.bfloat16)
    plan = K.dec_cross_variant_plan(variant, beams, 40, 1)
    assert plan.variant == variant
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="cuda"):
        K._dec_cross_planned(plan, q, ck, cv, ks, vs, bias, 2)
    assert K.dec_cross_variant_counts() == {"beams": 0, "wide": 0, "grouped": 0, "split": 0}


def test_cpu_wide_beams_take_the_twin_and_count_nothing():
    q, ck, cv, ks, vs, bias = cross_inputs(5, 2, 11, 2, 40, "int8", torch.float32)
    K.reset_launch_counts()
    out = K.dec_cross_attention(q, ck, cv, ks, vs, bias, 2)
    assert torch.equal(out, K.dec_cross_attention_plain(q, ck, cv, ks, vs, bias, 2))
    assert K.launch_counts()["dec_cross_attention"] == 0 and K.dec_cross_beam_counts() == {}
