"""The CUDA kernels' Python wrappers and their plain-PyTorch twins.

Every wrapper dispatches on the device of its tensors: CPU tensors take the
`*_plain` twin; CUDA tensors are checked (device, dtype, shape, contiguity),
outputs are allocated with torch.empty, the kernel is launched on the
current stream and its launch count goes up by one; any other tensor
raises. There is no fallback from a CUDA tensor to the plain twin. No
kernel has a backward: every wrapper first refuses, on either device, a
call under grad mode on a tensor that requires grad (`no_grad_guard`).

The plain twins define the semantics the kernels are held to: the dtype of
the inputs is the matmul dtype (bf16 on the card, f32 in the CPU tests),
products accumulate in f32, q is rounded to that dtype after scaling and
probabilities before the value product. In f32 every rounding is a no-op.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

KERNELS = ("gemm_bf16", "layernorm", "enc_self_attention", "enc_cross_attention",
           "dec_self_attention", "dec_cross_attention", "lm_stats", "flash_attention",
           "lm_head")
# (the wrappers of the last three live in kernels/lm_stats, kernels/flash_attn
# and kernels/lm_head)
LAUNCHES: dict[str, int] = {k: 0 for k in KERNELS}
# gemm_bf16 is two __global__ kernels; every launch also counts under its own
GEMM_VARIANTS = ("large_m", "small_m")
GEMM_VARIANT_LAUNCHES: dict[str, int] = {v: 0 for v in GEMM_VARIANTS}
# and so is layernorm
LAYERNORM_VARIANTS = ("warp", "block")
LAYERNORM_VARIANT_LAUNCHES: dict[str, int] = {v: 0 for v in LAYERNORM_VARIANTS}
# and dec_self_attention, one instance for each self-cache type
DEC_SELF_VARIANTS = ("bf16", "int8", "fp8")
DEC_SELF_VARIANT_LAUNCHES: dict[str, int] = {v: 0 for v in DEC_SELF_VARIANTS}

GELU = "gelu"


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for v in GEMM_VARIANT_LAUNCHES:
        GEMM_VARIANT_LAUNCHES[v] = 0
    for v in LAYERNORM_VARIANT_LAUNCHES:
        LAYERNORM_VARIANT_LAUNCHES[v] = 0
    for v in DEC_SELF_VARIANT_LAUNCHES:
        DEC_SELF_VARIANT_LAUNCHES[v] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def gemm_variant_counts() -> dict[str, int]:
    """Launches of gemm_bf16 by kernel: they add up to LAUNCHES["gemm_bf16"]."""
    return dict(GEMM_VARIANT_LAUNCHES)


def layernorm_variant_counts() -> dict[str, int]:
    """Launches of layernorm by kernel: they add up to LAUNCHES["layernorm"]."""
    return dict(LAYERNORM_VARIANT_LAUNCHES)


def dec_self_variant_counts() -> dict[str, int]:
    """Launches of dec_self_attention by self-cache type: they add up to
    LAUNCHES["dec_self_attention"]."""
    return dict(DEC_SELF_VARIANT_LAUNCHES)


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------

def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise RuntimeError(f"unsupported device {t.device}: the kernels take cuda tensors, "
                       "their plain twins cpu tensors")


def differentiated(*tensors) -> bool:
    """Grad mode is on and one of the tensors (None allowed) requires grad:
    an op on them is part of a computation autograd will differentiate."""
    return torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                           for t in tensors)


def no_grad_guard(name: str, *tensors) -> None:
    """Refuse a differentiated call: the kernels have no backward, so a
    wrapper called with grad mode on and an input that requires grad would
    drop that input's gradient. Raises on the CPU twin as on the card; run
    such a call under torch.no_grad(), or take the plain path
    (models/layers.attention_core does)."""
    if differentiated(*tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; called under grad mode on a "
                           "tensor that requires grad")


def _req(t: torch.Tensor, name: str, dtype, shape=None, device=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a cuda tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _p(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _launch(name: str, fn: str, *args) -> None:
    from vacnic_tpu_torch.kernels._build import lib

    rc = getattr(lib(), fn)(*args, _stream())
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# GEMM with fused epilogue
# ---------------------------------------------------------------------------

def gemm_plain(a, w, bias=None, residual=None, act=None, out_dtype=torch.float32):
    y = torch.matmul(a.float(), w.float())
    if bias is not None:
        y = y + bias.float()
    if act == GELU:
        y = torch.nn.functional.gelu(y, approximate="none")
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


GEMM_BK = 64                  # k per tile of csrc/gemm_bf16.cu
GEMM_SMALL_M_MAX = 256        # four warpgroups of 64 rows
GEMM_SMS = 132                # an H100's streaming multiprocessors


class GemmPlan(NamedTuple):
    """Which kernel of csrc/gemm_bf16.cu a product takes, and how K is cut."""
    variant: str    # "large_m": TMA-fed 256 x 128 tiles; "small_m": split-K over a cluster
    split: int = 1  # small_m: blocks of a cluster along K, each block a 64-column slab


@functools.lru_cache(maxsize=None)  # a decode step asks 72 times, for four shapes
def gemm_plan(m: int, n: int, k: int) -> GemmPlan:
    """The kernel and split of an [m, k] @ [k, n] product. Pure: the CUDA
    launcher only follows it. The rules were measured on an H100 (PERF.md).

    m <= 256: the weight-streaming kernel. One block covers every row of a
    64-column slab and a cluster of `split` blocks shares K: the largest
    split of 1, 2, 4 that divides the k tiles and keeps the grid within one
    wave of the 132 SMs (a block takes an SM's whole shared memory). More
    blocks than SMs ran 1.5-2x slower, and so did clusters of 8, which the
    card does not place 16 at a time.
    Above: the TMA kernel, 256 x 128 tiles."""
    if m < 1 or k < 32 or k % 32 or n < 64 or n % 64:
        raise ValueError(f"gemm: needs M >= 1, K % 32 == 0 and N % 64 == 0, got M={m} K={k} N={n}")
    if m > GEMM_SMALL_M_MAX:
        return GemmPlan("large_m")
    k_tiles = -(-k // GEMM_BK)
    fits = [s for s in (1, 2, 4) if k_tiles % s == 0 and n // 64 * s <= GEMM_SMS]
    return GemmPlan("small_m", max(fits, default=1))


_VARIANT_ID = {"large_m": 1, "small_m": 2}


def gemm(a, w, bias=None, residual=None, act=None, out_dtype=torch.float32):
    """epilogue(a [M, K] @ w [K, N]): + bias [N] f32, exact gelu if
    act == "gelu", + residual [M, N] f32; out_dtype f32 or bf16."""
    no_grad_guard("gemm", a, w, bias, residual)
    if _on_cpu(a):
        return gemm_plain(a, w, bias, residual, act, out_dtype)
    m, k = a.shape
    n = w.shape[1]
    _req(a, "gemm a", torch.bfloat16)
    _req(w, "gemm w", torch.bfloat16, (k, n), a.device)
    if bias is not None:
        _req(bias, "gemm bias", torch.float32, (n,), a.device)
    if residual is not None:
        _req(residual, "gemm residual", torch.float32, (m, n), a.device)
    if act not in (None, GELU) or out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gemm: act {act!r}, out_dtype {out_dtype} not supported")
    plan = gemm_plan(m, n, k)
    out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    _launch("gemm_bf16", "vt_gemm_bf16", _p(a), _p(w), _p(bias), _p(residual), _p(out),
            m, n, k, int(act == GELU), int(out_dtype == torch.bfloat16),
            _VARIANT_ID[plan.variant], plan.split)
    GEMM_VARIANT_LAUNCHES[plan.variant] += 1
    return out


def gemm_smem_bytes(m: int, n: int, k: int) -> int:
    """Dynamic shared memory a block of the product's kernel takes, as the
    built library states it."""
    from vacnic_tpu_torch.kernels._build import lib

    return lib().vt_gemm_smem_bytes(_VARIANT_ID[gemm_plan(m, n, k).variant], m)


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

def layernorm_plain(x, gb, mm_dtype, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * gb[0].float() + gb[1].float()
    return y, y.to(mm_dtype)


LN_WARP_MAX_D = 1024  # 32 lanes x 8 float4 slots in registers (csrc/layernorm.cu)


class LayernormPlan(NamedTuple):
    """Which kernel of csrc/layernorm.cu a row width takes."""
    variant: str    # "warp": a warp a row, the row in registers; "block": a block a row
    slots: int = 0  # warp: float4 slots a lane, ceil(d / 128)


@functools.lru_cache(maxsize=None)
def layernorm_plan(rows: int, d: int) -> LayernormPlan:
    """The kernel of a [rows, d] LayerNorm. Pure: the CUDA launcher only
    follows it. d <= 1024: the register-resident warp kernel with the fewest
    slots that cover the row; wider rows: a block a row. Any rows >= 1."""
    if rows < 1 or d < 1:
        raise ValueError(f"layernorm: needs rows >= 1 and d >= 1, got rows={rows} d={d}")
    if d > LN_WARP_MAX_D:
        return LayernormPlan("block")
    return LayernormPlan("warp", -(-d // 128))


_LN_VARIANT_ID = {"warp": 1, "block": 2}


def layernorm(x, gb, mm_dtype, eps: float = 1e-5):
    """Row LayerNorm of x [R, d] f32 with gb [2, d] = (scale, bias) ->
    (y f32, y in mm_dtype)."""
    no_grad_guard("layernorm", x, gb)
    if _on_cpu(x):
        return layernorm_plain(x, gb, mm_dtype, eps)
    r, d = x.shape
    _req(x, "layernorm x", torch.float32)
    _req(gb, "layernorm gb", torch.float32, (2, d), x.device)
    if mm_dtype != torch.bfloat16:
        raise ValueError("layernorm: the kernel writes a bf16 copy")
    plan = layernorm_plan(r, d)
    y32 = torch.empty_like(x)
    y16 = torch.empty(r, d, dtype=torch.bfloat16, device=x.device)
    _launch("layernorm", "vt_layernorm", _p(x), _p(gb), _p(y32), _p(y16), r, d,
            ctypes.c_float(eps), _LN_VARIANT_ID[plan.variant], plan.slots)
    LAYERNORM_VARIANT_LAUNCHES[plan.variant] += 1
    return y32, y16


# ---------------------------------------------------------------------------
# Encoder attention
# ---------------------------------------------------------------------------

def enc_self_attention_plain(qkv, bias, batch: int, seq: int, heads: int):
    dt = qkv.dtype
    d = qkv.shape[1] // 3
    hd = d // heads
    x = qkv.reshape(batch, seq, 3, heads, hd).permute(2, 0, 3, 1, 4)  # [3, B, H, S, hd]
    q = (x[0].float() * hd ** -0.5).to(dt)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), x[1].float()) + bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(dt)
    o = torch.einsum("bhts,bhsd->bhtd", p.float(), x[2].float()).to(dt)
    return o.permute(0, 2, 1, 3).reshape(batch * seq, d)


def enc_self_attention(qkv, bias, batch: int, seq: int, heads: int):
    """qkv [B*S, 3d] (q | k | v), additive pad bias [B, S] f32 -> [B*S, d]."""
    no_grad_guard("enc_self_attention", qkv, bias)
    if _on_cpu(qkv):
        return enc_self_attention_plain(qkv, bias, batch, seq, heads)
    d = qkv.shape[1] // 3
    _req(qkv, "enc_self qkv", torch.bfloat16, (batch * seq, 3 * d))
    _req(bias, "enc_self bias", torch.float32, (batch, seq), qkv.device)
    if d != heads * 64 or seq % 64 or seq > 32768:
        raise ValueError(f"enc_self_attention: needs head_dim 64 and S % 64 == 0, S <= 32768 "
                         f"(d={d}, heads={heads}, S={seq})")
    out = torch.empty(batch * seq, d, dtype=torch.bfloat16, device=qkv.device)
    _launch("enc_self_attention", "vt_enc_self_attention", _p(qkv), _p(bias), _p(out),
            batch, seq, heads, ctypes.c_float(64 ** -0.5))
    return out


def enc_cross_attention_plain(q, ck, cv, batch: int, seq: int, heads: int):
    dt = q.dtype
    d = q.shape[1]
    hd = d // heads
    kv = cv.shape[1]
    qh = (q.reshape(batch, seq, heads, hd).float() * hd ** -0.5).to(dt)
    k = ck.reshape(batch, heads, hd, kv)
    v = cv.reshape(batch, kv, heads, hd)
    s = torch.einsum("bshd,bhdk->bhsk", qh.float(), k.float())
    p = torch.softmax(s, dim=-1).to(dt)
    o = torch.einsum("bhsk,bkhd->bshd", p.float(), v.float()).to(dt)
    return o.reshape(batch * seq, d)


def enc_cross_attention(q, ck, cv, batch: int, seq: int, heads: int):
    """q [B*S, d], ck [B, d, KV] (pre-transposed keys), cv [B, KV, d] -> [B*S, d]."""
    no_grad_guard("enc_cross_attention", q, ck, cv)
    if _on_cpu(q):
        return enc_cross_attention_plain(q, ck, cv, batch, seq, heads)
    d = q.shape[1]
    kv = cv.shape[1]
    _req(q, "enc_cross q", torch.bfloat16, (batch * seq, d))
    _req(ck, "enc_cross k", torch.bfloat16, (batch, d, kv), q.device)
    _req(cv, "enc_cross v", torch.bfloat16, (batch, kv, d), q.device)
    if d != heads * 64 or not 1 <= kv <= 64:
        raise ValueError(f"enc_cross_attention: needs head_dim 64 and 1 <= KV <= 64 "
                         f"(d={d}, KV={kv})")
    if q.data_ptr() % 16 or cv.data_ptr() % 16:
        raise ValueError("enc_cross_attention: q and cv must start on 16 bytes")
    out = torch.empty_like(q)
    _launch("enc_cross_attention", "vt_enc_cross_attention", _p(q), _p(ck), _p(cv), _p(out),
            batch, seq, kv, heads, ctypes.c_float(64 ** -0.5))
    return out


# ---------------------------------------------------------------------------
# Decoder attention
# ---------------------------------------------------------------------------

def dec_self_attention_plain(qkv, cache_k, cache_v, anc, pos: int, heads: int,
                             k_scale=None, v_scale=None):
    dt = qkv.dtype
    bk = qkv.shape[0]
    d = qkv.shape[1] // 3
    hd = d // heads
    rows = anc[:pos].long()  # [pos, BK] physical row of each beam row's step t
    t_ids = torch.arange(pos, device=qkv.device)[:, None]
    kg = torch.cat([cache_k[t_ids, rows].float(), qkv[None, :, d:2 * d].float()])  # [pos+1, BK, d]
    vg = torch.cat([cache_v[t_ids, rows].float(), qkv[None, :, 2 * d:].float()])
    q = (qkv[:, :d].float() * hd ** -0.5).to(dt).reshape(bk, heads, hd)
    s = torch.einsum("bhd,tbhd->bht", q.float(), kg.reshape(pos + 1, bk, heads, hd))
    if k_scale is not None:  # int8 rows t < pos; the step's own row is unscaled
        s = s * _row_scales(k_scale, t_ids, rows)
    p = torch.softmax(s, dim=-1).to(dt).float()
    if v_scale is not None:
        p = p * _row_scales(v_scale, t_ids, rows)
    o = torch.einsum("bht,tbhd->bhd", p, vg.reshape(pos + 1, bk, heads, hd))
    return o.to(dt).reshape(bk, d)


def _row_scales(scale, t_ids, rows):
    """[T, BK, H] per-row scales of the gathered rows t < pos, and 1 for the
    step's own row -> [BK, H, pos + 1]."""
    sc = scale[t_ids, rows].float()  # [pos, BK, H]
    return torch.cat([sc, torch.ones_like(scale[:1]).float()]).permute(1, 2, 0)


DEC_SELF_MAX_T = 4096
DEC_SELF_KINDS = {torch.bfloat16: "bf16", torch.int8: "int8", torch.float8_e4m3fn: "fp8"}  # cache dtypes


def dec_self_smem_bytes(t_len: int, elem_bytes: int) -> int:
    """Dynamic shared memory of a dec_self_attention block, as
    csrc/dec_attention.cu's launcher counts it: for each of its four warps
    (a head each), 64 staged V rows [64][64] of the cache's type, their
    scales [64] f32, the scores [T] f32 and the ancestry [T] int32, rounded
    up to 16 bytes."""
    return 4 * (-(-(64 * 64 * elem_bytes + 4 * 64 + 8 * t_len) // 16) * 16)


def dec_self_attention(qkv, cache_k, cache_v, anc, pos: int, heads: int, k_scale=None,
                       v_scale=None):
    """One step of self-attention: qkv [BK, 3d] of this step, the layer's
    write-once cache [T, BK, d] (bf16, int8 with per-row scales k_scale /
    v_scale [T, BK, H] f32, or float8_e4m3fn), ancestry anc [T, BK] int32.
    Rows t < pos are read from row anc[t, c]; the step's own K/V (t == pos)
    from qkv."""
    no_grad_guard("dec_self_attention", qkv, cache_k, cache_v, k_scale, v_scale)
    if _on_cpu(qkv):
        return dec_self_attention_plain(qkv, cache_k, cache_v, anc, pos, heads, k_scale,
                                        v_scale)
    bk = qkv.shape[0]
    d = qkv.shape[1] // 3
    t_len = cache_k.shape[0]
    kind = DEC_SELF_KINDS.get(cache_k.dtype)
    if kind is None:
        raise ValueError(f"dec_self_attention: cache dtype {cache_k.dtype}, expected bf16, "
                         "int8 or float8_e4m3fn")
    _req(qkv, "dec_self qkv", torch.bfloat16, (bk, 3 * d))
    _req(cache_k, "dec_self cache_k", cache_k.dtype, (t_len, bk, d), qkv.device)
    _req(cache_v, "dec_self cache_v", cache_k.dtype, (t_len, bk, d), qkv.device)
    _req(anc, "dec_self anc", torch.int32, (t_len, bk), qkv.device)
    if (kind == "int8") != (k_scale is not None) or (kind == "int8") != (v_scale is not None):
        raise ValueError("dec_self_attention: an int8 cache and its scales travel together")
    if kind == "int8":
        _req(k_scale, "dec_self k scale", torch.float32, (t_len, bk, heads), qkv.device)
        _req(v_scale, "dec_self v scale", torch.float32, (t_len, bk, heads), qkv.device)
    if d != heads * 64 or heads % 4 or not 0 <= pos < t_len or t_len > DEC_SELF_MAX_T:
        raise ValueError(f"dec_self_attention: needs head_dim 64, heads % 4 == 0, "
                         f"0 <= pos < T <= {DEC_SELF_MAX_T} (d={d}, heads={heads}, pos={pos}, "
                         f"T={t_len})")
    if any(x is not None and x.data_ptr() % 16 for x in (qkv, cache_k, cache_v, k_scale, v_scale)):
        raise ValueError("dec_self_attention: qkv, the cache and the scales must start on 16 "
                         "bytes")
    out = torch.empty(bk, d, dtype=torch.bfloat16, device=qkv.device)
    _launch("dec_self_attention", "vt_dec_self_attention", _p(qkv), _p(cache_k), _p(cache_v),
            _p(k_scale), _p(v_scale), _p(anc), _p(out), bk, t_len, heads, int(pos),
            DEC_SELF_VARIANTS.index(kind), ctypes.c_float(64 ** -0.5))
    DEC_SELF_VARIANT_LAUNCHES[kind] += 1
    return out


def dec_cross_attention_plain(q, ck, cv, ck_scale, cv_scale, enc_bias, heads: int):
    dt = q.dtype
    bk, d = q.shape
    b, _, hd, s_len = ck.shape
    beams = bk // b
    qh = (q.float() * hd ** -0.5).to(dt).reshape(b, beams, heads, hd)
    if ck_scale is not None:
        qh = (qh.float() * ck_scale.float()[:, None]).to(dt)
    s = torch.einsum("bkhd,bhds->bkhs", qh.float(), ck.float())
    s = s + enc_bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(dt)
    o = torch.einsum("bkhs,bhds->bkhd", p.float(), cv.float())
    if cv_scale is not None:
        o = o * cv_scale.float()[:, None]
    return o.to(dt).reshape(bk, d)


SMEM_MAX = 232448  # shared memory a block can have on an H100


@functools.lru_cache(maxsize=None)  # a decode step asks once a layer, for one shape
def dec_cross_smem_bytes(beams: int, s_len: int, elem_bytes: int) -> int:
    """Dynamic shared memory of a dec_cross_attention block, as
    csrc/dec_cross_attention.cu's smem_bytes counts it (sp = S in whole
    64-position tiles): the ring of K/V tiles as copied (int8: four, rows of
    80 bytes, and a 3 KB bf16 strip a warp; bf16: three, rows of 144 bytes),
    scores [beams][sp + 4] f32, probabilities [beams][sp + 8] bf16, a zero
    row, q [8][68] f32, the bias, the V scales, the softmax statistics."""
    sp = 64 * -(-s_len // 64)
    ring = 4 * 64 * 80 + 4 * 3072 if elem_bytes == 1 else 3 * 64 * 144
    return (ring + 4 * beams * (sp + 4) + 2 * beams * (sp + 8) + 16 + 4 * 8 * 68 + 4 * sp
            + 4 * 64 + 8 * 8)


def dec_cross_attention(q, ck, cv, ck_scale, cv_scale, enc_bias, heads: int):
    """q [BK, d] (beams of item b are rows b*K..b*K+K-1), K/V [B, H, hd, S]
    bf16 or int8 (with scales [B, H, hd] f32), pad bias [B, S] f32 -> [BK, d]."""
    no_grad_guard("dec_cross_attention", q, ck, cv, ck_scale, cv_scale, enc_bias)
    if _on_cpu(q):
        return dec_cross_attention_plain(q, ck, cv, ck_scale, cv_scale, enc_bias, heads)
    bk, d = q.shape
    b, h, hd, s_len = ck.shape
    is_int8 = ck.dtype == torch.int8
    _req(q, "dec_cross q", torch.bfloat16)
    _req(ck, "dec_cross k", ck.dtype, (b, heads, 64, s_len), q.device)
    _req(cv, "dec_cross v", ck.dtype, (b, heads, 64, s_len), q.device)
    if ck.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"dec_cross_attention: K/V dtype {ck.dtype}")
    if is_int8 != (ck_scale is not None) or is_int8 != (cv_scale is not None):
        raise ValueError("dec_cross_attention: int8 K/V and their scales travel together")
    if is_int8:
        _req(ck_scale, "dec_cross k scale", torch.float32, (b, heads, 64), q.device)
        _req(cv_scale, "dec_cross v scale", torch.float32, (b, heads, 64), q.device)
    _req(enc_bias, "dec_cross bias", torch.float32, (b, s_len), q.device)
    if d != heads * 64 or bk % b or bk // b > 8:
        raise ValueError(f"dec_cross_attention: needs head_dim 64 and <= 8 beams (d={d}, "
                         f"rows={bk}, items={b})")
    if dec_cross_smem_bytes(bk // b, s_len, ck.element_size()) > SMEM_MAX:
        raise ValueError(f"dec_cross_attention: S={s_len} with {bk // b} beams needs more "
                         "shared memory than a block has")
    out = torch.empty(bk, d, dtype=torch.bfloat16, device=q.device)
    _launch("dec_cross_attention", "vt_dec_cross_attention", _p(q), _p(ck), _p(cv),
            _p(ck_scale), _p(cv_scale), _p(enc_bias), _p(out), b, bk // b, heads, s_len,
            int(is_int8), ctypes.c_float(64 ** -0.5))
    return out
