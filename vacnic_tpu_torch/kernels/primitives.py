"""The CUDA kernels' Python wrappers and their plain-PyTorch twins.

Every wrapper dispatches on the device of its tensors: CPU tensors take the
`*_plain` twin; CUDA tensors are checked (device, dtype, shape, contiguity),
outputs are allocated with torch.empty, the kernel is launched on the
device of its first operand and that device's current stream, whatever
device is current on the calling thread, and its launch count goes up by
one; any other tensor raises. The counts are bumped under a lock: one host
thread a card (infer/generate.generate_mm_sharded) launches at once.
There is no fallback from a CUDA tensor to the plain twin. No kernel has a
backward: every wrapper first refuses, on either device, a
call under grad mode on a tensor that requires grad (`no_grad_guard`).

The plain twins define the semantics the kernels are held to: the dtype of
the inputs is the matmul dtype (bf16 on the card, f32 in the CPU tests),
products accumulate in f32, q is rounded to that dtype after scaling and
probabilities before the value product. In f32 every rounding is a no-op.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading
from typing import NamedTuple

import torch

KERNELS = ("gemm_bf16", "layernorm", "enc_self_attention", "enc_cross_attention",
           "dec_self_attention", "dec_cross_attention", "lm_stats", "flash_attention",
           "lm_head", "cross_kv", "enc_window_attention", "cross_kv_quant")
# (the wrappers of lm_stats, flash_attention and lm_head live in
# kernels/lm_stats, kernels/flash_attn and kernels/lm_head)
LAUNCHES: dict[str, int] = {k: 0 for k in KERNELS}
# gemm_bf16 is three __global__ kernels; every launch also counts under its own
GEMM_VARIANTS = ("large_m", "small_m", "mid_m")
GEMM_VARIANT_LAUNCHES: dict[str, int] = {v: 0 for v in GEMM_VARIANTS}
# and so is layernorm
LAYERNORM_VARIANTS = ("warp", "block")
LAYERNORM_VARIANT_LAUNCHES: dict[str, int] = {v: 0 for v in LAYERNORM_VARIANTS}
# and dec_self_attention, one instance for each self-cache type
DEC_SELF_VARIANTS = ("bf16", "int8", "fp8")
DEC_SELF_VARIANT_LAUNCHES: dict[str, int] = {v: 0 for v in DEC_SELF_VARIANTS}
# enc_cross_attention's launches by their KV (the prompt rows, + the NER
# prefix's without only_image: 40 and 20 under clipcap, 36 and 16 under mlp)
ENC_CROSS_KV_LAUNCHES: dict[int, int] = {kv: 0 for kv in range(1, 65)}
# dec_cross_attention's launches by the beams of an item (any count >= 1),
# and by the plan's variant (DEC_CROSS_VARIANTS)
DEC_CROSS_BEAM_LAUNCHES: collections.Counter = collections.Counter()
DEC_CROSS_VARIANTS = ("beams", "wide", "grouped", "split")  # the launcher's variant ids, in order
DEC_CROSS_VARIANT_LAUNCHES: dict[str, int] = {v: 0 for v in DEC_CROSS_VARIANTS}
# cross_kv's product launches by the plan's variant: "cluster" (an item's row
# tiles in one cluster, S <= 1024) or "long" (past it; then cross_kv_quant)
CROSS_KV_VARIANTS = ("cluster", "long")
CROSS_KV_VARIANT_LAUNCHES: dict[str, int] = {v: 0 for v in CROSS_KV_VARIANTS}

GELU = "gelu"
_COUNT_LOCK = threading.Lock()  # the counts above are bumped from one thread a card


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for table in (LAUNCHES, GEMM_VARIANT_LAUNCHES, LAYERNORM_VARIANT_LAUNCHES,
                      DEC_SELF_VARIANT_LAUNCHES, ENC_CROSS_KV_LAUNCHES,
                      DEC_CROSS_BEAM_LAUNCHES, DEC_CROSS_VARIANT_LAUNCHES,
                      CROSS_KV_VARIANT_LAUNCHES):
            for k in table:
                table[k] = 0


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


def enc_cross_kv_counts() -> dict[int, int]:
    """Launches of enc_cross_attention by KV, the KVs launched only: they add
    up to LAUNCHES["enc_cross_attention"]."""
    return {kv: n for kv, n in ENC_CROSS_KV_LAUNCHES.items() if n}


def dec_cross_beam_counts() -> dict[int, int]:
    """Launches of dec_cross_attention by the beams of an item, the beam
    counts launched only: they add up to LAUNCHES["dec_cross_attention"]."""
    return {k: n for k, n in sorted(DEC_CROSS_BEAM_LAUNCHES.items()) if n}


def dec_cross_variant_counts() -> dict[str, int]:
    """Launches of dec_cross_attention by the plan's variant ("beams",
    "wide", "grouped", "split"): they add up to
    LAUNCHES["dec_cross_attention"]."""
    return dict(DEC_CROSS_VARIANT_LAUNCHES)


def cross_kv_variant_counts() -> dict[str, int]:
    """Launches of cross_kv's product by the plan's variant ("cluster",
    "long"): they add up to LAUNCHES["cross_kv"]."""
    return dict(CROSS_KV_VARIANT_LAUNCHES)


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


def _stream(device: torch.device | None = None) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _launch(name: str, fn: str, device: torch.device, *args,
            variant: tuple[dict[str, int], str] | None = None,
            also: tuple[dict[str, int], str] | None = None) -> None:
    """Call the library's entry point `fn` on `device` (its first tensor
    operand's) and that device's current stream; the entry points launch on
    the calling thread's current device, so another one is made current for
    the call. Counts one launch of `name`, and of `variant` and `also`, each
    a (table, key)."""
    from vacnic_tpu_torch.kernels._build import lib

    entry = getattr(lib(), fn)
    if device.index == torch.cuda.current_device():
        rc = entry(*args, _stream(device))
    else:
        with torch.cuda.device(device):
            rc = entry(*args, _stream(device))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        for table_key in (variant, also):
            if table_key is not None:
                table_key[0][table_key[1]] += 1


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
GEMM_MID_M_MAX = 2048         # mid_m's last row count (gemm_plan); above, large_m
GEMM_MID_BM = 128             # rows a mid_m block: two warpgroups
GEMM_MID_MIN_BLOCKS = 128     # mid_m: the grid the plan fills first, where the shape has one
GEMM_MID_STEP_128 = 1.8       # mid_m: a 128-column k-step's time, in 64-column k-steps
GEMM_MID_SPLIT_STEPS = 2      # mid_m: a further rank of a split, in 64-column k-steps
GEMM_SMS = 132                # an H100's streaming multiprocessors


class GemmPlan(NamedTuple):
    """Which kernel of csrc/gemm_bf16.cu a product takes, and how K is cut."""
    variant: str    # "large_m": TMA-fed 256 x 128 tiles; "small_m": split-K over a cluster;
    #                 "mid_m": TMA-fed 128 x bn tiles, split-K over a cluster
    split: int = 1  # small_m, mid_m: blocks of a cluster along K
    bn: int = 0     # mid_m: columns a block, 64 or 128; 0 where the kernel fixes them


def mid_m_blocks(plan: GemmPlan, m: int, n: int) -> int:
    """Blocks of a mid_m launch: 128-row by bn-column tiles, `split` a tile."""
    return -(-m // GEMM_MID_BM) * -(-n // plan.bn) * plan.split


def _mid_m_plan(m: int, n: int, k: int) -> GemmPlan:
    """Of the tile widths 64 and 128 and the splits 1, 2, 4 that divide the
    k tiles: among the grids of at least GEMM_MID_MIN_BLOCKS blocks, where
    the shape has one, the least estimated time -- the blocks an SM (at
    least one: a grid under a wave is no faster than one wave) times a
    block's k-steps, a 128-column k-step weighing GEMM_MID_STEP_128 of a
    64-column one, plus GEMM_MID_SPLIT_STEPS for each further rank of a
    split (its share of the cluster's reduction); fewer blocks, then the
    wider tile, on a tie.

    The weights were fitted to chip_smoke.py's gemmplan phase, which times
    every plan at M 320-4096 for each product of a layer and sets the
    layer-step of the plan's picks beside that of the best plans (PERF.md).
    A full wave of 132 blocks is not asked for: at M 512 it would move the
    d x d products from 128 blocks of split 2 (0.0082 graph ms) to 256 of
    split 4 (0.0126)."""
    k_tiles = -(-k // GEMM_BK)
    cands = []
    for bn in (64, 128):
        for split in (1, 2, 4):
            if k_tiles % split:
                continue
            plan = GemmPlan("mid_m", split, bn)
            blocks = mid_m_blocks(plan, m, n)
            step = GEMM_MID_STEP_128 if bn == 128 else 1.0
            est = (max(1.0, blocks / GEMM_SMS) * (k_tiles // split) * step
                   + GEMM_MID_SPLIT_STEPS * (split - 1))
            cands.append((blocks < GEMM_MID_MIN_BLOCKS, est, blocks, -bn, plan))
    return min(cands)[-1]


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
    257 <= m <= GEMM_MID_M_MAX: the TMA kernel of 128-row tiles with split-K
    (_mid_m_plan). Above: the TMA kernel of 256 x 128 tiles. The bound is
    where the second overtakes the first: summed over a layer-step (qkv,
    self and cross out, cross q, fc1, fc2) the 128-row kernel took 0.1780
    graph ms at M 2048 against the 256-row kernel's 0.1817, and 0.3195
    against 0.2624 at M 4096 (chip_smoke.py's kernels phase; PERF.md)."""
    if m < 1 or k < 32 or k % 32 or n < 64 or n % 64:
        raise ValueError(f"gemm: needs M >= 1, K % 32 == 0 and N % 64 == 0, got M={m} K={k} N={n}")
    if m > GEMM_MID_M_MAX:
        return GemmPlan("large_m")
    if m > GEMM_SMALL_M_MAX:
        return _mid_m_plan(m, n, k)
    k_tiles = -(-k // GEMM_BK)
    fits = [s for s in (1, 2, 4) if k_tiles % s == 0 and n // 64 * s <= GEMM_SMS]
    return GemmPlan("small_m", max(fits, default=1))


_VARIANT_ID = {"large_m": 1, "small_m": 2, "mid_m": 3}


def gemm(a, w, bias=None, residual=None, act=None, out_dtype=torch.float32):
    """epilogue(a [M, K] @ w [K, N]): + bias [N] f32, exact gelu if
    act == "gelu", + residual [M, N] f32; out_dtype f32 or bf16."""
    no_grad_guard("gemm", a, w, bias, residual)
    if _on_cpu(a):
        return gemm_plain(a, w, bias, residual, act, out_dtype)
    return _gemm_planned(gemm_plan(a.shape[0], w.shape[1], a.shape[1]), a, w, bias, residual,
                         act, out_dtype)


def _gemm_planned(plan: GemmPlan, a, w, bias=None, residual=None, act=None,
                  out_dtype=torch.float32):
    """gemm on the card by the given plan, whatever gemm_plan would say: the
    entry through which tests and chip_smoke.py hold each kernel to the twin
    and time it at shapes that the plan gives another. The port's paths go
    through `gemm`."""
    no_grad_guard("gemm", a, w, bias, residual)
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
    out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    _launch("gemm_bf16", "vt_gemm_bf16", a.device, _p(a), _p(w), _p(bias), _p(residual),
            _p(out), m, n, k, int(act == GELU), int(out_dtype == torch.bfloat16),
            _VARIANT_ID[plan.variant], plan.split, plan.bn,
            variant=(GEMM_VARIANT_LAUNCHES, plan.variant))
    return out


def gemm_smem_bytes(m: int, n: int, k: int) -> int:
    """Dynamic shared memory a block of the product's kernel takes, as the
    built library states it."""
    from vacnic_tpu_torch.kernels._build import lib

    plan = gemm_plan(m, n, k)
    return lib().vt_gemm_smem_bytes(_VARIANT_ID[plan.variant], m, plan.bn)


# ---------------------------------------------------------------------------
# The decoder's cross K/V: one product a layer, its epilogue quantizing
# ---------------------------------------------------------------------------

def quantize_cross_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., S] -> (int8 values, f32 scales [...]).

    Symmetric per-(layer, item, head, channel) quantization over S. The
    channel scales cost nothing in the kernel: K's folds into q before the
    score sum over hd, V's into the head output after the sum over S.
    torch.round rounds half to even, as jnp.round does."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def cross_kv_plain(x, w, b, heads: int, int8: bool):
    """x [B, S, d] in the matmul dtype, w [L, d, 2d] (each layer's Wk | Wv)
    in it, b [L, 2d] -> (k, v [L, B, H, hd, S], k_scale, v_scale [L, B, H,
    hd] f32 or None): each layer's K and V as two f32 products of x's
    values, + the f32 bias, rounded to x's dtype; int8: quantize_cross_kv
    over S."""
    bsz, s_len, d = x.shape
    xf = x.float()
    outs, scales = ([], []), ([], [])
    for wl, bl in zip(w, b):
        for i, (wh, bh) in enumerate(zip(wl.split(d, dim=1), bl.split(d))):
            y = xf @ wh.float().contiguous() + bh.float()  # one layer's [B, S, d] f32 at a time
            y = y.to(x.dtype).reshape(bsz, s_len, heads, d // heads).permute(0, 2, 3, 1)
            if int8:
                yq, sc = quantize_cross_kv(y)
                outs[i].append(yq)
                scales[i].append(sc)
            else:
                outs[i].append(y.contiguous())
    k, v = (torch.stack(o).contiguous() for o in outs)
    if not int8:
        return k, v, None, None
    return k, v, *(torch.stack(sc).contiguous() for sc in scales)


CROSS_KV_BM = 256        # positions a row tile of csrc/gemm_bf16.cu's cross_kv_gemm_kernel
CROSS_KV_MAX_TILES = 4   # row tiles an item: a cluster of 2 column x 4 row tiles, 8 blocks
CROSS_KV_MAX_S = 16384   # LED's encoder positions: the longest S the plan takes


class CrossKvPlan(NamedTuple):
    """How csrc/gemm_bf16.cu's cross_kv_gemm_kernel covers one layer."""
    tiles: int    # row tiles an item, ceil(S / 256)
    cluster: int  # blocks a cluster: 2 column tiles x `tiles` ("cluster"), 2 ("long")
    variant: str = "cluster"  # "long": past CROSS_KV_MAX_TILES, int8 by cross_kv_quant_kernel


@functools.lru_cache(maxsize=None)
def cross_kv_plan(batch: int, s_len: int, d: int) -> CrossKvPlan:
    """The launch of one layer's cross K/V at `batch` items of `s_len`
    positions and model width d. Pure: the CUDA launcher only follows it.
    An item's positions are whole row tiles of 256, never shared with
    another item. Up to 1024 positions (BART's) one cluster holds all of an
    item's rows of a column pair and takes its column maxima (the int8
    scales) in distributed shared memory ("cluster"). Past that, to
    CROSS_KV_MAX_S (LED's 16384), the clusters are the column pair alone
    and the product is stored in bf16; with int8, cross_kv_quant_kernel
    then takes each (item, channel)'s maximum and quantizes ("long"), to
    the same bits. Raises ValueError for batch < 1, S outside 1..16384, d
    not a multiple of 64 or a grid past 65535 rows of blocks."""
    tiles = -(-s_len // CROSS_KV_BM)
    if (batch < 1 or not 1 <= s_len <= CROSS_KV_MAX_S or d < 64 or d % 64
            or batch * tiles > 65535):
        raise ValueError(f"cross_kv: needs batch >= 1, 1 <= S <= {CROSS_KV_MAX_S}, d % 64 == 0 "
                         f"and batch x ceil(S / {CROSS_KV_BM}) <= 65535 (batch={batch}, "
                         f"S={s_len}, d={d})")
    if tiles <= CROSS_KV_MAX_TILES:
        return CrossKvPlan(tiles, 2 * tiles)
    return CrossKvPlan(tiles, 2, "long")


def cross_kv(x, w, b, heads: int, int8: bool):
    """The decoder's cross K/V of every layer, one launch a layer: x [B, S,
    d] (the encoder's output in the matmul dtype), w [L, d, 2d] (each
    layer's Wk | Wv), b [L, 2d] f32 -> (k, v [L, B, H, hd, S] int8 or bf16,
    k_scale, v_scale [L, B, H, hd] f32 or None). y = x @ w + b rounded to
    bf16, then with int8 quantized over S as quantize_cross_kv (kernel:
    csrc/gemm_bf16.cu's cross_kv_gemm_kernel, `cross_kv_plan`). Past 1024
    positions with int8, a second launch a layer (cross_kv_quant_kernel)
    quantizes the product's bf16 copy. Also LED's global keys and values
    (bf16, one layer at a time: kernels/encoder_stack)."""
    no_grad_guard("cross_kv", x, w, b)
    if _on_cpu(x):
        return cross_kv_plain(x, w, b, heads, int8)
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"cross_kv: x [B, S, d] and w [L, d, 2d], got shapes "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    bsz, s_len, d = x.shape
    n_layers = w.shape[0]
    _req(x, "cross_kv x", torch.bfloat16)
    _req(w, "cross_kv w", torch.bfloat16, (n_layers, d, 2 * d), x.device)
    _req(b, "cross_kv b", torch.float32, (n_layers, 2 * d), x.device)
    if heads < 1 or d % heads:
        raise ValueError(f"cross_kv: {heads} heads do not divide d={d}")
    plan = cross_kv_plan(bsz, s_len, d)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("cross_kv: x and w must start on 16 bytes")
    shape = (n_layers, bsz, heads, d // heads, s_len)
    k = torch.empty(shape, dtype=torch.int8 if int8 else torch.bfloat16, device=x.device)
    v = torch.empty_like(k)
    ks = vs = None
    if int8:
        ks = torch.empty(shape[:-1], dtype=torch.float32, device=x.device)
        vs = torch.empty_like(ks)
    if plan.variant == "long":
        if int8:  # the product's bf16 K and V of a layer, before cross_kv_quant_kernel
            tmp_k = torch.empty(shape[1:], dtype=torch.bfloat16, device=x.device)
            tmp_v = torch.empty_like(tmp_k)
        for layer in range(n_layers):
            yk, yv = (tmp_k, tmp_v) if int8 else (k[layer], v[layer])
            _launch("cross_kv", "vt_cross_kv_long", x.device, _p(x), _p(w[layer]), _p(b[layer]),
                    _p(yk), _p(yv), bsz, s_len, d, plan.tiles,
                    variant=(CROSS_KV_VARIANT_LAUNCHES, "long"))
            if int8:
                _launch("cross_kv_quant", "vt_cross_kv_quant", x.device, _p(yk), _p(yv),
                        _p(k[layer]), _p(v[layer]), _p(ks[layer]), _p(vs[layer]), bsz * d, s_len)
        return k, v, ks, vs
    for layer in range(n_layers):
        _launch("cross_kv", "vt_cross_kv", x.device, _p(x), _p(w[layer]), _p(b[layer]),
                _p(k[layer]), _p(v[layer]), _p(ks[layer] if int8 else None),
                _p(vs[layer] if int8 else None), bsz, s_len, d, plan.tiles, int(int8),
                variant=(CROSS_KV_VARIANT_LAUNCHES, "cluster"))
    return k, v, ks, vs


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
    _launch("layernorm", "vt_layernorm", x.device, _p(x), _p(gb), _p(y32), _p(y16), r, d,
            ctypes.c_float(eps), _LN_VARIANT_ID[plan.variant], plan.slots,
            variant=(LAYERNORM_VARIANT_LAUNCHES, plan.variant))
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
    _launch("enc_self_attention", "vt_enc_self_attention", qkv.device, _p(qkv), _p(bias),
            _p(out), batch, seq, heads, ctypes.c_float(64 ** -0.5))
    return out


def window_attention_plain(q, k, v, bias, window: int, global_tokens: int):
    """LED's windowed self-attention, the arithmetic that the layer-by-layer
    encoder (models/bart.led_self_attention) and enc_window_attention's twin
    share: q [B, H, S, hd] already scaled (in the matmul dtype), k, v [B, H,
    S, hd], bias [B, S] additive f32 (0 kept, very negative padded) -> [B, H,
    S, hd] in v's dtype. Row i's columns are the global keys j <
    global_tokens, then the band j >= global_tokens with |i - j| <= window,
    as transformers' LEDEncoderSelfAttention concatenates them ([global ||
    band]; a global key in the band counted once), each + its pad bias; an
    f32 softmax; a padded row's probabilities 0; P rounded to v's dtype, P V
    summed in f32. Queries go in blocks of `window` rows against their keys
    alone, so memory grows with S x window, not S^2."""
    bsz, heads, s_len, hd = q.shape
    dt = v.dtype
    g = global_tokens
    bias = bias.float()
    blk = max(window, 1)
    out = torch.empty_like(v)
    gk = torch.arange(g, device=q.device)
    for i0 in range(0, s_len, blk):
        i1 = min(s_len, i0 + blk)
        k0 = max(g, i0 - window)
        k1 = max(k0, min(s_len, i1 + window))  # empty where the global keys cover the band
        keys = torch.cat([gk, torch.arange(k0, k1, device=q.device)])
        rows = torch.arange(i0, i1, device=q.device)[:, None]
        band = (keys[None, :] >= g) & ((rows - keys[None, :]).abs() <= window)
        ok = (keys[None, :] < g) | band  # [rows, keys]
        s = torch.einsum("bhid,bhjd->bhij", q[:, :, i0:i1].float(), k[:, :, keys].float())
        s = s + bias[:, None, None, keys]
        s = s.masked_fill(~ok[None, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        p = p.masked_fill((bias[:, i0:i1] < 0)[:, None, :, None], 0.0)
        o = torch.einsum("bhij,bhjd->bhid", p.to(dt).float(), v[:, :, keys].float())
        out[:, :, i0:i1] = o.to(dt)
    return out


def enc_window_attention_plain(qkv, bias, batch: int, seq: int, heads: int, window: int,
                               global_tokens: int):
    dt = qkv.dtype
    d = qkv.shape[1] // 3
    hd = d // heads
    x = qkv.reshape(batch, seq, 3, heads, hd).permute(2, 0, 3, 1, 4)  # [3, B, H, S, hd]
    q = (x[0].float() * hd ** -0.5).to(dt)
    o = window_attention_plain(q, x[1], x[2], bias, window, global_tokens)
    return o.permute(0, 2, 1, 3).reshape(batch * seq, d)


ENC_WINDOW_MAX_GLOBAL = 64  # global tokens: they must lie in the first key tile


def enc_window_attention(qkv, bias, batch: int, seq: int, heads: int, window: int,
                         global_tokens: int):
    """LED's windowed self-attention of the fused stack: qkv [B*S, 3d] (q |
    k | v), additive pad bias [B, S] f32 -> [B*S, d], window_attention_plain's
    semantics (the global tokens' own rows are computed as any other's;
    encoder_stack overwrites them with their global attention). Kernel:
    csrc/enc_attention.cu's enc_window_kernel."""
    no_grad_guard("enc_window_attention", qkv, bias)
    if _on_cpu(qkv):
        return enc_window_attention_plain(qkv, bias, batch, seq, heads, window, global_tokens)
    d = qkv.shape[1] // 3
    _req(qkv, "enc_window qkv", torch.bfloat16, (batch * seq, 3 * d))
    _req(bias, "enc_window bias", torch.float32, (batch, seq), qkv.device)
    if (d != heads * 64 or seq % 64 or seq > 32768 or window < 0
            or not 0 <= global_tokens <= ENC_WINDOW_MAX_GLOBAL):
        raise ValueError(f"enc_window_attention: needs head_dim 64, S % 64 == 0, S <= 32768, "
                         f"window >= 0 and 0 <= global tokens <= {ENC_WINDOW_MAX_GLOBAL} "
                         f"(d={d}, heads={heads}, S={seq}, window={window}, "
                         f"global={global_tokens})")
    out = torch.empty(batch * seq, d, dtype=torch.bfloat16, device=qkv.device)
    _launch("enc_window_attention", "vt_enc_window_attention", qkv.device, _p(qkv), _p(bias),
            _p(out), batch, seq, heads, window, global_tokens, ctypes.c_float(64 ** -0.5))
    return out


def global_rows_plain(qg, kg, vg, bias, heads: int):
    """LED's global rows on the layer-by-layer path: qg [B, G, d] (the global
    tokens' query_global projections, unscaled), kg, vg [B, S, d]
    (key_global, value_global of every token), bias [B, S] -> [B, G, d]: each
    global token's attention over every unpadded key, as
    dec_cross_attention_plain computes a beam's (q scaled by hd**-0.5 and
    rounded, an f32 softmax, P rounded before the f32 value sum), which is
    what the fused stack runs for them."""
    bsz, g, d = qg.shape
    s_len, hd = kg.shape[1], d // heads
    ck = kg.reshape(bsz, s_len, heads, hd).permute(0, 2, 3, 1)
    cv = vg.reshape(bsz, s_len, heads, hd).permute(0, 2, 3, 1)
    o = dec_cross_attention_plain(qg.reshape(bsz * g, d), ck, cv, None, None, bias, heads)
    return o.reshape(bsz, g, d)


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
    _launch("enc_cross_attention", "vt_enc_cross_attention", q.device, _p(q), _p(ck), _p(cv),
            _p(out), batch, seq, kv, heads, ctypes.c_float(64 ** -0.5),
            variant=(ENC_CROSS_KV_LAUNCHES, kv))
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
    _launch("dec_self_attention", "vt_dec_self_attention", qkv.device, _p(qkv), _p(cache_k),
            _p(cache_v), _p(k_scale), _p(v_scale), _p(anc), _p(out), bk, t_len, heads, int(pos),
            DEC_SELF_VARIANTS.index(kind), ctypes.c_float(64 ** -0.5),
            variant=(DEC_SELF_VARIANT_LAUNCHES, kind))
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
DEC_CROSS_GROUP = 8  # beams an operand: the n8 operand of csrc/dec_cross_attention.cu's mma.sync
DEC_CROSS_WIDE_MAX = 24  # beams of the widest wide instance: three n8 operands


DEC_CROSS_SPLITS = (2, 4, 8)  # blocks a split's cluster may have; 8 is the portable largest
SMEM_SM = 233472  # shared memory of an H100 SM; a block reserves 1 KB of it


def dec_cross_split_positions(s_len: int, split: int) -> int:
    """Positions a rank of a split over `split` blocks takes: whole tiles of 64."""
    return -(-(-(-s_len // 64)) // split) * 64


@functools.lru_cache(maxsize=None)  # a decode step asks once a layer, for one shape
def dec_cross_smem_bytes(beams: int, s_len: int, elem_bytes: int, variant: str = "beams",
                         split: int = 1) -> int:
    """Dynamic shared memory of a dec_cross_attention block, as
    csrc/dec_cross_attention.cu's smem_bytes ("beams": a block of `beams`
    beams; "grouped": of 8) and wide_smem_bytes ("wide": all `beams` in
    one block) count it, sp = S in whole 64-position tiles: the ring of K/V
    tiles as copied (int8: four, rows of 80 bytes; bf16: three, rows of 144
    bytes), scores [beams][sp + 4] f32, a zero row; "beams" and "grouped"
    also probabilities [beams][sp + 8] bf16, int8's 3 KB bf16 strip a warp,
    q [8][68] f32, the bias, the V scales, the softmax statistics; "wide"
    only the V scales and the four warps' score maxima [4][beams] f32 (its
    probabilities overlay its scores, its int8 tiles become bf16 in
    registers, its q goes straight to registers, its bias is read from
    device memory); "split" the "beams" block's layout for `beams` beams
    over a rank's positions (dec_cross_split_positions), then the exchange
    of the cluster: the row maxima and sums [8] and the partial outputs
    [128][4], f32."""
    sp = 64 * -(-s_len // 64)
    ring = 4 * 64 * 80 if elem_bytes == 1 else 3 * 64 * 144
    if variant == "split":
        sp = dec_cross_split_positions(s_len, split)
        strips = 4 * 3072 if elem_bytes == 1 else 0
        return (ring + strips + 4 * beams * (sp + 4) + 2 * beams * (sp + 8) + 16 + 4 * 8 * 68
                + 4 * sp + 4 * 64 + 8 * 8 + 4 * 2 * 8 + 16 * 128)
    if variant == "wide":
        return ring + 4 * beams * (sp + 4) + 16 + 4 * 64 + 4 * 4 * beams
    if variant == "grouped":
        beams = DEC_CROSS_GROUP
    strips = 4 * 3072 if elem_bytes == 1 else 0
    return (ring + strips + 4 * beams * (sp + 4) + 2 * beams * (sp + 8) + 16 + 4 * 8 * 68
            + 4 * sp + 4 * 64 + 8 * 8)


class DecCrossPlan(NamedTuple):
    """How csrc/dec_cross_attention.cu launches an item's beams."""
    variant: str      # "beams": 1-8, a block an (item, head) with room for exactly them;
    #                   "wide": 9-24, a block an (item, head) for all of them, q as
    #                   ceil(beams / 8) n8 operands; "grouped": a block a group of 8;
    #                   "split": 1-8, S over a cluster of `groups` blocks an (item, head)
    groups: int       # blocks an (item, head): ceil(beams / 8) grouped, the split's, else 1
    group_beams: int  # beams a block holds room for: all (wide) or min(beams, 8)
    last_beams: int   # beams of the last n8 operand
    smem: int         # dynamic shared memory a block, bytes


@functools.lru_cache(maxsize=None)  # a decode step asks once a layer, for one shape
def dec_cross_plan(beams: int, s_len: int, elem_bytes: int) -> DecCrossPlan:
    """The launch of dec_cross_attention for `beams` beams an item over S =
    s_len positions of K/V with `elem_bytes` bytes an element (1: int8, 2:
    bf16). Pure: the wrapper passes its variant, blocks and bytes to the
    CUDA launcher, which makes its grid of them and refuses a plan that is
    not its kernel instance's. Up to 8 beams: one block an (item, head),
    with room for exactly those beams (one kernel instance a beam count).
    9-24 beams: one wide block an (item, head) for all of them, where that
    block fits a SM's shared memory. Otherwise (more beams, or an S whose
    scores do not fit): groups of 8, a block a (group, head, item), each
    with the shared memory of 8 beams, so the largest S does not shrink with
    the beam count. Up to 8 beams at an S whose block no SM holds (LED's
    16384 positions): S over a cluster of 2, 4 or 8 blocks ("split"), the
    fewest whose block two fit an SM, else the fewest that fit one. Raises
    ValueError for beams < 1, S < 1, or a block that no H100 SM holds.

    The rule follows the readings of chip_smoke.py's crossplan phase
    (PERF.md §6; H100 80GB HBM3 at 700 W): at S 512, H 16 and B 8, 16 and
    32, the wide block took 0.52-0.97x the groups' time at every int8 shape
    of 9, 11, 16, 17 and 24 beams (B 32 x 16: 0.0269 against 0.0496 graph
    ms), and 0.60-0.95x at 11 of the 15 bf16 ones (1.01-1.12x at B 8 x 16,
    17, 24 and B 32 x 16). No path runs bf16 cross K/V on the card, so the
    rule makes no exception for them."""
    if beams < 1 or s_len < 1 or elem_bytes not in (1, 2):
        raise ValueError(f"dec_cross_attention: needs beams >= 1, S >= 1 and 1- or 2-byte K/V "
                         f"(beams={beams}, S={s_len}, elem_bytes={elem_bytes})")
    if beams <= DEC_CROSS_GROUP:
        plan = dec_cross_variant_plan("beams", beams, s_len, elem_bytes)
        if plan.smem > SMEM_MAX:
            plan = _dec_cross_split_plan(beams, s_len, elem_bytes) or plan
    else:
        plan = dec_cross_variant_plan("wide", beams, s_len, elem_bytes)
        if beams > DEC_CROSS_WIDE_MAX or plan.smem > SMEM_MAX:
            plan = dec_cross_variant_plan("grouped", beams, s_len, elem_bytes)
    if plan.smem > SMEM_MAX:
        raise ValueError(f"dec_cross_attention: S={s_len} with {plan.group_beams} beams a block "
                         f"needs {plan.smem} bytes of shared memory, more than a block has "
                         f"({SMEM_MAX})")
    return plan


def _dec_cross_split_plan(beams: int, s_len: int, elem_bytes: int) -> DecCrossPlan | None:
    """The split of dec_cross_plan's rule, or None where none fits: among
    the splits whose every rank holds positions, the fewest blocks whose
    block two fit an SM, else the fewest that fit one."""
    plans = [dec_cross_variant_plan("split", beams, s_len, elem_bytes, n) for n in DEC_CROSS_SPLITS
             if (n - 1) * dec_cross_split_positions(s_len, n) < s_len]
    for fits in (lambda p: 2 * (p.smem + 1024) <= SMEM_SM, lambda p: p.smem <= SMEM_MAX):
        for p in plans:
            if fits(p):
                return p
    return None


def dec_cross_variant_plan(variant: str, beams: int, s_len: int, elem_bytes: int,
                           split: int = 2) -> DecCrossPlan:
    """The plan of one variant at this shape, whether or not dec_cross_plan
    picks it and whether or not the launcher has an instance for it or a SM
    holds its block (the launcher refuses such a plan); `split` the blocks
    of a "split" plan."""
    groups = -(-beams // DEC_CROSS_GROUP)
    last = beams - DEC_CROSS_GROUP * (groups - 1)
    if variant == "split":
        return DecCrossPlan("split", split, beams, beams,
                            dec_cross_smem_bytes(beams, s_len, elem_bytes, "split", split))
    smem = dec_cross_smem_bytes(beams, s_len, elem_bytes, variant)
    if variant == "grouped":
        return DecCrossPlan("grouped", groups, DEC_CROSS_GROUP, last, smem)
    return DecCrossPlan(variant, 1, beams, last, smem)


def dec_cross_attention(q, ck, cv, ck_scale, cv_scale, enc_bias, heads: int):
    """q [BK, d] (beams of item b are rows b*K..b*K+K-1), K/V [B, H, hd, S]
    bf16 or int8 (with scales [B, H, hd] f32), pad bias [B, S] f32 -> [BK, d].
    Any beam count K: past 8 one wide block an (item, head) or groups of 8,
    and to 8 past shared memory's S a split over a cluster
    (`dec_cross_plan`); the launch counts under K (`dec_cross_beam_counts`)
    and under the plan's variant (`dec_cross_variant_counts`) as well."""
    no_grad_guard("dec_cross_attention", q, ck, cv, ck_scale, cv_scale, enc_bias)
    if _on_cpu(q):
        return dec_cross_attention_plain(q, ck, cv, ck_scale, cv_scale, enc_bias, heads)
    return _dec_cross_planned(None, q, ck, cv, ck_scale, cv_scale, enc_bias, heads)


def _dec_cross_planned(plan: DecCrossPlan | None, q, ck, cv, ck_scale, cv_scale, enc_bias,
                       heads: int):
    """dec_cross_attention on the card by the given plan (None:
    dec_cross_plan's), whatever dec_cross_plan would say: the entry through
    which tests and chip_smoke.py hold each variant to the twin and time it
    at shapes that the plan gives another. The port's paths go through
    `dec_cross_attention`."""
    no_grad_guard("dec_cross_attention", q, ck, cv, ck_scale, cv_scale, enc_bias)
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
    if d != heads * 64 or bk < b or bk % b:
        raise ValueError(f"dec_cross_attention: needs head_dim 64 and whole beams an item "
                         f"(d={d}, rows={bk}, items={b})")
    beams = bk // b
    if plan is None:
        plan = dec_cross_plan(beams, s_len, ck.element_size())  # raises where no block holds it
    out = torch.empty(bk, d, dtype=torch.bfloat16, device=q.device)
    _launch("dec_cross_attention", "vt_dec_cross_attention", q.device, _p(q), _p(ck), _p(cv),
            _p(ck_scale), _p(cv_scale), _p(enc_bias), _p(out), b, beams,
            DEC_CROSS_VARIANTS.index(plan.variant), plan.groups, plan.smem, heads, s_len,
            int(is_int8), ctypes.c_float(64 ** -0.5),
            variant=(DEC_CROSS_BEAM_LAUNCHES, beams),
            also=(DEC_CROSS_VARIANT_LAUNCHES, plan.variant))
    return out
