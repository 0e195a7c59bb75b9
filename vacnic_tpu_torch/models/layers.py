"""Functional NN primitives (port of vacnic_tpu/models/layers.py).

Plain functions over dict parameter trees. Linear kernels keep the JAX
package's [in, out] layout (models/weights_io.py loads them untransposed),
so `linear` is `x @ kernel`. Products accumulate in float32 and round once
to the input dtype, the recipe of the JAX `preferred_element_type=float32`
dots, through models/products.product (bf16 tensor cores on the card where
both operands are bf16).

Training: `dropout` takes a 63-bit seed where JAX takes a key, and
`RngStream` / `fold_in` derive one seed per call site from (base seed,
layer, site), as JAX's `fold_in` does. Each site draws its mask from a
generator made for it from that seed alone, so a layer recomputed under
`torch.utils.checkpoint` draws the masks of the forward that ran. A
`RowShardSeed` (the data-parallel training step's) makes a rank's dropout
draw its rows of the global batch's mask, a `ColShardSeed` (the
tensor-parallel step's) its columns of a cut activation's.

Tensor parallelism (`tp`, a core/tensor_parallel.ModelShard; None is the
one-process path): `column_linear` and `row_linear` are the Megatron pair,
and `mha` runs this rank's heads, read from the shard's width.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from vacnic_tpu_torch.core.tensor_parallel import (
    ModelShard,
    column_slice,
    copy_to_model_parallel,
    reduce_from_model_parallel,
)
from vacnic_tpu_torch.kernels.flash_attn import flash_attention, flash_eligible
from vacnic_tpu_torch.kernels.primitives import differentiated
from vacnic_tpu_torch.models.products import product

Params = dict[str, Any]


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="none")


ACT2FN: dict[str, Callable] = {
    "gelu": _gelu_exact,
    "gelu_new": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "relu": torch.relu,
    "tanh": torch.tanh,
    # OpenAI CLIP's x*sigmoid(1.702x) ("quick gelu")
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
}


# ---------------------------------------------------------------------------
# Dropout seeds
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit integers that spreads
    every input bit over the output."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


class RowShardSeed(int):
    """A dropout seed for one rank's rows of a global batch: the batch is
    cut into `world` equal contiguous shares and this rank holds share
    `rank`. `dropout` under it draws the mask of the global batch (a
    tensor's leading dimension times `world` rows) and keeps the rows
    [rank * n, (rank + 1) * n) of its n, so each row gets the mask it gets
    in one process. That costs `world` times the random bits of the rank's
    own mask. `fold_in` and `split` keep the shard, so every seed derived
    from this one is a RowShardSeed too; it travels with the value, into a
    layer that torch.utils.checkpoint recomputes on autograd's thread."""

    def __new__(cls, seed: int, rank: int, world: int):
        if not 0 <= rank < world:
            raise ValueError(f"RowShardSeed: rank {rank} of {world}")
        obj = super().__new__(cls, seed)
        obj.rank, obj.world = rank, world
        return obj


class ColShardSeed(RowShardSeed):
    """A dropout seed for one model rank's slice of a cut activation: its
    dimension `dim` is cut into `col_world` equal slices and this rank holds
    slice `col_rank`. `dropout` under it draws the mask of the whole
    activation and keeps that slice, so each column gets its one-process
    mask; the rows stay those of `seed`'s RowShardSeed, if it is one. Made
    at the call site (`column_seed`) and consumed there: `fold_in` keeps the
    row shard only."""

    def __new__(cls, seed: int, col_rank: int, col_world: int, dim: int = -1):
        if not 0 <= col_rank < col_world:
            raise ValueError(f"ColShardSeed: rank {col_rank} of {col_world}")
        rank, world = (seed.rank, seed.world) if isinstance(seed, RowShardSeed) else (0, 1)
        obj = super().__new__(cls, seed, rank, world)
        obj.col_rank, obj.col_world, obj.dim = col_rank, col_world, dim
        return obj


def column_seed(seed: int | None, tp: ModelShard | None, dim: int = -1) -> int | None:
    """The seed of a dropout on an activation cut over the model group along
    `dim` (the output of a column-parallel product); `seed` itself without
    tensor parallelism or without dropout."""
    if seed is None or tp is None:
        return seed
    return ColShardSeed(seed, tp.rank, tp.size, dim)


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from `seed` and the integer `data` (the port's
    jax.random.fold_in); a RowShardSeed stays one, of the same shard."""
    out = _mix64(_mix64(seed & _M64) ^ (data & _M64)) >> 1
    if isinstance(seed, RowShardSeed):
        return RowShardSeed(out, seed.rank, seed.world)
    return out


def split(seed: int) -> tuple[int, int]:
    """Two independent seeds from one (jax.random.split into two)."""
    return fold_in(seed, 0), fold_in(seed, 1)


def dropout(x: torch.Tensor, rate: float, seed: int | None) -> torch.Tensor:
    """Inverted dropout; seed None or rate 0 is the identity (the eval path).

    JAX's default keep rule (vacnic_tpu/models/layers.py:84-108): uniform
    16-bit integers compared against round(keep * 65536), so the keep
    probability is that threshold over 65536 (0.899994 at rate 0.1). The
    bits come from a generator on x's device seeded with `seed` alone; under
    a RowShardSeed, the rank's rows of the global batch's bits, under a
    ColShardSeed also its slice of the whole activation's."""
    if seed is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    thresh = min(int(round(keep * 65536.0)), 65535)
    g = torch.Generator(device=x.device)
    g.manual_seed(int(seed))
    n = x.shape[0]
    world = seed.world if isinstance(seed, RowShardSeed) else 1
    shape = [n * world, *x.shape[1:]]
    col = isinstance(seed, ColShardSeed)
    if col:
        dim = seed.dim % x.dim()
        if dim == 0:
            raise ValueError("ColShardSeed: the leading (row) dimension is not a column")
        shape[dim] *= seed.col_world
    bits = torch.randint(0, 65536, shape, generator=g, device=x.device, dtype=torch.int32)
    if world > 1:
        bits = bits[seed.rank * n:(seed.rank + 1) * n]
    if col:
        bits = bits.narrow(dim, seed.col_rank * x.shape[dim], x.shape[dim])
    return torch.where(bits < thresh, x / keep, torch.zeros_like(x))


class RngStream:
    """Per-call-site seeds: the n-th `next()` is fold_in(seed, n). A stream
    made from None yields None, and every dropout it feeds is the identity."""

    def __init__(self, seed: int | None):
        self._seed = seed
        self._n = 0

    def next(self) -> int | None:
        if self._seed is None:
            return None
        self._n += 1
        return fold_in(self._seed, self._n)


NO_DROPOUT = RngStream(None)  # the eval path's stream: next() is always None, nothing moves


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ kernel (+ bias) with the kernel rounded to x.dtype first, a
    float32 accumulator, cast back to x.dtype."""
    y = product(x, p["kernel"].to(x.dtype), cotangent="bf16")
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def column_linear(p: Params, x: torch.Tensor, tp: ModelShard | None = None) -> torch.Tensor:
    """`linear` with this rank's output columns of the kernel and its slice
    of the (replicated) bias: the rank's columns of the one-process output.
    x is whole on every rank; the caller passes it through
    copy_to_model_parallel once for all the products that read it."""
    if tp is not None and "bias" in p:
        p = {**p, "bias": column_slice(p["bias"], tp)}
    return linear(p, x)


def row_linear(p: Params, x: torch.Tensor, tp: ModelShard | None = None) -> torch.Tensor:
    """`linear` of a cut input x (this rank's columns) with this rank's input
    rows of the kernel: the f32 partial products are summed over the model
    group, then the bias is added once and the sum rounded once to x.dtype,
    as the one-process product is."""
    if tp is None:
        return linear(p, x)
    y = reduce_from_model_parallel(product(x, p["kernel"].to(x.dtype), cotangent="bf16"), tp)
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def embed(p: Params, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    out = p["weight"][ids.long()]
    return out.to(dtype) if dtype is not None else out


def expand_mask(mask: torch.Tensor, tgt_len: int | None = None,
                dtype=torch.float32) -> torch.Tensor:
    """[B, S] {0,1} keep-mask -> additive [B, 1, T, S], min-float where masked
    (HF `_expand_mask`)."""
    bsz, src_len = mask.shape
    tgt_len = tgt_len if tgt_len is not None else src_len
    m = mask[:, None, None, :].to(dtype).expand(bsz, 1, tgt_len, src_len)
    return (1.0 - m) * torch.finfo(dtype).min


def causal_mask(tgt_len: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[1, 1, T, T] additive causal mask (HF `_make_causal_mask`)."""
    i = torch.arange(tgt_len, device=device)[:, None]
    j = torch.arange(tgt_len, device=device)[None, :]
    m = torch.where(j <= i, torch.zeros((), dtype=dtype, device=device),
                    torch.full((), torch.finfo(dtype).min, dtype=dtype, device=device))
    return m[None, None]


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).permute(0, 2, 1, 3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * hd)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor | None) -> torch.Tensor:
    """The softmax-then-P·V attention of JAX attention_core (:166): scores and
    softmax in float32, probabilities cast to v.dtype before the value
    product, which accumulates in float32."""
    scores = product(q, k.transpose(-1, -2), cotangent="f32")
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1)
    return product(probs.to(v.dtype), v, cotangent="bf16").to(v.dtype)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor | None) -> torch.Tensor:
    """q [B,H,T,hd] (pre-scaled), k/v [B,H,S,hd], additive mask [B|1,1,T,S].

    Shapes that `flash_eligible` accepts (the 512-token encoder
    self-attention) go to kernels/flash_attn.flash_attention: the CUDA
    kernel on the card, its plain twin on the CPU. The JAX package takes
    that route only under VACNIC_PALLAS=1; the port always does, outside
    autograd. On the card the kernel runs in bf16, as the fused stacks do:
    other inputs are rounded to bf16 and the output is cast back to v.dtype.

    The kernel has no backward. When grad mode is on and q, k or v requires
    grad (a differentiated training forward), every shape takes
    `attention_plain`, the XLA recipe that JAX training runs
    (vacnic_tpu/models/layers.py:166-197 without VACNIC_PALLAS). Under
    torch.no_grad() (the teacher, eval) the kernel runs as above. Other
    shapes take `attention_plain`."""
    if not flash_eligible(q, k, mask) or differentiated(q, k, v):
        return attention_plain(q, k, v, mask)
    if q.is_cuda and v.dtype != torch.bfloat16:
        bf = torch.bfloat16
        return flash_attention(q.to(bf), k.to(bf), v.to(bf), mask).to(v.dtype)
    return flash_attention(q, k, v, mask)


def mha(p: Params, hidden: torch.Tensor, key_value: torch.Tensor | None = None,
        mask: torch.Tensor | None = None, *, num_heads: int,
        tp: ModelShard | None = None, cache: Params | None = None,
        cache_index: int | torch.Tensor | None = None) -> torch.Tensor:
    """HF BartAttention: q scaled by head_dim**-0.5; key_value=None is
    self-attention. `num_heads` is the layer's whole head count, which fixes
    head_dim = d // num_heads; the heads run here are as many as the q
    projection's columns hold (all of them in one process, a model rank's
    share of them under `tp`: q/k/v column-parallel, out_proj row-parallel).

    `cache` (the general decoder's, models/bart.init_cache): {"k", "v"} of
    [B, H, L_max, hd]. Self-attention writes its new k/v rows at
    `cache_index` into the cache, in place, and attends over all L_max rows
    (the caller's mask hides those past the step); cross-attention reads the
    cache's K/V, projected once, and ignores key_value's values. The JAX
    function returns the updated cache beside the output; here the output
    alone. A step that would end past L_max (cache_index + t > L_max) raises
    ValueError before anything is written, where JAX clamps the write's
    start. A cache takes whole weights: with `tp` it raises."""
    if cache is not None and tp is not None:
        raise ValueError("mha: cache= runs on whole weights; tp= is not supported with it")
    d = hidden.shape[-1]
    head_dim = d // num_heads
    width = p["q_proj"]["kernel"].shape[1]
    if width % head_dim:
        raise ValueError(f"mha: {width} projection columns are not whole heads of {head_dim}")
    heads = width // head_dim
    scaling = head_dim ** -0.5
    hidden = copy_to_model_parallel(hidden, tp)
    q = _split_heads(column_linear(p["q_proj"], hidden, tp) * scaling, heads)
    if cache is not None and key_value is not None:  # cross K/V projected once a sequence
        k, v = cache["k"], cache["v"]
    else:
        src = hidden if key_value is None else copy_to_model_parallel(key_value, tp)
        k = _split_heads(column_linear(p["k_proj"], src, tp), heads)
        v = _split_heads(column_linear(p["v_proj"], src, tp), heads)
        if cache is not None:  # a decode step of the cached self-attention
            idx, t, l_max = int(cache_index), k.shape[2], cache["k"].shape[2]
            if idx < 0 or idx + t > l_max:  # JAX's dynamic_update_slice clamps instead
                raise ValueError(f"mha: a cached step of t={t} tokens at cache_index={idx} "
                                 f"does not fit the cache's L_max={l_max}")
            cache["k"][:, :, idx:idx + t] = k
            cache["v"][:, :, idx:idx + v.shape[2]] = v
            k, v = cache["k"], cache["v"]
    out = attention_core(q, k, v, mask)
    return row_linear(p["out_proj"], _merge_heads(out), tp)


def normal_(shape, generator: torch.Generator, std: float = 0.02,
            device=None) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device) * std


def linear_init(g: torch.Generator, d_in: int, d_out: int, device=None,
                std: float = 0.02, bias: bool = True) -> Params:
    p = {"kernel": normal_((d_in, d_out), g, std, device)}
    if bias:
        p["bias"] = torch.zeros(d_out, device=device)
    return p


def layernorm_init(dim: int, device=None) -> Params:
    return {"scale": torch.ones(dim, device=device), "bias": torch.zeros(dim, device=device)}


def embedding_init(g: torch.Generator, vocab: int, dim: int, device=None,
                   std: float = 0.02) -> Params:
    return {"weight": normal_((vocab, dim), g, std, device)}


def mha_init(g: torch.Generator, d_model: int, device=None) -> Params:
    return {n: linear_init(g, d_model, d_model, device)
            for n in ("q_proj", "k_proj", "v_proj", "out_proj")}

