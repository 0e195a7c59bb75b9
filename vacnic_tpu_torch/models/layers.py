"""Functional NN primitives (port of vacnic_tpu/models/layers.py).

Plain functions over dict parameter trees. Linear kernels keep the JAX
package's [in, out] layout (models/weights_io.py loads them untransposed),
so `linear` is `x @ kernel`. Products accumulate in float32 and round once
to the input dtype, the recipe of the JAX `preferred_element_type=float32`
dots.

Training: `dropout` takes a 63-bit seed where JAX takes a key, and
`RngStream` / `fold_in` derive one seed per call site from (base seed,
layer, site), as JAX's `fold_in` does. Each site draws its mask from a
generator made for it from that seed alone, so a layer recomputed under
`torch.utils.checkpoint` draws the masks of the forward that ran.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from vacnic_tpu_torch.kernels.flash_attn import flash_attention, flash_eligible
from vacnic_tpu_torch.kernels.primitives import differentiated

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


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from `seed` and the integer `data` (the port's
    jax.random.fold_in)."""
    return _mix64(_mix64(seed & _M64) ^ (data & _M64)) >> 1


def split(seed: int) -> tuple[int, int]:
    """Two independent seeds from one (jax.random.split into two)."""
    return fold_in(seed, 0), fold_in(seed, 1)


def dropout(x: torch.Tensor, rate: float, seed: int | None) -> torch.Tensor:
    """Inverted dropout; seed None or rate 0 is the identity (the eval path).

    JAX's default keep rule (vacnic_tpu/models/layers.py:84-108): uniform
    16-bit integers compared against round(keep * 65536), so the keep
    probability is that threshold over 65536 (0.899994 at rate 0.1). The
    bits come from a generator on x's device seeded with `seed` alone."""
    if seed is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    thresh = min(int(round(keep * 65536.0)), 65535)
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    bits = torch.randint(0, 65536, x.shape, generator=g, device=x.device, dtype=torch.int32)
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
    y = torch.matmul(x.float(), p["kernel"].to(x.dtype).float())
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
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float())
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bhsd->bhtd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


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
        mask: torch.Tensor | None = None, *, num_heads: int) -> torch.Tensor:
    """HF BartAttention without a cache: q scaled by head_dim**-0.5;
    key_value=None is self-attention."""
    d = hidden.shape[-1]
    scaling = (d // num_heads) ** -0.5
    q = _split_heads(linear(p["q_proj"], hidden) * scaling, num_heads)
    src = hidden if key_value is None else key_value
    k = _split_heads(linear(p["k_proj"], src), num_heads)
    v = _split_heads(linear(p["v_proj"], src), num_heads)
    out = attention_core(q, k, v, mask)
    return linear(p["out_proj"], _merge_heads(out))


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

