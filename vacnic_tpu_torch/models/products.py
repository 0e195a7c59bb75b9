"""The model path's one library product: a @ b of bf16-rounded values,
summed and returned in float32 (the JAX package's `jnp.dot(...,
preferred_element_type=float32)`, vacnic_tpu/models/layers.py:63-67).

`product(a, b, cotangent=...)` takes the operands in their own dtype, with
no float32 copies, and returns float32. b is [K, N] (a is [..., M, K]) or
has a's batch dimensions ([..., M, K] @ [..., K, N]).

- On the card, with two bf16 operands: a bf16 tensor-core product with
  float32 sums and output (`torch.mm` / `torch.bmm` with
  `out_dtype=torch.float32`, aten::mm.dtype / aten::bmm.dtype), as a
  `torch.autograd.Function` with its own backward (`_Bf16Product`).
- Otherwise the float32 recipe, `torch.matmul(a.float(), b.float())`, and
  autograd's own backward: on the CPU, which has no aten::mm.dtype kernel,
  and for float32 operands (the float32 presets, float32 features).

Both operands of the bf16 product hold bf16 values, so each elementwise
product is exact in float32; only the order of the float32 sums differs
from the float32 recipe.

`cotangent` says what the caller does with the float32 output, and so what
the backward may round:
- "bf16": the output is rounded to bf16 before anything else reads it
  (`linear`, P·V, the CLIP projections). The cotangent that comes back
  through that cast is a bf16 value; it is rounded to bf16, which loses
  nothing, and dA and dB run as bf16 products with float32 sums.
- "f32": the output feeds a float32 nonlinearity (the attention scores
  into the softmax, the logits into the loss). The cotangent is a true
  float32 value, and the backward products stay float32 products with the
  bf16 operand upcast, as autograd computes them for the float32 recipe.
Each gradient is returned in its operand's dtype, as the recipe's
`.float()` casts return it.

Under a profiler each product runs inside a `product.bf16` or
`product.f32` span (core/profiling.annotate), forward and backward alike;
the backward of the float32 recipe is autograd's own and is not spanned.
"""

from __future__ import annotations

import torch

from vacnic_tpu_torch.core.profiling import annotate

COTANGENTS = ("bf16", "f32")


def _check(a: torch.Tensor, b: torch.Tensor, cotangent: str) -> None:
    if cotangent not in COTANGENTS:
        raise ValueError(f"product: cotangent={cotangent!r}, expected one of {COTANGENTS}")
    if b.dim() != 2 and (a.dim() != b.dim() or a.shape[:-2] != b.shape[:-2]):
        raise ValueError(f"product: a {tuple(a.shape)} @ b {tuple(b.shape)}: b is [K, N] or "
                         "has a's batch dimensions")


def mm_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x @ y of two bf16 matrices (or batches of them) on the card, float32
    sums and output."""
    if x.dim() == 2:
        return torch.mm(x, y, out_dtype=torch.float32)
    return torch.bmm(x, y, out_dtype=torch.float32)


def _operands(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a and b as the operands of one mm (b [K, N]: a's leading dimensions
    folded into its rows) or of one bmm (the batch dimensions folded)."""
    if b.dim() == 2:
        return a.reshape(-1, a.shape[-1]), b
    return a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:])


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


class _Bf16Product(torch.autograd.Function):
    """a @ b of two bf16 operands through `mm`, a product of two bf16
    matrices with float32 sums and output (on the card `mm_f32`; a test
    passes an emulation). The backward as the module docstring says."""

    @staticmethod
    def forward(ctx, a, b, cotangent, mm):
        ctx.save_for_backward(a, b)
        ctx.cotangent, ctx.mm = cotangent, mm
        with annotate("product.bf16"):
            y = mm(*_operands(a, b))
        return y.reshape(*a.shape[:-1], b.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        a2, b2 = _operands(a, b)
        g2 = g.reshape(*a2.shape[:-1], b.shape[-1])
        if ctx.cotangent == "bf16":
            g2 = g2.to(torch.bfloat16)  # a bf16 value already: nothing is lost
            span, mm = "product.bf16", ctx.mm
        else:
            a2, b2 = a2.float(), b2.float()
            span, mm = "product.f32", torch.matmul
        da = db = None
        if ctx.needs_input_grad[0]:
            with annotate(span):
                da = mm(g2, _t(b2))
            da = da.to(a.dtype).reshape(a.shape)
        if ctx.needs_input_grad[1]:
            with annotate(span):
                db = mm(_t(a2), g2)
            db = db.to(b.dtype).reshape(b.shape)
        return da, db, None, None


def _bf16_mm(a: torch.Tensor, b: torch.Tensor):
    """The bf16 product for these operands, or None for the float32 recipe:
    `mm_f32` on the card where a and b are both bf16."""
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        return mm_f32
    return None


def product(a: torch.Tensor, b: torch.Tensor, *, cotangent: str) -> torch.Tensor:
    """a @ b in float32 by the module docstring's recipe: the bf16 product
    on the card where a and b are both bf16, else the float32 one."""
    _check(a, b, cotangent)
    mm = _bf16_mm(a, b)
    if mm is not None:
        return _Bf16Product.apply(a, b, cotangent, mm)
    with annotate("product.f32"):
        return torch.matmul(a.float(), b.float())
