"""Flash attention with an additive bias (port of
vacnic_tpu/kernels/flash_attn.py).

`flash_attention(q, k, v, bias)`: non-causal attention with q already
scaled, an additive bias [B | 1, H | 1, T, S], an online softmax with f32
statistics, bf16 products with f32 accumulation, the probabilities rounded
to the input dtype before P·V, and the normalisation after P·V
(acc / max(l, 1e-30)). On a CUDA tensor it launches
kernels/csrc/flash_attn.cu; on a CPU tensor it takes `flash_attention_plain`.

The kernel reads q, k, v and the bias through their (item, head, row)
strides: the head-split views that models/layers.attention_core hands over
are read in place, with no copy, and a [B, 1, T, S] bias is read with a head
stride of 0 rather than expanded over heads (the JAX wrapper broadcasts it).
The output is written into [B, T, H, D] memory and returned as its
[B, H, T, D] view, which the head merge then reshapes without a copy.

`flash_eligible` is the shape rule of vacnic_tpu/models/layers.py:184-196.
"""

from __future__ import annotations

import ctypes

import torch

from vacnic_tpu_torch.kernels import primitives as K

NEG_INF = float(torch.finfo(torch.float32).min)  # the running max's start


def flash_eligible(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor | None) -> bool:
    """Long, aligned attention with a mask: the encoder's 512-token self-attention."""
    if mask is None:
        return False
    t, s, hd = q.shape[2], k.shape[2], q.shape[3]
    return t % 128 == 0 and s % 128 == 0 and hd % 64 == 0 and t >= 256


def flash_attention_plain(q, k, v, bias):
    """The twin of `flash_attention` in f32 with the kernel's recipe; any device."""
    dt = q.dtype
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) + bias.float()
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhts,bhsd->bhtd", p.to(dt).float(), v.float())
    return (acc / torch.clamp(l, min=1e-30)).to(dt)


def _strides(t: torch.Tensor, name: str) -> list[int]:
    """(item, head, row) element strides of a 4-D tensor with a unit last
    stride; a size-1 dimension reads with stride 0. The kernel copies rows in
    16-byte pieces, so every row must start on a 16-byte boundary."""
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention {name}: the last dimension must be contiguous")
    st = [0 if t.shape[i] == 1 else t.stride(i) for i in range(3)]
    if any(z % (16 // t.element_size()) for z in st) or t.data_ptr() % 16:
        raise ValueError(f"flash_attention {name}: rows must be 16-byte aligned")
    return st


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """q [B, H, T, D] (pre-scaled), k/v [B, H, S, D], additive bias
    [B | 1, H | 1, T, S] -> [B, H, T, D] in q's dtype. The kernel takes bf16
    q/k/v, an f32 or bf16 bias, D == 64, T % 64 == 0, S % 64 == 0, and
    rows of q, k, v and the bias 16-byte aligned."""
    K.no_grad_guard("flash_attention", q, k, v, bias)
    if K._on_cpu(q):
        return flash_attention_plain(q, k, v, bias)
    b, h, t, d = q.shape
    s = k.shape[2]
    for name, x, shape in (("q", q, (b, h, t, d)), ("k", k, (b, h, s, d)),
                           ("v", v, (b, h, s, d))):
        if not x.is_cuda or x.device != q.device or x.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention {name}: expected bf16 on {q.device}, got "
                             f"{x.dtype} on {x.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"flash_attention {name}: shape {tuple(x.shape)}, expected {shape}")
    if bias.device != q.device or bias.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention bias: {bias.dtype} on {bias.device}")
    if bias.dim() != 4 or bias.shape[0] not in (1, b) or bias.shape[1] not in (1, h) \
            or tuple(bias.shape[2:]) != (t, s):
        raise ValueError(f"flash_attention bias: shape {tuple(bias.shape)}, expected "
                         f"[{b} | 1, {h} | 1, {t}, {s}]")
    if d != 64 or t % 64 or s % 64:
        raise ValueError(f"flash_attention: needs D == 64, T % 64 == 0 and S % 64 == 0 "
                         f"(D={d}, T={t}, S={s})")
    out = torch.empty(b, t, h, d, dtype=torch.bfloat16, device=q.device).permute(0, 2, 1, 3)
    strides = []
    for name, x in (("q", q), ("k", k), ("v", v), ("bias", bias), ("out", out)):
        strides += _strides(x, name)
    arr = (ctypes.c_longlong * 15)(*strides)
    K._launch("flash_attention", "vt_flash_attention", K._p(q), K._p(k), K._p(v), K._p(bias),
              K._p(out), b, h, t, s, d, int(bias.dtype == torch.bfloat16),
              ctypes.cast(arr, ctypes.c_void_p))
    return out
