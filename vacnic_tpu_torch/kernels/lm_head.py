"""The decoder's LM head inside the stack (port of the `_lm_head` grid
iteration of vacnic_tpu/kernels/decode_layer.py:decode_stack, :643-650,
which runs when ChunkPlan.n_lm > 0).

`lm_head` computes logits [BK, Vp] f32 = x @ w_lmᵀ + b_lm over the
vocab-padded head of infer/decode_fast.build_lm_head (pad rows zero, pad
bias -1e9), with products in the dtype of x and w_lm and sums in f32. On a
CUDA tensor it launches kernels/csrc/lm_head.cu; on a CPU tensor it takes
`lm_head_plain`, its twin.
"""

from __future__ import annotations

import torch

from vacnic_tpu_torch.kernels import primitives as K


def lm_head_plain(x: torch.Tensor, w_lm: torch.Tensor, b_lm: torch.Tensor) -> torch.Tensor:
    """The f32 twin of `lm_head`, on any device."""
    return torch.matmul(x.float(), w_lm.float().t()) + b_lm


def lm_head(x: torch.Tensor, w_lm: torch.Tensor, b_lm: torch.Tensor) -> torch.Tensor:
    """x [BK, d], w_lm [Vp, d], b_lm [Vp] f32 -> logits [BK, Vp] f32. The
    kernel takes bf16 x and w_lm, any BK >= 1, d % 32 == 0, Vp % 128 == 0
    and tensors that start on 16 bytes."""
    K.no_grad_guard("lm_head", x, w_lm, b_lm)
    if K._on_cpu(x):
        return lm_head_plain(x, w_lm, b_lm)
    bk, d = x.shape
    vp = w_lm.shape[0]
    K._req(x, "lm_head x", torch.bfloat16)
    K._req(w_lm, "lm_head w_lm", torch.bfloat16, (vp, d), x.device)
    K._req(b_lm, "lm_head b_lm", torch.float32, (vp,), x.device)
    if bk < 1 or d < 32 or d % 32 or vp < 128 or vp % 128:
        raise ValueError(f"lm_head: needs BK >= 1, d % 32 == 0 and Vp % 128 == 0 "
                         f"(BK={bk}, d={d}, Vp={vp})")
    if any(t.data_ptr() % 16 for t in (x, w_lm, b_lm)):
        raise ValueError("lm_head: x, w_lm and b_lm must start on 16 bytes")
    logits = torch.empty(bk, vp, dtype=torch.float32, device=x.device)
    K._launch("lm_head", "vt_lm_head", K._p(x), K._p(w_lm), K._p(b_lm), K._p(logits), bk, vp, d)
    return logits
