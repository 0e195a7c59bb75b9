"""The text path of all fusion-encoder layers (port of
vacnic_tpu/kernels/encoder_stack.py:encoder_text_stack).

Per layer: self-attention with fused QKV and the [B, S] pad bias, then
self_attn_layer_norm; cross-attention to the layer's precomputed img+ner
K/V (keys pre-transposed [d, KV], no bias), then img_ner_attn_layer_norm;
FFN (exact gelu), then final_layer_norm. `encoder_text_stack` runs each
layer through the CUDA kernels of kernels/primitives on the card;
`encoder_text_stack_plain` runs the same layer loop through their plain
twins and is what CPU tensors take. The residual stream stays in f32
between sublayers; a bf16 copy feeds the matrix products.

The TPU kernel's chunking plan (EncPlan) exists for its VMEM and is not
carried over.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import torch

from vacnic_tpu_torch.core.config import BartConfig
from vacnic_tpu_torch.kernels import primitives as K


class EncStackParams(NamedTuple):
    """Stacked per-layer text-path weights [L, ...]; matrices in the matmul
    dtype (bf16 on the card), biases and layer norms f32."""

    w_qkv: torch.Tensor   # [L, d, 3d] self-attn q|k|v
    b_qkv: torch.Tensor   # [L, 3d]
    w_so: torch.Tensor    # [L, d, d]
    b_so: torch.Tensor    # [L, d]
    ln_s: torch.Tensor    # [L, 2, d] (scale, bias)
    w_cq: torch.Tensor    # [L, d, d]
    b_cq: torch.Tensor    # [L, d]
    w_co: torch.Tensor    # [L, d, d]
    b_co: torch.Tensor    # [L, d]
    ln_c: torch.Tensor    # [L, 2, d]
    w_fc1: torch.Tensor   # [L, d, F]
    b_fc1: torch.Tensor   # [L, F]
    w_fc2: torch.Tensor   # [L, F, d]
    b_fc2: torch.Tensor   # [L, d]
    ln_f: torch.Tensor    # [L, 2, d]


KERNEL_OPS = SimpleNamespace(gemm=K.gemm, layernorm=K.layernorm,
                             self_attn=K.enc_self_attention, cross_attn=K.enc_cross_attention)
PLAIN_OPS = SimpleNamespace(gemm=K.gemm_plain, layernorm=K.layernorm_plain,
                            self_attn=K.enc_self_attention_plain,
                            cross_attn=K.enc_cross_attention_plain)


def _layers(sp: EncStackParams, x0, cross_k, cross_v, self_bias, cfg: BartConfig, ops):
    n_layers = sp.w_qkv.shape[0]
    bsz, seq, d = x0.shape
    heads = cfg.encoder_attention_heads
    mm = sp.w_qkv.dtype
    # the callers build the pad bias from finfo(f32).min; it stays f32 here,
    # clamped to a finite value the kernels' f32 arithmetic cannot overflow
    bias = torch.clamp(self_bias.float(), min=float(torch.finfo(torch.bfloat16).min)).contiguous()
    x = x0.reshape(bsz * seq, d).float().contiguous()
    xb = x.to(mm)
    for l in range(n_layers):
        qkv = ops.gemm(xb, sp.w_qkv[l], sp.b_qkv[l], out_dtype=mm)
        o = ops.self_attn(qkv, bias, bsz, seq, heads)
        h = ops.gemm(o, sp.w_so[l], sp.b_so[l], residual=x)
        x1, x1b = ops.layernorm(h, sp.ln_s[l], mm)
        q2 = ops.gemm(x1b, sp.w_cq[l], sp.b_cq[l], out_dtype=mm)
        o2 = ops.cross_attn(q2, cross_k[l], cross_v[l], bsz, seq, heads)
        h = ops.gemm(o2, sp.w_co[l], sp.b_co[l], residual=x1)
        x2, x2b = ops.layernorm(h, sp.ln_c[l], mm)
        hm = ops.gemm(x2b, sp.w_fc1[l], sp.b_fc1[l], act=K.GELU, out_dtype=mm)
        h = ops.gemm(hm, sp.w_fc2[l], sp.b_fc2[l], residual=x2)
        x, xb = ops.layernorm(h, sp.ln_f[l], mm)
    return x.to(x0.dtype).reshape(bsz, seq, d)


def encoder_text_stack_plain(sp: EncStackParams, x0, cross_k, cross_v, self_bias,
                             cross_bias, cfg: BartConfig) -> torch.Tensor:
    """The plain-PyTorch twin of encoder_text_stack, on any device."""
    del cross_bias  # structurally zero in the supported configs; not consumed
    mm = sp.w_qkv.dtype
    return _layers(sp, x0, cross_k.to(mm), cross_v.to(mm), self_bias, cfg, PLAIN_OPS)


def encoder_text_stack(
    sp: EncStackParams,
    x0: torch.Tensor,          # [B, S, d] embedded + embed-LN'd tokens
    cross_k: torch.Tensor,     # [L, B, d, KV] per-layer projected cross keys (pre-transposed)
    cross_v: torch.Tensor,     # [L, B, KV, d]
    self_bias: torch.Tensor,   # [B, S] f32 additive pad bias
    cross_bias: torch.Tensor,  # [B, KV]: must be zero (all-ones img+ner mask); not consumed
    cfg: BartConfig,
) -> torch.Tensor:
    """-> last_hidden [B, S, d] in x0.dtype. CUDA kernels for CUDA tensors,
    the plain twin for CPU tensors."""
    K.no_grad_guard("encoder_text_stack", *(sp or ()), x0, cross_k, cross_v, self_bias, cross_bias)
    if x0.device.type == "cpu":
        return encoder_text_stack_plain(sp, x0, cross_k, cross_v, self_bias, cross_bias, cfg)
    if x0.device.type != "cuda":
        raise RuntimeError(f"encoder_text_stack: unsupported device {x0.device}")
    if sp.w_qkv.dtype != torch.bfloat16:
        raise ValueError("encoder_text_stack: the kernels take bf16 stacked weights")
    ck = cross_k.to(torch.bfloat16).contiguous()
    cv = cross_v.to(torch.bfloat16).contiguous()
    return _layers(sp, x0, ck, cv, self_bias, cfg, KERNEL_OPS)
