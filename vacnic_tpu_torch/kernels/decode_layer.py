"""One decoder step through all post-LN BART layers (port of
vacnic_tpu/kernels/decode_layer.py:decode_stack: bf16, int8 or fp8 self
cache; bf16 or int8 cross K/V; the LM head outside by default, or inside
the stack).

Per layer, for the [BK, d] rows of the step: fused QKV; self-attention over
the time-major write-once cache [T, BK, d] through the ancestry matrix
anc [T, BK] (rows t < pos read from row anc[t, c], the step's own K/V from
the QKV output; int8 rows with their [T, BK, H] scales, fp8 rows converted
exactly); out-projection + residual, self_attn_layer_norm;
cross-attention to the beam-invariant K/V [B, H, hd, S] with the [B, S] pad
bias (int8: scales fold into q and the head output); out-projection +
residual, encoder_attn_layer_norm; FFN (exact gelu) + residual,
final_layer_norm. The step's new K/V rows come back as k_new/v_new
[L, BK, d] for the caller to write at row `pos`.

Given the vocab-padded head w_lm/b_lm (infer/decode_fast.build_lm_head),
the stack also runs the LM head (the TPU kernel's extra grid iteration when
ChunkPlan.n_lm > 0, :643-650) on the last layer norm's output in the
weights' dtype: the TPU kernel multiplies its f32 carried residual cast to
the matmul dtype, which is that copy, and not x_out (bf16 even at f32).

`decode_stack` runs the layers through the CUDA kernels of
kernels/primitives and kernels/lm_head on the card; `decode_stack_plain`
runs the same loop through their plain twins and is what CPU tensors take.
The TPU kernel's ChunkPlan and its one-hot ancestry gathers are TPU
constructs and are not carried over.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from vacnic_tpu_torch.kernels import primitives as K
from vacnic_tpu_torch.kernels.lm_head import lm_head, lm_head_plain

KERNEL_OPS = SimpleNamespace(gemm=K.gemm, layernorm=K.layernorm,
                             self_attn=K.dec_self_attention, cross_attn=K.dec_cross_attention,
                             lm_head=lm_head)
PLAIN_OPS = SimpleNamespace(gemm=K.gemm_plain, layernorm=K.layernorm_plain,
                            self_attn=K.dec_self_attention_plain,
                            cross_attn=K.dec_cross_attention_plain, lm_head=lm_head_plain)


def _layer(scale, l):
    return None if scale is None else scale[l]


def _layers(dp, x0, pos: int, self_k, self_v, anc, cross_k, cross_v, enc_bias, heads: int,
            cross_k_scale, cross_v_scale, self_k_scale, self_v_scale, w_lm, b_lm, ops):
    n_layers = dp.w_qkv.shape[0]
    bk, d = x0.shape
    mm = dp.w_qkv.dtype
    x = x0.float()
    xb = x.to(mm)
    k_new = torch.empty(n_layers, bk, d, dtype=mm, device=x0.device)
    v_new = torch.empty_like(k_new)
    for l in range(n_layers):
        qkv = ops.gemm(xb, dp.w_qkv[l], dp.b_qkv[l], out_dtype=mm)
        k_new[l] = qkv[:, d:2 * d]
        v_new[l] = qkv[:, 2 * d:]
        o = ops.self_attn(qkv, self_k[l], self_v[l], anc, pos, heads, _layer(self_k_scale, l),
                          _layer(self_v_scale, l))
        h = ops.gemm(o, dp.w_self_out[l], dp.b_self_out[l], residual=x)
        x1, x1b = ops.layernorm(h, dp.ln_self[l], mm)
        q = ops.gemm(x1b, dp.w_cross_q[l], dp.b_cross_q[l], out_dtype=mm)
        o = ops.cross_attn(q, cross_k[l], cross_v[l], _layer(cross_k_scale, l),
                           _layer(cross_v_scale, l), enc_bias, heads)
        h = ops.gemm(o, dp.w_cross_out[l], dp.b_cross_out[l], residual=x1)
        x2, x2b = ops.layernorm(h, dp.ln_cross[l], mm)
        hm = ops.gemm(x2b, dp.w_fc1[l], dp.b_fc1[l], act=K.GELU, out_dtype=mm)
        h = ops.gemm(hm, dp.w_fc2[l], dp.b_fc2[l], residual=x2)
        x, xb = ops.layernorm(h, dp.ln_final[l], mm)
    if w_lm is None:
        return x.to(x0.dtype), k_new, v_new
    return ops.lm_head(xb, w_lm, b_lm), x.to(x0.dtype), k_new, v_new


def decode_stack_plain(dp, x0, pos: int, self_k, self_v, anc, cross_k, cross_v, enc_bias,
                       heads: int, cross_k_scale=None, cross_v_scale=None, self_k_scale=None,
                       self_v_scale=None, w_lm=None, b_lm=None):
    """The plain-PyTorch twin of decode_stack, on any device."""
    return _layers(dp, x0, int(pos), self_k, self_v, anc, cross_k, cross_v, enc_bias, heads,
                   cross_k_scale, cross_v_scale, self_k_scale, self_v_scale, w_lm, b_lm,
                   PLAIN_OPS)


def decode_stack(
    dp,                       # infer.decode_fast.DecodeParams (stacked [L, ...])
    x0: torch.Tensor,         # [BK, d] embedded + LN'd token
    pos: int,                 # step position (0-based)
    self_k: torch.Tensor,     # [L, T, BK, d] time-major, never reordered; bf16, int8 or fp8
    self_v: torch.Tensor,
    anc: torch.Tensor,        # [T, BK] int32 ancestry
    cross_k: torch.Tensor,    # [L, B, H, hd, S] bf16, or int8 with the scales below
    cross_v: torch.Tensor,
    enc_bias: torch.Tensor,   # [B, S] f32 additive pad bias
    heads: int,
    cross_k_scale: torch.Tensor | None = None,  # [L, B, H, hd] f32 (int8 cross K/V)
    cross_v_scale: torch.Tensor | None = None,
    self_k_scale: torch.Tensor | None = None,   # [L, T, BK, H] f32 (int8 self cache)
    self_v_scale: torch.Tensor | None = None,
    w_lm: torch.Tensor | None = None,           # [Vp, d] in the weights' dtype (LM head)
    b_lm: torch.Tensor | None = None,           # [Vp] f32
):
    """-> (x_out [BK, d] in x0.dtype, k_new [L, BK, d], v_new [L, BK, d]),
    or with w_lm/b_lm (logits_p [BK, Vp] f32, x_out, k_new, v_new) as the
    JAX decode_stack returns them. k_new/v_new are the step's rows at full
    precision (the weights' dtype); the caller quantizes them for an int8 or
    fp8 cache. CUDA kernels for CUDA tensors, the plain twin for CPU
    tensors."""
    if (self_k.dtype == torch.int8) != (self_k_scale is not None) or (
            self_k_scale is None) != (self_v_scale is None):
        raise ValueError("decode_stack: an int8 self cache and its scales travel together")
    if (w_lm is None) != (b_lm is None):
        raise ValueError("decode_stack: the LM head's w_lm and b_lm travel together")
    if x0.device.type == "cpu":
        return decode_stack_plain(dp, x0, pos, self_k, self_v, anc, cross_k, cross_v,
                                  enc_bias, heads, cross_k_scale, cross_v_scale, self_k_scale,
                                  self_v_scale, w_lm, b_lm)
    if x0.device.type != "cuda":
        raise RuntimeError(f"decode_stack: unsupported device {x0.device}")
    if dp.w_qkv.dtype != torch.bfloat16 or self_k.dtype not in K.DEC_SELF_KINDS:
        raise ValueError("decode_stack: the kernels take bf16 weights and a bf16, int8 or "
                         f"float8_e4m3fn self cache (got {dp.w_qkv.dtype}, {self_k.dtype})")
    return _layers(dp, x0, int(pos), self_k, self_v, anc, cross_k, cross_v,
                   enc_bias.float().contiguous(), heads, cross_k_scale, cross_v_scale,
                   self_k_scale, self_v_scale, w_lm, b_lm, KERNEL_OPS)
