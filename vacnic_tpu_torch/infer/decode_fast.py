"""Decode-time state and step functions (port of
vacnic_tpu/infer/decode_fast.py).

* Cross K/V are computed once per batch item, [L, B, H, hd, S], and never
  expanded over beams; beams enter through q.
* The kernel path keeps the self cache time-major [L, T, BK, D] and
  write-once: a step writes its K/V at row `pos` of its own beam row, and a
  beam select only recomposes the ancestry matrix anc [T, BK]
  (`reorder_anc`); the cache is never gathered.
* That self cache holds the stack's dtype, or (opt-in) int8 with per-(layer,
  t, row, head) f32 scales [L, T, BK, H] (`quantize_self_rows` at the row
  write; a row's scale travels with the physical row, so `reorder_anc` is
  unchanged), or fp8 e4m3 clamped to +-448 at the store (`to_fp8`). The
  step never reads its own row from the cache: row `pos` enters the
  attention at full precision from the QKV output.
* `decode_step` is the plain reference step over the batch-major cache
  [L, BK, T, D] with a physical reorder; `decode_step_kernel` embeds, runs
  kernels/decode_layer.decode_stack, writes row `pos`, and applies the LM
  head x @ shared.to(dtype)ᵀ + final_logits_bias with f32 accumulation (a
  library product: it lies outside the TPU kernel too).
* `decode_step_kernel_stats` replaces that LM head with
  kernels/lm_stats.lm_stats over the vocab-padded head of `build_lm_head`
  (built lazily by `ensure_lm_head`) and returns the beam shortlist's
  per-row top-C and logsumexp with the padded logits.

Unlike the JAX package, the caches are updated in place: a step writes its
rows into the tensors it was given and returns the same cache.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vacnic_tpu_torch.core.config import BartConfig
from vacnic_tpu_torch.models.bart import POS_OFFSET
from vacnic_tpu_torch.models.layers import ACT2FN, Params, layernorm


class DecodeParams(NamedTuple):
    """Stacked per-layer decoder weights [L, ...]; matrices in the matmul
    dtype, biases and layer norms f32. w_lm/b_lm: the vocab-padded LM head
    of the stats step, None until `ensure_lm_head` builds it."""

    w_qkv: torch.Tensor        # [L, d, 3d]
    b_qkv: torch.Tensor        # [L, 3d]
    w_self_out: torch.Tensor   # [L, d, d]
    b_self_out: torch.Tensor   # [L, d]
    ln_self: torch.Tensor      # [L, 2, d]
    w_cross_q: torch.Tensor    # [L, d, d]
    b_cross_q: torch.Tensor    # [L, d]
    w_cross_out: torch.Tensor  # [L, d, d]
    b_cross_out: torch.Tensor  # [L, d]
    ln_cross: torch.Tensor     # [L, 2, d]
    w_fc1: torch.Tensor        # [L, d, F]
    b_fc1: torch.Tensor        # [L, F]
    w_fc2: torch.Tensor        # [L, F, d]
    b_fc2: torch.Tensor        # [L, d]
    ln_final: torch.Tensor     # [L, 2, d]
    w_lm: torch.Tensor | None = None  # [Vp, d] in dtype, pad rows zero
    b_lm: torch.Tensor | None = None  # [Vp] f32, pad columns -1e9


class DecodeCache(NamedTuple):
    self_k: torch.Tensor  # kernel path [L, T, BK, D]; reference path [L, BK, T, D]
    self_v: torch.Tensor
    cross_k: torch.Tensor  # [L, B, H, hd, S], beam-invariant
    cross_v: torch.Tensor
    anc: torch.Tensor | None = None  # [T, BK] int32 (kernel path)
    pos: int | None = None           # last written time row (kernel path)
    cross_k_scale: torch.Tensor | None = None  # [L, B, H, hd] f32 (int8 cross K/V)
    cross_v_scale: torch.Tensor | None = None
    self_k_scale: torch.Tensor | None = None   # [L, T, BK, H] f32 (int8 self cache)
    self_v_scale: torch.Tensor | None = None


def _stack(layers, *path) -> torch.Tensor:
    def leaf(p):
        for k in path:
            p = p[k]
        return p

    return torch.stack([leaf(p) for p in layers])


def build_decode_params(params: Params, dtype=torch.bfloat16) -> DecodeParams:
    layers = params["decoder"]["layers"]

    def w(*path):
        return _stack(layers, *path).to(dtype).contiguous()

    def b(*path):
        return _stack(layers, *path).float().contiguous()

    def ln(name):
        return torch.stack([torch.stack([p[name]["scale"], p[name]["bias"]])
                            for p in layers]).float().contiguous()

    return DecodeParams(
        w_qkv=torch.cat([w("self_attn", n, "kernel") for n in ("q_proj", "k_proj", "v_proj")],
                        dim=-1).contiguous(),
        b_qkv=torch.cat([b("self_attn", n, "bias") for n in ("q_proj", "k_proj", "v_proj")],
                        dim=-1).contiguous(),
        w_self_out=w("self_attn", "out_proj", "kernel"),
        b_self_out=b("self_attn", "out_proj", "bias"),
        ln_self=ln("self_attn_layer_norm"),
        w_cross_q=w("encoder_attn", "q_proj", "kernel"),
        b_cross_q=b("encoder_attn", "q_proj", "bias"),
        w_cross_out=w("encoder_attn", "out_proj", "kernel"),
        b_cross_out=b("encoder_attn", "out_proj", "bias"),
        ln_cross=ln("encoder_attn_layer_norm"),
        w_fc1=w("fc1", "kernel"),
        b_fc1=b("fc1", "bias"),
        w_fc2=w("fc2", "kernel"),
        b_fc2=b("fc2", "bias"),
        ln_final=ln("final_layer_norm"),
    )


LM_PAD = 4096  # the padded head's vocab rounds up to a multiple of this


def build_lm_head(params: Params, dtype=torch.bfloat16) -> tuple[torch.Tensor, torch.Tensor]:
    """The tied LM head padded to Vp = ceil(V / 4096) * 4096 rows:
    (w [Vp, d] in dtype with zero pad rows, b [Vp] f32 with -1e9 on the pad
    columns), so that no pad column can outrank a real one."""
    w_shared = params["shared"]["weight"]
    v, d = w_shared.shape
    vp = -(-v // LM_PAD) * LM_PAD
    w = torch.zeros(vp, d, dtype=dtype, device=w_shared.device)
    w[:v] = w_shared.to(dtype)
    b = torch.full((vp,), -1e9, dtype=torch.float32, device=w_shared.device)
    b[:v] = params["final_logits_bias"].float()
    return w, b


def ensure_lm_head(dp: DecodeParams, params: Params, dtype=torch.bfloat16) -> DecodeParams:
    """dp with the padded LM head built (once: only the stats path needs it)."""
    if dp.w_lm is None:
        w, b = build_lm_head(params, dtype)
        dp = dp._replace(w_lm=w, b_lm=b)
    return dp


def quantize_cross_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[L, B, H, hd, S] -> (int8 values, f32 scales [L, B, H, hd]).

    Symmetric per-(layer, item, head, channel) quantization over S. The
    channel scales cost nothing in the kernel: K's folds into q before the
    score sum over hd, V's into the head output after the sum over S.
    torch.round rounds half to even, as jnp.round does."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_self_rows(rows: torch.Tensor, n_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[L, BK, d] new self K (or V) rows -> (int8 [L, BK, d], f32 [L, BK, H]).

    Symmetric per-(layer, row, head) quantization over the head's channels,
    max / 127 floored at 1e-12, round half to even (JAX quantize_self_rows,
    vacnic_tpu/infer/decode_fast.py:353-373)."""
    lr, bk, d = rows.shape
    xf = rows.float().reshape(lr, bk, n_heads, d // n_heads)
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q.reshape(lr, bk, d), scale


FP8_MAX = 448.0  # largest finite float8_e4m3fn


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """The fp8 self cache's store: clamp to +-448, then cast. torch saturates
    where ml_dtypes (JAX) overflows to NaN; the clamp makes both agree."""
    return x.float().clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)


def build_decode_cache(params: Params, enc_out: torch.Tensor, num_beams: int, max_len: int,
                       cfg: BartConfig, dtype=torch.bfloat16, pad_to: int = 1,
                       time_major: bool = False, cross_kv_int8: bool = False,
                       self_kv_int8: bool = False, self_kv_fp8: bool = False) -> DecodeCache:
    """Cross K/V once per batch item; zero self cache at batch*beams with T
    rounded up to `pad_to`. time_major=True: [L, T, BK, D] + identity
    ancestry (kernel path); else [L, BK, T, D] (reference path).
    self_kv_int8 / self_kv_fp8 (kernel path, one at most): the self cache in
    int8 with zero [L, T, BK, H] scales, or in fp8 e4m3."""
    if self_kv_int8 and self_kv_fp8:
        raise ValueError("build_decode_cache: self_kv_int8 and self_kv_fp8 exclude each other")
    if (self_kv_int8 or self_kv_fp8) and not time_major:
        raise ValueError("build_decode_cache: a quantized self cache needs time_major=True")
    layers = params["decoder"]["layers"]
    b, s, d = enc_out.shape
    t_len = -(-max_len // pad_to) * pad_to
    h, hd = cfg.decoder_attention_heads, cfg.decoder_head_dim
    dev = enc_out.device

    def project(name):
        outs, scales = [], []
        x = enc_out.to(dtype).float()
        for p in layers:  # one layer's [B, S, D] f32 at a time
            y = x @ p["encoder_attn"][name]["kernel"].to(dtype).float() \
                + p["encoder_attn"][name]["bias"].float()
            y = y.to(dtype).reshape(b, s, h, hd).permute(0, 2, 3, 1)  # [B, H, hd, S]
            if cross_kv_int8:
                yq, sc = quantize_cross_kv(y)
                outs.append(yq)
                scales.append(sc)
            else:
                outs.append(y.contiguous())
        return (torch.stack(outs).contiguous(),
                torch.stack(scales).contiguous() if cross_kv_int8 else None)

    cross_k, ck_scale = project("k_proj")
    cross_v, cv_scale = project("v_proj")
    n_layers, bkt = len(layers), b * num_beams
    shape = (n_layers, t_len, bkt, d) if time_major else (n_layers, bkt, t_len, d)
    anc = None
    if time_major:
        anc = torch.arange(bkt, dtype=torch.int32, device=dev)[None, :].repeat(t_len, 1)
    self_dtype = torch.int8 if self_kv_int8 else torch.float8_e4m3fn if self_kv_fp8 else dtype
    sk_scale = sv_scale = None
    if self_kv_int8:  # zero is safe: a row's scale is written with the row, before any read
        sk_scale = torch.zeros(n_layers, t_len, bkt, h, dtype=torch.float32, device=dev)
        sv_scale = torch.zeros_like(sk_scale)
    return DecodeCache(
        self_k=torch.zeros(shape, dtype=self_dtype, device=dev),
        self_v=torch.zeros(shape, dtype=self_dtype, device=dev),
        cross_k=cross_k, cross_v=cross_v, anc=anc, pos=0 if time_major else None,
        cross_k_scale=ck_scale, cross_v_scale=cv_scale,
        self_k_scale=sk_scale, self_v_scale=sv_scale)


def reorder_anc(cache: DecodeCache, flat_sel: torch.Tensor) -> DecodeCache:
    """Beam select on the kernel path: compose the ancestry with the
    selection instead of gathering cache rows. Rows after `pos` reset to
    identity, so the next step's row write (row r holds beam r's new K/V)
    composes correctly on the following select."""
    t_len, bk = cache.anc.shape
    anc = cache.anc[:, flat_sel.long()]
    t_ids = torch.arange(t_len, device=anc.device)[:, None]
    ident = torch.arange(bk, dtype=anc.dtype, device=anc.device)[None, :]
    return cache._replace(anc=torch.where(t_ids <= cache.pos, anc, ident).contiguous())


def reorder_batch_major(cache: DecodeCache, flat_sel: torch.Tensor) -> DecodeCache:
    """Beam select on the reference path: gather the self cache rows."""
    sel = flat_sel.long()
    return cache._replace(self_k=cache.self_k[:, sel], self_v=cache.self_v[:, sel])


def _embed(params: Params, tok: torch.Tensor, pos: int, cfg: BartConfig, dtype) -> torch.Tensor:
    dec = params["decoder"]
    x = params["shared"]["weight"][tok[:, 0].long()].to(dtype)
    scale = float(cfg.d_model) ** 0.5 if cfg.scale_embedding else 1.0
    x = x * scale + dec["embed_positions"]["weight"][pos + POS_OFFSET].to(dtype)
    return layernorm(dec["layernorm_embedding"], x)


def _lm_head(params: Params, x: torch.Tensor, dtype) -> torch.Tensor:
    """x @ shared.to(dtype)ᵀ with f32 accumulation, + final_logits_bias in f32
    (vacnic_tpu/infer/decode_fast.py:761-763)."""
    w = params["shared"]["weight"].to(dtype)
    return torch.matmul(x.float(), w.float().t()) + params["final_logits_bias"].float()


def decode_step(dp: DecodeParams, params: Params, cache: DecodeCache, tok: torch.Tensor,
                pos: int, enc_mask_bias: torch.Tensor, cfg: BartConfig,
                dtype=torch.bfloat16) -> tuple[torch.Tensor, DecodeCache]:
    """Reference step (plain torch, batch-major cache [L, BK, T, D]):
    -> (logits [BK, V] f32, cache with row `pos` written)."""
    h_heads, hd, d = cfg.decoder_attention_heads, cfg.decoder_head_dim, cfg.d_model
    act = ACT2FN[cfg.activation_function]
    bk = tok.shape[0]
    batch = cache.cross_k.shape[1]
    k_beams = bk // batch
    t_max = cache.self_k.shape[2]
    x = _embed(params, tok, pos, cfg, dtype)
    t_idx = torch.arange(t_max, device=x.device)
    self_bias = torch.where(t_idx <= pos, 0.0, torch.finfo(torch.float32).min)
    scaling = hd ** -0.5
    enc_bias = enc_mask_bias[:, 0, 0, :].float()

    def mm(a, w, b):
        return torch.matmul(a.float(), w.float()) + b

    def ln(p, v):
        return layernorm({"scale": p[0], "bias": p[1]}, v)

    for l in range(dp.w_qkv.shape[0]):
        residual = x
        qkv = mm(x, dp.w_qkv[l], dp.b_qkv[l]).to(dtype)
        q, k_new, v_new = qkv.split(d, dim=-1)
        cache.self_k[l, :, pos] = k_new
        cache.self_v[l, :, pos] = v_new
        qh = (q * scaling).reshape(bk, h_heads, hd)
        s = torch.einsum("bhd,bthd->bht", qh.float(),
                         cache.self_k[l].reshape(bk, t_max, h_heads, hd).float())
        p = torch.softmax(s + self_bias, dim=-1).to(dtype)
        o = torch.einsum("bht,bthd->bhd", p.float(),
                         cache.self_v[l].reshape(bk, t_max, h_heads, hd).float())
        o = mm(o.to(dtype).reshape(bk, d), dp.w_self_out[l], dp.b_self_out[l]).to(dtype)
        x = ln(dp.ln_self[l], residual + o)

        residual = x
        q = mm(x, dp.w_cross_q[l], dp.b_cross_q[l]).to(dtype) * scaling
        qh = q.reshape(batch, k_beams, h_heads, hd)
        s = torch.einsum("bkhd,bhds->bkhs", qh.float(), cache.cross_k[l].float())
        p = torch.softmax(s + enc_bias[:, None, None, :], dim=-1).to(dtype)
        o = torch.einsum("bkhs,bhds->bkhd", p.float(), cache.cross_v[l].float())
        o = mm(o.to(dtype).reshape(bk, d), dp.w_cross_out[l], dp.b_cross_out[l]).to(dtype)
        x = ln(dp.ln_cross[l], residual + o)

        residual = x
        hmid = act(mm(x, dp.w_fc1[l], dp.b_fc1[l])).to(dtype)
        o = mm(hmid, dp.w_fc2[l], dp.b_fc2[l]).to(dtype)
        x = ln(dp.ln_final[l], residual + o)
    return _lm_head(params, x, dtype), cache


def _kernel_stack_step(dp: DecodeParams, params: Params, cache: DecodeCache,
                       tok: torch.Tensor, pos: int, enc_mask_bias: torch.Tensor,
                       cfg: BartConfig, dtype) -> tuple[torch.Tensor, DecodeCache]:
    """Embed, run kernels/decode_layer.decode_stack, write row `pos` (int8:
    quantized, with its scale rows; fp8: clamped and cast)
    -> (x_out [BK, d] bf16, cache)."""
    from vacnic_tpu_torch.kernels.decode_layer import decode_stack

    heads = cfg.decoder_attention_heads
    x = _embed(params, tok, pos, cfg, dtype).to(torch.bfloat16)
    x_out, k_new, v_new = decode_stack(
        dp, x, pos, cache.self_k, cache.self_v, cache.anc, cache.cross_k, cache.cross_v,
        enc_mask_bias[:, 0, 0, :].float().contiguous(), heads,
        cache.cross_k_scale, cache.cross_v_scale, cache.self_k_scale, cache.self_v_scale)
    if cache.self_k.dtype == torch.int8:
        # the rows are quantized from x's dtype (bf16), as the JAX kernel
        # step hands them out even at dtype f32 (decode_layer.py:914)
        k_new, ks = quantize_self_rows(k_new.to(x.dtype), heads)
        v_new, vs = quantize_self_rows(v_new.to(x.dtype), heads)
        cache.self_k_scale[:, pos] = ks
        cache.self_v_scale[:, pos] = vs
    elif cache.self_k.dtype == torch.float8_e4m3fn:
        k_new, v_new = to_fp8(k_new), to_fp8(v_new)
    cache.self_k[:, pos] = k_new
    cache.self_v[:, pos] = v_new
    return x_out, cache._replace(pos=pos)


def decode_step_kernel(dp: DecodeParams, params: Params, cache: DecodeCache,
                       tok: torch.Tensor, pos: int, enc_mask_bias: torch.Tensor,
                       cfg: BartConfig, dtype=torch.bfloat16) -> tuple[torch.Tensor, DecodeCache]:
    """decode_step with the layer stack in kernels/decode_layer.decode_stack
    over the time-major cache. The embedded token enters the stack rounded
    to bf16 and the stack's output leaves in bf16, as in the JAX kernel
    step. The step's K/V rows are written at `pos` after the stack (row
    `pos` is still zero while the stack runs; it reads them from the QKV
    output)."""
    x_out, cache = _kernel_stack_step(dp, params, cache, tok, pos, enc_mask_bias, cfg, dtype)
    return _lm_head(params, x_out.to(dtype), dtype), cache


def decode_step_kernel_stats(dp: DecodeParams, params: Params, cache: DecodeCache,
                             tok: torch.Tensor, pos: int, enc_mask_bias: torch.Tensor,
                             cfg: BartConfig, dtype=torch.bfloat16, shortlist_c: int = 16):
    """decode_step_kernel with the LM head replaced by kernels/lm_stats (port
    of decode_step_pallas_stats): lm_stats over dp's padded head (in the
    dtype it was built in), then lm_stats_topk with C = shortlist_c.
    Returns (logits_padded [BK, Vp] f32, cand_vals [BK, C], cand_idx
    [BK, C], lse [BK], cache) -- beam_search's `step_stats_fn` contract."""
    from vacnic_tpu_torch.kernels.lm_stats import lm_stats, lm_stats_topk

    if dp.w_lm is None:
        raise ValueError("decode_step_kernel_stats: build the padded head with ensure_lm_head")
    x_out, cache = _kernel_stack_step(dp, params, cache, tok, pos, enc_mask_bias, cfg, dtype)
    logits_p, m, s = lm_stats(x_out.to(dp.w_lm.dtype), dp.w_lm, dp.b_lm)
    cv, ci, lse = lm_stats_topk(logits_p, m, s, shortlist_c, params["shared"]["weight"].shape[0])
    return logits_p, cv, ci, lse, cache
