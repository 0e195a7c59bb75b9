"""BART backbone (port of vacnic_tpu/models/bart.py): embeddings, the
encoder and decoder layers, the text-only encoder and teacher-forced
seq2seq forward, the general KV-cached decoder, the tied LM head, label
shifting and the parameter init.

Training: dropout at JAX's sites, from a seed (`dropout_rng`; None is the
eval path). Every layer draws its masks from its own seed, fold_in(base, i),
with or without remat, so `remat=True` (each layer recomputed in the
backward through torch.utils.checkpoint) replays the forward's masks. JAX's
decoder derives per-layer keys only under remat; the masks themselves are
not JAX's in either case. JAX's remat policies (VACNIC_REMAT_POLICY) are a
TPU-compiler knob and are not carried over: the port's one policy is
"recompute the layer".

Decoding with the general KV cache (`init_cache`, `decoder_fwd(cache=,
cache_index=)`): HF's incremental decode, the step-by-step reference the
kernel decode (infer/decode_fast) is held to. The cache is written in place.

Tensor parallelism (`tp`, core/tensor_parallel): the layers run on a model
rank's shard, attention by heads and fc1/fc2 as a column/row pair, with
the activation dropout drawing the rank's columns of the one-process mask
(models/layers.column_seed)."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from vacnic_tpu_torch.core.config import BartConfig
from vacnic_tpu_torch.core.profiling import annotate
from vacnic_tpu_torch.core.tensor_parallel import ModelShard, copy_to_model_parallel
from vacnic_tpu_torch.kernels.primitives import global_rows_plain, window_attention_plain
from vacnic_tpu_torch.models.layers import (
    ACT2FN,
    NO_DROPOUT,
    Params,
    RngStream,
    _merge_heads,
    _split_heads,
    causal_mask,
    column_linear,
    column_seed,
    dropout,
    embed,
    embedding_init,
    expand_mask,
    fold_in,
    layernorm,
    layernorm_init,
    linear,
    linear_init,
    mha,
    mha_init,
    row_linear,
    split,
)
from vacnic_tpu_torch.models.products import product


def _embed_scale(cfg: BartConfig) -> float:
    return float(cfg.d_model) ** 0.5 if cfg.scale_embedding else 1.0


def embed_and_norm(shared: Params, pos: Params, ln: Params, ids: torch.Tensor,
                   cfg: BartConfig, dtype, pos_offset: int = 0,
                   rngs: RngStream = NO_DROPOUT) -> torch.Tensor:
    """token embed * scale + learned positions (+ cfg.position_offset: 2 for
    BART, 0 for LED) -> LN -> dropout."""
    x = embed(shared, ids, dtype) * _embed_scale(cfg)
    t = ids.shape[-1]
    positions = torch.arange(t, device=ids.device) + cfg.position_offset + pos_offset
    x = x + embed(pos, positions, dtype)[None, :, :]
    x = layernorm(ln, x)
    return dropout(x, cfg.dropout, rngs.next())


def residual_ffn(up: Params, down: Params, ln: Params, x: torch.Tensor, act, cfg: BartConfig,
                 rngs: RngStream = NO_DROPOUT, tp: ModelShard | None = None) -> torch.Tensor:
    """LN(x + dropout(down(dropout(act(up(x)))))): the layers' FFN, fusion's
    residual stream FFNs too; under `tp`, up column- and down row-parallel."""
    h = column_linear(up, copy_to_model_parallel(x, tp), tp)
    h = dropout(act(h), cfg.activation_dropout, column_seed(rngs.next(), tp))
    h = dropout(row_linear(down, h, tp), cfg.dropout, rngs.next())
    return layernorm(ln, x + h)


def encoder_self_attention(p: Params, x: torch.Tensor, attn_mask, cfg: BartConfig,
                           tp: ModelShard | None = None) -> torch.Tensor:
    """An encoder layer's self-attention: BART's dense `mha`, or with
    cfg.attention_window LED's window and global rows (led_self_attention;
    `attn_mask` is then the [B, S] keep-mask)."""
    if cfg.attention_window:
        if tp is not None:
            raise ValueError("encoder_self_attention: LED's windowed attention takes whole "
                             "weights; tp= is not supported with it")
        with annotate("encoder.window_attention"):
            return led_self_attention(p["self_attn"], p["self_attn_global"], x, attn_mask, cfg)
    return mha(p["self_attn"], x, mask=attn_mask, num_heads=cfg.encoder_attention_heads, tp=tp)


def led_self_attention(p: Params, pg: Params, x: torch.Tensor, keep: torch.Tensor,
                       cfg: BartConfig) -> torch.Tensor:
    """LED's encoder self-attention (transformers' LEDEncoderSelfAttention
    with its `output` projection) on the layer-by-layer path: x [B, S, d],
    keep [B, S] {0, 1}. q, k, v from `p`'s q/k/v_proj (q scaled by
    head_dim**-0.5) -> kernels/primitives.window_attention_plain (the band of
    cfg.attention_window / 2 on each side, the global key of <s> as a
    column of every row, padded rows zero); then the global token's row
    replaced by its attention over every unpadded key through `pg`'s
    q/k/v_proj (LED's query_global, key_global, value_global); then
    out_proj."""
    heads = cfg.encoder_attention_heads
    hd = x.shape[-1] // heads
    bias = ((1.0 - keep.float()) * torch.finfo(torch.float32).min)  # [B, S]
    q = _split_heads(linear(p["q_proj"], x) * hd ** -0.5, heads)
    k = _split_heads(linear(p["k_proj"], x), heads)
    v = _split_heads(linear(p["v_proj"], x), heads)
    o = window_attention_plain(q, k, v, bias, cfg.attention_window // 2, cfg.global_tokens)
    o = _merge_heads(o)
    g = cfg.global_tokens
    qg = linear(pg["q_proj"], x[:, :g])  # unscaled: global_rows_plain scales it
    kg = linear(pg["k_proj"], x)
    vg = linear(pg["v_proj"], x)
    o = torch.cat([global_rows_plain(qg, kg, vg, bias, heads).to(o.dtype), o[:, g:]], dim=1)
    return linear(p["out_proj"], o)


def encoder_layer_fwd(p: Params, x: torch.Tensor, attn_mask, cfg: BartConfig,
                      rngs: RngStream = NO_DROPOUT,
                      tp: ModelShard | None = None) -> torch.Tensor:
    """Vanilla post-LN BART encoder layer (LED's with cfg.attention_window)."""
    act = ACT2FN[cfg.activation_function]
    h = encoder_self_attention(p, x, attn_mask, cfg, tp)
    x = layernorm(p["self_attn_layer_norm"], x + dropout(h, cfg.dropout, rngs.next()))
    return residual_ffn(p["fc1"], p["fc2"], p["final_layer_norm"], x, act, cfg, rngs, tp)


def decoder_layer_fwd(p: Params, x: torch.Tensor, self_mask, enc_out: torch.Tensor | None,
                      cross_mask, cfg: BartConfig,
                      rngs: RngStream = NO_DROPOUT,
                      tp: ModelShard | None = None, cache: Params | None = None,
                      cache_index: int | torch.Tensor | None = None) -> torch.Tensor:
    """BART decoder layer over a whole (teacher-forced) sequence, or with
    `cache` ({"self", "cross"} of init_cache's layer) a decode step at
    `cache_index`: the self K/V rows written into the cache in place, the
    cross K/V read from it."""
    act = ACT2FN[cfg.activation_function]
    h = mha(p["self_attn"], x, mask=self_mask, num_heads=cfg.decoder_attention_heads, tp=tp,
            cache=cache["self"] if cache else None, cache_index=cache_index)
    x = layernorm(p["self_attn_layer_norm"], x + dropout(h, cfg.dropout, rngs.next()))
    if enc_out is not None:
        h = mha(p["encoder_attn"], x, key_value=enc_out, mask=cross_mask,
                num_heads=cfg.decoder_attention_heads, tp=tp,
                cache=cache["cross"] if cache else None)
        x = layernorm(p["encoder_attn_layer_norm"], x + dropout(h, cfg.dropout, rngs.next()))
    return residual_ffn(p["fc1"], p["fc2"], p["final_layer_norm"], x, act, cfg, rngs, tp)


def layer_seed(base: int | None, i: int) -> int | None:
    """Layer i's dropout seed: fold_in(base, i), None without dropout."""
    return None if base is None else fold_in(base, i)


def run_layer(fn, remat: bool, *args):
    """fn(*args), or under remat through torch.utils.checkpoint: the layer's
    activations are dropped after the forward and recomputed in the
    backward. fn must draw its dropout masks from its arguments alone."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _decoder_layer(p, x, self_mask, enc_out, cross_mask, cfg, seed, tp, cache=None,
                   cache_index=None):
    return decoder_layer_fwd(p, x, self_mask, enc_out, cross_mask, cfg, RngStream(seed), tp,
                             cache, cache_index)


def _encoder_layer(p, x, mask, cfg, seed, tp):
    return encoder_layer_fwd(p, x, mask, cfg, RngStream(seed), tp)


def decoder_fwd(params: Params, decoder_input_ids: torch.Tensor, enc_out: torch.Tensor,
                enc_attention_mask: torch.Tensor, cfg: BartConfig,
                dtype=torch.float32, *, decoder_attention_mask: torch.Tensor | None = None,
                dropout_rng: int | None = None, remat: bool = False,
                tp: ModelShard | None = None, cache: Params | None = None,
                cache_index: int | torch.Tensor | None = None) -> torch.Tensor:
    """The decoder stack over a whole sequence (teacher-forced: causal self
    mask, plus `decoder_attention_mask`'s padding when given; padded cross
    mask), or with `cache` (init_cache's) a decode step: decoder_input_ids
    [B, t] at positions cache_index.., attending to the cache's rows <=
    cache_index (the JAX mask: one step's tokens see each other whole), the
    cache updated in place; remat is off there, as in JAX. The JAX function
    also returns the updated cache; here the hidden states alone."""
    dec = params["decoder"]
    t = decoder_input_ids.shape[-1]
    pos_offset = int(cache_index) if cache is not None else 0
    x = embed_and_norm(params["shared"], dec["embed_positions"], dec["layernorm_embedding"],
                       decoder_input_ids, cfg, dtype, pos_offset=pos_offset,
                       rngs=RngStream(dropout_rng))
    if cache is not None:
        n_max = cache["layers"][0]["self"]["k"].shape[2]
        pos = torch.arange(n_max, device=x.device)[None, None, None, :]
        self_mask = torch.where(pos <= pos_offset, torch.zeros((), dtype=dtype, device=x.device),
                                torch.full((), torch.finfo(dtype).min, dtype=dtype,
                                           device=x.device))
    else:
        self_mask = causal_mask(t, dtype, device=x.device)
        if decoder_attention_mask is not None:
            self_mask = self_mask + expand_mask(decoder_attention_mask, t, dtype)
    cross_mask = expand_mask(enc_attention_mask, t, dtype)
    for i, p in enumerate(dec["layers"]):
        layer_cache = cache["layers"][i] if cache is not None else None
        x = run_layer(_decoder_layer, remat and cache is None, p, x, self_mask, enc_out,
                      cross_mask, cfg, layer_seed(dropout_rng, i), tp, layer_cache, pos_offset)
    return x


def encoder_self_mask(attention_mask: torch.Tensor, cfg: BartConfig, dtype) -> torch.Tensor:
    """What encoder_self_attention takes as its mask: BART's additive [B, 1,
    S, S], or with cfg.attention_window the [B, S] keep-mask itself."""
    if cfg.attention_window:
        return attention_mask
    return expand_mask(attention_mask, dtype=dtype)


def encoder_fwd(params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                cfg: BartConfig, dtype=torch.float32, *, dropout_rng: int | None = None,
                remat: bool = False, tp: ModelShard | None = None) -> torch.Tensor:
    """Text-only encoder (the CoLaM teacher's) -> [B, S, d]."""
    enc = params["encoder"]
    x = embed_and_norm(params["shared"], enc["embed_positions"], enc["layernorm_embedding"],
                       input_ids, cfg, dtype, rngs=RngStream(dropout_rng))
    mask = encoder_self_mask(attention_mask, cfg, dtype)
    for i, p in enumerate(enc["layers"]):
        x = run_layer(_encoder_layer, remat, p, x, mask, cfg, layer_seed(dropout_rng, i), tp)
    return x


def bart_forward(params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 decoder_input_ids: torch.Tensor, cfg: BartConfig,
                 dtype=torch.float32, *, dropout_rng: int | None = None,
                 remat: bool = False, tp: ModelShard | None = None) -> dict[str, torch.Tensor]:
    """Teacher-forced seq2seq forward -> {"logits", "decoder_hidden",
    "encoder_hidden"}."""
    rng_e, rng_d = split(dropout_rng) if dropout_rng is not None else (None, None)
    enc_out = encoder_fwd(params, input_ids, attention_mask, cfg, dtype,
                          dropout_rng=rng_e, remat=remat, tp=tp)
    dec_out = decoder_fwd(params, decoder_input_ids, enc_out, attention_mask, cfg, dtype,
                          dropout_rng=rng_d, remat=remat, tp=tp)
    return {"logits": lm_logits(params, dec_out), "decoder_hidden": dec_out,
            "encoder_hidden": enc_out}


def shift_tokens_right(input_ids: torch.Tensor, pad_token_id: int,
                       decoder_start_token_id: int) -> torch.Tensor:
    """Prepend decoder_start, drop the last token, and map -100 to pad."""
    shifted = torch.roll(input_ids, 1, dims=-1)
    shifted[:, 0] = decoder_start_token_id
    return torch.where(shifted == -100, pad_token_id, shifted)


def lm_logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """Tied LM head: hidden @ sharedᵀ + final_logits_bias, in float32."""
    w = params["shared"]["weight"].to(hidden.dtype)
    logits = product(hidden, w.t(), cotangent="f32")
    return logits + params["final_logits_bias"].float()


# ---------------------------------------------------------------------------
# Decode-time cache of the general decoder (decoder_fwd(cache=))
# ---------------------------------------------------------------------------

def init_cache(params: Params, batch: int, max_len: int, enc_out: torch.Tensor,
               cfg: BartConfig, dtype=torch.float32) -> Params:
    """{"layers": ({"self": {"k", "v"}, "cross": {"k", "v"}}, ...)}: the self
    K/V zeros of [batch, H, max_len, hd] in `dtype`, written by the decode
    steps; the cross K/V projected from enc_out [batch, S, d] once a
    sequence (in enc_out's dtype), as HF computes them at step 0 and
    reuses them."""
    h = cfg.decoder_attention_heads
    hd = cfg.d_model // h
    dev = enc_out.device
    layers = []
    for p in params["decoder"]["layers"]:
        layers.append({
            "self": {"k": torch.zeros(batch, h, max_len, hd, dtype=dtype, device=dev),
                     "v": torch.zeros(batch, h, max_len, hd, dtype=dtype, device=dev)},
            "cross": {"k": _split_heads(linear(p["encoder_attn"]["k_proj"], enc_out), h),
                      "v": _split_heads(linear(p["encoder_attn"]["v_proj"], enc_out), h)},
        })
    return {"layers": tuple(layers)}


# ---------------------------------------------------------------------------
# Init (same tree and shapes as vacnic_tpu/models/bart.py; the numbers differ:
# torch generators are not JAX keys)
# ---------------------------------------------------------------------------

def encoder_layer_init(g: torch.Generator, cfg: BartConfig, device=None) -> Params:
    p = {
        "self_attn": mha_init(g, cfg.d_model, device),
        "self_attn_layer_norm": layernorm_init(cfg.d_model, device),
        "fc1": linear_init(g, cfg.d_model, cfg.encoder_ffn_dim, device),
        "fc2": linear_init(g, cfg.encoder_ffn_dim, cfg.d_model, device),
        "final_layer_norm": layernorm_init(cfg.d_model, device),
    }
    if cfg.attention_window:  # LED's query_global, key_global, value_global
        p["self_attn_global"] = {n: linear_init(g, cfg.d_model, cfg.d_model, device)
                                 for n in ("q_proj", "k_proj", "v_proj")}
    return p


def decoder_layer_init(g: torch.Generator, cfg: BartConfig, device=None) -> Params:
    return {
        "self_attn": mha_init(g, cfg.d_model, device),
        "self_attn_layer_norm": layernorm_init(cfg.d_model, device),
        "encoder_attn": mha_init(g, cfg.d_model, device),
        "encoder_attn_layer_norm": layernorm_init(cfg.d_model, device),
        "fc1": linear_init(g, cfg.d_model, cfg.decoder_ffn_dim, device),
        "fc2": linear_init(g, cfg.decoder_ffn_dim, cfg.d_model, device),
        "final_layer_norm": layernorm_init(cfg.d_model, device),
    }


def bart_init(g: torch.Generator, cfg: BartConfig, device=None) -> Params:
    return {
        "shared": embedding_init(g, cfg.vocab_size, cfg.d_model, device),
        "encoder": {
            "embed_positions": embedding_init(g, cfg.encoder_positions, cfg.d_model, device),
            "layernorm_embedding": layernorm_init(cfg.d_model, device),
            "layers": tuple(encoder_layer_init(g, cfg, device)
                            for _ in range(cfg.encoder_layers)),
        },
        "decoder": {
            "embed_positions": embedding_init(g, cfg.decoder_positions, cfg.d_model, device),
            "layernorm_embedding": layernorm_init(cfg.d_model, device),
            "layers": tuple(decoder_layer_init(g, cfg, device)
                            for _ in range(cfg.decoder_layers)),
        },
        "final_logits_bias": torch.zeros(cfg.vocab_size, device=device),
    }
