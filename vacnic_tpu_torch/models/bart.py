"""BART backbone (port of vacnic_tpu/models/bart.py): embeddings, the
encoder and decoder layers over a whole sequence, the text-only encoder and
teacher-forced seq2seq forward, the tied LM head, label shifting and the
parameter init. Inference only."""

from __future__ import annotations

import torch

from vacnic_tpu_torch.core.config import BartConfig
from vacnic_tpu_torch.models.layers import (
    ACT2FN,
    Params,
    causal_mask,
    embed,
    embedding_init,
    expand_mask,
    layernorm,
    layernorm_init,
    linear,
    linear_init,
    mha,
    mha_init,
)

POS_OFFSET = 2  # BartLearnedPositionalEmbedding offset


def _embed_scale(cfg: BartConfig) -> float:
    return float(cfg.d_model) ** 0.5 if cfg.scale_embedding else 1.0


def embed_and_norm(shared: Params, pos: Params, ln: Params, ids: torch.Tensor,
                   cfg: BartConfig, dtype, pos_offset: int = 0) -> torch.Tensor:
    """token embed * scale + learned positions (+2 offset) -> LN."""
    x = embed(shared, ids, dtype) * _embed_scale(cfg)
    t = ids.shape[-1]
    positions = torch.arange(t, device=ids.device) + POS_OFFSET + pos_offset
    x = x + embed(pos, positions, dtype)[None, :, :]
    return layernorm(ln, x)


def encoder_layer_fwd(p: Params, x: torch.Tensor, attn_mask, cfg: BartConfig) -> torch.Tensor:
    """Vanilla post-LN BART encoder layer."""
    act = ACT2FN[cfg.activation_function]
    h = mha(p["self_attn"], x, mask=attn_mask, num_heads=cfg.encoder_attention_heads)
    x = layernorm(p["self_attn_layer_norm"], x + h)
    h = linear(p["fc2"], act(linear(p["fc1"], x)))
    return layernorm(p["final_layer_norm"], x + h)


def decoder_layer_fwd(p: Params, x: torch.Tensor, self_mask, enc_out: torch.Tensor | None,
                      cross_mask, cfg: BartConfig) -> torch.Tensor:
    """BART decoder layer over a whole (teacher-forced) sequence."""
    act = ACT2FN[cfg.activation_function]
    h = mha(p["self_attn"], x, mask=self_mask, num_heads=cfg.decoder_attention_heads)
    x = layernorm(p["self_attn_layer_norm"], x + h)
    if enc_out is not None:
        h = mha(p["encoder_attn"], x, key_value=enc_out, mask=cross_mask,
                num_heads=cfg.decoder_attention_heads)
        x = layernorm(p["encoder_attn_layer_norm"], x + h)
    h = linear(p["fc2"], act(linear(p["fc1"], x)))
    return layernorm(p["final_layer_norm"], x + h)


def decoder_fwd(params: Params, decoder_input_ids: torch.Tensor, enc_out: torch.Tensor,
                enc_attention_mask: torch.Tensor, cfg: BartConfig,
                dtype=torch.float32) -> torch.Tensor:
    """Teacher-forced decoder stack (causal self mask, padded cross mask)."""
    dec = params["decoder"]
    t = decoder_input_ids.shape[-1]
    x = embed_and_norm(params["shared"], dec["embed_positions"], dec["layernorm_embedding"],
                       decoder_input_ids, cfg, dtype)
    self_mask = causal_mask(t, dtype, device=x.device)
    cross_mask = expand_mask(enc_attention_mask, t, dtype)
    for p in dec["layers"]:
        x = decoder_layer_fwd(p, x, self_mask, enc_out, cross_mask, cfg)
    return x


def encoder_fwd(params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                cfg: BartConfig, dtype=torch.float32) -> torch.Tensor:
    """Text-only encoder (the CoLaM teacher's) -> [B, S, d]."""
    enc = params["encoder"]
    x = embed_and_norm(params["shared"], enc["embed_positions"], enc["layernorm_embedding"],
                       input_ids, cfg, dtype)
    mask = expand_mask(attention_mask, dtype=dtype)
    for p in enc["layers"]:
        x = encoder_layer_fwd(p, x, mask, cfg)
    return x


def bart_forward(params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 decoder_input_ids: torch.Tensor, cfg: BartConfig,
                 dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Teacher-forced seq2seq forward -> {"logits", "decoder_hidden",
    "encoder_hidden"}."""
    enc_out = encoder_fwd(params, input_ids, attention_mask, cfg, dtype)
    dec_out = decoder_fwd(params, decoder_input_ids, enc_out, attention_mask, cfg, dtype)
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
    logits = torch.matmul(hidden.float(), w.float().t())
    return logits + params["final_logits_bias"].float()


# ---------------------------------------------------------------------------
# Init (same tree and shapes as vacnic_tpu/models/bart.py; the numbers differ:
# torch generators are not JAX keys)
# ---------------------------------------------------------------------------

def encoder_layer_init(g: torch.Generator, cfg: BartConfig, device=None) -> Params:
    return {
        "self_attn": mha_init(g, cfg.d_model, device),
        "self_attn_layer_norm": layernorm_init(cfg.d_model, device),
        "fc1": linear_init(g, cfg.d_model, cfg.encoder_ffn_dim, device),
        "fc2": linear_init(g, cfg.encoder_ffn_dim, cfg.d_model, device),
        "final_layer_norm": layernorm_init(cfg.d_model, device),
    }


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
    n_pos = cfg.max_position_embeddings + POS_OFFSET
    return {
        "shared": embedding_init(g, cfg.vocab_size, cfg.d_model, device),
        "encoder": {
            "embed_positions": embedding_init(g, n_pos, cfg.d_model, device),
            "layernorm_embedding": layernorm_init(cfg.d_model, device),
            "layers": tuple(encoder_layer_init(g, cfg, device)
                            for _ in range(cfg.encoder_layers)),
        },
        "decoder": {
            "embed_positions": embedding_init(g, n_pos, cfg.d_model, device),
            "layernorm_embedding": layernorm_init(cfg.d_model, device),
            "layers": tuple(decoder_layer_init(g, cfg, device)
                            for _ in range(cfg.decoder_layers)),
        },
        "final_logits_bias": torch.zeros(cfg.vocab_size, device=device),
    }
