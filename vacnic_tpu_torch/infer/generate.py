"""Generation entry points (port of vacnic_tpu/infer/generate.py):
`generate_mm` (multimodal captioning), `generate_text_bart` and
`greedy_search` (text-only BART), `get_prob` (teacher-forced sequence
log-probability).

The encoder runs once -- for generate_mm the fused text stack
(kernels/encoder_stack) on the eligible released configs, the
layer-by-layer encoder otherwise, whose 512-token self-attention goes
through kernels/flash_attn -- then beam search steps the decoder with the
kernel step (infer/decode_fast.decode_step_kernel): the write-once
time-major self cache with its ancestry matrix, and int8 cross K/V. On the
card both stacks run the CUDA kernels, with bf16 stacked weights and self
cache, and the cross K/V are int8 at every batch and beam count; for CPU
tensors the stacks take their plain twins in the caller's dtype and the
cross K/V stay unquantized (`cache_plan`).

`self_kv="int8"` or `"fp8"` stores the self cache quantized, on the card
and on the CPU alike: int8 with per-(layer, t, row, head) scales, or fp8
e4m3 (infer/decode_fast.build_decode_cache).

`lm_stats=True` replaces the LM head and the beam shortlist's full-width
passes with the fused LM-stats head (kernels/lm_stats; bf16 on the card,
like the stacks). It needs the shortlist candidate mode and a shortlist no
wider than the vocab blocks; where that gate fails the call raises (the
JAX package warns and runs the plain head instead).

Entry points run on "cuda" unless the caller passes device="cpu"; without
a card and without that argument they raise.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from vacnic_tpu_torch.core.config import BartConfig, DecodeConfig, FusionConfig
from vacnic_tpu_torch.core.device import as_tensor, resolve_device
from vacnic_tpu_torch.infer import decode_fast as DF
from vacnic_tpu_torch.infer.beam_search import beam_search, resolve_cand_mode, shortlist_c_width
from vacnic_tpu_torch.kernels.lm_stats import VBLOCK
from vacnic_tpu_torch.models import bart as B
from vacnic_tpu_torch.models import fusion as F
from vacnic_tpu_torch.models.layers import expand_mask
from vacnic_tpu_torch.models.weights_io import tree_to

CACHE_PAD = 16  # self-cache T rounds up to a multiple of this (50 -> 64)
SELF_KV_KINDS = (None, "int8", "fp8")


class CachePlan(NamedTuple):
    """The decode cache's types: the stacks' dtype, int8 cross K/V or not,
    the self cache's kind (None: the stacks' dtype, "int8" or "fp8")."""
    dtype: torch.dtype
    cross_kv_int8: bool
    self_kv: str | None


def cache_plan(on_card: bool, self_kv: str | None, dtype) -> CachePlan:
    """On the card: bf16 stacks and int8 cross K/V, whatever the batch and
    beam count. (The JAX package quantizes the cross K/V only on its Pallas
    path, which a Mosaic chunking rule keeps from batch 1 x beam 5; CUDA has
    no such rule.) On the CPU: the caller's dtype, unquantized cross K/V.
    The self cache is the caller's choice on both."""
    if self_kv not in SELF_KV_KINDS:
        raise ValueError(f"self_kv must be one of {SELF_KV_KINDS}, got {self_kv!r}")
    return CachePlan(torch.bfloat16 if on_card else dtype, on_card, self_kv)


def _mm_encode(params, input_ids, attention_mask, image_features, cfg, fcfg, *,
               face_features, face_mask, name_ids, name_mask, add_ner_ffn, dtype):
    fwd = (F.mm_encoder_fwd_fused if F.fused_encoder_eligible(fcfg, cfg, add_ner_ffn)
           else F.mm_encoder_fwd)
    return fwd(params, input_ids, attention_mask, image_features, cfg, fcfg,
               face_features=face_features, face_mask=face_mask, name_ids=name_ids,
               name_mask=name_mask, add_ner_ffn=add_ner_ffn, dtype=dtype)


def _search_plan(params, dcfg: DecodeConfig, cand_mode, lm_stats: bool):
    """(candidate mode, stats-head shortlist width or None). Raises when
    lm_stats=True fails the gate of vacnic_tpu/infer/generate.py:165-192."""
    vocab = params["shared"]["weight"].shape[0]
    mode = cand_mode or resolve_cand_mode(dcfg, vocab)
    if not lm_stats:
        return mode, None
    c = shortlist_c_width(dcfg.num_beams)
    n_blocks = -(-vocab // DF.LM_PAD) * DF.LM_PAD // VBLOCK
    if mode != "shortlist" or c > n_blocks:
        raise ValueError(f"lm_stats=True needs the shortlist candidate mode and a shortlist "
                         f"no wider than the vocab blocks (mode {mode!r}, C={c}, "
                         f"{n_blocks} blocks)")
    return mode, c


def _decode_from_encoder(params, enc_hidden, attention_mask, cfg: BartConfig,
                         dcfg: DecodeConfig, dtype, mode: str, shortlist_c: int | None,
                         plan: CachePlan):
    kdtype = plan.dtype
    bsz = enc_hidden.shape[0]
    dp = DF.build_decode_params(params, kdtype)
    cache = DF.build_decode_cache(params, enc_hidden, dcfg.num_beams, dcfg.max_length, cfg,
                                  kdtype, pad_to=CACHE_PAD, time_major=True,
                                  cross_kv_int8=plan.cross_kv_int8,
                                  self_kv_int8=plan.self_kv == "int8",
                                  self_kv_fp8=plan.self_kv == "fp8")
    enc_bias = expand_mask(attention_mask, 1)  # [B, 1, 1, S]

    def step_fn(tok, cache, pos):
        return DF.decode_step_kernel(dp, params, cache, tok, pos, enc_bias, cfg, dtype)

    step_stats_fn = None
    if shortlist_c is not None:
        dp = DF.ensure_lm_head(dp, params, kdtype)

        def step_stats_fn(tok, cache, pos):
            return DF.decode_step_kernel_stats(dp, params, cache, tok, pos, enc_bias, cfg,
                                               dtype, shortlist_c=shortlist_c)

    return beam_search(
        step_fn, cache, bsz, cfg=dcfg, eos_token_id=cfg.eos_token_id,
        pad_token_id=cfg.pad_token_id, decoder_start_token_id=cfg.decoder_start_token_id,
        forced_bos_token_id=cfg.forced_bos_token_id,
        vocab_size=params["shared"]["weight"].shape[0],
        reorder_cache_fn=DF.reorder_anc, device=enc_hidden.device, cand_mode=mode,
        step_stats_fn=step_stats_fn)


@torch.no_grad()
def generate_mm(params, input_ids, attention_mask, image_features, cfg: BartConfig,
                fcfg: FusionConfig, dcfg: DecodeConfig, *, face_features=None,
                face_mask=None, name_ids=None, name_mask=None, add_ner_ffn: bool = True,
                dtype=torch.float32, device=None, cand_mode: str | None = None,
                lm_stats: bool = False, self_kv: str | None = None):
    """Multimodal beam-search captioning -> (sequences [B, max_length] int64,
    scores [B] f32). `params` (the tree of models/fusion) and the inputs
    (tensors or numpy arrays) are moved to `device` ("cuda" by default).
    `cand_mode` picks the beam candidate selection ("full" | "opt" |
    "shortlist"; None = auto), `lm_stats` the fused LM-stats head, `self_kv`
    the self cache (None: the stacks' dtype, "int8" or "fp8")."""
    dev = resolve_device(device)
    plan = cache_plan(dev.type == "cuda", self_kv, dtype)
    mode, shortlist_c = _search_plan(params, dcfg, cand_mode, lm_stats)
    params = tree_to(params, dev)
    input_ids, attention_mask, image_features, face_features, face_mask, name_ids, name_mask = (
        as_tensor(x, dev) for x in (input_ids, attention_mask, image_features, face_features,
                                    face_mask, name_ids, name_mask))
    enc = _mm_encode(params, input_ids, attention_mask, image_features, cfg, fcfg,
                     face_features=face_features, face_mask=face_mask, name_ids=name_ids,
                     name_mask=name_mask, add_ner_ffn=add_ner_ffn, dtype=dtype)
    return _decode_from_encoder(params, enc["last_hidden"], attention_mask, cfg, dcfg, dtype,
                                mode, shortlist_c, plan)


@torch.no_grad()
def generate_text_bart(params, input_ids, attention_mask, cfg: BartConfig, dcfg: DecodeConfig,
                       dtype=torch.float32, *, device=None, self_kv: str | None = None):
    """Text-only BART beam generation over a `models/bart.bart_init` tree
    -> (sequences [B, max_length] int64, scores [B] f32); `self_kv` as in
    generate_mm."""
    dev = resolve_device(device)
    plan = cache_plan(dev.type == "cuda", self_kv, dtype)
    mode = resolve_cand_mode(dcfg, params["shared"]["weight"].shape[0])
    params = tree_to(params, dev)
    input_ids, attention_mask = as_tensor(input_ids, dev), as_tensor(attention_mask, dev)
    enc = B.encoder_fwd(params, input_ids, attention_mask, cfg, dtype=dtype)
    return _decode_from_encoder(params, enc, attention_mask, cfg, dcfg, dtype, mode, None, plan)


def greedy_search(params, input_ids, attention_mask, cfg: BartConfig, dcfg: DecodeConfig,
                  dtype=torch.float32, *, device=None):
    """Greedy decoding: beam search with one beam is argmax decoding."""
    return generate_text_bart(
        params, input_ids, attention_mask, cfg,
        dataclasses.replace(dcfg, num_beams=1, length_penalty=1.0), dtype, device=device)


@torch.no_grad()
def get_prob(params, input_ids, attention_mask, decoder_input_ids, labels, cfg: BartConfig,
             dtype=torch.float32, *, device=None) -> torch.Tensor:
    """Per-sequence log-probability of `labels` [B, T] (token ids) under
    teacher forcing: the sum of token log-probabilities, pad positions
    masked -> [B] f32."""
    dev = resolve_device(device)
    params = tree_to(params, dev)
    input_ids, attention_mask, decoder_input_ids, labels = (
        as_tensor(x, dev) for x in (input_ids, attention_mask, decoder_input_ids, labels))
    out = B.bart_forward(params, input_ids, attention_mask, decoder_input_ids, cfg, dtype=dtype)
    logp = torch.log_softmax(out["logits"].float(), dim=-1)
    tok_lp = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    valid = (labels != cfg.pad_token_id).float()
    return (tok_lp * valid).sum(dim=-1)
