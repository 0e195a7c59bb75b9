"""Multimodal caption generation, the port's entry point (port of
vacnic_tpu/infer/generate.py:generate_mm).

The encoder runs once over the multimodal inputs -- the fused text stack
(kernels/encoder_stack) for the eligible released configs, the
layer-by-layer encoder otherwise -- then beam search steps the decoder with
the kernel step (infer/decode_fast.decode_step_kernel): the write-once
time-major self cache with its ancestry matrix, and int8 cross K/V. On the
card both stacks run the CUDA kernels, with bf16 stacked weights and self
cache, and the cross K/V are int8; for CPU tensors the stacks take their
plain twins in the caller's dtype and the cross K/V stay unquantized.

Entry points run on "cuda" unless the caller passes device="cpu"; without
a card and without that argument they raise.
"""

from __future__ import annotations

import torch

from vacnic_tpu_torch.core.config import BartConfig, DecodeConfig, FusionConfig
from vacnic_tpu_torch.infer import decode_fast as DF
from vacnic_tpu_torch.infer.beam_search import beam_search
from vacnic_tpu_torch.models import fusion as F
from vacnic_tpu_torch.models.layers import expand_mask
from vacnic_tpu_torch.models.weights_io import tree_to

CACHE_PAD = 16  # self-cache T rounds up to a multiple of this (50 -> 64)


def resolve_device(device=None) -> torch.device:
    """`device` or "cuda"; refuses a cuda device when there is no card."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU unless the caller "
                           "passes device='cpu'")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev


def _mm_encode(params, input_ids, attention_mask, image_features, cfg, fcfg, *,
               face_features, face_mask, name_ids, name_mask, add_ner_ffn, dtype):
    fwd = (F.mm_encoder_fwd_fused if F.fused_encoder_eligible(fcfg, cfg, add_ner_ffn)
           else F.mm_encoder_fwd)
    return fwd(params, input_ids, attention_mask, image_features, cfg, fcfg,
               face_features=face_features, face_mask=face_mask, name_ids=name_ids,
               name_mask=name_mask, add_ner_ffn=add_ner_ffn, dtype=dtype)


def _decode_from_encoder(params, enc_hidden, attention_mask, cfg: BartConfig,
                         dcfg: DecodeConfig, dtype, cand_mode=None):
    on_card = enc_hidden.is_cuda
    kdtype = torch.bfloat16 if on_card else dtype
    bsz = enc_hidden.shape[0]
    dp = DF.build_decode_params(params, kdtype)
    cache = DF.build_decode_cache(params, enc_hidden, dcfg.num_beams, dcfg.max_length, cfg,
                                  kdtype, pad_to=CACHE_PAD, time_major=True,
                                  cross_kv_int8=on_card)
    enc_bias = expand_mask(attention_mask, 1)  # [B, 1, 1, S]

    def step_fn(tok, cache, pos):
        return DF.decode_step_kernel(dp, params, cache, tok, pos, enc_bias, cfg, dtype)

    return beam_search(
        step_fn, cache, bsz, cfg=dcfg, eos_token_id=cfg.eos_token_id,
        pad_token_id=cfg.pad_token_id, decoder_start_token_id=cfg.decoder_start_token_id,
        forced_bos_token_id=cfg.forced_bos_token_id,
        vocab_size=params["shared"]["weight"].shape[0],
        reorder_cache_fn=DF.reorder_anc, device=enc_hidden.device, cand_mode=cand_mode)


def _as_tensor(x, dev):
    if x is None:
        return None
    return torch.as_tensor(x).to(dev)


@torch.no_grad()
def generate_mm(params, input_ids, attention_mask, image_features, cfg: BartConfig,
                fcfg: FusionConfig, dcfg: DecodeConfig, *, face_features=None,
                face_mask=None, name_ids=None, name_mask=None, add_ner_ffn: bool = True,
                dtype=torch.float32, device=None, cand_mode: str | None = None):
    """Multimodal beam-search captioning -> (sequences [B, max_length] int64,
    scores [B] f32). `params` (the tree of models/fusion) and the inputs
    (tensors or numpy arrays) are moved to `device` ("cuda" by default).
    `cand_mode` picks the beam candidate selection ("full" | "shortlist";
    None = auto)."""
    dev = resolve_device(device)
    params = tree_to(params, dev)
    input_ids, attention_mask, image_features, face_features, face_mask, name_ids, name_mask = (
        _as_tensor(x, dev) for x in (input_ids, attention_mask, image_features, face_features,
                                     face_mask, name_ids, name_mask))
    enc = _mm_encode(params, input_ids, attention_mask, image_features, cfg, fcfg,
                     face_features=face_features, face_mask=face_mask, name_ids=name_ids,
                     name_mask=name_mask, add_ner_ffn=add_ner_ffn, dtype=dtype)
    return _decode_from_encoder(params, enc["last_hidden"], attention_mask, cfg, dcfg, dtype,
                                cand_mode)
