"""Typed configuration for the PyTorch port: a field-for-field copy of
vacnic_tpu/core/config.py (no jax), so both packages build the same presets.

Original notes:

Replaces the reference's ~45 argparse flags duplicated across three entry
points (train_mmbart...match.py:5-82, run_train...onlyvis.py:5-79,
utils/test_mmbart_clip_ddp.py:3-40) with a single dataclass tree plus presets
matching the released launch scripts (run_full_train.sh, run_onlyvis_train.sh).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BartConfig:
    """BART architecture hyperparameters (mirrors HF BartConfig fields we use).

    Defaults are bart-large (the released VACNIC config uses
    `patrickvonplaten/bart-large-fp32`, run_full_train.sh:5) with the vocab
    already extended by <ENT>, <NONAME> (train...match.py:753 resizes
    50265 -> 50267).

    The last three fields hold LED's shape (allenai/led-large-16384,
    config.json; Beltagy et al., arXiv:2004.05150) and are the port's own:
    the JAX package has no LED. Their defaults are BART's, so every BART
    preset is unchanged.
      attention_window: config.json's `attention_window` (one value for
        every encoder layer): each token attends to the keys within
        attention_window / 2 of it. 0 is BART's dense self-attention.
      max_encoder_position_embeddings: `max_encoder_position_embeddings`,
        the rows of the encoder's (and the names stream's) position table;
        0 takes `max_position_embeddings` (BART: one size for both). The
        decoder's table is `max_position_embeddings` (LED's
        `max_decoder_position_embeddings`).
      position_offset: the rows a position table holds before position 0:
        2 for BART's BartLearnedPositionalEmbedding, 0 for LED's.
    Where the window is set, the first token `<s>` has global attention
    (LED's `global_attention_mask` on `<s>`, the paper's convention for long
    inputs, §5): `global_tokens`.
    """

    vocab_size: int = 50267
    d_model: int = 1024
    encoder_layers: int = 12
    decoder_layers: int = 12
    encoder_attention_heads: int = 16
    decoder_attention_heads: int = 16
    encoder_ffn_dim: int = 4096
    decoder_ffn_dim: int = 4096
    max_position_embeddings: int = 1024
    activation_function: str = "gelu"
    scale_embedding: bool = False
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int = 2  # BART decodes starting from </s>
    forced_bos_token_id: int = 0
    # dropout rates (train-time only; inference paths are deterministic)
    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    # LED (port only; see the docstring)
    attention_window: int = 0
    max_encoder_position_embeddings: int = 0
    position_offset: int = 2

    @property
    def global_tokens(self) -> int:
        """The leading tokens with global attention: `<s>` under a window."""
        return 1 if self.attention_window else 0

    @property
    def encoder_positions(self) -> int:
        """Rows of the encoder's position table, the offset's included."""
        return (self.max_encoder_position_embeddings or self.max_position_embeddings
                ) + self.position_offset

    @property
    def decoder_positions(self) -> int:
        """Rows of the decoder's position table, the offset's included."""
        return self.max_position_embeddings + self.position_offset

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads

    @property
    def decoder_head_dim(self) -> int:
        # distinct from head_dim: encoder and decoder head counts may differ
        return self.d_model // self.decoder_attention_heads

    @staticmethod
    def base(**kw) -> "BartConfig":
        """bart-base shape (used by the CPU end-to-end slice, BASELINE config 1)."""
        defaults = dict(
            d_model=768,
            encoder_layers=6,
            decoder_layers=6,
            encoder_attention_heads=12,
            decoder_attention_heads=12,
            encoder_ffn_dim=3072,
            decoder_ffn_dim=3072,
        )
        defaults.update(kw)
        return BartConfig(**defaults)

    @staticmethod
    def tiny(**kw) -> "BartConfig":
        """Small random config for tests / golden parity vs torch."""
        defaults = dict(
            vocab_size=128,
            d_model=32,
            encoder_layers=2,
            decoder_layers=2,
            encoder_attention_heads=4,
            decoder_attention_heads=4,
            encoder_ffn_dim=64,
            decoder_ffn_dim=64,
            max_position_embeddings=128,
            dropout=0.0,
        )
        defaults.update(kw)
        return BartConfig(**defaults)


@dataclass(frozen=True)
class ClipVisionConfig:
    """CLIP ViT vision tower (ViT-B/16 in the released config, run_full_train.sh:6).

    The reference manually unrolls OpenAI CLIP's visual backbone to get both
    patch tokens and the CLS embedding (extract_clip_img_feat,
    train...match.py:220-240); our forward returns the same pair.
    """

    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    output_dim: int = 512  # CLIP joint-embedding dim (after `proj`)
    # text-tower attention heads (ViT-B CLIP text encoder, width 512) — used
    # by the optional CLIP contrastive loss, where the tower's stored "heads"
    # leaf is traced under jit and a static count is needed
    text_heads: int = 8

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @staticmethod
    def tiny(**kw) -> "ClipVisionConfig":
        defaults = dict(image_size=32, patch_size=16, width=32, layers=2, heads=4,
                        output_dim=16, text_heads=4)
        defaults.update(kw)
        return ClipVisionConfig(**defaults)


@dataclass(frozen=True)
class FusionConfig:
    """Multimodal fusion hyperparameters for the modified BART encoder.

    Mirrors the constructor surface of the reference
    `BartForMultiModalGeneration` (model file :1881-1882): enc_fusion_layer,
    dim_common, img_size, prompt_mlp_type, map_size, prompt_size,
    max_ner_type_len, max_ner_type_len_gt, only_image.
    """

    fusion_layers: tuple[int, ...] = tuple(range(12))  # run_full_train.sh:8 (all-enc)
    dim_common: int = 1024
    img_size: int = 768  # CLIP feature dim fed to the prompt MLP
    prompt_mlp_type: str = "clipcap"  # "clipcap" | "mlp"
    map_size: tuple[int, ...] = (196, 256, 64, 16)
    prompt_size: int = 20
    face_feature_dim: int = 512  # FaceNet embedding dim (goodnews...py faces/*.npy)
    max_faces: int = 4  # nytimes...py:22 max_n_faces=4
    max_ner_type_len: int = 80  # in-article names, fixed length
    max_ner_type_len_gt: int = 20  # caption names, fixed length
    only_image: bool = False
    init_attn_weight: bool = False
    ner_vocab_size: int = 50267  # separate NER embedding table (model file :1150)

    @staticmethod
    def tiny(**kw) -> "FusionConfig":
        defaults = dict(
            fusion_layers=(0, 1),
            dim_common=32,
            img_size=32,
            prompt_size=4,
            face_feature_dim=8,
            max_faces=2,
            max_ner_type_len=12,
            max_ner_type_len_gt=6,
            ner_vocab_size=128,
        )
        defaults.update(kw)
        return FusionConfig(**defaults)


# ---------------------------------------------------------------------------
# Data / training / decoding configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DataConfig:
    """Static-shape data contract (XLA-friendly buckets).

    The reference pads dynamically to the batch max (collate_fn_*,
    goodnews...py:22-127); on TPU we fix the buckets so every step compiles
    once.
    """

    dataset: str = "goodnews"  # "goodnews" | "nytimes"
    data_dir: str = ""
    article_max_length: int = 512  # run_full_train.sh:4
    caption_max_length: int = 100  # run_full_train.sh:4
    clip_context_length: int = 77
    num_sentences: int = 8  # CLIP-retrieved segments (run_full_train.sh:30)
    use_retrieval: bool = True
    num_workers: int = 8
    prefetch: int = 2


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (run_full_train.sh values)."""

    seed: int = 684331
    num_epochs: int = 16
    train_batch_size: int = 32
    val_batch_size: int = 1
    lr_bart: float = 3e-5
    lr_clip: float = 1e-7
    weight_decay: float = 0.01
    warmup_rate: float = 0.05
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    clip_norm: float = 0.1
    no_clip_norm: bool = True  # released script disables grad clipping
    # loss composition (train...match.py:358-363)
    margin: float = 1.0  # CoLaM Δ
    alpha: float = 0.5  # CoLaM α
    mapping_loss_weight: float = 1.0
    use_secla: bool = True
    no_mapping: bool = False
    no_clip_loss: bool = True
    freeze_clip: bool = True
    perturb_bos: bool = False
    grad_checkpoint: bool = True
    compute_dtype: str = "bfloat16"  # forward/backward compute; params stay fp32
    # Cache the frozen CoLaM teacher's pooled state per sample after its first
    # computation and skip the teacher forward on later epochs (the teacher is
    # deterministic — numerics-identical; saves its full BART forward per step
    # for epochs >= 2; train/loop.py + losses.colam_margin_from_pooled).
    teacher_cache: bool = False
    # PRNG implementation name of the JAX package's training key tree; kept
    # so both packages serialize the same config. The port draws its random
    # numbers from torch.Generator (core/rng.py): set_random_seed accepts
    # "threefry2x32" and "rbg" and changes nothing for either.
    prng_impl: str = "rbg"


@dataclass(frozen=True)
class DecodeConfig:
    """Generation settings (README.md:8 — beam 5, max_length 50, lp 2.0, seed 42)."""

    num_beams: int = 5
    max_length: int = 50
    length_penalty: float = 2.0
    early_stopping: bool = True
    min_length: int = 0
    no_repeat_ngram_size: int = 3  # facebook/bart-large generation default
    forced_eos: bool = True  # BartConfig default forced_eos_token_id=2
    seed: int = 42
    batch_size: int = 1
    # Beam-semantics compatibility target. "4.18" = the reference env's
    # transformers 4.18 (BeamSearchScorer.process/finalize); "modern" = the
    # vectorized path in current transformers. They differ ONLY in (a) the
    # max-length finalize denominator (4.18: full length incl. decoder start;
    # modern: generated length) and (b) the early_stopping=False heuristic
    # numerator (4.18: best of all 2K candidates incl. eos; modern: best
    # running beam). Under the released VACNIC decode config (bart-large
    # model defaults: early_stopping=True + forced_eos) the two coincide —
    # see tests/test_beam_418_semantics.py.
    hf_compat: str = "4.18"


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout. data = DP axis, model = TP axis."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1: all remaining devices
    model_parallel: int = 1


@dataclass(frozen=True)
class VacnicConfig:
    bart: BartConfig = field(default_factory=BartConfig)
    clip: ClipVisionConfig = field(default_factory=ClipVisionConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # -- presets ------------------------------------------------------------
    @staticmethod
    def full_train() -> "VacnicConfig":
        """The released full-model config (run_full_train.sh)."""
        return VacnicConfig()

    @staticmethod
    def onlyvis_train() -> "VacnicConfig":
        """Visual-prompt-only baseline (run_onlyvis_train.sh; model §2.2)."""
        cfg = VacnicConfig()
        return dataclasses.replace(cfg, fusion=dataclasses.replace(cfg.fusion, only_image=True))

    @staticmethod
    def led_full() -> "VacnicConfig":
        """The full model (full_train) with LED-large-16384 as its BART:
        bart-large's widths, 16384 encoder positions, a window of 1024 in
        every encoder layer with global attention on `<s>`, 1024 decoder
        positions, no position offset; articles of 16384 tokens."""
        cfg = VacnicConfig()
        bart = dataclasses.replace(cfg.bart, attention_window=1024,
                                   max_encoder_position_embeddings=16384, position_offset=0)
        return dataclasses.replace(cfg, bart=bart,
                                   data=dataclasses.replace(cfg.data, article_max_length=16384))

    @staticmethod
    def tiny(only_image: bool = False) -> "VacnicConfig":
        return VacnicConfig(
            bart=BartConfig.tiny(),
            clip=ClipVisionConfig.tiny(),
            fusion=FusionConfig.tiny(dim_common=32, only_image=only_image),
            data=DataConfig(article_max_length=16, caption_max_length=10),
            train=TrainConfig(train_batch_size=2, compute_dtype="float32", grad_checkpoint=False),
            decode=DecodeConfig(num_beams=3, max_length=8),
        )

    # -- (de)serialization — replaces hyperparameters-in-filename codec ------
    # (train...match.py:669-717 encodes config into the checkpoint name and the
    # inference script dispatches on substrings; we store explicit JSON.)
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "VacnicConfig":
        raw: dict[str, Any] = json.loads(s)

        def build(cls, d):
            kw = {}
            for f in dataclasses.fields(cls):
                if f.name in d:
                    v = d[f.name]
                    if isinstance(v, list):
                        v = tuple(v)
                    kw[f.name] = v
            return cls(**kw)

        return VacnicConfig(
            bart=build(BartConfig, raw.get("bart", {})),
            clip=build(ClipVisionConfig, raw.get("clip", {})),
            fusion=build(FusionConfig, raw.get("fusion", {})),
            data=build(DataConfig, raw.get("data", {})),
            train=build(TrainConfig, raw.get("train", {})),
            decode=build(DecodeConfig, raw.get("decode", {})),
            mesh=build(MeshConfig, raw.get("mesh", {})),
        )


# BartConfig's fields that the JAX package's copy does not have (LED's)
PORT_ONLY_BART_FIELDS = ("attention_window", "max_encoder_position_embeddings",
                         "position_offset")


def dtype_of(name: str):
    """Config dtype name -> torch dtype (torch imported here so the config
    module itself stays importable without it)."""
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}[name]
