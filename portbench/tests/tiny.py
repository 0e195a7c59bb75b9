"""The tiny configuration of the CPU tests: the port's VacnicConfig.tiny()
as a portbench configuration file, and cell files at its sizes."""

import copy

TINY_SIZES = {
    "vocab_size": 128, "d_model": 32, "encoder_layers": 2, "decoder_layers": 2,
    "encoder_attention_heads": 4, "decoder_attention_heads": 4,
    "encoder_ffn_dim": 64, "decoder_ffn_dim": 64, "max_position_embeddings": 128,
    "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2, "decoder_start_token_id": 2,
    "forced_bos_token_id": 0, "dropout": 0.0,
    "img_size": 32, "prompt_size": 4, "dim_common": 32, "face_feature_dim": 8,
    "face_ffn_dim": 3072, "max_faces": 2, "max_ner_type_len": 12, "max_ner_type_len_gt": 6,
    "ner_vocab_size": 128, "article_max_length": 16, "caption_max_length": 10,
    "image_size": 32, "patch_size": 16, "clip_width": 32, "clip_layers": 2, "clip_heads": 4,
    "clip_output_dim": 16, "num_beams": 3, "max_length": 8, "length_penalty": 2.0,
    "min_length": 7, "no_repeat_ngram_size": 3, "train_batch_size": 2, "lr_bart": 3e-5,
    "weight_decay": 0.01, "warmup_rate": 0.05, "adam_b1": 0.9, "adam_b2": 0.999,
    "adam_eps": 1e-8, "margin": 1.0, "alpha": 0.5, "mapping_loss_weight": 1.0,
    "only_image": False, "enc_cross_kv": 10,
}
# kernels and embeddings N(0, TINY_STD) (conftest.py): at the benchmark's
# 0.02 the tiny decoder hardly reads its input, and a row answered with
# another row's caption would pass any check
TINY_STD = 0.1


def tiny_config(only_image: bool = False) -> dict:
    s = dict(TINY_SIZES, only_image=only_image)
    return {"name": "tiny", "source": "VacnicConfig.tiny()", "port_preset": "tiny",
            "port_overrides": {"decode": {"min_length": 7},
                               "fusion": {"only_image": only_image}},
            "reduced": [], "assumed": [], "sizes": s}


def tiny_spec(spec: dict) -> dict:
    """A cell file at the tiny sizes: batches and windows cut down."""
    s = copy.deepcopy(spec)
    for key, small in (("batch", 4), ("check_rows", 6), ("trace_batches", 1),
                       ("trace_steps", 1)):
        if key in s:
            s[key] = small
    return s
