"""The port's checkpoint converters and loader (vacnic_tpu_torch/models/
weights_io.py) against the JAX package's (vacnic_tpu/models/weights_io.py):
the same state dict through both gives the same tree, dicts and tuples
alike, leaf for leaf EXACTLY (the conversion is transposes and f32 casts).
The loader's safetensors reader is held to the `safetensors` package, and
chip_smoke.py's reference-name exporters and safetensors writer, which its
serve phase uses at full width, to both converters."""

import runpy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from vacnic_tpu.core.config import (BartConfig as JBart, ClipVisionConfig as JClip,
                                    FusionConfig as JFusion, VacnicConfig as JC)
from vacnic_tpu.models import fusion as JF
from vacnic_tpu.models import weights_io as JW
from vacnic_tpu.models.clip_vit import clip_vision_init as j_clip_init
from vacnic_tpu_torch.core.config import BartConfig, ClipVisionConfig, FusionConfig
from vacnic_tpu_torch.models import weights_io as W
from vacnic_tpu_torch.models.weights_io import params_from_jax

SMOKE = runpy.run_path(str(Path(__file__).resolve().parents[1] / "chip_smoke.py"),
                       run_name="chip_smoke_imported")
BART_KW = dict(encoder_layers=2, decoder_layers=2, d_model=32, encoder_ffn_dim=64,
               decoder_ffn_dim=64, vocab_size=96, max_position_embeddings=64)


def assert_same_tree(port_tree, jax_tree):
    """Same containers (dict / tuple / list) and keys; every port leaf an
    f32 CPU tensor, contiguous, equal to the JAX leaf bit for bit."""
    pl, pdef = jax.tree_util.tree_flatten(port_tree)
    jl, jdef = jax.tree_util.tree_flatten(jax_tree)
    assert pdef == jdef
    for p, j in zip(pl, jl):
        assert isinstance(p, torch.Tensor) and p.dtype == torch.float32
        assert p.device.type == "cpu" and p.is_contiguous()
        j = np.asarray(j)
        assert j.dtype == np.float32 and p.shape == j.shape
        np.testing.assert_array_equal(p.numpy(), j)


def hf_bart(seed=0):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    cfg = transformers.BartConfig(
        vocab_size=BART_KW["vocab_size"], d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_position_embeddings=62, pad_token_id=1, bos_token_id=0,
        eos_token_id=2, decoder_start_token_id=2, forced_bos_token_id=0)
    model = transformers.BartForConditionalGeneration(cfg).eval()
    with torch.no_grad():
        model.final_logits_bias.normal_()  # zeros after init: make the copy visible
    return model


@pytest.mark.parametrize("layout", ["prefixed", "bare"])
def test_convert_bart_matches_jax(layout):
    """BartForConditionalGeneration's `model.`-prefixed keys, and BartModel's
    bare ones (which hold no final_logits_bias: zeros in both packages)."""
    sd = hf_bart().state_dict()
    if layout == "bare":
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    ours = W.convert_bart(sd, BartConfig.tiny(**BART_KW))
    theirs = JW.convert_bart(sd, JBart.tiny(**BART_KW))
    assert_same_tree(ours, theirs)
    bias = ours["final_logits_bias"]
    assert bias.shape == (BART_KW["vocab_size"],)
    assert bool((bias == 0).all()) == (layout == "bare")
    # the kernels are the transposed torch weights
    q = sd[("model." if layout == "prefixed" else "") + "encoder.layers.1.self_attn.q_proj.weight"]
    assert torch.equal(ours["encoder"]["layers"][1]["self_attn"]["q_proj"]["kernel"], q.T)


@pytest.mark.parametrize("new_vocab", [128, 40, 96], ids=["grow", "shrink", "same"])
def test_resize_vocab_matches_jax(new_vocab):
    """The new rows are np.random.RandomState(0)'s draws in both packages."""
    sd = hf_bart(seed=1).state_dict()
    ours = W.resize_vocab(W.convert_bart(sd, BartConfig.tiny(**BART_KW)), new_vocab)
    theirs = JW.resize_vocab(JW.convert_bart(sd, JBart.tiny(**BART_KW)), new_vocab)
    assert_same_tree(ours, theirs)
    assert ours["shared"]["weight"].shape == (new_vocab, 32)
    assert ours["final_logits_bias"].shape == (new_vocab,)


def j_multimodal(fusion_kw: dict, seed=0, visual_map=False):
    bart, fcfg = JBart.tiny(), JFusion.tiny(**fusion_kw)
    tree = JF.multimodal_bart_init(jax.random.PRNGKey(seed), bart, fcfg)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    if visual_map:  # only full width (d 1024) builds it; its name mapping is the same
        rng = np.random.RandomState(seed)
        tree["encoder"]["visual_map"] = {"kernel": rng.randn(24, 32).astype(np.float32),
                                         "bias": rng.randn(32).astype(np.float32)}
    return tree


MULTIMODAL_CASES = {
    "full_clipcap": dict(),
    "only_image": dict(only_image=True),
    "full_mlp_mapper": dict(prompt_mlp_type="mlp", map_size=(4, 8, 6, 3)),
    "fusion_layer_1_only": dict(fusion_layers=(1,)),
}


@pytest.mark.parametrize("case", sorted(MULTIMODAL_CASES))
def test_convert_multimodal_bart_matches_jax(case):
    """A reference-named state dict (chip_smoke.reference_state_dict of a
    JAX tiny tree): both converters give the tree back, exactly."""
    kw = MULTIMODAL_CASES[case]
    jtree = j_multimodal(kw, visual_map=case == "full_clipcap")
    sd = SMOKE["reference_state_dict"](params_from_jax(jtree))
    assert all(k.startswith("model.") for k in sd if k != "final_logits_bias")
    assert sd["final_logits_bias"].shape == (1, JBart.tiny().vocab_size)
    if case == "full_clipcap":
        for name in ("model.encoder.layers.0._linear_1up.weight",
                     "model.encoder.layers.1._face_down.weight", "model.encoder._linear_1.bias",
                     "model.encoder.prompt_mlp.model.2.weight", "model.encoder.visual_map.weight"):
            assert name in sd, name
    ours = W.convert_multimodal_bart(sd, BartConfig.tiny(), FusionConfig.tiny(**kw))
    theirs = JW.convert_multimodal_bart(sd, JBart.tiny(), JFusion.tiny(**kw))
    assert_same_tree(ours, theirs)
    assert_same_tree(ours, jtree)
    if case == "full_mlp_mapper":
        assert len(ours["encoder"]["prompt_mlp"]["stages"]) == 3
        # the converted tree runs: the port's forward on patch tokens equals JAX's
        from vacnic_tpu.data.synthetic import synthetic_batch as j_batch
        from vacnic_tpu.train.train_step import create_mask, face_mask_from_emb
        from vacnic_tpu_torch.models.fusion import mm_forward

        jcfg = JC.tiny()
        b = {k: np.array(v) for k, v in j_batch(jcfg, 2, seed=0).items()}
        patches = np.random.RandomState(1).randn(2, 4, 32).astype(np.float32)
        dec_in = b["caption_ids"][:, :5]
        streams = dict(face_features=b["face_emb"],
                       face_mask=np.array(face_mask_from_emb(b["face_emb"])),
                       name_ids=b["names_art_ids"],
                       name_mask=np.array(create_mask(b["names_art_ids"])))
        mask = np.array(create_mask(b["article_ids"]))
        want = JF.mm_forward(jtree, b["article_ids"], mask, dec_in, patches, JBart.tiny(),
                             JFusion.tiny(**kw), **streams)
        got = mm_forward(ours, b["article_ids"], mask, dec_in, patches, BartConfig.tiny(),
                         FusionConfig.tiny(**kw), device="cpu", **streams)
        for k in ("logits", "hidden_states_img"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=k)


def test_convert_multimodal_bart_bare_keys_and_device():
    """Keys without `model.` convert alike; `device` places every leaf."""
    jtree = j_multimodal({})
    sd = SMOKE["reference_state_dict"](params_from_jax(jtree))
    bare = {k.removeprefix("model."): v for k, v in sd.items()}
    ours = W.convert_multimodal_bart(bare, BartConfig.tiny(), FusionConfig.tiny(), device="cpu")
    assert_same_tree(ours, JW.convert_multimodal_bart(bare, JBart.tiny(), JFusion.tiny()))
    meta = W.convert_multimodal_bart(sd, BartConfig.tiny(), FusionConfig.tiny(), device="meta")
    assert all(t.device.type == "meta" for t in jax.tree_util.tree_leaves(meta))


def test_convert_clip_openai_matches_jax():
    """OpenAI `visual.*` (chip_smoke.openai_clip_state_dict of a JAX tiny
    tower: packed in_proj, OIHW conv1)."""
    jtree = jax.tree_util.tree_map(np.asarray, j_clip_init(jax.random.PRNGKey(2), JClip.tiny()))
    sd = SMOKE["openai_clip_state_dict"](params_from_jax(jtree))
    assert sd["visual.conv1.weight"].shape == (32, 3, 16, 16)
    assert sd["visual.transformer.resblocks.1.attn.in_proj_weight"].shape == (96, 32)
    ours = W.convert_clip_vision_openai(sd, ClipVisionConfig.tiny())
    theirs = JW.convert_clip_vision_openai(sd, JClip.tiny())
    assert_same_tree(ours, theirs)
    assert_same_tree(ours, jtree)


@pytest.mark.parametrize("with_projection", [False, True])
def test_convert_clip_hf_matches_jax(with_projection):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(3)
    hcfg = transformers.CLIPVisionConfig(
        hidden_size=32, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        image_size=32, patch_size=16, hidden_act="quick_gelu", projection_dim=16)
    cls = (transformers.CLIPVisionModelWithProjection if with_projection
           else transformers.CLIPVisionModel)
    sd = cls(hcfg).state_dict()
    ours = W.convert_clip_vision_hf(sd, ClipVisionConfig.tiny())
    theirs = JW.convert_clip_vision_hf(sd, JClip.tiny())
    assert_same_tree(ours, theirs)
    assert ("proj" in ours) == with_projection
    with pytest.raises(ValueError, match="not an HF CLIP"):
        W.convert_clip_vision_hf({"visual.proj": torch.zeros(2)}, ClipVisionConfig.tiny())


# ---------------------------------------------------------------------------
# load_state_dict
# ---------------------------------------------------------------------------

def assert_same_state(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_load_bin_state_dict_and_pickled_module(tmp_path):
    """torch.save of a state dict, and of a whole module (the reference's
    checkpoints): both give the state dict, as JAX's loader does."""
    model = hf_bart(seed=4)
    sd = model.state_dict()
    torch.save(sd, tmp_path / "sd.bin")
    torch.save(model, tmp_path / "whole.pt")
    for name in ("sd.bin", "whole.pt"):
        got = W.load_state_dict(str(tmp_path / name))
        assert_same_state(got, sd)
        assert_same_state(JW.load_state_dict(str(tmp_path / name)), got)


def st_tensors(dtype):
    g = torch.Generator().manual_seed(5)
    return {
        "w": torch.randn(7, 5, generator=g).to(dtype),
        "b": torch.randn(5, generator=g).to(dtype),
        "scalar": torch.tensor(3.5).to(dtype),
        "empty": torch.zeros(0, 4, dtype=dtype),
        "ids": torch.arange(-3, 9, dtype=torch.int64).reshape(3, 4),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["f32", "f16", "bf16"])
def test_safetensors_reader_matches_package(tmp_path, dtype):
    """A file written by the `safetensors` package (with __metadata__): the
    port's reader gives the tensors that were written, and JAX's loader (the
    package's numpy reader) the same values."""
    st = pytest.importorskip("safetensors.torch")
    want = st_tensors(dtype)
    path = str(tmp_path / "t.safetensors")
    st.save_file(want, path, metadata={"format": "pt"})
    got = W.load_state_dict(path)
    assert_same_state(got, want)
    assert_same_state(got, st.load_file(path))
    theirs = JW.load_state_dict(path)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(theirs[k]).astype(np.float64),
                                      v.double().numpy())


def test_safetensors_reader_other_dtypes(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    want = {"f64": torch.randn(3, dtype=torch.float64), "i64": torch.arange(4),
            "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
            "u8": torch.tensor([0, 200, 255], dtype=torch.uint8),
            "bool": torch.tensor([True, False, True])}
    path = str(tmp_path / "t.safetensors")
    st.save_file(want, path)
    assert_same_state(W.read_safetensors(path), want)


def test_chip_smoke_safetensors_writer(tmp_path):
    """chip_smoke.write_safetensors: the package reads back what it wrote,
    and so does the port's reader."""
    st = pytest.importorskip("safetensors.torch")
    want = dict(st_tensors(torch.bfloat16), f32=torch.randn(4, 3), flag=torch.tensor([True]))
    path = str(tmp_path / "w.safetensors")
    SMOKE["write_safetensors"](path, want)
    assert_same_state(st.load_file(path), want)
    assert_same_state(W.load_state_dict(path), want)


@pytest.mark.parametrize("fmt", ["safetensors", "bin", "both"])
def test_load_directory(tmp_path, fmt):
    """A directory: model.safetensors first, then pytorch_model.bin."""
    st = pytest.importorskip("safetensors.torch")
    a, b = st_tensors(torch.float32), {"other": torch.ones(2)}
    if fmt in ("safetensors", "both"):
        st.save_file(a, str(tmp_path / "model.safetensors"))
    if fmt in ("bin", "both"):
        torch.save(b, tmp_path / "pytorch_model.bin")
    assert_same_state(W.load_state_dict(str(tmp_path)), b if fmt == "bin" else a)


def test_load_errors(tmp_path):
    """No checkpoint in a directory; a truncated file; a header or offsets
    past the end; an unknown dtype, named with its key."""
    st = pytest.importorskip("safetensors.torch")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        W.load_state_dict(str(tmp_path))
    path = tmp_path / "t.safetensors"
    st.save_file(st_tensors(torch.float32), str(path))
    data = path.read_bytes()
    cut = tmp_path / "cut.safetensors"
    cut.write_bytes(data[:-8])
    with pytest.raises(ValueError, match="does not fit"):
        W.load_state_dict(str(cut))
    cut.write_bytes(data[:5])
    with pytest.raises(ValueError, match="shorter than"):
        W.load_state_dict(str(cut))
    cut.write_bytes(data[:8] + data[8:40])
    with pytest.raises(ValueError, match="overruns"):
        W.load_state_dict(str(cut))

    def raw(header: bytes, body: bytes = b"\0" * 8) -> Path:
        p = tmp_path / "raw.safetensors"
        p.write_bytes(len(header).to_bytes(8, "little") + header + body)
        return p

    odd = raw(b'{"x": {"dtype": "C64", "shape": [1], "data_offsets": [0, 8]}}')
    with pytest.raises(ValueError, match="'x'.*C64"):
        W.load_state_dict(str(odd))
    past = raw(b'{"y": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}')
    with pytest.raises(ValueError, match="'y'.*does not fit"):
        W.load_state_dict(str(past))
    short = raw(b'{"z": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}')
    with pytest.raises(ValueError, match="'z'"):
        W.load_state_dict(str(short))
