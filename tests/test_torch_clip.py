"""The port's CLIP vision tower (vacnic_tpu_torch/models/clip_vit.py)
against the JAX package's on ClipVisionConfig.tiny() with the same weights
(params_from_jax) and numpy pixels: f32 within 1e-5; bf16 within 2e-2 +
2e-2 * |JAX| (one bf16 rounding of values up to a few units, the bf16
tolerance of tests/test_torch_cuda.py). Against the installed HF
CLIPVisionModel through convert_clip_vision_hf at the tolerance of
tests/test_clip_parity.py (atol = rtol = 1e-4). The seeded pixel batch
equals JAX's draw for draw."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vacnic_tpu.core.config import ClipVisionConfig as JClip, VacnicConfig as JC
from vacnic_tpu.data.synthetic import synthetic_batch as j_batch
from vacnic_tpu.models import clip_vit as JV
from vacnic_tpu_torch.core.config import ClipVisionConfig, VacnicConfig
from vacnic_tpu_torch.core.rng import make_generator
from vacnic_tpu_torch.data.synthetic import synthetic_batch
from vacnic_tpu_torch.models import clip_vit as TV
from vacnic_tpu_torch.models.weights_io import convert_clip_vision_hf, params_from_jax

CFG = ClipVisionConfig.tiny()


@pytest.fixture(scope="module")
def towers():
    jp = jax.tree_util.tree_map(np.asarray, JV.clip_vision_init(jax.random.PRNGKey(0),
                                                                JClip.tiny()))
    return jp, params_from_jax(jp)


def pixels(seed, n=3, size=32):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def test_clip_vision_fwd_matches_jax_f32(towers):
    jp, tp = towers
    px = pixels(0)
    jpat, jcls = JV.clip_vision_fwd(jp, jnp.asarray(px), JClip.tiny())
    tpat, tcls = TV.clip_vision_fwd(tp, px, CFG)
    assert tpat.shape == (3, CFG.num_patches, CFG.width) and tcls.shape == (3, CFG.width)
    assert tpat.dtype == tcls.dtype == torch.float32
    np.testing.assert_allclose(tpat.numpy(), np.asarray(jpat), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tcls.numpy(), np.asarray(jcls), atol=1e-5, rtol=1e-5)


def test_clip_vision_fwd_matches_jax_bf16(towers):
    jp, tp = towers
    px = pixels(1)
    jpat, jcls = JV.clip_vision_fwd(jp, jnp.asarray(px), JClip.tiny(), jnp.bfloat16)
    tpat, tcls = TV.clip_vision_fwd(tp, torch.from_numpy(px), CFG, torch.bfloat16)
    assert tpat.dtype == tcls.dtype == torch.float32  # computed in bf16, returned in f32
    for t, j in ((tpat, jpat), (tcls, jcls)):
        j = np.asarray(j)
        assert bool((np.abs(t.numpy() - j) <= 2e-2 + 2e-2 * np.abs(j)).all())
    assert float(np.abs(tcls.numpy() - np.asarray(jcls)).max()) > 0  # bf16 really ran


def test_clip_image_embed_matches_jax(towers):
    jp, tp = towers
    px = pixels(2)
    ref = JV.clip_image_embed(jp, jnp.asarray(px), JClip.tiny())
    out = TV.clip_image_embed(tp, px, CFG)
    assert out.shape == (3, CFG.output_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_patch_embed_is_the_convolution():
    """The patch product equals conv2d (stride P, no padding) on the OIHW
    kernel, rows and columns past the last whole patch dropped."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 37, 35, 3).astype(np.float32))
    k = torch.from_numpy(rng.randn(8, 8, 3, 16).astype(np.float32))  # HWIO
    out = TV.patch_embed(k, x, 8)
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), stride=8)
    assert out.shape == (2, 4 * 4, 16)
    np.testing.assert_allclose(out.numpy(), ref.flatten(2).transpose(1, 2).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_clip_vision_init_shapes_match_jax(towers):
    jp, _ = towers
    tp = TV.clip_vision_init(make_generator(0), CFG)
    pl, pdef = jax.tree_util.tree_flatten(tp)
    jl, jdef = jax.tree_util.tree_flatten(jp)
    assert pdef == jdef
    assert [tuple(p.shape) for p in pl] == [np.shape(j) for j in jl]
    assert all(p.dtype == torch.float32 for p in pl)
    again = TV.clip_vision_init(make_generator(0), CFG)  # seeded: the same tower
    assert all(torch.equal(a, b) for a, b in zip(pl, jax.tree_util.tree_leaves(again)))
    std = float(tp["positional_embedding"].std())
    assert abs(std - CFG.width ** -0.5) < 0.05


def test_clip_matches_hf_clip_vision_model():
    """HF CLIPVisionModel (random tiny config) through
    convert_clip_vision_hf: the CLS is its pooler output (ln_post on the
    CLS), the patches ln_post of its last hidden state."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=CFG.width, intermediate_size=CFG.width * 4, num_hidden_layers=CFG.layers,
        num_attention_heads=CFG.heads, image_size=CFG.image_size, patch_size=CFG.patch_size,
        hidden_act="quick_gelu", attention_dropout=0.0)).eval()
    params = convert_clip_vision_hf(hf.state_dict(), CFG)
    px = pixels(4, n=2)
    with torch.no_grad():
        out = hf(pixel_values=torch.from_numpy(px.transpose(0, 3, 1, 2)))
        ref_patches = hf.vision_model.post_layernorm(out.last_hidden_state[:, 1:, :])
    patches, cls = TV.clip_vision_fwd(params, px, CFG)
    np.testing.assert_allclose(cls.numpy(), out.pooler_output.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(patches.numpy(), ref_patches.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("only_image", [False, True])
def test_synthetic_batch_with_pixels_matches_jax(only_image):
    """with_pixels draws `pixels` where `image_cls` would be drawn: every
    array equals JAX's for the same seed."""
    ours = synthetic_batch(VacnicConfig.tiny(only_image=only_image), 3, seed=9, with_pixels=True)
    theirs = j_batch(JC.tiny(only_image=only_image), 3, seed=9, with_pixels=True)
    assert sorted(ours) == sorted(theirs) and "pixels" in ours and "image_cls" not in ours
    assert ours["pixels"].shape == (3, 32, 32, 3)
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(theirs[k]))
