"""The port's CLIP text tower (vacnic_tpu_torch/models/clip_text.py)
against vacnic_tpu/models/clip_text.py with the same weights
(params_from_jax) and numpy token ids: f32 within 1e-5; bf16 within
2e-2 * max|JAX f32 output| of JAX's bf16 output (both round to bf16 at a
few dozen points over two layers, features up to ~3; each is ~0.02 from
the f32 result at this size), and no farther from the f32 result than
1.5x JAX's bf16 distance. `convert_clip_text_openai` gives
JAX's tree leaf for leaf from one OpenAI-layout state dict; `clip_text_init`
gives JAX's shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vacnic_tpu.models import clip_text as JT
from vacnic_tpu_torch.core.rng import make_generator
from vacnic_tpu_torch.core.tree import leaves_with_path
from vacnic_tpu_torch.models import clip_text as TT
from vacnic_tpu_torch.models.weights_io import params_from_jax

DIMS = dict(vocab_size=64, context_length=16, width=32, layers=2, heads=4, output_dim=16)


@pytest.fixture(scope="module")
def towers():
    jp = JT.clip_text_init(jax.random.PRNGKey(0), **DIMS)
    heads = jp.pop("heads")
    rng = np.random.RandomState(0)
    # perturb so that the LN and bias leaves are not their init constants
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.float32(0.1) * rng.randn(*np.shape(a)).astype(np.float32)
        if np.ndim(a) else np.asarray(a), jp)
    return jp, params_from_jax(jp), heads


def ids(seed, n=3, t=16):
    x = np.random.RandomState(seed).randint(1, 60, (n, t)).astype(np.int32)
    x[0, 5] = 63  # the EOT (highest id) at different places
    x[1, -1] = 63
    return x


def test_clip_text_fwd_matches_jax_f32(towers):
    jp, tp, heads = towers
    x = ids(1)
    ref = np.asarray(JT.clip_text_fwd(jp, jnp.asarray(x), num_heads=heads))
    out = TT.clip_text_fwd(tp, torch.from_numpy(x), num_heads=heads)
    assert out.shape == (3, DIMS["output_dim"]) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_clip_text_fwd_matches_jax_bf16(towers):
    jp, tp, heads = towers
    x = ids(2)
    ref = np.asarray(JT.clip_text_fwd(jp, jnp.asarray(x), jnp.bfloat16, num_heads=heads))
    r32 = np.asarray(JT.clip_text_fwd(jp, jnp.asarray(x), num_heads=heads))
    out = TT.clip_text_fwd(tp, x, torch.bfloat16, num_heads=heads)
    assert out.dtype == torch.float32
    out = out.numpy()
    assert np.abs(out - ref).max() <= 2e-2 * np.abs(r32).max()
    assert 0 < np.abs(out - r32).max() <= 1.5 * np.abs(ref - r32).max()


def test_heads_read_from_the_tree(towers):
    _, tp, heads = towers
    x = ids(3)
    tree = dict(tp, heads=heads)
    assert torch.equal(TT.clip_text_fwd(tree, x), TT.clip_text_fwd(tp, x, num_heads=heads))


def openai_state_dict(jp):
    """The JAX tree under OpenAI CLIP's names and layouts."""
    sd = {"token_embedding.weight": jp["token_embedding"]["weight"],
          "positional_embedding": jp["positional_embedding"],
          "ln_final.weight": jp["ln_final"]["scale"], "ln_final.bias": jp["ln_final"]["bias"],
          "text_projection": jp["text_projection"], "logit_scale": jp["logit_scale"]}
    for i, lp in enumerate(jp["layers"]):
        pre = f"transformer.resblocks.{i}"
        a = lp["attn"]
        sd[f"{pre}.attn.in_proj_weight"] = np.concatenate(
            [a[n]["kernel"].T for n in ("q_proj", "k_proj", "v_proj")])
        sd[f"{pre}.attn.in_proj_bias"] = np.concatenate(
            [a[n]["bias"] for n in ("q_proj", "k_proj", "v_proj")])
        sd[f"{pre}.attn.out_proj.weight"] = a["out_proj"]["kernel"].T
        sd[f"{pre}.attn.out_proj.bias"] = a["out_proj"]["bias"]
        for ln in ("ln_1", "ln_2"):
            sd[f"{pre}.{ln}.weight"] = lp[ln]["scale"]
            sd[f"{pre}.{ln}.bias"] = lp[ln]["bias"]
        for m in ("c_fc", "c_proj"):
            sd[f"{pre}.mlp.{m}.weight"] = lp["mlp"][m]["kernel"].T
            sd[f"{pre}.mlp.{m}.bias"] = lp["mlp"][m]["bias"]
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def test_convert_clip_text_openai_matches_jax(towers):
    jp, _, heads = towers
    sd = openai_state_dict(jp)
    ref = JT.convert_clip_text_openai({k: torch.from_numpy(v) for k, v in sd.items()},
                                      layers=DIMS["layers"], heads=heads)
    got = TT.convert_clip_text_openai({k: torch.from_numpy(v) for k, v in sd.items()},
                                      layers=DIMS["layers"], heads=heads)
    assert got.pop("heads") == ref.pop("heads") == heads
    jflat = {jax.tree_util.keystr(p): np.asarray(v)
             for p, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    tflat = {"".join(f"['{k}']" if isinstance(k, str) else f"[{k}]" for k in p): v
             for p, v in leaves_with_path(got)}
    assert set(jflat) == set(tflat)
    for k, v in tflat.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), jflat[k], err_msg=k)


def test_clip_text_init_shapes_match_jax():
    jp = JT.clip_text_init(jax.random.PRNGKey(0), **DIMS)
    tp = TT.clip_text_init(make_generator(0), **DIMS)
    assert tp["heads"] == jp["heads"] == DIMS["heads"]
    jflat = {jax.tree_util.keystr(p): np.shape(v)
             for p, v in jax.tree_util.tree_flatten_with_path(
                 {k: v for k, v in jp.items() if k != "heads"})[0]}
    tflat = {"".join(f"['{k}']" if isinstance(k, str) else f"[{k}]" for k in p): tuple(v.shape)
             for p, v in leaves_with_path({k: v for k, v in tp.items() if k != "heads"})}
    assert jflat == tflat
    np.testing.assert_allclose(float(tp["logit_scale"]), float(jp["logit_scale"]), rtol=1e-6)
