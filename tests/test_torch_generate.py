"""The slice end to end: port generate_mm(..., device="cpu") against JAX
generate_mm with the Pallas decode and encoder kernels selected
(VACNIC_PALLAS_DECODE=1, VACNIC_PALLAS_ENCODER=1; interpret mode on the CPU)
at VacnicConfig.tiny() on a synthetic batch, for the full and the
only_image configs and the full and shortlist beam modes: tokens identical,
scores within 1e-4."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from vacnic_tpu.core.config import VacnicConfig as JC
from vacnic_tpu.data.synthetic import synthetic_batch as j_batch
from vacnic_tpu.infer.generate import generate_mm as j_generate
from vacnic_tpu.models import fusion as JF
from vacnic_tpu.train.train_step import create_mask as j_mask, face_mask_from_emb as j_face
from vacnic_tpu_torch.core.config import VacnicConfig as TC
from vacnic_tpu_torch.data.synthetic import synthetic_batch as t_batch
from vacnic_tpu_torch.infer.generate import generate_mm as t_generate
from vacnic_tpu_torch.kernels import primitives as K
from vacnic_tpu_torch.models.weights_io import params_from_jax
from vacnic_tpu_torch.train.train_step import create_mask as t_mask, face_mask_from_emb as t_face


def inputs(only_image: bool, seed: int = 0):
    jcfg, tcfg = JC.tiny(only_image=only_image), TC.tiny(only_image=only_image)
    # a wider weight spread than the init's 0.02 so the tiny model's beams
    # choose varied tokens rather than one repeated id
    rng = np.random.RandomState(seed + 1)
    jp = JF.multimodal_bart_init(jax.random.PRNGKey(seed), jcfg.bart, jcfg.fusion)
    jp = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.3 * rng.randn(*np.shape(x)).astype(np.float32), jp)
    jb, tb = j_batch(jcfg, 2, seed=seed), t_batch(tcfg, 2, seed=seed)
    jargs = [jp, jb["article_ids"], j_mask(jb["article_ids"]), jb["image_cls"]]
    targs = [params_from_jax(jp), tb["article_ids"], t_mask(tb["article_ids"]), tb["image_cls"]]
    jkw = tkw = {}
    if not only_image:
        jkw = dict(face_features=jb["face_emb"], face_mask=j_face(jb["face_emb"]),
                   name_ids=jb["names_art_ids"], name_mask=j_mask(jb["names_art_ids"]))
        tkw = dict(face_features=tb["face_emb"], face_mask=t_face(tb["face_emb"]),
                   name_ids=tb["names_art_ids"], name_mask=t_mask(tb["names_art_ids"]))
    return jcfg, tcfg, jargs, jkw, targs, tkw


@pytest.mark.parametrize("mode", ["full", "shortlist"])
@pytest.mark.parametrize("only_image", [False, True], ids=["full_cfg", "onlyimg"])
def test_generate_mm_matches_jax(only_image, mode, monkeypatch):
    jcfg, tcfg, jargs, jkw, targs, tkw = inputs(only_image)
    dec = dict(max_length=10)
    monkeypatch.setenv("VACNIC_PALLAS_DECODE", "1")
    monkeypatch.setenv("VACNIC_PALLAS_ENCODER", "1")
    monkeypatch.setenv("VACNIC_BEAM_LOGIC", mode)
    js, jsc = j_generate(*jargs, jcfg.bart, jcfg.fusion,
                         dataclasses.replace(jcfg.decode, **dec), **jkw)
    before = K.launch_counts()
    ts, tsc = t_generate(*targs, tcfg.bart, tcfg.fusion, dataclasses.replace(tcfg.decode, **dec),
                         device="cpu", cand_mode=mode, **tkw)
    assert K.launch_counts() == before
    assert ts.shape == (2, 10) and ts.dtype == torch.int64
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-4, atol=1e-4)
    assert len(np.unique(ts.numpy())) > 4  # the beams chose varied tokens


def test_generate_mm_layerwise_matches_jax(monkeypatch):
    """add_ner_ffn=False: the layer-by-layer encoder (x itself joins the
    cross-attention KV), then the kernel decode step."""
    jcfg, tcfg, jargs, jkw, targs, tkw = inputs(False, seed=3)
    dec = dict(max_length=10)
    monkeypatch.setenv("VACNIC_PALLAS_DECODE", "1")
    js, jsc = j_generate(*jargs, jcfg.bart, jcfg.fusion,
                         dataclasses.replace(jcfg.decode, **dec), add_ner_ffn=False, **jkw)
    ts, tsc = t_generate(*targs, tcfg.bart, tcfg.fusion, dataclasses.replace(tcfg.decode, **dec),
                         add_ner_ffn=False, device="cpu", **tkw)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-4, atol=1e-4)
    assert len(np.unique(ts.numpy())) > 4


def test_generate_mm_auto_mode_and_numpy_inputs():
    """cand_mode=None takes the auto rule; numpy inputs are accepted."""
    jcfg, tcfg, jargs, jkw, targs, tkw = inputs(False, seed=2)
    a, sa = t_generate(*targs, tcfg.bart, tcfg.fusion, tcfg.decode, device="cpu", **tkw)
    npargs = [targs[0]] + [x.numpy() for x in targs[1:]]
    npkw = {k: v.numpy() for k, v in tkw.items()}
    b, sb = t_generate(*npargs, tcfg.bart, tcfg.fusion, tcfg.decode, device="cpu", **npkw)
    assert torch.equal(a, b) and torch.equal(sa, sb)
    assert bool(torch.isfinite(sa).all())
