"""Port fusion encoder and kernels/encoder_stack against the JAX package:
the fused encoder (plain text stack on the CPU) against JAX
mm_encoder_fwd_fused in interpret mode and the XLA mm_encoder_fwd, for the
full and the only_image configs at VacnicConfig.tiny(), f32.

Tolerances: 1e-4 against the XLA functions (both sides use exact gelu);
2e-4 against the interpret-mode Pallas kernel, whose gelu is a rational erf
approximation (|err| <= 1.5e-7) evaluated in another order."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import assert_close
from vacnic_tpu.core.config import VacnicConfig as JC
from vacnic_tpu.data.synthetic import synthetic_batch as j_batch
from vacnic_tpu.kernels.encoder_stack import encoder_text_stack as j_text_stack
from vacnic_tpu.models import fusion as JF
from vacnic_tpu.train.train_step import create_mask as j_mask, face_mask_from_emb as j_face
from vacnic_tpu_torch.core.config import (PORT_ONLY_BART_FIELDS, BartConfig, FusionConfig,
                                          VacnicConfig as TC)
from vacnic_tpu_torch.core.rng import make_generator
from vacnic_tpu_torch.data.synthetic import synthetic_batch as t_batch
from vacnic_tpu_torch.kernels import encoder_stack as ES
from vacnic_tpu_torch.kernels import primitives as K
from vacnic_tpu_torch.models import fusion as TF
from vacnic_tpu_torch.models.weights_io import params_from_jax
from vacnic_tpu_torch.train.train_step import create_mask as t_mask, face_mask_from_emb as t_face


def perturbed_params(cfg, seed=0):
    rng = np.random.RandomState(seed)
    jp = JF.multimodal_bart_init(jax.random.PRNGKey(seed), cfg.bart, cfg.fusion)
    jp = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.randn(*np.shape(x)).astype(np.float32), jp)
    return jp, params_from_jax(jp)


@pytest.fixture(scope="module", params=[False, True], ids=["full", "onlyimg"])
def setup(request):
    only = request.param
    jcfg, tcfg = JC.tiny(only_image=only), TC.tiny(only_image=only)
    jp, tp = perturbed_params(jcfg)
    jb, tb = j_batch(jcfg, 3, seed=0), t_batch(tcfg, 3, seed=0)
    jkw = tkw = {}
    if not only:
        jkw = dict(face_features=jb["face_emb"], face_mask=j_face(jb["face_emb"]),
                   name_ids=jb["names_art_ids"], name_mask=j_mask(jb["names_art_ids"]))
        tkw = dict(face_features=tb["face_emb"], face_mask=t_face(tb["face_emb"]),
                   name_ids=tb["names_art_ids"], name_mask=t_mask(tb["names_art_ids"]))
    jargs = (jp, jb["article_ids"], j_mask(jb["article_ids"]), jb["image_cls"], jcfg.bart,
             jcfg.fusion)
    targs = (tp, tb["article_ids"], t_mask(tb["article_ids"]), tb["image_cls"], tcfg.bart,
             tcfg.fusion)
    return jargs, jkw, targs, tkw


def test_synthetic_batch_matches():
    jcfg = JC.tiny()
    jb, tb = j_batch(jcfg, 3, seed=5), t_batch(TC.tiny(), 3, seed=5)
    assert set(tb) <= set(jb)
    for k in tb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)


def test_layer_by_layer_encoder(setup):
    jargs, jkw, targs, tkw = setup
    ref = JF.mm_encoder_fwd(*jargs, **jkw)
    out = TF.mm_encoder_fwd(*targs, **tkw)
    for k in ("last_hidden", "img", "ner", "face"):
        if ref[k] is not None:
            assert_close(out[k], ref[k], msg=k)


def test_fused_encoder_against_jax(setup):
    jargs, jkw, targs, tkw = setup
    assert TF.fused_encoder_eligible(targs[5], targs[4], True)
    ref_xla = JF.mm_encoder_fwd(*jargs, **jkw)
    ref_pallas = JF.mm_encoder_fwd_fused(*jargs, interpret=True, **jkw)
    before = K.launch_counts()
    out = TF.mm_encoder_fwd_fused(*targs, **tkw)
    assert K.launch_counts() == before  # CPU tensors: plain twins, no launches
    assert_close(out["last_hidden"], ref_xla["last_hidden"])
    assert_close(out["last_hidden"], ref_pallas["last_hidden"], atol=2e-4, rtol=2e-4)
    for k in ("img", "ner", "face"):
        if ref_xla[k] is not None:
            assert_close(out[k], ref_xla[k], msg=k)


def test_text_stack_plain_on_jax_prologue(setup):
    """encoder_text_stack_plain fed the JAX prologue's own outputs equals the
    interpret-mode Pallas text stack."""
    jargs, jkw, targs, tkw = setup
    x, sp, ck, cv, sb, cb, _ = JF._fused_encoder_prologue(*jargs, interpret=True, **jkw)
    ref = j_text_stack(sp, x, ck, cv, sb, cb, jargs[4], interpret=True)
    tsp = ES.EncStackParams(*(torch.from_numpy(np.array(a)) for a in sp))
    # the JAX stack keeps [L, 1, n] biases; the port keeps [L, n]
    tsp = tsp._replace(**{f: getattr(tsp, f)[:, 0] for f in
                          ("b_qkv", "b_so", "b_cq", "b_co", "b_fc1", "b_fc2")})
    conv = [torch.from_numpy(np.array(a)) for a in (x, ck, cv, sb, cb)]
    out = ES.encoder_text_stack_plain(tsp, *conv, targs[4])
    assert_close(out, ref, atol=2e-4, rtol=2e-4)
    # the public wrapper takes the same plain twin for CPU tensors
    assert torch.equal(ES.encoder_text_stack(tsp, *conv, targs[4]), out)


def test_eligibility_rules():
    cfg = TC.tiny()
    assert TF.fused_encoder_eligible(cfg.fusion, cfg.bart, True)
    assert not TF.fused_encoder_eligible(cfg.fusion, cfg.bart, False)
    part = dataclasses.replace(cfg.fusion, fusion_layers=(0,))
    assert not TF.fused_encoder_eligible(part, cfg.bart, True)
    oi = dataclasses.replace(cfg.fusion, only_image=True)
    assert TF.fused_encoder_eligible(oi, cfg.bart, False)


@pytest.mark.parametrize("only_image", [False, True], ids=["full", "onlyimg"])
def test_init_tree_matches_jax(only_image):
    """multimodal_bart_init builds the JAX tree with the JAX shapes,
    including the d_model == 1024 visual_map branch."""
    bart = BartConfig.tiny(d_model=1024, encoder_layers=1, decoder_layers=1,
                           encoder_ffn_dim=64, decoder_ffn_dim=64)
    fus = FusionConfig.tiny(fusion_layers=(0,), dim_common=1024, img_size=768, prompt_size=2,
                            only_image=only_image)
    import vacnic_tpu.core.config as J

    jbart = J.BartConfig(**{k: v for k, v in dataclasses.asdict(bart).items()
                            if k not in PORT_ONLY_BART_FIELDS})  # LED's: the port's own
    jfus = J.FusionConfig(**dataclasses.asdict(fus))
    shapes = jax.eval_shape(lambda k: JF.multimodal_bart_init(k, jbart, jfus),
                            jax.random.PRNGKey(0))
    tp = TF.multimodal_bart_init(make_generator(0), bart, fus)
    jflat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda a: np.empty(a.shape), tp,
                               is_leaf=lambda a: isinstance(a, torch.Tensor)))[0]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
        [jax.tree_util.keystr(p) for p, _ in tflat]
    assert [tuple(a.shape) for _, a in jflat] == [tuple(a.shape) for _, a in tflat]
    # ner table seeded from the shared embedding, positions copied
    if not only_image:
        enc = tp["encoder"]
        assert torch.equal(enc["embed_tokens_ner"]["weight"][:128], tp["shared"]["weight"][:128])
        assert torch.equal(enc["embed_positions_ner"]["weight"], enc["embed_positions"]["weight"])
