"""Port text-only BART entry points and the multimodal teacher-forced forward
against the JAX package, f32 on the CPU, at the tiny configs:

* params_from_jax carries a text-only `bart_init` tree unchanged;
* shift_tokens_right, encoder_fwd / bart_forward (logits within 1e-4) and
  get_prob (within 1e-4);
* generate_text_bart and greedy_search token-identical to JAX with the
  Pallas decode step selected (VACNIC_PALLAS_DECODE=1, interpret mode),
  scores within 1e-4;
* mm_forward, full and only_image, against JAX mm_forward: logits and
  hidden states within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from vacnic_tpu.core.config import VacnicConfig as JC
from vacnic_tpu.data.synthetic import synthetic_batch as j_batch
from vacnic_tpu.infer import generate as JG
from vacnic_tpu.models import bart as JB
from vacnic_tpu.models import fusion as JF
from vacnic_tpu.train.train_step import create_mask as j_mask, face_mask_from_emb as j_face
from vacnic_tpu_torch.core.config import VacnicConfig as TC
from vacnic_tpu_torch.data.synthetic import synthetic_batch as t_batch
from vacnic_tpu_torch.infer import generate as TG
from vacnic_tpu_torch.models import bart as TB
from vacnic_tpu_torch.models import fusion as TF
from vacnic_tpu_torch.models.weights_io import params_from_jax
from vacnic_tpu_torch.train.train_step import create_mask as t_mask, face_mask_from_emb as t_face

BATCH, SRC, TGT = 3, 16, 10


@pytest.fixture(scope="module")
def text():
    jcfg, tcfg = JC.tiny().bart, TC.tiny().bart
    rng = np.random.RandomState(0)
    jp = JB.bart_init(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.3 * rng.randn(*np.shape(a)).astype(np.float32), jp)
    ids = rng.randint(4, jcfg.vocab_size, (BATCH, SRC)).astype(np.int32)
    ids[:, 0] = jcfg.bos_token_id
    mask = np.ones((BATCH, SRC), np.int32)
    for i, n in enumerate((SRC, 11, 7)):
        ids[i, n - 1] = jcfg.eos_token_id
        ids[i, n:] = jcfg.pad_token_id
        mask[i, n:] = 0
    labels = rng.randint(4, jcfg.vocab_size, (BATCH, TGT)).astype(np.int32)
    labels[:, -3:] = jcfg.pad_token_id
    dec_in = np.array(JB.shift_tokens_right(jnp.asarray(labels), jcfg.pad_token_id,
                                            jcfg.decoder_start_token_id))
    return jcfg, tcfg, jp, params_from_jax(jp), ids, mask, labels, dec_in


def test_params_from_jax_text_only_tree(text):
    jcfg, tcfg, jp, tp, *_ = text
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        tp, is_leaf=lambda a: isinstance(a, torch.Tensor))[0]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
        [jax.tree_util.keystr(p) for p, _ in tflat]
    for (_, a), (_, b) in zip(jflat, tflat):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert set(tp) == {"shared", "encoder", "decoder", "final_logits_bias"}


def test_shift_tokens_right_matches_jax():
    x = np.array([[5, 6, -100, 7], [9, -100, -100, 3]], np.int32)
    ref = JB.shift_tokens_right(jnp.asarray(x), 1, 2)
    out = TB.shift_tokens_right(torch.from_numpy(x), 1, 2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_bart_forward_and_get_prob_match_jax(text):
    jcfg, tcfg, jp, tp, ids, mask, labels, dec_in = text
    ref = JB.bart_forward(jp, ids, mask, dec_in, jcfg)
    out = TB.bart_forward(tp, *(torch.from_numpy(a) for a in (ids, mask, dec_in)), tcfg)
    for key in ("logits", "decoder_hidden", "encoder_hidden"):
        assert_close(out[key], ref[key], msg=key)
    assert_close(TB.encoder_fwd(tp, torch.from_numpy(ids), torch.from_numpy(mask), tcfg),
                 ref["encoder_hidden"])
    jlp = JG.get_prob(jp, ids, mask, dec_in, labels, jcfg)
    tlp = TG.get_prob(tp, ids, mask, dec_in, labels, tcfg, device="cpu")
    assert tlp.shape == (BATCH,) and tlp.dtype == torch.float32
    assert_close(tlp, jlp)


@pytest.mark.parametrize("greedy", [False, True], ids=["beam", "greedy"])
def test_text_generation_matches_jax(text, greedy, monkeypatch):
    jcfg, tcfg, jp, tp, ids, mask, *_ = text
    jd = dataclasses.replace(JC.tiny().decode, max_length=TGT)
    td = dataclasses.replace(TC.tiny().decode, max_length=TGT)
    monkeypatch.setenv("VACNIC_PALLAS_DECODE", "1")
    jfn, tfn = ((JG.greedy_search, TG.greedy_search) if greedy
                else (JG.generate_text_bart, TG.generate_text_bart))
    js, jsc = jfn(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg, jd)
    ts, tsc = tfn(tp, ids, mask, tcfg, td, device="cpu")
    assert ts.shape == (BATCH, TGT)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-4, atol=1e-4)
    assert len(np.unique(ts.numpy())) > 4  # varied tokens


@pytest.mark.parametrize("only_image", [False, True], ids=["full", "onlyimg"])
def test_mm_forward_matches_jax(only_image):
    jcfg, tcfg = JC.tiny(only_image=only_image), TC.tiny(only_image=only_image)
    rng = np.random.RandomState(2)
    jp = JF.multimodal_bart_init(jax.random.PRNGKey(1), jcfg.bart, jcfg.fusion)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*np.shape(a)).astype(np.float32), jp)
    tp = params_from_jax(jp)
    jb, tb = j_batch(jcfg, 2, seed=4), t_batch(tcfg, 2, seed=4)
    dec_in = np.array(JB.shift_tokens_right(jb["caption_ids"], jcfg.bart.pad_token_id,
                                            jcfg.bart.decoder_start_token_id))
    jkw = tkw = {}
    if not only_image:
        jkw = dict(face_features=jb["face_emb"], face_mask=j_face(jb["face_emb"]),
                   name_ids=jb["names_art_ids"], name_mask=j_mask(jb["names_art_ids"]))
        tkw = dict(face_features=tb["face_emb"], face_mask=t_face(tb["face_emb"]),
                   name_ids=tb["names_art_ids"], name_mask=t_mask(tb["names_art_ids"]))
    ref = JF.mm_forward(jp, jb["article_ids"], j_mask(jb["article_ids"]), dec_in,
                        jb["image_cls"], jcfg.bart, jcfg.fusion, **jkw)
    targs = (tp, tb["article_ids"], t_mask(tb["article_ids"]), dec_in, tb["image_cls"],
             tcfg.bart, tcfg.fusion)
    for fused in (True, False):
        out = TF.mm_forward(*targs, allow_fused_encoder=fused, device="cpu", **tkw)
        for key, val in ref.items():
            if val is not None:
                assert_close(out[key], val, msg=f"{key} fused={fused}")
