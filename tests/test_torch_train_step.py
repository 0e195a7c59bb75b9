"""The port's training step (vacnic_tpu_torch/train/train_step.py) against
vacnic_tpu/train/train_step.py on VacnicConfig.tiny() in f32 on the CPU,
with the JAX trees carried over by params_from_jax and the batch made once
with numpy (synthetic_batch):

* compute_losses at dropout 0 (dropout_rng None): every loss component
  within rtol 1e-4, and every gradient leaf of jax.value_and_grad within
  rtol 1e-4 of that leaf's largest |gradient| (+1e-9: the key-projection
  biases' gradients are zero up to f32 noise, softmax being shift-invariant),
  for SECLA, use_secla=False (InfoNCE), only_image, alpha 0, the teacher
  cache (the pooled teacher state surfaced, then fed back), the CLIP loss
  with a text tower on pixels, pixels without it, and remat;
* three make_train_step steps (dropout rates 0, lr 1e-2 so that an update
  is the size of a weight): metrics within rtol 1e-4; each leaf's update,
  new - old, within 1e-3 of JAX's update in norm with f32 or bf16 moments
  (seen: 1.6e-4 and 1.7e-4 at worst), but for the key biases, whose
  gradient is f32 noise and so is their Adam update; and every element
  within rtol 1e-4 + lr, one Adam update: an element whose
  gradient sits near the noise floor, or whose first moment cancels as its
  gradient changes sign, has an update set by f32 noise (seen: 1% and 8% of
  lr in one element of 98304), which only the leaf's norm can hold;
  the teacher and the frozen CLIP tower bit-unchanged; step 0 (lr 0) leaves
  the parameters bit-unchanged and moves the moments;
* eval_step: val_loss within rtol 1e-4, argmax ids identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vacnic_tpu.core.config import VacnicConfig as JC
from vacnic_tpu.data.synthetic import synthetic_batch as j_batch
from vacnic_tpu.models import bart as JB
from vacnic_tpu.models import fusion as JF
from vacnic_tpu.models.clip_text import clip_text_init as j_clip_text_init
from vacnic_tpu.models.clip_vit import clip_vision_init as j_clip_vision_init
from vacnic_tpu.train import train_step as JT
from vacnic_tpu_torch.core.config import VacnicConfig as TC
from vacnic_tpu_torch.core.tree import leaves_with_path
from vacnic_tpu_torch.models.weights_io import params_from_jax
from vacnic_tpu_torch.train import train_step as TT
from vacnic_tpu_torch.train.optim import trainable

BATCH = 4


def configs(fusion=None, **train):
    """The same tiny config in both packages, f32 compute."""
    out = []
    for C in (JC, TC):
        c = C.tiny()
        fcfg = dataclasses.replace(c.fusion, **(fusion or {}))
        tcfg = dataclasses.replace(c.train, **dict(dict(compute_dtype="float32",
                                                        grad_checkpoint=False), **train))
        out.append(dataclasses.replace(c, fusion=fcfg, train=tcfg))
    return out


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_case(jc, clip=False, clip_text=False, pixels=False):
    """JAX trees (numpy leaves) and a numpy batch for config jc."""
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    jp = {"model": JF.multimodal_bart_init(keys[0], jc.bart, jc.fusion)}
    if clip:
        jp["clip"] = j_clip_vision_init(keys[2], jc.clip)
    if clip_text:
        tower = j_clip_text_init(keys[3], vocab_size=64, context_length=16, width=32,
                                 layers=2, heads=jc.clip.text_heads,
                                 output_dim=jc.clip.output_dim)
        jp["clip_text"] = {k: v for k, v in tower.items() if k != "heads"}
    teacher = JB.bart_init(keys[1], jc.bart)
    batch = {k: np.asarray(v) for k, v in j_batch(jc, BATCH, seed=1, with_pixels=pixels).items()}
    if clip_text:
        batch["caption_ids_clip"] = np.random.RandomState(3).randint(
            1, 63, (BATCH, 16)).astype(np.int32)
    return to_np(jp), to_np(teacher), batch


def keystr(path):
    return "".join(f"['{k}']" if isinstance(k, str) else f"[{k}]" for k in path)


def flat_jax(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_losses(tp, tt, batch, tc):
    """(loss, metrics, {path: grad}) of the port's compute_losses."""
    for _, p in leaves_with_path(tp):
        if trainable(p):
            p.requires_grad_(True)
    loss, metrics = TT.compute_losses(tp, tt, batch, tc, None)
    leaves = leaves_with_path(tp)
    gs = torch.autograd.grad(loss, [p for _, p in leaves], allow_unused=True)
    grads = {keystr(path): (torch.zeros_like(p) if g is None else g).numpy()
             for (path, p), g in zip(leaves, gs)}
    return loss, metrics, grads


def jax_losses(jp, jt, batch, jc):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JT.compute_losses(p, jt, b, jc, None), has_aux=True))
    (loss, metrics), grads = fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return loss, metrics, flat_jax(grads)


def assert_grads(got: dict, want: dict):
    assert set(got) == set(want)
    for k, ref in want.items():
        np.testing.assert_allclose(got[k], ref, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(ref).max()) + 1e-9, err_msg=k)


def assert_metrics(tm, jm):
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].detach().numpy(), np.asarray(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


CASES = {
    "secla": (dict(), dict()),
    "infonce": (dict(use_secla=False), dict()),
    "only_image": (dict(), dict(fusion=dict(only_image=True))),
    "alpha0": (dict(alpha=0.0), dict()),
    "remat": (dict(grad_checkpoint=True), dict()),
    "pixels": (dict(), dict(clip=True, pixels=True)),
    "clip_loss": (dict(no_clip_loss=False), dict(clip=True, clip_text=True, pixels=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_compute_losses_and_grads_match_jax(case):
    train, opts = CASES[case]
    fusion = opts.pop("fusion", None) if "fusion" in opts else None
    jc, tc = configs(fusion, **train)
    jp, jt, batch = make_case(jc, **opts)
    jl, jm, jg = jax_losses(jp, jt, batch, jc)
    tl, tm, tg = port_losses(params_from_jax(jp), params_from_jax(jt), batch, tc)
    assert_metrics(tm, jm)
    if case == "clip_loss":
        assert "clip_loss" in tm
        assert np.abs(tg["['clip_text']['logit_scale']"]).max() > 0
    if case == "only_image":
        assert "face_name_loss" not in tm
    if case == "alpha0":
        assert "margin_loss" not in tm
    assert_grads(tg, jg)


def test_teacher_cache_surfaces_and_reuses_pooled_state():
    jc, tc = configs(teacher_cache=True)
    jp, jt, batch = make_case(jc)
    jl, jm, jg = jax_losses(jp, jt, batch, jc)
    tl, tm, tg = port_losses(params_from_jax(jp), params_from_jax(jt), batch, tc)
    pooled = tm.pop("teacher_pooled")
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jm.pop("teacher_pooled")),
                               rtol=1e-5, atol=1e-6)
    assert_metrics(tm, jm)
    cached = dict(batch, teacher_pooled=pooled.numpy())
    jl2, jm2, jg2 = jax_losses(jp, jt, cached, jc)
    tl2, tm2, tg2 = port_losses(params_from_jax(jp), params_from_jax(jt), cached, tc)
    assert "teacher_pooled" not in tm2 and "teacher_pooled" not in jm2
    assert_metrics(tm2, jm2)
    assert_grads(tg2, jg2)
    np.testing.assert_allclose(tl2.item(), tl.item(), rtol=1e-6)


def test_clip_loss_without_text_tower_raises():
    _, tc = configs(no_clip_loss=False)
    jc, _ = configs()
    jp, jt, batch = make_case(jc, clip=True, pixels=True)
    batch["caption_ids_clip"] = np.ones((BATCH, 16), np.int32)
    with pytest.raises(ValueError, match="clip_text"):
        TT.compute_losses(params_from_jax(jp), params_from_jax(jt), batch, tc, None)


def run_steps(jc, tc, dtypes, n=3):
    jp, jt, batch = make_case(jc, clip=True, pixels=True)
    jdt, tdt = dtypes
    j_init, j_step = JT.make_train_step(jc, 20, mu_dtype=jdt, nu_dtype=jdt)
    js = j_init(jp, jt, jax.random.PRNGKey(5))
    j_step = jax.jit(j_step)
    t_init, t_step = TT.make_train_step(tc, 20, mu_dtype=tdt, nu_dtype=tdt, device="cpu")
    ts = t_init(params_from_jax(jp), params_from_jax(jt), 5)
    start = [p.detach().clone() for _, p in leaves_with_path(ts.params)]
    teacher0 = [p.clone() for _, p in leaves_with_path(ts.teacher)]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for i in range(n):
        js, jm = j_step(js, jbatch)
        ts2, tm = t_step(ts, batch)
        assert ts2 is ts and ts.step == i + 1  # updated in place
        out.append((jm, tm))
        if i == 0:  # lr 0 at count 0: parameters bit-unchanged, moments moved
            assert all(torch.equal(a, b) for a, (_, b) in zip(start, leaves_with_path(ts.params)))
            mu = ts.opt_state["bart"]["mu"]["model"]["shared"]["weight"]
            assert mu.abs().sum() > 0
    assert all(torch.equal(a, b) for a, (_, b) in zip(teacher0, leaves_with_path(ts.teacher)))
    for a, (path, b) in zip(start, leaves_with_path(ts.params)):
        if path[0] == "clip":
            assert torch.equal(a, b), path
    assert any(not torch.equal(a, b) for a, (_, b) in zip(start, leaves_with_path(ts.params)))
    return js, ts, out


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_three_train_steps_match_jax(moments):
    lr = 1e-2
    jc, tc = configs(grad_checkpoint=True, lr_bart=lr)
    dtypes = (None, None) if moments == "f32" else (jnp.bfloat16, torch.bfloat16)
    js, ts, out = run_steps(jc, tc, dtypes)
    for jm, tm in out:
        assert_metrics(tm, jm)
    want = flat_jax(js.params)
    start = flat_jax(make_case(jc, clip=True, pixels=True)[0])
    got = {keystr(p): v.detach().numpy() for p, v in leaves_with_path(ts.params)}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=lr, err_msg=k)
        if k.endswith("['k_proj']['bias']"):
            continue
        d_got, d_want = got[k] - start[k], want[k] - start[k]
        assert np.linalg.norm(d_got - d_want) <= 1e-3 * np.linalg.norm(d_want) + 1e-9, k
    dt = torch.float32 if moments == "f32" else torch.bfloat16
    assert ts.opt_state["bart"]["nu"]["model"]["shared"]["weight"].dtype == dt


@pytest.mark.parametrize("only_image", [False, True])
def test_eval_step_matches_jax(only_image):
    jc, tc = configs(dict(only_image=True) if only_image else None)
    jp, _, batch = make_case(jc)
    ref = jax.jit(lambda p, b: JT.eval_step(p, b, jc))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    out = TT.eval_step(params_from_jax(jp), batch, tc, device="cpu")
    np.testing.assert_allclose(out["val_loss"].item(), float(ref["val_loss"]), rtol=1e-4)
    np.testing.assert_array_equal(out["argmax_ids"].numpy(), np.asarray(ref["argmax_ids"]))


def test_helpers_match_jax():
    jc, tc = configs()
    jp, _, batch = make_case(jc)
    tp = params_from_jax(jp)
    j3 = JT.embed_names_3d(jp["model"], jnp.asarray(batch["names_ids"]), jc.bart)
    t3 = TT.embed_names_3d(tp["model"], torch.from_numpy(batch["names_ids"]), tc.bart)
    np.testing.assert_allclose(t3.numpy(), np.asarray(j3), rtol=1e-5, atol=1e-6)
    jt_ = JT.embed_tgt(jp["model"], jnp.asarray(batch["caption_ids"]), jc.bart)
    tt_ = TT.embed_tgt(tp["model"], torch.from_numpy(batch["caption_ids"]), tc.bart)
    np.testing.assert_allclose(tt_.numpy(), np.asarray(jt_), rtol=1e-5, atol=1e-6)
    src = batch["article_ids"]
    args = [src, (src != 1).astype(np.int32), batch["image_cls"], batch["names_art_ids"],
            (batch["names_art_ids"] != 1).astype(np.int32), batch["face_emb"],
            (batch["face_emb"][:, :, -1] != 1).astype(np.int32)]
    jn = JT.get_hidden_states_ner(jp["model"], *(jnp.asarray(a) for a in args), jc.bart,
                                  jc.fusion)
    tn = TT.get_hidden_states_ner(tp["model"], *(torch.from_numpy(a) for a in args), tc.bart,
                                  tc.fusion)
    assert not tn.requires_grad
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-4, atol=1e-5)


def test_perturb_bos_changes_only_the_bos_row():
    _, tc = configs()
    jc, _ = configs()
    jp, _, _ = make_case(jc)
    tp = params_from_jax(jp)["model"]
    g = torch.Generator().manual_seed(0)
    out = TT.perturb_bos(tp, g, scale=0.5)
    w0, w1 = tp["shared"]["weight"], out["shared"]["weight"]
    assert not torch.equal(w0[0], w1[0]) and torch.equal(w0[1:], w1[1:])
    assert out["encoder"] is tp["encoder"]
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(TT.perturb_bos(tp, g2, scale=0.5)["shared"]["weight"], w1)


def test_train_entry_points_need_a_card_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    _, tc = configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.make_train_step(tc, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.eval_step({"model": {}}, {}, tc)
