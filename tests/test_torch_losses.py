"""The port's training losses (vacnic_tpu_torch/train/losses.py) against
vacnic_tpu/train/losses.py on the same numpy inputs, f32 on the CPU: values
and the gradient of every differentiated input within rtol 1e-5 (atol 1e-6:
f32 sums in another order). The SECLA inputs hold tied face rows that
carry the max over regions, so the even split of a tied max's gradient
(torch.amax as jnp.max) is checked."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vacnic_tpu.train import losses as JL
from vacnic_tpu_torch.train import losses as TL

TOL = dict(rtol=1e-5, atol=1e-6)


def grads_match(jfn, tfn, *arrays):
    """Values and gradients (w.r.t. every float input) of jfn and tfn agree."""
    jv, jg = jax.value_and_grad(lambda *a: jfn(*a), argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tv = tfn(*ts)
    tg = torch.autograd.grad(tv, ts, allow_unused=True)  # a detached input has none
    np.testing.assert_allclose(tv.item(), float(jv), **TOL)
    for a, b, t in zip(tg, jg, ts):
        a = torch.zeros_like(t) if a is None else a
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def rn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_pool_and_pool_replace_with_an_empty_row():
    h = rn(0, 3, 5, 8)
    mask = np.array([[1, 1, 0, 0, 0], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    img = rn(1, 3, 8)
    m = torch.from_numpy(mask)
    grads_match(lambda x: jnp.sum(JL.pool(x, jnp.asarray(mask)) ** 2),
                lambda x: (TL.pool(x, m) ** 2).sum(), h)
    grads_match(lambda x, i: jnp.sum(JL.pool_replace(x, jnp.asarray(mask), i) ** 3),
                lambda x, i: (TL.pool_replace(x, m, i) ** 3).sum(), h, img)
    # the all-masked row is 1.0, with a finite (zero) gradient: the guarded divide
    x = torch.tensor(h, requires_grad=True)
    out = TL.pool(x, m)
    assert torch.equal(out[1], torch.ones(8))
    (g,) = torch.autograd.grad(out.sum(), x)
    assert torch.isfinite(g).all() and not g[1].any()


def test_l2_normalize():
    grads_match(lambda x: jnp.sum(JL.l2_normalize(x) * jnp.arange(6.0)),
                lambda x: (TL.l2_normalize(x) * torch.arange(6.0)).sum(), rn(2, 4, 6))


def test_lm_cross_entropy_ignores_pad():
    logits = rn(3, 2, 7, 11)
    labels = np.random.RandomState(4).randint(0, 11, (2, 7)).astype(np.int32)
    labels[0, 4:] = 1
    labels[1, 2] = 1
    lab = torch.from_numpy(labels)
    grads_match(lambda x: JL.lm_cross_entropy(x, jnp.asarray(labels), 1),
                lambda x: TL.lm_cross_entropy(x, lab, 1), logits)


def test_colam_margin_losses():
    dec, teach = rn(5, 3, 6, 8), rn(6, 3, 6, 8)
    mask = np.ones((3, 6), np.int32)
    mask[1, 3:] = 0
    m = torch.from_numpy(mask)
    grads_match(lambda a, b: JL.colam_margin_loss(a, b, jnp.asarray(mask), 1.0),
                lambda a, b: TL.colam_margin_loss(a, b, m, 1.0), dec, teach)
    pooled = np.asarray(JL.l2_normalize(JL.pool(jnp.asarray(teach), jnp.asarray(mask))))
    grads_match(lambda a: JL.colam_margin_from_pooled(a, jnp.asarray(pooled),
                                                      jnp.asarray(mask), 0.3),
                lambda a: TL.colam_margin_from_pooled(a, torch.from_numpy(pooled), m, 0.3),
                dec)


def tied_faces(seed):
    """[B, F, d] face states whose last two faces are one identical row that
    beats every other face (the padded faces of a batch are identical rows)."""
    f = rn(seed, 4, 5, 8)
    f[:, 3] = f[:, 4] = 3.0 + np.abs(rn(seed + 1, 4, 8))
    return f


def test_secla_loss_with_tied_faces():
    faces, names = tied_faces(7), np.abs(rn(9, 4, 3, 8))
    grads_match(JL.secla_loss, TL.secla_loss, faces, names)
    # the tie is real: the tied faces carry the max over regions
    s = np.einsum("and,bfd->abnf", names, faces)
    assert (s.argmax(-1) == 3).all() and np.array_equal(s[..., 3], s[..., 4])


def test_batch_softmax_splits_a_tied_max():
    match = rn(10, 3, 3, 2, 4)
    match[..., 2] = match[..., 3] = 5.0
    t = torch.tensor(match, requires_grad=True)
    (g,) = torch.autograd.grad(TL._batch_softmax(t), t)
    np.testing.assert_allclose(g[..., 2].numpy(), g[..., 3].numpy(), rtol=0, atol=0)
    grads_match(JL._batch_softmax, TL._batch_softmax, match)


def test_face_name_infonce():
    faces, names = tied_faces(11), rn(13, 4, 6, 8)
    fmask = np.array([[1, 1, 1, 0, 0]] * 4, np.int32)
    nmask = np.ones((4, 6), np.int32)
    nmask[2, 2:] = 0
    args = (jnp.asarray(fmask), jnp.asarray(nmask))
    targs = (torch.from_numpy(fmask), torch.from_numpy(nmask))
    grads_match(lambda f, n, s: JL.face_name_infonce(f, args[0], n, args[1], s),
                lambda f, n, s: TL.face_name_infonce(f, targs[0], n, targs[1], s),
                faces, names, np.float32(14.3))


@pytest.mark.parametrize("scale", [1.0, 100.0])
def test_clip_contrastive_loss(scale):
    grads_match(JL.clip_contrastive_loss, TL.clip_contrastive_loss, rn(14, 5, 16),
                rn(15, 5, 16), np.float32(scale))
