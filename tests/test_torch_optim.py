"""The port's two-group AdamW (vacnic_tpu_torch/train/optim.py) against the
JAX package's optax chain (vacnic_tpu/train/optim.py) on one tree with a
"model", a "clip" and a "clip_text" subtree and the same numpy gradients:
five updates (warmup, peak, decay) with f32 moments, a bf16 first moment,
bf16 first and second moments (the low-precision Adam), global-norm clipping
on (triggered and not) and off, and the CLIP group frozen or trained.
Parameters and moments within rtol 1e-6 in f32 (atol 1e-8: one rounding of
a few f32 operations); with bf16 moments, moments within one bf16 rounding
(rtol 8e-3) and parameters within rtol 1e-6. The warmup schedule equals
JAX's float for float."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vacnic_tpu.core.config import TrainConfig as JTrain
from vacnic_tpu.train import optim as JO
from vacnic_tpu_torch.core.config import TrainConfig as TTrain
from vacnic_tpu_torch.core.tree import leaves_with_path
from vacnic_tpu_torch.models.weights_io import params_from_jax
from vacnic_tpu_torch.train import optim as TO

STEPS, N_TRAIN = 5, 10


def tree(seed):
    r = np.random.RandomState(seed)

    def a(*s):
        return r.randn(*s).astype(np.float32)

    return {"model": {"enc": {"kernel": a(5, 4), "bias": a(4)}, "layers": ({"w": a(3)},
                                                                        {"w": a(2, 3)})},
            "clip": {"proj": a(6, 2)}, "clip_text": {"emb": a(3, 2)}}


def run_both(cfg_kw, train_clip=False, mu=None, nu=None, grad_scale=1.0):
    jcfg, tcfg = JTrain(**cfg_kw), TTrain(**cfg_kw)
    jdt = {None: None, "bf16": jnp.bfloat16}
    tdt = {None: None, "bf16": torch.bfloat16}
    tx = JO.make_optimizer(jcfg, N_TRAIN, train_clip=train_clip, mu_dtype=jdt[mu],
                           nu_dtype=jdt[nu])
    jp = jax.tree_util.tree_map(jnp.asarray, tree(0))
    jstate = tx.init(jp)
    tp = params_from_jax(tree(0))
    opt = TO.make_optimizer(tcfg, N_TRAIN, train_clip=train_clip, mu_dtype=tdt[mu],
                            nu_dtype=tdt[nu])
    tstate = opt.init(tp)
    for step in range(STEPS):
        g = tree(100 + step)  # jax's tree_map would sort the keys: leaves in the port's order
        upd, jstate = tx.update(jax.tree_util.tree_map(lambda x: jnp.asarray(x * grad_scale), g),
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step_(tp, [torch.from_numpy(x * grad_scale) for _, x in leaves_with_path(g)], tstate)
    return jp, jstate, tp, tstate


def keystr(path):
    return "".join(f"['{k}']" if isinstance(k, str) else f"[{k}]" for k in path)


def assert_tree(tp, jp, **tol):
    """Every leaf of the port's tree (None leaves skipped) against the JAX
    tree's leaf at the same path; the two hold the same paths."""
    jflat = {jax.tree_util.keystr(p): np.asarray(v, np.float32)
             for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]
             if not isinstance(v, optax.MaskedNode)}
    got = {keystr(path): t for path, t in leaves_with_path(tp) if t is not None}
    assert set(got) == set(jflat) and got
    for key, t in got.items():
        np.testing.assert_allclose(t.float().numpy(), jflat[key], err_msg=key, **tol)


def adam_state(jstate, group):
    """The ScaleByAdamState of one group in optax's multi_transform state."""
    inner = jstate.inner_states[group].inner_state
    for s in jax.tree_util.tree_leaves(inner, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            return s
    raise AssertionError("no Adam state")


def moments(jstate, tstate, group, **tol):
    js = adam_state(jstate, group)
    for name in ("mu", "nu"):
        assert_tree(tstate[group][name], getattr(js, name), **tol)
    assert tstate[group]["count"] == int(js.count) == STEPS


BASE = dict(lr_bart=1e-2, lr_clip=1e-3, warmup_rate=0.2)
F32 = dict(rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("train_clip", [False, True], ids=["clip_frozen", "clip_trained"])
@pytest.mark.parametrize("clip", ["off", "triggered", "inactive"])
def test_optimizer_matches_optax_f32(train_clip, clip):
    kw = dict(BASE, no_clip_norm=clip == "off",
              clip_norm={"off": 0.1, "triggered": 0.1, "inactive": 1e6}[clip])
    jp, js, tp, ts = run_both(kw, train_clip=train_clip)
    assert_tree(tp, jp, **F32)
    moments(js, ts, "bart", **F32)
    if train_clip:
        moments(js, ts, "clip", **F32)
    else:  # frozen: the CLIP leaves are bit for bit the initial ones
        for path, t in leaves_with_path({k: tp[k] for k in ("clip", "clip_text")}):
            ref = params_from_jax(tree(0))[path[0]]
            for k in path[1:]:
                ref = ref[k]
            assert torch.equal(t, ref)


@pytest.mark.parametrize("mu,nu", [("bf16", None), ("bf16", "bf16"), (None, "bf16")])
def test_optimizer_matches_optax_bf16_moments(mu, nu):
    jp, js, tp, ts = run_both(dict(BASE, no_clip_norm=False), mu=mu, nu=nu, grad_scale=3.0)
    assert_tree(tp, jp, **F32)
    moments(js, ts, "bart", rtol=8e-3, atol=1e-6)
    assert ts["bart"]["mu"]["model"]["enc"]["kernel"].dtype == (
        torch.bfloat16 if mu else torch.float32)
    assert ts["bart"]["nu"]["model"]["enc"]["kernel"].dtype == (
        torch.bfloat16 if nu else torch.float32)


def test_first_step_moves_moments_not_params():
    """lr is 0 at count 0: the first update changes the moments only."""
    tcfg = TTrain(**BASE)
    tp = params_from_jax(tree(0))
    before = [t.clone() for _, t in leaves_with_path(tp)]
    opt = TO.make_optimizer(tcfg, N_TRAIN)
    st = opt.init(tp)
    opt.step_(tp, [torch.from_numpy(x) for _, x in leaves_with_path(tree(1))], st)
    assert all(torch.equal(a, b) for a, (_, b) in zip(before, leaves_with_path(tp)))
    assert st["bart"]["mu"]["model"]["enc"]["kernel"].abs().sum() > 0


@pytest.mark.parametrize("base,n,rate", [(3e-5, 20, 0.05), (1e-7, 1000, 0.05), (0.1, 7, 0.3),
                                         (1.0, 1, 0.5)])
def test_warmup_schedule_exact(base, n, rate):
    js = JO.linear_warmup_schedule(base, n, rate)
    ts = TO.linear_warmup_schedule(base, n, rate)
    for count in range(n + 3):
        want = np.float32(js(jnp.int32(count)))
        got = ts(count)
        assert got.dtype == np.float32 and got == want, (count, got, want)
    assert ts(0) == 0.0


def test_is_clip_labels():
    assert TO.is_clip(("clip", "layers", 0, "w")) and TO.is_clip(("clip_text", "emb"))
    assert not TO.is_clip(("model", "encoder", "layers", 0, "fc1", "kernel"))
    assert not TO.is_clip(("model", 3))
