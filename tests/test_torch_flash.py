"""Port kernels/flash_attn through models/layers.attention_core against the
JAX package, f32 on the CPU: at flash-eligible shapes (B 2, H 4, D 64, a
padding mask) attention_core equals JAX flash_attention in interpret mode
and the port's plain softmax attention within 2e-5 (f32 sum order and the
online rescale); rows whose keys are all masked stay finite."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vacnic_tpu.kernels.flash_attn import flash_attention as j_flash
from vacnic_tpu_torch.kernels import flash_attn as FA
from vacnic_tpu_torch.kernels import primitives as K
from vacnic_tpu_torch.models import layers as TL

B, H, D = 2, 4, 64


def qkv_bias(t: int, s: int, seed: int):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, t, D) * D ** -0.5).astype(np.float32)
    k = rng.randn(B, H, s, D).astype(np.float32)
    v = rng.randn(B, H, s, D).astype(np.float32)
    keep = np.ones((B, s), np.float32)
    keep[0, s - 37:] = 0.0
    keep[1, s // 2:] = 0.0
    bias = ((1.0 - keep) * np.finfo(np.float32).min)[:, None, None, :]
    return q, k, v, np.broadcast_to(bias, (B, 1, t, s)).copy()


@pytest.mark.parametrize("t,s", [(256, 256), (256, 512), (512, 512)])
def test_attention_core_flash_matches_jax(t, s):
    q, k, v, bias = qkv_bias(t, s, seed=t + s)
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    assert FA.flash_eligible(tq, tk, tb)
    before = K.launch_counts()
    out = TL.attention_core(tq, tk, tv, tb)
    assert K.launch_counts() == before  # CPU tensors: the plain twin
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                  interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), TL.attention_plain(tq, tk, tv, tb).numpy(),
                               rtol=0, atol=2e-5)


def test_flash_fully_masked_rows_finite():
    q, k, v, bias = qkv_bias(256, 256, seed=9)
    bias[0, 0, 3:9, :] = np.finfo(np.float32).min
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    out = TL.attention_core(tq, tk, tv, tb)
    assert bool(torch.isfinite(out).all())
    # a finite all-masked row weighs its keys uniformly, as the JAX kernel does
    ref = j_flash(*(jnp.asarray(a) for a in (q, k, v, bias)), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-5)
    # a -inf row (a bias that overflowed) gives zeros, not NaN
    tb[1, 0, 0, :] = float("-inf")
    out = FA.flash_attention_plain(tq, tk, tv, tb.expand(B, H, 256, 256))
    assert bool(torch.isfinite(out).all()) and bool((out[1, :, 0] == 0).all())


def test_flash_eligible_rule():
    def shapes(t, s, d, mask=True):
        q, k = torch.empty(1, 1, t, d), torch.empty(1, 1, s, d)
        return q, k, torch.empty(1, 1, t, s) if mask else None

    assert FA.flash_eligible(*shapes(512, 512, 64))
    assert FA.flash_eligible(*shapes(256, 640, 128))
    assert not FA.flash_eligible(*shapes(512, 512, 64, mask=False))
    assert not FA.flash_eligible(*shapes(128, 512, 64))   # T < 256
    assert not FA.flash_eligible(*shapes(512, 612, 64))   # the img+ner+text cross KV
    assert not FA.flash_eligible(*shapes(512, 512, 32))   # head dim
    assert not FA.flash_eligible(*shapes(320, 512, 64))   # T % 128


def test_flash_wrapper_refuses_other_devices():
    x = torch.empty(1, 1, 256, 64, device="meta")
    with pytest.raises(RuntimeError):
        FA.flash_attention(x, x, x, torch.empty(1, 1, 256, 256, device="meta"))
