"""Dropout, remat and the no-backward guards of the port (no JAX needed):

* `dropout`: JAX's keep rule (uint16 bits < round(keep * 65536): 0.899994
  at rate 0.1, within 5 binomial sigmas over 2**20 draws), inverted scaling,
  the identity at rate 0 or without a seed, the same seed giving the same
  mask and another seed another; `RngStream` is fold_in(seed, n);
* remat replays the forward's masks: compute_losses with dropout on (rate
  0.1 everywhere) gives the same loss and bit-identical gradients with
  grad_checkpoint on and off, and another loss than without dropout;
* every kernel wrapper (kernels/primitives, flash_attn, lm_head, lm_stats,
  encoder_stack, decode_layer) raises on a tensor that requires grad under
  grad mode, on the CPU twin, and runs under torch.no_grad();
  `attention_core` takes `attention_plain` under autograd and the flash
  path otherwise; mm_forward takes the fused encoder only without dropout
  and remat;
* `tree_to` hands back the same leaf tensors when nothing moves.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vacnic_tpu_torch.core.config import BartConfig, VacnicConfig
from vacnic_tpu_torch.core.rng import make_generator
from vacnic_tpu_torch.core.tree import leaves_with_path
from vacnic_tpu_torch.data.synthetic import synthetic_batch
from vacnic_tpu_torch.kernels import encoder_stack, flash_attn, lm_head, lm_stats
from vacnic_tpu_torch.kernels import decode_layer
from vacnic_tpu_torch.kernels import primitives as K
from vacnic_tpu_torch.models import bart as B
from vacnic_tpu_torch.models import fusion as F
from vacnic_tpu_torch.models import layers as L
from vacnic_tpu_torch.models.weights_io import tree_to
from vacnic_tpu_torch.train import train_step as TT


def test_keep_rate_and_scaling():
    x = torch.ones(1 << 20)
    y = L.dropout(x, 0.1, 1234)
    kept = (y != 0).float().mean().item()
    p = round(0.9 * 65536) / 65536  # 0.899994
    assert abs(kept - p) <= 5 * (p * (1 - p) / x.numel()) ** 0.5
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))


def test_identity_without_seed_or_rate():
    x = torch.randn(4, 5)
    assert L.dropout(x, 0.1, None) is x
    assert L.dropout(x, 0.0, 7) is x
    assert L.RngStream(None).next() is None


def test_same_seed_same_mask():
    x = torch.randn(64, 128)
    assert torch.equal(L.dropout(x, 0.3, 11), L.dropout(x, 0.3, 11))
    assert not torch.equal(L.dropout(x, 0.3, 11), L.dropout(x, 0.3, 12))
    s, t = L.RngStream(5), L.RngStream(5)
    seq = [s.next() for _ in range(4)]
    assert seq == [t.next() for _ in range(4)] == [L.fold_in(5, n) for n in (1, 2, 3, 4)]
    assert len(set(seq)) == 4 and all(0 <= v < 2 ** 63 for v in seq)
    assert L.split(5) == (L.fold_in(5, 0), L.fold_in(5, 1)) and L.split(5)[0] != L.split(5)[1]


def dropout_case(grad_checkpoint: bool):
    cfg = VacnicConfig.tiny()
    bart = dataclasses.replace(cfg.bart, dropout=0.1, activation_dropout=0.1)
    train = dataclasses.replace(cfg.train, compute_dtype="float32",
                                grad_checkpoint=grad_checkpoint)
    cfg = dataclasses.replace(cfg, bart=bart, train=train)
    g = make_generator(0)
    params = {"model": F.multimodal_bart_init(g, cfg.bart, cfg.fusion)}
    teacher = B.bart_init(g, cfg.bart)
    for _, p in leaves_with_path(params):
        p.requires_grad_(True)
    return cfg, params, teacher, synthetic_batch(cfg, 4, seed=1)


def losses_and_grads(grad_checkpoint: bool, seed):
    cfg, params, teacher, batch = dropout_case(grad_checkpoint)
    loss, _ = TT.compute_losses(params, teacher, batch, cfg, seed)
    leaves = [p for _, p in leaves_with_path(params)]
    return loss, torch.autograd.grad(loss, leaves, allow_unused=True)


def test_remat_replays_dropout_masks():
    l_on, g_on = losses_and_grads(True, 99)
    l_off, g_off = losses_and_grads(False, 99)
    l_none, _ = losses_and_grads(False, None)
    assert torch.equal(l_on, l_off)
    assert not torch.allclose(l_on, l_none)  # dropout really ran
    for a, b in zip(g_on, g_off):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_dropout_changes_with_the_step_seed():
    l1, _ = losses_and_grads(False, 1)
    l2, _ = losses_and_grads(False, 2)
    assert not torch.equal(l1, l2)


# ---------------------------------------------------------------------------
# guards: no kernel wrapper runs inside a differentiated computation
# ---------------------------------------------------------------------------

def rg(*shape):
    return torch.randn(*shape, requires_grad=True)


def wrapper_calls():
    """(name, call) for every kernel wrapper, each given a first input that
    requires grad and otherwise valid CPU inputs."""
    d, heads, bsz, seq, kv, bk, t = 128, 2, 2, 64, 8, 4, 6
    z = torch.zeros
    ln = torch.stack([torch.ones(1, d), z(1, d)], 1)
    stack = encoder_stack.EncStackParams(
        z(1, d, 3 * d), z(1, 3 * d), z(1, d, d), z(1, d), ln, z(1, d, d), z(1, d), z(1, d, d),
        z(1, d), ln, z(1, d, 256), z(1, 256), z(1, 256, d), z(1, d), ln)
    return [
        ("gemm", lambda x: K.gemm(x, torch.randn(d, 64))),
        ("layernorm", lambda x: K.layernorm(x, torch.stack([torch.ones(d), z(d)]),
                                            torch.float32)),
        ("enc_self_attention", lambda x: K.enc_self_attention(
            x.repeat(1, 3), z(bsz, seq // bsz), bsz, seq // bsz, heads)),
        ("enc_cross_attention", lambda x: K.enc_cross_attention(
            x, torch.randn(bsz, d, kv), torch.randn(bsz, kv, d), bsz, seq // bsz, heads)),
        ("dec_self_attention", lambda x: K.dec_self_attention(
            x[:bk].repeat(1, 3), z(t, bk, d), z(t, bk, d),
            torch.zeros(t, bk, dtype=torch.int32), 3, heads)),
        ("dec_cross_attention", lambda x: K.dec_cross_attention(
            x[:bk], torch.randn(2, heads, d // heads, kv), torch.randn(2, heads, d // heads, kv),
            None, None, z(2, kv), heads)),
        ("flash_attention", lambda x: flash_attn.flash_attention(
            x.reshape(1, 1, seq, d), torch.randn(1, 1, seq, d), torch.randn(1, 1, seq, d),
            z(1, 1, seq, seq))),
        ("lm_head", lambda x: lm_head.lm_head(x, torch.randn(256, d), z(256))),
        ("lm_stats", lambda x: lm_stats.lm_stats(x, torch.randn(1024, d), z(1024))),
        ("encoder_text_stack", lambda x: encoder_stack.encoder_text_stack(
            stack, x.reshape(bsz, seq // bsz, d), torch.randn(1, bsz, d, kv),
            torch.randn(1, bsz, kv, d), z(bsz, seq // bsz), z(bsz, kv),
            BartConfig(d_model=d, encoder_attention_heads=heads))),
        ("decode_stack", lambda x: decode_layer.decode_stack(
            (x,), x[:bk], 0, z(1, t, bk, d), z(1, t, bk, d),
            torch.zeros(t, bk, dtype=torch.int32), z(1, 2, heads, 64, kv),
            z(1, 2, heads, 64, kv), z(2, kv), heads)),
    ]


@pytest.mark.parametrize("name", [n for n, _ in wrapper_calls()])
def test_kernel_wrappers_refuse_grad(name):
    call = dict(wrapper_calls())[name]
    x = rg(64, 128)
    with pytest.raises(RuntimeError, match="no backward"):
        call(x)
    if name == "decode_stack":  # given no real stacked weights: the refusal only
        return
    with torch.no_grad():
        call(x)  # the same call runs outside autograd
    call(x.detach())  # and on an input that does not require grad


def test_attention_core_routes_around_flash_under_grad(monkeypatch):
    calls = []
    real = L.flash_attention

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(L, "flash_attention", spy)
    q, k, v = rg(1, 2, 256, 64), rg(1, 2, 256, 64), rg(1, 2, 256, 64)
    mask = torch.zeros(1, 1, 256, 256)
    mask[..., 200:] = torch.finfo(torch.float32).min
    assert L.flash_eligible(q, k, mask)
    out = L.attention_core(q, k, v, mask)
    assert not calls and out.requires_grad
    assert torch.equal(out, L.attention_plain(q, k, v, mask))
    assert all(g is not None for g in torch.autograd.grad(out.sum(), (q, k, v)))
    with torch.no_grad():
        flash = L.attention_core(q, k, v, mask)
    assert calls == [1]
    torch.testing.assert_close(flash, out.detach(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dropout_rng,remat,fused", [(None, False, True), (3, False, False),
                                                    (None, True, False)])
def test_mm_forward_takes_the_fused_encoder_only_without_dropout_or_remat(
        monkeypatch, dropout_rng, remat, fused):
    cfg = VacnicConfig.tiny()
    params = F.multimodal_bart_init(make_generator(0), cfg.bart, cfg.fusion)
    b = synthetic_batch(cfg, 2)
    taken = []
    real = F.mm_encoder_fwd_fused
    monkeypatch.setattr(F, "mm_encoder_fwd_fused", lambda *a, **k: taken.append(1) or real(
        *a, **k))
    with torch.no_grad():
        F.mm_forward(params, b["article_ids"], TT.create_mask(b["article_ids"]),
                     b["caption_ids"], b["image_cls"], cfg.bart, cfg.fusion,
                     face_features=b["face_emb"], face_mask=TT.face_mask_from_emb(b["face_emb"]),
                     name_ids=b["names_art_ids"], name_mask=TT.create_mask(b["names_art_ids"]),
                     dropout_rng=dropout_rng, remat=remat, device="cpu")
    assert bool(taken) == fused


def test_fused_encoder_refuses_a_differentiated_forward():
    cfg = VacnicConfig.tiny()
    params = F.multimodal_bart_init(make_generator(0), cfg.bart, cfg.fusion)
    for _, p in leaves_with_path(params):
        p.requires_grad_(True)
    b = synthetic_batch(cfg, 2)
    with pytest.raises(RuntimeError, match="no backward"):
        F.mm_forward(params, b["article_ids"], TT.create_mask(b["article_ids"]),
                     b["caption_ids"], b["image_cls"], cfg.bart, cfg.fusion,
                     face_features=b["face_emb"], face_mask=TT.face_mask_from_emb(b["face_emb"]),
                     name_ids=b["names_art_ids"], name_mask=TT.create_mask(b["names_art_ids"]),
                     device="cpu")


def test_tree_to_keeps_leaf_tensors():
    tree = {"a": torch.randn(3, requires_grad=True), "b": (torch.zeros(2, dtype=torch.int32),
                                                          {"c": torch.ones(1)}), "heads": 4}
    moved = tree_to(tree, "cpu")
    assert moved["a"] is tree["a"] and moved["b"][1]["c"] is tree["b"][1]["c"]
    assert moved["b"][0] is tree["b"][0] and moved["heads"] == 4
    assert isinstance(moved["b"], tuple)
    cast = tree_to(tree, "cpu", torch.bfloat16)
    assert cast["a"].dtype == torch.bfloat16 and cast["b"][0].dtype == torch.int32
    # a gradient through the moved tree reaches the caller's leaf
    (moved["a"] * 2).sum().backward()
    assert torch.equal(tree["a"].grad, torch.full((3,), 2.0))
    assert np.isfinite(cast["a"].float().detach().numpy()).all()
