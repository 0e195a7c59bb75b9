"""The decoder's cross K/V build (kernels/primitives.cross_kv and its plain
twin) on the CPU: the twin is the decode cache's earlier inline recipe, bit
for bit; the plan of cross_kv_gemm_kernel's row tiles and clusters; the
wrapper's refusals and which calls reach the kernel, on a faked card whose
launches are recorded instead of made."""

import pytest
import torch

from vacnic_tpu_torch.cli import _smoke_config
from vacnic_tpu_torch.core.config import VacnicConfig
from vacnic_tpu_torch.core.rng import make_generator
from vacnic_tpu_torch.infer import decode_fast as DF
from vacnic_tpu_torch.kernels import primitives as K
from vacnic_tpu_torch.models.fusion import multimodal_bart_init


def old_project(layers, enc_out, name, heads, dtype, int8):
    """The decode cache's cross K (name "k_proj") or V ("v_proj") as
    build_decode_cache computed them inline before cross_kv."""
    b, s, d = enc_out.shape
    outs, scales = [], []
    x = enc_out.to(dtype).float()
    for p in layers:
        y = x @ p["encoder_attn"][name]["kernel"].to(dtype).float() \
            + p["encoder_attn"][name]["bias"].float()
        y = y.to(dtype).reshape(b, s, heads, d // heads).permute(0, 2, 3, 1)
        if int8:
            yq, sc = K.quantize_cross_kv(y)
            outs.append(yq)
            scales.append(sc)
        else:
            outs.append(y.contiguous())
    return torch.stack(outs).contiguous(), torch.stack(scales).contiguous() if int8 else None


def layer_tree(n_layers, d, seed):
    g = torch.Generator().manual_seed(seed)

    def lin():
        return {"kernel": torch.randn(d, d, generator=g) * 0.05,
                "bias": torch.randn(d, generator=g) * 0.05}

    return [{"encoder_attn": {"k_proj": lin(), "v_proj": lin()}} for _ in range(n_layers)]


def stacked(layers, dtype):
    """(w [L, d, 2d] in dtype, b [L, 2d] f32) as build_decode_cache stacks them."""
    def kv(part):
        return torch.stack([torch.cat([p["encoder_attn"][n][part] for n in ("k_proj", "v_proj")],
                                      dim=-1) for p in layers])

    return kv("kernel").to(dtype).contiguous(), kv("bias").float().contiguous()


@pytest.mark.parametrize("s_len", [7, 16, 33])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("int8", [True, False])
def test_plain_is_the_old_recipe(int8, batch, s_len):
    """cross_kv_plain equals the earlier inline recipe bit for bit, in f32
    (the CPU tests' dtype) and in bf16 (the card's), at S that is no whole
    tile of anything."""
    d, heads = 64, 4
    layers = layer_tree(2, d, seed=batch * 100 + s_len)
    enc = torch.randn(batch, s_len, d, generator=torch.Generator().manual_seed(s_len))
    for dtype in (torch.float32, torch.bfloat16):
        w, b = stacked(layers, dtype)
        k, v, ks, vs = K.cross_kv_plain(enc.to(dtype), w, b, heads, int8)
        (ok_, oks), (ov, ovs) = (old_project(layers, enc, n, heads, dtype, int8)
                                 for n in ("k_proj", "v_proj"))
        assert k.shape == (2, batch, heads, d // heads, s_len)
        assert torch.equal(k, ok_) and torch.equal(v, ov)
        if int8:
            assert k.dtype == torch.int8 and torch.equal(ks, oks) and torch.equal(vs, ovs)
        else:
            assert ks is None and vs is None and k.dtype == dtype


def small_model(card_widths: bool = False):
    """VacnicConfig.tiny(), or with card_widths the `cli smoke` config (d 256,
    head_dim 64: widths the kernel takes), and its random tree."""
    cfg = _smoke_config() if card_widths else VacnicConfig.tiny()
    return cfg, multimodal_bart_init(make_generator(0), cfg.bart, cfg.fusion)


@pytest.mark.parametrize("time_major", [True, False])
@pytest.mark.parametrize("int8", [True, False])
def test_decode_cache_keeps_the_recipe_on_the_cpu(int8, time_major):
    """build_decode_cache on CPU tensors, on either path, holds the earlier
    recipe's cross K/V bit for bit."""
    cfg, params = small_model()
    layers = params["decoder"]["layers"]
    enc = torch.randn(2, 9, cfg.bart.d_model, generator=torch.Generator().manual_seed(3))
    c = DF.build_decode_cache(params, enc, 2, 8, cfg.bart, torch.float32, pad_to=16,
                              time_major=time_major, cross_kv_int8=int8)
    heads = cfg.bart.decoder_attention_heads
    for got, got_s, name in ((c.cross_k, c.cross_k_scale, "k_proj"),
                             (c.cross_v, c.cross_v_scale, "v_proj")):
        want, want_s = old_project(layers, enc, name, heads, torch.float32, int8)
        assert torch.equal(got, want)
        assert (got_s is None and want_s is None) or torch.equal(got_s, want_s)


@pytest.mark.parametrize("batch,s_len,d,tiles", [
    (256, 512, 1024, 2), (1, 512, 1024, 2), (32, 512, 1024, 2),  # the cells, the service's buckets
    (3, 7, 256, 1), (2, 256, 768, 1), (2, 257, 768, 2), (1, 1024, 768, 4), (5, 1000, 64, 4)])
def test_cross_kv_plan(batch, s_len, d, tiles):
    """Row tiles of 256 positions an item, never shared by two items; the
    cluster is the column pair x the item's row tiles."""
    plan = K.cross_kv_plan(batch, s_len, d)
    assert plan == K.CrossKvPlan(tiles, 2 * tiles)
    assert plan.cluster <= 8  # the portable cluster's largest
    assert (plan.tiles - 1) * K.CROSS_KV_BM < s_len <= plan.tiles * K.CROSS_KV_BM


@pytest.mark.parametrize("batch,s_len,d", [(1, 16385, 1024), (1, 0, 1024), (0, 512, 1024),
                                           (2, 512, 96), (2, 512, 32), (65536, 1, 64),
                                           (32768, 257, 64)])
def test_cross_kv_plan_refuses(batch, s_len, d):
    """Past LED's 16384 positions (the long plan's last), no positions or
    items, d not a multiple of 64, a grid of more than 65535 block rows."""
    with pytest.raises(ValueError):
        K.cross_kv_plan(batch, s_len, d)


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors taken for the card's: the wrapper's own checks run as on
    a card, and each launch is recorded instead of made."""
    launches = []
    monkeypatch.setattr(K, "_on_cpu", lambda t: False)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(K, "_launch", lambda name, fn, device, *args, **kw:
                        launches.append((name, fn, args)))
    return launches


def card_inputs(batch=2, s_len=40, d=256, layers=3):
    bf = torch.bfloat16
    return (torch.zeros(batch, s_len, d, dtype=bf), torch.zeros(layers, d, 2 * d, dtype=bf),
            torch.zeros(layers, 2 * d))


def test_wrapper_refuses(fake_card):
    x, w, b = card_inputs()
    bad = [lambda: K.cross_kv(x.float(), w, b, 4, True),                   # x not bf16
           lambda: K.cross_kv(x, w.float(), b, 4, True),                   # w not bf16
           lambda: K.cross_kv(x, w[:, :, :256].contiguous(), b, 4, True),  # w not [d, 2d]
           lambda: K.cross_kv(x, w, b[:2], 4, True),                       # b of two layers
           lambda: K.cross_kv(x, w, b.to(torch.bfloat16), 4, True),        # b not f32
           lambda: K.cross_kv(x.transpose(0, 1), w, b, 4, True),           # not contiguous
           lambda: K.cross_kv(x[0], w, b, 4, True),                        # not [B, S, d]
           lambda: K.cross_kv(x, w, b, 3, True),                           # 3 heads of 256
           lambda: K.cross_kv(*card_inputs(s_len=16385), 4, True),         # past 16384 positions
           lambda: K.cross_kv(*card_inputs(d=96, layers=1), 1, True),      # d % 64
           lambda: K.cross_kv(torch.zeros(2 * 40 * 256 + 1, dtype=torch.bfloat16)[1:]
                              .view(2, 40, 256), w, b, 4, True)]           # off 16 bytes
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert fake_card == []
    with pytest.raises(RuntimeError):  # under grad mode: the kernel has no backward
        K.cross_kv(x, w.clone().requires_grad_(), b, 4, True)


@pytest.mark.parametrize("int8", [True, False])
def test_wrapper_launches_once_a_layer(fake_card, int8):
    x, w, b = card_inputs(batch=3, s_len=300, layers=3)
    k, v, ks, vs = K.cross_kv(x, w, b, 4, int8)
    assert k.shape == v.shape == (3, 3, 4, 64, 300)
    assert k.dtype == (torch.int8 if int8 else torch.bfloat16)
    assert (ks is None) == (vs is None) == (not int8)
    assert [(n, fn) for n, fn, _ in fake_card] == [("cross_kv", "vt_cross_kv")] * 3
    for layer, (_, _, args) in enumerate(fake_card):  # each layer's slices, the plan's tiles
        ptrs = [a.value for a in args[:7]]
        assert ptrs[1] == w[layer].data_ptr() and ptrs[3] == k[layer].data_ptr()
        assert ptrs[4] == v[layer].data_ptr()
        assert (ptrs[5] is None) == (not int8)
        assert args[7:] == (3, 300, 256, 2, int(int8))


@pytest.mark.parametrize("int8", [True, False])
def test_wrapper_long_launches(fake_card, int8):
    """Past 1024 positions: the product once a layer in clusters of the
    column pair (vt_cross_kv_long, bf16), with int8 into a bf16 copy that
    cross_kv_quant_kernel then quantizes into the layer's slices."""
    x, w, b = card_inputs(batch=2, s_len=1280, layers=2)
    k, v, ks, vs = K.cross_kv(x, w, b, 4, int8)
    assert k.shape == (2, 2, 4, 64, 1280) and (ks is None) == (not int8)
    want = ([("cross_kv", "vt_cross_kv_long"), ("cross_kv_quant", "vt_cross_kv_quant")] if int8
            else [("cross_kv", "vt_cross_kv_long")]) * 2
    assert [(n, fn) for n, fn, _ in fake_card] == want
    for layer in range(2):
        prod = fake_card[layer * len(want) // 2][2]
        assert prod[5:] == (2, 1280, 256, 5)
        assert prod[1].value == w[layer].data_ptr()
        if int8:
            quant = fake_card[layer * 2 + 1][2]
            assert [a.value for a in quant[:2]] == [a.value for a in prod[3:5]]
            assert quant[2].value == k[layer].data_ptr() and quant[5].value == vs[layer].data_ptr()
            assert quant[6:] == (2 * 256, 1280)
        else:
            assert prod[3].value == k[layer].data_ptr() and prod[4].value == v[layer].data_ptr()


@pytest.mark.parametrize("int8", [True, False])
def test_path_split(monkeypatch, fake_card, int8):
    """The kernel path (time_major=True) reaches the kernel once a decoder
    layer on a card; the reference path (time_major=False) never does, and
    neither path does on CPU tensors."""
    cfg, params = small_model(card_widths=True)
    enc = torch.randn(2, 9, cfg.bart.d_model)
    n_layers = len(params["decoder"]["layers"])
    DF.build_decode_cache(params, enc, 2, 8, cfg.bart, torch.bfloat16, pad_to=16,
                          time_major=True, cross_kv_int8=int8)
    assert [n for n, _, _ in fake_card] == ["cross_kv"] * n_layers
    fake_card.clear()
    c = DF.build_decode_cache(params, enc, 2, 8, cfg.bart, torch.bfloat16, pad_to=16,
                              cross_kv_int8=int8)
    assert fake_card == [] and (c.cross_k_scale is not None) == int8
    monkeypatch.setattr(K, "_on_cpu", lambda t: True)
    for time_major in (True, False):
        DF.build_decode_cache(params, enc, 2, 8, cfg.bart, torch.bfloat16, pad_to=16,
                              time_major=time_major, cross_kv_int8=int8)
    assert fake_card == []
