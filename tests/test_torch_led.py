"""VACNIC on LED (VacnicConfig.led_full) on the CPU, at tiny widths:

* the tests' plain reference of LED's self-attention (tests/led_reference.py)
  equals transformers' LEDEncoderAttention with the same weights, and the
  benchmark's copy (portbench/reference/led.py) equals it too;
* the port's window arithmetic (kernels/primitives.window_attention_plain),
  on the layer-by-layer path and through the fused stack's plain ops (the
  band, then the global rows by gemm, cross_kv and dec_cross_attention),
  equals the reference;
* mm_encoder_fwd and the fused encoder equal the reference encoder, and
  generate_mm's beam scores equal the reference's teacher-forced
  log-probabilities of the same tokens;
* cross_kv_plan and dec_cross_plan give their new variants only past the
  old limits, the old plans at S 512 unchanged; the split dec_cross's order
  of work equals the unsplit twin to f32 rounding;
* the span "encoder.window_attention" opens once a layer on both paths;
* an LEDForConditionalGeneration state dict converts to the port's tree and
  its text encoder matches transformers'."""

import dataclasses
import json

import pytest
import torch

transformers = pytest.importorskip("transformers")
from transformers import LEDConfig, LEDForConditionalGeneration  # noqa: E402
from transformers.models.led import modeling_led as HF  # noqa: E402

from led_reference import LedReference, led_attention, sizes_of  # noqa: E402
from portbench.reference.led import LedModel  # noqa: E402
from portbench.reference.model import caption_sums, scored_positions  # noqa: E402
from vacnic_tpu_torch.core import profiling  # noqa: E402
from vacnic_tpu_torch.core.config import (  # noqa: E402
    BartConfig, ClipVisionConfig, DataConfig, DecodeConfig, FusionConfig, VacnicConfig)
from vacnic_tpu_torch.core.rng import make_generator  # noqa: E402
from vacnic_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from vacnic_tpu_torch.infer.generate import generate_mm  # noqa: E402
from vacnic_tpu_torch.kernels import encoder_stack as ES  # noqa: E402
from vacnic_tpu_torch.kernels import primitives as K  # noqa: E402
from vacnic_tpu_torch.models import bart as B  # noqa: E402
from vacnic_tpu_torch.models.fusion import (  # noqa: E402
    mm_encoder_fwd, mm_encoder_fwd_fused, multimodal_bart_init)
from vacnic_tpu_torch.models.weights_io import convert_bart  # noqa: E402
from vacnic_tpu_torch.train.train_step import create_mask, face_mask_from_emb  # noqa: E402


def tiny_led(window: int = 8, s_len: int = 32) -> VacnicConfig:
    """led_full() at the tiny widths of VacnicConfig.tiny()."""
    full = VacnicConfig.led_full()
    bart = BartConfig.tiny(attention_window=window, max_encoder_position_embeddings=64,
                           max_position_embeddings=32, position_offset=full.bart.position_offset)
    return VacnicConfig(bart=bart, clip=ClipVisionConfig.tiny(), fusion=FusionConfig.tiny(),
                        data=DataConfig(article_max_length=s_len, caption_max_length=10),
                        decode=DecodeConfig(num_beams=3, max_length=8))


def test_led_full_preset():
    """led_full is full_train with LED's fields; BART's presets keep the defaults."""
    led, full = VacnicConfig.led_full(), VacnicConfig.full_train()
    assert (led.bart.attention_window, led.bart.max_encoder_position_embeddings,
            led.bart.position_offset, led.bart.global_tokens) == (1024, 16384, 0, 1)
    assert led.data.article_max_length == 16384
    assert led.bart.encoder_positions == 16384 and led.bart.decoder_positions == 1024
    assert full.bart.encoder_positions == full.bart.decoder_positions == 1026
    same = dataclasses.replace(led, bart=full.bart, data=full.data)
    assert same == full
    assert VacnicConfig.from_json(led.to_json()) == led


def hf_attention(d, heads, w, seed):
    cfg = LEDConfig(d_model=d, encoder_attention_heads=heads, attention_window=[2 * w],
                    encoder_layers=1, decoder_layers=1, vocab_size=64,
                    max_encoder_position_embeddings=256, max_decoder_position_embeddings=64,
                    encoder_ffn_dim=64, decoder_ffn_dim=64, attention_dropout=0.0)
    torch.manual_seed(seed)
    m = HF.LEDEncoderAttention(cfg, layer_id=0).eval()
    with torch.no_grad():
        for prm in m.parameters():
            prm.normal_(0.0, 0.2)
    lf = m.longformer_self_attn

    def lin(mod):
        return {"kernel": mod.weight.detach().T.contiguous(), "bias": mod.bias.detach().clone()}

    p = {"q_proj": lin(lf.query), "k_proj": lin(lf.key), "v_proj": lin(lf.value),
         "out_proj": lin(m.output)}
    pg = {"q_proj": lin(lf.query_global), "k_proj": lin(lf.key_global),
          "v_proj": lin(lf.value_global)}
    return m, p, pg


def run_hf(m, x, keep, g):
    glob = torch.zeros_like(keep)
    glob[:, :g] = 1
    merged = keep * (1 + glob)
    mask = HF._prepare_4d_attention_mask_inverted(merged, torch.float32)[:, 0, 0, :]
    with torch.no_grad():
        return m(hidden_states=x, attention_mask=mask, is_index_masked=mask < 0,
                 is_index_global_attn=mask > 0, is_global_attn=bool((mask > 0).any()))[0]


def attention_case(w, g, seed=0):
    d, heads, b = 32, 4, 3
    s_len = 4 * 2 * w  # four windows
    m, p, pg = hf_attention(d, heads, w, seed)
    x = torch.randn(b, s_len, d, generator=torch.Generator().manual_seed(seed + 1))
    keep = torch.ones(b, s_len, dtype=torch.long)
    keep[1, s_len - w - 3:] = 0       # a padded tail inside the last window
    keep[2, s_len // 2 + 1:] = 0      # half the item padded
    return m, p, pg, x, keep, heads


@pytest.mark.parametrize("w,g", [(4, 1), (4, 2), (8, 1), (8, 2), (4, 9)])
def test_reference_attention_equals_transformers(w, g):
    m, p, pg, x, keep, heads = attention_case(w, g)
    want = run_hf(m, x, keep, g)
    got = led_attention(x, keep, p, pg, heads, w, g)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5), (got - want).abs().max()
    bench = LedModel({"encoder_attention_heads": heads, "attention_window": 2 * w,
                      "global_tokens": g}).self_attention(p, pg, x, keep)
    assert torch.allclose(bench, want, atol=2e-5, rtol=1e-5), (bench - want).abs().max()


@pytest.mark.parametrize("w", [4, 8, 16])
def test_port_window_equals_reference(w):
    """The layer-by-layer path (bart.led_self_attention) and the fused
    stack's plain ops (enc_window_attention's twin, then the global rows by
    gemm, cross_kv and dec_cross_attention) against the reference, with
    global attention on <s>."""
    g = 1
    _, p, pg, x, keep, heads = attention_case(w, g, seed=5)
    cfg = BartConfig.tiny(d_model=32, encoder_attention_heads=heads, attention_window=2 * w,
                          position_offset=0)
    assert cfg.global_tokens == g
    want = led_attention(x, keep, p, pg, heads, w, g)
    got = B.led_self_attention(p, pg, x, keep, cfg)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5), (got - want).abs().max()

    bsz, s_len, d = x.shape
    ident = {"kernel": torch.eye(d), "bias": torch.zeros(d)}
    want_o = led_attention(x, keep, {**p, "out_proj": ident}, pg, heads, w, g)
    sp = ES.EncStackParams(
        *([None] * 15),
        w_qg=pg["q_proj"]["kernel"][None], b_qg=pg["q_proj"]["bias"][None],
        w_kvg=torch.cat([pg["k_proj"]["kernel"], pg["v_proj"]["kernel"]], -1)[None],
        b_kvg=torch.cat([pg["k_proj"]["bias"], pg["v_proj"]["bias"]])[None])
    xb = x.reshape(bsz * s_len, d)
    qkv = torch.cat([xb @ p[n]["kernel"] + p[n]["bias"] for n in ("q_proj", "k_proj", "v_proj")],
                    -1)
    bias = (1.0 - keep.float()) * torch.finfo(torch.float32).min
    o = ES._window_attention(sp, 0, qkv, xb, bias, bsz, s_len, cfg, ES.PLAIN_OPS)
    assert torch.allclose(o.reshape(bsz, s_len, d), want_o, atol=2e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def led_model():
    cfg = tiny_led()
    params = multimodal_bart_init(make_generator(0), cfg.bart, cfg.fusion)
    b = synthetic_batch(cfg, 3, seed=11)
    t = {k: torch.as_tensor(v) for k, v in b.items()}
    x = dict(input_ids=t["article_ids"], attention_mask=create_mask(t["article_ids"]),
             image_features=t["image_cls"], face_features=t["face_emb"],
             face_mask=face_mask_from_emb(t["face_emb"]), name_ids=t["names_art_ids"],
             name_mask=create_mask(t["names_art_ids"]))
    return cfg, params, x


def test_encoders_equal_reference(led_model):
    cfg, params, x = led_model
    assert (x["attention_mask"] == 0).any()  # ragged tails
    ref = LedReference(sizes_of(cfg))
    want = ref.encode(params, x)["last_hidden"]
    kw = {k: v for k, v in x.items() if k not in ("input_ids", "attention_mask", "image_features")}
    with torch.no_grad():
        for fwd in (mm_encoder_fwd, mm_encoder_fwd_fused):
            got = fwd(params, x["input_ids"], x["attention_mask"], x["image_features"], cfg.bart,
                      cfg.fusion, **kw)["last_hidden"]
            assert torch.allclose(got, want, atol=1e-4, rtol=1e-4), (fwd.__name__,
                                                                     (got - want).abs().max())


def test_generate_scores_equal_reference(led_model):
    cfg, params, x = led_model
    seqs, scores = generate_mm(params, cfg=cfg.bart, fcfg=cfg.fusion, dcfg=cfg.decode,
                               device="cpu", **x)
    sizes = sizes_of(cfg)
    _, length = scored_positions(seqs, sizes)
    with torch.no_grad():
        want = caption_sums(LedReference(sizes), params, x, seqs)
    got = scores.float() * length ** sizes["length_penalty"]
    assert torch.allclose(got, want, atol=1e-3, rtol=1e-4), (got - want).abs().max()


@pytest.mark.parametrize("s_len,variant", [(512, "cluster"), (1024, "cluster"), (1025, "long"),
                                           (8192, "long"), (16384, "long")])
def test_cross_kv_plan_long(s_len, variant):
    plan = K.cross_kv_plan(32, s_len, 1024)
    assert plan.variant == variant and plan.tiles == -(-s_len // K.CROSS_KV_BM)
    assert plan.cluster == (2 * plan.tiles if variant == "cluster" else 2)


@pytest.mark.parametrize("beams,s_len,elem", [(5, 512, 1), (5, 1024, 1), (1, 512, 2),
                                              (5, 5000, 1), (1, 16384, 2), (5, 16384, 1),
                                              (8, 9000, 1), (5, 16384, 2)])
def test_dec_cross_split_only_past_the_unsplit(beams, s_len, elem):
    """The split plan only where the beams block does not fit; at S 512
    the plan is the one before splits existed; a split's every rank holds
    positions and its block fits."""
    plan = K.dec_cross_plan(beams, s_len, elem)
    unsplit = K.dec_cross_variant_plan("beams", beams, s_len, elem)
    if unsplit.smem <= K.SMEM_MAX:
        assert plan == unsplit
    else:
        assert plan.variant == "split" and plan.groups in K.DEC_CROSS_SPLITS
        assert plan.smem <= K.SMEM_MAX
        assert (plan.groups - 1) * K.dec_cross_split_positions(s_len, plan.groups) < s_len
    if s_len == 512:
        assert plan == K.DecCrossPlan("beams", 1, beams, beams,
                                      K.dec_cross_smem_bytes(beams, 512, elem))
    if (beams, s_len, elem) == (5, 16384, 1):  # LED's cell: 8 ranks of 2048, two blocks an SM
        assert plan.groups == 8 and 2 * (plan.smem + 1024) <= K.SMEM_SM


def split_emulated(q, ck, cv, ck_scale, cv_scale, bias, heads, split):
    """dec_cross_kernel_split's order of work in f32: each rank's scores over
    its positions, the row max over the ranks, each rank's sum of exp, the
    sum in rank order, each rank's P V, the partials in rank order."""
    bk, d = q.shape
    b, _, hd, s_len = ck.shape
    beams = bk // b
    qh = (q.float() * hd ** -0.5).reshape(b, beams, heads, hd)
    if ck_scale is not None:
        qh = qh * ck_scale.float()[:, None]
    per = K.dec_cross_split_positions(s_len, split)
    ranges = [(r * per, min(s_len, (r + 1) * per)) for r in range(split)]
    sc = [torch.einsum("bkhd,bhds->bkhs", qh, ck[..., a:e].float()) + bias[:, None, None, a:e]
          for a, e in ranges]
    m = torch.stack([s.amax(-1) for s in sc]).amax(0)
    total = sum(torch.exp(s - m[..., None]).sum(-1) for s in sc)
    o = sum(torch.einsum("bkhs,bhds->bkhd", torch.exp(s - m[..., None]) / total[..., None],
                         cv[..., a:e].float()) for s, (a, e) in zip(sc, ranges))
    if cv_scale is not None:
        o = o * cv_scale.float()[:, None]
    return o.reshape(bk, d)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("split", [2, 4, 8])
def test_split_dec_cross_order_equals_twin(split, int8):
    g = torch.Generator().manual_seed(split)
    b, beams, heads, hd, s_len = 2, 5, 2, 64, 1000
    q = torch.randn(b * beams, heads * hd, generator=g)
    if int8:
        ck = torch.randint(-127, 128, (b, heads, hd, s_len), generator=g).to(torch.int8)
        cv = torch.randint(-127, 128, (b, heads, hd, s_len), generator=g).to(torch.int8)
        ks, vs = torch.rand(b, heads, hd, generator=g) * 0.02, torch.rand(b, heads, hd, generator=g) * 0.02
    else:
        ck, cv = (torch.randn(b, heads, hd, s_len, generator=g) for _ in range(2))
        ks = vs = None
    bias = torch.zeros(b, s_len)
    bias[1, 700:] = torch.finfo(torch.float32).min
    want = K.dec_cross_attention_plain(q, ck, cv, ks, vs, bias, heads)
    got = split_emulated(q, ck, cv, ks, vs, bias, heads, split)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5), (got - want).abs().max()


def test_window_span_opens_once_a_layer(led_model, tmp_path):
    cfg, params, x = led_model
    kw = {k: v for k, v in x.items() if k not in ("input_ids", "attention_mask", "image_features")}
    for fwd in (mm_encoder_fwd, mm_encoder_fwd_fused):
        out = tmp_path / fwd.__name__
        with torch.no_grad(), profiling.trace(str(out)):
            fwd(params, x["input_ids"], x["attention_mask"], x["image_features"], cfg.bart,
                cfg.fusion, **kw)
        with open(out / profiling.TRACE_FILE) as f:
            names = [e.get("name") for e in json.load(f)["traceEvents"]]
        assert names.count("encoder.window_attention") == cfg.bart.encoder_layers, fwd.__name__


def test_led_checkpoint_names_convert():
    """A tiny LEDForConditionalGeneration's state dict -> the port's tree;
    the port's text encoder equals transformers' LED encoder with global
    attention on <s>."""
    hf_cfg = LEDConfig(vocab_size=64, d_model=32, encoder_layers=2, decoder_layers=2,
                       encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
                       decoder_ffn_dim=64, max_encoder_position_embeddings=64,
                       max_decoder_position_embeddings=32, attention_window=[8, 8],
                       dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
    torch.manual_seed(3)
    model = LEDForConditionalGeneration(hf_cfg).eval()
    cfg = BartConfig.tiny(vocab_size=64, d_model=32, encoder_ffn_dim=64, decoder_ffn_dim=64,
                          max_position_embeddings=32, max_encoder_position_embeddings=64,
                          attention_window=8, position_offset=0)
    params = convert_bart(model.state_dict(), cfg)
    layer = params["encoder"]["layers"][0]
    assert set(layer["self_attn"]) == {"q_proj", "k_proj", "v_proj", "out_proj"}
    assert set(layer["self_attn_global"]) == {"q_proj", "k_proj", "v_proj"}
    assert params["encoder"]["embed_positions"]["weight"].shape == (64, 32)
    ids = torch.randint(3, 64, (2, 32), generator=torch.Generator().manual_seed(4))
    ids[:, 0] = 0
    mask = torch.ones_like(ids)
    mask[1, 20:] = 0
    glob = torch.zeros_like(ids)
    glob[:, 0] = 1
    with torch.no_grad():
        want = model.led.encoder(input_ids=ids, attention_mask=mask,
                                 global_attention_mask=glob).last_hidden_state
        got = B.encoder_fwd(params, ids, mask, cfg)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4), (got - want).abs().max()
