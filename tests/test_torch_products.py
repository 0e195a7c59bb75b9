"""models/products.product, the model path's one library product, on the
CPU.

The bf16 tensor-core product (`torch.mm` / `torch.bmm` with
`out_dtype=torch.float32`) exists only on the card. Here the helper's
autograd Function runs with an emulating product instead: the bf16
operands upcast and multiplied in float32, which is what the float32
recipe computes. So where the Function's backward rounds a cotangent to
bf16, its gradients equal the recipe's bit for bit only if that cotangent
was a bf16 value already; these tests hold every site to that, forward and
every gradient, with and without remat, and the whole differentiated
training step too. The recipe is the helper's CPU path, autograd's own
backward of `torch.matmul(a.float(), b.float())`, which the last tests
hold to the expressions the sites wrote before the helper.

The `cuda`-marked tests at the end run the bf16 product on the card
against the float32 recipe:

    python -m pytest --noconftest -m cuda tests/test_torch_products.py -q
"""

import dataclasses
import math
import runpy
from pathlib import Path

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from vacnic_tpu_torch.core.config import VacnicConfig
from vacnic_tpu_torch.core.tensor_parallel import ModelShard
from vacnic_tpu_torch.core.tree import leaves_with_path
from vacnic_tpu_torch.models import bart as B
from vacnic_tpu_torch.models import clip_text as CT
from vacnic_tpu_torch.models import clip_vit as CV
from vacnic_tpu_torch.models import fusion as F
from vacnic_tpu_torch.models import layers as L
from vacnic_tpu_torch.models import products as P

BF16 = torch.bfloat16


def emulated_mm(x, y):
    """The card's bf16 product with float32 sums, as the float32 recipe
    computes it: the bf16 values upcast, one float32 matmul."""
    return torch.matmul(x.float(), y.float())


def _emulate(monkeypatch) -> list:
    """From here on, the helper's bf16 Function for two bf16 operands on
    the CPU; returns the list of the cotangent kinds it is applied with."""
    monkeypatch.setattr(P, "_bf16_mm", lambda a, b: emulated_mm
                        if a.dtype == BF16 and b.dtype == BF16 else None)
    calls = []
    apply = P._Bf16Product.apply
    monkeypatch.setattr(P._Bf16Product, "apply", lambda *a: calls.append(a[2]) or apply(*a))
    return calls


@pytest.fixture
def emulate(monkeypatch):
    return _emulate(monkeypatch)


def rn(g, *shape, std=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=g) * std).to(dtype).requires_grad_(True)


def _linear_inputs(g):
    return rn(g, 32, 48, std=0.2), rn(g, 48, std=0.1), rn(g, 3, 5, 32, dtype=BF16)


def _site_linear(g):
    return (lambda k, b, x: L.linear({"kernel": k, "bias": b}, x)), _linear_inputs(g)


def _site_row_linear(g):
    shard = ModelShard(0, 1, None)  # the tp path, its collective skipped
    return (lambda k, b, x: L.row_linear({"kernel": k, "bias": b}, x, shard)), _linear_inputs(g)


def _site_attention(g):
    q, k, v = (rn(g, 2, 4, t, 16, std=0.5, dtype=BF16) for t in (7, 9, 9))
    mask = L.expand_mask(torch.tensor([[1] * 9, [1] * 6 + [0] * 3]), 7)
    return (lambda q, k, v: L.attention_plain(q, k, v, mask)), (q, k, v)


def _site_linear_batched(g):
    t, kern, bias = rn(g, 3, 2, 5, 32, dtype=BF16), rn(g, 3, 32, 24, std=0.2), rn(g, 3, 24)
    return F.linear_batched, (t, kern, bias)


def _site_lm_logits(g):
    h = rn(g, 2, 6, 32, dtype=BF16)
    w, fb = rn(g, 50, 32, std=0.2), rn(g, 50, std=0.1)
    return (lambda h, w, fb: B.lm_logits({"shared": {"weight": w}, "final_logits_bias": fb},
                                         h)), (h, w, fb)


def _site_patch_embed(g):
    kern, x = rn(g, 4, 4, 3, 16, std=0.2), rn(g, 2, 9, 9, 3, dtype=BF16)
    return (lambda kern, x: CV.patch_embed(kern, x, 4)), (kern, x)


def _site_clip_text(g):
    tower = CT.clip_text_init(g, vocab_size=40, context_length=8, width=32, layers=2, heads=4,
                              output_dim=16)
    tower.pop("heads")
    leaves = [p for _, p in leaves_with_path(tower)]
    for p in leaves:
        p.requires_grad_(True)
    ids = torch.randint(1, 39, (3, 8), generator=g)

    def fwd(*ps):
        return CT.clip_text_fwd(tower, ids, BF16, num_heads=4)

    return fwd, tuple(leaves)


SITES = {
    "linear": _site_linear,
    "row_linear": _site_row_linear,
    "attention_scores_pv": _site_attention,
    "linear_batched": _site_linear_batched,
    "lm_logits": _site_lm_logits,
    "clip_vit_patch_embed": _site_patch_embed,
    "clip_text_projection": _site_clip_text,
}


def _forward_and_grads(fn, inputs, remat: bool):
    """fn's output and the gradient of every input under a loss with a true
    float32 cotangent (log_softmax over the last axis of the upcast
    output, weighted), through torch.utils.checkpoint under remat."""
    out = checkpoint(fn, *inputs, use_reentrant=False) if remat else fn(*inputs)
    logp = torch.log_softmax(out.float(), dim=-1)
    weights = torch.linspace(-1.0, 2.0, logp.numel()).reshape(logp.shape)
    grads = torch.autograd.grad((logp * weights).sum(), inputs, allow_unused=True)
    return out.detach(), grads


def _run_site(name: str, remat: bool):
    fn, inputs = SITES[name](torch.Generator().manual_seed(7))
    return _forward_and_grads(fn, inputs, remat)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("site", list(SITES))
def test_bf16_function_equals_the_f32_recipe_bitwise(site, remat, monkeypatch):
    want_out, want = _run_site(site, remat)
    calls = _emulate(monkeypatch)
    got_out, got = _run_site(site, remat)
    assert calls, "the site never reached the bf16 Function"
    assert got_out.dtype == want_out.dtype and torch.equal(got_out, want_out)
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a is None) == (b is None), i
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), (i, float((a - b).abs().max()))


@pytest.mark.parametrize("site,kinds", [("attention_scores_pv", ["f32", "bf16"]),
                                        ("lm_logits", ["f32"]), ("linear", ["bf16"])])
def test_sites_name_their_cotangent(site, kinds, emulate):
    """The scores and the LM head keep a float32 backward; the products
    whose output is rounded to bf16 take the bf16 one."""
    _run_site(site, False)
    assert emulate == kinds


def test_f32_cotangent_keeps_the_f32_backward_product(emulate):
    """The LM head's cotangent (d loss / d logits through log_softmax) is no
    bf16 value: rounding it, as the "bf16" backward would, changes the
    gradients, while the "f32" backward gives the recipe's bits."""
    g = torch.Generator().manual_seed(3)
    h, w = rn(g, 12, 32, dtype=BF16), rn(g, 64, 32, std=0.3, dtype=BF16)

    def grads(fn):
        logits = fn(h, w.t())
        loss = -torch.log_softmax(logits, dim=-1)[:, 5].sum()
        return torch.autograd.grad(loss, (h, w))

    want = grads(lambda a, b: torch.matmul(a.float(), b.float()))
    f32 = grads(lambda a, b: P._Bf16Product.apply(a, b, "f32", emulated_mm))
    rounded = grads(lambda a, b: P._Bf16Product.apply(a, b, "bf16", emulated_mm))
    assert all(torch.equal(a, b) for a, b in zip(f32, want))
    assert not any(torch.equal(a, b) for a, b in zip(rounded, want))


def test_spans_forward_and_backward(emulate):
    """Under a profiler the Function opens "product.bf16" around each bf16
    product and "product.f32" around each float32 one, in the backward too:
    the attention's two forward products (bf16), the scores' two backward
    products (f32) and P·V's two (bf16)."""
    from torch.profiler import ProfilerActivity, profile

    fn, inputs = _site_attention(torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*inputs)
        torch.autograd.grad(out.float().square().sum(), inputs)
    names = [e.name for e in prof.events()]
    assert names.count("product.bf16") == 4 and names.count("product.f32") == 2


def test_whole_training_step_bitwise_under_remat(monkeypatch):
    """loss_and_grads of the tiny config in bf16 over float32 trees, remat,
    dropout, SECLA, the teacher and the CLIP loss on pixels: every gradient
    leaf and every metric the same bits through the bf16 Function as
    through the float32 recipe."""
    from vacnic_tpu_torch.data.synthetic import synthetic_batch
    from vacnic_tpu_torch.train import train_step as TT

    c = VacnicConfig.tiny()
    cfg = dataclasses.replace(c, train=dataclasses.replace(
        c.train, compute_dtype="bfloat16", grad_checkpoint=True, no_clip_loss=False))
    g = torch.Generator().manual_seed(0)
    params = {"model": F.multimodal_bart_init(g, cfg.bart, cfg.fusion),
              "clip": CV.clip_vision_init(g, cfg.clip)}
    text = CT.clip_text_init(g, vocab_size=64, context_length=16, width=32, layers=2,
                             heads=cfg.clip.text_heads, output_dim=cfg.clip.output_dim)
    params["clip_text"] = {k: v for k, v in text.items() if k != "heads"}
    teacher = B.bart_init(g, cfg.bart)
    batch = synthetic_batch(cfg, 4, seed=1, with_pixels=True)
    batch["caption_ids_clip"] = torch.randint(1, 63, (4, 16), generator=g)
    for _, p in leaves_with_path(params):
        if p.is_floating_point():
            p.requires_grad_(True)

    def run():
        return TT.loss_and_grads(params, teacher, batch, cfg, dropout_rng=11)

    want_metrics, want = run()
    calls = _emulate(monkeypatch)
    got_metrics, got = run()
    assert calls.count("bf16") > calls.count("f32") > 0
    assert set(got_metrics) == set(want_metrics)
    for k in want_metrics:
        assert torch.equal(got_metrics[k], want_metrics[k]), k
    assert sum(x is not None for x in want) > 100
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a is None) == (b is None), i
        if a is not None:
            assert torch.equal(a, b), (i, float((a - b).abs().max()))


# ---------------------------------------------------------------------------
# the CPU and float32 operands: the float32 recipe, as the sites wrote it
# ---------------------------------------------------------------------------

def _old_recipes(g, dtype):
    """(what the helper computes now, what the site wrote before it) for
    each product site, operands in `dtype`."""
    x, k = rn(g, 3, 5, 32, dtype=dtype), rn(g, 32, 48)
    q, kk, v = (rn(g, 2, 4, t, 16, dtype=dtype) for t in (7, 9, 9))
    p = torch.softmax(torch.randn(2, 4, 7, 9, generator=g), -1).to(dtype)
    t, kern = rn(g, 3, 2, 5, 32, dtype=dtype), rn(g, 3, 32, 24)
    w = rn(g, 50, 32)
    n, f = rn(g, 4, 3, 32), rn(g, 4, 2, 32)
    return {
        "linear": (P.product(x, k.to(dtype), cotangent="bf16"),
                   torch.matmul(x.float(), k.to(dtype).float())),
        "scores": (P.product(q, kk.transpose(-1, -2), cotangent="f32"),
                   torch.einsum("bhtd,bhsd->bhts", q.float(), kk.float())),
        "pv": (P.product(p, v, cotangent="bf16"),
               torch.einsum("bhts,bhsd->bhtd", p.float(), v.float())),
        "linear_batched": (P.product(t.reshape(3, 10, 32), kern.to(dtype), cotangent="bf16"
                                     ).reshape(3, 2, 5, 24),
                           torch.einsum("lbnd,lde->lbne", t.float(), kern.to(dtype).float())),
        "lm_logits": (P.product(x, w.to(dtype).t(), cotangent="f32"),
                      torch.matmul(x.float(), w.to(dtype).float().t())),
        "secla": (P.product(n.reshape(12, 32), f.reshape(8, 32).t(), cotangent="f32"
                            ).reshape(4, 3, 4, 2).permute(0, 2, 1, 3),
                  torch.einsum("and,bfd->abnf", n, f)),
    }


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
def test_cpu_takes_the_f32_recipe(dtype):
    """On the CPU (bf16 or float32 operands) and for float32 operands the
    helper computes the float32 recipe with autograd's own backward: the
    bits of each site's former expression, forward and backward, and no
    bf16 Function."""
    assert P._bf16_mm(torch.ones(2, 2, dtype=BF16), torch.ones(2, 2, dtype=BF16)) is None
    cases = _old_recipes(torch.Generator().manual_seed(5), dtype)
    for name, (got, want) in cases.items():
        assert got.dtype == torch.float32 and torch.equal(got, want), name
        assert "Bf16Product" not in type(got.grad_fn).__name__, name
        gw = torch.linspace(-1, 1, got.numel()).reshape(got.shape)
        leaves = _graph_leaves(got)
        a = torch.autograd.grad((got * gw).sum(), leaves)
        b = torch.autograd.grad((want * gw).sum(), leaves)
        assert all(torch.equal(u, v) for u, v in zip(a, b)), name


def _graph_leaves(t):
    """The leaf tensors that require grad under t's graph."""
    out, seen, stack = [], set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if hasattr(fn, "variable"):
            out.append(fn.variable)
        stack.extend(f for f, _ in fn.next_functions)
    return out


def test_smoke_switches_the_recipe(emulate):
    """chip_smoke.use_products, the card checks' witness: "f32" routes the
    helper to the float32 recipe (twice in a row too), "bf16" back to the
    program's own choice, anything else is refused."""
    smoke = runpy.run_path(str(Path(__file__).resolve().parents[1] / "chip_smoke.py"),
                           run_name="chip_smoke_helpers")
    a = torch.ones(2, 3, dtype=BF16, requires_grad=True)
    b = torch.ones(3, 4, dtype=BF16)
    program = P._bf16_mm
    try:
        for _ in range(2):
            smoke["use_products"]("f32")
            assert P._bf16_mm(a, b) is None
            y = P.product(a, b, cotangent="bf16")
            assert "Bf16Product" not in type(y.grad_fn).__name__
    finally:
        smoke["use_products"]("bf16")
    assert P._bf16_mm is program
    assert "Bf16Product" in type(P.product(a, b, cotangent="bf16").grad_fn).__name__
    with pytest.raises(ValueError, match="expected one of"):
        smoke["use_products"]("fp8")


def test_product_refuses_what_it_does_not_take():
    a = torch.ones(2, 3, 4)
    with pytest.raises(ValueError, match="cotangent"):
        P.product(a, torch.ones(4, 5), cotangent="bf16-ish")
    with pytest.raises(ValueError, match="batch dimensions"):
        P.product(a, torch.ones(1, 4, 5), cotangent="f32")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: aten::mm.dtype has no CPU kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _sum_bound(a, b):
    """The classical bound of a float32 sum's rounding for each entry of
    a @ b: K unit roundoffs (2^-24) times |a| @ |b| (K the depth), so two
    orders of summation may differ by twice that."""
    k = a.shape[-1]
    return 2 * k * 2.0 ** -24 * torch.matmul(a.float().abs(), b.float().abs())


def _within(got, want, a, b):
    """Within two float32 summation orders, and for a bf16 result one bf16
    rounding more (2^-7 of the value): the two sums may round to
    neighbouring bf16 values."""
    err = (got.float() - want.float()).abs()
    tol = _sum_bound(a, b)
    if got.dtype == BF16:
        tol = tol + 2.0 ** -7 * want.float().abs()
    assert bool((err <= tol + 1e-30).all()), float(err.max())


# the training cell's products: the encoder's and decoder's rows (32 x 512
# tokens), d_model 1024, q/k/v/o, the face stream's 3072 and fc1; fc2; the
# LM head over the decoder's 32 x 100 rows and the 50267-word vocabulary
CARD_SHAPES = {"d_d": (16384, 1024, 1024), "d_3072": (16384, 1024, 3072),
               "fc1": (16384, 1024, 4096), "fc2": (16384, 4096, 1024)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_card_bf16_product_against_the_f32_recipe(dev, shape):
    """A `linear` product on the card (cotangent "bf16"): the output and
    both gradients against the float32 recipe, within one float32
    summation order; the output rounds to bf16 as the site rounds it."""
    m, k, n = CARD_SHAPES[shape]
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(m, k, generator=g, device=dev).to(BF16).requires_grad_(True)
    w = (torch.randn(k, n, generator=g, device=dev) * k ** -0.5).to(BF16).requires_grad_(True)
    cot = torch.randn(m, n, generator=g, device=dev).to(BF16).float()  # a bf16 value
    y = P.product(x, w, cotangent="bf16")
    assert "Bf16Product" in type(y.grad_fn).__name__
    dx, dw = torch.autograd.grad(y, (x, w), cot)
    yr = torch.matmul(x.float(), w.float())
    dxr, dwr = torch.autograd.grad(yr, (x, w), cot)
    _within(y, yr, x, w)
    _within(dx, dxr, cot, w.t())
    _within(dw, dwr, x.t(), cot)
    assert dx.dtype == dw.dtype == BF16


@pytest.mark.cuda
def test_card_lm_head_keeps_its_f32_backward(dev):
    """The LM head at the cell's 3200 x 1024 rows and 50267 words: the bf16
    forward within one float32 summation order of the recipe, the float32
    backward (its cotangent is no bf16 value) the recipe's own product."""
    g = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn(3200, 1024, generator=g, device=dev).to(BF16).requires_grad_(True)
    w = (torch.randn(50267, 1024, generator=g, device=dev) * 0.02).to(BF16).requires_grad_(True)
    cot = torch.randn(3200, 50267, generator=g, device=dev) * 1e-3
    y = P.product(h, w.t(), cotangent="f32")
    dh, dw = torch.autograd.grad(y, (h, w), cot)
    yr = torch.matmul(h.float(), w.t().float())
    dhr, dwr = torch.autograd.grad(yr, (h, w), cot)
    _within(y, yr, h, w.t())
    _within(dh, dhr, cot, w)
    _within(dw, dwr, cot.t(), h)


@pytest.mark.cuda
def test_card_spans_and_kernels_forward_and_backward(dev):
    """Under the profiler as the benchmark starts it (portbench/trace.py:
    this thread only), read back as the benchmark reads it: the spans
    opened in the backward, on autograd's device thread, are in the trace,
    and a step of bf16 products launches no float32 gemm."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import spans
    from portbench.trace import read_profile

    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(4, 128, 256, generator=g, device=dev).to(BF16).requires_grad_(True)
    k = (torch.randn(256, 512, generator=g, device=dev) * 0.05).requires_grad_(True)
    q, kk, v = (torch.randn(2, 4, 64, 32, generator=g, device=dev).to(BF16).requires_grad_(True)
                for _ in range(3))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        o = L.attention_plain(q, kk, v, None)
        torch.autograd.grad(o.float().square().sum(), (q, kk, v))
        torch.cuda.synchronize()
    rec = read_profile(prof, 1)
    # P·V 1 + 2 and the scores' forward 1 bf16; the scores' backward 2 f32
    assert (spans.count(rec, "product.bf16"), spans.count(rec, "product.f32")) == (4, 2)
    with profile(activities=acts) as prof:
        y = L.linear({"kernel": k}, x)
        torch.autograd.grad(y.float().square().sum(), (x, k))
        torch.cuda.synchronize()
    rec = read_profile(prof, 1)
    assert (spans.count(rec, "product.bf16"), spans.count(rec, "product.f32")) == (3, 0)
    gemms = sorted({n for n, *_ in rec.device if "gemm" in n.lower() or "nvjet" in n.lower()})
    print("bf16 product kernels:", gemms)
    assert gemms and not any("sgemm" in n or "f32f32_f32f32" in n for n in gemms), gemms


@pytest.mark.cuda
def test_card_train_b32_gradients_against_the_f32_recipe(dev, monkeypatch):
    """One whole step of the benchmark's vacnic_full.train_b32 (its trees,
    batch, dropout and remat): each bart leaf's gradient norm through the
    bf16 products against the float32 recipe's, as the cell's check reads
    them (portbench/drivers/train_closed.leaf_gaps), within the cell's
    limits: the worst leaf 0.25, the median leaf 0.0008. The loss is
    printed: bf16 activations carry a change of summation order through
    every layer, as they carry the float32 reference's rounding (the cell
    prints that loss gap, 0.25-1%, and holds it to no limit)."""
    import numpy as np

    from portbench import harness, weights
    from portbench.drivers.train_closed import draw_batch, leaf_gaps
    from vacnic_tpu_torch.train import train_step as TT

    cell = "vacnic_full.train_b32"
    ctx = harness.Context(name=cell, spec=harness.cell_spec(cell),
                          config=harness.config_file("vacnic_full"), seed=2 ** 31 + 11,
                          seconds=1.0, trace=False, device="cuda", t_start=0.0)
    cfg = ctx.port_config()
    params, teacher = weights.make_training_trees(ctx.sizes, ctx.sub_seed(0), dev)
    for _, p in leaves_with_path(params):
        if p.is_floating_point():
            p.requires_grad_(True)
    batch = draw_batch(ctx, 0)
    n_model = len(leaves_with_path(params["model"]))

    def grad_norms():
        metrics, grads = TT.loss_and_grads(params, teacher, batch, cfg, dropout_rng=5)
        norms = [float(torch.linalg.vector_norm(t.float())) for t in grads[:n_model]]
        return float(metrics["loss"]), norms

    loss, norms = grad_norms()
    monkeypatch.setattr(P, "_bf16_mm", lambda a, b: None)
    loss_ref, norms_ref = grad_norms()
    gaps, kept = leaf_gaps({"grad_norms": norms}, {"grad_norms": norms_ref}, "grad_norms")
    print(f"loss {loss!r} / {loss_ref!r}; grad gap worst {gaps.max()!r} median "
          f"{np.median(gaps)!r} over {len(kept)} leaves")
    assert math.isfinite(loss) and math.isfinite(loss_ref)
    assert gaps.max() <= 0.25 and np.median(gaps) <= 0.0008
