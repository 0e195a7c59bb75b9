"""The yardstick's arithmetic reproduces the bounds of the port's kernel
table (PERF.md §6, computed by chip_smoke.py from the same shapes)."""

import pytest

from portbench import costs


@pytest.mark.parametrize("m,k,n,res,out,want", [
    (160, 1024, 3072, False, 2, 0.0023),        # dec qkv M=160 [small_m]
    (160, 1024, 1024, True, 4, 0.0011),         # dec self_out +res f32
    (16384, 1024, 3072, False, 2, 0.1042),      # enc qkv M=16384 (operations)
    (16384, 1024, 1024, True, 4, 0.0507),       # enc self_out +res f32 (bytes)
    (1280, 1024, 3072, False, 2, 0.0081),       # dec qkv M=1280 [mid_m] (operations)
])
def test_gemm_bound(m, k, n, res, out, want):
    ms, _ = costs.bound(costs.gemm_bytes(m, k, n, res, out), costs.gemm_ops(m, k, n))
    assert round(ms, 4) == want


@pytest.mark.parametrize("items,beams,want", [(32, 5, 0.0103), (256, 5, 0.0825), (8, 11, 0.0026),
                                              (32, 16, 0.0107)])
def test_dec_cross_bound(items, beams, want):
    ms, how = costs.bound(costs.dec_cross_bytes(items, beams, 16, 64, 512),
                          costs.dec_cross_ops(items, beams, 16, 64, 512))
    assert round(ms, 4) == want and how == "bytes"


def test_caption_counts_match_the_launches():
    """588 dec_cross and 72 + 3528 gemm_bf16 launches a batch (PERF §6)."""
    from portbench.harness import config_file

    s = config_file("vacnic_full")["sizes"]
    _, ops, n = costs.caption_gemm_bf16(s, 32)
    assert n == 72 + 3528 and ops > 0
    assert costs.caption_dec_cross(s, 32)[1] == 588


def test_model_flops_orders():
    from portbench.harness import config_file

    full, only = config_file("vacnic_full")["sizes"], config_file("vacnic_onlyvis")["sizes"]
    f = costs.caption_flops(full, 256)
    assert 80e12 < f < 100e12  # about 90 TFLOP a batch
    assert costs.caption_flops(only, 256) < f
    t = costs.train_step_flops(full, 32)
    assert 30e12 < t < 45e12  # about 36 TFLOP a step


def test_every_product_holds_the_gemm_bf16_ones():
    """caption_products counts gemm_bf16's products at the same shapes, and
    more work besides: its least time is above theirs (a lower byte count,
    the same operations), its operations under the batch's model FLOPs."""
    from portbench.harness import config_file

    for name in ("vacnic_full", "vacnic_onlyvis"):
        s = config_file(name)["sizes"]
        prods = costs.caption_products(s, 256)
        mine = [(m, k, n, c) for nm, m, k, n, c in prods if nm[4:] in
                {p[0] for p in costs.layer_products(s["d_model"], s["encoder_ffn_dim"])}]
        _, ops, launches = costs.caption_gemm_bf16(s, 256)
        assert sum(c for *_, c in mine) == launches
        assert sum(c * costs.gemm_ops(m, k, n) for m, k, n, c in mine) == ops
        assert costs.products_least_s(prods) > costs.caption_gemm_bf16(s, 256)[0] * 0.9
        assert sum(c * costs.gemm_ops(m, k, n) for _, m, k, n, c in prods) < costs.caption_flops(s, 256)


@pytest.mark.parametrize("name,product", [
    ("gemm_large_kernel", True), ("gemm_mid_kernel", True),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nn_align1>(Params)", True),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32_cublas", True),
    ("nvjet_hsh_256x128_64x4_1x2_h_bz_coopA_NNN", True),
    ("void splitKreduce_kernel<32, 16, int, float, float, float>(...)", True),
    ("lm_head_kernel", True),
    ("fmha_cutlassF_f32_aligned_64x64_rf_sm80(AttentionKernel)", False),
    ("dec_cross_kernel_wide<1, 2>", False), ("enc_self_attn_kernel", False),
    ("layernorm_warp_kernel", False), ("Memcpy DtoD (Device -> Device)", False),
])
def test_products_roofline_reads_every_product_kernel(name, product):
    from portbench.harness import metric_reader

    assert metric_reader("products_roofline.caption").is_product(name) is product


def test_products_roofline_over_the_product_kernels_time():
    from portbench.harness import metric_reader
    from portbench.trace import Records

    dev = [("gemm_large_kernel", 0.0, 3e5, 1), ("cutlass_80_simt_sgemm_nn", 3e5, 1e5, 2),
           ("dec_cross_kernel<int8, 5>", 4e5, 5e5, 3)]
    rec = Records(device=dev, launches={}, ranges=[], cpu_ops=[], window_us=(0.0, 1e6), units=1,
                  extra={"products_least_s": 0.1})
    reader = metric_reader("products_roofline.caption")
    assert reader.read(rec) == pytest.approx(25.0)  # 0.1 s over 0.4 s of product kernels
    rec.device = dev[2:]
    assert reader.read(rec) is None
