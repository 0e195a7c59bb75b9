#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (vacnic_tpu_torch) on one GPU.

    python3 chip_smoke.py                     # every phase, one card
    python3 chip_smoke.py --phases build,kernels   # `build` also prints the ptxas line

Phases:
  build    compile kernels/csrc/*.cu (one nvcc per source, in parallel).
  kernels  each CUDA kernel against its plain PyTorch twin on the card at
           the main path's shapes: max error against a stated tolerance,
           its time (the median of five groups of 20 calls; graph_ms is the
           same 20 calls replayed from one CUDA graph, without the host's
           dispatch), the plain twin's time, its bound (bytes or operations
           over the H100's peak rate) and, where one PyTorch call computes
           the same function, that call's time, eager and from a graph
           (timed here only; the port never calls it). gemm_bf16 runs every product of a layer in both
           regimes (M = 16384: the TMA kernel, M = 160: the split-K kernel;
           each row names its plan) and ragged shapes untimed. Untimed too:
           layernorm at d 32 ... 2048 (both kernels, a scalar tail) and
           rows 1 to 6000; dec_cross_attention at beams 1, 5, 8 x S 1, 40,
           130, 512, int8 and bf16, with an item whose keys are all masked.
           layernorm and dec_cross_attention must repeat bit-identically.
  dispatch host microseconds a call of the decoder's products, layernorm and
           a bare torch.empty, issued without waiting for the card.
  stacks   full-width fused encoder and decode step (random weights) against
           the layer-by-layer references on a small batch.
  slice    VacnicConfig.full_train(), random bf16 weights from seed 0,
           synthetic_batch(32): generate_mm on cuda, beam 5 x max_length 50
           x length penalty 2.0 with min_length 49. Launch counts are zeroed
           just before this run and read just after; the six kernels of the
           fused encoder and the decode stack must have launched, gemm_bf16's
           large-M kernel six times an encoder layer and its small-M kernel
           for every other product, layernorm once a layer norm (1800, all
           on the warp kernel) and dec_cross_attention once a decoder layer a
           step (588). Checks finite scores and a mean caption length >= 45.
  stats    the same run with lm_stats=True (the fused LM-stats head):
           lm_stats must launch once per decode step; at one step its
           stage 2 must be exact on the kernel's own logits (top-C equal to
           top_k over logits[:, :V], lse within 1e-5 of torch.logsumexp);
           finite scores, mean length >= 45; token agreement with the slice.
  layerwise  generate_mm(add_ner_ffn=False): the layer-by-layer encoder,
           whose 512-token self-attention is flash_attention (12 launches a
           pass), then the decode kernels; get_prob at batch 8 x S 512
           (flash again in its text encoder); and the layer-by-layer encoder
           at batch 2 on the card (bf16) against the same encoder in f32 on
           the CPU (relative error <= 5e-2).
  profile  the fused encoder alone, then one more run of each of the slice,
           stats and layerwise paths under torch.profiler: device time by
           kernel family, busy/idle share.

Prints the registers, spills and shared memory of the two 512-token
self-attention kernels, the two gemm_bf16, two layernorm and two
dec_cross_attention kernels (from nvcc's output of this build; a spill in
any but the attention kernels fails the run), a JSON line with
every kernel, the card's name and power limit (nvidia-smi), and last `{"ok": true, "device": {...}}`. Exits non-zero, printing
no result, when a phase fails or there is no CUDA device. Long logs go to
chiprun_out/chip_smoke/.

Tolerances, by each output's dtype: bf16 outputs are held to
|err| <= 2e-2 + 2e-2 * |plain| (one bf16 rounding of values up to a few
units, plus f32 sum-order noise); f32 outputs of the GEMM, LayerNorm and
LM-stats head to |err| <= 2e-3 + 2e-3 * |plain|.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12    # outside the tensor cores
PEAK_BYTES = 3.35e12      # HBM3
OUT_DIR = os.path.join("chiprun_out", "chip_smoke")

SOURCES = {
    "gemm_bf16": "vacnic_tpu_torch/kernels/csrc/gemm_bf16.cu",
    "layernorm": "vacnic_tpu_torch/kernels/csrc/layernorm.cu",
    "enc_self_attention": "vacnic_tpu_torch/kernels/csrc/enc_attention.cu",
    "enc_cross_attention": "vacnic_tpu_torch/kernels/csrc/enc_attention.cu",
    "dec_self_attention": "vacnic_tpu_torch/kernels/csrc/dec_attention.cu",
    "dec_cross_attention": "vacnic_tpu_torch/kernels/csrc/dec_cross_attention.cu",
    "lm_stats": "vacnic_tpu_torch/kernels/csrc/lm_stats.cu",
    "flash_attention": "vacnic_tpu_torch/kernels/csrc/flash_attn.cu",
}
REPLACES = {
    "gemm_bf16": "vacnic_tpu/kernels/encoder_stack.py:103 (_kernel matmuls); "
                 "vacnic_tpu/kernels/decode_layer.py:136 (_kernel matmuls)",
    "layernorm": "vacnic_tpu/kernels/encoder_stack.py:139 (ln); "
                 "vacnic_tpu/kernels/decode_layer.py:235 (ln)",
    "enc_self_attention": "vacnic_tpu/kernels/encoder_stack.py:160 (self-attention)",
    "enc_cross_attention": "vacnic_tpu/kernels/encoder_stack.py:197 (cross-attention)",
    "dec_self_attention": "vacnic_tpu/kernels/decode_layer.py:314 (_self_attn)",
    "dec_cross_attention": "vacnic_tpu/kernels/decode_layer.py:499 (_cross_attn)",
    "lm_stats": "vacnic_tpu/kernels/lm_stats.py:76 (lm_stats; _kernel :44)",
    "flash_attention": "vacnic_tpu/kernels/flash_attn.py:65 (flash_attention; _flash_kernel :28)",
}
SLICE_KERNELS = ("gemm_bf16", "layernorm", "enc_self_attention", "enc_cross_attention",
                 "dec_self_attention", "dec_cross_attention")
DECODE_KERNELS = ("gemm_bf16", "layernorm", "dec_self_attention", "dec_cross_attention")


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2, groups: int = 5) -> float:
    """Median over `groups` of the mean time of `reps` back-to-back calls
    (CUDA events): one slow group, a clock ramp or a neighbour on the host,
    does not move the number."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(groups):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return sorted(means)[len(means) // 2]


def graph_ms(fn, reps: int = 20) -> float:
    """Per-call time of `reps` calls captured once in a CUDA graph and
    replayed (median of ten replays): the device's time, without the host's
    dispatch between launches."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # allocator and library warm-up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, reps=1, groups=10) / reps


def bound(byts: float, ops: float, peak_ops: float = PEAK_BF16_FLOPS):
    t_bytes, t_ops = byts / PEAK_BYTES, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# kernels phase
# ---------------------------------------------------------------------------

def kernel_cases():
    """(name, kernel, call, plain call, bytes, ops, peak, library call or None)
    at the main path's shapes. A case with bytes None is held against its
    plain twin only: it is not timed and not listed."""
    import itertools

    import torch
    import torch.nn.functional as Fn

    from vacnic_tpu_torch.kernels import primitives as K

    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    bf = torch.bfloat16

    def rn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    cases = []
    d, F = 1024, 4096
    products = (("qkv", d, 3 * d, None, False, bf), ("self_out", d, d, None, True, torch.float32),
                ("cross_q", d, d, None, False, bf), ("fc1", d, F, K.GELU, False, bf),
                ("fc2", F, d, None, True, torch.float32))  # cross_out is self_out's product
    for tag, m in (("enc", 32 * 512), ("dec", 160)):
        for sub, k, n, act, res, out in products:
            a, w, b = rn(m, k, dtype=bf), rn(k, n, std=0.02, dtype=bf), rn(n, std=0.02)
            r = rn(m, n) if res else None
            byts = (m * k + k * n) * 2 + n * 4 + (m * n * 4 if res else 0) + m * n * out.itemsize
            b16 = b.to(bf)
            plan = K.gemm_plan(m, n, k)
            how = plan.variant + (f" split {plan.split}" if plan.variant == "small_m" else "")
            epi = "".join((" +gelu" if act else "", " +res" if res else "",
                           " f32" if out == torch.float32 else " bf16"))
            cases.append((f"gemm_bf16 {tag} {sub} M={m} K={k} N={n}{epi} [{how}]",
                          f"gemm_bf16:{plan.variant}",  # its launches are its own kernel's
                          lambda a=a, w=w, b=b, r=r, act=act, out=out: K.gemm(a, w, b, r, act, out),
                          lambda a=a, w=w, b=b, r=r, act=act, out=out:
                          K.gemm_plain(a, w, b, r, act, out),
                          byts, 2.0 * m * n * k, PEAK_BF16_FLOPS,
                          lambda a=a, w=w, b16=b16: torch.addmm(b16, a, w)))
    # correctness only: ragged rows in both kernels, every epilogue combination
    for m in (1, 37, 161, 1280):
        a, w = rn(m, 256, dtype=bf), rn(256, 384, std=0.05, dtype=bf)
        b, r = rn(384), rn(m, 384)
        for bias, res, act, out in itertools.product((None, b), (None, r), (None, K.GELU),
                                                     (torch.float32, bf)):
            epi = "".join((" +bias" if bias is not None else "", " +gelu" if act else "",
                           " +res" if res is not None else "",
                           " f32" if out == torch.float32 else " bf16"))
            cases.append((f"gemm_bf16 M={m} K=256 N=384{epi} [{K.gemm_plan(m, 384, 256).variant}]",
                          "gemm_bf16",
                          lambda a=a, w=w, bias=bias, res=res, act=act, out=out:
                          K.gemm(a, w, bias, res, act, out),
                          lambda a=a, w=w, bias=bias, res=res, act=act, out=out:
                          K.gemm_plain(a, w, bias, res, act, out),
                          None, 0.0, PEAK_BF16_FLOPS, None))

    def ln_case(rows, width, timed=False):  # both outputs, f32 and bf16, are held to the twin
        x = rn(rows, width)
        gb = torch.stack([1 + rn(width, std=0.1), rn(width, std=0.1)]).contiguous()
        plan = K.layernorm_plan(rows, width)
        how = plan.variant + (f" {plan.slots} slots" if plan.slots else "")
        return (f"layernorm rows={rows} d={width} [{how}]", f"layernorm:{plan.variant}",
                lambda: K.layernorm(x, gb, bf), lambda: K.layernorm_plain(x, gb, bf),
                rows * width * (4 + 4 + 2) + 2 * width * 4 if timed else None,
                8.0 * rows * width, PEAK_F32_FLOPS,
                lambda: Fn.layer_norm(x, (width,), gb[0], gb[1]))

    cases += [ln_case(32 * 512, d, timed=True), ln_case(160, d, timed=True)]
    # correctness only: every width class of both kernels (a scalar tail where
    # d % 4 != 0), one row to more than a resident wave of warps
    cases += [ln_case(rows, width) for width in (32, 384, 768, 1022, 1024, 1030, 2048)
              for rows in (1, 37, 160)]
    cases += [ln_case(6000, 1024), ln_case(6000, 384)]

    H, B, S, KV = 16, 8, 512, 40

    def enc_self_case(bsz, seq, timed=True):  # B=32 is the slice's own shape
        qkv = rn(bsz * seq, 3 * d, dtype=bf)
        keep = torch.arange(seq, device=dev)[None, :] < torch.randint(
            seq // 2, seq + 1, (bsz, 1), device=dev, generator=g)
        sbias = torch.where(keep, 0.0, torch.finfo(torch.float32).min).float().contiguous()
        clamped = sbias.clamp(min=float(torch.finfo(bf).min))
        q4 = qkv.view(bsz, seq, 3, H, 64)
        mask = keep[:, None, None, :]
        return (f"enc_self_attention B={bsz} S={seq} H={H}", "enc_self_attention",
                lambda: K.enc_self_attention(qkv, clamped, bsz, seq, H),
                lambda: K.enc_self_attention_plain(qkv, clamped, bsz, seq, H),
                bsz * seq * 4 * d * 2 + bsz * seq * 4 if timed else None,
                4.0 * bsz * H * seq * seq * 64, PEAK_BF16_FLOPS,
                lambda: Fn.scaled_dot_product_attention(
                    q4[:, :, 0].transpose(1, 2), q4[:, :, 1].transpose(1, 2),
                    q4[:, :, 2].transpose(1, 2), attn_mask=mask))

    cases += [enc_self_case(B, S), enc_self_case(32, S), enc_self_case(3, 64, timed=False),
              enc_self_case(3, 192, timed=False)]
    q = rn(B * S, d, dtype=bf)
    ck, cv = rn(B, d, KV, dtype=bf), rn(B, KV, d, dtype=bf)
    cases.append((f"enc_cross_attention B={B} S={S} KV={KV}", "enc_cross_attention",
                  lambda: K.enc_cross_attention(q, ck, cv, B, S, H),
                  lambda: K.enc_cross_attention_plain(q, ck, cv, B, S, H),
                  (2 * B * S * d + 2 * B * KV * d) * 2, 4.0 * B * S * KV * d, PEAK_BF16_FLOPS,
                  lambda: Fn.scaled_dot_product_attention(
                      q.view(B, S, H, 64).transpose(1, 2),
                      ck.view(B, H, 64, KV).transpose(2, 3), cv.view(B, KV, H, 64).transpose(1, 2))))

    BK, T, B2, beams = 160, 64, 32, 5
    ck_cache, cv_cache = rn(T, BK, d, dtype=bf), rn(T, BK, d, dtype=bf)
    qkv_d = rn(BK, 3 * d, dtype=bf)
    item = torch.arange(BK, device=dev) // beams
    anc = (item[None, :] * beams + torch.randint(0, beams, (T, BK), device=dev, generator=g)
           ).to(torch.int32).contiguous()
    for pos in (0, 31, 49):
        n_rows = int(torch.unique(torch.arange(pos, device=dev)[:, None] * BK
                                  + anc[:pos].long()).numel()) if pos else 0
        byts = BK * 3 * d * 2 + 2 * n_rows * d * 2 + pos * BK * 4 + BK * d * 2
        cases.append((f"dec_self_attention BK={BK} T={T} pos={pos}", "dec_self_attention",
                      lambda pos=pos: K.dec_self_attention(qkv_d, ck_cache, cv_cache, anc, pos, H),
                      lambda pos=pos: K.dec_self_attention_plain(qkv_d, ck_cache, cv_cache, anc,
                                                                 pos, H),
                      byts, 4.0 * BK * d * (pos + 1), PEAK_BF16_FLOPS, None))
    qd = rn(BK, d, dtype=bf)
    ebias = torch.where(torch.arange(S, device=dev)[None, :] < torch.randint(
        S // 2, S + 1, (B2, 1), device=dev, generator=g), 0.0,
        torch.finfo(torch.float32).min).float().contiguous()
    for kind in ("int8", "bf16"):
        if kind == "int8":
            kk = torch.randint(-127, 128, (B2, H, 64, S), device=dev, generator=g).to(torch.int8)
            vv = torch.randint(-127, 128, (B2, H, 64, S), device=dev, generator=g).to(torch.int8)
            ks, vs = rn(B2, H, 64, std=0.01).abs() + 1e-3, rn(B2, H, 64, std=0.01).abs() + 1e-3
            lib = None
        else:
            kk, vv = rn(B2, H, 64, S, dtype=bf), rn(B2, H, 64, S, dtype=bf)
            ks = vs = None
            emask = (ebias > -1)[:, None, None, :]
            lib = (lambda kk=kk, vv=vv, emask=emask: Fn.scaled_dot_product_attention(
                qd.view(B2, beams, H, 64).transpose(1, 2), kk.transpose(2, 3),
                vv.transpose(2, 3), attn_mask=emask))
        byts = BK * d * 2 * 2 + 2 * kk.numel() * kk.element_size() + B2 * S * 4 + (
            2 * B2 * H * 64 * 4 if ks is not None else 0)
        cases.append((f"dec_cross_attention {kind} B={B2} beams={beams} S={S}",
                      "dec_cross_attention",
                      lambda kk=kk, vv=vv, ks=ks, vs=vs: K.dec_cross_attention(
                          qd, kk, vv, ks, vs, ebias, H),
                      lambda kk=kk, vv=vv, ks=ks, vs=vs: K.dec_cross_attention_plain(
                          qd, kk, vv, ks, vs, ebias, H),
                      byts, 4.0 * BK * S * d, PEAK_BF16_FLOPS, lib))
    # correctness only: beams 1, 5, 8 x S 1, 40, 130, 512 x int8 and bf16; item
    # 0 has every key masked (a uniform row), item 1 half of them
    B5, H5 = 3, 4
    for beams_c, s_c, kind in itertools.product((1, 5, 8), (1, 40, 130, 512), ("int8", "bf16")):
        cases.append(dec_cross_case(rn, g, B5, H5, beams_c, s_c, kind))

    from vacnic_tpu_torch.kernels import flash_attn as FA
    from vacnic_tpu_torch.kernels import lm_stats as LS

    V, Vp = 50267, 53248
    x_lm = rn(BK, d, dtype=bf)
    w_lm = torch.zeros(Vp, d, device=dev, dtype=bf)
    w_lm[:V] = rn(V, d, std=0.02, dtype=bf)
    b_lm = torch.full((Vp,), -1e9, device=dev)
    b_lm[:V] = rn(V, std=0.02)
    nvb = Vp // LS.VBLOCK
    cases.append((f"lm_stats BK={BK} d={d} Vp={Vp}", "lm_stats",
                  lambda: LS.lm_stats(x_lm, w_lm, b_lm),
                  lambda: LS.lm_stats_plain(x_lm, w_lm, b_lm),
                  BK * d * 2 + Vp * d * 2 + Vp * 4 + BK * Vp * 4 + 2 * BK * nvb * 4,
                  2.0 * BK * Vp * d, PEAK_BF16_FLOPS, None))

    B3, T3 = 32, 512

    def heads():  # head-split views of [B, T, H*64] projections, as attention_core gets them
        return rn(B3, T3, d, dtype=bf).view(B3, T3, H, 64).permute(0, 2, 1, 3)

    fq = (heads().float() * 64 ** -0.5).to(bf)
    fk, fv = heads(), heads()
    fkeep = torch.arange(T3, device=dev)[None, :] < torch.randint(T3 // 2, T3 + 1, (B3, 1),
                                                                  device=dev, generator=g)
    fbias = torch.where(fkeep, 0.0, torch.finfo(bf).min).to(bf)[:, None, None, :].expand(
        B3, 1, T3, T3).contiguous()
    cases.append((f"flash_attention B={B3} H={H} T=S={T3} D=64 bias [B,1,T,S] bf16",
                  "flash_attention", lambda: FA.flash_attention(fq, fk, fv, fbias),
                  lambda: FA.flash_attention_plain(fq, fk, fv, fbias),
                  4 * B3 * H * T3 * 64 * 2 + fbias.numel() * 2, 4.0 * B3 * H * T3 * T3 * 64,
                  PEAK_BF16_FLOPS,
                  lambda: Fn.scaled_dot_product_attention(fq, fk, fv, attn_mask=fbias, scale=1.0)))
    # correctness only: T != S, an f32 per-head bias, non-contiguous head-split views
    B4, T4, S4 = 2, 256, 512
    hq = (rn(B4, T4, d).view(B4, T4, H, 64).permute(0, 2, 1, 3) * 64 ** -0.5).to(bf)
    hk = rn(B4, S4, d, dtype=bf).view(B4, S4, H, 64).permute(0, 2, 1, 3)
    hv = rn(B4, S4, d, dtype=bf).view(B4, S4, H, 64).permute(0, 2, 1, 3)
    hbias = rn(B4, H, T4, S4)
    hbias[1, :, :, 300:] = torch.finfo(torch.float32).min
    cases.append((f"flash_attention B={B4} H={H} T={T4} S={S4} D=64 bias [B,H,T,S] f32",
                  "flash_attention", lambda: FA.flash_attention(hq, hk, hv, hbias),
                  lambda: FA.flash_attention_plain(hq, hk, hv, hbias), None, 0.0,
                  PEAK_BF16_FLOPS, None))
    return cases


def dec_cross_case(rn, g, items: int, heads: int, beams: int, s_len: int, kind: str):
    """A correctness-only dec_cross_attention case: item 0 has every key
    masked (the twin's softmax is uniform there), item 1 the first half of
    them, the others none."""
    import torch

    from vacnic_tpu_torch.kernels import primitives as K

    keep = torch.full((items, 1), s_len, device="cuda")
    keep[0], keep[1] = 0, (s_len + 1) // 2
    ebias = torch.where(torch.arange(s_len, device="cuda")[None, :] < keep, 0.0,
                        torch.finfo(torch.float32).min).float().contiguous()
    q = rn(items * beams, heads * 64, dtype=torch.bfloat16)
    shape = (items, heads, 64, s_len)
    if kind == "int8":
        kk, vv = (torch.randint(-127, 128, shape, device="cuda", generator=g).to(torch.int8)
                  for _ in range(2))
        ks, vs = (rn(items, heads, 64, std=0.01).abs() + 1e-3 for _ in range(2))
    else:
        kk, vv = rn(*shape, dtype=torch.bfloat16), rn(*shape, dtype=torch.bfloat16)
        ks = vs = None
    return (f"dec_cross_attention {kind} B={items} beams={beams} S={s_len}",
            "dec_cross_attention",
            lambda: K.dec_cross_attention(q, kk, vv, ks, vs, ebias, heads),
            lambda: K.dec_cross_attention_plain(q, kk, vv, ks, vs, ebias, heads),
            None, 0.0, PEAK_BF16_FLOPS, None)


def tolerance(out) -> tuple[float, float]:
    """bf16 outputs: one bf16 rounding; f32 outputs: f32 sum order."""
    import torch

    return (2e-2, 2e-2) if out.dtype == torch.bfloat16 else (2e-3, 2e-3)


REPEATABLE = ("layernorm", "dec_cross_attention")  # checked bit-identical over two calls


def run_kernels_phase():
    import torch

    rows = []
    failures = []
    for name, kern, call, plain, byts, ops, peak, lib in kernel_cases():
        outs = call()
        torch.cuda.synchronize()
        refs = plain()
        if isinstance(outs, torch.Tensor):
            outs, refs = (outs,), (refs,)
        ok, max_err, errs = True, 0.0, []
        for out, ref in zip(outs, refs):  # every output of the kernel
            tol_a, tol_r = tolerance(out)
            e = (out.float() - ref.float()).abs()
            ok = ok and bool(torch.isfinite(out.float()).all()) and bool(
                (e <= tol_a + tol_r * ref.float().abs()).all())
            max_err = max(max_err, float(e.max()))
            errs.append(f"{str(out.dtype).split('.')[-1]} {float(e.max()):.3e} (tol {tol_a}+"
                        f"{tol_r}*|plain|)")
        if kern.split(":")[0] in REPEATABLE:
            again = call()
            again = (again,) if isinstance(again, torch.Tensor) else again
            if not all(torch.equal(a, o) for a, o in zip(again, outs)):
                ok = False
                errs.append("NOT bit-identical over two calls")
        if byts is None:  # held against the plain twin only
            log(f"kernel {name}: max_abs_err {', '.join(errs)} {'ok' if ok else 'FAIL'}; "
                "not timed")
            if not ok:
                failures.append(name)
            continue
        reps = 20
        ms = time_ms(call, reps)
        g_ms = graph_ms(call, reps)
        plain_ms = time_ms(plain, 5, warmup=1)
        lib_ms = time_ms(lib, reps) if lib is not None else None
        lib_g_ms = graph_ms(lib, reps) if lib is not None else None
        b_ms, b_by = bound(byts, ops, peak)
        family = kern.split(":")[0]
        row = {"name": name, "kernel": kern, "route": "cuda", "source": SOURCES[family],
               "replaces": REPLACES[family], "launches": None,
               "max_abs_err": max_err, "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "library_graph_ms": lib_g_ms}
        if family == "gemm_bf16":
            row["library"] = "torch.addmm in bf16: product + bias only"
        rows.append(row)
        log(f"kernel {name}: max_abs_err {', '.join(errs)} {'ok' if ok else 'FAIL'}; ms {ms:.4f} "
            f"graph_ms {g_ms:.4f} plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms {lib_ms} "
            f"library_graph_ms {lib_g_ms}")
        if not ok:
            failures.append(name)
    if failures:
        raise RuntimeError(f"kernels disagree with their plain twins: {failures}")
    return rows


def host_us(fn, calls: int = 500) -> float:
    """Host time of one call, in microseconds: `calls` calls issued without
    waiting for the card (perf_counter around the loop, one synchronize
    after it). The card's queue is far deeper than the loop, so this is what
    the call costs the Python thread: checks, torch.empty, ctypes and the
    CUDA runtime's launch."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def run_dispatch_phase() -> None:
    """What a launch costs the host, which sets the wall of every path: the
    decoder's products (M = 160) through gemm, with layernorm at 160 rows (a
    plain <<< >>> launch) and a bare torch.empty beside them; the median of
    five loops each. Uses only the wrappers' public interface, so the same
    phase times an older tree's kernels when this file is run from it
    (`--phases dispatch`)."""
    import torch

    from vacnic_tpu_torch.kernels import primitives as K

    bf, d, F, m = torch.bfloat16, 1024, 4096, 160
    g = torch.Generator(device="cuda").manual_seed(4321)

    def rn(*shape, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device="cuda") * 0.02).to(dtype)

    calls = [("torch.empty [160, 1024] f32", lambda: torch.empty(m, d, device="cuda"))]
    x, gb = rn(m, d), torch.stack([1 + rn(d), rn(d)]).contiguous()
    calls.append(("layernorm rows=160", lambda: K.layernorm(x, gb, bf)))
    for sub, k, n, act, res, out in (("qkv", d, 3 * d, None, False, bf),
                                     ("self_out +res f32", d, d, None, True, torch.float32),
                                     ("fc1 +gelu", d, F, K.GELU, False, bf),
                                     ("fc2 +res f32", F, d, None, True, torch.float32)):
        a, w, b = rn(m, k, dtype=bf), rn(k, n, dtype=bf), rn(n)
        r = rn(m, n) if res else None
        calls.append((f"gemm_bf16 dec {sub} M={m} K={k} N={n}",
                      lambda a=a, w=w, b=b, r=r, act=act, out=out: K.gemm(a, w, b, r, act, out)))
    for name, fn in calls:
        us = sorted(host_us(fn) for _ in range(5))
        log(f"dispatch {name}: host {us[2]:.2f} us a call (min {us[0]:.2f}, max {us[4]:.2f})")


# ---------------------------------------------------------------------------
# stacks + slice phases
# ---------------------------------------------------------------------------

def full_model(seed: int = 0):
    import torch

    from vacnic_tpu_torch.core.config import VacnicConfig
    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.models.fusion import multimodal_bart_init
    from vacnic_tpu_torch.models.weights_io import tree_to

    cfg = VacnicConfig.full_train()
    cfg = dataclasses.replace(cfg, decode=dataclasses.replace(
        cfg.decode, min_length=cfg.decode.max_length - 1))
    params = multimodal_bart_init(make_generator(seed, "cuda"), cfg.bart, cfg.fusion,
                                  device="cuda")
    return cfg, tree_to(params, dtype=torch.bfloat16)


def batch_inputs(cfg, batch_size: int):
    from vacnic_tpu_torch.data.synthetic import synthetic_batch
    from vacnic_tpu_torch.train.train_step import create_mask, face_mask_from_emb

    b = {k: v.cuda() for k, v in synthetic_batch(cfg, batch_size=batch_size, seed=0).items()}
    return dict(input_ids=b["article_ids"], attention_mask=create_mask(b["article_ids"]),
                image_features=b["image_cls"], face_features=b["face_emb"],
                face_mask=face_mask_from_emb(b["face_emb"]), name_ids=b["names_art_ids"],
                name_mask=create_mask(b["names_art_ids"]))


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-6))


def run_stacks_phase(cfg, params):
    """Full width, batch 2: the fused encoder (CUDA text stack) against the
    layer-by-layer encoder, and three kernel decode steps against the
    reference decode step, both in bf16 on the card. Tolerance: max error
    <= 5% of the reference's max magnitude (a bf16 model run two ways)."""
    import torch

    from vacnic_tpu_torch.infer import decode_fast as DF
    from vacnic_tpu_torch.models import fusion as F
    from vacnic_tpu_torch.models.layers import expand_mask

    bf = torch.bfloat16
    x = batch_inputs(cfg, 2)
    kw = {k: x[k] for k in ("face_features", "face_mask", "name_ids", "name_mask")}
    args = (params, x["input_ids"], x["attention_mask"], x["image_features"], cfg.bart,
            cfg.fusion)
    with torch.no_grad():
        fused = F.mm_encoder_fwd_fused(*args, dtype=bf, **kw)["last_hidden"]
        ref = F.mm_encoder_fwd(*args, dtype=bf, **kw)["last_hidden"]
        e_enc = rel_err(fused, ref)
        enc = ref
        dp = DF.build_decode_params(params, bf)
        c_ref = DF.build_decode_cache(params, enc, 5, 50, cfg.bart, bf, pad_to=16)
        c_ker = DF.build_decode_cache(params, enc, 5, 50, cfg.bart, bf, pad_to=16,
                                      time_major=True)
        bias = expand_mask(x["attention_mask"], 1)
        tok = torch.full((10, 1), cfg.bart.decoder_start_token_id, device="cuda")
        e_dec, agree = 0.0, 1.0
        for pos in range(3):
            lr, c_ref = DF.decode_step(dp, params, c_ref, tok, pos, bias, cfg.bart, bf)
            lk, c_ker = DF.decode_step_kernel(dp, params, c_ker, tok, pos, bias, cfg.bart, bf)
            e_dec = max(e_dec, rel_err(lk, lr))
            agree = min(agree, float((lk.argmax(-1) == lr.argmax(-1)).float().mean()))
            tok = lr.argmax(-1, keepdim=True)
    log(f"stacks: fused encoder vs layer-by-layer rel err {e_enc:.3e}; kernel decode step vs "
        f"reference rel err {e_dec:.3e}, argmax agreement {agree:.3f} (tol rel 5e-2)")
    if not (e_enc <= 5e-2 and e_dec <= 5e-2):
        raise RuntimeError("full-width stacks disagree with their references")


def check_captions(tag: str, cfg, seqs, scores, batch_size: int) -> float:
    """Shape, finite scores, mean non-pad length >= 45 -> that length."""
    import torch

    nonpad = float((seqs != cfg.bart.pad_token_id).sum(dim=1).float().mean())
    if tuple(seqs.shape) != (batch_size, cfg.decode.max_length):
        raise RuntimeError(f"{tag}: sequences of shape {tuple(seqs.shape)}")
    if not bool(torch.isfinite(scores).all()):
        raise RuntimeError(f"{tag}: non-finite scores")
    if nonpad < 0.9 * cfg.decode.max_length:
        raise RuntimeError(f"{tag}: mean non-pad length {nonpad:.1f} < 45")
    return nonpad


def check_launched(tag: str, counts: dict, names) -> None:
    missing = [k for k in names if counts[k] == 0]
    if missing:
        raise RuntimeError(f"{tag}: kernels of this path never launched: {missing}")


def run_slice_phase(cfg, params, batch_size: int):
    import torch

    from vacnic_tpu_torch.infer.generate import generate_mm
    from vacnic_tpu_torch.kernels import primitives as K

    x = batch_inputs(cfg, batch_size)

    def run():
        seqs, scores = generate_mm(params, cfg=cfg.bart, fcfg=cfg.fusion, dcfg=cfg.decode,
                                   dtype=torch.bfloat16, device="cuda", **x)
        torch.cuda.synchronize()
        return seqs, scores

    run()  # warm-up: allocator, cuBLAS handles
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seqs, scores = run()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    by_kernel = K.gemm_variant_counts()
    ln_by_kernel = K.layernorm_variant_counts()
    nonpad = check_captions("slice", cfg, seqs, scores, batch_size)
    log(f"slice: full_train beam {cfg.decode.num_beams} x {cfg.decode.max_length} x lp "
        f"{cfg.decode.length_penalty}, batch {batch_size}: {dt:.3f} s, "
        f"{batch_size / dt:.2f} captions/s, mean non-pad length {nonpad:.1f}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}")
    check_launched("slice", counts, SLICE_KERNELS)
    log(f"slice: gemm_bf16 by kernel {by_kernel}")
    enc_products = 6 * cfg.bart.encoder_layers  # M = batch x 512 rows; decode has batch x 5
    if by_kernel != {"large_m": enc_products, "small_m": counts["gemm_bf16"] - enc_products}:
        raise RuntimeError(f"slice: gemm_bf16 kernels {by_kernel}: expected {enc_products} "
                           "large_m launches (the encoder's) and small_m for the rest")
    counts.update({f"gemm_bf16:{v}": n for v, n in by_kernel.items()})
    # one launch a call: three layer norms an encoder layer and a decoder
    # layer a step, one cross-attention a decoder layer a step; d = 1024 is
    # the register-resident kernel's
    steps = cfg.decode.max_length - 1  # min_length = max_length - 1: every step runs
    dec_layers = cfg.bart.decoder_layers
    want = {"layernorm": 3 * cfg.bart.encoder_layers + 3 * dec_layers * steps,
            "dec_cross_attention": dec_layers * steps}
    log(f"slice: layernorm by kernel {ln_by_kernel}; expected {want}")
    if any(counts[k] != n for k, n in want.items()) or ln_by_kernel != {
            "warp": want["layernorm"], "block": 0}:
        raise RuntimeError(f"slice: launches {counts}, layernorm by kernel {ln_by_kernel}: "
                           f"expected {want}, all layernorm launches the warp kernel's")
    counts.update({f"layernorm:{v}": n for v, n in ln_by_kernel.items()})
    return counts, seqs


def run_stats_phase(cfg, params, batch_size: int, ref_seqs):
    """generate_mm(lm_stats=True): the fused LM-stats head replaces the LM
    head and the shortlist's full-width passes. One step's stage 2 is held
    exact against the kernel's own logits."""
    import torch

    from vacnic_tpu_torch.infer import decode_fast as DF
    from vacnic_tpu_torch.infer.beam_search import top_k
    from vacnic_tpu_torch.infer.generate import generate_mm
    from vacnic_tpu_torch.kernels import primitives as K

    x = batch_inputs(cfg, batch_size)
    vocab = params["shared"]["weight"].shape[0]
    real = DF.decode_step_kernel_stats
    steps, seen = [], {}

    def spy(*a, **kw):  # counts the steps, keeps one step's outputs
        out = real(*a, **kw)
        steps.append(1)
        if len(steps) == 4:
            seen["out"] = out
        return out

    def run():
        seqs, scores = generate_mm(params, cfg=cfg.bart, fcfg=cfg.fusion, dcfg=cfg.decode,
                                   dtype=torch.bfloat16, device="cuda", lm_stats=True, **x)
        torch.cuda.synchronize()
        return seqs, scores

    DF.decode_step_kernel_stats = spy
    try:
        run()  # warm-up
        steps.clear()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        seqs, scores = run()
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
    finally:
        DF.decode_step_kernel_stats = real
    nonpad = check_captions("stats", cfg, seqs, scores, batch_size)
    agree = float((seqs == ref_seqs).float().mean())
    logits, cv, ci, lse, _ = seen["out"]
    tv, ti = top_k(logits[:, :vocab], cv.shape[1])
    lse_err = float((lse - torch.logsumexp(logits[:, :vocab], dim=-1)).abs().max())
    log(f"stats: lm_stats=True, batch {batch_size}: {dt:.3f} s, {batch_size / dt:.2f} "
        f"captions/s, mean non-pad length {nonpad:.1f}, {len(steps)} decode steps, token "
        f"agreement with the slice {agree:.4f}; step-4 stage 2: top-{cv.shape[1]} exact "
        f"{bool(torch.equal(cv, tv) and torch.equal(ci, ti))}, lse max err {lse_err:.2e} "
        f"(tol 1e-5); launches {counts}")
    check_launched("stats", counts, SLICE_KERNELS + ("lm_stats",))
    if counts["lm_stats"] != len(steps):
        raise RuntimeError(f"stats: lm_stats launched {counts['lm_stats']} times over "
                           f"{len(steps)} decode steps")
    if not (torch.equal(cv, tv) and torch.equal(ci, ti)) or lse_err > 1e-5:
        raise RuntimeError("stats: stage 2 is not exact on the kernel's logits")
    return counts


def run_layerwise_phase(cfg, params, batch_size: int):
    """The layer-by-layer encoder paths, whose 512-token self-attention is
    flash_attention: generate_mm(add_ner_ffn=False), get_prob, and the
    encoder on the card against the CPU in f32."""
    import torch

    from vacnic_tpu_torch.infer.generate import generate_mm, get_prob
    from vacnic_tpu_torch.kernels import primitives as K
    from vacnic_tpu_torch.models import fusion as F
    from vacnic_tpu_torch.models.bart import shift_tokens_right
    from vacnic_tpu_torch.models.weights_io import tree_to

    n_layers = cfg.bart.encoder_layers
    x = batch_inputs(cfg, batch_size)

    def run():
        seqs, scores = generate_mm(params, cfg=cfg.bart, fcfg=cfg.fusion, dcfg=cfg.decode,
                                   dtype=torch.bfloat16, device="cuda", add_ner_ffn=False, **x)
        torch.cuda.synchronize()
        return seqs, scores

    run()  # warm-up
    K.reset_launch_counts()
    t0 = time.perf_counter()
    seqs, scores = run()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    nonpad = check_captions("layerwise", cfg, seqs, scores, batch_size)
    log(f"layerwise: add_ner_ffn=False, batch {batch_size}: {dt:.3f} s, "
        f"{batch_size / dt:.2f} captions/s, mean non-pad length {nonpad:.1f}; launches {counts}")
    check_launched("layerwise", counts, DECODE_KERNELS + ("flash_attention",))
    if counts["flash_attention"] != n_layers:
        raise RuntimeError(f"layerwise: flash_attention launched {counts['flash_attention']} "
                           f"times in one {n_layers}-layer encoder pass")

    from vacnic_tpu_torch.data.synthetic import synthetic_batch
    from vacnic_tpu_torch.train.train_step import create_mask

    b8 = {k: v.cuda() for k, v in synthetic_batch(cfg, batch_size=8, seed=1).items()}
    labels = b8["caption_ids"].long()
    dec_in = shift_tokens_right(labels, cfg.bart.pad_token_id, cfg.bart.decoder_start_token_id)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    lp = get_prob(params, b8["article_ids"], create_mask(b8["article_ids"]), dec_in, labels,
                  cfg.bart, torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    dt_p = time.perf_counter() - t0
    n_flash = K.launch_counts()["flash_attention"]
    log(f"layerwise: get_prob batch 8 x S {b8['article_ids'].shape[1]} x T {labels.shape[1]}: "
        f"{dt_p:.3f} s, flash_attention launches {n_flash}, log-probs {lp.tolist()}")
    if tuple(lp.shape) != (8,) or not bool(torch.isfinite(lp).all()) or n_flash != n_layers:
        raise RuntimeError("layerwise: get_prob gave non-finite values or skipped the kernel")

    x2 = batch_inputs(cfg, 2)
    kw = {k: x2[k] for k in ("face_features", "face_mask", "name_ids", "name_mask")}
    args = (x2["input_ids"], x2["attention_mask"], x2["image_features"], cfg.bart, cfg.fusion)
    with torch.no_grad():
        card = F.mm_encoder_fwd(params, *args, add_ner_ffn=False, dtype=torch.bfloat16,
                                **kw)["last_hidden"]
        cpu_params = tree_to(params, "cpu", torch.float32)
        cpu_args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)
        ref = F.mm_encoder_fwd(cpu_params, *cpu_args, add_ner_ffn=False, dtype=torch.float32,
                               **{k: v.cpu() for k, v in kw.items()})["last_hidden"]
    e = rel_err(card.cpu(), ref)
    log(f"layerwise: encoder batch 2 on the card (bf16) vs the CPU (f32): rel err {e:.3e} "
        "(tol 5e-2)")
    if not e <= 5e-2:
        raise RuntimeError("layerwise: the card's layer-by-layer encoder disagrees with the CPU")
    return counts


def build_lines() -> list[str]:
    """Registers a thread, spill bytes and shared memory of the two 512-token
    self-attention kernels, the two gemm_bf16 kernels, the two layernorm
    kernels and the int8 and bf16 dec_cross_attention kernels at the slice's
    plans, from nvcc's -Xptxas -v output of this build. The dynamic shared
    memory is the launch's own (csrc/enc_attention.cu: ring + 4 S;
    csrc/flash_attn.cu: two stages of K, V and the padded bias tile; both
    + 1024 to align the tiles, computed here for S = 512; gemm: what the
    built library states for the shape; dec_cross: dec_cross_smem_bytes). A gemm,
    layernorm or dec_cross kernel that spills fails the run."""
    import re

    from vacnic_tpu_torch.kernels import _build
    from vacnic_tpu_torch.kernels import primitives as K

    dynamic = {"enc_self_attn_kernel": 4 * 8192 + 4 * 512 + 1024,
               "flash_attn_kernelIf": 2 * (2 * 8192 + 64 * 72 * 4) + 1024,
               "flash_attn_kernelI13__nv_bfloat16": 2 * (2 * 8192 + 64 * 72 * 2) + 1024,
               "gemm_large_kernel": K.gemm_smem_bytes(32 * 512, 1024, 1024),
               # the instance of three warpgroups: 160 rows
               "gemm_small_kernelILi3E": K.gemm_smem_bytes(160, 1024, 1024),
               "layernorm_warp_kernelILi8ELb1E": 0,  # d = 1024: eight float4 slots a lane
               "layernorm_block_kernelILb1E": 0,
               # int8 (signed char, "a") and bf16 K/V, five beams, S = 512
               "dec_cross_kernelIaLi5E": K.dec_cross_smem_bytes(5, 512, 1),
               "dec_cross_kernelI13__nv_bfloat16Li5E": K.dec_cross_smem_bytes(5, 512, 2)}
    if not _build.BUILD_LOG:
        return ["ptxas: the library was already built; no compiler output in this run"]
    text = "\n".join(_build.BUILD_LOG)
    lines = []
    for key, dyn in dynamic.items():
        m = re.search(r"Function properties for \S*" + re.escape(key) + r"\S*\n(.*)\n(.*)\n", text)
        if m is None:
            raise RuntimeError(f"build log has no ptxas lines for {key}")
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", m.group(1))
        regs = re.search(r"Used (\d+) registers", m.group(2))
        static = re.search(r"(\d+) bytes smem", m.group(2))
        lines.append(f"ptxas {key}: {regs.group(1)} registers/thread, spill stores "
                     f"{spill.group(1)} B, spill loads {spill.group(2)} B, static shared "
                     f"{static.group(1) if static else 0} B, dynamic shared {dyn} B a block")
        if key.startswith(("gemm_", "layernorm_", "dec_cross_")) and (
                int(spill.group(1)) or int(spill.group(2))):
            raise RuntimeError(f"{key} spills registers: {lines[-1]}")
    return lines


KERNEL_FAMILIES = (("gemm_large_kernel", "gemm_bf16 large_m"),
                   ("gemm_small_kernel", "gemm_bf16 small_m"), ("layernorm_", "layernorm"),
                   ("enc_self_attn", "enc_self_attention"),
                   ("enc_cross_attn", "enc_cross_attention"),
                   ("dec_self_attn", "dec_self_attention"),
                   ("dec_cross_kernel", "dec_cross_attention"), ("lm_stats_kernel", "lm_stats"),
                   ("flash_attn_kernel", "flash_attention"))


PROFILED_RUNS = (("slice", "profile.txt", {}), ("stats", "profile_stats.txt", {"lm_stats": True}),
                 ("layerwise", "profile_layerwise.txt", {"add_ner_ffn": False}))


def run_profile_phase(cfg, params, batch_size: int) -> None:
    """Where the time goes: the fused encoder alone (CUDA events), then one
    generate_mm of each path (slice, stats, layerwise) under torch.profiler
    -- device time by kernel family (the port's kernels vs PyTorch's own),
    the device's busy and idle share of the wall time. Full tables:
    chiprun_out/chip_smoke/profile*.txt."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vacnic_tpu_torch.infer.generate import generate_mm
    from vacnic_tpu_torch.models import fusion as F

    x = batch_inputs(cfg, batch_size)
    kw = {k: x[k] for k in ("face_features", "face_mask", "name_ids", "name_mask")}
    with torch.no_grad():
        enc_ms = time_ms(lambda: F.mm_encoder_fwd_fused(
            params, x["input_ids"], x["attention_mask"], x["image_features"], cfg.bart,
            cfg.fusion, dtype=torch.bfloat16, **kw), reps=3, warmup=1)
    log(f"profile: fused encoder alone, batch {batch_size}: {enc_ms:.1f} ms")
    for tag, fname, extra in PROFILED_RUNS:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            generate_mm(params, cfg=cfg.bart, fcfg=cfg.fusion, dcfg=cfg.decode,
                        dtype=torch.bfloat16, device="cuda", **extra, **x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name: dict[str, list[float]] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
        busy_ms = sum(sum(v) for v in by_name.values())
        fam: dict[str, float] = {}
        for name, times in by_name.items():
            key = next((f for pat, f in KERNEL_FAMILIES if pat in name), "pytorch (other)")
            fam[key] = fam.get(key, 0.0) + sum(times)
        rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
        with open(os.path.join(OUT_DIR, fname), "w") as f:
            f.write(f"{tag} wall_ms {wall_ms:.3f} device_busy_ms {busy_ms:.3f} "
                    f"fused_encoder_ms {enc_ms:.3f}\n")
            for name, times in rows:
                f.write(f"{sum(times):10.3f} ms {len(times):7d} x  {name[:160]}\n")
        if busy_ms == 0:
            log(f"profile {tag}: wall {wall_ms:.1f} ms; the profiler saw no device activity "
                "(device time not measured)")
            continue
        fams = ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(fam.items(), key=lambda kv: -kv[1]))
        log(f"profile {tag}: batch {batch_size} wall {wall_ms:.1f} ms; device busy {busy_ms:.1f} "
            f"ms ({100 * busy_ms / wall_ms:.1f}% of wall, idle "
            f"{100 * (1 - busy_ms / wall_ms):.1f}%); by family: {fams}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="build,kernels,dispatch,stacks,slice,stats,layerwise,profile")
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the GPU",
              file=sys.stderr)
        return 2
    try:
        from vacnic_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the vacnic_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)
    gpu = gpu_line()
    log(f"gpu: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {_build.library_path().name}")
    with open(os.path.join(OUT_DIR, "build.log"), "w") as f:
        f.write("\n".join(_build.BUILD_LOG))

    rows = run_kernels_phase() if "kernels" in phases else []
    if "dispatch" in phases:
        run_dispatch_phase()
    launches = {}  # kernel -> launches in the run of the path that names it
    if phases & {"stacks", "slice", "stats", "layerwise", "profile"}:
        cfg, params = full_model()
        if "stacks" in phases:
            run_stacks_phase(cfg, params)
        slice_seqs = None
        if "slice" in phases:
            counts, slice_seqs = run_slice_phase(cfg, params, args.batch)
            launches.update({k: counts[k] for k in SLICE_KERNELS +
                             ("gemm_bf16:large_m", "gemm_bf16:small_m", "layernorm:warp")})
        if "stats" in phases:
            if slice_seqs is None:
                slice_seqs = run_slice_phase(cfg, params, args.batch)[1]
            launches["lm_stats"] = run_stats_phase(cfg, params, args.batch,
                                                   slice_seqs)["lm_stats"]
        if "layerwise" in phases:
            launches["flash_attention"] = run_layerwise_phase(
                cfg, params, args.batch)["flash_attention"]
        if "profile" in phases:
            run_profile_phase(cfg, params, args.batch)
    for row in rows:
        row["launches"] = launches.get(row.pop("kernel"))
    if not rows:
        rows = [{"name": k, "route": "cuda", "source": SOURCES[k.split(":")[0]],
                 "replaces": REPLACES[k.split(":")[0]], "launches": n}
                for k, n in launches.items() if k != "gemm_bf16"]
    with open(os.path.join(OUT_DIR, "kernels.json"), "w") as f:
        json.dump(rows, f, indent=1)
    if "build" in phases:
        print("; ".join(build_lines()))
    print(json.dumps({"kernels": rows}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
