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
           130, 512, int8 and bf16, with an item whose keys are all masked;
           dec_self_attention (timed at pos 0, 31, 49 for each of its bf16,
           int8 and fp8 self caches) at BK 1, 5, 8, 37, 160, 640 x heads 4
           and 16, pos = T - 1 and a middle pos, a random ancestry, and int8
           with power-of-two scales against the bf16 kernel on the
           dequantized cache, which must be bit-identical. lm_head (timed at
           BK 160 x d 1024 x Vp 53248, beside two library columns:
           torch.addmm on an f32 copy of the head made once, and the default
           head decode_fast._lm_head as the step runs it, with its f32 cast
           of the tied weights; also timed at BK 5 and 640 beside addmm) at
           BK 1, 5, 37, 160, 320, 640 x Vp 4096 and 53248, and d 768.
           lm_stats (timed at BK 160, 5 and 640) at BK 1, 5, 37, 160, 320,
           640 x Vp 1024, 4096 and 53248, where m must equal the max of the
           kernel's own logits bit for bit and the arrival counters read
           zero after the launch; enc_cross_attention (timed at B 8 and 32)
           at KV 1, 8, 40, 64 x S 1, 63, 64, 130, 512. The rows of the two
           kernels redesigned in this slice log the times of the kernels
           before them (EARLIER), outside the kernels line. layernorm,
           dec_cross_attention, dec_self_attention, lm_head,
           enc_cross_attention and lm_stats must repeat bit-identically.
  accuracy enc_cross_attention at the slice's shape on three seeds against
           a float64 reference with the twin's rounding points, beside the
           plain twin and an emulation of the kernel's order of work: the
           outputs that differ from it in bf16, the worst distance in bf16
           ulps of the output and of the sum's scale (fails beyond 4 of
           the latter); the kernel against the emulation the same way
           (runs unchanged in an older tree).
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
           on the warp kernel), dec_cross_attention and dec_self_attention
           once a decoder layer a step (588, dec_self all on the bf16
           cache's kernel). Checks finite scores and a mean caption length
           >= 45.
  selfkv   the same run with self_kv="int8" and with self_kv="fp8" (the
           quantized self cache): dec_self_attention must launch 588 times
           on that cache's kernel; finite scores, mean length >= 45; token
           agreement with the slice and captions/s (not gated: random
           weights make the logits near-degenerate).
  stats    the same run with lm_stats=True (the fused LM-stats head):
           lm_stats must launch once per decode step; at one step its
           stage 2 must be exact on the kernel's own logits (top-C equal to
           top_k over logits[:, :V], lse within 1e-5 of torch.logsumexp);
           finite scores, mean length >= 45; token agreement with the slice.
  stackhead  the same run with lm_head="stack" (the LM head inside the
           decode stack, kernels/lm_head): lm_head must launch once per
           decode step; at one step its logits[:, :V] must match the default
           head decode_fast._lm_head on that step's x_out (f32 tolerance);
           finite scores, mean length >= 45; token agreement with the slice
           and captions/s (not gated).
  layerwise  generate_mm(add_ner_ffn=False): the layer-by-layer encoder,
           whose 512-token self-attention is flash_attention (12 launches a
           pass), then the decode kernels; get_prob at batch 8 x S 512
           (flash again in its text encoder); and the layer-by-layer encoder
           at batch 2 on the card (bf16) against the same encoder in f32 on
           the CPU (relative error <= 5e-2).
  serve    the serving entry point (vacnic_tpu_torch/serve.py) on the
           slice's config. Checkpoints: the slice's tree and a seeded
           ViT-B/16 CLIP tree written under the reference's names and torch
           layouts (model.-prefixed (out, in) weights; OpenAI visual.* with
           in_proj_weight packed and conv1 OIHW), as a torch.save .bin and as
           .safetensors (a writer of a few lines here), loaded by
           weights_io.load_state_dict and converted back: every leaf must be
           bit-identical. CaptionService(device="cuda") on the converted trees
           behind make_http_server: 32 HTTP requests from 32 threads must
           come back token- and score-identical to a direct generate_mm of
           the same batch, with every kernel launched at the slice's counts
           (zeroed just before the requests, read just after);
           input_kind="pixels" at batch 8 identical to clip_vision_fwd +
           generate_mm. Readings, not gated: the CLIP tower's ms at batch 8
           and 32; with buckets (1, 8, 32) after precompile(), b1 latency
           (median, p95 of 10 sequential requests), captions/s of a burst of
           256 requests over HTTP, of the same rows submitted in-process and
           of eight direct generate_mm calls of 32 on them, and stats().
  profile  the fused encoder alone, then one more run of each of the slice,
           selfkv (int8, fp8), stats, stackhead and layerwise paths under
           torch.profiler: device time by kernel family (dec_self_attention
           by cache type), busy/idle share, and PyTorch's own device time
           split by op (the top aten ops by self device time).
  train    the training step at full width (VacnicConfig.full_train() as
           released: batch 32, S 512, caption 100, bf16 over f32, remat,
           dropout 0.1, CoLaM with the teacher's forward, SECLA, CLIP frozen
           on pixels; random f32 trees from seed 0), after the trees above
           are freed: 4 steps of make_train_step (finite metrics, lr 0 at
           step 0, the CLIP tower and teacher bit-unchanged), step 1's
           launches (flash_attention 12 from the teacher, nothing else),
           remat on/off with dropout at batch 8, eval_step through the fused
           encoder against allow_fused_encoder=False, a CheckpointManager
           round trip (the next steps bit-identical), and readings: state
           bytes, peak memory, step ms, samples/s, save/restore seconds and
           one step under torch.profiler (profile_train.txt).

--tokens-out FILE saves every path's captions; --tokens-ref FILE holds every
path of this run token-identical to captions another tree saved (copy this
file into that tree and run it there with --tokens-out first).

Prints the registers, spills and shared memory of the two 512-token
self-attention kernels, the encoder's cross-attention, the two gemm_bf16,
two layernorm, two dec_cross_attention, three dec_self_attention, four
lm_head and four lm_stats kernels (from nvcc's output of this build; a spill
in any but the 512-token self-attention kernels fails the run), a JSON line
with
every kernel, the card's name and power limit (nvidia-smi), and last `{"ok": true, "device": {...}}`. Exits non-zero, printing
no result, when a phase fails or there is no CUDA device. Long logs go to
chiprun_out/chip_smoke/.

Tolerances, by each output's dtype: bf16 outputs are held to
|err| <= 2e-2 + 2e-2 * |plain| (one bf16 rounding of values up to a few
units, plus f32 sum-order noise); f32 outputs of the GEMM, LayerNorm,
LM-stats head and LM head to |err| <= 2e-3 + 2e-3 * |plain|.
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
PEAK_8BIT_OPS = 1979e12   # int8 / fp8 tensor-core rate
PEAK_BYTES = 3.35e12      # HBM3
OUT_DIR = os.path.join("chiprun_out", "chip_smoke")
TOKENS: dict = {}  # path -> its captions [B, max_length] (int64, on the CPU)

SOURCES = {
    "gemm_bf16": "vacnic_tpu_torch/kernels/csrc/gemm_bf16.cu",
    "layernorm": "vacnic_tpu_torch/kernels/csrc/layernorm.cu",
    "enc_self_attention": "vacnic_tpu_torch/kernels/csrc/enc_attention.cu",
    "enc_cross_attention": "vacnic_tpu_torch/kernels/csrc/enc_attention.cu",
    "dec_self_attention": "vacnic_tpu_torch/kernels/csrc/dec_attention.cu",
    "dec_cross_attention": "vacnic_tpu_torch/kernels/csrc/dec_cross_attention.cu",
    "lm_stats": "vacnic_tpu_torch/kernels/csrc/lm_head.cu",
    "flash_attention": "vacnic_tpu_torch/kernels/csrc/flash_attn.cu",
    "lm_head": "vacnic_tpu_torch/kernels/csrc/lm_head.cu",
}
REPLACES = {
    "gemm_bf16": "vacnic_tpu/kernels/encoder_stack.py:103 (_kernel matmuls); "
                 "vacnic_tpu/kernels/decode_layer.py:136 (_kernel matmuls)",
    "layernorm": "vacnic_tpu/kernels/encoder_stack.py:139 (ln); "
                 "vacnic_tpu/kernels/decode_layer.py:235 (ln)",
    "enc_self_attention": "vacnic_tpu/kernels/encoder_stack.py:160 (self-attention)",
    "enc_cross_attention": "vacnic_tpu/kernels/encoder_stack.py:197 (cross-attention)",
    "dec_self_attention": "vacnic_tpu/kernels/decode_layer.py:314 (_self_attn; int8 self "
                          "cache :393-409, :454-462; fp8 store :330-339)",
    "dec_cross_attention": "vacnic_tpu/kernels/decode_layer.py:499 (_cross_attn)",
    "lm_stats": "vacnic_tpu/kernels/lm_stats.py:76 (lm_stats; _kernel :44)",
    "flash_attention": "vacnic_tpu/kernels/flash_attn.py:65 (flash_attention; _flash_kernel :28)",
    "lm_head": "vacnic_tpu/kernels/decode_layer.py:643-650 (_lm_head, the n_lm > 0 grid "
               "iteration of decode_stack :653)",
}
SLICE_KERNELS = ("gemm_bf16", "layernorm", "enc_self_attention", "enc_cross_attention",
                 "dec_self_attention", "dec_cross_attention")
DECODE_KERNELS = ("gemm_bf16", "layernorm", "dec_self_attention", "dec_cross_attention")
SELF_KV_KINDS = ("int8", "fp8")


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

    def enc_cross_case(bsz):  # B = 32 is the slice's own shape
        q = rn(bsz * S, d, dtype=bf)
        ck, cv = rn(bsz, d, KV, dtype=bf), rn(bsz, KV, d, dtype=bf)
        return (f"enc_cross_attention B={bsz} S={S} KV={KV}", "enc_cross_attention",
                lambda: K.enc_cross_attention(q, ck, cv, bsz, S, H),
                lambda: K.enc_cross_attention_plain(q, ck, cv, bsz, S, H),
                (2 * bsz * S * d + 2 * bsz * KV * d) * 2, 4.0 * bsz * S * KV * d, PEAK_BF16_FLOPS,
                lambda: Fn.scaled_dot_product_attention(
                    q.view(bsz, S, H, 64).transpose(1, 2), ck.view(bsz, H, 64, KV).transpose(2, 3),
                    cv.view(bsz, KV, H, 64).transpose(1, 2)))

    cases += [enc_cross_case(B), enc_cross_case(32)]
    # correctness only: KV 1 ... 64 x S 1 ... 512 (ragged last q tiles)
    for kv_c, s_c in itertools.product((1, 8, 40, 64), (1, 63, 64, 130, 512)):
        cases.append(enc_cross_sweep_case(rn, 3, s_c, kv_c))

    BK, T, B2, beams = 160, 64, 32, 5
    qkv_d = rn(BK, 3 * d, dtype=bf)
    item = torch.arange(BK, device=dev) // beams
    anc = (item[None, :] * beams + torch.randint(0, beams, (T, BK), device=dev, generator=g)
           ).to(torch.int32).contiguous()
    for kind in ("bf16",) + SELF_KV_KINDS:
        ck_c, cv_c, ks_c, vs_c = self_cache(rn, g, T, BK, H, kind)
        elem = ck_c.element_size()
        for pos in (0, 31, 49):
            # the rows the ancestry reaches, each read once (with its scales for int8)
            n_rows = int(torch.unique(torch.arange(pos, device=dev)[:, None] * BK
                                      + anc[:pos].long()).numel()) if pos else 0
            byts = (BK * 3 * d * 2 + 2 * n_rows * d * elem + pos * BK * 4 + BK * d * 2
                    + (2 * n_rows * H * 4 if ks_c is not None else 0))
            cases.append((f"dec_self_attention {kind} BK={BK} T={T} pos={pos}",
                          f"dec_self_attention:{kind}",
                          lambda pos=pos, c=(ck_c, cv_c, anc), s=(ks_c, vs_c):
                          K.dec_self_attention(qkv_d, *c, pos, H, *s),
                          lambda pos=pos, c=(ck_c, cv_c, anc), s=(ks_c, vs_c):
                          K.dec_self_attention_plain(qkv_d, *c, pos, H, *s),
                          byts, 4.0 * BK * d * (pos + 1),
                          PEAK_BF16_FLOPS if kind == "bf16" else PEAK_8BIT_OPS, None))
    # correctness only: every cache type at BK 1 ... 640 x heads 4 and 16, a
    # middle pos and pos = T - 1, an ancestry over all rows
    for kind, (bk_c, h_c) in itertools.product(("bf16",) + SELF_KV_KINDS,
                                               ((1, 4), (5, 16), (8, 4), (37, 4), (160, 16),
                                                (640, 16))):
        cases += [dec_self_case(rn, g, bk_c, h_c, T, pos, kind) for pos in (T // 2 - 1, T - 1)]
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
    for bk_t in (BK, 5, 640):  # the stats path's batch 32, batch 1 and batch 128 at beam 5
        xt = x_lm if bk_t == BK else rn(bk_t, d, dtype=bf)
        cases.append((f"lm_stats BK={bk_t} d={d} Vp={Vp}", "lm_stats",
                      lambda xt=xt: LS.lm_stats(xt, w_lm, b_lm),
                      lambda xt=xt: LS.lm_stats_plain(xt, w_lm, b_lm),
                      bk_t * d * 2 + Vp * d * 2 + Vp * 4 + bk_t * Vp * 4 + 2 * bk_t * nvb * 4,
                      2.0 * bk_t * Vp * d, PEAK_BF16_FLOPS, None))
    # correctness only: ragged BK, one to three passes, a head with one
    # 1024-block, Vp 53248's two all-pad blocks; m must be the max of the
    # kernel's own logits and the counters zero after it
    for bk_c, vp_c in itertools.product((1, 5, 37, 160, 320, 640), (1024, 4096, Vp)):
        xc = rn(bk_c, d, dtype=bf)
        cases.append((f"lm_stats BK={bk_c} d={d} Vp={vp_c}", "lm_stats",
                      lambda xc=xc, vp_c=vp_c: lm_stats_checked(xc, w_lm[:vp_c], b_lm[:vp_c]),
                      lambda xc=xc, vp_c=vp_c: LS.lm_stats_plain(xc, w_lm[:vp_c], b_lm[:vp_c]),
                      None, 0.0, PEAK_BF16_FLOPS, None))

    from vacnic_tpu_torch.infer import decode_fast as DF
    from vacnic_tpu_torch.kernels import lm_head as LH

    w32 = w_lm.float()  # the library call's f32 head, made once outside the timing
    tied = {"shared": {"weight": w_lm[:V]}, "final_logits_bias": b_lm[:V].to(bf)}  # bf16 params
    cases.append((f"lm_head BK={BK} d={d} Vp={Vp}", "lm_head",
                  lambda: LH.lm_head(x_lm, w_lm, b_lm), lambda: LH.lm_head_plain(x_lm, w_lm, b_lm),
                  BK * d * 2 + Vp * d * 2 + Vp * 4 + BK * Vp * 4, 2.0 * BK * Vp * d,
                  PEAK_BF16_FLOPS, lambda: torch.addmm(b_lm, x_lm.float(), w32.t()),
                  ("decode_fast._lm_head: the default head as the step runs it (f32 cast of "
                   "the tied weights, f32 product over V)", lambda: DF._lm_head(tied, x_lm, bf))))
    for bk_t in (5, 640):  # batch 1 and batch 128 at beam 5: x nearly free, and three passes
        xt = rn(bk_t, d, dtype=bf)
        cases.append((f"lm_head BK={bk_t} d={d} Vp={Vp}", "lm_head",
                      lambda xt=xt: LH.lm_head(xt, w_lm, b_lm),
                      lambda xt=xt: LH.lm_head_plain(xt, w_lm, b_lm),
                      bk_t * d * 2 + Vp * d * 2 + Vp * 4 + bk_t * Vp * 4, 2.0 * bk_t * Vp * d,
                      PEAK_BF16_FLOPS, lambda xt=xt: torch.addmm(b_lm, xt.float(), w32.t())))
    # correctness only: ragged BK, one and three passes of 256, a small head, d 768
    for bk_c, vp_c in itertools.product((1, 5, 37, 160, 320, 640), (4096, Vp)):
        xc = rn(bk_c, d, dtype=bf)
        cases.append((f"lm_head BK={bk_c} d={d} Vp={vp_c}", "lm_head",
                      lambda xc=xc, vp_c=vp_c: LH.lm_head(xc, w_lm[:vp_c], b_lm[:vp_c]),
                      lambda xc=xc, vp_c=vp_c: LH.lm_head_plain(xc, w_lm[:vp_c], b_lm[:vp_c]),
                      None, 0.0, PEAK_BF16_FLOPS, None))
    x768, w768, b768 = rn(BK, 768, dtype=bf), rn(4096, 768, std=0.02, dtype=bf), rn(4096)
    cases.append((f"lm_head BK={BK} d=768 Vp=4096", "lm_head",
                  lambda: LH.lm_head(x768, w768, b768), lambda: LH.lm_head_plain(x768, w768, b768),
                  None, 0.0, PEAK_BF16_FLOPS, None))

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


def enc_cross_sweep_case(rn, items: int, s_len: int, kv: int, heads: int = 16):
    """A correctness-only enc_cross_attention case."""
    import torch

    from vacnic_tpu_torch.kernels import primitives as K

    d = heads * 64
    q = rn(items * s_len, d, dtype=torch.bfloat16)
    ck, cv = rn(items, d, kv, dtype=torch.bfloat16), rn(items, kv, d, dtype=torch.bfloat16)
    return (f"enc_cross_attention B={items} S={s_len} KV={kv} H={heads}", "enc_cross_attention",
            lambda: K.enc_cross_attention(q, ck, cv, items, s_len, heads),
            lambda: K.enc_cross_attention_plain(q, ck, cv, items, s_len, heads),
            None, 0.0, PEAK_BF16_FLOPS, None)


def lm_stats_checked(x, w, b):
    """lm_stats, raising unless m is the max of the kernel's own logits over
    each 1024-block, bit for bit, and the arrival counters read zero after
    the launch."""
    import torch

    from vacnic_tpu_torch.kernels import lm_stats as LS

    logits, m, s = LS.lm_stats(x, w, b)
    counters = LS.counters(x.device)
    if not torch.equal(m, logits.view(logits.shape[0], -1, LS.VBLOCK).amax(-1)):
        raise RuntimeError("lm_stats: m is not the max of the kernel's logits")
    if bool(counters.any()):
        raise RuntimeError("lm_stats: an arrival counter is not zero after the launch")
    return logits, m, s


def self_cache(rn, g, t_len: int, bk: int, heads: int, kind: str):
    """A dec_self_attention cache [T, BK, heads * 64] of the kind: bf16, int8
    with per-row scales [T, BK, heads] f32, or fp8 e4m3 of values up to a
    few units -> (K, V, K scales or None, V scales or None)."""
    import torch

    shape = (t_len, bk, heads * 64)
    if kind == "int8":
        kk, vv = (torch.randint(-127, 128, shape, device="cuda", generator=g).to(torch.int8)
                  for _ in range(2))
        ks, vs = (rn(t_len, bk, heads, std=0.01).abs() + 1e-3 for _ in range(2))
        return kk, vv, ks, vs
    if kind == "fp8":
        return (*(rn(*shape, std=2.0).clamp(-448, 448).to(torch.float8_e4m3fn)
                  for _ in range(2)), None, None)
    return rn(*shape, dtype=torch.bfloat16), rn(*shape, dtype=torch.bfloat16), None, None


def dec_self_case(rn, g, bk: int, heads: int, t_len: int, pos: int, kind: str):
    """A correctness-only dec_self_attention case over an ancestry that
    reaches any row."""
    import torch

    from vacnic_tpu_torch.kernels import primitives as K

    qkv = rn(bk, 3 * heads * 64, dtype=torch.bfloat16)
    ck, cv, ks, vs = self_cache(rn, g, t_len, bk, heads, kind)
    anc = torch.randint(0, bk, (t_len, bk), device="cuda", generator=g).to(torch.int32)
    return (f"dec_self_attention {kind} BK={bk} H={heads} T={t_len} pos={pos}",
            f"dec_self_attention:{kind}",
            lambda: K.dec_self_attention(qkv, ck, cv, anc, pos, heads, ks, vs),
            lambda: K.dec_self_attention_plain(qkv, ck, cv, anc, pos, heads, ks, vs),
            None, 0.0, PEAK_BF16_FLOPS, None)


def dec_self_pow2_identity() -> str | None:
    """int8 with power-of-two scales against the bf16 kernel on the
    dequantized cache, at the main path's shape: must be bit-identical.
    -> None, or what differed."""
    import torch

    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device="cuda").manual_seed(77)
    t_len, bk, heads = 64, 160, 16

    def rn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)

    qkv = rn(bk, 3 * heads * 64, dtype=torch.bfloat16)
    ck, cv, _, _ = self_cache(rn, g, t_len, bk, heads, "int8")
    ks, vs = (torch.exp2(torch.randint(-3, 3, (t_len, bk, heads), device="cuda",
                                       generator=g).float()) for _ in range(2))
    deq = [(c.float().view(t_len, bk, heads, 64) * s[..., None]).view(c.shape).to(torch.bfloat16)
           for c, s in ((ck, ks), (cv, vs))]
    item = torch.arange(bk, device="cuda") // 5
    anc = (item[None, :] * 5 + torch.randint(0, 5, (t_len, bk), device="cuda", generator=g)
           ).to(torch.int32)
    for pos in (0, 1, 31, 49, 63):
        a = K.dec_self_attention(qkv, ck, cv, anc, pos, heads, ks, vs)
        b = K.dec_self_attention(qkv, *deq, anc, pos, heads)
        if not torch.equal(a, b):
            return f"pos {pos}: max |int8 - bf16| {float((a.float() - b.float()).abs().max()):.3e}"
    return None


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


# checked bit-identical over two calls
REPEATABLE = ("layernorm", "dec_cross_attention", "dec_self_attention", "lm_head",
              "enc_cross_attention", "lm_stats")
# the times of the kernels a redesign replaced, logged beside the new ones
# and kept out of the kernels line, which holds only this run's numbers
# (this script's kernels phase on an NVIDIA H100 80GB HBM3, 700.00 W;
# ms / graph ms)
EARLIER = {
    "enc_cross_attention B=8 S=512 KV=40": "the thread-a-row kernel before: 0.1032 / 0.1000",
    "enc_cross_attention B=32 S=512 KV=40": "the thread-a-row kernel before: 0.4775 / 0.4720",
    "lm_stats BK=160 d=1024 Vp=53248": "the WMMA kernel before (lm_stats.cu): 0.1644 / 0.1613",
}


def run_kernels_phase():
    import torch

    rows = []
    failures = []
    for name, kern, call, plain, byts, ops, peak, lib, *second in kernel_cases():
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
        if family == "lm_head":
            row["library"] = "torch.addmm on an f32 copy of w_lm made once"
        for label, fn in second:  # a second PyTorch yardstick beside the library call
            row.update(second=label, second_ms=time_ms(fn, reps),
                       second_graph_ms=graph_ms(fn, reps))
        rows.append(row)
        log(f"kernel {name}: max_abs_err {', '.join(errs)} {'ok' if ok else 'FAIL'}; ms {ms:.4f} "
            f"graph_ms {g_ms:.4f} plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms {lib_ms} "
            f"library_graph_ms {lib_g_ms}"
            + (f"; earlier {EARLIER[name]}" if name in EARLIER else "") + "".join(
                f"; {row['second']}: ms {row['second_ms']:.4f} "
                f"graph_ms {row['second_graph_ms']:.4f}" for _ in second))
        if not ok:
            failures.append(name)
    pow2 = dec_self_pow2_identity()
    log("kernel dec_self_attention int8 with power-of-two scales vs bf16 on the dequantized "
        f"cache, BK=160 H=16 T=64 pos 0/1/31/49/63: {pow2 or 'bit-identical ok'}")
    if pow2:
        failures.append("dec_self_attention int8 power-of-two identity")
    if failures:
        raise RuntimeError(f"kernels disagree with their plain twins: {failures}")
    return rows


def enc_cross_tiles(q, ck, cv, batch: int, seq: int, heads: int):
    """enc_cross_attn_kernel's order of work in f32 PyTorch on the inputs'
    device: q scaled and rounded to bf16, S = q K^T over keys zero-padded to
    64 and masked to -inf past KV, exp(s - m) times the reciprocal of the
    row sum rounded to bf16, P V one 16-key k-step after another, rounded
    once. (The q tiles only group rows; no row reads another.)"""
    import torch

    bf, kv = torch.bfloat16, cv.shape[1]
    qh = (q.view(batch, seq, heads, 64).transpose(1, 2).float() * 64 ** -0.5).to(bf).float()
    k_pad = q.new_zeros(batch, heads, 64, 64, dtype=torch.float32)
    k_pad[..., :kv] = ck.float().view(batch, heads, 64, kv)
    v_pad = q.new_zeros(batch, heads, 64, 64, dtype=torch.float32)
    v_pad[:, :, :kv] = cv.float().view(batch, kv, heads, 64).transpose(1, 2)
    sc = torch.matmul(qh, k_pad)
    sc[..., kv:] = float("-inf")
    e = torch.exp(sc - sc.amax(-1, keepdim=True))
    pr = (e * (1.0 / e.sum(-1, keepdim=True))).to(bf).float()
    o = torch.zeros_like(qh)
    for c in range(0, 64, 16):
        o = o + torch.matmul(pr[..., c:c + 16], v_pad[:, :, c:c + 16])
    return o.to(bf).transpose(1, 2).reshape(batch * seq, heads * 64)


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (eight significant bits)."""
    import torch

    return torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)


def enc_cross_reference(q, ck, cv, batch: int, seq: int, heads: int):
    """The float64 cross-attention with the twin's rounding points (q scaled
    and rounded to bf16, the normalised probabilities rounded to bf16, the
    output not rounded) -> (reference, the sum's scale sum_j p_j |v_j|),
    both [B*S, d] float64."""
    import torch

    bf, kv, d = torch.bfloat16, cv.shape[1], heads * 64
    qh = (q.view(batch, seq, heads, 64).double() * 64 ** -0.5).to(bf).double()
    s = torch.einsum("bshd,bhdk->bhsk", qh, ck.view(batch, heads, 64, kv).double())
    p = torch.softmax(s, dim=-1).to(bf).double()
    vh = cv.view(batch, kv, heads, 64).double()
    return (torch.einsum("bhsk,bkhd->bshd", p, vh).reshape(batch * seq, d),
            torch.einsum("bhsk,bkhd->bshd", p, vh.abs()).reshape(batch * seq, d))


def run_accuracy_phase(gpu: str) -> None:
    """enc_cross_attention at the slice's shape (B 32, S 512, KV 40, H 16)
    on three seeds, against a float64 reference with the twin's rounding
    points (q scaled and rounded to bf16, the normalised probabilities
    rounded to bf16, the output rounded once). For the kernel, the plain
    twin (f32) and an emulation of the tensor-core kernel's order of work
    (enc_cross_tiles, f32 on the card): the outputs that differ from the
    reference rounded to bf16, and the largest absolute difference from it;
    the largest distance from the reference in bf16 ulps of the reference,
    with the |reference| and the sum's scale sum_j p_j |v_j| where it falls
    (a near-zero output of a cancelling sum reads thousands of ulps from
    one last-bit change of a term); and the largest distance in bf16 ulps
    of that scale, which is what the output's rounding (at most half), a
    sum in another order (far below one) and a probability rounded the
    other way at a bf16 tie (at most two, mostly below one) can move an
    output by, while a wrong key, mask or k-step moves it by tens to
    hundreds. The kernel fails the phase beyond 4 such ulps. The kernel
    against the emulation is read the same way. Uses only
    the wrappers' interface, so this file run in an older tree measures
    that tree's kernel on the same inputs (`--phases accuracy`)."""
    import torch

    from vacnic_tpu_torch.kernels import primitives as K

    bf, (B, S, KV, H) = torch.bfloat16, (32, 512, 40, 16)
    d = H * 64
    worst_scaled, limit = 0.0, 4.0
    for seed in (8, 9, 10):
        g = torch.Generator(device="cuda").manual_seed(seed)

        def rn(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(bf)

        q, ck, cv = rn(B * S, d), rn(B, d, KV), rn(B, KV, d)
        out = K.enc_cross_attention(q, ck, cv, B, S, H)
        twin = K.enc_cross_attention_plain(q, ck, cv, B, S, H)
        emul = enc_cross_tiles(q, ck, cv, B, S, H)
        ref, scale = enc_cross_reference(q, ck, cv, B, S, H)
        ulp_ref, ulp_scale = bf16_ulp(ref), bf16_ulp(scale)
        for name, t, against in (("kernel", out, ref), ("plain twin", twin, ref),
                                 ("order-of-work emulation", emul, ref),
                                 ("kernel against the emulation", out, emul.double())):
            e = (t.double() - against).abs()
            e_bf = (t.double() - against.to(bf).double()).abs()
            differ = int((e_bf != 0).sum())
            raw = e / ulp_ref
            at = int(raw.argmax())
            scaled = float((e / ulp_scale).max())
            if name == "kernel":
                worst_scaled = max(worst_scaled, scaled)
            log(f"accuracy enc_cross_attention B={B} S={S} KV={KV} H={H} seed {seed}, {name}: "
                f"{differ} of {ref.numel()} outputs ({100.0 * differ / ref.numel():.4f}%) differ "
                f"{'from it' if 'against' in name else 'from the float64 reference rounded to bf16'}"
                f", by at most {float(e_bf.max()):.3e}; worst {float(raw.view(-1)[at]):.1f} "
                f"bf16 ulps of the reference, at |ref| {float(ref.view(-1)[at].abs()):.3e} with "
                f"scale {float(scale.view(-1)[at]):.3e}; worst {scaled:.3f} bf16 ulps of the "
                f"scale ({gpu})")
    if not worst_scaled <= limit:
        raise RuntimeError(f"accuracy: enc_cross_attention is {worst_scaled:.3f} bf16 ulps of "
                           f"the sum's scale from the float64 reference (limit {limit})")


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
    nonpad = check_captions("slice", cfg, seqs, scores, batch_size)
    TOKENS["slice"] = seqs.cpu()
    log(f"slice: full_train beam {cfg.decode.num_beams} x {cfg.decode.max_length} x lp "
        f"{cfg.decode.length_penalty}, batch {batch_size}: {dt:.3f} s, "
        f"{batch_size / dt:.2f} captions/s, mean non-pad length {nonpad:.1f}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{K.launch_counts()}")
    return check_slice_counts("slice", cfg), seqs


def check_slice_counts(tag: str, cfg) -> dict:
    """The launch counts since the last reset, held to one batch of the
    slice's path (the fused encoder, then every decode step on the bf16
    self cache) -> the counts with the per-kernel splits added."""
    from vacnic_tpu_torch.kernels import primitives as K

    counts = K.launch_counts()
    by_kernel = K.gemm_variant_counts()
    ln_by_kernel = K.layernorm_variant_counts()
    self_by_kind = K.dec_self_variant_counts()
    check_launched(tag, counts, SLICE_KERNELS)
    log(f"{tag}: gemm_bf16 by kernel {by_kernel}")
    enc_products = 6 * cfg.bart.encoder_layers  # M = batch x 512 rows; decode has batch x 5
    if by_kernel != {"large_m": enc_products, "small_m": counts["gemm_bf16"] - enc_products}:
        raise RuntimeError(f"{tag}: gemm_bf16 kernels {by_kernel}: expected {enc_products} "
                           "large_m launches (the encoder's) and small_m for the rest")
    counts.update({f"gemm_bf16:{v}": n for v, n in by_kernel.items()})
    # one launch a call: three layer norms an encoder layer and a decoder
    # layer a step, one cross-attention a decoder layer a step; d = 1024 is
    # the register-resident kernel's
    steps = cfg.decode.max_length - 1  # min_length = max_length - 1: every step runs
    dec_layers = cfg.bart.decoder_layers
    want = {"layernorm": 3 * cfg.bart.encoder_layers + 3 * dec_layers * steps,
            "dec_cross_attention": dec_layers * steps, "dec_self_attention": dec_layers * steps}
    log(f"{tag}: layernorm by kernel {ln_by_kernel}, dec_self_attention by cache {self_by_kind}; "
        f"expected {want}")
    if any(counts[k] != n for k, n in want.items()) or ln_by_kernel != {
            "warp": want["layernorm"], "block": 0} or self_by_kind != {
            "bf16": want["dec_self_attention"], "int8": 0, "fp8": 0}:
        raise RuntimeError(f"{tag}: launches {counts}, layernorm by kernel {ln_by_kernel}, "
                           f"dec_self_attention by cache {self_by_kind}: expected {want}, all "
                           "layernorm launches the warp kernel's, all dec_self the bf16 cache's")
    counts.update({f"layernorm:{v}": n for v, n in ln_by_kernel.items()})
    counts.update({f"dec_self_attention:{v}": n for v, n in self_by_kind.items()})
    return counts


def run_selfkv_phase(cfg, params, batch_size: int, ref_seqs, gpu: str) -> dict:
    """generate_mm(self_kv=...) for the int8 and the fp8 self cache: every
    dec_self_attention launch on that cache's kernel, one a decoder layer a
    step; finite scores, mean length >= 45. Token agreement with the slice
    and captions/s are printed, not gated."""
    import torch

    from vacnic_tpu_torch.infer.generate import generate_mm
    from vacnic_tpu_torch.kernels import primitives as K

    x = batch_inputs(cfg, batch_size)
    want = cfg.bart.decoder_layers * (cfg.decode.max_length - 1)
    launches = {}
    for kind in SELF_KV_KINDS:
        def run():
            seqs, scores = generate_mm(params, cfg=cfg.bart, fcfg=cfg.fusion, dcfg=cfg.decode,
                                       dtype=torch.bfloat16, device="cuda", self_kv=kind, **x)
            torch.cuda.synchronize()
            return seqs, scores

        run()  # warm-up
        K.reset_launch_counts()
        t0 = time.perf_counter()
        seqs, scores = run()
        dt = time.perf_counter() - t0
        counts, by_kind = K.launch_counts(), K.dec_self_variant_counts()
        nonpad = check_captions(f"selfkv {kind}", cfg, seqs, scores, batch_size)
        TOKENS[f"selfkv {kind}"] = seqs.cpu()
        agree = float((seqs == ref_seqs).float().mean())
        log(f"selfkv {kind}: self_kv={kind!r}, batch {batch_size}: {dt:.3f} s, "
            f"{batch_size / dt:.2f} captions/s, mean non-pad length {nonpad:.1f}, token "
            f"agreement with the slice {agree:.4f} ({gpu}); dec_self_attention by cache "
            f"{by_kind}; launches {counts}")
        check_launched(f"selfkv {kind}", counts, DECODE_KERNELS)
        if by_kind != {v: (want if v == kind else 0) for v in K.DEC_SELF_VARIANTS}:
            raise RuntimeError(f"selfkv {kind}: dec_self_attention by cache {by_kind}, expected "
                               f"{want} launches of the {kind} kernel only")
        launches[f"dec_self_attention:{kind}"] = by_kind[kind]
    return launches


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
    TOKENS["stats"] = seqs.cpu()
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


def run_stackhead_phase(cfg, params, batch_size: int, ref_seqs):
    """generate_mm(lm_head="stack"): the LM head inside the decode stack
    (kernels/lm_head). One step's logits are held against the default head
    on the same step's x_out, the bf16 copy the stack head multiplies."""
    import torch

    from vacnic_tpu_torch.infer import decode_fast as DF
    from vacnic_tpu_torch.infer.generate import generate_mm
    from vacnic_tpu_torch.kernels import decode_layer as DL
    from vacnic_tpu_torch.kernels import primitives as K

    x = batch_inputs(cfg, batch_size)
    vocab = params["shared"]["weight"].shape[0]
    real = DL.decode_stack
    steps, seen = [], {}

    def spy(*a, **kw):  # counts the steps, keeps one step's outputs
        out = real(*a, **kw)
        steps.append(1)
        if len(steps) == 4:
            seen["out"] = out
        return out

    def run():
        seqs, scores = generate_mm(params, cfg=cfg.bart, fcfg=cfg.fusion, dcfg=cfg.decode,
                                   dtype=torch.bfloat16, device="cuda", lm_head="stack", **x)
        torch.cuda.synchronize()
        return seqs, scores

    DL.decode_stack = spy
    try:
        run()  # warm-up
        steps.clear()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        seqs, scores = run()
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
    finally:
        DL.decode_stack = real
    nonpad = check_captions("stackhead", cfg, seqs, scores, batch_size)
    TOKENS["stackhead"] = seqs.cpu()
    agree = float((seqs == ref_seqs).float().mean())
    logits_p, x_out = seen["out"][:2]
    ref = DF._lm_head(params, x_out.to(torch.bfloat16), torch.bfloat16)
    err = (logits_p[:, :vocab] - ref).abs()
    ok = bool(torch.isfinite(logits_p).all()) and bool((err <= 2e-3 + 2e-3 * ref.abs()).all())
    log(f"stackhead: lm_head=\"stack\", batch {batch_size}: {dt:.3f} s, {batch_size / dt:.2f} "
        f"captions/s, mean non-pad length {nonpad:.1f}, {len(steps)} decode steps, token "
        f"agreement with the slice {agree:.4f}; step-4 logits[:, :V] vs the default head on its "
        f"x_out: max abs err {float(err.max()):.3e} (tol 2e-3+2e-3*|ref|) "
        f"{'ok' if ok else 'FAIL'}; launches {counts}")
    check_launched("stackhead", counts, SLICE_KERNELS + ("lm_head",))
    if counts["lm_head"] != len(steps):
        raise RuntimeError(f"stackhead: lm_head launched {counts['lm_head']} times over "
                           f"{len(steps)} decode steps")
    if not ok:
        raise RuntimeError("stackhead: the stack head's logits disagree with the default head's")
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
    TOKENS["layerwise"] = seqs.cpu()
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


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

# tree key -> the reference module's member name, where they differ
# (models/weights_io.convert_multimodal_bart's docstring)
MEMBER_NAMES = {"img_up": "_linear_1up", "img_down": "_linear_1down", "face_up": "_face_up",
                "face_down": "_face_down", "face_proj": "_linear_1"}
SAFETENSORS_NAMES = {"float32": "F32", "float16": "F16", "bfloat16": "BF16", "float64": "F64",
                     "int64": "I64", "int32": "I32", "int8": "I8", "uint8": "U8", "bool": "BOOL"}


def _export(sd: dict, name: str, p) -> None:
    """One node of a parameter tree under its torch name, on the CPU: a
    linear ([in, out] kernel -> (out, in) weight), a layer norm, an
    embedding, or a dict of them (an attention's four linears)."""
    if "kernel" in p:
        sd[f"{name}.weight"] = p["kernel"].detach().t().contiguous().cpu()
        if "bias" in p:
            sd[f"{name}.bias"] = p["bias"].detach().cpu()
    elif "scale" in p:
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["scale"].detach().cpu(), p["bias"].detach().cpu()
    elif "weight" in p:
        sd[f"{name}.weight"] = p["weight"].detach().cpu()
    else:
        for key, sub in p.items():
            _export(sd, f"{name}.{key}", sub)


def reference_state_dict(tree) -> dict:
    """models/fusion.py tree -> the reference BartForMultiModalGeneration's
    state dict: `model.`-prefixed names, torch (out, in) weights,
    `final_logits_bias` [1, V]. The inverse of
    models/weights_io.convert_multimodal_bart; the JAX package has no
    exporter, so it lives here."""
    sd = {"model.shared.weight": tree["shared"]["weight"].detach().cpu()}
    for side in ("encoder", "decoder"):
        part = tree[side]
        for key in ("embed_positions", "layernorm_embedding"):
            _export(sd, f"model.{side}.{key}", part[key])
        for i, layer in enumerate(part["layers"]):
            for key, p in layer.items():
                _export(sd, f"model.{side}.layers.{i}.{MEMBER_NAMES.get(key, key)}", p)
    enc = tree["encoder"]
    mapper = enc.get("prompt_mlp")
    if mapper is not None:  # both mapper kinds: linears at model.0, model.2, ...
        stages = mapper["stages"] if "stages" in mapper else (mapper["prompt_fc1"],
                                                              mapper["prompt_fc2"])
        for j, stage in enumerate(stages):
            _export(sd, f"model.encoder.prompt_mlp.model.{2 * j}", stage)
    for key in ("visual_map", "embed_tokens_ner", "embed_positions_ner",
                "layernorm_embedding_ner", "face_proj"):
        if key in enc:
            _export(sd, f"model.encoder.{MEMBER_NAMES.get(key, key)}", enc[key])
    sd["final_logits_bias"] = tree["final_logits_bias"].detach().cpu()[None]
    return sd


def openai_clip_state_dict(tree) -> dict:
    """models/clip_vit.py tree -> OpenAI CLIP's `visual.*` state dict: the
    HWIO conv1 kernel as OIHW, q/k/v packed into in_proj_weight / _bias.
    The inverse of models/weights_io.convert_clip_vision_openai."""
    import torch

    sd = {"visual.conv1.weight": tree["conv1"]["kernel"].detach().permute(3, 2, 0, 1)
          .contiguous().cpu(),
          "visual.class_embedding": tree["class_embedding"].detach().cpu(),
          "visual.positional_embedding": tree["positional_embedding"].detach().cpu()}
    _export(sd, "visual.ln_pre", tree["ln_pre"])
    _export(sd, "visual.ln_post", tree["ln_post"])
    if "proj" in tree:
        sd["visual.proj"] = tree["proj"].detach().cpu()
    for i, layer in enumerate(tree["layers"]):
        pre = f"visual.transformer.resblocks.{i}"
        qkv = [layer["attn"][n] for n in ("q_proj", "k_proj", "v_proj")]
        sd[f"{pre}.attn.in_proj_weight"] = torch.cat([p["kernel"].detach().t() for p in qkv]).cpu()
        sd[f"{pre}.attn.in_proj_bias"] = torch.cat([p["bias"].detach() for p in qkv]).cpu()
        _export(sd, f"{pre}.attn.out_proj", layer["attn"]["out_proj"])
        for key in ("ln_1", "ln_2"):
            _export(sd, f"{pre}.{key}", layer[key])
        for key in ("c_fc", "c_proj"):
            _export(sd, f"{pre}.mlp.{key}", layer["mlp"][key])
    return sd


def write_safetensors(path: str, sd: dict) -> None:
    """The `.safetensors` format in a few lines: an 8-byte little-endian
    header length, a JSON header (dtype, shape, data_offsets of each
    tensor), the raw little-endian bytes one tensor after another."""
    import torch

    header, blobs, offset = {}, [], 0
    for name, t in sd.items():
        t = t.detach().contiguous().cpu()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": SAFETENSORS_NAMES[str(t.dtype).split(".")[-1]],
                        "shape": list(t.shape), "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def tree_mismatches(got, want, path: str = "") -> list[str]:
    """Where `got` (a converted tree: f32 CPU leaves) differs from `want`:
    another structure, a leaf that is not f32, or a leaf not bit-identical
    to want's leaf widened to f32 on the CPU."""
    import torch

    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            return [f"{path}: keys {sorted(got) if isinstance(got, dict) else type(got)}"]
        return [m for k in want for m in tree_mismatches(got[k], want[k], f"{path}/{k}")]
    if isinstance(want, (tuple, list)):
        if type(got) is not type(want) or len(got) != len(want):
            return [f"{path}: {type(got).__name__} of {len(got)}"]
        return [m for i, (g, w) in enumerate(zip(got, want))
                for m in tree_mismatches(g, w, f"{path}[{i}]")]
    if got.dtype != torch.float32 or not torch.equal(got, want.detach().cpu().float()):
        return [f"{path}: {got.dtype} {tuple(got.shape)}"]
    return []


def http_opener():
    """urllib without proxies: the requests go to this process's own server."""
    import urllib.request

    return urllib.request.build_opener(urllib.request.ProxyHandler({}))


def request_body(row: dict) -> bytes:
    """A sample as the JSON body of POST /v1/caption."""
    return json.dumps({k: v.tolist() for k, v in row.items()}).encode()


def post_caption(opener, base: str, body: bytes) -> dict:
    import urllib.request

    req = urllib.request.Request(f"{base}/v1/caption", data=body,
                                 headers={"Content-Type": "application/json"})
    with opener.open(req, timeout=600) as r:
        return json.load(r)


def sample_rows(cfg, n: int, seed: int, with_pixels: bool = False) -> list[dict]:
    from vacnic_tpu_torch.data.synthetic import synthetic_batch

    b = synthetic_batch(cfg, n, seed=seed, with_pixels=with_pixels)
    keys = ("article_ids", "pixels" if with_pixels else "image_cls", "face_emb", "names_art_ids")
    return [{k: b[k][i].numpy() for k in keys} for i in range(n)]


def direct_generate(cfg, model, rows, img_cls=None):
    """generate_mm on the card of the stacked rows, as the service runs it
    -> (tokens [n, L] int64, scores [n] f32), both on the CPU."""
    import numpy as np
    import torch

    from vacnic_tpu_torch.infer.generate import generate_mm
    from vacnic_tpu_torch.train.train_step import create_mask, face_mask_from_emb

    b = {k: torch.from_numpy(np.stack([r[k] for r in rows])).cuda() for k in rows[0]}
    seqs, scores = generate_mm(
        model, b["article_ids"], create_mask(b["article_ids"]),
        b["image_cls"] if img_cls is None else img_cls, cfg.bart, cfg.fusion, cfg.decode,
        face_features=b["face_emb"], face_mask=face_mask_from_emb(b["face_emb"]),
        name_ids=b["names_art_ids"], name_mask=create_mask(b["names_art_ids"]),
        dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    return seqs.cpu(), scores.float().cpu()


def check_identical(tag: str, results: list[dict], seqs, scores) -> None:
    """Every result's tokens equal to the direct run's row, its score equal
    bit for bit."""
    bad = [i for i, r in enumerate(results)
           if r["tokens"] != seqs[i].tolist() or r["score"] != float(scores[i])]
    if bad:
        raise RuntimeError(f"{tag}: rows {bad} differ from the direct generate_mm "
                           f"(first: tokens {results[bad[0]]['tokens'][:8]}... score "
                           f"{results[bad[0]]['score']!r} vs {seqs[bad[0]][:8].tolist()}... "
                           f"{float(scores[bad[0]])!r})")


def run_serve_phase(cfg, params, batch_size: int, gpu: str, slice_counts=None) -> None:
    """The serving entry point at full width. (1) The slice's random tree and
    a seeded ViT-B/16 CLIP tree written under the reference's names and
    torch layouts, as a torch.save `.bin` and as `.safetensors`, loaded by
    weights_io.load_state_dict and converted back: every leaf bit-identical.
    (2) CaptionService on the converted trees behind make_http_server: 32
    HTTP requests from 32 threads, one batch, tokens and scores identical to
    a direct generate_mm of the same batch, and the kernels launched at the
    slice's counts (zeroed just before the requests, read just after).
    (3) input_kind="pixels" at batch 8 against clip_vision_fwd +
    generate_mm. (4) Readings, not gated: the CLIP tower's ms at batch 8 and
    32; with buckets (1, 8, 32) after precompile(), the latency of 10
    sequential single requests and the captions/s of a burst of 256
    requests over HTTP, of the same rows submitted in this process, and of
    eight direct generate_mm calls of 32 on them. The HTTP clients run in
    this process: their JSON bodies are made before the clock starts, but
    their threads and sockets share the interpreter with the server's."""
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.kernels import primitives as K
    from vacnic_tpu_torch.models import weights_io as W
    from vacnic_tpu_torch.models.clip_vit import clip_vision_fwd, clip_vision_init
    from vacnic_tpu_torch.serve import CaptionService, ServeConfig, make_http_server

    clip = clip_vision_init(make_generator(0, "cuda"), cfg.clip, device="cuda")
    parts = {"model": (params, reference_state_dict(params),
                       lambda sd: W.convert_multimodal_bart(sd, cfg.bart, cfg.fusion)),
             "clip": (clip, openai_clip_state_dict(clip),
                      lambda sd: W.convert_clip_vision_openai(sd, cfg.clip))}
    served = {}
    with tempfile.TemporaryDirectory() as tmp:
        for part, (tree, sd, convert) in parts.items():
            for fmt in ("bin", "safetensors"):
                path = os.path.join(tmp, f"{part}.{fmt}")
                t0 = time.perf_counter()
                if fmt == "bin":
                    torch.save(sd, path)
                else:
                    write_safetensors(path, sd)
                t_write = time.perf_counter() - t0
                t0 = time.perf_counter()
                out = convert(W.load_state_dict(path))
                t_load = time.perf_counter() - t0
                bad = tree_mismatches(out, tree)
                log(f"serve: {part} checkpoint .{fmt}, {len(sd)} tensors "
                    f"({next(iter(sd.values())).dtype}), {os.path.getsize(path) / 2**20:.1f} MiB: "
                    f"written in {t_write:.2f} s, load_state_dict + convert {t_load:.2f} s; "
                    + ("every leaf bit-identical to the tree it came from" if not bad
                       else f"{len(bad)} leaves differ: {bad[:4]}"))
                if bad:
                    raise RuntimeError(f"serve: the {part} .{fmt} round trip changed the tree")
                served[part] = out
    del parts

    opener = http_opener()

    def serve_http(svc):
        srv = make_http_server(svc, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv, f"http://127.0.0.1:{srv.server_address[1]}"

    # (2) exactness through HTTP, image_cls, the slice's batch
    rows = sample_rows(cfg, batch_size, seed=0)
    bodies = [request_body(r) for r in rows]
    svc = CaptionService(cfg, served, device="cuda",
                         serve_cfg=ServeConfig(buckets=(batch_size,), max_wait_ms=5000))
    srv, base = serve_http(svc)
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(batch_size) as ex:
            results = list(ex.map(lambda b: post_caption(opener, base, b), bodies))
        dt = time.perf_counter() - t0
        log(f"serve: {batch_size} HTTP requests from {batch_size} threads: {dt:.3f} s; "
            f"stats {svc.stats()}; launches {K.launch_counts()}")
        counts = check_slice_counts("serve", cfg)
        if slice_counts is not None:
            differ = {k: (counts[k], slice_counts[k]) for k in slice_counts if k in counts
                      and counts[k] != slice_counts[k]}
            if differ:
                raise RuntimeError(f"serve: launches (serve, slice) differ: {differ}")
        seqs, scores = direct_generate(cfg, svc.params["model"], rows)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
    check_identical("serve", results, seqs, scores)
    TOKENS["serve"] = seqs
    agree = (f"{float((TOKENS['slice'] == seqs).float().mean()):.4f}" if "slice" in TOKENS
             else "(no slice run)")
    log(f"serve: {batch_size} responses token- and score-identical to a direct generate_mm of "
        f"the same batch; token agreement with the slice (its bf16 tree) {agree}")

    # (3) pixels through the CLIP tower
    rows_px = sample_rows(cfg, 8, seed=0, with_pixels=True)
    svc = CaptionService(cfg, served, device="cuda",
                         serve_cfg=ServeConfig(buckets=(8,), max_wait_ms=5000,
                                               input_kind="pixels"))
    try:
        futs = [svc.submit(r) for r in rows_px]
        results = [f.result(timeout=600) for f in futs]
        px = torch.from_numpy(np.stack([r["pixels"] for r in rows_px])).cuda()
        with torch.inference_mode():
            _, img_cls = clip_vision_fwd(svc.params["clip"], px, cfg.clip, torch.bfloat16)
            seqs, scores = direct_generate(cfg, svc.params["model"], rows_px, img_cls=img_cls)
            clip_ms = {}
            for n in (8, 32):
                pxn = px[:1].expand(n, -1, -1, -1).contiguous() if n > 8 else px
                clip_ms[n] = time_ms(lambda pxn=pxn: clip_vision_fwd(
                    svc.params["clip"], pxn, cfg.clip, torch.bfloat16), reps=3, warmup=1)
    finally:
        svc.close()
    check_identical("serve pixels", results, seqs, scores)
    TOKENS["serve pixels"] = seqs
    log(f"serve: input_kind=pixels, batch 8: token- and score-identical to clip_vision_fwd + "
        f"generate_mm; the CLIP tower ({cfg.clip.layers} layers x width {cfg.clip.width}, "
        f"patch {cfg.clip.patch_size}, {cfg.clip.image_size}px, bf16) batch 8 "
        f"{clip_ms[8]:.2f} ms, batch 32 {clip_ms[32]:.2f} ms ({gpu})")

    # (4) readings: latency and throughput through the service
    svc = CaptionService(cfg, served, device="cuda", serve_cfg=ServeConfig(buckets=(1, 8, 32)))
    srv, base = serve_http(svc)
    try:
        t0 = time.perf_counter()
        svc.precompile()
        t_pre = time.perf_counter() - t0
        lat = []
        for body in [request_body(r) for r in sample_rows(cfg, 10, seed=2)]:
            t0 = time.perf_counter()
            post_caption(opener, base, body)
            lat.append((time.perf_counter() - t0) * 1e3)
        burst = sample_rows(cfg, 256, seed=3)
        bodies = [request_body(r) for r in burst]  # the clients' JSON, made before the clock
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(burst)) as ex:
            done = list(ex.map(lambda b: post_caption(opener, base, b), bodies))
        t_burst = time.perf_counter() - t0
        st = svc.stats()
        t0 = time.perf_counter()  # the same burst without the HTTP front end
        done_local = [f.result(timeout=600) for f in [svc.submit(r) for r in burst]]
        t_local = time.perf_counter() - t0
        st_local = svc.stats()
        t0 = time.perf_counter()
        for i in range(0, len(burst), 32):
            direct_generate(cfg, svc.params["model"], burst[i:i + 32])
        t_direct = time.perf_counter() - t0
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
    if len(done) != len(burst) or len(done_local) != len(burst) or st_local["errors"]:
        raise RuntimeError(f"serve: a burst lost requests ({len(done)} and {len(done_local)} "
                           f"answered, stats {st_local})")
    lat_sorted = sorted(lat)
    log(f"serve: precompile of buckets (1, 8, 32) {t_pre:.2f} s; b1 latency over HTTP, 10 "
        f"sequential requests: median {float(np.median(lat)):.1f} ms, p95 "
        f"{float(np.percentile(lat, 95)):.1f} ms (min {lat_sorted[0]:.1f}, max "
        f"{lat_sorted[-1]:.1f}) ({gpu})")
    local_counts = {b: n - st["bucket_counts"][b] for b, n in st_local["bucket_counts"].items()}
    log(f"serve: burst of {len(burst)} HTTP requests: {t_burst:.3f} s, "
        f"{len(burst) / t_burst:.2f} captions/s; the same rows submitted in this process (no "
        f"HTTP): {t_local:.3f} s, {len(burst) / t_local:.2f} captions/s, batches by bucket "
        f"{local_counts}; as {len(burst) // 32} direct generate_mm calls of 32: "
        f"{t_direct:.3f} s, {len(burst) / t_direct:.2f} captions/s; the service's own cost "
        f"{t_burst - t_direct:.3f} s over HTTP, {t_local - t_direct:.3f} s without ({gpu})")
    log(f"serve: stats after the b1 requests and the HTTP burst: bucket_decode_ms {st['bucket_decode_ms']}, "
        f"bucket_counts {st['bucket_counts']}, padded_rows {st['padded_rows']}, "
        f"deferred_rows {st['deferred_rows']}, mean_wait_ms {st['mean_wait_ms']:.1f}, "
        f"mean_decode_ms {st['mean_decode_ms']:.1f}, latency p50/p95/p99 "
        f"{st.get('latency_p50_ms')}/{st.get('latency_p95_ms')}/{st.get('latency_p99_ms')} ms "
        f"({gpu})")


def build_lines() -> list[str]:
    """Registers a thread, spill bytes and shared memory of the two 512-token
    self-attention kernels, the encoder's cross-attention kernel, the two
    gemm_bf16 kernels, the two layernorm kernels, the int8 and bf16
    dec_cross_attention kernels, the bf16, int8 and fp8 dec_self_attention
    kernels at the slice's plans and the four lm_head and four lm_stats
    kernels (N = 64, 128, 192, 256 x rows a pass; BK 160 takes 192), from
    nvcc's -Xptxas -v output of this build. The dynamic shared memory is the
    launch's own (csrc/enc_attention.cu: ring + 4 S for the self-attention,
    what the built library states for the cross-attention; csrc/flash_attn.cu:
    two stages of K, V and the padded bias tile; both + 1024 to align the
    tiles, computed here for S = 512; gemm: what the built library states
    for the shape; dec_cross: dec_cross_smem_bytes; dec_self:
    dec_self_smem_bytes at T = 64; lm_head and lm_stats: what the built
    library states for csrc/lm_head.cu's Geometry). A kernel other
    than the 512-token self-attention ones that spills fails the run."""
    import re

    from vacnic_tpu_torch.kernels import _build
    from vacnic_tpu_torch.kernels import primitives as K

    lib = _build.lib()
    dynamic = {"enc_self_attn_kernel": 4 * 8192 + 4 * 512 + 1024,
               "enc_cross_attn_kernel": lib.vt_enc_cross_smem_bytes(),
               "flash_attn_kernelIf": 2 * (2 * 8192 + 64 * 72 * 4) + 1024,
               "flash_attn_kernelI13__nv_bfloat16": 2 * (2 * 8192 + 64 * 72 * 2) + 1024,
               "gemm_large_kernel": K.gemm_smem_bytes(32 * 512, 1024, 1024),
               # the instance of three warpgroups: 160 rows
               "gemm_small_kernelILi3E": K.gemm_smem_bytes(160, 1024, 1024),
               "layernorm_warp_kernelILi8ELb1E": 0,  # d = 1024: eight float4 slots a lane
               "layernorm_block_kernelILb1E": 0,
               # int8 (signed char, "a") and bf16 K/V, five beams, S = 512
               "dec_cross_kernelIaLi5E": K.dec_cross_smem_bytes(5, 512, 1),
               "dec_cross_kernelI13__nv_bfloat16Li5E": K.dec_cross_smem_bytes(5, 512, 2),
               # bf16, int8 (signed char) and fp8 self caches, T = 64
               "dec_self_kernelI13__nv_bfloat16E": K.dec_self_smem_bytes(64, 2),
               "dec_self_kernelIaE": K.dec_self_smem_bytes(64, 1),
               "dec_self_kernelI13__nv_fp8_e4m3E": K.dec_self_smem_bytes(64, 1),
               **{f"{name}_kernelILi{nb}E": lib.vt_lm_head_smem_bytes(nb, stats)
                  for name, stats in (("lm_head", 0), ("lm_stats", 1)) for nb in (1, 2, 3, 4)}}
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
        if key.startswith(("gemm_", "layernorm_", "dec_cross_", "dec_self_", "lm_head_",
                           "lm_stats_", "enc_cross_")) and (
                int(spill.group(1)) or int(spill.group(2))):
            raise RuntimeError(f"{key} spills registers: {lines[-1]}")
    return lines


KERNEL_FAMILIES = (("gemm_large_kernel", "gemm_bf16 large_m"),
                   ("gemm_small_kernel", "gemm_bf16 small_m"), ("layernorm_", "layernorm"),
                   ("enc_self_attn", "enc_self_attention"),
                   ("enc_cross_attn", "enc_cross_attention"),
                   ("dec_self_kernel<__nv_bfloat16", "dec_self_attention bf16"),
                   ("dec_self_kernel<signed char", "dec_self_attention int8"),
                   ("dec_self_kernel<__nv_fp8_e4m3", "dec_self_attention fp8"),
                   ("dec_self_kernel", "dec_self_attention"),
                   ("dec_cross_kernel", "dec_cross_attention"), ("lm_stats_kernel", "lm_stats"),
                   ("flash_attn_kernel", "flash_attention"), ("lm_head_kernel", "lm_head"))


PROFILED_RUNS = (("slice", "profile.txt", {}),
                 ("selfkv int8", "profile_selfkv_int8.txt", {"self_kv": "int8"}),
                 ("selfkv fp8", "profile_selfkv_fp8.txt", {"self_kv": "fp8"}),
                 ("stats", "profile_stats.txt", {"lm_stats": True}),
                 ("stackhead", "profile_stackhead.txt", {"lm_head": "stack"}),
                 ("layerwise", "profile_layerwise.txt", {"add_ner_ffn": False}))


def run_profile_phase(cfg, params, batch_size: int) -> None:
    """Where the time goes: the fused encoder alone (CUDA events), then one
    generate_mm of each path (slice, selfkv int8 and fp8, stats, stackhead,
    layerwise) under torch.profiler
    -- device time by kernel family (the port's kernels vs PyTorch's own),
    the device's busy and idle share of the wall time, and PyTorch's own
    time by op: the aten ops' self device time (the port's kernels launch
    through ctypes and belong to no op). Full tables:
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
        aten = []  # (self device ms, calls, op)
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            us = ev.self_cuda_time_total if us is None else us
            if ev.key.startswith("aten::") and us > 0:
                aten.append((us / 1e3, ev.count, ev.key))
        aten.sort(reverse=True)
        with open(os.path.join(OUT_DIR, fname), "w") as f:
            f.write(f"{tag} wall_ms {wall_ms:.3f} device_busy_ms {busy_ms:.3f} "
                    f"fused_encoder_ms {enc_ms:.3f}\n")
            for name, times in rows:
                f.write(f"{sum(times):10.3f} ms {len(times):7d} x  {name[:160]}\n")
            f.write("PyTorch's own by op (self device time):\n")
            for ms, n, key in aten:
                f.write(f"{ms:10.3f} ms {n:7d} x  {key}\n")
        if busy_ms == 0:
            log(f"profile {tag}: wall {wall_ms:.1f} ms; the profiler saw no device activity "
                "(device time not measured)")
            continue
        fams = ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(fam.items(), key=lambda kv: -kv[1]))
        log(f"profile {tag}: batch {batch_size} wall {wall_ms:.1f} ms; device busy {busy_ms:.1f} "
            f"ms ({100 * busy_ms / wall_ms:.1f}% of wall, idle "
            f"{100 * (1 - busy_ms / wall_ms):.1f}%); by family: {fams}")
        log(f"profile {tag}: PyTorch's own by op, self device ms (calls): "
            + ", ".join(f"{key} {ms:.1f} ({n})" for ms, n, key in aten[:12])
            + f"; all aten ops {sum(a[0] for a in aten):.1f} ms")


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

TRAIN_STEPS = 4
REPLAY_BATCH = 8
GRAD_TOL = 2e-2  # of a leaf's largest |gradient|: bf16 products summed in another order


def tree_bytes(tree) -> int:
    from vacnic_tpu_torch.core.tree import leaves_with_path

    return sum(t.numel() * t.element_size() for _, t in leaves_with_path(tree)
               if hasattr(t, "numel"))


def n_params(tree) -> float:
    from vacnic_tpu_torch.core.tree import leaves_with_path

    return sum(t.numel() for _, t in leaves_with_path(tree) if hasattr(t, "numel")) / 1e6


def bart_leaves(state):
    """The bart group's leaves (everything but the CLIP towers)."""
    from vacnic_tpu_torch.core.tree import leaves_with_path
    from vacnic_tpu_torch.train.optim import is_clip

    return [t for p, t in leaves_with_path(state.params) if not is_clip(p)]


def frozen_leaves(state):
    """The CLIP tower's and the teacher's leaves."""
    from vacnic_tpu_torch.core.tree import leaves_with_path
    from vacnic_tpu_torch.train.optim import is_clip

    return ([t for p, t in leaves_with_path(state.params) if is_clip(p)]
            + [t for _, t in leaves_with_path(state.teacher)])


def same(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_train_metrics(tag: str, m: dict) -> None:
    import math

    bad = {k: float(v) for k, v in m.items() if not math.isfinite(float(v))}
    if bad:
        raise RuntimeError(f"{tag}: non-finite metrics {bad}")


def replay_grads(cfg, state, batch, remat: bool, seed: int):
    """The loss and the bart group's gradients of compute_losses with dropout
    seeded by `seed`, with or without remat, on the live parameters."""
    import torch

    from vacnic_tpu_torch.train.train_step import compute_losses

    c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, grad_checkpoint=remat))
    leaves = bart_leaves(state)
    loss, _ = compute_losses(state.params, state.teacher, batch, c, seed)
    return loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True)


def run_train_phase(gpu: str) -> dict:
    """The training step at full width: VacnicConfig.full_train() as released
    (bf16 compute over f32 parameters, grad_checkpoint, dropout 0.1, CoLaM
    alpha 0.5 with the teacher's forward, SECLA, CLIP frozen and run on
    pixels), random weights from seed 0, synthetic_batch(32, with_pixels),
    S 512, caption 100, make_train_step(num_training_steps=20), 4 steps.
    Gated: every metric finite; after step 0 (lr 0) the bart group
    bit-unchanged and its moments moved; after step 1 the bart group moved;
    the CLIP tower and the teacher bit-unchanged after every step; in step
    1's launch counts flash_attention 12 (the teacher's encoder) and no other
    kernel (the differentiated forward reaches none); remat on and off give
    the same loss and gradients at batch 8 with dropout on (bit-identical,
    else within GRAD_TOL of each leaf's largest |gradient|); eval_step
    through the fused encoder (whose kernels it must launch) against
    allow_fused_encoder=False: logits and val_loss within 5e-2 relative (the
    stacks phase's bf16 tolerance); CheckpointManager save after step 2 and
    restore into a fresh state: the next step from each, with dropout as
    released and then at dropout 0, gives bit-identical parameters.
    Readings: state bytes from the trees' shapes against
    torch.cuda.max_memory_allocated, step ms (median of the steps after the
    first two), samples/s, save / restore seconds, and a torch.profiler
    split of one step's device time (forward, backward, optimizer; aten ops;
    the port's kernels). Returns the step's launch counts."""
    import shutil
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vacnic_tpu_torch.core.config import VacnicConfig
    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.data.synthetic import synthetic_batch
    from vacnic_tpu_torch.kernels import primitives as K
    from vacnic_tpu_torch.models import fusion as F
    from vacnic_tpu_torch.models.bart import bart_init, shift_tokens_right
    from vacnic_tpu_torch.models.clip_vit import clip_vision_fwd, clip_vision_init
    from vacnic_tpu_torch.train import losses as L
    from vacnic_tpu_torch.train.checkpoints import CheckpointManager
    from vacnic_tpu_torch.train.train_step import (create_mask, eval_step, face_mask_from_emb,
                                                   make_train_step)

    cfg = VacnicConfig.full_train()
    bsz = cfg.train.train_batch_size
    g = make_generator(0, "cuda")
    model = F.multimodal_bart_init(g, cfg.bart, cfg.fusion, device="cuda")
    clip = clip_vision_init(g, cfg.clip, device="cuda")
    teacher = bart_init(g, cfg.bart, device="cuda")
    init_fn, step_fn = make_train_step(cfg, 20)
    state = init_fn({"model": model, "clip": clip}, teacher, cfg.train.seed)
    del model, clip, teacher
    batch = {k: v.cuda() for k, v in synthetic_batch(cfg, bsz, seed=0, with_pixels=True).items()}
    m_bytes, c_bytes, t_bytes = (tree_bytes(state.params["model"]),
                                 tree_bytes(state.params["clip"]), tree_bytes(state.teacher))
    o_bytes = tree_bytes(state.opt_state)
    log(f"train: full_train, batch {bsz} x S {cfg.data.article_max_length} x caption "
        f"{cfg.data.caption_max_length}, {cfg.train.compute_dtype} over f32, remat "
        f"{cfg.train.grad_checkpoint}, dropout {cfg.bart.dropout}, alpha {cfg.train.alpha}, "
        f"secla {cfg.train.use_secla}, CLIP frozen on pixels; parameters: model "
        f"{n_params(state.params['model']):.1f} M, CLIP {n_params(state.params['clip']):.1f} M, "
        f"teacher {n_params(state.teacher):.1f} M")
    log(f"train: state from the trees' shapes: params {(m_bytes + c_bytes) / 1e9:.2f} GB + "
        f"teacher {t_bytes / 1e9:.2f} GB + Adam moments {o_bytes / 1e9:.2f} GB = "
        f"{(m_bytes + c_bytes + t_bytes + o_bytes) / 1e9:.2f} GB, + the bart group's "
        f"gradients {m_bytes / 1e9:.2f} GB in a step = "
        f"{(2 * m_bytes + c_bytes + t_bytes + o_bytes) / 1e9:.2f} GB before activations; "
        f"allocated now {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    frozen0 = [t.detach().clone() for t in frozen_leaves(state)]
    bart0 = [t.detach().clone() for t in bart_leaves(state)]
    torch.cuda.reset_peak_memory_stats()
    step_s, counts, ckpt_dir = [], None, tempfile.mkdtemp(prefix="train_ckpt_")
    try:
        mgr = CheckpointManager(ckpt_dir, cfg, max_to_keep=1)
        for i in range(TRAIN_STEPS):
            if i == 1:
                K.reset_launch_counts()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            if i == 1:
                counts = K.launch_counts()
            check_train_metrics(f"train step {i}", m)
            log(f"train: step {i}: {step_s[-1] * 1e3:.1f} ms, " + ", ".join(
                f"{k} {float(v):.4f}" for k, v in m.items()))
            if not same(frozen0, frozen_leaves(state)):
                raise RuntimeError(f"train step {i}: the CLIP tower or the teacher changed")
            if i == 0:
                mu = state.opt_state["bart"]["mu"]["model"]["shared"]["weight"]
                nu = state.opt_state["bart"]["nu"]["model"]["shared"]["weight"]
                if not same(bart0, bart_leaves(state)) or not (mu.any() and nu.any()):
                    raise RuntimeError("train step 0 (lr 0): the bart group moved or its "
                                       "moments did not")
            if i == 1:
                if same(bart0, bart_leaves(state)):
                    raise RuntimeError("train step 1: the bart group did not move")
                del bart0
            if i == 2:
                t0 = time.perf_counter()
                mgr.save(state.step, state, {"loss": float(m["loss"])})
                save_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        ms = sorted(s * 1e3 for s in step_s[2:])
        med = ms[len(ms) // 2] if len(ms) % 2 else sum(ms[len(ms) // 2 - 1:len(ms) // 2 + 1]) / 2
        others = {k: n for k, n in counts.items() if k != "flash_attention" and n}
        log(f"train: step 1 launches {counts} ({gpu})")
        if counts["flash_attention"] != cfg.bart.encoder_layers or others:
            raise RuntimeError(f"train: a step must launch flash_attention once per teacher "
                               f"encoder layer and no other kernel, got {counts}")
        log(f"train: step wall ms {[round(s * 1e3, 1) for s in step_s]}; median of steps "
            f"2..{TRAIN_STEPS - 1} {med:.1f} ms, {bsz / (med / 1e3):.2f} samples/s; peak "
            f"memory {peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated) ({gpu})")

        # checkpoint round trip: the step after the save, from the live state
        # (already taken: step 3) and from the restored one
        t0 = time.perf_counter()
        restored, at = mgr.restore(state)
        restore_s = time.perf_counter() - t0
        if at != 3 or restored.step != 3:
            raise RuntimeError(f"train: restored step {at}, state step {restored.step}")
        restored, _ = step_fn(restored, batch)
        if not same(bart_leaves(state), bart_leaves(restored)):
            raise RuntimeError("train: the step from the restored state differs from the live one")
        cfg0 = dataclasses.replace(cfg, bart=dataclasses.replace(
            cfg.bart, dropout=0.0, activation_dropout=0.0))
        step0 = make_train_step(cfg0, 20)[1]
        state, _ = step0(state, batch)
        restored, _ = step0(restored, batch)
        identical = same(bart_leaves(state), bart_leaves(restored))
        ck_gb = (m_bytes + c_bytes + t_bytes + o_bytes) / 1e9
        log(f"train: checkpoint of {ck_gb:.2f} GB: save {save_s:.2f} s, restore "
            f"{restore_s:.2f} s; the step after it from the live and the restored state "
            f"bit-identical (dropout {cfg.bart.dropout}), then one more at dropout 0: "
            f"{'bit-identical' if identical else 'DIFFERENT'} ({gpu})")
        if not identical:
            raise RuntimeError("train: a dropout-0 step from the restored state differs")
        del restored
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # remat replays dropout: batch 8, dropout on, the same seed
    small = {k: v[:REPLAY_BATCH] for k, v in batch.items()}
    l_on, g_on = replay_grads(cfg, state, small, True, 12345)
    l_off, g_off = replay_grads(cfg, state, small, False, 12345)
    bitwise = bool(torch.equal(l_on, l_off)) and all(
        (a is None and b is None) or torch.equal(a, b) for a, b in zip(g_on, g_off))
    worst = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for a, b in zip(g_on, g_off) if a is not None)
    log(f"train: remat replay at batch {REPLAY_BATCH}, dropout {cfg.bart.dropout}: loss "
        f"{float(l_on):.6f} / {float(l_off):.6f}, gradients "
        f"{'bit-identical' if bitwise else 'not bit-identical'}, worst leaf "
        f"{worst:.3e} of its largest |gradient| (tol {GRAD_TOL})")
    if not bitwise and (worst > GRAD_TOL or abs(float(l_on - l_off)) > 1e-3 * abs(float(l_off))):
        raise RuntimeError("train: remat on and off disagree with dropout on")
    del g_on, g_off
    torch.cuda.empty_cache()

    # eval_step: the fused encoder (kernels) against allow_fused_encoder=False
    K.reset_launch_counts()
    ev = eval_step(state.params, batch, cfg)
    torch.cuda.synchronize()
    ev_counts = K.launch_counts()
    check_launched("train eval_step", ev_counts, SLICE_KERNELS[:4])
    with torch.no_grad():
        dt = torch.bfloat16
        _, img = clip_vision_fwd(state.params["clip"], batch["pixels"], cfg.clip, dt)
        tgt_in = shift_tokens_right(batch["caption_ids"], cfg.bart.pad_token_id,
                                    cfg.bart.eos_token_id)
        kw = dict(face_features=batch["face_emb"], face_mask=face_mask_from_emb(batch["face_emb"]),
                  name_ids=batch["names_art_ids"], name_mask=create_mask(batch["names_art_ids"]))
        args = (state.params["model"], batch["article_ids"], create_mask(batch["article_ids"]),
                tgt_in, img, cfg.bart, cfg.fusion)
        fused = F.mm_forward(*args, dtype=dt, **kw)["logits"]
        ref = F.mm_forward(*args, dtype=dt, allow_fused_encoder=False, **kw)["logits"]
        ref_loss = L.lm_cross_entropy(ref, batch["caption_ids"], cfg.bart.pad_token_id)
    e_logits = rel_err(fused, ref)
    e_loss = abs(float(ev["val_loss"]) - float(ref_loss)) / abs(float(ref_loss))
    agree = float((ev["argmax_ids"] == ref.argmax(-1)).float().mean())
    log(f"train: eval_step val_loss {float(ev['val_loss']):.5f} (fused encoder) vs "
        f"{float(ref_loss):.5f} (allow_fused_encoder=False): rel {e_loss:.3e}; logits rel err "
        f"{e_logits:.3e}; argmax agreement {agree:.4f} (tol rel 5e-2); launches {ev_counts}")
    if not (e_loss <= 5e-2 and e_logits <= 5e-2):
        raise RuntimeError("train: eval_step through the fused encoder disagrees")
    del fused, ref

    # where one step's device time goes
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the device's events: the step's three profiler ranges come back as
    # annotations spanning their kernels; every other event is work
    spans, work = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name.startswith("train_step."):
            spans.setdefault(e.name.split(".", 1)[1], []).append(
                (e.time_range.start, e.time_range.end))
        else:
            work.append(e)
    busy_ms = sum(e.time_range.elapsed_us() for e in work) / 1e3
    part_ms, fam = {}, {}
    for e in work:
        t = e.time_range.elapsed_us() / 1e3
        part = next((r for r, ss in spans.items()
                     if any(a <= e.time_range.start < b for a, b in ss)), "outside the ranges")
        part_ms[part] = part_ms.get(part, 0.0) + t
        key = next((f for pat, f in KERNEL_FAMILIES if pat in e.name), None)
        if key:
            fam[key] = fam.get(key, 0.0) + t
    span_ms = {r: sum(b - a for a, b in ss) / 1e3 for r, ss in spans.items()}
    aten = []
    for ev_ in prof.key_averages():
        self_us = getattr(ev_, "self_device_time_total", None)
        self_us = ev_.self_cuda_time_total if self_us is None else self_us
        if ev_.key.startswith("aten::") and self_us > 0:
            aten.append((self_us / 1e3, ev_.count, ev_.key))
    aten.sort(reverse=True)
    with open(os.path.join(OUT_DIR, "profile_train.txt"), "w") as f:
        f.write(f"train step wall_ms {wall_ms:.3f} device_busy_ms {busy_ms:.3f} "
                f"busy by range {part_ms} range spans {span_ms}\n")
        for ms_, n, key in aten:
            f.write(f"{ms_:10.3f} ms {n:7d} x  {key}\n")
    if busy_ms == 0:
        log(f"train profile: wall {wall_ms:.1f} ms; the profiler saw no device activity "
            "(device time not measured)")
    else:
        log(f"train profile: one step, batch {bsz}: wall {wall_ms:.1f} ms, device busy "
            f"{busy_ms:.1f} ms (idle {100 * (1 - busy_ms / wall_ms):.1f}%); device busy by "
            "range (device span of the range): " + ", ".join(
                f"{r} {v:.1f} ms ({span_ms[r]:.1f})" if r in span_ms else f"{r} {v:.1f} ms"
                for r, v in part_ms.items())
            + " (the backward's ops, remat's recompute among them, run on autograd's thread "
            "outside the ranges); the port's kernels "
            + (", ".join(f"{k} {v:.1f} ms" for k, v in fam.items()) or "none")
            + "; aten self device ms (calls): "
            + ", ".join(f"{key} {ms_:.1f} ({n})" for ms_, n, key in aten[:12])
            + f"; all aten ops {sum(a[0] for a in aten):.1f} ms ({gpu})")

    # the step's products, counted as they run (forward, remat's recompute,
    # backward; the ctypes kernels are not seen)
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        state, _ = step_fn(state, batch)
    flops = fc.get_total_flops()
    mm_ms = sum(ms_ for ms_, _, key in aten if key in ("aten::mm", "aten::bmm", "aten::addmm"))
    rate = f"{flops / 1e12 / (mm_ms / 1e3):.1f} TFLOP/s" if mm_ms else "not measured"
    log(f"train: one step's library products, counted by torch.utils.flop_counter: "
        f"{flops / 1e12:.2f} TFLOP; over the profiled step's aten mm + bmm + addmm device time "
        f"({mm_ms:.1f} ms): {rate} ({gpu})")
    return counts


def compare_tokens(ref: dict, gpu: str) -> None:
    """Every path run here against the captions another tree saved with
    --tokens-out on the same seeds: token agreement printed, and any
    difference fails the run."""
    import torch

    common = sorted(set(ref) & set(TOKENS))
    if not common:
        raise RuntimeError("tokens: no path of this run is in the reference file")
    differ = []
    for path in common:
        a, b = TOKENS[path], ref[path]
        same = a.shape == b.shape and bool(torch.equal(a, b))
        agree = float((a == b).float().mean()) if a.shape == b.shape else 0.0
        log(f"tokens {path}: token agreement with the reference tree {agree:.4f}, "
            f"{'identical' if same else 'DIFFERENT'} ({gpu})")
        if not same:
            differ.append(path)
    if differ:
        raise RuntimeError(f"tokens: paths not token-identical to the reference tree: {differ}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,accuracy,dispatch,stacks,slice,selfkv,stats,stackhead,"
                            "layerwise,serve,profile,train")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--tokens-out", metavar="FILE",
                    help="save each path's captions (torch.save of {path: tokens})")
    ap.add_argument("--tokens-ref", metavar="FILE",
                    help="captions saved by --tokens-out from another tree: every path run "
                         "here must be token-identical to them")
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
    if "accuracy" in phases:
        run_accuracy_phase(gpu)
    if "dispatch" in phases:
        run_dispatch_phase()
    launches = {}  # kernel -> launches in the run of the path that names it
    if phases & {"stacks", "slice", "selfkv", "stats", "stackhead", "layerwise", "serve",
                  "profile"}:
        cfg, params = full_model()
        if "stacks" in phases:
            run_stacks_phase(cfg, params)
        slice_seqs = counts = None
        if "slice" in phases:
            counts, slice_seqs = run_slice_phase(cfg, params, args.batch)
            launches.update({k: counts[k] for k in SLICE_KERNELS +
                             ("gemm_bf16:large_m", "gemm_bf16:small_m", "layernorm:warp",
                              "dec_self_attention:bf16")})
        if phases & {"selfkv", "stats", "stackhead"} and slice_seqs is None:
            slice_seqs = run_slice_phase(cfg, params, args.batch)[1]
        if "selfkv" in phases:
            launches.update(run_selfkv_phase(cfg, params, args.batch, slice_seqs, gpu))
        if "stats" in phases:
            launches["lm_stats"] = run_stats_phase(cfg, params, args.batch,
                                                   slice_seqs)["lm_stats"]
        if "stackhead" in phases:
            launches["lm_head"] = run_stackhead_phase(cfg, params, args.batch,
                                                      slice_seqs)["lm_head"]
        if "layerwise" in phases:
            launches["flash_attention"] = run_layerwise_phase(
                cfg, params, args.batch)["flash_attention"]
        if "serve" in phases:
            run_serve_phase(cfg, params, args.batch, gpu, counts)
        if "profile" in phases:
            run_profile_phase(cfg, params, args.batch)
        del params  # the train phase builds its own f32 trees
    if "train" in phases:
        torch.cuda.empty_cache()
        launches.setdefault("flash_attention", run_train_phase(gpu)["flash_attention"])
    if args.tokens_out:
        torch.save(TOKENS, args.tokens_out)
        log(f"tokens: the captions of {sorted(TOKENS)} saved to {args.tokens_out}")
    if args.tokens_ref:
        compare_tokens(torch.load(args.tokens_ref), gpu)
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
