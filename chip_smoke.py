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
           (timed here only; the port never calls it). gemm_bf16 runs every
           product of a layer in the three regimes (M = 16384: the 256 x 128
           TMA kernel, M = 160: the split-K kernel, M 320-2048: the 128-row
           TMA kernel with split-K; each row names its plan; from 257 rows
           to 4096 beside the other TMA kernel at the same shape) and, untimed,
           ragged shapes on each side of both boundaries and every mid_m
           tile width and split through the private entry. Untimed too:
           layernorm at d 32 ... 2048 (both kernels, a scalar tail) and
           rows 1 to 6000; dec_cross_attention at beams 1, 5, 8, 9, 11, 16,
           17, 24, 33 x S 1, 40 (to 8 beams), 130, 512, int8 and bf16, with
           an item whose keys are all masked, by the plan and, 9-24 beams,
           the groups of 8 and the wide block by explicit plans;
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
           zero after the launch; enc_cross_attention (timed at B 8 and 32
           at KV 40, the slice's, and at B 32 at KV 20 and 36, the onlyvis
           and mlp paths') at KV 1, 8, 16, 20, 36, 40, 64 x S 1, 63, 64,
           130, 512. The ladder phase's shapes, timed: dec_cross_attention
           at B 8 x 11 beams, B 32 x 16 (the ladder's) and 32 x 11 beams
           (no path's), each as the plan launches it beside the other launch
           past 8 beams (the wide block or the groups of 8), and B 256 x
           beam 5, int8 and bf16 (bf16 beside SDPA); the decoder's five products at
           M 320, 640, 1280 (batch 64-256 x beam 5) and 512 (32 x 16 beams),
           the encoder's at M 512, 1024, 2048 and 4096 (batch 1, 2, 4, 8),
           beside addmm; lm_head at BK 1280 beside addmm. Past 8 beams each group's rows
           must be bit-identical to the kernel of that many beams on those q
           rows alone (at B 32 x 11 and 16: the wide block's). The rows of
           the two kernels redesigned last log the times of the kernels
           before them (EARLIER), outside the kernels line. gemm_bf16, layernorm, dec_cross_attention,
           dec_self_attention, lm_head, enc_cross_attention and lm_stats
           must repeat bit-identically. cross_kv (the decode cache's cross
           K/V, one launch a layer) against its twin at batch 256, 32, 8
           and 1 x S 512 x d 1024, int8 and bf16, by cross_kv_gaps, then
           one layer timed at each beside the f32 product the decode cache
           ran before (`library`) and bf16 addmm.
  gemmplan readings only, not in the default list: every mid_m plan (tile
           width x split), large_m and addmm at the decoder's and the
           encoder's rows (GEMM_SWEEP_M) for each product of a layer, each
           held to the twin (run_gemmplan_phase).
  crossplan readings only, not in the default list: dec_cross_attention's
           groups of 8 and wide block at B 8, 16, 32 x beams 9, 11, 16, 17,
           24 x int8 and bf16, each held to the twin and the wide one
           bit-identical to the groups (run_crossplan_phase).
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
           the layer-by-layer references at batches 2 and 4 (the encoder's
           products at M 1024 and 2048); the kernel path's decode cache
           (cross_kv, bf16) against the reference path's cross K/V within
           one bf16 ulp (cross_kv_gaps), wherever a decode step is checked.
  slice    VacnicConfig.full_train(), random bf16 weights from seed 0,
           synthetic_batch(32): generate_mm on cuda, beam 5 x max_length 50
           x length penalty 2.0 with min_length 49. Launch counts are zeroed
           just before this run and read just after; the six kernels of the
           fused encoder and the decode stack and the decode cache's cross_kv
           must have launched, gemm_bf16's
           three kernels as kernels/primitives.gemm_plan places the six
           products of an encoder layer (M = batch x 512) and of a decoder
           layer a step (M = batch x beams): small_m up to 256 rows, mid_m
           to GEMM_MID_M_MAX, large_m above (at batch 32, 72 large_m and
           3528 small_m),
           layernorm once a layer norm (1800, all on the warp kernel),
           enc_self_attention and enc_cross_attention once an encoder layer
           (12, enc_cross all at KV 40), dec_cross_attention and
           dec_self_attention once a decoder layer a step (588, dec_self all
           on the bf16 cache's kernel, dec_cross all at the path's beam
           count), cross_kv once a decoder layer (12). Checks finite scores
           and a mean caption length >= 45.
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
           of eight direct generate_mm calls of 32 on them, and stats();
           ROADMAP C.10's probe (head_thread_probe).
  ladder   the slice's model and tree past the slice's beam count and batch
           (run_ladder_phase): generate_mm at batch 8 x 11 beams (BK 88,
           small_m) and batch 32 x 16 beams (BK 512, mid_m), then at
           batches 64, 128 and 256 x beam 5 (BK 320-1280: every decoder
           product on mid_m, the encoder on large_m at up to 131072 rows), each with
           the slice's gates at its batch and beam count (launch counts as
           gemm_plan says, dec_cross_attention counted by beams and on the
           variant dec_cross_plan picks: at 8 x 11 and 32 x 16 the wide
           block; mean length >= 45, finite scores) and
           readings (wall, captions/s, peak
           memory); rows 0-31 of batch 256 decoded at batch 32, token
           agreement read, not gated; then CaptionService with the default
           ServeConfig() (buckets up to 256): a burst of 256 rows queued
           behind one b1 request must decode as one batch of the 256 bucket,
           each response token- and score-identical to a direct generate_mm
           of the same rows.
  profile  the fused encoder alone, then one more run of each of the slice,
           selfkv (int8, fp8), stats, stackhead and layerwise paths under
           torch.profiler: device time by kernel family (dec_self_attention
           by cache type), busy/idle share, and PyTorch's own device time
           split by op (the top aten ops by self device time).
  mesh     multi-GPU over every visible card (run_mesh_phase): make_mesh();
           generate_mm_sharded at the slice's batch token- and
           score-identical to the slice (on several cards each shard to a
           generate_mm of its rows on its card), every kernel launched the
           slice's count times the cards; CaptionService(mesh=) answering 8
           requests identically to a direct generate_mm_sharded, then an
           update_params swap to a seed-1 tree reaching every card's
           shard; `cli generate --sharded` writing the file of
           generate_captions(mesh=), `cli serve --sharded` as a subprocess;
           the data-parallel training step in torch.cuda.device_count()
           spawned NCCL ranks (run_dp_group) at full_train() widths cut to
           2 + 2 layers, batch 32, with the models' products on the float32
           recipe its loss terms equal to one process's within 2e-5; with
           the program's bf16 products, finite, its gaps read.
  meshscale  readings only, not in the default list: generate_mm_sharded
           over the first 1, 2, 4 cards at 32 rows a card (the switch
           interval at its default and at 1e-4 s) beside one card's
           generate_mm and the shards run in turn from one thread.
  bf16gaps readings only, not in the default list: over seeds 0, 1, 2,
           the mesh phase's data-parallel step and the tp phase's bf16
           witness, each with the products on the program's bf16 recipe
           and on the float32 one: the gaps to one process and the two
           recipes' distance in one process.
  tp       the dp x tp training step (run_tp_phase, core/tensor_parallel) at
           full_train() widths and depth, batch 32, computed in f32
           (tp_config), against one process on the
           same batch and trees: two ranks sharing the card over gloo (on
           four cards dp 2 x tp 2 and tp 4 over NCCL), each making the whole
           trees from the seed and keeping its shards; 2 steps: loss terms
           within 2e-5, the gradient norm within 2e-3, named column-,
           row-parallel and replicated leaves of BART, fusion and the teacher
           gathered after the update, shard bytes, flash_attention on the
           head shards, then gather_params and a batch-32 decode over a data
           mesh identical to generate_mm. In bf16 (bf16_witness) against
           one bf16 process, both off the f32 step: whole with the products
           on the float32 recipe; the gradients alone with the program's
           bf16 products, its terms read. Readings: step ms, samples/s, peak
           GB a rank against one process.
  onlyvis  VacnicConfig.onlyvis_train() (the visual-prompt-only model:
           clipcap prompt alone, KV 20) at full width, random bf16 weights
           from seed 0, after the slice's tree is freed: the fused encoder
           against the layer-by-layer one at batch 32 (rel 5e-2);
           generate_mm at the slice's decode, batch 32, launches zeroed
           just before and read just after: the slice's counts, with
           enc_self_attention 12 and enc_cross_attention 12, all at KV 20;
           mean length >= 45; CaptionService answering 8 requests without
           faces or names token- and score-identical to a direct
           generate_mm; then, that tree freed, 3 training steps at batch 32
           (f32 trees, bf16 compute, remat, CoLaM with the teacher's
           forward, CLIP frozen on pixels) under the train phase's gates
           (finite metrics, lr 0 at step 0, the bart group moved at step 1,
           CLIP and teacher bit-unchanged, flash_attention 12 and no other
           kernel in step 1, eval_step fused against unfused within 5e-2).
           Readings: captions/s, step ms, samples/s, peak GB.
  mlp      full_train() with prompt_mlp_type="mlp" (the patch-token mapper,
           map_size (196, 256, 64, 16): KV 16 + 20 = 36) at full width,
           random bf16 weights from seed 0: the CLIP tower (ViT-B/16, seed
           0) on pixels gives patch tokens [32, 196, 768]; the fused encoder
           against the layer-by-layer one on them (rel 5e-2); generate_mm
           at the slice's decode, batch 32: the slice's counts with
           enc_cross_attention 12, all at KV 36; mean length >= 45. Then the
           general KV-cached decoder (models/bart.init_cache +
           decoder_fwd(cache=)) at full width in f32, batch 8: 16
           teacher-forced steps, each step's logits within 1e-4 of its
           largest |logit| of the uncached decoder_fwd at that position.
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
  data     the data layer and evaluation (run_data_phase): a GoodNews-layout
           fixture written here (64 / 8 / 32 rows, 224 px JPEGs, faces on
           every second row, NER masks, byte-level BPE padded to BART's
           50265 entries; the BPE engine and pretokenizer printed, native
           ids equal to Python's); PrefetchLoader(device="cuda") batches
           bit-identical to host collate, pinned, no thread left by an
           abandoned iterator; fit at full_train() widths cut to 2 + 2
           layers, batch 32, 2 epochs, teacher cache (epoch 2 launches no
           flash_attention), then generate_captions on val; generate_captions
           at full_train() as released over the 32 test rows at batch 32:
           the slice's launch counts, tokens identical to a direct
           clip_vision_fwd + generate_mm, metrics finite. Readings: loader
           batches/s, H2D ms, fit step ms, captions/s against direct.
  cli      every subcommand of `python -m vacnic_tpu_torch.cli` (run_cli_phase)
           on the data phase's fixture, in this process but serve: generate
           at full_train() as released (random bf16 weights from seed 0 and
           a ViT-B/16 tower saved once by CheckpointManager, the 32 test rows
           at batch 32): tokens and file identical to
           train/loop.generate_captions on the same tree and loader, the
           slice's launch counts (zeroed just before, read just after);
           evaluate of that output with --data-dict; serve as a subprocess
           on that checkpoint with --watch-ckpt-s 1: three requests over HTTP
           each identical to a direct generate_mm of its row, a newer step
           saved and weights_version rising in /v1/stats, SIGINT -> exit 0;
           train at full_train() widths cut to 2 + 2 layers (each save
           writes the whole state), --max-steps 2, then --resume:
           flash_attention launched (the teacher), test metrics finite;
           retrieve with a random ViT-B/16 + CLIP text tower .npz
           (convert_checkpoint.save_tree; released widths, each tower cut to
           2 of 12 layers) and a fixture CLIP vocab, equal to
           retrieve_sentences recomputed on the card; lmm --backend echo;
           smoke (the slice's kernels launched). One line a subcommand
           with its wall seconds; logs in chiprun_out/chip_smoke/cli_*.log.
  led      VacnicConfig.led_full() (run_led_phase): its kernels at the LED
           cell's B 32 x S 16384 against their twins, within tolerance()
           (cross_kv by cross_kv_gaps): enc_window_attention, the layer's
           window plus global rows, the long cross_kv, the split
           dec_cross_attention; timed beside the twin, the bound and the
           library (led_kernels.json). Then (run_led_path) the fused
           encoder against the layer-by-layer one at batch 2, and
           generate_mm at 32 x 16384 x beam 5 with its launches held to
           LED's path.

--batch N (32 by default) is the batch of the slice and of the paths run
beside it; their launch gates follow gemm_plan at that batch.
--tokens-out FILE saves every path's captions; --tokens-ref FILE holds every
path of this run token-identical to captions another tree saved (copy this
file into that tree and run it there with --tokens-out first).

Prints the registers, spills and shared memory of the two 512-token
self-attention kernels, the encoder's cross-attention, the four gemm_bf16,
two layernorm, eight dec_cross_attention (beam 5, groups of 8 and the
wide block of two and of three n8 operands, int8 and bf16), three
dec_self_attention, four
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
import math
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
# paths whose run launched gemm_bf16's mid_m: against a tree from before
# that kernel, their token agreement is a reading (compare_tokens)
MID_M_PATHS: set = set()
SCORES: dict = {}  # path -> its scores [B] (f32, on the CPU)

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
    "cross_kv": "vacnic_tpu_torch/kernels/csrc/gemm_bf16.cu",
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
    "dec_cross_attention": "vacnic_tpu/kernels/decode_layer.py:499 (_cross_attn; beam pad to "
                           "ceil8(beams) :508-521)",
    "lm_stats": "vacnic_tpu/kernels/lm_stats.py:76 (lm_stats; _kernel :44)",
    "flash_attention": "vacnic_tpu/kernels/flash_attn.py:65 (flash_attention; _flash_kernel :28)",
    "lm_head": "vacnic_tpu/kernels/decode_layer.py:643-650 (_lm_head, the n_lm > 0 grid "
               "iteration of decode_stack :653)",
    "cross_kv": "none: the JAX package leaves the decoder's cross K/V product to XLA's einsum "
                "(vacnic_tpu/infer/decode_fast.py:267-280)",
}
SLICE_KERNELS = ("gemm_bf16", "layernorm", "enc_self_attention", "enc_cross_attention",
                 "dec_self_attention", "dec_cross_attention", "cross_kv")
DECODE_KERNELS = ("gemm_bf16", "layernorm", "dec_self_attention", "dec_cross_attention",
                  "cross_kv")
SELF_KV_KINDS = ("int8", "fp8")
# enc_cross_attention's KV on each model's path: the slice's full_train()
# (clipcap, 20 prompt rows + 20 NER rows), onlyvis_train() (only_image: 20
# prompt rows) and the mlp mapper's (16 prompt rows + 20 NER rows)
ENC_CROSS_KV = {"slice": 40, "onlyvis": 20, "mlp": 36}
# the slice's kernels, and the splits of those that are several __global__ kernels
SLICE_COUNTED = SLICE_KERNELS + ("gemm_bf16:large_m", "gemm_bf16:small_m", "layernorm:warp",
                                 "dec_self_attention:bf16")


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

    def gemm_cases(tag: str, m: int, kern_suffix: str = ""):
        """A layer's five products at M = m, timed beside addmm and, from
        257 rows to 4096, beside the other TMA kernel at the same shape
        (mid_m's rows beside large_m, the kernel they took before; large_m's
        beside mid_m as _mid_m_plan would cut it). A row's launches are its
        kernel's in the slice's run, or with a suffix (":b64") in that run's."""
        for sub, k, n, act, res, out in products:
            a, w, b = rn(m, k, dtype=bf), rn(k, n, std=0.02, dtype=bf), rn(n, std=0.02)
            r = rn(m, n) if res else None
            byts = (m * k + k * n) * 2 + n * 4 + (m * n * 4 if res else 0) + m * n * out.itemsize
            b16 = b.to(bf)
            plan = K.gemm_plan(m, n, k)
            epi = "".join((" +gelu" if act else "", " +res" if res else "",
                           " f32" if out == torch.float32 else " bf16"))
            other = []
            if K.GEMM_SMALL_M_MAX < m <= 4096:
                o_plan = (K.GemmPlan("large_m") if plan.variant == "mid_m"
                          else K._mid_m_plan(m, n, k))
                other = [("other", f"{gemm_how(o_plan)} at the same shape",
                          lambda a=a, w=w, b=b, r=r, act=act, out=out, o_plan=o_plan:
                          K._gemm_planned(o_plan, a, w, b, r, act, out))]
            cases.append((f"gemm_bf16 {tag} {sub} M={m} K={k} N={n}{epi} [{gemm_how(plan)}]",
                          f"gemm_bf16:{plan.variant}{kern_suffix}",
                          lambda a=a, w=w, b=b, r=r, act=act, out=out: K.gemm(a, w, b, r, act, out),
                          lambda a=a, w=w, b=b, r=r, act=act, out=out:
                          K.gemm_plain(a, w, b, r, act, out),
                          byts, 2.0 * m * n * k, PEAK_BF16_FLOPS,
                          lambda a=a, w=w, b16=b16: torch.addmm(b16, a, w), *other))

    gemm_cases("enc", 32 * 512)
    gemm_cases("dec", 160)
    # correctness only: ragged rows in the three kernels and on each side of
    # both boundaries (256 | 257, GEMM_MID_M_MAX | + 1), every epilogue
    mx = K.GEMM_MID_M_MAX
    for m in (1, 37, 161, 255, 256, 257, 258, 383, 1280, mx - 1, mx, mx + 1):
        a, w = rn(m, 256, dtype=bf), rn(256, 384, std=0.05, dtype=bf)
        b, r = rn(384), rn(m, 384)
        for bias, res, act, out in itertools.product((None, b), (None, r), (None, K.GELU),
                                                     (torch.float32, bf)):
            epi = "".join((" +bias" if bias is not None else "", " +gelu" if act else "",
                           " +res" if res is not None else "",
                           " f32" if out == torch.float32 else " bf16"))
            how = gemm_how(K.gemm_plan(m, 384, 256))
            cases.append((f"gemm_bf16 M={m} K=256 N=384{epi} [{how}]", "gemm_bf16",
                          lambda a=a, w=w, bias=bias, res=res, act=act, out=out:
                          K.gemm(a, w, bias, res, act, out),
                          lambda a=a, w=w, bias=bias, res=res, act=act, out=out:
                          K.gemm_plain(a, w, bias, res, act, out),
                          None, 0.0, PEAK_BF16_FLOPS, None))
    # correctness only: every mid_m tile width and split, through the private
    # entry, at ragged M, a k tail of 32 (K % 64 == 32: the last slab short),
    # a half-empty last 128-column tile (N % 128 == 64), and one warpgroup
    # with a single live row (M 257)
    for (m, k, n), bn, split in itertools.product(
            ((257, 96, 192), (320, 1056, 1088), (383, 4096, 1024)), (64, 128), (1, 2, 4)):
        a, w = rn(m, k, dtype=bf), rn(k, n, std=0.05, dtype=bf)
        b, r = rn(n), rn(m, n)
        plan = K.GemmPlan("mid_m", split, bn)
        for act, out in ((K.GELU, bf), (None, torch.float32)):
            cases.append((f"gemm_bf16 M={m} K={k} N={n} +bias{' +gelu' if act else ''} +res "
                          f"{'bf16' if out == bf else 'f32'} [{gemm_how(plan)}, private entry]",
                          "gemm_bf16",
                          lambda a=a, w=w, b=b, r=r, act=act, out=out, plan=plan:
                          K._gemm_planned(plan, a, w, b, r, act, out),
                          lambda a=a, w=w, b=b, r=r, act=act, out=out:
                          K.gemm_plain(a, w, b, r, act, out),
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

    H, B, S, KV = 16, 8, 512, ENC_CROSS_KV["slice"]

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

    def enc_cross_case(bsz, kv=KV, kern="enc_cross_attention"):  # B = 32: the paths' own
        q = rn(bsz * S, d, dtype=bf)
        ck, cv = rn(bsz, d, kv, dtype=bf), rn(bsz, kv, d, dtype=bf)
        return (f"enc_cross_attention B={bsz} S={S} KV={kv}", kern,
                lambda: K.enc_cross_attention(q, ck, cv, bsz, S, H),
                lambda: K.enc_cross_attention_plain(q, ck, cv, bsz, S, H),
                (2 * bsz * S * d + 2 * bsz * kv * d) * 2, 4.0 * bsz * S * kv * d, PEAK_BF16_FLOPS,
                lambda: Fn.scaled_dot_product_attention(
                    q.view(bsz, S, H, 64).transpose(1, 2), ck.view(bsz, H, 64, kv).transpose(2, 3),
                    cv.view(bsz, kv, H, 64).transpose(1, 2)))

    # each path's KV (ENC_CROSS_KV); a row's launches are its own path's
    cases += [enc_cross_case(B), enc_cross_case(32)]
    cases += [enc_cross_case(32, ENC_CROSS_KV[p], f"enc_cross_attention:kv{ENC_CROSS_KV[p]}")
              for p in ("onlyvis", "mlp")]
    # correctness only: KV 1 ... 64 (16 the mlp mapper's under only_image)
    # x S 1 ... 512 (ragged last q tiles)
    for kv_c, s_c in itertools.product((1, 8, 16, 20, 36, 40, 64), (1, 63, 64, 130, 512)):
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
                  ("second", "decode_fast._lm_head: the default head as the step runs it (f32 "
                   "cast of the tied weights, f32 product over V)",
                   lambda: DF._lm_head(tied, x_lm, bf))))
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
    # the tensor-parallel step's head shards (the teacher's encoder on a model
    # rank: tp 2 gives H 8, tp 4 gives H 4): timed at H 8, held to the twin at H 4
    for h_tp, timed in ((8, True), (4, False)):
        def shard(h_tp=h_tp):
            return rn(B3, T3, h_tp * 64, dtype=bf).view(B3, T3, h_tp, 64).permute(0, 2, 1, 3)

        sq, sk, sv = (shard().float() * 64 ** -0.5).to(bf), shard(), shard()
        cases.append((f"flash_attention B={B3} H={h_tp} T=S={T3} D=64 bias [B,1,T,S] bf16 "
                      "(tp head shard)", "flash_attention:tp",
                      lambda a=(sq, sk, sv): FA.flash_attention(*a, fbias),
                      lambda a=(sq, sk, sv): FA.flash_attention_plain(*a, fbias),
                      4 * B3 * h_tp * T3 * 64 * 2 + fbias.numel() * 2 if timed else None,
                      4.0 * B3 * h_tp * T3 * T3 * 64, PEAK_BF16_FLOPS,
                      lambda a=(sq, sk, sv): Fn.scaled_dot_product_attention(
                          *a, attn_mask=fbias, scale=1.0)))
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

    # the ladder phase's shapes (a row's launches are its own ladder run's;
    # the paths' cross K/V are int8, so no path launches a bf16 row):
    # dec_cross_attention at 8 x 11 and 32 x 16 beams and at batch 256, and
    # 32 x 11 beams, which no path runs
    for items, beams_w, kern in ((8, 11, "dec_cross_attention:beams11"),
                                 (32, 16, "dec_cross_attention:beams16"),
                                 (32, 11, "dec_cross_attention:unpathed"),
                                 (256, beams, "dec_cross_attention:b256")):
        cases += [dec_cross_timed(rn, g, items, beams_w, S, kind,
                                  kern if kind == "int8" else "dec_cross_attention:unpathed")
                  for kind in ("int8", "bf16")]
    # the decoder's products at batch 64, 128, 256 x beam 5 (M 320, ragged:
    # 256 + 64; 640; 1280) and at batch 32 x 16 beams (M 512); the encoder's
    # at batch 1 (M 512: the service's b1 requests), 2 and 4 (M 1024, 2048:
    # the stacks phase) and 8 (M 4096: the ladder's 8 x 11 beams), each with
    # the other TMA kernel beside it: GEMM_MID_M_MAX is set from these
    for batch in (64, 128, 256):
        gemm_cases("dec", batch * beams, f":b{batch}")
    gemm_cases("dec", 32 * 16, ":beams16")
    for batch, path in ((1, "serve_b1"), (2, "stacks_b2"), (4, "stacks_b4"), (8, "beams11")):
        gemm_cases("enc", batch * S, f":{path}")
    # the LM head at batch 256 x beam 5, five passes of 256 rows: a shape no
    # path runs (the ladder decodes with the library head), so no launches
    x1280 = rn(1280, d, dtype=bf)
    cases.append((f"lm_head BK=1280 d={d} Vp={Vp} (no path: the ladder's head is the library's)",
                  "lm_head:unpathed",
                  lambda: LH.lm_head(x1280, w_lm, b_lm), lambda: LH.lm_head_plain(x1280, w_lm, b_lm),
                  1280 * d * 2 + Vp * d * 2 + Vp * 4 + 1280 * Vp * 4, 2.0 * 1280 * Vp * d,
                  PEAK_BF16_FLOPS, lambda: torch.addmm(b_lm, x1280.float(), w32.t())))
    # correctness only, past 8 beams: by the plan (the wide block to 24
    # beams, the groups of 8 past) with a ragged last operand (9, 11, 17,
    # 33) and whole ones (16, 24) x S 1, 130, 512; the groups of 8 by
    # explicit plans at the same shapes but 33; int8 and bf16
    for beams_c, s_c, kind in itertools.product((9, 11, 16, 17, 24, 33), (1, 130, 512),
                                                ("int8", "bf16")):
        cases.append(dec_cross_case(rn, g, B5, H5, beams_c, s_c, kind))
    for beams_c, s_c, kind in itertools.product((9, 11, 16, 17, 24), (1, 130, 512),
                                                ("int8", "bf16")):
        cases.append(dec_cross_case(rn, g, B5, H5, beams_c, s_c, kind, "grouped"))
    return cases


def gemm_how(plan) -> str:
    """A gemm plan as a row names it."""
    if plan.variant == "mid_m":
        return f"mid_m {plan.bn} cols split {plan.split}"
    return plan.variant + (f" split {plan.split}" if plan.variant == "small_m" else "")


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


def dec_cross_group_identity() -> str | None:
    """dec_cross_attention past 8 beams (B 32 x beams 11 and 16 x heads 16,
    S 512, int8 and bf16, item 0's keys all masked): each group's rows
    bit-identical to the kernel of that many beams on those q rows alone,
    so a beam's sums do not depend on the beams beside it. -> None, or what
    differed."""
    import itertools

    import torch

    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device="cuda").manual_seed(78)

    def rn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)

    for beams, kind in itertools.product((11, 16), ("int8", "bf16")):
        q, kk, vv, ks, vs, ebias = dec_cross_inputs(rn, g, 32, 16, beams, 512, kind)
        out = K.dec_cross_attention(q, kk, vv, ks, vs, ebias, 16).view(32, beams, -1)
        q3 = q.view(32, beams, -1)
        for lo in range(0, beams, 8):
            n = min(8, beams - lo)
            alone = K.dec_cross_attention(q3[:, lo:lo + n].reshape(32 * n, -1).contiguous(), kk,
                                          vv, ks, vs, ebias, 16)
            if not torch.equal(out[:, lo:lo + n].reshape(32 * n, -1), alone):
                return f"beams {beams} {kind}: group of beams {lo}..{lo + n - 1} differs"
    return None


def dec_cross_inputs(rn, g, items: int, heads: int, beams: int, s_len: int, kind: str,
                     keep=None):
    """q, K, V, their scales (int8) and the pad bias of a dec_cross_attention
    call: each item's keys kept up to `keep` [items, 1], by default none
    for item 0 (the twin's softmax is uniform there), the first half for
    item 1 and all for the others."""
    import torch

    if keep is None:
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
    return q, kk, vv, ks, vs, ebias


def dec_cross_case(rn, g, items: int, heads: int, beams: int, s_len: int, kind: str,
                   variant: str | None = None):
    """A correctness-only dec_cross_attention case (dec_cross_inputs), by
    dec_cross_plan's plan or, given a variant, by that variant's."""
    from vacnic_tpu_torch.kernels import primitives as K

    args = dec_cross_inputs(rn, g, items, heads, beams, s_len, kind)
    plan = None if variant is None else K.dec_cross_variant_plan(
        variant, beams, s_len, 1 if kind == "int8" else 2)
    return (f"dec_cross_attention {kind} B={items} beams={beams} S={s_len}"
            + (f" [{plan.variant}]" if plan is not None else ""),
            "dec_cross_attention", lambda: K._dec_cross_planned(plan, *args, heads),
            lambda: K.dec_cross_attention_plain(*args, heads), None, 0.0, PEAK_BF16_FLOPS, None)


def dec_cross_bytes(args) -> int:
    """The bytes a dec_cross_attention call must move: q in and out (bf16),
    K and V once an item, the bias and (int8) the scales."""
    q, kk, _, ks, _, ebias = args
    return (2 * q.numel() * 2 + 2 * kk.numel() * kk.element_size() + ebias.numel() * 4
            + (2 * ks.numel() * 4 if ks is not None else 0))


def dec_cross_timed(rn, g, items: int, beams: int, s_len: int, kind: str, kern: str,
                    heads: int = 16):
    """A timed dec_cross_attention case: q of items x beams rows, K/V of
    `kind`, each item's keys masked past a random point in [S/2, S]. The
    bound counts each K/V element once an item (read by every beam group of
    it); bf16 also against SDPA over [items, H, beams, 64] queries. Past 8
    beams the row names the plan's variant and has the other launch past 8
    at the same shape beside it ("other": the groups of 8 beside the wide
    block, or the wide block beside the groups)."""
    import torch
    import torch.nn.functional as Fn

    from vacnic_tpu_torch.kernels import primitives as K

    args = dec_cross_inputs(
        rn, g, items, heads, beams, s_len, kind,
        torch.randint(s_len // 2, s_len + 1, (items, 1), device="cuda", generator=g))
    q, kk, vv, ks, vs, ebias = args
    lib = None
    if kind != "int8":
        emask = (ebias > -1)[:, None, None, :]
        lib = (lambda: Fn.scaled_dot_product_attention(
            q.view(items, beams, heads, 64).transpose(1, 2), kk.transpose(2, 3),
            vv.transpose(2, 3), attn_mask=emask))
    plan = K.dec_cross_plan(beams, s_len, kk.element_size())
    extra = ()
    if plan.variant != "beams":  # the other launch past 8 beams, beside the plan's
        other = K.dec_cross_variant_plan("grouped" if plan.variant == "wide" else "wide", beams,
                                         s_len, kk.element_size())
        extra = (("other", f"{other.variant} at the same shape",
                  lambda: K._dec_cross_planned(other, *args, heads)),)
    return (f"dec_cross_attention {kind} B={items} beams={beams} S={s_len}"
            + (f" [{plan.variant}]" if beams > K.DEC_CROSS_GROUP else ""), kern,
            lambda: K.dec_cross_attention(*args, heads),
            lambda: K.dec_cross_attention_plain(*args, heads),
            dec_cross_bytes(args), 4.0 * items * beams * s_len * heads * 64, PEAK_BF16_FLOPS, lib,
            *extra)


def tolerance(out) -> tuple[float, float]:
    """bf16 outputs: one bf16 rounding; f32 outputs: f32 sum order."""
    import torch

    return (2e-2, 2e-2) if out.dtype == torch.bfloat16 else (2e-3, 2e-3)


# checked bit-identical over two calls
REPEATABLE = ("gemm_bf16", "layernorm", "dec_cross_attention", "dec_self_attention", "lm_head",
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
    for name, kern, call, plain, byts, ops, peak, lib, *extra in kernel_cases():
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
        # beside the library call: a second PyTorch yardstick ("second") or
        # the other TMA kernel at the same shape ("other")
        for key, label, fn in extra:
            row.update({key: label, f"{key}_ms": time_ms(fn, reps),
                        f"{key}_graph_ms": graph_ms(fn, reps)})
        rows.append(row)
        log(f"kernel {name}: max_abs_err {', '.join(errs)} {'ok' if ok else 'FAIL'}; ms {ms:.4f} "
            f"graph_ms {g_ms:.4f} plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms {lib_ms} "
            f"library_graph_ms {lib_g_ms}"
            + (f"; earlier {EARLIER[name]}" if name in EARLIER else "") + "".join(
                f"; {row[key]}: ms {row[f'{key}_ms']:.4f} "
                f"graph_ms {row[f'{key}_graph_ms']:.4f}" for key, _, _ in extra))
        if not ok:
            failures.append(name)
    pow2 = dec_self_pow2_identity()
    log("kernel dec_self_attention int8 with power-of-two scales vs bf16 on the dequantized "
        f"cache, BK=160 H=16 T=64 pos 0/1/31/49/63: {pow2 or 'bit-identical ok'}")
    if pow2:
        failures.append("dec_self_attention int8 power-of-two identity")
    groups = dec_cross_group_identity()
    log("kernel dec_cross_attention past 8 beams, B=32 x beams 11 / 16 x H=16 S=512, int8 and "
        "bf16: each group of 8 beams vs the kernel of that many beams on its q rows alone: "
        f"{groups or 'bit-identical ok'}")
    if groups:
        failures.append("dec_cross_attention group identity")
    rows += cross_kv_rows(failures)
    if failures:
        raise RuntimeError(f"kernels disagree with their plain twins: {failures}")
    return rows


CROSS_KV_TIMED = (256, 32, 8, 1)  # items at S 512: the cells' batch, the service's buckets


def cross_kv_rows(failures: list) -> list:
    """cross_kv (csrc/gemm_bf16.cu's cross_kv_gemm_kernel) against its twin,
    int8 and bf16, at batch 256 / 32 / 8 / 1 x S 512 x d 1024 (two layers,
    cross_kv_gaps; the int8 share of entries off by one is logged), one
    launch a layer; then one layer timed at each of those shapes: ms, graph
    ms, the bound, the twin (the recipe the decode cache ran before, f32
    products of bf16 values and plain passes), the f32 library product and
    bias alone (`library`), bf16 addmm (`second`)."""
    import torch

    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device="cuda")
    g.manual_seed(2206)
    d, s_len, rows = 1024, 512, []
    heads = d // 64
    for batch in CROSS_KV_TIMED:
        x, w, b = cross_kv_inputs(g, batch, s_len, d, layers=2)
        for int8 in (True, False):
            before = K.launch_counts()["cross_kv"]
            got = K.cross_kv(x, w, b, heads, int8)
            torch.cuda.synchronize()
            launched = K.launch_counts()["cross_kv"] - before
            gaps = cross_kv_gaps(got, K.cross_kv_plain(x, w, b, heads, int8))
            ok = gaps["ok"] and launched == 2
            log(f"kernel cross_kv B={batch} S={s_len} d={d} {'int8' if int8 else 'bf16'}, 2 "
                f"layers: {gaps}, {launched} launches {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"cross_kv B={batch} {'int8' if int8 else 'bf16'}")
        x1, w1, b1 = x, w[:1].contiguous(), b[:1].contiguous()
        xf, wf = x1.float(), w1[0].float()
        byts = (x1.numel() * 2 + w1.numel() * 2 + b1.numel() * 4 + 2 * x1.numel()
                + 2 * batch * d * 4)
        b_ms, b_by = bound(byts, 2.0 * batch * s_len * d * 2 * d)
        row = {"name": f"cross_kv B={batch} S={s_len} d={d} int8 (one layer)",
               "kernel": "cross_kv", "route": "cuda", "source": SOURCES["cross_kv"],
               "replaces": REPLACES["cross_kv"],
               "launches": None, "ms": time_ms(lambda: K.cross_kv(x1, w1, b1, heads, True), 5),
               "graph_ms": graph_ms(lambda: K.cross_kv(x1, w1, b1, heads, True), 5),
               "bound_ms": b_ms, "bound_by": b_by,
               "plain_ms": time_ms(lambda: K.cross_kv_plain(x1, w1, b1, heads, True), 3, warmup=1),
               "library": "f32 product + bias of bf16 values, as the decode cache ran it",
               "library_ms": time_ms(lambda: torch.addmm(b1[0], xf.view(-1, d), wf), 3),
               "library_graph_ms": graph_ms(lambda: torch.addmm(b1[0], xf.view(-1, d), wf), 3),
               "second": "bf16 addmm, product + bias only",
               "second_ms": time_ms(lambda: torch.addmm(b1[0].to(torch.bfloat16),
                                                        x1.view(-1, d), w1[0]), 5)}
        rows.append(row)
        log(f"kernel {row['name']}: ms {row['ms']:.4f} graph_ms {row['graph_ms']:.4f} bound_ms "
            f"{b_ms:.4f} ({b_by}) plain_ms {row['plain_ms']:.4f} library_ms "
            f"{row['library_ms']:.4f} library_graph_ms {row['library_graph_ms']:.4f}; "
            f"bf16 addmm ms {row['second_ms']:.4f}")
        del x, w, b, x1, w1, b1, xf, wf, got
        torch.cuda.empty_cache()
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


CROSS_KV_SHARE = 0.01           # int8 entries that may differ, by one, from the twin's
CROSS_KV_SCALE_REL = 2.0 ** -7  # a scale's relative gap: one bf16 ulp of its amax
CROSS_KV_ULP_FLOOR = 2.0 ** -10  # bf16: the ulp is taken at no less than this magnitude


def cross_kv_inputs(g, batch: int, s_len: int, d: int, layers: int = 1):
    """Cross K/V inputs on the card: x [B, S, d] bf16 ~ N(0, 1) (a LayerNorm's
    output), w [L, d, 2d] bf16 and b [L, 2d] f32 ~ N(0, 0.02) (the weights'
    initial scale)."""
    import torch

    x = torch.randn(batch, s_len, d, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(layers, d, 2 * d, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    return x, w, torch.randn(layers, 2 * d, generator=g, device="cuda") * 0.02


def cross_kv_gaps(got, ref) -> dict:
    """The kernel's cross K/V (k, v, k_scale, v_scale) against the twin's ->
    readings and `ok`. int8: values within +-1 on at most CROSS_KV_SHARE of
    the entries, scales within CROSS_KV_SCALE_REL (the two sum the products
    in other orders, so a bf16 value, and with it an amax, may round one ulp
    apart: 2^-7 of an amax just above a power of two). bf16: within one bf16
    ulp of the twin's value, the ulp taken at
    no less than CROSS_KV_ULP_FLOOR: below it the sums' order alone (~1e-6
    over 1024 products) moves a value by more than its ulp."""
    import torch

    out = {"ok": all(a.shape == r.shape and a.dtype == r.dtype
                     for a, r in zip(got, ref) if r is not None)
           and all((a is None) == (r is None) for a, r in zip(got, ref))}
    if not out["ok"]:
        return out
    k, v, ks, vs = got
    rk, rv, rks, rvs = ref
    if ks is not None:
        diffs = [(a.int() - r.int()).abs() for a, r in ((k, rk), (v, rv))]
        out["max_diff"] = max(int(dd.max()) for dd in diffs)
        out["share"] = sum(int((dd != 0).sum()) for dd in diffs) / (2 * k.numel())
        out["scale_rel"] = max(float(((a - r).abs() / r.abs()).max())
                               for a, r in ((ks, rks), (vs, rvs)))
        out["ok"] = (out["max_diff"] <= 1 and out["share"] <= CROSS_KV_SHARE
                     and out["scale_rel"] <= CROSS_KV_SCALE_REL)
    else:
        out["ulps"] = max(float(((a.float() - r.float()).abs()
                                 / bf16_ulp(r.float().abs().clamp(min=CROSS_KV_ULP_FLOOR))).max())
                          for a, r in ((k, rk), (v, rv)))
        out["ok"] = out["ulps"] <= 1.0
    return out


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


GEMM_SWEEP_M = (320, 512, 640, 1024, 1280, 2048, 4096)  # the decoder's and the encoder's rows


def run_gemmplan_phase(gpu: str) -> None:
    """Readings behind gemm_plan's mid_m rule and GEMM_MID_M_MAX: at each M of
    GEMM_SWEEP_M and each of a layer's five products, graph ms of every
    mid_m plan (tile width 64 / 128 x split 1, 2, 4 dividing the k tiles,
    through the private entry), of large_m and of bf16 addmm; each kernel
    result held to the plain twin (tolerance()). One line a shape, the
    plan's pick starred; then a layer-step (qkv, self_out twice, cross_q,
    fc1, fc2) by M: the plan's, the best plan's, large_m's and addmm's sums.
    Full table: chiprun_out/chip_smoke/gemm_plans.txt."""
    import torch

    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device="cuda").manual_seed(4321)
    bf = torch.bfloat16
    d, F = 1024, 4096
    f32 = torch.float32
    products = (("qkv", d, 3 * d, None, False, bf, 1), ("self_out", d, d, None, True, f32, 2),
                ("cross_q", d, d, None, False, bf, 1), ("fc1", d, F, K.GELU, False, bf, 1),
                ("fc2", F, d, None, True, f32, 1))
    lines, failures, step = [], [], {}
    for m in GEMM_SWEEP_M:
        sums = step.setdefault(m, {"plan": 0.0, "best": 0.0, "large_m": 0.0, "addmm": 0.0})
        for sub, k, n, act, res, out, times in products:
            a = torch.randn(m, k, generator=g, device="cuda").to(bf)
            w = (torch.randn(k, n, generator=g, device="cuda") * 0.02).to(bf)
            b = torch.randn(n, generator=g, device="cuda") * 0.02
            r = torch.randn(m, n, generator=g, device="cuda") if res else None
            ref = K.gemm_plain(a, w, b, r, act, out)
            k_tiles = -(-k // K.GEMM_BK)
            plans = [K.GemmPlan("mid_m", split, bn) for bn in (64, 128) for split in (1, 2, 4)
                     if k_tiles % split == 0] + [K.GemmPlan("large_m")]
            got = {}
            for plan in plans:
                fn = (lambda plan=plan: K._gemm_planned(plan, a, w, b, r, act, out))
                o = fn().float()
                tol_a, tol_r = tolerance(ref)
                if not bool(((o - ref.float()).abs() <= tol_a + tol_r * ref.float().abs()).all()):
                    failures.append(f"M={m} {sub} {gemm_how(plan)}")
                got[plan] = graph_ms(fn)
            lib = graph_ms(lambda: torch.addmm(b.to(bf), a, w))
            pick = K.gemm_plan(m, n, k) if m <= K.GEMM_MID_M_MAX else K._mid_m_plan(m, n, k)
            mids = {p: t for p, t in got.items() if p.variant == "mid_m"}
            best = min(mids, key=mids.get)
            sums["plan"] += times * mids[pick]
            sums["best"] += times * mids[best]
            sums["large_m"] += times * got[K.GemmPlan("large_m")]
            sums["addmm"] += times * lib
            lines.append(f"M={m} {sub} K={k} N={n}: " + ", ".join(
                f"{'*' if p == pick else ''}{gemm_how(p)} {t:.4f}" for p, t in got.items())
                + f", addmm {lib:.4f} (graph ms; * the mid_m plan's pick, best {gemm_how(best)})")
    with open(os.path.join(OUT_DIR, "gemm_plans.txt"), "w") as f:
        f.write("\n".join(lines + [gpu]) + "\n")
    for line in lines:
        log(f"gemmplan {line}")
    for m, sums in step.items():
        log(f"gemmplan layer-step at M={m} (graph ms, self_out twice): mid_m as planned "
            f"{sums['plan']:.4f}, best mid_m plans {sums['best']:.4f}, large_m "
            f"{sums['large_m']:.4f}, addmm {sums['addmm']:.4f} ({gpu})")
    if failures:
        raise RuntimeError(f"gemmplan: kernels disagree with the plain twin: {failures}")


CROSS_SWEEP_ITEMS = (8, 16, 32)  # the ladder's 8 x 11 and 32 x 16 beams' batches, and between
CROSS_SWEEP_BEAMS = (9, 11, 16, 17, 24)  # two and three n8 operands, whole and ragged


def run_crossplan_phase(gpu: str) -> None:
    """Readings behind dec_cross_plan's rule past 8 beams: at B 8, 16 and 32
    x beams 9, 11, 16, 17, 24 x int8 and bf16 (H 16, S 512, each item's keys
    masked past a random point in [S/2, S], as dec_cross_timed makes them),
    graph ms of the groups of 8 and of the wide block (the shared memory of
    each, and so its blocks a SM, in the line), each through the launcher
    with an explicit plan, held to the plain twin (tolerance()) and the
    wide output bit-identical to the grouped one; the plan's pick starred,
    the bound beside. Full table: chiprun_out/chip_smoke/cross_plans.txt."""
    import itertools

    import torch

    from vacnic_tpu_torch.kernels import primitives as K

    g = torch.Generator(device="cuda").manual_seed(4322)

    def rn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)

    lines, failures = [], []
    for items, beams, kind in itertools.product(CROSS_SWEEP_ITEMS, CROSS_SWEEP_BEAMS,
                                                ("int8", "bf16")):
        heads, s_len, eb = 16, 512, 1 if kind == "int8" else 2
        args = dec_cross_inputs(rn, g, items, heads, beams, s_len, kind, torch.randint(
            s_len // 2, s_len + 1, (items, 1), device="cuda", generator=g))
        ref = K.dec_cross_attention_plain(*args, heads)
        pick = K.dec_cross_plan(beams, s_len, eb)
        got, outs = [], {}
        for variant in ("grouped", "wide"):
            plan = K.dec_cross_variant_plan(variant, beams, s_len, eb)
            fn = (lambda plan=plan: K._dec_cross_planned(plan, *args, heads))
            out = outs[variant] = fn()
            tol_a, tol_r = tolerance(out)
            if not bool(((out.float() - ref.float()).abs()
                         <= tol_a + tol_r * ref.float().abs()).all()):
                failures.append(f"B={items} beams={beams} {kind} {variant}: vs twin")
            got.append(f"{'*' if plan == pick else ''}{variant} ({plan.smem} B) "
                       f"{graph_ms(fn):.4f}")
        if not torch.equal(outs["wide"], outs["grouped"]):
            failures.append(f"B={items} beams={beams} {kind}: wide not bit-identical to the "
                            "groups of 8")
        b_ms, b_by = bound(dec_cross_bytes(args), 4.0 * items * beams * s_len * heads * 64)
        lines.append(f"B={items} beams={beams} {kind}: " + ", ".join(got)
                     + f"; bound {b_ms:.4f} ({b_by}) (graph ms; * the plan's pick)")
    with open(os.path.join(OUT_DIR, "cross_plans.txt"), "w") as f:
        f.write("\n".join(lines + [gpu]) + "\n")
    for line in lines:
        log(f"crossplan {line} ({gpu})")
    if failures:
        raise RuntimeError(f"crossplan: {failures}")


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

def full_model(seed: int = 0, cfg=None):
    """`cfg` (VacnicConfig.full_train() by default) decoding every step
    (min_length = max_length - 1) and its random bf16 tree from `seed`, on
    the card."""
    import torch

    from vacnic_tpu_torch.core.config import VacnicConfig
    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.models.fusion import multimodal_bart_init
    from vacnic_tpu_torch.models.weights_io import tree_to

    cfg = cfg or VacnicConfig.full_train()
    cfg = dataclasses.replace(cfg, decode=dataclasses.replace(
        cfg.decode, min_length=cfg.decode.max_length - 1))
    params = multimodal_bart_init(make_generator(seed, "cuda"), cfg.bart, cfg.fusion,
                                  device="cuda")
    return cfg, tree_to(params, dtype=torch.bfloat16)


def batch_inputs(cfg, batch_size: int):
    from vacnic_tpu_torch.data.synthetic import synthetic_batch
    from vacnic_tpu_torch.train.train_step import create_mask, face_mask_from_emb

    b = {k: v.cuda() for k, v in synthetic_batch(cfg, batch_size=batch_size, seed=0).items()}
    x = dict(input_ids=b["article_ids"], attention_mask=create_mask(b["article_ids"]),
             image_features=b["image_cls"])
    if not cfg.fusion.only_image:
        x.update(face_features=b["face_emb"], face_mask=face_mask_from_emb(b["face_emb"]),
                 name_ids=b["names_art_ids"], name_mask=create_mask(b["names_art_ids"]))
    return x


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-6))


def run_stacks_phase(cfg, params) -> dict:
    """Full width, batches 2 and 4 (the encoder's products at M 1024 and
    2048): the fused encoder (CUDA text stack) against the layer-by-layer
    encoder, and three kernel decode steps against the reference decode
    step, both in bf16 on the card. Tolerance: max error <= 5% of the
    reference's max magnitude (a bf16 model run two ways). -> gemm_bf16's
    launches by kernel in each batch's fused encoder ("gemm_bf16:mid_m:stacks_b2")."""
    import torch

    from vacnic_tpu_torch.kernels import primitives as K
    from vacnic_tpu_torch.models import fusion as F

    bf = torch.bfloat16
    launches = {}
    for batch in (2, 4):
        x = batch_inputs(cfg, batch)
        kw = {k: x[k] for k in ("face_features", "face_mask", "name_ids", "name_mask")}
        args = (params, x["input_ids"], x["attention_mask"], x["image_features"], cfg.bart,
                cfg.fusion)
        with torch.no_grad():
            K.reset_launch_counts()
            fused = F.mm_encoder_fwd_fused(*args, dtype=bf, **kw)["last_hidden"]
            torch.cuda.synchronize()
            by_kernel = K.gemm_variant_counts()
            launches.update({f"gemm_bf16:{v}:stacks_b{batch}": n for v, n in by_kernel.items()})
            ref = F.mm_encoder_fwd(*args, dtype=bf, **kw)["last_hidden"]
            e_enc = rel_err(fused, ref)
        e_dec, agree = decode_steps_error(cfg, params, x, ref)
        log(f"stacks b{batch}: fused encoder (gemm_bf16 by kernel {by_kernel}) vs "
            f"layer-by-layer rel err {e_enc:.3e}; kernel decode step vs reference rel err "
            f"{e_dec:.3e}, argmax agreement {agree:.3f} (tol rel 5e-2)")
        if not (e_enc <= 5e-2 and e_dec <= 5e-2):
            raise RuntimeError(f"full-width stacks disagree with their references at batch {batch}")
    return launches


def decode_steps_error(cfg, params, x: dict, enc, steps: int = 3) -> tuple[float, float]:
    """`steps` kernel decode steps (decode_step_kernel: the CUDA decoder
    stack at BK = batch x cfg's beams, on the time-major cache) against the
    reference step (plain PyTorch, batch-major cache), both bf16 on the card
    from the same encoder output `enc`, each step's tokens the reference's
    argmax -> (the largest relative error of the logits, the lowest argmax
    agreement)."""
    import torch

    from vacnic_tpu_torch.infer import decode_fast as DF
    from vacnic_tpu_torch.models.layers import expand_mask

    bf, beams, length = torch.bfloat16, cfg.decode.num_beams, cfg.decode.max_length
    with torch.no_grad():
        dp = DF.build_decode_params(params, bf)
        c_ref = DF.build_decode_cache(params, enc, beams, length, cfg.bart, bf, pad_to=16)
        c_ker = DF.build_decode_cache(params, enc, beams, length, cfg.bart, bf, pad_to=16,
                                      time_major=True)
        gaps = cross_kv_gaps((c_ker.cross_k, c_ker.cross_v, None, None),
                             (c_ref.cross_k, c_ref.cross_v, None, None))
        if not gaps["ok"]:  # the kernel path's bf16 cross K/V against the reference path's
            raise RuntimeError(f"decode cache: the kernel's cross K/V against the plain "
                               f"recipe's at batch {enc.shape[0]}: {gaps}")
        bias = expand_mask(x["attention_mask"], 1)
        tok = torch.full((enc.shape[0] * beams, 1), cfg.bart.decoder_start_token_id,
                         device="cuda")
        e_dec, agree = 0.0, 1.0
        for pos in range(steps):
            lr, c_ref = DF.decode_step(dp, params, c_ref, tok, pos, bias, cfg.bart, bf)
            lk, c_ker = DF.decode_step_kernel(dp, params, c_ker, tok, pos, bias, cfg.bart, bf)
            e_dec = max(e_dec, rel_err(lk, lr))
            agree = min(agree, float((lk.argmax(-1) == lr.argmax(-1)).float().mean()))
            tok = lr.argmax(-1, keepdim=True)
    return e_dec, agree


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


def counts_by_kernel() -> dict:
    """The launch counts since the last reset, with gemm_bf16's, layernorm's
    and dec_self_attention's split by kernel ("gemm_bf16:small_m", ...) and
    dec_cross_attention's by the beams of an item ("dec_cross_attention:beams5")
    and by the plan's variant ("dec_cross_attention:wide")."""
    from vacnic_tpu_torch.kernels import primitives as K

    counts = K.launch_counts()
    counts.update({f"gemm_bf16:{v}": n for v, n in K.gemm_variant_counts().items()})
    counts.update({f"layernorm:{v}": n for v, n in K.layernorm_variant_counts().items()})
    counts.update({f"dec_self_attention:{v}": n for v, n in K.dec_self_variant_counts().items()})
    counts.update({f"dec_cross_attention:beams{b}": n
                   for b, n in K.dec_cross_beam_counts().items()})
    counts.update({f"dec_cross_attention:{v}": n for v, n in K.dec_cross_variant_counts().items()})
    return counts


def gemm_plan_counts(cfg, batch_size: int) -> dict:
    """gemm_bf16's launches by kernel in one generate_mm of `batch_size` rows
    on `cfg`, as kernels/primitives.gemm_plan places the six products of a
    layer (fused qkv, self out, cross q, cross out, fc1, fc2): the encoder's
    once an encoder layer at M = batch x the article's tokens, the decoder's
    once a decoder layer a step at M = batch x beams (every step runs:
    min_length = max_length - 1)."""
    from vacnic_tpu_torch.kernels import primitives as K

    b, d = cfg.bart, cfg.bart.d_model
    steps = cfg.decode.max_length - 1
    out = {v: 0 for v in K.GEMM_VARIANTS}
    for m, ffn, times in ((batch_size * cfg.data.article_max_length, b.encoder_ffn_dim,
                           b.encoder_layers),
                          (batch_size * cfg.decode.num_beams, b.decoder_ffn_dim,
                           b.decoder_layers * steps)):
        for k, n in ((d, 3 * d), (d, d), (d, d), (d, d), (d, ffn), (ffn, d)):
            out[K.gemm_plan(m, n, k).variant] += times
    return out


def check_slice_counts(tag: str, cfg, batch_size: int) -> dict:
    """The launch counts since the last reset, held to one batch of
    `batch_size` rows of the slice's path (the fused encoder, then every
    decode step on the bf16 self cache) -> the counts with the per-kernel
    splits added."""
    from vacnic_tpu_torch.kernels import primitives as K

    counts = counts_by_kernel()
    by_kernel = K.gemm_variant_counts()
    ln_by_kernel = K.layernorm_variant_counts()
    self_by_kind = K.dec_self_variant_counts()
    cross_by_beams = K.dec_cross_beam_counts()
    check_launched(tag, counts, SLICE_KERNELS)
    planned = gemm_plan_counts(cfg, batch_size)
    # the same placement stated apart from gemm_plan, by rows alone: small_m
    # up to 256, mid_m from 257 to GEMM_MID_M_MAX, large_m past it -- the
    # encoder's products at M = batch x the article's tokens, the decoder's
    # at M = batch x beams
    def by_rows(m):
        return "small_m" if m <= 256 else "mid_m" if m <= K.GEMM_MID_M_MAX else "large_m"

    stated = {v: 0 for v in K.GEMM_VARIANTS}
    stated[by_rows(batch_size * cfg.data.article_max_length)] += 6 * cfg.bart.encoder_layers
    stated[by_rows(batch_size * cfg.decode.num_beams)] += (
        6 * cfg.bart.decoder_layers * (cfg.decode.max_length - 1))
    if planned != stated:
        raise RuntimeError(f"{tag}: gemm_plan places the products as {planned}, not as stated "
                           f"({stated}) at batch {batch_size} x {cfg.decode.num_beams} beams")
    log(f"{tag}: gemm_bf16 by kernel {by_kernel}, gemm_plan's {planned}")
    if by_kernel != planned:
        raise RuntimeError(f"{tag}: gemm_bf16 kernels {by_kernel}: expected {planned}, as "
                           f"gemm_plan places the encoder's and the decoder's products at "
                           f"batch {batch_size}")
    # one launch a call: three layer norms an encoder layer and a decoder
    # layer a step, one cross-attention a decoder layer a step; d = 1024 is
    # the register-resident kernel's
    steps = cfg.decode.max_length - 1  # min_length = max_length - 1: every step runs
    dec_layers = cfg.bart.decoder_layers
    want = {"layernorm": 3 * cfg.bart.encoder_layers + 3 * dec_layers * steps,
            "dec_cross_attention": dec_layers * steps, "dec_self_attention": dec_layers * steps,
            "cross_kv": dec_layers}  # the decode cache's cross K/V: one launch a decoder layer
    # dec_cross_attention's variant, as dec_cross_plan picks it for the
    # beams over the article's tokens in int8 (the paths' cross K/V)
    cross_plan = K.dec_cross_plan(cfg.decode.num_beams, cfg.data.article_max_length, 1)
    cross_by_variant = K.dec_cross_variant_counts()
    want_variant = {v: want["dec_cross_attention"] * (v == cross_plan.variant)
                    for v in K.DEC_CROSS_VARIANTS}
    log(f"{tag}: layernorm by kernel {ln_by_kernel}, dec_self_attention by cache {self_by_kind}, "
        f"dec_cross_attention by beams {cross_by_beams} and by variant {cross_by_variant}; "
        f"expected {want}, dec_cross all {cross_plan.variant}")
    if any(counts[k] != n for k, n in want.items()) or ln_by_kernel != {
            "warp": want["layernorm"], "block": 0} or self_by_kind != {
            "bf16": want["dec_self_attention"], "int8": 0, "fp8": 0} or cross_by_beams != {
            cfg.decode.num_beams: want["dec_cross_attention"]} or cross_by_variant != want_variant:
        raise RuntimeError(f"{tag}: launches {counts}, layernorm by kernel {ln_by_kernel}, "
                           f"dec_self_attention by cache {self_by_kind}, dec_cross_attention "
                           f"by beams {cross_by_beams}, by variant {cross_by_variant}: expected "
                           f"{want}, all layernorm launches the warp kernel's, all dec_self the "
                           f"bf16 cache's, all dec_cross at {cfg.decode.num_beams} beams on "
                           f"the {cross_plan.variant} kernel")
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
    keys = ("article_ids", "pixels" if with_pixels else "image_cls")
    if not cfg.fusion.only_image:
        keys += ("face_emb", "names_art_ids")
    return [{k: b[k][i].numpy() for k in keys} for i in range(n)]


def direct_generate(cfg, model, rows, img_cls=None):
    """generate_mm on the card of the stacked rows, as the service runs it
    -> (tokens [n, L] int64, scores [n] f32), both on the CPU."""
    import numpy as np
    import torch

    from vacnic_tpu_torch.infer.generate import generate_mm
    from vacnic_tpu_torch.train.train_step import create_mask, face_mask_from_emb

    b = {k: torch.from_numpy(np.stack([r[k] for r in rows])).cuda() for k in rows[0]}
    streams = {} if cfg.fusion.only_image else dict(
        face_features=b["face_emb"], face_mask=face_mask_from_emb(b["face_emb"]),
        name_ids=b["names_art_ids"], name_mask=create_mask(b["names_art_ids"]))
    seqs, scores = generate_mm(
        model, b["article_ids"], create_mask(b["article_ids"]),
        b["image_cls"] if img_cls is None else img_cls, cfg.bart, cfg.fusion, cfg.decode,
        dtype=torch.bfloat16, device="cuda", **streams)
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


HEAD_PROBE_ROUNDS = 200  # ROADMAP C.10's probe: rounds of each way of running the library head


def head_thread_probe(params, bk: int, rounds: int = HEAD_PROBE_ROUNDS) -> dict:
    """ROADMAP C.10's suspect, tested: the default library head
    (decode_fast._lm_head, as the decode step runs it: the f32 cast of the
    tied weights, then the f32 product) on the same x [bk, d], `rounds`
    times each on this thread, on a second thread on its current (default)
    stream, as the service's batcher runs it, and on a second thread on a
    stream of its own, each result held bit for bit to this thread's first
    -> rounds that differ, by way."""
    import threading

    import torch

    from vacnic_tpu_torch.infer import decode_fast as DF

    g = torch.Generator(device="cuda").manual_seed(91)
    d = params["shared"]["weight"].shape[1]
    x = torch.randn(bk, d, generator=g, device="cuda").to(torch.bfloat16)
    differ = {"this thread": 0, "second thread, its current stream": 0,
              "second thread, a stream of its own": 0}

    def run(way, stream=None):
        with torch.no_grad(), torch.cuda.stream(stream):
            for _ in range(rounds):
                differ[way] += not torch.equal(DF._lm_head(params, x, torch.bfloat16), ref)

    with torch.no_grad():
        ref = DF._lm_head(params, x, torch.bfloat16)
    torch.cuda.synchronize()
    run("this thread")
    for way, stream in (("second thread, its current stream", None),
                        ("second thread, a stream of its own", torch.cuda.Stream())):
        t = threading.Thread(target=run, args=(way, stream))
        t.start()
        t.join()
    return differ


def run_serve_phase(cfg, params, batch_size: int, gpu: str, slice_counts=None) -> dict:
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
    sequential single requests (their gemm_bf16 launches by kernel counted:
    the encoder at M 512) and the captions/s of a burst of 256
    requests over HTTP, of the same rows submitted in this process, and of
    eight direct generate_mm calls of 32 on them. The HTTP clients run in
    this process: their JSON bodies are made before the clock starts, but
    their threads and sockets share the interpreter with the server's.
    (5) ROADMAP C.10's probe (head_thread_probe) at BK 160 and 1280, the
    32-request batch's and the 256 bucket's: a reading. -> the b1 requests'
    gemm_bf16 launches by kernel ("gemm_bf16:mid_m:serve_b1")."""
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
        counts = check_slice_counts("serve", cfg, batch_size)
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
    if K.gemm_plan(8 * cfg.data.article_max_length, cfg.bart.d_model,
                   cfg.bart.d_model).variant == "mid_m":
        MID_M_PATHS.add("serve pixels")
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
        K.reset_launch_counts()
        for body in [request_body(r) for r in sample_rows(cfg, 10, seed=2)]:
            t0 = time.perf_counter()
            post_caption(opener, base, body)
            lat.append((time.perf_counter() - t0) * 1e3)
        b1_gemm = K.gemm_variant_counts()
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
        f"{lat_sorted[-1]:.1f}); their gemm_bf16 launches by kernel {b1_gemm} ({gpu})")
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

    # (5) ROADMAP C.10: the library head's product, thread against thread
    for bk in (batch_size * cfg.decode.num_beams, 256 * cfg.decode.num_beams):
        t0 = time.perf_counter()
        differ = head_thread_probe(params, bk)
        log(f"serve: C.10 probe, decode_fast._lm_head at BK {bk} ({HEAD_PROBE_ROUNDS} rounds a "
            f"way, {time.perf_counter() - t0:.1f} s): rounds not bit-identical to this thread's "
            f"first result {differ} ({gpu})")
    return {f"gemm_bf16:{v}:serve_b1": n for v, n in b1_gemm.items()}


LADDER_BATCHES = (64, 128, 256)  # beam 5: BK 320, 640, 1280, every decoder product on mid_m
WIDE_BEAMS = ((8, 11), (32, 16))  # (batch, beams): BK 88 (small_m) and 512 (mid_m)
ROWS_AT = 32  # the ladder's encoder output held row by row against these many items at a time


def check_ladder_numbers(tag: str, cfg, params, x: dict) -> None:
    """The numbers of one ladder run, on its own inputs `x`, at its batch
    and beam count: (1) the fused encoder against the layer-by-layer one
    (check_fused_encoder, 5e-2); (2) past ROWS_AT items, every item of the
    fused output against the same items encoded ROWS_AT at a time (M 16384,
    large_m as at every ladder batch; at batch 256 the encoder's products reach 131072
    rows and fc1's output 2^31 bytes as f32, so a 32-bit offset would break
    the high rows): each item within 5e-2 of its own largest magnitude (the
    prologue's PyTorch products may sum in other orders at another batch);
    (3) three kernel decode steps at BK = batch x beams against the
    reference step from the layer-by-layer output (decode_steps_error,
    5e-2)."""
    import torch

    from vacnic_tpu_torch.models import fusion as F

    fused, ref = check_fused_encoder(tag, cfg, params, x)
    batch = x["input_ids"].shape[0]
    if batch > ROWS_AT:
        streams = {k: v for k, v in x.items()
                   if k not in ("input_ids", "attention_mask", "image_features")}
        with torch.no_grad():
            parts = [F.mm_encoder_fwd_fused(
                params, x["input_ids"][lo:lo + ROWS_AT], x["attention_mask"][lo:lo + ROWS_AT],
                x["image_features"][lo:lo + ROWS_AT], cfg.bart, cfg.fusion,
                dtype=torch.bfloat16, **{k: v[lo:lo + ROWS_AT] for k, v in streams.items()}
            )["last_hidden"] for lo in range(0, batch, ROWS_AT)]
        alone = torch.cat(parts)
        diff = (fused.float() - alone.float()).flatten(1).abs().amax(1)
        item_err = float((diff / alone.float().flatten(1).abs().amax(1).clamp(min=1e-6)).max())
        same = int((diff == 0).sum())
        log(f"{tag}: fused encoder at batch {batch} vs its items encoded {ROWS_AT} at a time: "
            f"worst item rel err {item_err:.3e}, {same} of {batch} items bit-identical "
            f"(tol rel 5e-2 an item)")
        if not item_err <= 5e-2:
            raise RuntimeError(f"{tag}: the fused encoder's items at batch {batch} disagree "
                               f"with the same items encoded {ROWS_AT} at a time")
        del parts, alone
    del fused
    e_dec, agree = decode_steps_error(cfg, params, x, ref)
    log(f"{tag}: kernel decode step vs reference at BK {batch * cfg.decode.num_beams}: rel err "
        f"{e_dec:.3e}, argmax agreement {agree:.3f} (tol rel 5e-2)")
    if not e_dec <= 5e-2:
        raise RuntimeError(f"{tag}: the kernel decode step disagrees with the reference step "
                           f"at BK {batch * cfg.decode.num_beams}")


def run_ladder_phase(cfg, params, gpu: str) -> dict:
    """Decoding at the beam counts and batches the slice does not take, on
    the slice's model and tree (full_train(), random bf16 weights from seed
    0, uncut; lp 2.0, length 50, min_length 49). (1) generate_mm at batch 8
    x 11 beams and batch 32 x 16 beams (dec_cross_attention past 8 beams:
    the wide block, as dec_cross_plan picks), (2) at batches 64, 128 and 256
    x beam 5: each through
    run_model_path, so with the slice's gates at that batch and beam count
    (every slice kernel launched, gemm_bf16's kernels as gemm_plan places
    the encoder's and the decoder's products, dec_cross_attention counted by
    beams, mean length >= 45, finite scores) and its readings (wall,
    captions/s, peak memory), then each with check_ladder_numbers on its own
    inputs (the fused encoder against the layer-by-layer one and, past 32
    items, against its items encoded 32 at a time; kernel decode steps at
    its BK against the reference step). (3) A reading: rows 0-31 of the batch-256
    inputs decoded at batch 32, token agreement with their batch-256
    captions (small_m and mid_m sum in other orders, and random weights
    have near-ties everywhere). (4) CaptionService with the default
    ServeConfig() (buckets up to 256): one request takes the batcher, then a
    burst of 256 rows queues behind it; the 256 must decode as one batch of
    the 256 bucket, each response token- and score-identical to a direct
    generate_mm of the same 256 rows. -> the launches of the rows of the
    kernels line that these runs measure."""
    import torch

    from vacnic_tpu_torch.kernels import primitives as K
    from vacnic_tpu_torch.serve import CaptionService, ServeConfig

    launches = {}
    kv = ENC_CROSS_KV["slice"]
    for batch, beams in WIDE_BEAMS:
        wcfg = dataclasses.replace(cfg, decode=dataclasses.replace(cfg.decode, num_beams=beams))
        x = batch_inputs(wcfg, batch)
        tag = f"ladder b{batch} x {beams} beams"
        counts, _ = run_model_path(tag, wcfg, params, x, gpu, kv=kv)
        launches[f"dec_cross_attention:beams{beams}"] = counts[f"dec_cross_attention:beams{beams}"]
        launches.update({f"gemm_bf16:{v}:beams{beams}": counts[f"gemm_bf16:{v}"]
                         for v in K.GEMM_VARIANTS})
        check_ladder_numbers(tag, wcfg, params, x)
    for batch in LADDER_BATCHES:
        x = batch_inputs(cfg, batch)
        counts, seqs = run_model_path(f"ladder b{batch}", cfg, params, x, gpu, kv=kv)
        launches.update({f"gemm_bf16:{v}:b{batch}": counts[f"gemm_bf16:{v}"]
                         for v in K.GEMM_VARIANTS})
        launches[f"dec_cross_attention:b{batch}"] = counts["dec_cross_attention"]
        check_ladder_numbers(f"ladder b{batch}", cfg, params, x)
        torch.cuda.empty_cache()
    run_model_path("ladder b256 rows 0-31 at batch 32", cfg, params,
                              {k: v[:32] for k, v in x.items()}, gpu, kv=kv)
    agree = float((TOKENS["ladder b256 rows 0-31 at batch 32"] == seqs[:32].cpu()).float().mean())
    log(f"ladder: rows 0-31 of batch 256 decoded at batch 32 against their batch-256 captions: "
        f"token agreement {agree:.4f} (a reading: the decoder's products sum in other orders "
        f"at BK 160 and 1280)")

    rows = sample_rows(cfg, LADDER_BATCHES[-1], seed=0)
    svc = CaptionService(cfg, {"model": params}, device="cuda")
    try:
        if svc.scfg != ServeConfig() or svc.scfg.buckets[-1] != len(rows):
            raise RuntimeError(f"ladder service: not the default buckets ending at "
                               f"{len(rows)}: {svc.scfg}")
        first = svc.submit(sample_rows(cfg, 1, seed=4)[0])  # one b1 batch takes the batcher
        time.sleep(0.1)  # past its collect window (max_wait_ms 10): the b1 decode has started
        t0 = time.perf_counter()
        futs = [svc.submit(r) for r in rows]
        t_submit = time.perf_counter() - t0
        first.result(timeout=600)
        results = [f.result(timeout=600) for f in futs]
        t_burst = time.perf_counter() - t0
        st = svc.stats()
        seqs, scores = direct_generate(cfg, svc.params["model"], rows)
    finally:
        svc.close()
    log(f"ladder service: default ServeConfig() buckets {svc.scfg.buckets}; {len(rows)} rows "
        f"submitted in {t_submit * 1e3:.1f} ms behind one b1 request, answered after "
        f"{t_burst:.3f} s; batches by bucket {st['bucket_counts']}, bucket_decode_ms "
        f"{st['bucket_decode_ms']} ({gpu})")
    if st["bucket_counts"] != {b: int(b in (1, len(rows))) for b in svc.scfg.buckets} or st[
            "errors"]:
        raise RuntimeError(f"ladder service: the burst did not decode as one batch of the 256 "
                           f"bucket: {st}")
    check_identical("ladder service", results, seqs, scores)
    TOKENS["ladder service b256"] = seqs
    if K.gemm_plan(len(rows) * cfg.decode.num_beams, cfg.bart.d_model,
                   cfg.bart.d_model).variant == "mid_m":
        MID_M_PATHS.add("ladder service b256")
    log(f"ladder service: {len(rows)} responses decoded in the 256 bucket, token- and "
        f"score-identical to a direct generate_mm of the same rows; the same rows' captions "
        f"as the ladder's batch 256 decoded them: "
        f"{'identical' if torch.equal(seqs, TOKENS['ladder b256']) else 'DIFFERENT'}")
    return launches


def build_lines() -> list[str]:
    """Registers a thread, spill bytes and shared memory of the two 512-token
    self-attention kernels, the encoder's cross-attention kernel, the four
    gemm_bf16 kernels (mid_m at both tile widths), the two layernorm kernels, the int8 and bf16
    dec_cross_attention kernels at five beams, at groups of 8 beams (past
    8) and the wide block's (two and three n8 operands), the bf16, int8 and
    fp8 dec_self_attention
    kernels at the slice's plans and the four lm_head and four lm_stats
    kernels (N = 64, 128, 192, 256 x rows a pass; BK 160 takes 192), from
    nvcc's -Xptxas -v output of this build. The dynamic shared memory is the
    launch's own (csrc/enc_attention.cu: ring + 4 S for the self-attention,
    what the built library states for the cross-attention; csrc/flash_attn.cu:
    two stages of K, V and the padded bias tile; both + 1024 to align the
    tiles, computed here for S = 512; gemm: what the built library states
    for the shape; dec_cross: dec_cross_smem_bytes, the wide block's at 16
    and 24 beams; dec_self:
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
               # 64- and 128-column tiles
               "gemm_mid_kernelILi1E": lib.vt_gemm_smem_bytes(3, 320, 64),
               "gemm_mid_kernelILi2E": lib.vt_gemm_smem_bytes(3, 320, 128),
               "layernorm_warp_kernelILi8ELb1E": 0,  # d = 1024: eight float4 slots a lane
               "layernorm_block_kernelILb1E": 0,
               # int8 (signed char, "a") and bf16 K/V, five beams, S = 512
               "dec_cross_kernelIaLi5E": K.dec_cross_smem_bytes(5, 512, 1),
               "dec_cross_kernelI13__nv_bfloat16Li5E": K.dec_cross_smem_bytes(5, 512, 2),
               # past 8 beams: blocks of a group of 8, S = 512
               "dec_cross_kernel_groupedIaE":
                   K.dec_cross_variant_plan("grouped", 16, 512, 1).smem,
               "dec_cross_kernel_groupedI13__nv_bfloat16E":
                   K.dec_cross_variant_plan("grouped", 16, 512, 2).smem,
               # and the wide block of two n8 operands (at 16 beams) and of
               # three (at 24), S = 512
               **{f"dec_cross_kernel_wideI{kt}Li{ops}E": K.dec_cross_plan(8 * ops, 512, eb).smem
                  for kt, eb in (("a", 1), ("13__nv_bfloat16", 2)) for ops in (2, 3)},
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
                   ("gemm_small_kernel", "gemm_bf16 small_m"),
                   ("gemm_mid_kernel", "gemm_bf16 mid_m"), ("layernorm_", "layernorm"),
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


def train_setup(cfg):
    """`cfg`'s training state on the card (random f32 trees from seed 0: the
    model, the CLIP tower, the teacher; make_train_step(cfg, 20)), its step
    function and synthetic_batch(train_batch_size, with_pixels) there."""
    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.data.synthetic import synthetic_batch
    from vacnic_tpu_torch.models import fusion as F
    from vacnic_tpu_torch.models.bart import bart_init
    from vacnic_tpu_torch.models.clip_vit import clip_vision_init
    from vacnic_tpu_torch.train.train_step import make_train_step

    g = make_generator(0, "cuda")
    model = F.multimodal_bart_init(g, cfg.bart, cfg.fusion, device="cuda")
    clip = clip_vision_init(g, cfg.clip, device="cuda")
    teacher = bart_init(g, cfg.bart, device="cuda")
    init_fn, step_fn = make_train_step(cfg, 20)
    state = init_fn({"model": model, "clip": clip}, teacher, cfg.train.seed)
    batch = synthetic_batch(cfg, cfg.train.train_batch_size, seed=0, with_pixels=True)
    return state, step_fn, {k: v.cuda() for k, v in batch.items()}


def gate_train_step(tag: str, cfg, i: int, state, m: dict, frozen0, bart0, counts: dict,
                    ms: float, gpu: str) -> None:
    """The gates on training step i: every metric finite; the CLIP tower
    and the teacher bit-unchanged (`frozen0`); after step 0 (lr 0) the bart
    group bit-unchanged (`bart0`) and its moments moved; after step 1 the
    bart group moved and the step's launches (`counts`) flash_attention once
    a teacher encoder layer (the teacher's forward) and no other kernel
    (the differentiated forward reaches none)."""
    check_train_metrics(f"{tag} step {i}", m)
    log(f"{tag}: step {i}: {ms:.1f} ms, " + ", ".join(
        f"{k} {float(v):.4f}" for k, v in m.items()))
    if not same(frozen0, frozen_leaves(state)):
        raise RuntimeError(f"{tag} step {i}: the CLIP tower or the teacher changed")
    if i == 0:
        mu = state.opt_state["bart"]["mu"]["model"]["shared"]["weight"]
        nu = state.opt_state["bart"]["nu"]["model"]["shared"]["weight"]
        if not same(bart0, bart_leaves(state)) or not (mu.any() and nu.any()):
            raise RuntimeError(f"{tag} step 0 (lr 0): the bart group moved or its moments "
                               "did not")
    if i == 1:
        if same(bart0, bart_leaves(state)):
            raise RuntimeError(f"{tag} step 1: the bart group did not move")
        others = {k: n for k, n in counts.items() if k != "flash_attention" and n}
        log(f"{tag}: step 1 launches {counts} ({gpu})")
        if counts["flash_attention"] != cfg.bart.encoder_layers or others:
            raise RuntimeError(f"{tag}: a step must launch flash_attention once per teacher "
                               f"encoder layer and no other kernel, got {counts}")


def check_eval_fused(tag: str, cfg, state, batch) -> None:
    """eval_step, whose encoder is the fused one (its kernels must launch),
    against mm_forward with allow_fused_encoder=False on the same CLIP
    features: val_loss and logits within 5e-2 relative (the stacks phase's
    bf16 tolerance)."""
    import torch

    from vacnic_tpu_torch.kernels import primitives as K
    from vacnic_tpu_torch.models import fusion as F
    from vacnic_tpu_torch.models.bart import shift_tokens_right
    from vacnic_tpu_torch.models.clip_vit import clip_vision_fwd
    from vacnic_tpu_torch.train import losses as L
    from vacnic_tpu_torch.train.train_step import create_mask, eval_step, face_mask_from_emb

    K.reset_launch_counts()
    ev = eval_step(state.params, batch, cfg)
    torch.cuda.synchronize()
    ev_counts = K.launch_counts()
    check_launched(f"{tag} eval_step", ev_counts, SLICE_KERNELS[:4])
    with torch.no_grad():
        dt = torch.bfloat16
        _, img = clip_vision_fwd(state.params["clip"], batch["pixels"], cfg.clip, dt)
        tgt_in = shift_tokens_right(batch["caption_ids"], cfg.bart.pad_token_id,
                                    cfg.bart.eos_token_id)
        kw = {} if cfg.fusion.only_image else dict(
            face_features=batch["face_emb"], face_mask=face_mask_from_emb(batch["face_emb"]),
            name_ids=batch["names_art_ids"], name_mask=create_mask(batch["names_art_ids"]))
        args = (state.params["model"], batch["article_ids"], create_mask(batch["article_ids"]),
                tgt_in, img, cfg.bart, cfg.fusion)
        fused = F.mm_forward(*args, dtype=dt, **kw)["logits"]
        ref = F.mm_forward(*args, dtype=dt, allow_fused_encoder=False, **kw)["logits"]
        ref_loss = L.lm_cross_entropy(ref, batch["caption_ids"], cfg.bart.pad_token_id)
    e_logits = rel_err(fused, ref)
    e_loss = abs(float(ev["val_loss"]) - float(ref_loss)) / abs(float(ref_loss))
    agree = float((ev["argmax_ids"] == ref.argmax(-1)).float().mean())
    log(f"{tag}: eval_step val_loss {float(ev['val_loss']):.5f} (fused encoder) vs "
        f"{float(ref_loss):.5f} (allow_fused_encoder=False): rel {e_loss:.3e}; logits rel err "
        f"{e_logits:.3e}; argmax agreement {agree:.4f} (tol rel 5e-2); launches {ev_counts}")
    if not (e_loss <= 5e-2 and e_logits <= 5e-2):
        raise RuntimeError(f"{tag}: eval_step through the fused encoder disagrees")


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
    from vacnic_tpu_torch.kernels import primitives as K
    from vacnic_tpu_torch.train.checkpoints import CheckpointManager
    from vacnic_tpu_torch.train.train_step import make_train_step

    cfg = VacnicConfig.full_train()
    bsz = cfg.train.train_batch_size
    state, step_fn, batch = train_setup(cfg)
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
            K.reset_launch_counts()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            if i == 1:
                counts = K.launch_counts()
            gate_train_step("train", cfg, i, state, m, frozen0, bart0, K.launch_counts(),
                            step_s[-1] * 1e3, gpu)
            if i == 1:
                bart0 = None
            if i == 2:
                t0 = time.perf_counter()
                mgr.save(state.step, state, {"loss": float(m["loss"])})
                save_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        ms = sorted(s * 1e3 for s in step_s[2:])
        med = ms[len(ms) // 2] if len(ms) % 2 else sum(ms[len(ms) // 2 - 1:len(ms) // 2 + 1]) / 2
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

    check_eval_fused("train", cfg, state, batch)

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

    def bmm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
        # the bf16 products (models/products.py) run aten::bmm.dtype, whose
        # out_dtype argument torch's own bmm formula does not take
        (b, m, k), n = a_shape, b_shape[-1]
        return 2 * b * m * k * n

    with FlopCounterMode(display=False, custom_mapping={torch.ops.aten.bmm: bmm_flop}) as fc:
        state, _ = step_fn(state, batch)
    flops = fc.get_total_flops()
    mm_ms = sum(ms_ for ms_, _, key in aten if key in ("aten::mm", "aten::bmm", "aten::addmm"))
    rate = f"{flops / 1e12 / (mm_ms / 1e3):.1f} TFLOP/s" if mm_ms else "not measured"
    log(f"train: one step's library products, counted by torch.utils.flop_counter: "
        f"{flops / 1e12:.2f} TFLOP; over the profiled step's aten mm + bmm + addmm device time "
        f"({mm_ms:.1f} ms): {rate} ({gpu})")
    return counts


# ---------------------------------------------------------------------------
# onlyvis + mlp phases: the visual-prompt-only model and the mlp prompt mapper
# ---------------------------------------------------------------------------

ONLYVIS_SERVE_ROWS = 8
ONLYVIS_TRAIN_STEPS = 3  # step 0's warmup lr is 0: step 1 moves the bart group
CACHED_BATCH = 8
CACHED_STEPS = 16
CACHED_TOL = 1e-4  # of a step's largest |logit|: f32 sums in another order


def mlp_config():
    """full_train() with the mlp prompt mapper over CLIP's patch tokens
    (FusionConfig.map_size (196, 256, 64, 16): 16 prompt rows)."""
    from vacnic_tpu_torch.core.config import VacnicConfig

    cfg = VacnicConfig.full_train()
    return dataclasses.replace(cfg, fusion=dataclasses.replace(cfg.fusion,
                                                               prompt_mlp_type="mlp"))


def check_fused_encoder(tag: str, cfg, params, x: dict):
    """The fused encoder (CUDA text stack) against the layer-by-layer one on
    the path's own batch, both bf16 on the card: relative error within the
    stacks phase's 5e-2 -> (the fused output, the layer-by-layer one)."""
    import torch

    from vacnic_tpu_torch.models import fusion as F

    streams = {k: v for k, v in x.items()
               if k not in ("input_ids", "attention_mask", "image_features")}
    args = (params, x["input_ids"], x["attention_mask"], x["image_features"], cfg.bart,
            cfg.fusion)
    with torch.no_grad():
        fused = F.mm_encoder_fwd_fused(*args, dtype=torch.bfloat16, **streams)["last_hidden"]
        ref = F.mm_encoder_fwd(*args, dtype=torch.bfloat16, **streams)["last_hidden"]
    err = rel_err(fused, ref)
    log(f"{tag}: fused encoder vs layer-by-layer at batch {x['input_ids'].shape[0]}: rel err "
        f"{err:.3e} (tol rel 5e-2)")
    if not err <= 5e-2:
        raise RuntimeError(f"{tag}: the fused encoder disagrees with the layer-by-layer one")
    return fused, ref


def run_model_path(tag: str, cfg, params, x: dict, gpu: str, kv: int | None = None):
    """generate_mm at `cfg`'s decode (the slice's: beam 5 x 50 x lp 2.0,
    every step) on its model, through the fused encoder; launches zeroed
    just before the run and read just after: the slice's counts at the
    batch of `x` (check_slice_counts: gemm_bf16's kernels as gemm_plan
    places the encoder's and the decoder's products, the decode's every
    step), and enc_self_attention and enc_cross_attention once an encoder
    layer, the latter all at the path's KV (`kv`, ENC_CROSS_KV[tag] by
    default); finite scores, mean length >= 45 -> (the counts, the captions
    on the card)."""
    import torch

    from vacnic_tpu_torch.infer.generate import generate_mm
    from vacnic_tpu_torch.kernels import primitives as K

    batch_size, kv = x["input_ids"].shape[0], kv or ENC_CROSS_KV[tag]

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
    by_kv = K.enc_cross_kv_counts()
    nonpad = check_captions(tag, cfg, seqs, scores, batch_size)
    TOKENS[tag], SCORES[tag] = seqs.cpu(), scores.float().cpu()
    log(f"{tag}: beam {cfg.decode.num_beams} x {cfg.decode.max_length} x lp "
        f"{cfg.decode.length_penalty}, batch {batch_size}: {dt:.3f} s, "
        f"{batch_size / dt:.2f} captions/s, mean non-pad length {nonpad:.1f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; enc_cross_attention by KV "
        f"{by_kv}; launches {K.launch_counts()} ({gpu})")
    counts = check_slice_counts(tag, cfg, batch_size)
    if counts["gemm_bf16:mid_m"]:
        MID_M_PATHS.add(tag)
    layers = cfg.bart.encoder_layers
    if counts["enc_self_attention"] != layers or by_kv != {kv: layers}:
        raise RuntimeError(f"{tag}: enc_self_attention {counts['enc_self_attention']} and "
                           f"enc_cross_attention by KV {by_kv}: expected {layers} each, all "
                           f"at KV {kv}")
    return counts, seqs


def run_onlyvis_train(gpu: str) -> None:
    """The training step of VacnicConfig.onlyvis_train() at full width
    (batch 32, S 512, caption 100, bf16 over f32, remat, dropout 0.1, CoLaM
    alpha 0.5 with the teacher's forward, CLIP frozen on pixels; random f32
    trees from seed 0): ONLYVIS_TRAIN_STEPS steps under the train phase's
    gates (finite metrics; after step 0, lr 0, the bart group bit-unchanged
    and its moments moved; after step 1 the bart group moved; the CLIP tower
    and the teacher bit-unchanged after every step; step 1 launches
    flash_attention once a teacher encoder layer and no other kernel), then
    eval_step through the fused encoder against allow_fused_encoder=False.
    Readings: each step's ms, samples/s of the last, peak GB."""
    import torch

    from vacnic_tpu_torch.core.config import VacnicConfig
    from vacnic_tpu_torch.kernels import primitives as K

    cfg = VacnicConfig.onlyvis_train()
    bsz = cfg.train.train_batch_size
    state, step_fn, batch = train_setup(cfg)
    frozen0 = [t.detach().clone() for t in frozen_leaves(state)]
    bart0 = [t.detach().clone() for t in bart_leaves(state)]
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(ONLYVIS_TRAIN_STEPS):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        gate_train_step("onlyvis train", cfg, i, state, m, frozen0, bart0, K.launch_counts(),
                        step_ms[-1], gpu)
    del bart0
    peak = torch.cuda.max_memory_allocated()
    log(f"onlyvis train: onlyvis_train, batch {bsz} x S {cfg.data.article_max_length} x "
        f"caption {cfg.data.caption_max_length}, {cfg.train.compute_dtype} over f32, remat "
        f"{cfg.train.grad_checkpoint}, alpha {cfg.train.alpha}, CLIP frozen on pixels: step "
        f"wall ms {[round(t, 1) for t in step_ms]}; step {ONLYVIS_TRAIN_STEPS - 1} "
        f"{step_ms[-1]:.1f} ms, {bsz / (step_ms[-1] / 1e3):.2f} samples/s; peak memory "
        f"{peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated) ({gpu})")
    check_eval_fused("onlyvis train", cfg, state, batch)


def run_onlyvis_phase(batch_size: int, gpu: str) -> dict:
    """VacnicConfig.onlyvis_train() (only_image: the clipcap prompt alone,
    KV 20) at full width, random bf16 weights from seed 0: the fused encoder
    against the layer-by-layer one at the path's batch; generate_mm at the
    slice's decode held to the slice's counts with enc_cross_attention 12
    at KV 20; CaptionService answering ONLYVIS_SERVE_ROWS requests (no faces
    or names) identically to a direct generate_mm; then, that tree freed,
    the training step (run_onlyvis_train) -> the decode's counts."""
    import torch

    from vacnic_tpu_torch.core.config import VacnicConfig
    from vacnic_tpu_torch.serve import CaptionService, ServeConfig

    t_phase = time.perf_counter()
    cfg, params = full_model(cfg=VacnicConfig.onlyvis_train())
    x = batch_inputs(cfg, batch_size)
    check_fused_encoder("onlyvis", cfg, params, x)
    counts, _ = run_model_path("onlyvis", cfg, params, x, gpu)

    rows = sample_rows(cfg, ONLYVIS_SERVE_ROWS, seed=0)
    svc = CaptionService(cfg, {"model": params}, device="cuda",
                         serve_cfg=ServeConfig(buckets=(ONLYVIS_SERVE_ROWS,), max_wait_ms=5000))
    try:
        t0 = time.perf_counter()
        results = [f.result(timeout=600) for f in [svc.submit(r) for r in rows]]
        dt = time.perf_counter() - t0
        seqs, scores = direct_generate(cfg, svc.params["model"], rows)
    finally:
        svc.close()
    check_identical("onlyvis serve", results, seqs, scores)
    TOKENS["onlyvis serve"] = seqs
    log(f"onlyvis serve: {ONLYVIS_SERVE_ROWS} requests without faces or names in {dt:.3f} s, "
        "token- and score-identical to a direct generate_mm of the same rows")
    del params, svc
    torch.cuda.empty_cache()
    run_onlyvis_train(gpu)
    torch.cuda.empty_cache()
    log(f"onlyvis: phase wall {time.perf_counter() - t_phase:.1f} s")
    return counts


def run_cached_decoder_check(cfg, gpu: str) -> None:
    """The general KV-cached decoder (models/bart.init_cache +
    decoder_fwd(cache=, cache_index=)) at full width in f32 (a random
    bart_init tree from seed 0), batch CACHED_BATCH over the encoder output
    of a synthetic batch: CACHED_STEPS teacher-forced steps, each step's
    logits within CACHED_TOL of its largest |logit| of the uncached
    decoder_fwd at that position."""
    import torch

    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.data.synthetic import synthetic_batch
    from vacnic_tpu_torch.models import bart as B
    from vacnic_tpu_torch.train.train_step import create_mask

    params = B.bart_init(make_generator(0, "cuda"), cfg.bart, device="cuda")
    b = synthetic_batch(cfg, CACHED_BATCH, seed=0)
    ids = b["article_ids"].cuda()
    mask = create_mask(ids)
    tgt = b["caption_ids"][:, :CACHED_STEPS].cuda()
    worst = 0.0
    with torch.no_grad():
        enc = B.encoder_fwd(params, ids, mask, cfg.bart)
        full = B.lm_logits(params, B.decoder_fwd(params, tgt, enc, mask, cfg.bart))
        cache = B.init_cache(params, CACHED_BATCH, CACHED_STEPS, enc, cfg.bart)
        t0 = time.perf_counter()
        for t in range(CACHED_STEPS):
            h = B.decoder_fwd(params, tgt[:, t:t + 1], enc, mask, cfg.bart, cache=cache,
                              cache_index=t)
            step = B.lm_logits(params, h)[:, 0]
            ref = full[:, t]
            worst = max(worst, float((step - ref).abs().max() / ref.abs().max()))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    log(f"mlp cached decoder: init_cache + decoder_fwd(cache=) at d {cfg.bart.d_model}, "
        f"{cfg.bart.decoder_layers} layers, f32, batch {CACHED_BATCH}: {CACHED_STEPS} steps in "
        f"{dt:.3f} s; worst step {worst:.3e} of its largest |logit| against the uncached "
        f"decoder_fwd (tol {CACHED_TOL}) ({gpu})")
    if not worst <= CACHED_TOL:
        raise RuntimeError("the cached decoder disagrees with the uncached one")


def run_mlp_phase(batch_size: int, gpu: str) -> dict:
    """full_train() with the mlp prompt mapper (mlp_config) at full width,
    random bf16 weights from seed 0: the CLIP tower (ViT-B/16, seed 0, bf16)
    on pixels gives the patch tokens [batch, 196, 768]; the fused encoder
    against the layer-by-layer one on them; generate_mm at the slice's
    decode held to the slice's counts with enc_cross_attention 12 at KV 36
    (16 prompt rows + 20 NER rows); then, that tree freed, the general
    cached decoder (run_cached_decoder_check) -> the decode's counts."""
    import torch

    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.data.synthetic import synthetic_batch
    from vacnic_tpu_torch.models.clip_vit import clip_vision_fwd, clip_vision_init

    t_phase = time.perf_counter()
    cfg, params = full_model(cfg=mlp_config())
    clip = clip_vision_init(make_generator(0, "cuda"), cfg.clip, device="cuda")
    px = synthetic_batch(cfg, batch_size, seed=0, with_pixels=True)["pixels"].cuda()
    with torch.no_grad():
        patches = clip_vision_fwd(clip, px, cfg.clip, torch.bfloat16)[0]
    del clip, px
    want = (batch_size, cfg.fusion.map_size[0], cfg.clip.width)
    if tuple(patches.shape) != want or not bool(torch.isfinite(patches).all()):
        raise RuntimeError(f"mlp: CLIP patch tokens of shape {tuple(patches.shape)} (want "
                           f"{want}), finite {bool(torch.isfinite(patches).all())}")
    log(f"mlp: CLIP patch tokens {tuple(patches.shape)} from pixels, finite")
    x = dict(batch_inputs(cfg, batch_size), image_features=patches)
    check_fused_encoder("mlp", cfg, params, x)
    counts, _ = run_model_path("mlp", cfg, params, x, gpu)
    del params, x, patches
    torch.cuda.empty_cache()
    run_cached_decoder_check(cfg, gpu)
    torch.cuda.empty_cache()
    log(f"mlp: phase wall {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# data phase
# ---------------------------------------------------------------------------

DATA_SPLITS = (("train", 64), ("val", 8), ("test", 32))
SPECIAL_TOKENS = ("<ENT>", "<NONAME>", "<PERSON>", "<ORGNORP>", "<GPELOC>")
BART_BASE_VOCAB = 50265  # entries of BART's vocab.json: the added tokens start here
PERSON_ID = 50267        # <PERSON>, the third added token
FIXTURE_WORDS = (
    "the", "a", "of", "in", "and", "to", "on", "at", "with", "for", "press", "photo", "shows",
    "waving", "crowd", "gathered", "today", "city", "council", "meeting", "president",
    "minister", "visit", "speech", "during", "after", "team", "game", "season", "police",
    "street", "protest", "market", "school", "students", "family", "river", "bridge",
    "festival", "music", "night", "morning", "week", "year", "new", "old", "2020",
    "Alice", "Smith", "Bob", "Jones", "Carol", "Diaz", "Paris", "London", "Berlin", "United",
    "Nations", "Senate", "Google", "café")
NAMES = ("Alice Smith", "Bob Jones", "Carol Diaz")
PLACES = ("Paris", "London", "Berlin")
ORGS = ("United Nations", "Senate", "Google")
DATA_FIT_LAYERS = 2  # the fit run's depth cut (encoder and decoder; fusion in both)
DATA_BATCH = 32


def write_bpe_vocab(d: str, words=FIXTURE_WORDS, size: int | None = BART_BASE_VOCAB):
    """A byte-level BPE vocab.json + merges.txt in BART's layout: <s> <pad>
    </s> <unk>, the 256 byte symbols, one merge chain a word (with and
    without its leading space), then filler tokens " w<i>" up to `size`
    entries, so that added tokens get BART's ids (<ENT> 50265, <NONAME>
    50266). -> (vocab path, merges path)."""
    from vacnic_tpu_torch.data.tokenize import _bytes_to_unicode

    b2u = _bytes_to_unicode()
    chars = sorted(set(b2u.values()))
    merges, extra, seen = [], [], set(chars)
    for w in words:
        for seq in ([b2u[b] for b in w.encode()], [b2u[b] for b in (" " + w).encode()]):
            cur = list(seq)
            while len(cur) > 1:
                merges.append(f"{cur[0]} {cur[1]}")
                cur = [cur[0] + cur[1]] + cur[2:]
                if cur[0] not in seen:
                    extra.append(cur[0])
                    seen.add(cur[0])
    tokens = ["<s>", "<pad>", "</s>", "<unk>"] + chars + extra
    if size is not None:
        tokens += [f"{b2u[ord(' ')]}w{i}" for i in range(size - len(tokens))]
    vocab, merges_path = os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt")
    with open(vocab, "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(tokens)}, f, ensure_ascii=False)
    with open(merges_path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(dict.fromkeys(merges)))
    return vocab, merges_path


def write_news_fixture(root: str, splits=DATA_SPLITS, image_size: int = 224,
                       face_dim: int = 512, article_words: int = 600, caption_words: int = 12,
                       seed: int = 0):
    """A GoodNews-layout dataset, made from `seed`: per-row files under
    root/GoodNews/goodnews (images_processed/<h>.jpg, faces/<h>.npy of
    [n, face_dim] on every second row, articles_full/<h>.txt, the
    NER-masked ids in articles_full_newsmep_ent_by_count/<h>.json) and one
    data dict a split, root/GoodNews/<split>_dict.json, whose sents_byclip
    fills the 512-token article bucket.
    -> (the per-row directory, {split: data dict})."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    base = os.path.join(root, "GoodNews", "goodnews")
    for sub in ("images_processed", "faces", "objects", "articles_full",
                "articles_full_newsmep_ent_by_count"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    plain = [w for w in FIXTURE_WORDS if w.islower()]
    cell = max(1, image_size // 14)
    dicts = {}
    for split, n in splits:
        dd = {}
        for i in range(n):
            h = f"{split}{i:03d}"
            coarse = rng.randint(0, 256, (-(-image_size // cell), -(-image_size // cell), 3))
            img = np.kron(coarse, np.ones((cell, cell, 1), np.int64))[:image_size, :image_size]
            img = np.clip(img + rng.randint(-24, 25, img.shape), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(base, "images_processed", f"{h}.jpg"))
            name, place, org = NAMES[i % 3], PLACES[(i // 3) % 3], ORGS[(i // 9) % 3]
            faces = i % 2 == 0
            if faces:
                np.save(os.path.join(base, "faces", f"{h}.npy"),
                        rng.randn(1 + i % 3, face_dim).astype(np.float32))
            words = [str(w) for w in rng.choice(plain, article_words)]
            words[3:3] = name.split()
            words[40:40] = ["in", place]
            words[90:90] = org.split()
            article = " ".join(words) + "."
            with open(os.path.join(base, "articles_full", f"{h}.txt"), "w") as f:
                f.write(article)
            with open(os.path.join(base, "articles_full_newsmep_ent_by_count", f"{h}.json"),
                      "w") as f:
                json.dump({"input_ids": [0, 5, PERSON_ID, PERSON_ID, 7, 9, PERSON_ID, 2]}, f)
            cap = " ".join(str(w) for w in rng.choice(plain, caption_words))
            dd[h] = {
                "caption": f"{name} {cap} in {place}" + (" café" if i % 4 == 0 else ""),
                "names": [name] if faces else [],
                "org_norp": [org] if i % 3 == 0 else [], "gpe_loc": [place],
                "names_art": [name, NAMES[(i + 1) % 3]], "org_norp_art": [org],
                "gpe_loc_art": [place],
                "sents_byclip": article,
                "face_emb_dir": [f"faces/{h}.npy"] if faces else [],
                "obj_emb_dir": [],
                "name_pos_cap": [[0, 1]],
            }
        with open(os.path.join(root, "GoodNews", f"{split}_dict.json"), "w") as f:
            json.dump(dd, f)
        dicts[split] = dd
    return base, dicts


def news_tokenizer(vocab: str, merges: str):
    """BartBpeTokenizer with the five added tokens, as the CLI builds it."""
    from vacnic_tpu_torch.data.tokenize import BartBpeTokenizer

    tok = BartBpeTokenizer(vocab, merges)
    tok.add_special_tokens(list(SPECIAL_TOKENS))
    return tok


def news_collate(cfg, tokenizer):
    from vacnic_tpu_torch.data.collate import collate

    noname = tokenizer.added_tokens.get("<NONAME>", 50266)
    return lambda s: collate(
        s, article_len=cfg.data.article_max_length, caption_len=cfg.data.caption_max_length,
        ner_len=cfg.fusion.max_ner_type_len, ner_len_gt=cfg.fusion.max_ner_type_len_gt,
        max_faces=cfg.fusion.max_faces, face_dim=cfg.fusion.face_feature_dim, noname_id=noname)


def news_dataset(cfg, tokenizer, base: str, data_dict: dict, is_train: bool):
    from vacnic_tpu_torch.data.datasets import NewsCaptionDataset

    return NewsCaptionDataset(
        data_dict, base, tokenizer, dataset=cfg.data.dataset,
        max_article_len=cfg.data.article_max_length, max_caption_len=cfg.data.caption_max_length,
        max_ner_type_len=cfg.fusion.max_ner_type_len,
        max_ner_type_len_gt=cfg.fusion.max_ner_type_len_gt,
        retrieved_sent=cfg.data.use_retrieval, train=is_train, image_size=cfg.clip.image_size)


def news_loader(cfg, tokenizer, base: str, data_dict: dict, is_train: bool, device=None,
                batch_size: int | None = None, **kw):
    """NewsCaptionDataset + collate + PrefetchLoader, wired as the JAX CLI
    wires them (vacnic_tpu/cli.py:97-145): train batches shuffled, eval
    loaders in order and keeping the tail."""
    from vacnic_tpu_torch.data.pipeline import PrefetchLoader

    bs = batch_size or (cfg.train.train_batch_size if is_train else cfg.train.val_batch_size)
    return PrefetchLoader(news_dataset(cfg, tokenizer, base, data_dict, is_train), bs,
                          news_collate(cfg, tokenizer), shuffle=is_train,
                          num_workers=cfg.data.num_workers, drop_last=is_train, device=device,
                          **kw)


def data_config(data_dir: str):
    """full_train() widths with the fit run's cuts: DATA_FIT_LAYERS encoder
    and decoder layers (fusion in both), 2 epochs, the teacher cache on."""
    from vacnic_tpu_torch.core.config import VacnicConfig

    cfg = VacnicConfig.full_train()
    return dataclasses.replace(
        cfg, bart=dataclasses.replace(cfg.bart, encoder_layers=DATA_FIT_LAYERS,
                                      decoder_layers=DATA_FIT_LAYERS),
        fusion=dataclasses.replace(cfg.fusion, fusion_layers=tuple(range(DATA_FIT_LAYERS))),
        data=dataclasses.replace(cfg.data, data_dir=data_dir),
        train=dataclasses.replace(cfg.train, num_epochs=2, teacher_cache=True))


def check_device_batch(tag: str, batch: dict, host: dict) -> None:
    """Every array of `host` (collate on the host) must be a CUDA tensor of
    the same dtype and shape in `batch`, equal bit for bit; lists equal."""
    import numpy as np
    import torch

    if set(batch) != set(host):
        raise RuntimeError(f"{tag}: keys {sorted(batch)} against the host's {sorted(host)}")
    for k, h in host.items():
        v = batch[k]
        if isinstance(h, np.ndarray):
            want = torch.from_numpy(h)
            if not (isinstance(v, torch.Tensor) and v.is_cuda and v.dtype == want.dtype
                    and v.shape == want.shape and torch.equal(v.cpu(), want)):
                raise RuntimeError(f"{tag}: {k} differs from host collate "
                                   f"({getattr(v, 'device', type(v))}, "
                                   f"{getattr(v, 'dtype', None)} against {want.dtype})")
        elif v != h:
            raise RuntimeError(f"{tag}: {k} differs from host collate")


def finite_metrics(tag: str, out: dict) -> dict:
    """The "bleu" and "other metrics" numbers of a generate_captions dict,
    each finite, with meteor_scorer recorded -> them, flat."""
    import math

    if "bleu" not in out or "other metrics" not in out:
        raise RuntimeError(f"{tag}: no 'bleu' / 'other metrics' in the output")
    om = dict(out["other metrics"])
    scorer = om.pop("meteor_scorer", None)
    nums = {**out["bleu"], **om}
    bad = {k: v for k, v in nums.items() if not (isinstance(v, float) and math.isfinite(v))}
    if bad or not scorer:
        raise RuntimeError(f"{tag}: metrics {nums}, meteor_scorer {scorer!r}")
    return dict(nums, meteor_scorer=scorer)


def data_fixture(root: str):
    """(1) of the data phase: the fixture and the tokenizer, whose engines
    must agree on the fixture's text -> (vocab files, row directory, data
    dicts, tokenizer)."""
    from vacnic_tpu_torch.data.tokenize import PRETOKENIZER

    t0 = time.perf_counter()
    vocab = write_bpe_vocab(root)
    base, dicts = write_news_fixture(root)
    log(f"data: fixture of {', '.join(f'{s} {n}' for s, n in DATA_SPLITS)} rows with 224 px "
        f"JPEGs written in {time.perf_counter() - t0:.2f} s")
    tok, py_tok = news_tokenizer(*vocab), news_tokenizer(*vocab)
    py_tok._native_tried = True  # the pure-Python merge loop
    texts = [r[k] for d in dicts.values() for r in d.values() for k in ("sents_byclip", "caption")]
    same = all(tok.encode(t) == py_tok.encode(t) for t in texts)
    added = {t: tok.added_tokens[t] for t in SPECIAL_TOKENS}
    log(f"data: BPE engine {tok.engine}, pretokenizer {PRETOKENIZER}; {len(texts)} fixture "
        f"texts: native ids {'identical to' if same else 'DIFFERENT from'} Python ids; "
        f"vocab {len(tok)}, added tokens {added}")
    if not same or added["<ENT>"] != 50265 or added["<NONAME>"] != 50266:
        raise RuntimeError("data: BPE ids differ between engines or added tokens off BART's")
    return vocab, base, dicts, tok


def check_data_loaders(cfg, tok, base: str, dicts: dict) -> None:
    """(2) of the data phase: PrefetchLoader(device="cuda") batches, over two
    epochs of the shuffled train split and the test split, against host
    collate of the same rows; pinned bytes; an abandoned iterator."""
    import threading

    import numpy as np

    from vacnic_tpu_torch.data.pipeline import THREAD_NAME, PrefetchLoader

    collate_fn = news_collate(cfg, tok)
    for split, shuffle in (("train", True), ("test", False)):
        ds = news_dataset(cfg, tok, base, dicts[split], False)
        loader = PrefetchLoader(ds, cfg.train.train_batch_size, collate_fn, shuffle=shuffle,
                                drop_last=False, num_workers=cfg.data.num_workers, device="cuda")
        host_bytes, seen = 0, []
        for _ in range(2):
            for b in loader:
                idx = b["sample_idx"].tolist()
                host = collate_fn([ds[i] for i in idx])
                check_device_batch(f"data loader {split}", b, host)
                host_bytes += sum(v.nbytes for v in host.values() if isinstance(v, np.ndarray))
                seen.append(idx)
        if sorted(i for s in seen[:len(loader)] for i in s) != list(range(len(ds))):
            raise RuntimeError(f"data loader {split}: an epoch did not cover every row once")
        if loader.pinned_bytes != host_bytes:
            raise RuntimeError(f"data loader {split}: {loader.pinned_bytes} bytes pinned for "
                               f"{host_bytes} copied")
        log(f"data: loader {split} (shuffle {shuffle}), 2 epochs, {len(seen)} batches: every "
            f"array on cuda, bit-identical to host collate with numpy's dtypes; "
            f"{host_bytes / 1e6:.1f} MB copied, all from pinned memory")
    it = iter(loader)
    next(it)
    it.close()
    deadline, alive = time.time() + 10.0, ["?"]
    while alive and time.time() < deadline:
        alive = [t.name for t in threading.enumerate()
                 if t.name.startswith(THREAD_NAME) and t.is_alive()]
        time.sleep(0.05)
    if alive:
        raise RuntimeError(f"data: an abandoned iterator left live threads {alive}")
    log("data: an abandoned iterator left no producer or worker thread")


def loader_readings(cfg, vocab, base: str, data_dict: dict, gpu: str) -> None:
    """Readings of the train loader as fit uses it (train=True reads, batch
    32): batches/s over three epochs from a cold tokenizer cache at
    cfg.data.num_workers threads, then warm by worker count; the H2D ms of
    one batch (pinning, then the copy); one thread's ms a row, under
    cProfile into profile_data.txt (the top functions by cumulative time);
    ascii_fold's us a call against JAX's form of it."""
    import cProfile
    import io
    import pstats

    import numpy as np
    import torch

    from vacnic_tpu_torch.data import datasets as D

    tok = news_tokenizer(*vocab)  # cold caches, as a run starts
    bsz = cfg.train.train_batch_size
    loader = news_loader(cfg, tok, base, data_dict, True, "cuda")
    epoch_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
    rates = {}
    for workers in (1, 2, 4, 8):
        c = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, num_workers=workers))
        loader = news_loader(c, tok, base, data_dict, True, "cuda")
        t0 = time.perf_counter()
        nb = sum(1 for _ in loader) + sum(1 for _ in loader)
        torch.cuda.synchronize()
        rates[workers] = round(nb / (time.perf_counter() - t0), 3)

    ds = news_dataset(cfg, tok, base, data_dict, True)
    arrays = [v for v in news_collate(cfg, tok)([ds[i] for i in range(bsz)]).values()
              if isinstance(v, np.ndarray)]
    nbytes = sum(a.nbytes for a in arrays)
    pin_ms, copy_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        pinned = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for a in arrays]
        t1 = time.perf_counter()
        on_card = [p.to("cuda", non_blocking=True) for p in pinned]
        torch.cuda.synchronize()
        pin_ms.append((t1 - t0) * 1e3)
        copy_ms.append((time.perf_counter() - t1) * 1e3)
        del pinned, on_card
    pin_ms, copy_ms = sorted(pin_ms)[2], sorted(copy_ms)[2]

    t0 = time.perf_counter()
    for i in range(bsz):
        ds[i]
    row_ms = (time.perf_counter() - t0) / bsz * 1e3
    prof = cProfile.Profile()
    prof.enable()
    for i in range(bsz):
        ds[i]
    prof.disable()
    out = io.StringIO()
    stats = pstats.Stats(prof, stream=out).sort_stats("cumulative")
    stats.print_stats(25)
    with open(os.path.join(OUT_DIR, "profile_data.txt"), "w") as f:
        f.write(out.getvalue())
    top = sorted(((v[3] / bsz * 1e3, f"{os.path.basename(k[0])}:{k[2]}")
                  for k, v in stats.stats.items()), reverse=True)[1:9]
    captions = [r["caption"] for r in data_dict.values()] * 10
    fold_us = {}
    for name, fold in (("port", D.ascii_fold), ("import per call", ascii_fold_import_per_call)):
        t0 = time.perf_counter()
        for c in captions:
            fold(c)
        fold_us[name] = round((time.perf_counter() - t0) / len(captions) * 1e6, 2)

    log(f"data: loader readings at batch {bsz} (read + decode + tokenize + collate + H2D), "
        f"{cfg.data.num_workers} worker threads: epoch 1 (cold tokenizer cache) "
        f"{n / epoch_s[0]:.2f} batches/s, epochs 2-3 {2 * n / sum(epoch_s[1:]):.2f} batches/s "
        f"({[round(s, 3) for s in epoch_s]} s an epoch of {n}); warm, by worker threads "
        f"{rates}; {os.cpu_count()} host cores ({gpu})")
    log(f"data: H2D of one batch ({nbytes / 1e6:.1f} MB): pin {pin_ms:.2f} ms + copy "
        f"{copy_ms:.2f} ms ({nbytes / 1e6 / copy_ms:.2f} GB/s); one thread reads a row in "
        f"{row_ms:.2f} ms (cProfile ms a row, cumulative: "
        + ", ".join(f"{name} {ms:.2f}" for ms, name in top)
        + f"); ascii_fold us a call, the port's (unidecode looked up once) and JAX's form "
        f"(the import tried on every call): {fold_us} ({gpu})")


def ascii_fold_import_per_call(text: str) -> str:
    """vacnic_tpu/data/datasets.py's ascii_fold as written there, for the
    reading beside the port's: the import is tried on every call."""
    import unicodedata

    try:
        import unidecode

        return unidecode.unidecode(text)
    except ImportError:
        return unicodedata.normalize("NFKD", text).encode("ascii", "ignore").decode("ascii")


def run_data_fit(cfg, tok, base: str, dicts: dict, out_dir: str, gpu: str) -> None:
    """(3) of the data phase: fit over the train and val loaders at
    full_train() widths cut to DATA_FIT_LAYERS, then generate_captions on
    the val split with the state fit returns."""
    import math

    import torch

    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.kernels import primitives as K
    from vacnic_tpu_torch.models import fusion as F
    from vacnic_tpu_torch.models.bart import bart_init
    from vacnic_tpu_torch.models.clip_vit import clip_vision_init
    from vacnic_tpu_torch.train import loop
    from vacnic_tpu_torch.train.train_step import make_train_step

    log(f"data: fit at full_train() widths (d {cfg.bart.d_model}, vocab {cfg.bart.vocab_size}, "
        f"S {cfg.data.article_max_length}, caption {cfg.data.caption_max_length}, ViT-B/16 at "
        f"{cfg.clip.image_size}, {cfg.train.compute_dtype} over f32, remat "
        f"{cfg.train.grad_checkpoint}, dropout {cfg.bart.dropout}); cut: {DATA_FIT_LAYERS} "
        f"encoder and {DATA_FIT_LAYERS} decoder layers (released 12 + 12), fusion_layers "
        f"{cfg.fusion.fusion_layers}; batch {cfg.train.train_batch_size}, "
        f"{cfg.train.num_epochs} epochs, teacher_cache, val batch {cfg.train.val_batch_size}")
    g = make_generator(0, "cuda")
    model = F.multimodal_bart_init(g, cfg.bart, cfg.fusion, device="cuda")
    clip = clip_vision_init(g, cfg.clip, device="cuda")
    teacher = bart_init(g, cfg.bart, device="cuda")
    train_loader = news_loader(cfg, tok, base, dicts["train"], True, "cuda")
    val_loader = news_loader(cfg, tok, base, dicts["val"], False, "cuda")
    init_fn, step_fn = make_train_step(cfg, cfg.train.num_epochs * len(train_loader))
    state = init_fn({"model": model, "clip": clip}, teacher, cfg.train.seed)
    del model, clip, teacher
    per_step, step_ms, mallocs = [], [], []

    def counted_step(state, batch):
        before = K.launch_counts()
        m0 = torch.cuda.memory_stats().get("num_device_alloc", 0)
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        mallocs.append(torch.cuda.memory_stats().get("num_device_alloc", 0) - m0)
        after = K.launch_counts()
        per_step.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
        return out

    t0 = time.perf_counter()
    state = loop.fit(cfg, state, counted_step, train_loader, val_loader, out_dir, tokenizer=tok)
    fit_s = time.perf_counter() - t0
    with open(os.path.join(out_dir, "run.metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    bad = [m for m in logged for v in m.values() if isinstance(v, float) and not math.isfinite(v)]
    per_epoch = len(train_loader)
    flash = [s.get("flash_attention", 0) for s in per_step]
    log(f"data: fit {len(per_step)} steps in {fit_s:.2f} s (validation and the checkpoint saves "
        f"included); step ms {[round(s, 1) for s in step_ms]} (cudaMalloc calls by step "
        f"{mallocs}); flash_attention launches by step {flash}; val_loss by epoch "
        f"{[round(m['val_loss'], 4) for m in logged if 'val_loss' in m]} ({gpu})")
    if bad or not logged:
        raise RuntimeError(f"data: fit logged non-finite metrics {bad}")
    if (len(per_step) != cfg.train.num_epochs * per_epoch
            or any(n != cfg.bart.encoder_layers for n in flash[:per_epoch])
            or any(flash[per_epoch:])):
        raise RuntimeError(f"data: flash_attention launches by step {flash}: the teacher's "
                           f"{cfg.bart.encoder_layers} a step in epoch 1, none in epoch 2 (the "
                           "teacher cache)")
    for sub in ("best", "last"):
        if not any(n.isdigit() for n in os.listdir(os.path.join(out_dir, sub))):
            raise RuntimeError(f"data: fit wrote no {sub}/ checkpoint")
    with open(os.path.join(out_dir, "val_outputs.json")) as f:
        vo = json.load(f)
    if len(vo) != len(val_loader) or not all(
            v["gt_cap"] and v["logit_output"]
            and all(isinstance(s, str) for s in v["gt_cap"] + v["logit_output"])
            for v in vo.values()):
        raise RuntimeError("data: val_outputs.json lacks gt_cap / logit_output strings")
    t0 = time.perf_counter()
    caps = loop.generate_captions(cfg, state.params, val_loader, tok,
                                  out_path=os.path.join(out_dir, "val_captions.json"))
    val_s = time.perf_counter() - t0
    rows = [k for k in caps if k not in ("bleu", "other metrics")]
    m = finite_metrics("data generate_captions (val)", caps)
    if len(rows) != len(dicts["val"]):
        raise RuntimeError(f"data: generate_captions on val gave {len(rows)} captions")
    log(f"data: best/ and last/ written; val_outputs.json has gt_cap and logit_output for "
        f"{len(vo)} steps; generate_captions on val with fit's state: {len(rows)} captions in "
        f"{val_s:.2f} s, metrics {m}")


def run_data_generate(tok, base: str, dicts: dict, out_path: str, gpu: str) -> dict:
    """(4) of the data phase: generate_captions at full_train() as released
    over the test rows, held to the slice's launch counts and to a direct
    clip_vision_fwd + generate_mm on the same device batch -> the counts."""
    import torch

    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.data.datasets import ascii_fold
    from vacnic_tpu_torch.eval.caption_metrics import compute_caption_metrics
    from vacnic_tpu_torch.infer.generate import generate_mm
    from vacnic_tpu_torch.kernels import primitives as K
    from vacnic_tpu_torch.models.clip_vit import clip_vision_fwd, clip_vision_init
    from vacnic_tpu_torch.models.weights_io import tree_to
    from vacnic_tpu_torch.train import loop
    from vacnic_tpu_torch.train.train_step import create_mask, face_mask_from_emb

    cfg, model = full_model()
    clip = tree_to(clip_vision_init(make_generator(0, "cuda"), cfg.clip, device="cuda"),
                   dtype=torch.bfloat16)
    params = {"model": model, "clip": clip}
    test_loader = news_loader(cfg, tok, base, dicts["test"], False, "cuda",
                              batch_size=DATA_BATCH)
    loop.generate_captions(cfg, params, test_loader, tok, compute_metrics=False)  # warm-up
    seen_batches, seen_seqs = [], []

    def tapped(loader):
        for b in loader:
            seen_batches.append(b)
            yield b

    def recording(*a, **kw):
        seqs, scores = generate_mm(*a, **kw)
        seen_seqs.append(seqs.clone())
        return seqs, scores

    loop.generate_mm = recording
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        caps = loop.generate_captions(cfg, params, tapped(test_loader), tok, out_path=out_path)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = check_slice_counts("data generate_captions", cfg, DATA_BATCH)
    finally:
        loop.generate_mm = generate_mm
    if len(seen_batches) != 1 or len(seen_seqs) != 1:
        raise RuntimeError(f"data: {len(seen_batches)} batches for the {DATA_BATCH} test rows")
    b, dt = seen_batches[0], torch.bfloat16
    with torch.no_grad():
        t0 = time.perf_counter()
        _, img = clip_vision_fwd(clip, b["pixels"], cfg.clip, dt)
        seqs, scores = generate_mm(model, b["article_ids"], create_mask(b["article_ids"]), img,
                                   cfg.bart, cfg.fusion, cfg.decode, dtype=dt, device="cuda",
                                   face_features=b["face_emb"],
                                   face_mask=face_mask_from_emb(b["face_emb"]),
                                   name_ids=b["names_art_ids"],
                                   name_mask=create_mask(b["names_art_ids"]))
        torch.cuda.synchronize()
        direct_s = time.perf_counter() - t0
    check_captions("data direct", cfg, seqs, scores, DATA_BATCH)
    identical = torch.equal(seqs, seen_seqs[0])
    TOKENS["data"] = seen_seqs[0].cpu()
    want = [ascii_fold(tok.decode(r, skip_special_tokens=True)) for r in seqs.tolist()]
    rows = [k for k in caps if k not in ("bleu", "other metrics")]
    strings = rows == list(range(DATA_BATCH)) and all(
        caps[i]["gen"] == want[i] and caps[i]["gt"] == ascii_fold(b["caption"][i])
        for i in range(DATA_BATCH))
    with open(out_path) as f:
        m = finite_metrics("data generate_captions (test)", json.load(f))
    t0 = time.perf_counter()
    compute_caption_metrics([(caps[i]["gen"], caps[i]["gt"]) for i in rows])
    metrics_s = time.perf_counter() - t0
    log(f"data: generate_captions, full_train() beam {cfg.decode.num_beams} x "
        f"{cfg.decode.max_length}, {DATA_BATCH} test rows at batch {DATA_BATCH} (CLIP on "
        f"pixels): tokens {'identical to' if identical else 'DIFFERENT from'} a direct "
        f"clip_vision_fwd + generate_mm on the same device batch; gen strings "
        f"{'equal to' if strings else 'DIFFERENT from'} ascii_fold(decode); metrics {m}")
    log(f"data: readings: generate_captions {gen_s:.3f} s ({DATA_BATCH / gen_s:.2f} captions/s, "
        f"the loader's read of the batch and the metrics included), direct {direct_s:.3f} s "
        f"({DATA_BATCH / direct_s:.2f} captions/s); the metrics alone {metrics_s:.3f} s "
        f"(meteor_scorer {m['meteor_scorer']}) ({gpu})")
    if not identical or not strings:
        raise RuntimeError("data: generate_captions disagrees with the direct generate_mm")
    return counts


def run_data_phase(gpu: str) -> dict:
    """The data layer and evaluation on the card, from a GoodNews-layout
    fixture written here (DATA_SPLITS rows, 224 px JPEGs, faces on every
    second row, NER masks, a byte-level BPE vocab padded to BART's 50265
    entries): (1) the BPE engine and pretokenizer in use, native ids equal
    to Python ids on the fixture's text; (2) PrefetchLoader(device="cuda")
    over NewsCaptionDataset + collate, every array of every batch
    bit-identical in dtype and value to host collate of the same rows, host
    memory pinned for every byte copied, no producer thread left by an
    abandoned iterator; readings (loader_readings); (3) fit at full_train()
    widths with the depth cut to DATA_FIT_LAYERS (batch 32, 2 epochs,
    teacher cache, val batch 1): finite metrics, epoch 2's train steps
    served from the teacher cache (no flash_attention launch), best/ and
    last/ written, val_outputs.json with gt_cap and logit_output strings,
    then generate_captions on the val split with fit's state; (4)
    generate_captions at full_train() as released (full depth, random bf16
    weights from seed 0 as in the slice, a ViT-B/16 tower on the rows'
    pixels) over the 32 test rows at batch 32: launches at the slice's
    counts (zeroed just before, read just after), tokens identical to a
    direct clip_vision_fwd + generate_mm on the same device batch, each gen
    string ascii_fold(decode) of them, "bleu" and "other metrics" finite with
    meteor_scorer recorded; readings: captions/s through it and direct, the
    metrics' seconds. -> the launch counts of (4)."""
    import shutil
    import tempfile

    import torch

    root = tempfile.mkdtemp(prefix="data_phase_")
    try:
        vocab, base, dicts, tok = data_fixture(root)
        cfg = data_config(root)
        check_data_loaders(cfg, tok, base, dicts)
        loader_readings(cfg, vocab, base, dicts["train"], gpu)
        run_data_fit(cfg, tok, base, dicts, os.path.join(root, "fit"), gpu)
        shutil.rmtree(os.path.join(root, "fit"), ignore_errors=True)
        torch.cuda.empty_cache()
        return run_data_generate(tok, base, dicts, os.path.join(root, "test_captions.json"), gpu)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# cli phase
# ---------------------------------------------------------------------------

CLI_SPLIT_FILE = "{split}_dict_newsmep_ent_clip8sent_contras_name_pos.json"  # cli train's names
CLI_SERVE_ROWS = 3
CLI_CLIP_LAYERS = 2  # retrieve's towers: depth cut, so the compressed .npz is written in seconds


def write_clip_vocab(d: str, words=FIXTURE_WORDS) -> str:
    """An OpenAI-format CLIP BPE vocab (bpe_simple_vocab_*.txt.gz: a header
    line, then one merge a line) with one merge chain a lower-cased ASCII
    word, ending in its "</w>" piece -> its path."""
    import gzip

    merges = []
    for w in dict.fromkeys(w.lower() for w in words if w.isascii()):
        cur = list(w[:-1]) + [w[-1] + "</w>"]
        while len(cur) > 1:
            merges.append(f"{cur[0]} {cur[1]}")
            cur = [cur[0] + cur[1]] + cur[2:]
    path = os.path.join(d, "bpe_simple_vocab_fixture.txt.gz")
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("bpe vocab fixture\n" + "\n".join(dict.fromkeys(merges)))
    return path


def run_cli(argv: list[str], tag: str | None = None) -> str:
    """vacnic_tpu_torch.cli.main(argv) in this process; it must return 0.
    Its wall seconds are logged on a line of their own, its standard output
    goes to OUT_DIR/cli_<tag>.log -> that output."""
    import contextlib
    import io

    from vacnic_tpu_torch import cli

    tag = tag or argv[0]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    dt = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, f"cli_{tag.replace(' ', '_')}.log"), "w") as f:
        f.write(buf.getvalue())
    if rc != 0:
        raise RuntimeError(f"cli {tag}: exit code {rc}")
    log(f"cli {tag}: {dt:.2f} s wall")
    return buf.getvalue()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_json(opener, url: str, timeout: float = 10) -> dict:
    with opener.open(url, timeout=timeout) as r:
        return json.load(r)


def serve_cli_roundtrip(ckpt_dir: str, rows: list[dict], direct, save_newer, log_path: str,
                        args=(), start_timeout: float = 600, serve_args=()) -> dict:
    """`python -m vacnic_tpu_torch.cli [args] serve --ckpt-dir ...
    --watch-ckpt-s 1 [serve_args]` as a subprocess: each row POSTed alone
    must come back with the tokens
    and score of `direct(row)` -> (tokens, score); then `save_newer()`
    writes a newer step and /v1/stats' weights_version must rise within 60
    s; one more row after the swap; SIGINT must end the process with exit
    code 0 -> readings (seconds to healthy, ms a request, seconds to the
    swap)."""
    import signal
    import urllib.error

    port = free_port()
    base = f"http://127.0.0.1:{port}"
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "vacnic_tpu_torch.cli", *args, "serve", "--ckpt-dir",
           ckpt_dir, "--port", str(port), "--watch-ckpt-s", "1", "--buckets", "1,4",
           *serve_args]
    opener = http_opener()
    with open(log_path, "w") as logf:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=logf, stderr=subprocess.STDOUT)
        try:
            while True:
                if proc.poll() is not None:
                    raise RuntimeError(f"cli serve exited with {proc.returncode} before it "
                                       f"served (log: {log_path})")
                try:
                    if http_json(opener, f"{base}/healthz")["ok"]:
                        break
                except (urllib.error.URLError, ConnectionError, OSError):
                    pass
                if time.perf_counter() - t0 > start_timeout:
                    raise RuntimeError(f"cli serve not healthy after {start_timeout} s")
                time.sleep(0.5)
            ready_s = time.perf_counter() - t0

            def check(row, tag):
                t = time.perf_counter()
                got = post_caption(opener, base, request_body(row))
                ms = (time.perf_counter() - t) * 1e3
                seqs, scores = direct(row)
                check_identical(tag, [got], seqs, scores)
                return ms

            req_ms = [check(r, f"cli serve row {i}") for i, r in enumerate(rows)]
            v0 = http_json(opener, f"{base}/v1/stats")["weights_version"]
            t_save = time.perf_counter()
            save_newer()
            while http_json(opener, f"{base}/v1/stats")["weights_version"] <= v0:
                if time.perf_counter() - t_save > 60:
                    raise RuntimeError("cli serve: weights_version did not rise within 60 s "
                                       "of a newer checkpoint")
                time.sleep(0.25)
            swap_s = time.perf_counter() - t_save
            req_ms.append(check(rows[0], "cli serve after the swap"))
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if rc != 0:
        raise RuntimeError(f"cli serve exited with {rc} on SIGINT (log: {log_path})")
    return {"ready_s": ready_s, "request_ms": req_ms, "swap_s": swap_s, "exit": rc,
            "wall_s": time.perf_counter() - t0}


def cli_fixture(root: str):
    """The data phase's GoodNews fixture and BPE vocab, with the split dicts
    also under the names `cli train` reads -> (vocab, merges, row
    directory, data dicts, tokenizer)."""
    vocab, merges = write_bpe_vocab(root)
    base, dicts = write_news_fixture(root)
    for split, _ in DATA_SPLITS:
        with open(os.path.join(root, "GoodNews", CLI_SPLIT_FILE.format(split=split)), "w") as f:
            json.dump(dicts[split], f)
    return vocab, merges, base, dicts, news_tokenizer(vocab, merges)


def run_cli_generate(root: str, vocab: str, merges: str, tok, base: str, dicts: dict,
                     gpu: str):
    """`cli generate` at full_train() as released (random bf16 weights from
    seed 0 and a ViT-B/16 tower, saved once by CheckpointManager) over the
    32 test rows at batch 32: tokens and file identical to
    train/loop.generate_captions on the same tree and loader, launches at
    the slice's counts (zeroed just before, read just after); then
    `cli evaluate` of its output. -> (cfg, model, ckpt dir, counts)."""
    import torch

    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.infer.generate import generate_mm
    from vacnic_tpu_torch.kernels import primitives as K
    from vacnic_tpu_torch.models.clip_vit import clip_vision_init
    from vacnic_tpu_torch.models.weights_io import tree_to
    from vacnic_tpu_torch.train import loop
    from vacnic_tpu_torch.train.checkpoints import CheckpointManager
    from vacnic_tpu_torch.train.train_step import TrainState

    cfg, model = full_model()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, data_dir=root))
    clip = tree_to(clip_vision_init(make_generator(0, "cuda"), cfg.clip, device="cuda"),
                   dtype=torch.bfloat16)
    params = {"model": model, "clip": clip}
    ckpt = os.path.join(root, "ckpt")
    t0 = time.perf_counter()
    CheckpointManager(ckpt, cfg).save(0, TrainState(step=0, params=params, teacher={},
                                                    opt_state={}, rng=0))
    log(f"cli: full_train() tree (bf16, {tree_bytes(params) / 2**30:.2f} GiB) saved by "
        f"CheckpointManager in {time.perf_counter() - t0:.2f} s")
    seen = []

    def recording(*a, **kw):
        seqs, scores = generate_mm(*a, **kw)
        seen.append(seqs.cpu())
        return seqs, scores

    test_dict = os.path.join(root, "GoodNews", CLI_SPLIT_FILE.format(split="test"))
    ref_path, out_path = os.path.join(root, "ref_captions.json"), os.path.join(root, "gen.json")
    loop.generate_mm = recording
    try:
        loader = news_loader(cfg, tok, base, dicts["test"], False, "cuda", batch_size=DATA_BATCH)
        loop.generate_captions(cfg, params, loader, tok, out_path=ref_path, device="cuda")
        K.reset_launch_counts()
        run_cli(["generate", "--ckpt-dir", ckpt, "--data-dict", test_dict, "--vocab", vocab,
                 "--merges", merges, "--out", out_path, "--set",
                 f"train.val_batch_size={DATA_BATCH}"])
        torch.cuda.synchronize()
        counts = check_slice_counts("cli generate", cfg, DATA_BATCH)
    finally:
        loop.generate_mm = generate_mm
    with open(ref_path) as f, open(out_path) as g:
        ref, got = json.load(f), json.load(g)
    identical = len(seen) == 2 and torch.equal(seen[0], seen[1])
    m = finite_metrics("cli generate", got)
    log(f"cli generate: full_train() beam {cfg.decode.num_beams} x {cfg.decode.max_length}, "
        f"{len(seen[-1])} test rows: tokens {'identical to' if identical else 'DIFFERENT from'} "
        f"generate_captions on the same tree and loader; file "
        f"{'equal' if got == ref else 'DIFFERENT'}; metrics {m} ({gpu})")
    if not identical or got != ref:
        raise RuntimeError("cli generate disagrees with train/loop.generate_captions")
    TOKENS["cli_generate"] = seen[-1]
    report_path = os.path.join(root, "report.json")
    run_cli(["evaluate", "--results", out_path, "--data-dict", test_dict, "--out", report_path])
    with open(report_path) as f:
        report = json.load(f)
    missing = {"bleu", "entities", "face_groups"} - set(report)
    if missing or report["entities"].get("ner_engine") is None:
        raise RuntimeError(f"cli evaluate: the report lacks {sorted(missing)} or an NER engine")
    log(f"cli evaluate: keys {sorted(report)}, NER engine {report['entities']['ner_engine']}")
    return cfg, model, params, ckpt, counts


def run_cli_serve(cfg, model, params, ckpt: str, gpu: str) -> None:
    """`cli serve` as a subprocess on the generate checkpoint (serve_cli_roundtrip)."""
    from vacnic_tpu_torch.train.checkpoints import CheckpointManager
    from vacnic_tpu_torch.train.train_step import TrainState

    rows = sample_rows(cfg, CLI_SERVE_ROWS, seed=7)
    r = serve_cli_roundtrip(
        ckpt, rows, lambda row: direct_generate(cfg, model, [row]),
        lambda: CheckpointManager(ckpt).save(1, TrainState(step=1, params=params, teacher={},
                                                           opt_state={}, rng=0)),
        os.path.join(OUT_DIR, "cli_serve.log"))
    log(f"cli serve: {r['wall_s']:.2f} s wall")
    log(f"cli serve: healthy after {r['ready_s']:.2f} s (restore + buckets 1, 4 warmed); "
        f"{len(r['request_ms'])} requests over HTTP identical to a direct generate_mm of each "
        f"row (ms {[round(x, 1) for x in r['request_ms']]}); a newer step saved -> "
        f"weights_version rose after {r['swap_s']:.2f} s; SIGINT -> exit {r['exit']} ({gpu})")


def run_cli_train(root: str, vocab: str, merges: str, gpu: str) -> int:
    """`cli train` at full_train() widths cut to DATA_FIT_LAYERS, 2 steps,
    then again with --resume: test_captions.json with finite metrics, best/
    and last/ written, flash_attention launched by the teacher -> its
    launches over both runs. The state last/ holds after the second run
    must be at step 4."""
    import torch

    from vacnic_tpu_torch.kernels import primitives as K
    from vacnic_tpu_torch.train.checkpoints import CheckpointManager

    out = os.path.join(root, "train")
    cut = ["--set", f"bart.encoder_layers={DATA_FIT_LAYERS}",
           "--set", f"bart.decoder_layers={DATA_FIT_LAYERS}",
           "--set", "fusion.fusion_layers=" + ",".join(map(str, range(DATA_FIT_LAYERS))),
           "--set", f"train.val_batch_size={DATA_BATCH}"]
    argv = ["train", "--config", "full", "--data-dir", root, "--out-dir", out, "--vocab", vocab,
            "--merges", merges, "--max-steps", "2", *cut]
    K.reset_launch_counts()
    run_cli(argv)
    run_cli(argv + ["--resume"], "train --resume")
    torch.cuda.synchronize()
    flash = K.launch_counts()["flash_attention"]
    with open(os.path.join(out, "test_captions.json")) as f:
        m = finite_metrics("cli train", json.load(f))
    with open(os.path.join(out, "run.metrics.jsonl")) as f:
        losses = [round(x["loss"], 4) for x in map(json.loads, f) if "loss" in x]
    for sub in ("best", "last"):
        if not any(n.isdigit() for n in os.listdir(os.path.join(out, sub))):
            raise RuntimeError(f"cli train wrote no {sub}/ checkpoint")
    raw, _ = CheckpointManager(os.path.join(out, "last")).restore_raw()
    log(f"cli train: full_train() widths, {DATA_FIT_LAYERS} + {DATA_FIT_LAYERS} layers, batch "
        f"{DATA_BATCH}, --max-steps 2 twice (the second --resume): the last state's step "
        f"{raw['step']}; losses logged {losses}; flash_attention {flash} launches; test "
        f"metrics {m} ({gpu})")
    if raw["step"] != 4 or len(losses) != 4:
        raise RuntimeError("cli train --resume did not continue from the saved step 2")
    if flash == 0:
        raise RuntimeError("cli train: flash_attention never launched (the teacher's encoder)")
    return flash


def run_cli_retrieve(root: str, base: str, dicts: dict, gpu: str) -> None:
    """`cli retrieve` with a random ViT-B/16 + CLIP text tower .npz written
    by convert_checkpoint.save_tree (released widths, CLI_CLIP_LAYERS layers
    each) and a fixture CLIP BPE vocab, over four
    test rows with 12-sentence articles: each row's sents_byclip must equal
    retrieve_sentences recomputed on the card from the same file, with the
    top 8 of its article's sentences."""
    import numpy as np
    import torch

    from vacnic_tpu_torch.convert_checkpoint import load_tree, save_tree
    from vacnic_tpu_torch.core.config import ClipVisionConfig
    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.data.clip_tokenize import ClipBpeTokenizer
    from vacnic_tpu_torch.data.datasets import load_image
    from vacnic_tpu_torch.data.preprocess.clip_retrieval import (retrieve_sentences,
                                                                 split_sentences)
    from vacnic_tpu_torch.models.clip_text import clip_text_init
    from vacnic_tpu_torch.models.clip_vit import clip_image_embed, clip_vision_init
    from vacnic_tpu_torch.models.weights_io import tree_to

    vcfg = ClipVisionConfig()
    npz, clip_vocab = os.path.join(root, "clip.npz"), write_clip_vocab(root)
    t0 = time.perf_counter()
    save_tree({"vision": clip_vision_init(make_generator(0), dataclasses.replace(
                   vcfg, layers=CLI_CLIP_LAYERS)),
               "text": clip_text_init(make_generator(1), layers=CLI_CLIP_LAYERS)}, npz)
    log(f"cli: ViT-B/16 + text tower .npz ({os.path.getsize(npz) / 2**20:.1f} MiB; widths as "
        f"released, cut to {CLI_CLIP_LAYERS} of 12 layers in each tower) written in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(3)
    plain = [w for w in FIXTURE_WORDS if w.islower() and w.isascii()]
    rows = {h: dict(dicts["test"][h], article=" ".join(
        " ".join(rng.choice(plain, 8)).capitalize() + "." for _ in range(12)))
        for h in list(dicts["test"])[:4]}
    dd, out = os.path.join(root, "retrieve_in.json"), os.path.join(root, "retrieve_out.json")
    with open(dd, "w") as f:
        json.dump(rows, f)
    run_cli(["retrieve", "--data-dict", dd, "--data-base-dir", base, "--clip-ckpt", npz,
             "--clip-vocab", clip_vocab, "--out", out])
    with open(out) as f:
        got = json.load(f)
    tree = tree_to(load_tree(npz), "cuda")
    tok = ClipBpeTokenizer.from_dir(clip_vocab)
    bad = []
    for h, rec in rows.items():
        with torch.no_grad():
            img = clip_image_embed(tree["vision"], load_image(
                os.path.join(base, "images_processed", f"{h}.jpg"))[None], vcfg)[0]
        want = retrieve_sentences(tree["text"], tok, img, rec["article"])
        picked = split_sentences(got[h]["sents_byclip"])
        if (got[h]["sents_byclip"] != want or len(picked) != 8
                or not set(picked) <= set(split_sentences(rec["article"]))):
            bad.append(h)
    log(f"cli retrieve: {len(rows)} rows x 12 sentences -> top 8 each, "
        f"{'equal to' if not bad else 'DIFFERENT from'} retrieve_sentences recomputed on the "
        f"card ({gpu})")
    if bad:
        raise RuntimeError(f"cli retrieve: rows {bad} differ from retrieve_sentences")


def run_cli_phase(gpu: str) -> dict:
    """Every subcommand of `python -m vacnic_tpu_torch.cli` on the card, on
    the data phase's fixture (its vocab and 64 / 8 / 32 rows):
    generate (run_cli_generate) and evaluate; serve as a subprocess
    (run_cli_serve); train and train --resume (run_cli_train); retrieve
    (run_cli_retrieve); lmm --backend echo (a JSON of 8 steps x 4 captions,
    finite metrics); smoke (the slice's six kernels launched). One line a
    subcommand with its wall seconds. -> the launch counts of cli generate
    (the slice's kernels) with flash_attention's in cli train."""
    import math
    import shutil
    import tempfile

    import torch

    from vacnic_tpu_torch.kernels import primitives as K

    root = tempfile.mkdtemp(prefix="cli_phase_")
    try:
        vocab, merges, base, dicts, tok = cli_fixture(root)
        cfg, model, params, ckpt, counts = run_cli_generate(root, vocab, merges, tok, base,
                                                            dicts, gpu)
        run_cli_serve(cfg, model, params, ckpt, gpu)
        del cfg, model, params
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.empty_cache()
        flash = run_cli_train(root, vocab, merges, gpu)
        shutil.rmtree(os.path.join(root, "train"), ignore_errors=True)
        torch.cuda.empty_cache()
        run_cli_retrieve(root, base, dicts, gpu)
        lmm_out = os.path.join(root, "lmm.json")
        test_dict = os.path.join(root, "GoodNews", CLI_SPLIT_FILE.format(split="test"))
        printed = run_cli(["lmm", "--backend", "echo", "--data-dict", test_dict,
                           "--data-base-dir", base, "--use-retrieval", "--out", lmm_out])
        with open(lmm_out) as f:
            lmm = json.load(f)
        gens = [g for v in lmm.values() for g in v["gen"]]
        m = json.loads(printed.strip().splitlines()[-1])
        nums = [v for v in {**m["bleu"], **m["other metrics"]}.values()
                if not isinstance(v, str)]
        if (len(lmm) != 8 or len(gens) != len(dicts["test"])
                or not all(math.isfinite(v) for v in nums)):
            raise RuntimeError(f"cli lmm: {len(lmm)} steps, {len(gens)} captions, metrics {m}")
        K.reset_launch_counts()
        run_cli(["smoke"])
        torch.cuda.synchronize()
        smoke = K.launch_counts()
        check_launched("cli smoke", smoke, SLICE_KERNELS)
        log(f"cli lmm: {len(lmm)} steps, {len(gens)} echo captions, metrics finite; cli smoke "
            f"launches { {k: smoke[k] for k in SLICE_KERNELS} } ({gpu})")
        return dict(counts, flash_attention=flash)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# mesh phase
# ---------------------------------------------------------------------------

DP_SPEC, DP_OUT, DP_STORE = "dp_spec.pt", "dp_out.pt", "dp_store"
PRODUCT_RECIPES = ("bf16", "f32")


def use_products(recipe: str) -> None:
    """The models' library products (models/products.product) from here on
    in this process: "bf16", the program's own choice (bf16 tensor cores on
    the card where both operands are bf16), or "f32", the float32 recipe at
    every site (the products before models/products took bf16 operands), a
    witness beside the program that the limits set on that recipe read."""
    from vacnic_tpu_torch.models import products as P

    if recipe not in PRODUCT_RECIPES:
        raise ValueError(f"use_products: {recipe!r}, expected one of {PRODUCT_RECIPES}")
    program = getattr(P._bf16_mm, "program", P._bf16_mm)
    if recipe == "bf16":
        P._bf16_mm = program
        return

    def f32_recipe(a, b):
        return None

    f32_recipe.program = program
    P._bf16_mm = f32_recipe


def _grid_worker_groups(world: int, grid, timeout_s: float, cache: dict):
    """(data group, model group) of a (dp, tp) grid over the world, made once
    a grid (every rank makes every group, in the order of the cases): the
    whole world and no model group for (world, 1)."""
    import datetime

    import torch.distributed as dist

    from vacnic_tpu_torch.core import distributed as D

    if tuple(grid) == (world, 1):
        return dist.group.WORLD, None
    if tuple(grid) not in cache:
        cache[tuple(grid)] = D.grid_groups(*grid, timeout=datetime.timedelta(seconds=timeout_s))
    return cache[tuple(grid)]


def _tp_decode(cfg, model, dev, spec: dict) -> dict:
    """The decode after training (rank 0 of a tensor-parallel group, on the
    gathered tree): generate_mm_sharded over a data mesh of this rank's
    device, as JAX's _dryrun_body decodes the trained params over its data
    mesh, against generate_mm of the same tree."""
    import torch

    from vacnic_tpu_torch.core.config import MeshConfig
    from vacnic_tpu_torch.core.mesh import make_mesh
    from vacnic_tpu_torch.data.synthetic import synthetic_batch
    from vacnic_tpu_torch.infer.generate import drop_replicas, generate_mm, generate_mm_sharded
    from vacnic_tpu_torch.train.train_step import create_mask, face_mask_from_emb

    b = {k: v.to(dev) for k, v in synthetic_batch(cfg, spec["batch"], seed=spec["seed"]).items()}
    x = dict(input_ids=b["article_ids"], attention_mask=create_mask(b["article_ids"]),
             image_features=b["image_cls"], face_features=b["face_emb"],
             face_mask=face_mask_from_emb(b["face_emb"]), name_ids=b["names_art_ids"],
             name_mask=create_mask(b["names_art_ids"]))
    kw = dict(cfg=cfg.bart, fcfg=cfg.fusion, dcfg=cfg.decode, dtype=spec["dtype"])
    mesh = make_mesh(MeshConfig(model_parallel=1), devices=[dev])
    with torch.no_grad():
        seqs, scores = generate_mm_sharded(mesh, model, **kw, **x)
        want_seqs, want_scores = generate_mm(model, device=dev, **kw, **x)
    drop_replicas(model)  # the next grid's memory readings hold no copy of this tree
    seqs, scores = seqs.cpu(), scores.float().cpu()
    return {"tokens": seqs, "scores": scores,
            "identical": bool(torch.equal(seqs, want_seqs.cpu())
                              and torch.equal(scores, want_scores.float().cpu())),
            "finite": bool(torch.isfinite(scores).all())}


def dp_step_worker(rank: int, world: int, work_dir: str, timeout_s: float) -> None:
    """One rank of a group of processes (spawned by run_dp_group; also by
    tests/test_torch_distributed.py and tests/test_torch_tensor_parallel.py
    on the CPU): joins the group through a file store in `work_dir` (the
    spec's backend, else nccl on cards and gloo on the CPU), then for each
    case of the spec there runs make_train_step on a (dp, tp) grid of the
    world (the case's "grid", (world, 1) by default: data parallel only;
    core/distributed.grid_groups) on the spec's global batch and trees (the
    case's own "batch" and "params"; or, with spec "build" = (fn, kwargs),
    fn(device, **kwargs) -> (params, teacher), whole trees every rank makes
    on its device and checks equal across the world). A case gives the
    config, its "products" recipe (use_products; "bf16", the program's, by
    default), `steps` steps (their metrics), and with `grads` first one
    loss_and_grads at step 1's dropout seed (the reduced gradients, the
    cut ones gathered whole; host copies on rank 0 only), freed before the
    steps. Under a model group also: "tp" (the storage bytes of the rank's
    params against the sum of its shard shapes, whether
    every replicated leaf's gradient is bit-identical across the model
    ranks (with `grads`), whether gather_params of the teacher gives back
    the whole teacher bit for bit), the named `leaves` gathered after the
    steps, and with `decode` ({"batch", "seed", "dtype"}) the decode after
    training (_tp_decode, rank 0). Every rank's step ms, peak memory and
    flash_attention launches of the last step go to "ranks". Rank 0 saves
    [{"steps": [metrics], "grads": [...], "grad_metrics": {...}, ...}] a
    case."""
    import datetime

    import torch
    import torch.distributed as dist

    from vacnic_tpu_torch.core import distributed as D
    from vacnic_tpu_torch.core import tensor_parallel as TP
    from vacnic_tpu_torch.core.tree import leaves_with_path, tree_map
    from vacnic_tpu_torch.kernels import primitives as K
    from vacnic_tpu_torch.models.layers import split
    from vacnic_tpu_torch.train import train_step as TT

    def fresh(tree):  # a copy on the rank's device: the step updates its trees in place
        return tree_map(lambda _, t: t.detach().to(dev, copy=True)
                        if isinstance(t, torch.Tensor) else t, tree)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    spec = torch.load(os.path.join(work_dir, DP_SPEC), weights_only=False)
    if spec["device"] == "cpu":
        torch.set_num_threads(spec.get("threads", 1))
    D.initialize("file://" + os.path.join(work_dir, DP_STORE), world, rank,
                 backend=spec.get("backend"), device=spec["device"],
                 timeout=datetime.timedelta(seconds=timeout_s))
    try:
        dev = (torch.device("cuda", torch.cuda.current_device()) if spec["device"] == "cuda"
               else torch.device("cpu"))
        groups: dict = {}
        results = []
        for case in spec["cases"]:
            cfg = case["cfg"]
            use_products(case.get("products", "bf16"))
            batch = case.get("batch", spec["batch"])
            data_group, model_group = _grid_worker_groups(world, case.get("grid", (world, 1)),
                                                          timeout_s, groups)
            tp = TP.model_shard(model_group)
            if "build" in spec:  # made here, a case at a time: the shards replace them
                fn, kwargs = spec["build"]
                params, teacher = fn(dev, **kwargs)
                fp = torch.stack([t.double().sum() for tree in (params, teacher)
                                  for _, t in leaves_with_path(tree)]).sum().reshape(1)
                if len({float(f) for f in TP.all_gather(fp, dist.group.WORLD)}) != 1:
                    raise RuntimeError("the ranks built different trees from one seed")
            else:
                params = fresh(case.get("params", spec["params"]))
                teacher = fresh(spec["teacher"])
            init_fn, step_fn = TT.make_train_step(cfg, 100, device=dev, group=data_group,
                                                  model_group=model_group)
            state = init_fn(params, teacher, spec["rng"])
            out: dict = {"steps": []}
            if tp is not None:
                storages = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                            for _, t in leaves_with_path(state.params)
                            if isinstance(t, torch.Tensor)}
                shards = sum(math.prod(TP.shard_shape(p, tuple(t.shape), tp.size))
                             * t.element_size() for p, t in leaves_with_path(params)
                             if isinstance(t, torch.Tensor))
                whole = TP.gather_params(state.teacher, tp)
                out["tp"] = {"param_bytes": sum(storages.values()), "shard_bytes": shards,
                             "teacher_gathered": all(
                                 torch.equal(a, b) for (_, a), (_, b) in zip(
                                     leaves_with_path(teacher), leaves_with_path(whole)))}
                del whole
            del params, teacher
            if case.get("grads"):
                m, grads = TT.loss_and_grads(state.params, state.teacher, batch, cfg,
                                             split(state.rng)[1], data_group, tp)
                if tp is not None:
                    paths = leaves_with_path(state.params)
                    cut = [TP.is_cut(p, t) for p, t in paths]
                    rep = torch.cat([g.reshape(-1) for g, c in zip(grads, cut)
                                     if g is not None and not c])
                    parts = TP.all_gather(rep, tp.group)
                    out["tp"]["replicated_grads_agree"] = all(torch.equal(parts[0], q)
                                                              for q in parts[1:])
                    del rep, parts
                    grads = [None if g is None else TP.gather_leaf(p, g, tp)
                             for g, (p, _) in zip(grads, paths)]
                    del paths  # it holds this case's parameters
                out["grads"] = [None if g is None or rank else g.cpu() for g in grads]
                out["grad_metrics"] = {k: float(v) for k, v in m.items()
                                       if k != "teacher_pooled"}
                del grads, m
            if dev.type == "cuda":  # the steps' peak: of the state and the steps alone
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            step_ms = []
            for _ in range(case["steps"]):
                sync()
                K.reset_launch_counts()
                t0 = time.perf_counter()
                state, m = step_fn(state, batch)
                sync()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                out["steps"].append({k: float(v) for k, v in m.items() if k != "teacher_pooled"})
            mine = {"step_ms": step_ms, "flash_attention": K.launch_counts()["flash_attention"],
                    "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                                if dev.type == "cuda" else None)}
            if tp is not None:
                out["leaves"] = {k: _whole_leaf(state.params, state.teacher, k, tp).cpu()
                                 for k in case.get("leaves", ())}
            if tp is not None and case.get("decode"):
                model = TP.gather_params(state.params["model"], tp)
                if rank == 0:
                    out["decode"] = _tp_decode(cfg, model, dev, case["decode"])
                del model
            ranks = [None] * world
            dist.all_gather_object(ranks, mine)
            out["ranks"] = ranks
            results.append(out)
            del state
        if rank == 0:
            torch.save(results, os.path.join(work_dir, DP_OUT))
    finally:
        dist.destroy_process_group()


def _at(tree, path: str):
    """The leaf of `tree` at a "/"-joined path (list indices as integers)."""
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def _whole_leaf(params, teacher, name: str, tp):
    """A named leaf ("teacher/..." in the teacher, else in params) of a
    model rank's trees, gathered whole over the model group where it is
    cut (a collective: every rank of the group calls it); with tp None, of
    whole trees."""
    from vacnic_tpu_torch.core import tensor_parallel as TP

    head, _, rest = name.partition("/")
    tree, name = (teacher, rest) if head == "teacher" else (params, name)
    path = tuple(int(k) if k.isdigit() else k for k in name.split("/"))
    return TP.gather_leaf(path, _at(tree, name).detach(), tp)


def grid_backend(device: str, world: int) -> str:
    """gloo on the CPU and where the ranks outnumber the cards (NCCL refuses
    two ranks on one device), else nccl."""
    import torch

    if device == "cpu" or world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def run_dp_group(world: int, spec: dict, work_dir: str, timeout_s: float = 300) -> list:
    """dp_step_worker in `world` spawned processes (spec: device "cpu" or
    "cuda", the rank's card its rank modulo the cards; "backend", else
    grid_backend's; params and teacher, or "build"; rng, batch, cases), each
    joined within `timeout_s` of the start; a rank still alive then is
    killed, and any rank that failed fails the run -> rank 0's results."""
    import multiprocessing

    import torch

    os.makedirs(work_dir, exist_ok=True)
    for name in (DP_STORE, DP_OUT):
        if os.path.exists(os.path.join(work_dir, name)):
            os.remove(os.path.join(work_dir, name))
    spec = dict(spec, backend=spec.get("backend") or grid_backend(spec["device"], world))
    torch.save(spec, os.path.join(work_dir, DP_SPEC))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=dp_step_worker, args=(r, world, work_dir, timeout_s),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if hung or failed:
        raise RuntimeError(f"group of {world} processes: ranks {hung} still running after "
                           f"{timeout_s} s, (rank, exit code) {failed}")
    return torch.load(os.path.join(work_dir, DP_OUT), weights_only=False)


MESH_SERVE_ROWS = 8
MESHSCALE_ROWS = 32


def direct_sharded(cfg, mesh, model, rows):
    """generate_mm_sharded over `mesh` of the stacked rows, as the sharded
    service runs it -> (tokens, scores) on the CPU."""
    import numpy as np
    import torch

    from vacnic_tpu_torch.infer.generate import generate_mm_sharded
    from vacnic_tpu_torch.train.train_step import create_mask, face_mask_from_emb

    b = {k: torch.from_numpy(np.stack([r[k] for r in rows])).cuda() for k in rows[0]}
    seqs, scores = generate_mm_sharded(
        mesh, model, b["article_ids"], create_mask(b["article_ids"]), b["image_cls"], cfg.bart,
        cfg.fusion, cfg.decode, face_features=b["face_emb"],
        face_mask=face_mask_from_emb(b["face_emb"]), name_ids=b["names_art_ids"],
        name_mask=create_mask(b["names_art_ids"]), dtype=torch.bfloat16)
    return seqs.cpu(), scores.float().cpu()


def run_mesh_decode(cfg, params, mesh, batch_size: int, slice_counts: dict, gpu: str) -> dict:
    """(1) of the mesh phase: generate_mm_sharded over the mesh at the
    slice's batch, after one warm-up run; the launches (zeroed just before,
    read just after) must be the slice's counts times the devices, and the
    captions the slice's, token- and score-identical (on one device the
    same program at the same shapes; on several, each shard is held to a
    generate_mm of its own rows on its own device) -> the counts."""
    import torch

    from vacnic_tpu_torch.infer.generate import generate_mm, generate_mm_sharded
    from vacnic_tpu_torch.kernels import primitives as K

    devs = mesh.data_devices()
    x = batch_inputs(cfg, batch_size)

    def run():
        out = generate_mm_sharded(mesh, params, cfg=cfg.bart, fcfg=cfg.fusion, dcfg=cfg.decode,
                                  dtype=torch.bfloat16, **x)
        for d in devs:
            torch.cuda.synchronize(d)
        return out

    run()  # warm-up: the replicas, each device's allocator
    K.reset_launch_counts()
    t0 = time.perf_counter()
    seqs, scores = run()
    dt = time.perf_counter() - t0
    counts = counts_by_kernel()
    seqs, scores = seqs.cpu(), scores.float().cpu()
    if len(devs) == 1:
        want = [(TOKENS["slice"], SCORES["slice"])]
    else:
        per = batch_size // len(devs)
        want = []
        for i, d in enumerate(devs):  # from this thread: the launches go to d all the same
            s, c = generate_mm(params, cfg=cfg.bart, fcfg=cfg.fusion, dcfg=cfg.decode,
                               dtype=torch.bfloat16, device=d,
                               **{k: v[i * per:(i + 1) * per] for k, v in x.items()})
            want.append((s.cpu(), c.float().cpu()))
    want_seqs, want_scores = (torch.cat([w[0] for w in want]), torch.cat([w[1] for w in want]))
    nonpad = check_captions("mesh", cfg, seqs, scores, batch_size)
    expected = {k: len(devs) * slice_counts[k] for k in SLICE_COUNTED}
    log(f"mesh: generate_mm_sharded over {len(devs)} device(s), batch {batch_size}: "
        f"{dt:.3f} s, {batch_size / dt:.2f} captions/s, mean non-pad length {nonpad:.1f}; "
        f"launches { {k: counts[k] for k in SLICE_COUNTED} } (expected {expected}); tokens "
        f"{'identical' if torch.equal(seqs, want_seqs) else 'DIFFERENT'}, scores "
        f"{'identical' if torch.equal(scores, want_scores) else 'DIFFERENT'} ({gpu})")
    if any(counts[k] != n for k, n in expected.items()):
        raise RuntimeError(f"mesh: launches {counts}, expected the slice's times "
                           f"{len(devs)}: {expected}")
    if not (torch.equal(seqs, want_seqs) and torch.equal(scores, want_scores)):
        raise RuntimeError("mesh: generate_mm_sharded differs from one device's captions")
    TOKENS["mesh"] = seqs
    return counts


def run_mesh_service(cfg, params, mesh, gpu: str) -> None:
    """(2) of the mesh phase: CaptionService(mesh=) with one bucket of
    MESH_SERVE_ROWS rounded up to the devices: the rows' answers identical
    (tokens and scores) to a direct generate_mm_sharded of them; then an
    update_params swap to a tree from seed 1: the answers identical to a
    direct call on the new tree, and changed on every device's shard."""
    from vacnic_tpu_torch.serve import CaptionService, ServeConfig

    n = len(mesh.data_devices())
    bucket = -(-MESH_SERVE_ROWS // n) * n
    rows = sample_rows(cfg, bucket, seed=9)
    svc = CaptionService(cfg, {"model": params}, mesh=mesh,
                         serve_cfg=ServeConfig(buckets=(bucket,), max_wait_ms=2000))
    try:
        t0 = time.perf_counter()
        before = [f.result(timeout=600) for f in [svc.submit(r) for r in rows]]
        first_s = time.perf_counter() - t0
        check_identical("mesh service", before, *direct_sharded(cfg, mesh, params, rows))
        _, new = full_model(seed=1)
        t0 = time.perf_counter()
        version = svc.update_params({"model": new})
        swap_s = time.perf_counter() - t0
        after = [f.result(timeout=600) for f in [svc.submit(r) for r in rows]]
        check_identical("mesh service after the swap", after,
                        *direct_sharded(cfg, mesh, new, rows))
    finally:
        svc.close()
    per = bucket // n
    changed = [any(before[j]["tokens"] != after[j]["tokens"] for j in range(i * per, (i + 1) * per))
               for i in range(n)]
    log(f"mesh service: {bucket} requests over {n} device(s) in {first_s:.2f} s, identical to a "
        f"direct generate_mm_sharded; update_params to a seed-1 tree in {swap_s:.2f} s "
        f"(weights_version {version}): identical to a direct call on it, answers changed on "
        f"the shards {changed} ({gpu})")
    if version != 1 or not all(changed):
        raise RuntimeError("mesh service: the swap did not reach every replica")


def run_mesh_cli(cfg, params, mesh, gpu: str) -> None:
    """(3) of the mesh phase, on the cli phase's fixture and a checkpoint of
    the slice's tree with a ViT-B/16 tower: `cli generate --sharded` over
    the 32 test rows at batch 32 writes the file train/loop.
    generate_captions(mesh=) writes over the same cards (on one card, the
    one-device file), with every slice kernel launched; `cli serve
    --sharded` as a subprocess (serve_cli_roundtrip)."""
    import shutil
    import tempfile

    import torch

    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.kernels import primitives as K
    from vacnic_tpu_torch.models.clip_vit import clip_vision_init
    from vacnic_tpu_torch.models.weights_io import tree_to
    from vacnic_tpu_torch.train import loop
    from vacnic_tpu_torch.train.checkpoints import CheckpointManager
    from vacnic_tpu_torch.train.train_step import TrainState

    root = tempfile.mkdtemp(prefix="mesh_cli_")
    try:
        vocab, merges, base, dicts, tok = cli_fixture(root)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, data_dir=root))
        clip = tree_to(clip_vision_init(make_generator(0, "cuda"), cfg.clip, device="cuda"),
                       dtype=torch.bfloat16)
        tree = {"model": params, "clip": clip}
        ckpt = os.path.join(root, "ckpt")
        CheckpointManager(ckpt, cfg).save(0, TrainState(step=0, params=tree, teacher={},
                                                        opt_state={}, rng=0))
        test_dict = os.path.join(root, "GoodNews", CLI_SPLIT_FILE.format(split="test"))
        ref, out = os.path.join(root, "ref.json"), os.path.join(root, "gen.json")
        loop.generate_captions(cfg, tree, news_loader(cfg, tok, base, dicts["test"], False,
                                                      "cuda", batch_size=DATA_BATCH),
                               tok, out_path=ref, mesh=mesh)
        K.reset_launch_counts()
        run_cli(["generate", "--ckpt-dir", ckpt, "--data-dict", test_dict, "--vocab", vocab,
                 "--merges", merges, "--out", out, "--set", f"train.val_batch_size={DATA_BATCH}",
                 "--sharded"], "generate --sharded")
        counts = counts_by_kernel()
        check_launched("cli generate --sharded", counts, SLICE_KERNELS)
        with open(ref) as f, open(out) as g:
            equal = json.load(f) == json.load(g)
        log(f"cli generate --sharded: the file {'equal to' if equal else 'DIFFERENT from'} "
            f"generate_captions(mesh=) over {len(mesh.data_devices())} device(s); launches "
            f"{ {k: counts[k] for k in SLICE_KERNELS} } ({gpu})")
        if not equal:
            raise RuntimeError("cli generate --sharded differs from generate_captions")
        rows = sample_rows(cfg, CLI_SERVE_ROWS, seed=7)
        r = serve_cli_roundtrip(
            ckpt, rows, lambda row: direct_generate(cfg, params, [row]),
            lambda: CheckpointManager(ckpt).save(1, TrainState(step=1, params=tree, teacher={},
                                                               opt_state={}, rng=0)),
            os.path.join(OUT_DIR, "cli_serve_sharded.log"), serve_args=("--sharded",))
        log(f"cli serve --sharded: {r['wall_s']:.2f} s wall, healthy after {r['ready_s']:.2f} s; "
            f"{len(r['request_ms'])} requests over HTTP identical to a direct generate_mm "
            f"(ms {[round(v, 1) for v in r['request_ms']]}); the swap seen after "
            f"{r['swap_s']:.2f} s; SIGINT -> exit {r['exit']} ({gpu})")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def mesh_train_metrics(seed: int = 0) -> tuple:
    """The data-parallel training step of run_mesh_train on random f32 trees
    and a batch from `seed`, once under each product recipe (use_products,
    PRODUCT_RECIPES; the group's cases spawned once) -> (ranks, backend,
    the group's seconds, {recipe: (the group's metrics, one process's)})."""
    import shutil
    import tempfile

    import torch

    from vacnic_tpu_torch.core.config import VacnicConfig
    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.data.synthetic import synthetic_batch
    from vacnic_tpu_torch.models import fusion as F
    from vacnic_tpu_torch.models.bart import bart_init
    from vacnic_tpu_torch.models.clip_vit import clip_vision_init
    from vacnic_tpu_torch.models.weights_io import tree_to
    from vacnic_tpu_torch.train.train_step import make_train_step

    cfg = VacnicConfig.full_train()
    cfg = dataclasses.replace(
        cfg, bart=dataclasses.replace(cfg.bart, encoder_layers=DATA_FIT_LAYERS,
                                      decoder_layers=DATA_FIT_LAYERS),
        fusion=dataclasses.replace(cfg.fusion, fusion_layers=tuple(range(DATA_FIT_LAYERS))))
    bsz = cfg.train.train_batch_size
    g = make_generator(seed, "cuda")
    params = tree_to({"model": F.multimodal_bart_init(g, cfg.bart, cfg.fusion, device="cuda"),
                      "clip": clip_vision_init(g, cfg.clip, device="cuda")}, "cpu")
    teacher = tree_to(bart_init(g, cfg.bart, device="cuda"), "cpu")
    batch = {k: v.numpy()
             for k, v in synthetic_batch(cfg, bsz, seed=seed, with_pixels=True).items()}
    world = max(2, torch.cuda.device_count())
    backend = grid_backend("cuda", world)
    work = tempfile.mkdtemp(prefix="mesh_dp_")
    try:
        t0 = time.perf_counter()
        res = run_dp_group(world, dict(device="cuda", params=params, teacher=teacher,
                                       rng=cfg.train.seed, batch=batch,
                                       cases=[dict(cfg=cfg, steps=1, products=r)
                                              for r in PRODUCT_RECIPES]), work, timeout_s=600)
        group_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {}
    try:
        for recipe, got in zip(PRODUCT_RECIPES, res):
            use_products(recipe)
            init_fn, step_fn = make_train_step(cfg, 100, device="cuda")
            state = init_fn(tree_to(params, "cuda"), tree_to(teacher, "cuda"), cfg.train.seed)
            _, m = step_fn(state, batch)
            out[recipe] = (got["steps"][0],
                           {k: float(v) for k, v in m.items() if k != "teacher_pooled"})
            del state, step_fn
    finally:
        use_products("bf16")
    torch.cuda.empty_cache()
    return world, backend, group_s, out


def relative_gaps(got: dict, want: dict) -> dict:
    """|got - want| / (1 + |want|) for each metric of want."""
    return {k: abs(got[k] - want[k]) / (1 + abs(want[k])) for k in want}


def run_mesh_train(gpu: str) -> None:
    """(4) of the mesh phase: the data-parallel training step in a group of
    torch.cuda.device_count() NCCL ranks (run_dp_group: spawned processes,
    one card each; on one card two ranks sharing it over gloo, so that the
    group's collectives run there too) at full_train() widths cut to
    DATA_FIT_LAYERS + DATA_FIT_LAYERS layers, as released otherwise (bf16
    over f32, remat, dropout 0.1, CoLaM with the teacher's forward, SECLA,
    CLIP frozen on pixels), batch 32, random f32 trees from seed 0, one
    step, against a one-process step on the same global batch
    (mesh_train_metrics), with the products on each recipe. Gated on the
    float32 recipe (use_products("f32")), whose products a rank's rows meet
    at another batch size in nearly the same order: the loss terms within
    2e-5 (the CPU tests' tolerance; 1.1e-5 relative at most over four H100s
    at 700 W), the gradient norm within 2e-3: the bf16 gradients of each
    rank's rows round before the ranks' sum (2e-4 seen over 2 CPU ranks),
    and the backward's atomics sum in another order from run to run. On the
    program's bf16 products the library sums a rank's 64 face rows at K 3072
    in another order than one process's 128 (PERF.md section 7): that case
    is held to finite metrics of the same names, and its gaps are read
    beside the two recipes' own distance in one process."""
    import numpy as np
    import torch

    world, backend, group_s, by_recipe = mesh_train_metrics()
    for recipe, (got, want) in by_recipe.items():
        log(f"mesh train, {recipe} products: {world} ranks on {torch.cuda.device_count()} "
            f"card(s) over {backend}, full_train() widths at {DATA_FIT_LAYERS} + "
            f"{DATA_FIT_LAYERS} layers, batch 32 (each rank {32 // world} rows): the group "
            f"{group_s:.2f} s (spawn, {backend}, one step a recipe); its metrics {got}; one "
            f"process {want} ({gpu})")
        if set(got) != set(want):
            raise RuntimeError(f"mesh train, {recipe} products: metrics {sorted(got)} vs "
                               f"{sorted(want)}")
        if not all(np.isfinite(v) for v in list(got.values()) + list(want.values())):
            raise RuntimeError(f"mesh train, {recipe} products: metrics not finite")
    got, want = by_recipe["f32"]
    for k in want:
        tol = 2e-3 if k == "grad_norm" else 2e-5
        if not abs(got[k] - want[k]) <= tol * (1 + abs(want[k])):
            raise RuntimeError(f"mesh train: {k} {got[k]!r} on {world} rank(s) against "
                               f"{want[k]!r} in one process (f32 products)")
    gaps = {r: relative_gaps(*by_recipe[r]) for r in PRODUCT_RECIPES}
    apart = relative_gaps(by_recipe["bf16"][1], by_recipe["f32"][1])
    log("mesh train: the group against one process, relative, bf16 products against f32 "
        "products: " + ", ".join(f"{k} {gaps['bf16'][k]:.2e} / {gaps['f32'][k]:.2e}"
                                 for k in want)
        + "; one process's bf16 products against its f32 products: "
        + ", ".join(f"{k} {v:.2e}" for k, v in apart.items()) + f" ({gpu})")


def run_meshscale_phase(cfg, params, gpu: str) -> None:
    """Readings, not gated (`--phases meshscale`, not in the default list):
    the wall of generate_mm_sharded over the first k cards (k = 1, 2, 4, ...
    up to every card) at MESHSCALE_ROWS rows a card, the interpreter's
    switch interval at its default and at 1e-4 s, each timed after a
    warm-up run; beside them, one card's generate_mm at MESHSCALE_ROWS and
    at MESHSCALE_ROWS x k rows, and the k shards run one after another from
    this thread (no worker threads). Captions/s of each."""
    import torch

    from vacnic_tpu_torch.core.mesh import make_mesh
    from vacnic_tpu_torch.infer.generate import generate_mm, generate_mm_sharded
    from vacnic_tpu_torch.models.weights_io import tree_to

    n = torch.cuda.device_count()
    ks = [k for k in (1, 2, 4, 8) if k <= n]
    default_si = sys.getswitchinterval()

    def timed(fn) -> float:
        fn()
        for d in range(n):
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        fn()
        for d in range(n):
            torch.cuda.synchronize(d)
        return time.perf_counter() - t0

    kw = dict(cfg=cfg.bart, fcfg=cfg.fusion, dcfg=cfg.decode, dtype=torch.bfloat16)
    for k in ks:
        rows = MESHSCALE_ROWS * k
        x = batch_inputs(cfg, rows)
        mesh = make_mesh(devices=[f"cuda:{i}" for i in range(k)])
        one = timed(lambda: generate_mm(params, device="cuda:0", **kw, **x))
        readings = [f"one card at {rows} rows {one:.3f} s ({rows / one:.2f} captions/s)"]
        for si in (default_si, 1e-4):
            sys.setswitchinterval(si)
            try:
                dt = timed(lambda: generate_mm_sharded(mesh, params, **kw, **x))
            finally:
                sys.setswitchinterval(default_si)
            readings.append(f"sharded, switch interval {si:g} s: {dt:.3f} s "
                            f"({rows / dt:.2f} captions/s)")
        replicas = [tree_to(params, f"cuda:{i}") for i in range(k)]
        seq = timed(lambda: [generate_mm(replicas[i], device=f"cuda:{i}", **kw,
                                         **{a: v[i * MESHSCALE_ROWS:(i + 1) * MESHSCALE_ROWS]
                                            for a, v in x.items()}) for i in range(k)])
        readings.append(f"the {k} shards one after another from one thread {seq:.3f} s")
        log(f"meshscale: {k} card(s), {MESHSCALE_ROWS} rows a card: " + "; ".join(readings)
            + f" ({gpu})")
        del replicas


def run_mesh_phase(cfg, params, batch_size: int, slice_counts: dict, gpu: str) -> dict:
    """The mesh phase: multi-GPU over every visible card (make_mesh()) and
    a group of as many NCCL ranks -- run_mesh_decode, run_mesh_service,
    run_mesh_cli, run_mesh_train -> the sharded decode's launch counts."""
    from vacnic_tpu_torch.core.mesh import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh()
    log(f"mesh: devices {[str(d) for d in mesh.data_devices()]}, mesh shape {mesh.shape}")
    counts = run_mesh_decode(cfg, params, mesh, batch_size, slice_counts, gpu)
    run_mesh_service(cfg, params, mesh, gpu)
    run_mesh_cli(cfg, params, mesh, gpu)
    run_mesh_train(gpu)
    log(f"mesh: phase {time.perf_counter() - t0:.1f} s wall")
    return counts


# ---------------------------------------------------------------------------
# tp phase: the dp x tp training step (core/tensor_parallel)
# ---------------------------------------------------------------------------

TP_LAYERS = 12  # encoder and decoder layers of the tp phase: full_train()'s 12 + 12
TP_STEPS = 2    # step 0's warmup lr is 0: step 1 moves the leaves
# (a column-parallel, a row-parallel and a replicated leaf) of BART, of the
# fusion encoder and of the teacher
TP_LEAVES = ("model/decoder/layers/0/fc1/kernel", "model/decoder/layers/0/self_attn/out_proj/kernel",
             "model/decoder/layers/0/final_layer_norm/scale",
             "model/encoder/layers/0/img_up/kernel", "model/encoder/layers/0/face_down/kernel",
             "model/encoder/layers/0/img_layer_norm/scale",
             "teacher/encoder/layers/0/self_attn/q_proj/kernel",
             "teacher/decoder/layers/0/fc2/kernel", "teacher/shared/weight")
# f32 levels, between the f32 readings and the bf16 control (PERF.md §6)
TP_NORM_TOL = 1e-4  # the gradient norm, relative to 1 + |one process's|
TP_LEAF_TOL = 1e-3  # |update - one process's update| over |one process's update|, by norm
TP_GRAD_TOL = 1e-4  # |gradient - one process's| over the leaf's largest |gradient|
# the bf16 witness: a bf16 tp step's whole gradient and loss terms no further from
# the f32 one-process step than TP_BF16_RATIO times one bf16 process's, each
# gradient leaf than TP_BF16_LEAF_RATIO times (read at full width: the whole
# gradient 1.00-1.14x, a term at most 1.60x, a leaf at most 3.34x, where a
# missing sum reads tens; PERF.md §6)
TP_BF16_RATIO = 3.0
TP_BF16_LEAF_RATIO = 6.0


def tp_config(layers: int = TP_LAYERS, dtype: str = "float32"):
    """VacnicConfig.full_train() as released (batch 32, f32 trees, remat,
    dropout 0.1, CoLaM, SECLA, CLIP frozen on pixels), `layers` + `layers`,
    computed in `dtype`. The phase holds the tp step to one process in f32:
    in bf16 a rank's products sum in another order (narrower products, a
    row-parallel sum), a bf16 rounding flips here and there, and SECLA's
    loss moves by as much as bf16 itself moves it (PERF.md §6); bf16 is
    held by bf16_witness instead."""
    from vacnic_tpu_torch.core.config import VacnicConfig

    cfg = VacnicConfig.full_train()
    return dataclasses.replace(
        cfg, bart=dataclasses.replace(cfg.bart, encoder_layers=layers, decoder_layers=layers),
        fusion=dataclasses.replace(cfg.fusion, fusion_layers=tuple(range(layers))),
        train=dataclasses.replace(cfg.train, compute_dtype=dtype))


def _key_bias(path: tuple) -> bool:
    """A key projection's bias: its gradient is zero but for rounding noise
    (softmax ignores a shift of the scores)."""
    return tuple(path[-2:]) == ("k_proj", "bias")


def grad_errors(paths, got, want) -> dict:
    """path -> max |got - want| over the largest |want| of the leaf (of a key
    bias: of its attention's q/v/out leaves), for every leaf with a
    gradient in `want`; `got` must have one exactly there."""
    import torch

    attn_max: dict = {}
    for path, w in zip(paths, want):
        if w is not None and not _key_bias(path):
            attn_max[path[:-2]] = max(attn_max.get(path[:-2], 0.0), float(w.abs().max()))
    out = {}
    for path, g, w in zip(paths, got, want):
        if (g is None) != (w is None) or (w is not None and g.shape != w.shape):
            out[path] = float("inf")
        elif w is not None:
            scale = attn_max[path[:-2]] if _key_bias(path) else float(w.abs().max())
            out[path] = float((g.float() - w.float()).abs().max()) / max(scale, 1e-30)
    return out


def bf16_witness(paths, g32, g16, t16, m32: dict, m16: dict, mt16: dict) -> dict:
    """Whether a bf16 tensor-parallel step is rounding and not a fault: its
    distance from the f32 one-process step (g32, m32) against one bf16
    process's (g16, m16), the same trees, batch and dropout. Gradients by
    norm, over every leaf ("all") and leaf by leaf (key biases left out:
    their f32 gradient is noise around zero), each as (one bf16 process, tp
    bf16); the loss terms and the gradient norm relative to 1 + |f32|.
    "ok_gradients": the whole gradient within TP_BF16_RATIO times one bf16
    process's distance, every leaf within TP_BF16_LEAF_RATIO times; "ok":
    those and every term within TP_BF16_RATIO times (a term also within
    2e-5)."""
    sq = [0.0] * 5  # |g32|^2, |g16|^2, |t16|^2, |g16 - g32|^2, |t16 - g32|^2 over every leaf
    leaves = {}
    for p, a, b, c in zip(paths, g32, g16, t16):
        if a is None:
            continue
        a, b, c = a.double(), b.double(), c.double()
        mine = [float(x.square().sum()) for x in (a, b, c, b - a, c - a)]
        sq = [u + v for u, v in zip(sq, mine)]
        if not _key_bias(p):
            leaves[p] = ((mine[3] / max(mine[0], 1e-60)) ** 0.5,
                         (mine[4] / max(mine[0], 1e-60)) ** 0.5)
    out = {"all": ((sq[3] / sq[0]) ** 0.5, (sq[4] / sq[0]) ** 0.5), "leaves": leaves}
    terms = {k: (m32[k], m16[k], mt16[k]) for k in m32}
    terms["grad_norm"] = tuple(v ** 0.5 for v in sq[:3])
    out["terms"] = {k: (abs(b - a) / (1 + abs(a)), abs(c - a) / (1 + abs(a)))
                    for k, (a, b, c) in terms.items()}
    out["ok_gradients"] = (out["all"][1] <= TP_BF16_RATIO * out["all"][0]
                           and all(t <= TP_BF16_LEAF_RATIO * o
                                   for o, t in out["leaves"].values()))
    out["ok"] = out["ok_gradients"] and all(t <= TP_BF16_RATIO * o + 2e-5
                                            for o, t in out["terms"].values())
    return out


def tp_trees(device, cfg, seed: int = 0):
    """The whole f32 trees of `cfg` from `seed` on `device`: ({"model",
    "clip"}, teacher), what every rank of the tp phase makes for itself."""
    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.models import fusion as F
    from vacnic_tpu_torch.models.bart import bart_init
    from vacnic_tpu_torch.models.clip_vit import clip_vision_init

    g = make_generator(seed, device)
    params = {"model": F.multimodal_bart_init(g, cfg.bart, cfg.fusion, device=device),
              "clip": clip_vision_init(g, cfg.clip, device=device)}
    return params, bart_init(g, cfg.bart, device=device)


def tp_grids(cards: int) -> list[tuple[int, int]]:
    """The (dp, tp) grids of the phase: tp 2 as two ranks sharing one card;
    on four cards dp 2 x tp 2 and dp 1 x tp 4; else tp over every card."""
    if cards == 1:
        return [(1, 2)]
    if cards == 4:
        return [(2, 2), (1, 4)]
    return [(1, cards)]


def _one_process_grads(cfg, batch, seed: int = 0) -> tuple:
    """One process's loss_and_grads at step 1's dropout seed on tp_trees(cfg, seed),
    as dp_step_worker's `grads` takes it -> (the state, (paths, host
    gradients, metrics)); the caller goes on stepping the state or drops it."""
    from vacnic_tpu_torch.core.tree import leaves_with_path
    from vacnic_tpu_torch.models.layers import split
    from vacnic_tpu_torch.train.train_step import loss_and_grads, make_train_step

    params, teacher = tp_trees("cuda", cfg, seed)
    init_fn, step_fn = make_train_step(cfg, 100, device="cuda")
    state = init_fn(params, teacher, cfg.train.seed)
    m, grads = loss_and_grads(state.params, state.teacher, batch, cfg, split(state.rng)[1])
    paths = [p for p, _ in leaves_with_path(state.params)]
    host = [None if g is None else g.cpu() for g in grads]
    return state, step_fn, (paths, host, {k: float(v) for k, v in m.items()
                                          if k != "teacher_pooled"})


def run_tp_phase(gpu: str) -> int:
    """The dp x tp training step (core/tensor_parallel, make_train_step(
    group=, model_group=)) at full width (tp_config(): full_train() at
    TP_LAYERS + TP_LAYERS layers, batch 32, dropout on, f32), against the
    one-process step on the same batch and trees. First the one process:
    its gradients (loss_and_grads at step 1's seed), then TP_STEPS steps
    (metrics, the step's ms and peak memory, the named leaves); then the
    gradients of one bf16 process; each process's memory freed after it.
    Then one group of spawned processes (run_dp_group; each rank makes the
    whole trees from the seed on its card, checked equal across ranks, and
    keeps its shards) over every grid of tp_grids, then two bf16 cases on
    the first grid: on one card two ranks sharing it over gloo (NCCL refuses
    two ranks a device; core/tensor_parallel stages gloo's CUDA tensors
    through host memory), on several cards NCCL. Gated for each grid: the
    loss terms of every step within 2e-5 (relative to 1 + |value|) of one
    process, the gradient norm within TP_NORM_TOL; the named leaves after
    the steps, gathered whole: the teacher's bit-identical to one
    process's, the others' updates within TP_LEAF_TOL by norm; every rank's
    parameter storage equal to the bytes of its shard shapes; gather_params
    of the teacher bit-identical to the whole teacher; flash_attention
    launched by the teacher on the head shards in every rank's step; the
    decode after training (gather_params, then generate_mm_sharded at batch
    32 over a data mesh, rank 0) token- and score-identical to generate_mm
    of the same tree. On the first grid also its gradients: every
    replicated leaf's bit-identical across the model ranks, every leaf
    within TP_GRAD_TOL (grad_errors) and the loss terms within 2e-5 of one
    process's. The bf16 cases, one a product recipe (use_products), each
    beside one bf16 process on the same recipe: bf16_witness, whole on the
    float32 recipe, where its ratios were read; on the program's bf16
    products its gradients (ok_gradients), its loss terms and gradient norm
    read (a rank's narrower bf16 products sum in another order, and SECLA
    carries a flipped rounding into the terms; PERF.md section 7).
    Readings: step ms, samples/s and peak GB a rank against one process. -> flash_attention's launches
    in rank 0's last step of the first grid."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vacnic_tpu_torch.data.synthetic import synthetic_batch
    from vacnic_tpu_torch.kernels import primitives as K

    t_phase = time.perf_counter()
    cfg, cfg16 = tp_config(), tp_config(dtype="bfloat16")
    bsz = cfg.train.train_batch_size
    batch = {k: v.numpy() for k, v in synthetic_batch(cfg, bsz, seed=0, with_pixels=True).items()}

    state, step_fn, (paths, one_grads, one_gm) = _one_process_grads(cfg, batch)
    before = {k: _whole_leaf(state.params, state.teacher, k, None).cpu().clone()
              for k in TP_LEAVES}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    one_base = torch.cuda.memory_allocated() / 1e9
    one_steps, one_ms = [], []
    for _ in range(TP_STEPS):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t0) * 1e3)
        one_steps.append({k: float(v) for k, v in m.items() if k != "teacher_pooled"})
    one_flash = K.launch_counts()["flash_attention"]
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    one_leaves = {k: _whole_leaf(state.params, state.teacher, k, None).cpu().clone()
                  for k in TP_LEAVES}
    del state, step_fn
    torch.cuda.empty_cache()
    one16 = {}
    try:
        for recipe in PRODUCT_RECIPES:
            use_products(recipe)
            state, step_fn, (_, g16, m16) = _one_process_grads(cfg16, batch)
            del state, step_fn
            torch.cuda.empty_cache()
            one16[recipe] = (g16, m16)
    finally:
        use_products("bf16")
    log(f"tp: one process, full_train() widths at {TP_LAYERS} + {TP_LAYERS} layers, batch {bsz}: "
        f"step ms {[round(v, 1) for v in one_ms]}, {bsz / one_ms[-1] * 1e3:.2f} samples/s, "
        f"peak {one_peak:.2f} GB ({one_base:.2f} GB held before the steps), "
        f"flash_attention {one_flash} launches a step; metrics "
        f"{one_steps} ({gpu})")

    cards = torch.cuda.device_count()
    grids = tp_grids(cards)
    world = grids[0][0] * grids[0][1]
    decode = dict(batch=bsz, seed=1, dtype=torch.bfloat16)
    cases = [dict(cfg=cfg, steps=TP_STEPS, grid=grid, leaves=TP_LEAVES, decode=decode,
                  grads=i == 0) for i, grid in enumerate(grids)]
    cases += [dict(cfg=cfg16, steps=0, grid=grids[0], grads=True, products=r)
              for r in PRODUCT_RECIPES]
    work = tempfile.mkdtemp(prefix="tp_")
    try:
        t0 = time.perf_counter()
        res = run_dp_group(world, dict(device="cuda", build=(tp_trees, {"cfg": cfg}),
                                       rng=cfg.train.seed, batch=batch, cases=cases),
                           work, timeout_s=900)
        group_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res, res16 = res[:-2], dict(zip(PRODUCT_RECIPES, res[-2:]))
    backend = grid_backend("cuda", world)
    log(f"tp: {world} spawned ranks on {cards} card(s), backend {backend}"
        + (" (CUDA tensors of the model group's collectives staged through host memory)"
           if backend == "gloo" else "") + f", grids {grids}: {group_s:.1f} s wall (spawn, "
        f"every rank's trees, {TP_STEPS} steps a grid, gathers, decodes, the gradients of the "
        f"first grid and of the bf16 cases)")

    def within(got: dict, want: dict, tag: str) -> list:
        if set(got) != set(want):
            return [f"{tag}: metrics {sorted(got)} vs {sorted(want)}"]
        return [f"{tag}: {k} {got[k]!r} against {want[k]!r}" for k in want
                if not (np.isfinite(got[k]) and abs(got[k] - want[k])
                        <= (TP_NORM_TOL if k == "grad_norm" else 2e-5) * (1 + abs(want[k])))]

    failures = []
    for grid, r in zip(grids, res):
        tag = f"tp grid dp {grid[0]} x tp {grid[1]}"
        for i, (got, want) in enumerate(zip(r["steps"], one_steps)):
            failures += within(got, want, f"{tag} step {i}")
        errs = {}
        for k in TP_LEAVES:
            g, w, b = r["leaves"][k], one_leaves[k], before[k]
            if g.shape != w.shape:
                failures.append(f"{tag}: leaf {k} gathered as {tuple(g.shape)}")
                continue
            if k.startswith("teacher/"):
                errs[k] = 0.0 if torch.equal(g, w) and torch.equal(w, b) else float("inf")
            else:
                upd = float((w - b).norm())
                errs[k] = float((g - w).norm()) / max(upd, 1e-30)
                if upd == 0.0:
                    failures.append(f"{tag}: leaf {k} not moved by the update")
            if not errs[k] <= (0.0 if k.startswith("teacher/") else TP_LEAF_TOL):
                failures.append(f"{tag}: leaf {k} off by {errs[k]:.3e} of its update")
        t = r["tp"]
        if t["param_bytes"] != t["shard_bytes"] or not t["teacher_gathered"]:
            failures.append(f"{tag}: rank 0 holds {t['param_bytes']} parameter bytes against "
                            f"{t['shard_bytes']} of its shards; teacher gathered whole "
                            f"{t['teacher_gathered']}")
        grad_line = ""
        if "grads" in r:
            failures += within(r["grad_metrics"], one_gm, f"{tag} gradients")
            gerr = grad_errors(paths, r["grads"], one_grads)
            worst = max(gerr, key=gerr.get)
            if not t["replicated_grads_agree"]:
                failures.append(f"{tag}: replicated leaves' gradients differ across model ranks")
            failures += [f"{tag}: gradient of {'/'.join(map(str, p))} off by {e:.3e} of its "
                         f"largest" for p, e in gerr.items() if not e <= TP_GRAD_TOL]
            grad_line = (f"; gradients of {len(gerr)} leaves within {gerr[worst]:.2e} of the "
                         f"largest (worst {'/'.join(map(str, worst))}), replicated ones "
                         f"bit-identical across model ranks {t['replicated_grads_agree']}")
        flash = [q["flash_attention"] for q in r["ranks"]]
        if not all(flash):
            failures.append(f"{tag}: flash_attention launches a rank {flash}")
        d = r["decode"]
        if not (d["identical"] and d["finite"]):
            failures.append(f"{tag}: the decode after training: identical {d['identical']}, "
                            f"finite {d['finite']}")
        ms = [q["step_ms"][-1] for q in r["ranks"]]
        peaks = [q["peak_gb"] for q in r["ranks"]]
        log(f"{tag} ({world} ranks on {cards} card(s), {backend}): metrics {r['steps']}; "
            f"named leaves off by { {k: f'{v:.2e}' for k, v in errs.items()} } of the update"
            f"{grad_line}; rank 0's parameters {t['param_bytes'] / 1e9:.3f} GB = its shard "
            f"shapes {t['param_bytes'] == t['shard_bytes']}, teacher gathered whole "
            f"{t['teacher_gathered']}; flash_attention a step by rank {flash}; last step ms "
            f"by rank {[round(v, 1) for v in ms]} ({bsz / max(ms) * 1e3:.2f} samples/s against "
            f"{bsz / one_ms[-1] * 1e3:.2f} in one process), peak GB by rank "
            f"{[round(v, 2) for v in peaks]} (one process {one_peak:.2f}); decode at batch "
            f"{bsz} over a data mesh identical to generate_mm {d['identical']}, tokens "
            f"{tuple(d['tokens'].shape)} ({gpu})")
        TOKENS[f"tp_{grid[0]}x{grid[1]}"] = d["tokens"]

    for recipe in PRODUCT_RECIPES:
        (g16, m16), r16 = one16[recipe], res16[recipe]
        w = bf16_witness(paths, one_grads, g16, r16["grads"], one_gm, m16, r16["grad_metrics"])
        ratios = sorted(((t / max(o, 1e-30), "/".join(map(str, p)), o, t)
                         for p, (o, t) in w["leaves"].items()), reverse=True)
        worst = "; ".join(f"{name} {o:.2e} against {t:.2e} ({r:.2f}x)"
                          for r, name, o, t in ratios[:3])
        apart = {k: f"{abs(r16['grad_metrics'][k] - v) / (1 + abs(v)):.2e}"
                 for k, v in m16.items()}
        log(f"tp bf16 witness, {recipe} products (grid dp {grids[0][0]} x tp {grids[0][1]}, "
            f"{backend}): distance from the f32 one-process step, one bf16 process against "
            f"the bf16 tp step: gradients by norm {w['all'][0]:.3e} against "
            f"{w['all'][1]:.3e}; by leaf {sum(r > 1 for r, *_ in ratios)} of {len(ratios)} "
            f"leaves further in the tp step, {sum(r > 2 for r, *_ in ratios)} over 2x, the "
            f"three furthest {worst}; terms "
            f"{ {k: f'{o:.2e} against {t:.2e}' for k, (o, t) in w['terms'].items()} } (within "
            f"{TP_BF16_RATIO}x: {w['ok']}); the tp step's terms against one bf16 process, "
            f"relative {apart} ({gpu})")
        if not w["ok" if recipe == "f32" else "ok_gradients"]:
            failures.append(f"tp bf16, {recipe} products: the tp step further from the f32 "
                            f"step than one bf16 process by more than {TP_BF16_RATIO}x (whole "
                            f"gradient {w['all']}"
                            + (f", terms {w['terms']}" if recipe == "f32" else "")
                            + f") or {TP_BF16_LEAF_RATIO}x (leaves: {worst})")
    log(f"tp: phase {time.perf_counter() - t_phase:.1f} s wall")
    if failures:
        raise RuntimeError("tp: " + "; ".join(failures))
    return res[0]["ranks"][0]["flash_attention"]


BF16GAPS_SEEDS = (0, 1, 2)  # the trees' and the batch's seeds of the bf16gaps phase


def run_bf16gaps_phase(gpu: str) -> None:
    """Readings, not gated (`--phases bf16gaps`, not in the default list):
    for each seed of BF16GAPS_SEEDS (trees and batch), the mesh phase's
    data-parallel step (mesh_train_metrics) and the tp phase's bf16 witness
    (bf16_witness on the first grid of tp_grids), each with the products on
    the program's bf16 recipe and on the float32 one (use_products): the
    group's loss terms against one process's, the two recipes' distance in
    one process, whether the group's terms lie within TP_BF16_RATIO times
    that distance (+ 2e-5), and the witness's distances with its verdict."""
    import shutil
    import tempfile

    import torch

    from vacnic_tpu_torch.data.synthetic import synthetic_batch

    def terms(d: dict) -> str:
        return ", ".join(f"{k} {v}" for k, v in d.items())

    for seed in BF16GAPS_SEEDS:
        world, backend, _, by_recipe = mesh_train_metrics(seed)
        gaps = {r: relative_gaps(*by_recipe[r]) for r in PRODUCT_RECIPES}
        apart = relative_gaps(by_recipe["bf16"][1], by_recipe["f32"][1])
        within = all(gaps["bf16"][k] <= TP_BF16_RATIO * v + 2e-5 for k, v in apart.items())
        log(f"bf16gaps seed {seed}: dp, {world} ranks ({backend}) against one process, "
            f"relative, bf16 products / f32 products: "
            + terms({k: f"{gaps['bf16'][k]:.2e} / {gaps['f32'][k]:.2e}" for k in apart})
            + "; one process's bf16 products against its f32 products: "
            + terms({k: f"{v:.2e}" for k, v in apart.items()})
            + f"; the bf16 group within {TP_BF16_RATIO}x that (+ 2e-5): {within} ({gpu})")
    cfg, cfg16 = tp_config(), tp_config(dtype="bfloat16")
    grid = tp_grids(torch.cuda.device_count())[0]
    for seed in BF16GAPS_SEEDS:
        batch = {k: v.numpy() for k, v in synthetic_batch(
            cfg, cfg.train.train_batch_size, seed=seed, with_pixels=True).items()}
        state, step_fn, (paths, g32, m32) = _one_process_grads(cfg, batch, seed)
        del state, step_fn
        torch.cuda.empty_cache()
        one = {}
        try:
            for recipe in PRODUCT_RECIPES:
                use_products(recipe)
                state, step_fn, (_, g16, m16) = _one_process_grads(cfg16, batch, seed)
                del state, step_fn
                torch.cuda.empty_cache()
                one[recipe] = (g16, m16)
        finally:
            use_products("bf16")
        work = tempfile.mkdtemp(prefix="bf16gaps_")
        try:
            res = run_dp_group(grid[0] * grid[1], dict(
                device="cuda", build=(tp_trees, {"cfg": cfg, "seed": seed}),
                rng=cfg.train.seed, batch=batch,
                cases=[dict(cfg=cfg16, steps=0, grid=grid, grads=True, products=r)
                       for r in PRODUCT_RECIPES]), work, timeout_s=900)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        for recipe, r in zip(PRODUCT_RECIPES, res):
            w = bf16_witness(paths, g32, one[recipe][0], r["grads"], m32, one[recipe][1],
                             r["grad_metrics"])
            ratios = [t / max(o, 1e-30) for o, t in w["leaves"].values()]
            log(f"bf16gaps seed {seed}: tp bf16 witness, {recipe} products (grid dp {grid[0]} x "
                f"tp {grid[1]}): ok {w['ok']}; whole gradient {w['all'][0]:.3e} against "
                f"{w['all'][1]:.3e}; {sum(x > 2 for x in ratios)} of {len(ratios)} leaves over "
                f"2x, the largest {max(ratios):.2f}x; terms, one bf16 process against the tp "
                f"step: " + terms({k: f"{o:.2e} against {t:.2e}"
                                   for k, (o, t) in w["terms"].items()}) + f" ({gpu})")
        del g32, one, res
        torch.cuda.empty_cache()


LED_BATCH, LED_S = 32, 16384  # the LED cell's batch and article bucket


def within_tolerance(out, ref) -> tuple[float, bool]:
    """(the widest gap of `out` to `ref`, every element within tolerance())."""
    tol_a, tol_r = tolerance(out)
    err = (out.float() - ref.float()).abs()
    return float(err.max()), bool((err <= tol_a + tol_r * ref.float().abs()).all())


def run_led_phase(gpu: str) -> None:
    """LED's kernels (VacnicConfig.led_full) at its cell's shape, B 32 x S
    16384, H 16, lengths in [8192, 16384), each against its plain twin and
    held to it: enc_window_attention (w 512, global <s>) and the whole LED
    self-attention of a layer (the window, then the global rows by gemm,
    cross_kv bf16 and dec_cross_attention at one query an item) within
    tolerance() on four items; cross_kv int8 of one layer by cross_kv_gaps
    on two; dec_cross_attention int8 at 5 beams (the split over a cluster)
    within tolerance(). Readings: ms (time_ms), graph ms, the bound, the
    plain twin's ms, the library's ms where one call does the work (SDPA
    with the band-and-global mask as a [4, 1, S, S] bool on four items;
    bf16 `addmm`, product and bias), the gap; led_kernels.json in OUT_DIR
    holds them. Then run_led_path."""
    import torch

    from vacnic_tpu_torch.core.config import VacnicConfig
    from vacnic_tpu_torch.kernels import encoder_stack as ES
    from vacnic_tpu_torch.kernels import primitives as K

    cfg = VacnicConfig.led_full().bart
    b, s_len, heads, d = LED_BATCH, LED_S, cfg.encoder_attention_heads, cfg.d_model
    w, glob = cfg.attention_window // 2, cfg.global_tokens
    g = torch.Generator(device="cuda").manual_seed(23)
    lengths = torch.randint(s_len // 2, s_len, (b,), generator=g, device="cuda")
    keep = torch.arange(s_len, device="cuda")[None, :] < lengths[:, None]
    bias = torch.where(keep, 0.0, torch.finfo(torch.float32).min).float().contiguous()
    bias_k = torch.clamp(bias, min=float(torch.finfo(torch.bfloat16).min)).contiguous()
    rows, bad = [], []

    def row(name, call, plain, byts, ops, library=None, gap=None, ok=True):
        ms, gms = time_ms(call, reps=3), graph_ms(call, reps=3)
        bms, by = bound(byts, ops)
        plain_ms = time_ms(plain, reps=1, warmup=1, groups=1)
        lib = None
        if library is not None:
            lib = (time_ms(library, reps=2, groups=3), graph_ms(library, reps=2))
        r = {"name": name, "ms": ms, "graph_ms": gms, "bound_ms": bms, "bound": by,
             "plain_ms": plain_ms, "library_ms": lib, "gap": gap, "ok": ok}
        log(f"led: {name}: {ms:.4f} ms, graph {gms:.4f}, bound {bms:.4f} ({by}), plain "
            f"{plain_ms:.1f}, library {lib}, gap {gap}, {'ok' if ok else 'OUT OF TOLERANCE'} "
            f"({gpu})")
        rows.append(r)
        if not ok:
            bad.append(name)
        torch.cuda.empty_cache()

    # the window attention
    qkv = (torch.randn(b * s_len, 3 * d, generator=g, device="cuda")).to(torch.bfloat16)
    out = K.enc_window_attention(qkv, bias_k, b, s_len, heads, w, glob)
    ref = torch.cat([K.enc_window_attention_plain(qkv[i * s_len:(i + 1) * s_len],
                                                  bias_k[i:i + 1], 1, s_len, heads, w, glob)
                     for i in range(4)])
    gap, ok = within_tolerance(out[:4 * s_len], ref)
    keys = sum(sum(min(s_len - 1, i + w) - max(0, i - w) + 1 + (1 if i - w > 0 else 0)
                   for i in range(0, int(n), 64)) * 64 for n in lengths.tolist())
    q4 = qkv.view(b, s_len, 3, heads, 64).permute(2, 0, 3, 1, 4)
    pos = torch.arange(s_len, device="cuda")
    band = ((pos[:, None] - pos[None, :]).abs() <= w) | (pos[None, :] < glob)
    mask = (band[None] & keep[:4, None, :])[:, None]  # [4, 1, S, S]: four items of the batch

    def sdpa():  # four items: its time x 8 is the batch's
        return torch.nn.functional.scaled_dot_product_attention(q4[0, :4], q4[1, :4], q4[2, :4],
                                                                attn_mask=mask)

    row(f"enc_window_attention B={b} S={s_len} H={heads} w={w} G={glob} "
        "(library: SDPA on 4 items)",
        lambda: K.enc_window_attention(qkv, bias_k, b, s_len, heads, w, glob),
        lambda: K.enc_window_attention_plain(qkv, bias_k, b, s_len, heads, w, glob),
        b * s_len * 4 * d * 2, 4.0 * 64 * heads * keys, sdpa, gap, ok)
    del mask, band, out, ref

    # the LED self-attention of a layer: the window, then the global rows
    xb = torch.randn(b * s_len, d, generator=g, device="cuda").to(torch.bfloat16)
    sp = ES.EncStackParams(
        *([None] * 15),
        w_qg=(torch.randn(1, d, d, generator=g, device="cuda") * 0.02).to(torch.bfloat16),
        b_qg=torch.randn(1, d, generator=g, device="cuda") * 0.02,
        w_kvg=(torch.randn(1, d, 2 * d, generator=g, device="cuda") * 0.02).to(torch.bfloat16),
        b_kvg=torch.randn(1, 2 * d, generator=g, device="cuda") * 0.02)
    got = ES._window_attention(sp, 0, qkv, xb, bias_k, b, s_len, cfg, ES.KERNEL_OPS)
    gap, ok = 0.0, True
    for i in range(4):
        rs = slice(i * s_len, (i + 1) * s_len)
        ref = ES._window_attention(sp, 0, qkv[rs], xb[rs], bias_k[i:i + 1], 1, s_len, cfg,
                                   ES.PLAIN_OPS)
        gi, oi = within_tolerance(got[rs], ref)
        gap, ok = max(gap, gi), ok and oi
    row("LED self-attention a layer (window + global rows)",
        lambda: ES._window_attention(sp, 0, qkv, xb, bias_k, b, s_len, cfg, ES.KERNEL_OPS),
        lambda: ES._window_attention(sp, 0, qkv, xb, bias_k, b, s_len, cfg, ES.PLAIN_OPS),
        b * s_len * 4 * d * 2 + b * s_len * 2 * d * 2 * 2 + b * s_len * d * 2,
        4.0 * 64 * heads * keys + 2.0 * b * s_len * d * 2 * d + 4.0 * b * s_len * d, None, gap, ok)
    del qkv, xb, got, ref

    # the decoder's long cross K/V, one layer
    x, wkv, bkv = cross_kv_inputs(g, b, s_len, d, layers=1)
    got = K.cross_kv(x, wkv, bkv, heads, True)
    ref = K.cross_kv_plain(x[:2].contiguous(), wkv, bkv, heads, True)
    gaps = cross_kv_gaps(tuple(t[:, :2] for t in got), ref)
    row(f"cross_kv int8 B={b} S={s_len} d={d}, one layer [long]",
        lambda: K.cross_kv(x, wkv, bkv, heads, True),
        lambda: K.cross_kv_plain(x, wkv, bkv, heads, True),
        (b * s_len * d + d * 2 * d) * 2 + 2 * d * 4 + b * s_len * 2 * d + 2 * b * d * 4,
        2.0 * b * s_len * d * 2 * d,
        lambda: torch.addmm(bkv[0].to(torch.bfloat16), x.view(-1, d), wkv[0]),
        {k: v for k, v in gaps.items() if k != "ok"}, gaps["ok"])
    del x, got, ref

    # the split dec_cross_attention, int8, 5 beams
    beams = VacnicConfig.led_full().decode.num_beams
    q = torch.randn(b * beams, d, generator=g, device="cuda").to(torch.bfloat16)
    ck, cv = (torch.randint(-127, 128, (b, heads, 64, s_len), generator=g,
                            device="cuda").to(torch.int8) for _ in range(2))
    ks, vs = (torch.rand(b, heads, 64, generator=g, device="cuda") * 0.01 + 1e-3
              for _ in range(2))
    out = K.dec_cross_attention(q, ck, cv, ks, vs, bias, heads)
    gap, ok = within_tolerance(out, K.dec_cross_attention_plain(q, ck, cv, ks, vs, bias, heads))
    plan = K.dec_cross_plan(beams, s_len, 1)
    if plan.variant != "split":
        raise RuntimeError(f"led: dec_cross_plan({beams}, {s_len}, int8) is {plan}, not split")
    row(f"dec_cross_attention int8 B={b} beams={beams} S={s_len} [split {plan.groups}]",
        lambda: K.dec_cross_attention(q, ck, cv, ks, vs, bias, heads),
        lambda: K.dec_cross_attention_plain(q, ck, cv, ks, vs, bias, heads),
        b * beams * d * 2 * 2 + 2 * b * d * s_len + b * s_len * 4 + 2 * b * d * 4,
        4.0 * b * beams * d * s_len, None, gap, ok)
    del q, ck, cv, out
    with open(os.path.join(OUT_DIR, "led_kernels.json"), "w") as f:
        json.dump({"gpu": gpu, "rows": rows}, f, indent=1)
    if bad:
        raise RuntimeError(f"led: kernels off their plain twins beyond tolerance(): {bad}")
    torch.cuda.empty_cache()
    run_led_path(gpu)


def run_led_path(gpu: str) -> None:
    """VacnicConfig.led_full() at full width, random bf16 weights from seed
    0, decoding every step: the fused encoder against the layer-by-layer
    one at batch 2 x S 16384; then generate_mm at the cell's batch, 32 x S
    16384 x beam 5, with the launches zeroed just before the run and held,
    just after, to LED's path: in each of the 12 encoder layers one
    enc_window_attention, one query_global product, one key_global |
    value_global cross_kv (bf16, "long") and one dec_cross_attention of
    one query an item, and no enc_self_attention; the decode cache's 12
    cross_kv ("long") with 12 cross_kv_quant; every decode step's
    dec_cross_attention on the split kernel; gemm_bf16's kernels as
    gemm_plan places the products."""
    import torch

    from vacnic_tpu_torch.core.config import VacnicConfig
    from vacnic_tpu_torch.infer.generate import generate_mm
    from vacnic_tpu_torch.kernels import primitives as K

    cfg, params = full_model(cfg=VacnicConfig.led_full())
    check_fused_encoder("led", cfg, params, batch_inputs(cfg, 2))
    torch.cuda.empty_cache()
    x = batch_inputs(cfg, LED_BATCH)

    def run():
        out = generate_mm(params, cfg=cfg.bart, fcfg=cfg.fusion, dcfg=cfg.decode,
                          dtype=torch.bfloat16, device="cuda", **x)
        torch.cuda.synchronize()
        return out

    run()  # warm-up
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seqs, scores = run()
    dt = time.perf_counter() - t0
    nonpad = check_captions("led", cfg, seqs, scores, LED_BATCH)
    b, s_len, d = cfg.bart, cfg.data.article_max_length, cfg.bart.d_model
    enc_l, dec_l, steps = b.encoder_layers, b.decoder_layers, cfg.decode.max_length - 1
    beams, glob = cfg.decode.num_beams, b.global_tokens
    gemm_want = gemm_plan_counts(cfg, LED_BATCH)
    gemm_want[K.gemm_plan(LED_BATCH * glob, d, d).variant] += enc_l  # query_global
    enc_plan, dec_plan = K.dec_cross_plan(glob, s_len, 2), K.dec_cross_plan(beams, s_len, 1)
    want = {
        "launches": {"enc_window_attention": enc_l, "enc_self_attention": 0,
                     "enc_cross_attention": enc_l, "cross_kv": enc_l + dec_l,
                     "cross_kv_quant": dec_l, "dec_cross_attention": enc_l + dec_l * steps,
                     "dec_self_attention": dec_l * steps,
                     "layernorm": 3 * enc_l + 3 * dec_l * steps},
        "gemm_bf16": gemm_want,
        "cross_kv": {"cluster": 0, "long": enc_l + dec_l},
        "dec_cross_beams": {glob: enc_l, beams: dec_l * steps},
        "dec_cross_variants": {v: enc_l * (v == enc_plan.variant)
                               + dec_l * steps * (v == dec_plan.variant)
                               for v in K.DEC_CROSS_VARIANTS},
    }
    counts = K.launch_counts()
    got = {"launches": {k: counts[k] for k in want["launches"]},
           "gemm_bf16": K.gemm_variant_counts(), "cross_kv": K.cross_kv_variant_counts(),
           "dec_cross_beams": K.dec_cross_beam_counts(),
           "dec_cross_variants": K.dec_cross_variant_counts()}
    log(f"led: generate_mm beam {beams} x {cfg.decode.max_length}, batch {LED_BATCH} x S "
        f"{s_len}: {dt:.3f} s, {LED_BATCH / dt:.2f} captions/s, mean non-pad length "
        f"{nonpad:.1f}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {got}; expected {want} ({gpu})")
    if dec_plan.variant != "split" or got != want:
        raise RuntimeError(f"led: launches {got}: expected {want}, every decode step's "
                           f"dec_cross_attention on the split kernel (plan {dec_plan.variant})")
    del params
    torch.cuda.empty_cache()


def compare_tokens(ref: dict, gpu: str) -> None:
    """Every path run here against the captions another tree saved with
    --tokens-out on the same seeds: token agreement printed, and any
    difference fails the run -- but on a path that launched gemm_bf16's
    mid_m (MID_M_PATHS), whose products a tree from before that kernel
    summed in another order, where the agreement is a reading."""
    import torch

    common = sorted(set(ref) & set(TOKENS))
    if not common:
        raise RuntimeError("tokens: no path of this run is in the reference file")
    differ = []
    for path in common:
        a, b = TOKENS[path], ref[path]
        same = a.shape == b.shape and bool(torch.equal(a, b))
        agree = float((a == b).float().mean()) if a.shape == b.shape else 0.0
        moved = path in MID_M_PATHS
        note = " (a reading: its products at 257 to GEMM_MID_M_MAX rows take mid_m)"
        log(f"tokens {path}: token agreement with the reference tree {agree:.4f}, "
            f"{'identical' if same else 'DIFFERENT'}{note if moved else ''} ({gpu})")
        if not same and not moved:
            differ.append(path)
    if differ:
        raise RuntimeError(f"tokens: paths not token-identical to the reference tree: {differ}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,accuracy,dispatch,stacks,slice,selfkv,stats,stackhead,"
                            "layerwise,serve,ladder,profile,mesh,onlyvis,mlp,train,tp,data,cli,"
                            "led")
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
    if "gemmplan" in phases:
        run_gemmplan_phase(gpu)
    if "crossplan" in phases:
        run_crossplan_phase(gpu)
    if "led" in phases:
        run_led_phase(gpu)
        torch.cuda.empty_cache()
    launches = {}  # kernel -> launches in the run of the path that names it
    if phases & {"stacks", "slice", "selfkv", "stats", "stackhead", "layerwise", "serve",
                  "ladder", "profile", "mesh", "meshscale"}:
        cfg, params = full_model()
        if "stacks" in phases:
            launches.update(run_stacks_phase(cfg, params))
        slice_seqs = counts = None
        if "slice" in phases:
            counts, slice_seqs = run_model_path("slice", cfg, params,
                                                batch_inputs(cfg, args.batch), gpu)
            launches.update({k: counts[k] for k in SLICE_COUNTED})
        if phases & {"selfkv", "stats", "stackhead", "mesh"} and slice_seqs is None:
            counts, slice_seqs = run_model_path("slice", cfg, params,
                                                batch_inputs(cfg, args.batch), gpu)
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
            launches.update(run_serve_phase(cfg, params, args.batch, gpu, counts))
        if "ladder" in phases:
            launches.update(run_ladder_phase(cfg, params, gpu))
            torch.cuda.empty_cache()
        if "profile" in phases:
            run_profile_phase(cfg, params, args.batch)
        if "mesh" in phases:
            mesh_counts = run_mesh_phase(cfg, params, args.batch, counts, gpu)
            for k in SLICE_COUNTED:
                launches.setdefault(k, mesh_counts[k])
        if "meshscale" in phases:
            run_meshscale_phase(cfg, params, gpu)
        del params  # the train phase builds its own f32 trees
    for phase, run_phase in (("onlyvis", run_onlyvis_phase), ("mlp", run_mlp_phase)):
        if phase in phases:
            torch.cuda.empty_cache()
            counts = run_phase(args.batch, gpu)
            launches[f"enc_cross_attention:kv{ENC_CROSS_KV[phase]}"] = counts[
                "enc_cross_attention"]
            for k in SLICE_COUNTED:  # the KV 40 rows' launches are the slice's alone
                if k != "enc_cross_attention":
                    launches.setdefault(k, counts[k])
    if "train" in phases:
        torch.cuda.empty_cache()
        launches.setdefault("flash_attention", run_train_phase(gpu)["flash_attention"])
    if "tp" in phases:
        torch.cuda.empty_cache()
        launches["flash_attention:tp"] = run_tp_phase(gpu)
    if "bf16gaps" in phases:
        torch.cuda.empty_cache()
        run_bf16gaps_phase(gpu)
    if "data" in phases:
        torch.cuda.empty_cache()
        counts = run_data_phase(gpu)
        for k in SLICE_COUNTED:
            launches.setdefault(k, counts[k])
    if "cli" in phases:
        torch.cuda.empty_cache()
        counts = run_cli_phase(gpu)
        for k in SLICE_COUNTED + ("flash_attention",):
            launches.setdefault(k, counts[k])
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
