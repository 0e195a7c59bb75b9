"""Generation entry points (port of vacnic_tpu/infer/generate.py):
`generate_mm` (multimodal captioning), `generate_text_bart` and
`greedy_search` (text-only BART), `get_prob` (teacher-forced sequence
log-probability).

The encoder runs once -- for generate_mm the fused text stack
(kernels/encoder_stack) on the eligible released configs, the
layer-by-layer encoder otherwise, whose 512-token self-attention goes
through kernels/flash_attn -- then beam search steps the decoder with the
kernel step (infer/decode_fast.decode_step_kernel): the write-once
time-major self cache with its ancestry matrix, and int8 cross K/V. On the
card both stacks run the CUDA kernels, with bf16 stacked weights and self
cache, and the cross K/V are int8 at every batch and beam count; for CPU
tensors the stacks take their plain twins in the caller's dtype and the
cross K/V stay unquantized (`cache_plan`).

`self_kv="int8"` or `"fp8"` stores the self cache quantized, on the card
and on the CPU alike: int8 with per-(layer, t, row, head) scales, or fp8
e4m3 (infer/decode_fast.build_decode_cache).

`lm_stats=True` replaces the LM head and the beam shortlist's full-width
passes with the fused LM-stats head (kernels/lm_stats; bf16 on the card,
like the stacks). It needs the shortlist candidate mode and a shortlist no
wider than the vocab blocks; where that gate fails the call raises (the
JAX package warns and runs the plain head instead).

`lm_head` places the LM head: "library" (the default) runs it after the
decode stack as a library product; "stack" inside the stack, over the
vocab-padded head built once a call (kernels/lm_head; the JAX package's
VACNIC_PLAN_NLM > 0). It excludes `lm_stats=True`: together they raise
(the JAX package warns and runs without the stats head).

`generate_mm_sharded` is the data-parallel decode over a `core/mesh.Mesh`:
one parameter replica and one host thread a device of the data axis, each
running the whole of `generate_mm` on its contiguous row shard.

Entry points run on "cuda" unless the caller passes device="cpu"; without
a card and without that argument they raise.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import torch

from vacnic_tpu_torch.core.config import BartConfig, DecodeConfig, FusionConfig
from vacnic_tpu_torch.core.device import as_tensor, resolve_device
from vacnic_tpu_torch.core.mesh import Mesh, Sharded
from vacnic_tpu_torch.core.tree import leaves_with_path
from vacnic_tpu_torch.infer import decode_fast as DF
from vacnic_tpu_torch.infer.beam_search import beam_search, resolve_cand_mode, shortlist_c_width
from vacnic_tpu_torch.kernels.lm_stats import VBLOCK
from vacnic_tpu_torch.models import bart as B
from vacnic_tpu_torch.models import fusion as F
from vacnic_tpu_torch.models.layers import expand_mask
from vacnic_tpu_torch.models.weights_io import tree_to

CACHE_PAD = 16  # self-cache T rounds up to a multiple of this (50 -> 64)
SELF_KV_KINDS = (None, "int8", "fp8")


class CachePlan(NamedTuple):
    """The decode cache's types: the stacks' dtype, int8 cross K/V or not,
    the self cache's kind (None: the stacks' dtype, "int8" or "fp8")."""
    dtype: torch.dtype
    cross_kv_int8: bool
    self_kv: str | None


def cache_plan(on_card: bool, self_kv: str | None, dtype) -> CachePlan:
    """On the card: bf16 stacks and int8 cross K/V, whatever the batch and
    beam count. (The JAX package quantizes the cross K/V only on its Pallas
    path, which a Mosaic chunking rule keeps from batch 1 x beam 5; CUDA has
    no such rule.) On the CPU: the caller's dtype, unquantized cross K/V.
    The self cache is the caller's choice on both."""
    if self_kv not in SELF_KV_KINDS:
        raise ValueError(f"self_kv must be one of {SELF_KV_KINDS}, got {self_kv!r}")
    return CachePlan(torch.bfloat16 if on_card else dtype, on_card, self_kv)


def _mm_encode(params, input_ids, attention_mask, image_features, cfg, fcfg, *,
               face_features, face_mask, name_ids, name_mask, add_ner_ffn, dtype):
    fwd = (F.mm_encoder_fwd_fused if F.fused_encoder_eligible(fcfg, cfg, add_ner_ffn)
           else F.mm_encoder_fwd)
    return fwd(params, input_ids, attention_mask, image_features, cfg, fcfg,
               face_features=face_features, face_mask=face_mask, name_ids=name_ids,
               name_mask=name_mask, add_ner_ffn=add_ner_ffn, dtype=dtype)


def _search_plan(params, dcfg: DecodeConfig, cand_mode, lm_stats: bool, lm_head: str):
    """(candidate mode, stats-head shortlist width or None). Raises on an
    unknown lm_head, on lm_stats=True with lm_head="stack", and when
    lm_stats=True fails the gate of vacnic_tpu/infer/generate.py:165-192."""
    if lm_head not in DF.LM_HEADS:
        raise ValueError(f"lm_head must be one of {DF.LM_HEADS}, got {lm_head!r}")
    if lm_stats and lm_head == "stack":
        raise ValueError('lm_stats=True and lm_head="stack" exclude each other: the stats '
                         "head replaces the LM head")
    vocab = params["shared"]["weight"].shape[0]
    mode = cand_mode or resolve_cand_mode(dcfg, vocab)
    if not lm_stats:
        return mode, None
    c = shortlist_c_width(dcfg.num_beams)
    n_blocks = -(-vocab // DF.LM_PAD) * DF.LM_PAD // VBLOCK
    if mode != "shortlist" or c > n_blocks:
        raise ValueError(f"lm_stats=True needs the shortlist candidate mode and a shortlist "
                         f"no wider than the vocab blocks (mode {mode!r}, C={c}, "
                         f"{n_blocks} blocks)")
    return mode, c


def _decode_from_encoder(params, enc_hidden, attention_mask, cfg: BartConfig,
                         dcfg: DecodeConfig, dtype, mode: str, shortlist_c: int | None,
                         plan: CachePlan, lm_head: str):
    kdtype = plan.dtype
    bsz = enc_hidden.shape[0]
    dp = DF.build_decode_params(params, kdtype)
    cache = DF.build_decode_cache(params, enc_hidden, dcfg.num_beams, dcfg.max_length, cfg,
                                  kdtype, pad_to=CACHE_PAD, time_major=True,
                                  cross_kv_int8=plan.cross_kv_int8,
                                  self_kv_int8=plan.self_kv == "int8",
                                  self_kv_fp8=plan.self_kv == "fp8")
    enc_bias = expand_mask(attention_mask, 1)  # [B, 1, 1, S]
    if shortlist_c is not None or lm_head == "stack":
        dp = DF.ensure_lm_head(dp, params, kdtype)

    def step_fn(tok, cache, pos):
        return DF.decode_step_kernel(dp, params, cache, tok, pos, enc_bias, cfg, dtype,
                                     lm_head=lm_head)

    step_stats_fn = None
    if shortlist_c is not None:

        def step_stats_fn(tok, cache, pos):
            return DF.decode_step_kernel_stats(dp, params, cache, tok, pos, enc_bias, cfg,
                                               dtype, shortlist_c=shortlist_c)

    return beam_search(
        step_fn, cache, bsz, cfg=dcfg, eos_token_id=cfg.eos_token_id,
        pad_token_id=cfg.pad_token_id, decoder_start_token_id=cfg.decoder_start_token_id,
        forced_bos_token_id=cfg.forced_bos_token_id,
        vocab_size=params["shared"]["weight"].shape[0],
        reorder_cache_fn=DF.reorder_anc, device=enc_hidden.device, cand_mode=mode,
        step_stats_fn=step_stats_fn)


@torch.no_grad()
def generate_mm(params, input_ids, attention_mask, image_features, cfg: BartConfig,
                fcfg: FusionConfig, dcfg: DecodeConfig, *, face_features=None,
                face_mask=None, name_ids=None, name_mask=None, add_ner_ffn: bool = True,
                dtype=torch.float32, device=None, cand_mode: str | None = None,
                lm_stats: bool = False, self_kv: str | None = None, lm_head: str = "library"):
    """Multimodal beam-search captioning -> (sequences [B, max_length] int64,
    scores [B] f32). `params` (the tree of models/fusion) and the inputs
    (tensors or numpy arrays) are moved to `device` ("cuda" by default).
    `cand_mode` picks the beam candidate selection ("full" | "opt" |
    "shortlist"; None = auto), `lm_stats` the fused LM-stats head, `self_kv`
    the self cache (None: the stacks' dtype, "int8" or "fp8"), `lm_head`
    where the LM head runs ("library" after the stack, "stack" inside it)."""
    dev = resolve_device(device)
    plan = cache_plan(dev.type == "cuda", self_kv, dtype)
    mode, shortlist_c = _search_plan(params, dcfg, cand_mode, lm_stats, lm_head)
    params = tree_to(params, dev)
    input_ids, attention_mask, image_features, face_features, face_mask, name_ids, name_mask = (
        as_tensor(x, dev) for x in (input_ids, attention_mask, image_features, face_features,
                                    face_mask, name_ids, name_mask))
    enc = _mm_encode(params, input_ids, attention_mask, image_features, cfg, fcfg,
                     face_features=face_features, face_mask=face_mask, name_ids=name_ids,
                     name_mask=name_mask, add_ner_ffn=add_ner_ffn, dtype=dtype)
    return _decode_from_encoder(params, enc["last_hidden"], attention_mask, cfg, dcfg, dtype,
                                mode, shortlist_c, plan, lm_head)


# (mesh, data axis, id of the tree) -> (the tree, its leaves, their version
# counters, one replica a data-axis device). The entry holds the tree, so
# its id cannot be reused while the entry lives; the leaves' identities and
# version counters tell a tree changed in place (an optimizer step) from
# the one that was copied.
_REPLICAS: collections.OrderedDict = collections.OrderedDict()
_REPLICAS_MAX = 4
_REPLICAS_LOCK = threading.Lock()


def _stamp(leaves) -> tuple:
    return tuple(t._version if isinstance(t, torch.Tensor) and not t.is_inference() else None
                 for t in leaves)


def replicate(params, mesh: Mesh, data_axis: str = "data") -> list:
    """One copy of `params` on each device of the mesh's data axis (a leaf
    already on a device is that device's copy, not copied again), made once
    and kept in a small LRU keyed by the mesh and the tree's identity: a
    tree whose leaves were replaced or changed in place since is copied
    anew. `drop_replicas` forgets a tree's copies."""
    devices = mesh.data_devices(data_axis)
    key = (mesh, data_axis, id(params))
    leaves = [leaf for _, leaf in leaves_with_path(params)]
    stamp = _stamp(leaves)
    with _REPLICAS_LOCK:
        hit = _REPLICAS.get(key)
        if (hit is not None and len(hit[1]) == len(leaves)
                and all(a is b for a, b in zip(hit[1], leaves)) and hit[2] == stamp):
            _REPLICAS.move_to_end(key)
            return hit[3]
    replicas = [tree_to(params, d) for d in devices]
    with _REPLICAS_LOCK:
        _REPLICAS[key] = (params, leaves, stamp, replicas)
        _REPLICAS.move_to_end(key)
        while len(_REPLICAS) > _REPLICAS_MAX:
            _REPLICAS.popitem(last=False)
    return replicas


def drop_replicas(params) -> None:
    """Forget every mesh's copies of `params` (a service swapping weights
    frees the old ones)."""
    with _REPLICAS_LOCK:
        for key in [k for k, v in _REPLICAS.items() if v[0] is params]:
            del _REPLICAS[key]


def _row_shards(x, devices: list[torch.device]) -> list:
    """x cut into len(devices) contiguous row shards, shard i on devices[i];
    a `Sharded` batch keeps the shards it has (copied only if one lies
    elsewhere); None stays None."""
    n = len(devices)
    if x is None:
        return [None] * n
    if isinstance(x, Sharded):
        if len(x.shards) != n:
            raise ValueError(f"a batch in {len(x.shards)} shards on a data axis of {n} devices")
        return [s.to(d) for s, d in zip(x.shards, devices)]
    x = torch.as_tensor(x)
    return [c.to(d) for c, d in zip(torch.chunk(x, n), devices)]


def generate_mm_sharded(mesh: Mesh, params, input_ids, attention_mask, image_features,
                        cfg: BartConfig, fcfg: FusionConfig, dcfg: DecodeConfig, *,
                        face_features=None, face_mask=None, name_ids=None, name_mask=None,
                        add_ner_ffn: bool = True, dtype=torch.float32, data_axis: str = "data"):
    """Data-parallel beam decode over the mesh's data axis (the counterpart
    of JAX's shard_map: parameters replicated, the batch scattered, each
    device running the whole search on its shard, no traffic between them
    after the scatter) -> (sequences, scores) of the global batch in row
    order, on the data axis's first device.

    The batch must divide by the data axis's size (ValueError otherwise).
    Contiguous row shards go to the axis's devices, to the first device of
    each data row when the mesh has a model axis wider than 1. The inputs
    are tensors, numpy arrays or `core/mesh.Sharded` batches (a
    `data/pipeline.PrefetchLoader(sharding=)` batch), whose shards are
    taken where they lie. The parameter replicas come from `replicate`.
    One host thread a device makes its device current and runs
    `generate_mm` on its shard under torch.inference_mode(); a worker's
    exception is raised here."""
    devices = mesh.data_devices(data_axis)
    rows = (input_ids.shape if isinstance(input_ids, Sharded)
            else torch.as_tensor(input_ids).shape)[0]
    if rows % len(devices):
        raise ValueError(f"generate_mm_sharded: batch of {rows} rows does not divide over the "
                         f"{len(devices)}-device {data_axis!r} axis")
    replicas = replicate(params, mesh, data_axis)
    args = [_row_shards(x, devices) for x in (input_ids, attention_mask, image_features,
                                              face_features, face_mask, name_ids, name_mask)]

    def work(i: int):
        dev = devices[i]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        ids, mask, img, face, fmask, names, nmask = (a[i] for a in args)
        with torch.inference_mode():
            return generate_mm(replicas[i], ids, mask, img, cfg, fcfg, dcfg, face_features=face,
                               face_mask=fmask, name_ids=names, name_mask=nmask,
                               add_ner_ffn=add_ner_ffn, dtype=dtype, device=dev)

    with ThreadPoolExecutor(len(devices), thread_name_prefix="generate_mm_sharded") as pool:
        futures = [pool.submit(work, i) for i in range(len(devices))]
        outs = [f.result() for f in futures]
    first = devices[0]
    return (torch.cat([s.to(first) for s, _ in outs]),
            torch.cat([s.to(first) for _, s in outs]))


@torch.no_grad()
def generate_text_bart(params, input_ids, attention_mask, cfg: BartConfig, dcfg: DecodeConfig,
                       dtype=torch.float32, *, device=None, self_kv: str | None = None,
                       lm_head: str = "library"):
    """Text-only BART beam generation over a `models/bart.bart_init` tree
    -> (sequences [B, max_length] int64, scores [B] f32); `self_kv` and
    `lm_head` as in generate_mm."""
    dev = resolve_device(device)
    plan = cache_plan(dev.type == "cuda", self_kv, dtype)
    mode, _ = _search_plan(params, dcfg, None, False, lm_head)
    params = tree_to(params, dev)
    input_ids, attention_mask = as_tensor(input_ids, dev), as_tensor(attention_mask, dev)
    enc = B.encoder_fwd(params, input_ids, attention_mask, cfg, dtype=dtype)
    return _decode_from_encoder(params, enc, attention_mask, cfg, dcfg, dtype, mode, None, plan,
                                lm_head)


def greedy_search(params, input_ids, attention_mask, cfg: BartConfig, dcfg: DecodeConfig,
                  dtype=torch.float32, *, device=None):
    """Greedy decoding: beam search with one beam is argmax decoding."""
    return generate_text_bart(
        params, input_ids, attention_mask, cfg,
        dataclasses.replace(dcfg, num_beams=1, length_penalty=1.0), dtype, device=device)


@torch.no_grad()
def get_prob(params, input_ids, attention_mask, decoder_input_ids, labels, cfg: BartConfig,
             dtype=torch.float32, *, device=None) -> torch.Tensor:
    """Per-sequence log-probability of `labels` [B, T] (token ids) under
    teacher forcing: the sum of token log-probabilities, pad positions
    masked -> [B] f32."""
    dev = resolve_device(device)
    params = tree_to(params, dev)
    input_ids, attention_mask, decoder_input_ids, labels = (
        as_tensor(x, dev) for x in (input_ids, attention_mask, decoder_input_ids, labels))
    out = B.bart_forward(params, input_ids, attention_mask, decoder_input_ids, cfg, dtype=dtype)
    logp = torch.log_softmax(out["logits"].float(), dim=-1)
    tok_lp = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    valid = (labels != cfg.pad_token_id).float()
    return (tok_lp * valid).sum(dim=-1)
