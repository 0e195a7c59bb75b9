"""The LM head with shortlist statistics (port of vacnic_tpu/kernels/lm_stats.py).

Stage 1, `lm_stats`: one pass computes the f32 logits y = x @ w_lmᵀ + b_lm
of the vocab-padded head (infer/decode_fast.build_lm_head) and, for every
VBLOCK-wide vocab block, the block max m and the exp-sum s = Σ exp(y − m).
On a CUDA tensor it launches lm_stats_kernel of kernels/csrc/lm_head.cu, the
LM head's kernel with a statistics epilogue (64-row unit partials in
scratch, combined in unit order by the thread block whose arrival on a
1024-block's counter completes its 16 units); on a CPU tensor it takes
`lm_stats_plain`, its f32 twin.

Stage 2, `lm_stats_topk` (plain PyTorch, as the JAX package leaves it to
XLA): the logsumexp from the (m, s) partials, and the exact per-row top-C
by block pigeonhole -- every block holding a top-C value ranks in the top C
by its max -- through `gather_rerank`. Ties break toward the lower index,
as `jax.lax.top_k` does: `top_k` sorts stably, and `gather_rerank` sorts the
chosen block ids ascending before the gather, so position order in the
gathered array is global index order.

The JAX wrapper pads the rows to a multiple of 8 for Mosaic; that is a TPU
constraint and is not carried over.
"""

from __future__ import annotations

import torch

from vacnic_tpu_torch.kernels import primitives as K

VBLOCK = 1024  # vocab block of the statistics; also the top-C block granularity
UNIT = 64  # vocab rows of one of the kernel's warpgroups: its unit partials
MAX_VBLOCKS = 4096  # vocab blocks (Vp <= 4 M) the arrival counters cover

# per CUDA device: one arrival counter per vocab block, made zero once and
# never freed; the kernel leaves every counter it touched at zero. Launches
# that share a device must follow one another (one stream): two launches
# running at once would count each other's arrivals.
_COUNTERS: dict[int, torch.Tensor] = {}


def counters(device: torch.device) -> torch.Tensor:
    """The device's arrival counters (int32 [MAX_VBLOCKS]), made on first use."""
    have = _COUNTERS.get(device.index)
    if have is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("lm_stats: call it once outside a CUDA graph capture first, so "
                               "that its counters are made and zeroed")
        have = _COUNTERS[device.index] = torch.zeros(MAX_VBLOCKS, dtype=torch.int32,
                                                     device=device)
    return have


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis, ties broken toward the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def lm_stats_plain(x: torch.Tensor, w_lm: torch.Tensor, b_lm: torch.Tensor):
    """The f32 twin of `lm_stats`, on any device."""
    y = torch.matmul(x.float(), w_lm.float().t()) + b_lm.float()
    r3 = y.reshape(y.shape[0], -1, VBLOCK)
    m = r3.amax(dim=-1)
    s = torch.exp(r3 - m[..., None]).sum(dim=-1)
    return y, m, s


def lm_stats(x: torch.Tensor, w_lm: torch.Tensor, b_lm: torch.Tensor):
    """x [BK, d], w_lm [Vp, d], b_lm [Vp] f32 -> (logits [BK, Vp] f32,
    m [BK, Vp/VBLOCK] f32, s [BK, Vp/VBLOCK] f32). The kernel takes bf16 x
    and w_lm, BK >= 1, d % 32 == 0, Vp % VBLOCK == 0 and tensors that start
    on 16 bytes (TMA reads x and w_lm)."""
    K.no_grad_guard("lm_stats", x, w_lm, b_lm)
    if K._on_cpu(x):
        return lm_stats_plain(x, w_lm, b_lm)
    bk, d = x.shape
    vp = w_lm.shape[0]
    K._req(x, "lm_stats x", torch.bfloat16)
    K._req(w_lm, "lm_stats w_lm", torch.bfloat16, (vp, d), x.device)
    K._req(b_lm, "lm_stats b_lm", torch.float32, (vp,), x.device)
    if bk < 1 or d < 32 or d % 32 or vp < VBLOCK or vp % VBLOCK:
        raise ValueError(f"lm_stats: needs BK >= 1, d % 32 == 0 and Vp % {VBLOCK} == 0 "
                         f"(BK={bk}, d={d}, Vp={vp})")
    if any(t.data_ptr() % 16 for t in (x, w_lm, b_lm)):
        raise ValueError("lm_stats: x, w_lm and b_lm must start on 16 bytes")
    nv = vp // VBLOCK
    if nv > MAX_VBLOCKS:
        raise ValueError(f"lm_stats: Vp <= {MAX_VBLOCKS * VBLOCK} (Vp={vp})")
    # one allocation for the outputs and the 64-row unit partials [BK, Vp/64]
    # (scratch, written before they are read); every part but m and s starts
    # on 64 bytes
    logits, unit_m, unit_s, m, s = torch.empty(
        bk * (vp + 2 * vp // UNIT + 2 * nv), dtype=torch.float32, device=x.device).split(
        [bk * vp, bk * vp // UNIT, bk * vp // UNIT, bk * nv, bk * nv])
    logits, m, s = logits.view(bk, vp), m.view(bk, nv), s.view(bk, nv)
    K._launch("lm_stats", "vt_lm_stats", x.device, K._p(x), K._p(w_lm), K._p(b_lm), K._p(logits),
              K._p(m), K._p(s), K._p(unit_m), K._p(unit_s), K._p(counters(x.device)), bk, vp, d)
    return logits, m, s


def gather_rerank(r3: torch.Tensor, bid: torch.Tensor, C: int):
    """Gather the blocks bid [rows, C] of r3 [rows, nb, blk] (ids sorted
    ascending first) and re-rank them to the exact tie-faithful top-C
    -> (values [rows, C], global indices [rows, C])."""
    rows, _, blk = r3.shape
    bid = torch.sort(bid, dim=-1).values
    g = torch.gather(r3, 1, bid[:, :, None].expand(rows, C, blk))
    cv, loc = top_k(g.reshape(rows, C * blk), C)
    gidx = (bid[:, :, None] * blk + torch.arange(blk, device=bid.device)[None, None, :]
            ).reshape(rows, C * blk)
    return cv, torch.gather(gidx, 1, loc)


def lm_stats_topk(logits: torch.Tensor, m: torch.Tensor, s: torch.Tensor, C: int,
                  vocab_size: int):
    """(cand_vals [BK, C], cand_idx [BK, C], lse [BK]) from lm_stats' output.
    Needs C <= the number of vocab blocks. Indices >= vocab_size (the pad
    columns) are masked to -inf, so they are never selected downstream."""
    bk, nvb = m.shape
    if C > nvb:
        raise ValueError(f"lm_stats_topk: C={C} exceeds the {nvb} vocab blocks")
    big = m.amax(dim=-1)
    lse = torch.log((s * torch.exp(m - big[:, None])).sum(dim=-1)) + big
    _, bid = top_k(m, C)
    cv, ci = gather_rerank(logits.reshape(bk, nvb, VBLOCK), bid, C)
    cv = torch.where(ci < vocab_size, cv, float("-inf"))
    return cv, ci, lse
