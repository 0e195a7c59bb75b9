"""Beam search with transformers-4.18 `generate` semantics (port of
vacnic_tpu/infer/beam_search.py, `hf_compat` "4.18" and "modern").

Semantics, as in the JAX package:
  * decoding starts from `decoder_start_token_id`; forced bos at cur_len 1,
    forced eos at max_length - 1; eos banned while cur_len < min_length;
    no-repeat-ngram bans;
  * per step: log_softmax -> processors -> + beam score -> top-2K over K*V;
    eos candidates ranked within the top K become hypotheses scored
    sum_logprobs / cur_len**lp; the other candidates fill the next K beams;
  * early_stopping=True: an item is done once K hypotheses exist;
  * finalize (4.18): at max_length the K running beams join the pool with
    denominator max_length**lp.

Candidate selection (`cand_mode`):
  * "full": whole-vocab processors and one top-2K (the reference);
  * "opt": one wide top-W (W = OPT_WINDOW) over the unbanned totals, bans
    checked on the W winners only, an exactness certificate, and a fallback
    to "full" when it fails;
  * "shortlist": per-row top-C of the raw logits, processors on [B, K, C],
    a certificate, and a fallback to "full" when it fails. Its row top-C
    comes from `step_stats_fn` (the fused LM-stats head) when one is given,
    else from the block-max two-stage top-C for wide vocabularies; with
    `block_lse=True` one block pass over the logits feeds both that top-C
    and the logsumexp.
`resolve_cand_mode` picks shortlist for big vocabularies. The search steps
from Python; the state stays on the device. A mode or option that cannot
apply raises instead of running another path.

Top-k order: every top-k here returns the larger value first and, among
equal values, the lower index first (the lax.top_k rule the tie tests pin),
through a stable descending sort.

Spans (`core/profiling.annotate`, for a profiler's trace): each step's
"beam_search.model" (`step_fn` / `step_stats_fn`: the decoder and the LM
head) and "beam_search.select" (from the logits to the next BeamState),
"beam_search.sync" around every wait of the host on the stream (the
reads of device values in `_host_bool`, the n-gram bans' `nonzero`,
`pow_f32`'s host scalars), and
"beam_search.fallback" around a step whose certificate failed.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from vacnic_tpu_torch.core.config import DecodeConfig
from vacnic_tpu_torch.core.profiling import annotate
from vacnic_tpu_torch.kernels.lm_stats import gather_rerank, top_k

NEG_INF = -1.0e7  # large but finite, as in the JAX package
OPT_WINDOW = 32  # the "opt" mode's top-k window; it tolerates OPT_WINDOW - 2K bans
MODES = ("full", "opt", "shortlist")


class BeamState(NamedTuple):
    cur_len: int
    running_seqs: torch.Tensor     # [B, K, L]
    running_scores: torch.Tensor   # [B, K]
    finished_seqs: torch.Tensor    # [B, K, L]
    finished_scores: torch.Tensor  # [B, K]
    finished_flags: torch.Tensor   # [B, K] bool
    done: torch.Tensor             # [B] bool
    cache: Any


def _host_bool(x: torch.Tensor) -> bool:
    """`bool(x)` of a one-element tensor: the search's host reads of device
    values go through here, under the span "beam_search.sync" (the host
    waiting on the device)."""
    with annotate("beam_search.sync"):
        return bool(x)


def gather_beams(x: torch.Tensor, beam_indices: torch.Tensor) -> torch.Tensor:
    """x [B, K_in, ...], beam_indices [B, K_out] -> [B, K_out, ...]."""
    b = x.shape[0]
    return x[torch.arange(b, device=x.device)[:, None], beam_indices]


def _ngram_matches(seqs: torch.Tensor, cur: int, n: int):
    """(match [B,K,P] bool, banned_tok [B,K,P]): start position p matches iff
    seqs[p:p+n-1] equals the current (n-1)-token suffix and the n-gram lies
    within the generated tokens; the banned token is seqs[p+n-1]."""
    b, k, L = seqs.shape
    dev = seqs.device
    idx = cur - (n - 1) + torch.arange(n - 1, device=dev)
    prefix = seqs[:, :, idx]  # negative ids wrap; masked below by cur >= n
    pos = torch.arange(L - n + 1, device=dev)
    win_idx = pos[:, None] + torch.arange(n - 1, device=dev)[None, :]
    windows = seqs[:, :, win_idx]  # [B, K, P, n-1]
    banned_tok = seqs[:, :, pos + (n - 1)]
    match = (windows == prefix[:, :, None, :]).all(dim=-1)
    valid = (pos + (n - 1)) <= (cur - 1)
    match = match & valid[None, None, :] & (cur >= n)
    return match, banned_tok


def _apply_no_repeat_ngram(seqs, cur: int, total, n: int, ban_value):
    match, banned_tok = _ngram_matches(seqs, cur, n)
    ban = torch.zeros(total.shape, dtype=torch.bool, device=total.device)
    with annotate("beam_search.sync"):  # the matches' count, read by the host
        bi, ki, pi = match.nonzero(as_tuple=True)
    ban.index_put_((bi, ki, banned_tok[bi, ki, pi].long()),
                   torch.ones((), dtype=torch.bool, device=total.device))
    return torch.where(ban, ban_value, total)


def shortlist_width(cfg: DecodeConfig) -> int:
    """Bans per row are bounded by the ngram start positions plus the
    min_length eos ban; the row shortlist needs 2K plus that margin."""
    c = 2 * cfg.num_beams
    if cfg.no_repeat_ngram_size > 0:
        c += cfg.max_length - cfg.no_repeat_ngram_size + 1
    if cfg.min_length > 0:
        c += 1
    return c


def shortlist_c_width(k: int) -> int:
    """Per-row shortlist width C: 2K winners + certificate tolerance, floor 16."""
    return max(2 * k + 6, 16)


def resolve_cand_mode(cfg: DecodeConfig, vocab_size: int) -> str:
    """Auto rule: shortlist when the vocab dwarfs the shortlist margin (the
    50k vocab), full for tiny vocabs."""
    big_vocab = vocab_size >= 8 * (shortlist_width(cfg) + 2)
    return "shortlist" if big_vocab else "full"


def _block_view(logits: torch.Tensor, blk: int = 128):
    """[rows, n] -> ([rows, nb, blk] padded with -inf, block maxima [rows, nb])."""
    rows, n = logits.shape
    nb = -(-n // blk)
    if nb * blk != n:
        logits = torch.nn.functional.pad(logits, (0, nb * blk - n), value=float("-inf"))
    r3 = logits.reshape(rows, nb, blk)
    return r3, r3.amax(dim=-1)


def blocked_logsumexp(r3: torch.Tensor, bm: torch.Tensor) -> torch.Tensor:
    """logsumexp from the block view (JAX `block_lse`): per-block exp-sums
    against the block max, combined against the row max. A pad block is all
    -inf; its max is clamped so that it contributes 0 rather than NaN."""
    bm_safe = torch.clamp(bm, min=torch.finfo(torch.float32).min)
    bs = torch.exp(r3 - bm_safe[..., None]).sum(dim=-1)
    m = bm.amax(dim=-1)
    return torch.log((bs * torch.exp(bm_safe - m[:, None])).sum(dim=-1)) + m


def row_topk_blockmax(logits: torch.Tensor, C: int, blk: int = 128, blocks=None):
    """Exact per-row top-C: the top-C blocks by block max hold every top-C
    value (pigeonhole); gather and re-rank them. `blocks` passes a
    precomputed `_block_view` (the block-lse path)."""
    r3, bm = _block_view(logits, blk) if blocks is None else blocks
    _, bid = top_k(bm, C)
    return gather_rerank(r3, bid, C)


def _banned_token_list(s: BeamState, cur: int, *, cfg: DecodeConfig, eos_token_id: int):
    """[B, K, P(+1)] token ids banned at this step (-1 in inactive slots)."""
    cols = []
    if cfg.no_repeat_ngram_size > 0:
        match, banned_tok = _ngram_matches(s.running_seqs, cur, cfg.no_repeat_ngram_size)
        cols.append(torch.where(match, banned_tok, torch.full_like(banned_tok, -1)))
    if cfg.min_length > 0:
        b, k, _ = s.running_seqs.shape
        eos = eos_token_id if cur < cfg.min_length else -1
        cols.append(torch.full((b, k, 1), eos, dtype=s.running_seqs.dtype,
                               device=s.running_seqs.device))
    return torch.cat(cols, dim=2) if cols else None


def _forced_step_candidates(s: BeamState, *, b, k, is_fe, eos_token_id,
                            forced_bos_token_id, vocab_size):
    """Analytic candidates of a forced-token step: the full path maps every
    other token to score + NEG_INF, so its top-2K is the K forced candidates
    then the lowest-index non-forced tokens ("junk") in (beam, token) order."""
    dev = s.running_scores.device
    ftok = eos_token_id if is_fe else (forced_bos_token_id if forced_bos_token_id is not None
                                       else eos_token_id)
    banned_total = s.running_scores[:, :, None] + NEG_INF
    jtok = torch.arange(2 * k, device=dev)
    jtok = torch.clamp(jtok + (jtok >= ftok).long(), max=vocab_size - 1)
    jtok = jtok.expand(b, k, 2 * k)
    total = torch.cat([banned_total.expand(b, k, 2 * k), s.running_scores[:, :, None]], dim=2)
    toks = torch.cat([jtok, torch.full((b, k, 1), ftok, dtype=jtok.dtype, device=dev)], dim=2)
    w = 2 * k + 1
    scores, ti = top_k(total.reshape(b, k * w), 2 * k)
    return scores, ti // w, torch.gather(toks.reshape(b, k * w), 1, ti)


def candidates_full(logits, lse, s: BeamState, cur: int, *, cfg: DecodeConfig, b, k,
                    vocab_size, eos_token_id, forced_bos_token_id):
    """Reference selection: total [B, K, V], processors over the whole
    vocab, one top-2K over K*V."""
    L = cfg.max_length
    dev = logits.device
    total = logits.reshape(b, k, -1) + (s.running_scores - lse.reshape(b, k))[:, :, None]
    banned_total = s.running_scores[:, :, None] + NEG_INF
    vocab = torch.arange(vocab_size, device=dev)[None, None, :]
    if cfg.min_length > 0 and cur < cfg.min_length:
        total = torch.where(vocab == eos_token_id, banned_total, total)
    if cfg.no_repeat_ngram_size > 0:
        total = _apply_no_repeat_ngram(s.running_seqs, cur, total, cfg.no_repeat_ngram_size,
                                       banned_total.expand_as(total))
    if forced_bos_token_id is not None and cur == 1:
        total = torch.where(vocab == forced_bos_token_id, s.running_scores[:, :, None],
                            banned_total)
    if cfg.forced_eos and cur == L - 1:
        total = torch.where(vocab == eos_token_id, s.running_scores[:, :, None], banned_total)
    scores, idx = top_k(total.reshape(b, k * vocab_size), 2 * k)
    return scores, idx // vocab_size, idx % vocab_size


def _candidates_shortlist(logits, lse, s: BeamState, cur: int, *, cfg: DecodeConfig, b, k,
                          vocab_size, eos_token_id, forced_bos_token_id, full_fn, pre=None,
                          blocks=None):
    """Per-row shortlist on raw logits (within a row, total = logit + const,
    so raw order is total order) with a ban certificate; falls back to the
    full path when more than C - 2K shortlist slots of a row are banned.
    `pre` = (cand_vals, cand_idx) [BK, C] from the stats head; `blocks` = the
    block view the block-lse path already built."""
    is_fb = forced_bos_token_id is not None and cur == 1
    is_fe = cfg.forced_eos and cur == cfg.max_length - 1
    if is_fb or is_fe:
        return _forced_step_candidates(s, b=b, k=k, is_fe=is_fe, eos_token_id=eos_token_id,
                                       forced_bos_token_id=forced_bos_token_id,
                                       vocab_size=vocab_size)
    banned = _banned_token_list(s, cur, cfg=cfg, eos_token_id=eos_token_id)
    if pre is not None:
        cv, ci = pre
        C = cv.shape[-1]
        if C <= 2 * k:
            raise ValueError(f"shortlist width {C} leaves no certificate tolerance at K={k}")
    else:
        C = min(shortlist_c_width(k), vocab_size)
        if blocks is not None:
            cv, ci = row_topk_blockmax(logits, C, blocks=blocks)
        elif vocab_size >= 2 * C * 128:  # needs >= C blocks for exactness
            cv, ci = row_topk_blockmax(logits, C)
        else:
            cv, ci = top_k(logits, C)
    shift = s.running_scores.reshape(-1) - lse
    total = (cv + shift[:, None]).reshape(b, k, C)
    ci3 = ci.reshape(b, k, C)
    if banned is not None:
        hit = (ci3[:, :, :, None] == banned[:, :, None, :]).any(dim=-1)
        if not _host_bool((hit.sum(dim=-1) <= C - 2 * k).all()):
            with annotate("beam_search.fallback"):
                return full_fn(logits, lse, s, cur)
        total = torch.where(hit, float("-inf"), total)
    ts, ti = top_k(total.reshape(b, k * C), 2 * k)
    return ts, ti // C, torch.gather(ci3.reshape(b, k * C), 1, ti)


def _candidates_opt(logits, lse, s: BeamState, cur: int, *, cfg: DecodeConfig, b, k,
                    vocab_size, eos_token_id, forced_bos_token_id, full_fn):
    """One wide top-W over the unbanned totals, bans checked on the W winners
    only; falls back to the full path when a row of the batch has more than
    W - 2K banned winners. Forced steps take the analytic candidates, so
    dropping the banned winners to -inf is exact."""
    is_fb = forced_bos_token_id is not None and cur == 1
    is_fe = cfg.forced_eos and cur == cfg.max_length - 1
    if is_fb or is_fe:
        return _forced_step_candidates(s, b=b, k=k, is_fe=is_fe, eos_token_id=eos_token_id,
                                       forced_bos_token_id=forced_bos_token_id,
                                       vocab_size=vocab_size)
    total = logits.reshape(b, k, -1) + (s.running_scores - lse.reshape(b, k))[:, :, None]
    banned = _banned_token_list(s, cur, cfg=cfg, eos_token_id=eos_token_id)
    # an explicitly valid OPT_WINDOW is kept (the tests shrink it to force the
    # fallback); otherwise the window widens with the beams
    w = OPT_WINDOW if OPT_WINDOW > 2 * k else 2 * k + 8
    ts, ti = top_k(total.reshape(b, k * vocab_size), w)
    tbeam, ttok = ti // vocab_size, ti % vocab_size
    if banned is not None:
        bl = torch.gather(banned, 1, tbeam[:, :, None].expand(b, w, banned.shape[2]))
        hit = (ttok[:, :, None] == bl).any(dim=-1)
        if not _host_bool((hit.sum(dim=1) <= w - 2 * k).all()):
            with annotate("beam_search.fallback"):
                return full_fn(logits, lse, s, cur)
        ts = torch.where(hit, float("-inf"), ts)
    s2, i2 = top_k(ts, 2 * k)
    return s2, torch.gather(tbeam, 1, i2), torch.gather(ttok, 1, i2)


def beam_search(
    step_fn: Callable[[torch.Tensor, Any, int], tuple[torch.Tensor, Any]],
    init_cache: Any,
    batch_size: int,
    *,
    cfg: DecodeConfig,
    eos_token_id: int,
    pad_token_id: int,
    decoder_start_token_id: int,
    forced_bos_token_id: int | None,
    vocab_size: int,
    reorder_cache_fn: Callable[[Any, torch.Tensor], Any],
    device,
    cand_mode: str | None = None,
    step_stats_fn: Callable | None = None,
    block_lse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run beam search. `step_fn(tokens [BK, 1], cache, pos) -> (logits
    [BK, V], cache)`; `reorder_cache_fn(cache, flat_sel [BK])` applies a beam
    selection. cand_mode None takes resolve_cand_mode's auto rule.

    `step_stats_fn(tokens, cache, pos) -> (logits_padded [BK, Vp] f32,
    cand_vals [BK, C], cand_idx [BK, C], lse [BK], cache)` replaces step_fn
    (shortlist mode only): a fused LM head that already computed the row
    shortlist and the logsumexp; the padded logits feed only the
    certificate fallback, sliced to V. `block_lse=True` (shortlist mode,
    without a stats head, vocab >= 2 * C * 128) shares one block pass
    between the row top-C and the logsumexp.
    Returns (sequences [B, L], scores [B]) of the best hypothesis per item."""
    b, k, L = batch_size, cfg.num_beams, cfg.max_length
    lp = cfg.length_penalty
    mode = cand_mode or resolve_cand_mode(cfg, vocab_size)
    if mode not in MODES:
        raise ValueError(f"cand_mode {mode!r}: the port has {MODES}")
    if step_stats_fn is not None and mode != "shortlist":
        raise ValueError(f"a stats head feeds the shortlist mode only, not {mode!r}")
    c_sl = min(shortlist_c_width(k), vocab_size)
    if block_lse and (mode != "shortlist" or step_stats_fn is not None
                      or vocab_size < 2 * c_sl * 128):
        raise ValueError("block_lse needs the shortlist mode without a stats head and "
                         f"vocab >= {2 * c_sl * 128} (mode {mode!r}, vocab {vocab_size})")
    legacy = cfg.hf_compat == "4.18"

    running_seqs = torch.full((b, k, L), pad_token_id, dtype=torch.int64, device=device)
    running_seqs[:, :, 0] = decoder_start_token_id
    running_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=device)
    running_scores[:, 0] = 0.0
    s = BeamState(
        cur_len=1, running_seqs=running_seqs, running_scores=running_scores,
        finished_seqs=torch.full((b, k, L), pad_token_id, dtype=torch.int64, device=device),
        finished_scores=torch.full((b, k), NEG_INF, dtype=torch.float32, device=device),
        finished_flags=torch.zeros((b, k), dtype=torch.bool, device=device),
        done=torch.zeros((b,), dtype=torch.bool, device=device),
        cache=init_cache)

    common = dict(cfg=cfg, b=b, k=k, vocab_size=vocab_size, eos_token_id=eos_token_id,
                  forced_bos_token_id=forced_bos_token_id)

    def full_fn(logits, lse, st, cur):
        return candidates_full(logits[:, :vocab_size], lse, st, cur, **common)

    def pow_f32(x: int) -> torch.Tensor:
        with annotate("beam_search.sync"):  # a host scalar's copy waits for the stream
            x = torch.tensor(float(x), dtype=torch.float32, device=device)
        return x ** lp

    k_range = torch.arange(2 * k, device=device)[None, :]
    while s.cur_len < L and not _host_bool(s.done.all()):
        cur = s.cur_len
        with annotate("beam_search.model"):
            tok = s.running_seqs.reshape(b * k, L)[:, cur - 1:cur]
            if step_stats_fn is not None:
                logits, cv, ci, lse, new_cache = step_stats_fn(tok, s.cache, cur - 1)
            else:
                logits, new_cache = step_fn(tok, s.cache, cur - 1)
        with annotate("beam_search.select"):
            if step_stats_fn is not None:
                topk_scores, topk_beam, topk_tok = _candidates_shortlist(
                    logits, lse, s, cur, full_fn=full_fn, pre=(cv, ci), **common)
            else:
                logits = logits.float()
                blocks = None
                if block_lse:
                    blocks = _block_view(logits)
                    lse = blocked_logsumexp(*blocks)
                else:
                    lse = torch.logsumexp(logits, dim=-1)
                if mode == "shortlist":
                    topk_scores, topk_beam, topk_tok = _candidates_shortlist(
                        logits, lse, s, cur, full_fn=full_fn, blocks=blocks, **common)
                elif mode == "opt":
                    topk_scores, topk_beam, topk_tok = _candidates_opt(
                        logits, lse, s, cur, full_fn=full_fn, **common)
                else:
                    topk_scores, topk_beam, topk_tok = full_fn(logits, lse, s, cur)

            cand_seqs = gather_beams(s.running_seqs, topk_beam)  # [B, 2K, L]
            cand_seqs[:, :, cur] = topk_tok

            eos_hit = topk_tok == eos_token_id
            is_last = cur + 1 >= L
            hits = eos_hit if legacy else (eos_hit | is_last)
            admit = hits & (k_range < k) & ~s.done[:, None]

            new_fin = torch.where(admit, topk_scores / pow_f32(cur), NEG_INF)
            fin_scores = torch.cat([s.finished_scores, new_fin], dim=1)
            fin_seqs = torch.cat([s.finished_seqs, cand_seqs], dim=1)
            fin_flags = torch.cat([s.finished_flags, admit], dim=1)

            run_cand = torch.where(hits, NEG_INF, topk_scores)
            top_run_scores, top_run_idx = top_k(run_cand, k)
            new_running_seqs = gather_beams(cand_seqs, top_run_idx)
            sel_beam = torch.gather(topk_beam, 1, top_run_idx)

            if legacy:
                final_admit = (~s.done[:, None]).expand(b, k) & is_last
                final_scores = torch.where(final_admit, top_run_scores / pow_f32(cur + 1), NEG_INF)
                fin_scores = torch.cat([fin_scores, final_scores], dim=1)
                fin_seqs = torch.cat([fin_seqs, new_running_seqs], dim=1)
                fin_flags = torch.cat([fin_flags, final_admit], dim=1)

            top_fin_scores, top_fin_idx = top_k(fin_scores, k)
            finished_seqs = gather_beams(fin_seqs, top_fin_idx)
            finished_flags = torch.gather(fin_flags, 1, top_fin_idx)

            flat_sel = (torch.arange(b, device=device)[:, None] * k + sel_beam).reshape(-1)
            new_cache = reorder_cache_fn(new_cache, flat_sel)

            all_fin = finished_flags.all(dim=1)
            if cfg.early_stopping:
                newly_done = all_fin
            else:
                best_num = topk_scores[:, 0] if legacy else top_run_scores[:, 0]
                best_possible = best_num / pow_f32(cur)
                newly_done = all_fin & (best_possible <= top_fin_scores.amin(dim=1))

            def freeze(old, new):
                return torch.where(s.done.reshape((b,) + (1,) * (new.ndim - 1)), old, new)

            s = BeamState(
                cur_len=cur + 1,
                running_seqs=freeze(s.running_seqs, new_running_seqs),
                running_scores=freeze(s.running_scores, top_run_scores),
                finished_seqs=freeze(s.finished_seqs, finished_seqs),
                finished_scores=freeze(s.finished_scores, top_fin_scores),
                finished_flags=freeze(s.finished_flags, finished_flags),
                done=s.done | newly_done,
                cache=new_cache)
    return s.finished_seqs[:, 0], s.finished_scores[:, 0]
