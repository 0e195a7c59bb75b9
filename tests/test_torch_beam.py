"""Port beam search against JAX beam_search on identical logit tables, in the
"full", "opt" and "shortlist" candidate modes (and the shortlist's block-lse
variant), with and without exact ties: sequences identical, scores within
1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vacnic_tpu.core.config import DecodeConfig as JDecode
from vacnic_tpu.infer import beam_search as JBS
from vacnic_tpu_torch.core.config import DecodeConfig as TDecode
from vacnic_tpu_torch.infer import beam_search as TBS

B, K = 3, 5

CFGS = [
    # released decode shape: forced bos + forced eos + ngram 3 + early stop
    dict(num_beams=K, max_length=12, length_penalty=2.0, early_stopping=True,
         no_repeat_ngram_size=3, forced_eos=True),
    # min_length active
    dict(num_beams=K, max_length=12, length_penalty=1.0, early_stopping=True, min_length=8,
         no_repeat_ngram_size=3, forced_eos=True),
    # early_stopping=False, 4.18 heuristic
    dict(num_beams=K, max_length=10, length_penalty=2.0, early_stopping=False,
         no_repeat_ngram_size=3, forced_eos=True, hf_compat="4.18"),
    # modern finalize denominators, no forced eos, ngram 2
    dict(num_beams=K, max_length=10, length_penalty=2.0, early_stopping=False,
         no_repeat_ngram_size=2, forced_eos=False, hf_compat="modern"),
]


def tables(seed: int, vocab: int, ties: bool):
    rng = np.random.RandomState(seed)
    table = rng.randn(64, vocab).astype(np.float32) * 4.0
    ptab = rng.randn(64, vocab).astype(np.float32)
    if ties:  # coarse grid, no position term: many exactly equal logits
        table = np.round(table).astype(np.float32)
        ptab = np.zeros_like(ptab)
    return table, ptab


def run_jax(cfg, table, ptab, mode, monkeypatch, vocab):
    monkeypatch.setenv("VACNIC_BEAM_LOGIC", mode)
    jt, jpt = jnp.asarray(table), jnp.asarray(ptab)

    def step_fn(tok, cache, pos):
        return jnp.take(jt, tok[:, 0] % 64, axis=0) + jnp.take(jpt, pos % 64, axis=0)[None], cache

    seqs, scores = JBS.beam_search(
        step_fn, jnp.int32(0), B, cfg=JDecode(**cfg), eos_token_id=2, pad_token_id=1,
        decoder_start_token_id=2, forced_bos_token_id=0, vocab_size=vocab,
        reorder_cache_fn=lambda c, sel: c)
    return np.asarray(seqs), np.asarray(scores)


def run_torch(cfg, table, ptab, mode, vocab, block_lse=False):
    tt, tpt = torch.from_numpy(table), torch.from_numpy(ptab)

    def step_fn(tok, cache, pos):
        return tt[tok[:, 0] % 64] + tpt[pos % 64][None], cache

    seqs, scores = TBS.beam_search(
        step_fn, None, B, cfg=TDecode(**cfg), eos_token_id=2, pad_token_id=1,
        decoder_start_token_id=2, forced_bos_token_id=0, vocab_size=vocab,
        reorder_cache_fn=lambda c, sel: c, device="cpu", cand_mode=mode, block_lse=block_lse)
    return seqs.numpy(), scores.numpy()


@pytest.mark.parametrize("mode", ["full", "shortlist", "opt"])
@pytest.mark.parametrize("case", range(len(CFGS)))
def test_beam_search_matches_jax(case, mode, monkeypatch):
    vocab = 256
    for seed, ties in ((case, False), (10 + case, True)):
        table, ptab = tables(seed, vocab, ties)
        js, jsc = run_jax(CFGS[case], table, ptab, mode, monkeypatch, vocab)
        ts, tsc = run_torch(CFGS[case], table, ptab, mode, vocab)
        np.testing.assert_array_equal(ts, js, err_msg=f"case {case} ties {ties}")
        np.testing.assert_allclose(tsc, jsc, rtol=0, atol=1e-5)


def test_blockmax_shortlist_matches_jax(monkeypatch):
    """A vocab wide enough for the block-max row top-C (>= 2*C*128)."""
    vocab = 4096
    table, ptab = tables(3, vocab, ties=True)
    js, jsc = run_jax(CFGS[0], table, ptab, "shortlist", monkeypatch, vocab)
    ts, tsc = run_torch(CFGS[0], table, ptab, "shortlist", vocab)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tsc, jsc, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", range(len(CFGS)))
def test_opt_mode_matches_full(case):
    """The opt mode's certificate makes it exact: token-identical to full."""
    for seed, ties in ((20 + case, False), (30 + case, True)):
        table, ptab = tables(seed, 256, ties)
        fs, fsc = run_torch(CFGS[case], table, ptab, "full", 256)
        os_, osc = run_torch(CFGS[case], table, ptab, "opt", 256)
        np.testing.assert_array_equal(os_, fs)
        np.testing.assert_allclose(osc, fsc, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", [0, 1])
def test_opt_certificate_fallback(case, monkeypatch):
    """A window of 2K + 1 tolerates one ban per row: the certificate fails on
    some steps and the step falls back to the full path, in both packages,
    with the same tokens as full."""
    # every row favours the same dozen tokens, so the n-gram bans pile up
    # on the top candidates
    rng = np.random.RandomState(case)
    base = np.full(256, -30.0, np.float32)
    base[:12] = -0.3 * np.arange(12)
    table = (base[None] + 0.05 * rng.randn(64, 256)).astype(np.float32)
    ptab = np.zeros_like(table)
    monkeypatch.setattr(JBS, "OPT_WINDOW", 2 * K + 1)
    monkeypatch.setattr(TBS, "OPT_WINDOW", 2 * K + 1)
    js, jsc = run_jax(CFGS[case], table, ptab, "opt", monkeypatch, 256)
    fallbacks = []
    real = TBS.candidates_full
    monkeypatch.setattr(TBS, "candidates_full",
                        lambda *a, **kw: fallbacks.append(1) or real(*a, **kw))
    ts, tsc = run_torch(CFGS[case], table, ptab, "opt", 256)
    assert fallbacks  # the certificate failed at least once (forced steps never call it)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tsc, jsc, rtol=0, atol=1e-5)
    monkeypatch.setattr(TBS, "candidates_full", real)
    fs, _ = run_torch(CFGS[case], table, ptab, "full", 256)
    np.testing.assert_array_equal(ts, fs)


@pytest.mark.parametrize("ties", [False, True], ids=["plain", "ties"])
def test_block_lse_matches_jax_and_full(ties, monkeypatch):
    """The shortlist's shared block pass (JAX VACNIC_BLOCK_LSE=1) at a vocab
    wide enough for it: token-identical to JAX and to the full mode."""
    vocab = 4096
    table, ptab = tables(50 + int(ties), vocab, ties)
    monkeypatch.setenv("VACNIC_BLOCK_LSE", "1")
    js, jsc = run_jax(CFGS[0], table, ptab, "shortlist", monkeypatch, vocab)
    ts, tsc = run_torch(CFGS[0], table, ptab, "shortlist", vocab, block_lse=True)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tsc, jsc, rtol=0, atol=1e-5)
    fs, fsc = run_torch(CFGS[0], table, ptab, "full", vocab)
    np.testing.assert_array_equal(ts, fs)
    np.testing.assert_allclose(tsc, fsc, rtol=0, atol=1e-4)
    r3, bm = TBS._block_view(torch.from_numpy(table[:, :4000]))
    np.testing.assert_allclose(TBS.blocked_logsumexp(r3, bm).numpy(),
                               torch.logsumexp(torch.from_numpy(table[:, :4000]), -1).numpy(),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="block_lse"):
        run_torch(CFGS[0], table, ptab, "full", vocab, block_lse=True)


def test_top_k_tie_order_and_blockmax():
    rng = np.random.RandomState(0)
    x = np.round(rng.randn(6, 4096) * 2).astype(np.float32)
    vt, it = TBS.top_k(torch.from_numpy(x), 16)
    vj, ij = jax.lax.top_k(jnp.asarray(x), 16)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    ct, cit = TBS.row_topk_blockmax(torch.from_numpy(x), 16)
    np.testing.assert_array_equal(cit.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(vj))


def test_resolve_cand_mode():
    released = TDecode()
    assert TBS.resolve_cand_mode(released, 50267) == "shortlist"
    assert TBS.resolve_cand_mode(released, 128) == "full"
    for v in (128, 200, 50267):
        jax_mode = JBS.resolve_cand_mode(JDecode(), v)
        assert TBS.resolve_cand_mode(TDecode(), v) == jax_mode
    with pytest.raises(ValueError):
        run_torch(CFGS[0], *tables(0, 256, False), "chunked", 256)
