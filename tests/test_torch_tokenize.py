"""The port's tokenizers and native BPE runtime (vacnic_tpu_torch/data/
tokenize.py, data/clip_tokenize.py, runtime/native.py + fastbpe.c) against
the JAX package's, on vocab and merges files each test writes itself
(chip_smoke.py's `write_bpe_vocab`, the data phase's writer):

* BartBpeTokenizer ids identical to JAX's over unicode, digit, added-token,
  whitespace and truncation cases, with the port on its native (C) engine
  and on its Python engine; on BART's 50265-entry layout the added tokens
  get BART's ids; `decode` identical, special tokens kept and skipped;
* HashWordTokenizer and the GPT-2 pretokenizer identical;
* ClipBpeTokenizer from HF files and from a written OpenAI `.gz`: ids,
  `tokenize` arrays and `decode` identical;
* the native build is atomic: the library appears under its final name only
  once complete, no temporary file is left, and processes that build the
  same library at the same time all load it.

Tolerance: none; ids, arrays and strings are compared exactly."""

import gzip
import json
import os
import random
import runpy
import string
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from vacnic_tpu.data import clip_tokenize as JC
from vacnic_tpu.data import tokenize as JT
from vacnic_tpu_torch.data import clip_tokenize as TC
from vacnic_tpu_torch.data import tokenize as TT
from vacnic_tpu_torch.runtime import native

REPO = Path(__file__).resolve().parents[1]
SMOKE = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke_helpers")
SPECIAL = list(SMOKE["SPECIAL_TOKENS"])

TEXTS = [
    "the press photo shows Alice Smith waving in Paris today",
    "héllo wörld — naïve café, Ünïcödé 東京 😀 ©",
    "COVID19 cases rose 42% in 2020; 9/11 and 3.14 and 1,000,000",
    "it's Obama's plan, isn't it? We'll see. They'd've",
    "foo_bar   spaced\tout\nnew   lines  ",
    "Alice <ENT> Smith<NONAME> met <PERSON> at the <ORGNORP>, in <GPELOC>.",
    "<ENT><ENT> <NONAME>",
    "",
    "   ",
]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    """(vocab, merges) of the fixture's words, no filler entries."""
    return SMOKE["write_bpe_vocab"](str(tmp_path_factory.mktemp("bpe")), size=None)


def pair(vocab, engine: str):
    """(JAX tokenizer, port tokenizer) with the five added tokens; the port's
    on the asked engine, JAX's on its default (native where cc builds it)."""
    j, t = JT.BartBpeTokenizer(*vocab), TT.BartBpeTokenizer(*vocab)
    if engine == "python":
        t._native_tried = True
    for tok in (j, t):
        tok.add_special_tokens(SPECIAL)
    return j, t


def random_texts(n: int, seed: int = 1):
    rng = random.Random(seed)
    words = list(SMOKE["FIXTURE_WORDS"]) + [
        "".join(rng.choices(string.ascii_letters + "éü", k=rng.randint(1, 12)))
        for _ in range(300)]
    return [" ".join(rng.choices(words, k=120)) for _ in range(n)]


@pytest.mark.parametrize("engine", ["native", "python"])
def test_bpe_ids_match_jax(vocab, engine):
    j, t = pair(vocab, engine)
    assert t.engine == engine
    for text in TEXTS + random_texts(5):
        assert t.encode(text) == j.encode(text), text
        assert t.encode(text, add_special_tokens=False) == j.encode(text, add_special_tokens=False)
        for n in (1, 2, 5, 16):
            assert t.encode(text, max_length=n) == j.encode(text, max_length=n), (text, n)
            assert (t.encode(text, max_length=n, add_special_tokens=False)
                    == j.encode(text, max_length=n, add_special_tokens=False))
    assert t.encode(TEXTS[0], max_length=5)[-1] == t.eos_token_id  # truncation keeps eos
    assert len(t) == len(j) and t.added_tokens == j.added_tokens


def test_native_engine_matches_python_engine(vocab):
    if native.load_fastbpe() is None:
        pytest.skip("no system compiler for the native runtime")
    _, tn = pair(vocab, "native")
    _, tp = pair(vocab, "python")
    for text in random_texts(10, seed=7) + TEXTS:
        assert tn.encode(text) == tp.encode(text)


def test_added_tokens_get_bart_ids(tmp_path):
    vf, mf = SMOKE["write_bpe_vocab"](str(tmp_path))  # padded to BART's 50265 entries
    j, t = JT.BartBpeTokenizer(vf, mf), TT.BartBpeTokenizer(vf, mf)
    for tok in (j, t):
        tok.add_special_tokens(SPECIAL)
    assert t.added_tokens == {"<ENT>": 50265, "<NONAME>": 50266, "<PERSON>": 50267,
                              "<ORGNORP>": 50268, "<GPELOC>": 50269}
    assert t.added_tokens == j.added_tokens
    text = "Alice Smith <ENT> Bob Jones <NONAME> in Paris"
    assert t.encode(text) == j.encode(text)
    assert 50265 in t.encode(text) and max(t.encode(TEXTS[0])) < 50265


@pytest.mark.parametrize("skip", [True, False])
def test_decode_matches_jax(vocab, skip):
    j, t = pair(vocab, "native")
    ids_list = [j.encode(x) for x in TEXTS] + [
        [0, 2, 1, 1, 3, len(t) - 1, len(t), len(t) + 40, 5, 2],  # specials, added, unknown
        np.arange(0, len(t), 7).tolist()]
    for ids in ids_list:
        assert t.decode(ids, skip_special_tokens=skip) == j.decode(ids, skip_special_tokens=skip)
        arr = np.asarray(ids, np.int64)
        assert t.decode(arr, skip_special_tokens=skip) == j.decode(arr, skip_special_tokens=skip)
    assert t.decode(t.encode(TEXTS[1])) == TEXTS[1]


def test_hash_word_tokenizer_and_pretokenizer_match_jax():
    j, t = JT.HashWordTokenizer(50265), TT.HashWordTokenizer(50265)
    for tok in (j, t):
        tok.add_special_tokens(SPECIAL)
    assert t.added_tokens == j.added_tokens and len(t) == len(j)
    for text in TEXTS + random_texts(2):
        assert t.encode(text, max_length=12) == j.encode(text, max_length=12)
        ids = t.encode(text)
        assert ids == j.encode(text) and t.decode(ids) == j.decode(ids)
    assert TT.PRETOKENIZER == "regex"  # `regex` is installed: GPT-2's exact classes
    for text in TEXTS + ["COVID19 cases", "foo_bar", "it's 9/11"]:
        assert TT._GPT2_SPLIT.findall(text) == JT._GPT2_SPLIT.findall(text)
    assert TT._bytes_to_unicode() == JT._bytes_to_unicode()


# -- CLIP ---------------------------------------------------------------------

CLIP_MERGES = [("h", "e"), ("l", "o</w>"), ("he", "l"), ("hel", "lo</w>"), ("w", "o"),
               ("wo", "r"), ("wor", "l"), ("worl", "d</w>"), ("t", "he</w>"), ("a", "n"),
               ("an", "d</w>"), ("i", "s</w>"), ("o", "b"), ("ob", "a"), ("oba", "m"),
               ("obam", "a</w>"), ("i", "t</w>"), ("'", "s</w>")]
CLIP_TEXTS = ["Hello World", "hello   world  ", "It's Obama's plan, isn't it?",
              "COVID19 cases rose 42%", "fish &amp;amp; chips", "café naïve — 2020",
              "hello !!", "hello world " * 30]


def write_clip_files(d: Path):
    """The OpenAI .gz (a header line, then the merges) and HF vocab.json +
    merges.txt built from it."""
    gz = d / "bpe_simple_vocab_test.txt.gz"
    with gzip.open(gz, "wt", encoding="utf-8") as f:
        f.write("bpe vocab header line\n" + "\n".join(" ".join(m) for m in CLIP_MERGES))
    enc = JC.ClipBpeTokenizer.from_openai_vocab(str(gz)).encoder
    (d / "vocab.json").write_text(json.dumps(enc, ensure_ascii=False), encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in CLIP_MERGES),
                                  encoding="utf-8")
    return str(gz), str(d / "vocab.json"), str(d / "merges.txt")


@pytest.mark.parametrize("source", ["openai_gz", "hf_files", "from_dir"])
def test_clip_tokenizer_matches_jax(tmp_path, source):
    gz, vf, mf = write_clip_files(tmp_path)
    if source == "openai_gz":
        j, t = JC.ClipBpeTokenizer.from_openai_vocab(gz), TC.ClipBpeTokenizer.from_openai_vocab(gz)
    elif source == "hf_files":
        j, t = (JC.ClipBpeTokenizer.from_hf_files(vf, mf),
                TC.ClipBpeTokenizer.from_hf_files(vf, mf))
    else:
        j, t = JC.ClipBpeTokenizer.from_dir(str(tmp_path)), TC.ClipBpeTokenizer.from_dir(str(tmp_path))
    assert t.encoder == j.encoder and t.bpe_ranks == j.bpe_ranks and len(t) == len(j)
    assert (t.sot_token_id, t.eot_token_id, t.pad_token_id) == (
        j.sot_token_id, j.eot_token_id, j.pad_token_id)
    for text in CLIP_TEXTS:
        assert t.encode(text) == j.encode(text), text
        assert t.encode(text, max_length=8) == j.encode(text, max_length=8)
        assert t.decode(t.encode(text)) == j.decode(j.encode(text))
    arr, jarr = t.tokenize(CLIP_TEXTS, truncate=True), j.tokenize(CLIP_TEXTS, truncate=True)
    assert arr.dtype == jarr.dtype == np.int32
    np.testing.assert_array_equal(arr, jarr)
    assert t.decode(arr[6].tolist()) == j.decode(jarr[6].tolist()) == "hello !!"
    with pytest.raises(RuntimeError, match="too long"):
        t.tokenize(CLIP_TEXTS[-1], context_length=8)
    assert TC.basic_clean("fish &amp;amp; chips") == JC.basic_clean("fish &amp;amp; chips")


# -- the native build ----------------------------------------------------------

def test_native_cache_dir_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.delenv("VACNIC_TORCH_NATIVE_CACHE", raising=False)
    monkeypatch.setattr(native.tempfile, "gettempdir", lambda: str(tmp_path))
    path = native.library_path()
    assert os.path.dirname(path) == str(tmp_path / f"vacnic_torch_native_{os.getuid()}")
    monkeypatch.setenv("VACNIC_TORCH_NATIVE_CACHE", str(tmp_path / "mine"))
    assert os.path.dirname(native.library_path()) == str(tmp_path / "mine")


def test_native_build_is_atomic(tmp_path, monkeypatch):
    """The compiler writes to a temporary name; the final name appears only
    through os.replace, complete, and no temporary file stays behind (also
    when every compiler fails)."""
    final = str(tmp_path / "libfastbpe_test.so")
    seen = []

    def fake_cc(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        assert out != final and os.path.dirname(out) == str(tmp_path)
        with open(out, "wb") as f:
            f.write(b"half")
            seen.append(os.path.exists(final))  # mid-write: nothing under the final name
            f.write(b" and the rest")
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(native.subprocess, "run", fake_cc)
    assert native.build(final)
    assert seen == [False]
    assert open(final, "rb").read() == b"half and the rest"
    assert os.listdir(tmp_path) == ["libfastbpe_test.so"]

    def no_cc(cmd, **kw):
        open(cmd[cmd.index("-o") + 1], "wb").write(b"partial")
        raise subprocess.CalledProcessError(1, cmd)

    monkeypatch.setattr(native.subprocess, "run", no_cc)
    other = str(tmp_path / "libother.so")
    assert not native.build(other)
    assert os.listdir(tmp_path) == ["libfastbpe_test.so"]


CONCURRENT = r"""
import sys
from vacnic_tpu_torch.data.tokenize import BartBpeTokenizer
from vacnic_tpu_torch.runtime import native
t = BartBpeTokenizer(sys.argv[1], sys.argv[2])
print(t.engine, t.encode("the press photo shows alice"), native.library_path())
"""


def test_concurrent_builds_all_load_native(vocab, tmp_path):
    """Four processes with an empty cache build the same library at once:
    every one loads it and tokenizes on the native engine."""
    if native.load_fastbpe() is None:
        pytest.skip("no system compiler for the native runtime")
    env = dict(os.environ, VACNIC_TORCH_NATIVE_CACHE=str(tmp_path / "cache"),
               PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", CONCURRENT, *vocab], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    lines = {o[0].strip() for o in outs}
    assert len(lines) == 1 and lines.pop().startswith("native ")
    assert [n for n in os.listdir(tmp_path / "cache") if ".tmp" in n] == []
