"""Tokenizers for the data layer (port of vacnic_tpu/data/tokenize.py; ids
identical to JAX's, added tokens and truncation included).

The reference uses HF `BartTokenizer` (byte-level GPT-2 BPE) with the special
tokens `<ENT> <NONAME>` added for the model and additionally
`<PERSON> <ORGNORP> <GPELOC>` for the dataset/NER side
(train...match.py:753, 767-768). This module provides:

  * `BartBpeTokenizer` — a self-contained byte-level BPE encoder/decoder that
    loads the standard `vocab.json` + `merges.txt` files (shipped with any
    BART checkpoint); no network or `transformers` needed at data time.
  * `HashWordTokenizer` — deterministic word→id hashing with BART's special
    token layout, for tests and synthetic pipelines.

Both expose the small interface the datasets consume:
`encode(text, max_length=None, add_special_tokens=True) -> list[int]`,
`decode(ids, skip_special_tokens=True) -> str`, `add_special_tokens([...])`,
plus `bos/eos/pad/unk_token_id` attributes.
"""

from __future__ import annotations

import json
import re
import threading
from functools import lru_cache


@lru_cache()
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2 byte↔unicode table (maps every byte to a printable codepoint)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(
        range(ord("®"), ord("ÿ") + 1)
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


# GPT-2's exact pretokenizer: separate letter / number / punctuation classes
# (`\p{L}`/`\p{N}`). A merged ` ?\w+` variant diverges on letter-digit mixes
# ("COVID19" → ["COVID","19"] in GPT-2) and underscores, breaking id-level
# parity with the pretrained BART vocab.
try:
    import regex as _re_impl

    _GPT2_SPLIT = _re_impl.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
    )
    PRETOKENIZER = "regex"
except ImportError:  # without `regex`: the same classes in the stdlib's syntax
    _GPT2_SPLIT = re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[_]|[^\s\w])+|\s+(?!\S)|\s+""",
        re.UNICODE,
    )
    PRETOKENIZER = "re"


class BartBpeTokenizer:
    """Byte-level BPE matching BART/GPT-2 tokenization.

    vocab_file: path to vocab.json; merges_file: path to merges.txt.
    BART ids: <s>=0, <pad>=1, </s>=2, <unk>=3.
    """

    def __init__(self, vocab_file: str, merges_file: str):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [m for m in merges if m and not m.startswith("#version")]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._bpe_cache: dict[str, str] = {}

        self.bos_token_id = self.encoder.get("<s>", 0)
        self.pad_token_id = self.encoder.get("<pad>", 1)
        self.eos_token_id = self.encoder.get("</s>", 2)
        self.unk_token_id = self.encoder.get("<unk>", 3)
        self.added_tokens: dict[str, int] = {}
        self._added_pattern: re.Pattern | None = None
        self._native = None
        self._native_tried = False
        self._native_lock = threading.Lock()
        self._ids_cache: dict[str, list[int]] = {}

    def __len__(self) -> int:
        return len(self.encoder) + len(self.added_tokens)

    # -- special tokens ----------------------------------------------------
    def add_special_tokens(self, tokens: list[str]) -> None:
        """Append new tokens after the base vocab (HF add_special_tokens
        ordering: <ENT>=50265, <NONAME>=50266, <PERSON>=50267, ...)."""
        for t in tokens:
            if t not in self.added_tokens and t not in self.encoder:
                self.added_tokens[t] = len(self.encoder) + len(self.added_tokens)
        pat = "|".join(re.escape(t) for t in self.added_tokens)
        self._added_pattern = re.compile(f"({pat})") if pat else None

    # -- BPE core ----------------------------------------------------------
    def _bpe(self, token: str) -> str:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word = tuple(token)
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        while pairs:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        out = " ".join(word)
        self._bpe_cache[token] = out
        return out

    # -- native merge engine (runtime/native: the C BPE loop via ctypes) -----
    def _get_native(self):
        with self._native_lock:  # the loader's worker threads share a tokenizer
            if self._native_tried:
                return self._native
            self._native_tried = True
            try:
                import numpy as np

                from vacnic_tpu_torch.runtime.native import FastBpe

                keys, ranks, merged = [], [], []
                for (x, y), r in self.bpe_ranks.items():
                    a, b, m = self.encoder.get(x), self.encoder.get(y), self.encoder.get(x + y)
                    if a is None or b is None or m is None:
                        continue
                    keys.append((a << 32) | b)
                    ranks.append(r)
                    merged.append(m)
                eng = FastBpe(np.asarray(keys, np.uint64), np.asarray(ranks, np.int32),
                              np.asarray(merged, np.int32))
                self._native = eng if eng.available else None
            except Exception:
                self._native = None
            return self._native

    @property
    def engine(self) -> str:
        """The BPE merge engine in use: "native" (fastbpe.c) or "python"."""
        return "native" if self._get_native() is not None else "python"

    def _encode_pretoken_py(self, tok: str) -> list[int]:
        tok_bytes = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
        return [self.encoder.get(p, self.unk_token_id) for p in self._bpe(tok_bytes).split(" ")]

    def _encode_text(self, text: str) -> list[int]:
        """Per-word id cache fronts both paths; the native C merge engine
        (runtime/native) handles all cache misses of a text in one batch
        call, the Python loop is the no-compiler fallback."""
        pretokens = _GPT2_SPLIT.findall(text)
        cache = self._ids_cache
        native = self._get_native()

        misses: list[str] = []
        if native is not None:
            miss_words = []
            for tok in set(t for t in pretokens if t not in cache):
                word_ids = [self.encoder.get(self.byte_encoder[b]) for b in tok.encode("utf-8")]
                if any(i is None for i in word_ids):
                    cache[tok] = self._encode_pretoken_py(tok)
                else:
                    misses.append(tok)
                    miss_words.append(word_ids)
            for tok, ids in zip(misses, native.encode_words(miss_words)):
                cache[tok] = ids

        out: list[int] = []
        for tok in pretokens:
            ids = cache.get(tok)
            if ids is None:
                ids = cache[tok] = self._encode_pretoken_py(tok)
            out.extend(ids)
        return out

    def encode(self, text: str, max_length: int | None = None,
               add_special_tokens: bool = True) -> list[int]:
        if self._added_pattern is not None:
            parts = self._added_pattern.split(text)
        else:
            parts = [text]
        ids: list[int] = []
        for part in parts:
            if not part:
                continue
            if part in self.added_tokens:
                ids.append(self.added_tokens[part])
            else:
                ids.extend(self._encode_text(part))
        if add_special_tokens:
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
        if max_length is not None and len(ids) > max_length:
            # HF truncation keeps the eos at the end
            ids = ids[: max_length - 1] + [self.eos_token_id] if add_special_tokens else ids[:max_length]
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        special = {self.bos_token_id, self.eos_token_id, self.pad_token_id}
        rev_added = {v: k for k, v in self.added_tokens.items()}
        pieces: list[str] = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in special:
                continue
            if i in rev_added:
                pieces.append(rev_added[i])
            else:
                pieces.append(self.decoder.get(i, ""))
        text = "".join(pieces)
        return bytearray(self.byte_decoder.get(c, 32) for c in text).decode("utf-8", errors="replace")


class HashWordTokenizer:
    """Deterministic word-hash tokenizer with BART's id layout — for tests and
    synthetic data pipelines (no vocab files needed)."""

    def __init__(self, vocab_size: int = 50265):
        self.vocab_size = vocab_size
        self.bos_token_id, self.pad_token_id, self.eos_token_id, self.unk_token_id = 0, 1, 2, 3
        self.added_tokens: dict[str, int] = {}

    def __len__(self) -> int:
        return self.vocab_size + len(self.added_tokens)

    def add_special_tokens(self, tokens: list[str]) -> None:
        for t in tokens:
            if t not in self.added_tokens:
                self.added_tokens[t] = self.vocab_size + len(self.added_tokens)

    def _word_id(self, w: str) -> int:
        h = 0
        for ch in w:
            h = (h * 131 + ord(ch)) % (self.vocab_size - 10)
        return 10 + h

    def encode(self, text: str, max_length: int | None = None,
               add_special_tokens: bool = True) -> list[int]:
        ids = []
        for w in text.split():
            if w in self.added_tokens:
                ids.append(self.added_tokens[w])
            else:
                ids.append(self._word_id(w))
        if add_special_tokens:
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
        if max_length is not None and len(ids) > max_length:
            ids = ids[: max_length - 1] + [self.eos_token_id]
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(f"w{int(i)}" for i in ids if int(i) > 3)
