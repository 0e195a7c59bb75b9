"""CLIP BPE tokenizer (port of vacnic_tpu/data/clip_tokenize.py) — the exact `clip.tokenize` semantics the reference
datasets depend on (goodnews...py:625-628, nytimes...py:585-588:
``caption_ids_clip = clip.tokenize(caption, truncate=True)``).

OpenAI CLIP's SimpleTokenizer (the ``clip==1.0`` dependency, vacnic.yml) is a
*word-level* byte-BPE with an explicit ``</w>`` end-of-word marker — unlike
GPT-2/BART's leading-space byte BPE (see `tokenize.BartBpeTokenizer`). The
pipeline is:

  1. text cleanup: ``ftfy.fix_text`` (identity on already-clean text; applied
     when ftfy is importable), ``html.unescape`` twice, strip;
  2. whitespace collapse to single spaces; lowercase;
  3. pretokenize with the CLIP pattern (case-insensitive):
     ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
     — note digits split ONE AT A TIME (``[\\p{N}]``), no leading-space
     convention;
  4. per pretoken: utf-8 bytes → unicode table, append ``</w>`` to the last
     symbol, greedy lowest-rank pair merges.

Vocab layout (OpenAI order; 49,408 entries for the shipped
``bpe_simple_vocab_16e6.txt.gz``): 256 byte symbols, 256 ``byte</w>``
symbols, one token per merge (48,894), then ``<|startoftext|>`` (49406) and
``<|endoftext|>`` (49407). ``<|endoftext|>`` doubles as pad-id 0's… no —
padding is literal 0 (the ``!`` token): ``clip.tokenize`` zero-pads to
context_length 77, and the reference collate pads ``caption_ids_clip`` with 0
(goodnews...py:95-99). HF ``CLIPTokenizer`` implements the same algorithm
from ``vocab.json`` + ``merges.txt``; both load paths are supported here.
"""

from __future__ import annotations

import gzip
import html
import json
import os
import re as _stdre

import numpy as np

from vacnic_tpu_torch.data.tokenize import _bytes_to_unicode

try:  # exact OpenAI pattern needs \p classes → `regex`
    import regex as _re

    _CLIP_SPLIT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # without `regex`: the same classes in the stdlib's syntax
    _CLIP_SPLIT = _stdre.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[_]|[^\s\w])+""",
        _stdre.IGNORECASE | _stdre.UNICODE,
    )

try:
    from ftfy import fix_text as _fix_text
except ImportError:  # ftfy absent: identity on clean text
    _fix_text = None

_WS = _stdre.compile(r"\s+")

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"
# merges slice used by BOTH openai/CLIP simple_tokenizer and HF CLIPTokenizer:
# lines [1 : 49152-256-2+1] of the merges file (skip the version header).
_MERGE_SLICE = slice(1, 49152 - 256 - 2 + 1)


def basic_clean(text: str) -> str:
    if _fix_text is not None:
        text = _fix_text(text)
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return _WS.sub(" ", text).strip()


class ClipBpeTokenizer:
    """OpenAI-CLIP byte-BPE. Construct via `from_openai_vocab` (the
    ``bpe_simple_vocab_16e6.txt.gz`` shipped with the `clip` package) or
    `from_hf_files` (``vocab.json`` + ``merges.txt`` beside any HF CLIP
    checkpoint). Exposes the duck-type the data layer consumes
    (``encode(text, max_length=...)``) plus `tokenize` matching
    ``clip.tokenize(texts, context_length=77, truncate=...)`` bit-for-bit.
    """

    def __init__(self, encoder: dict[str, int], bpe_ranks: dict[tuple[str, str], int]):
        self.encoder = encoder
        self.decoder = {v: k for k, v in encoder.items()}
        self.bpe_ranks = bpe_ranks
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: dict[str, str] = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}
        self.sot_token_id = encoder[SOT_TOKEN]
        self.eot_token_id = encoder[EOT_TOKEN]
        # data-layer duck-type aliases (datasets.py uses bos/eos-free encode;
        # collate pads with 0 like the reference, goodnews...py:95-99)
        self.bos_token_id = self.sot_token_id
        self.eos_token_id = self.eot_token_id
        self.pad_token_id = 0
        self.unk_token_id = self.eot_token_id  # HF CLIPTokenizer unk == eot

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_openai_vocab(cls, bpe_path: str) -> "ClipBpeTokenizer":
        """Load ``bpe_simple_vocab_16e6.txt.gz`` (or uncompressed) and build
        the vocab in OpenAI order: bytes, bytes</w>, merges, SOT, EOT."""
        if bpe_path.endswith(".gz"):
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
        else:
            with open(bpe_path, encoding="utf-8") as f:
                lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines[_MERGE_SLICE] if len(m.split()) == 2]
        base = list(_bytes_to_unicode().values())
        vocab = base + [v + "</w>" for v in base]
        vocab.extend("".join(m) for m in merges)
        vocab.extend([SOT_TOKEN, EOT_TOKEN])
        encoder = {tok: i for i, tok in enumerate(vocab)}
        ranks = {m: i for i, m in enumerate(merges)}
        return cls(encoder, ranks)

    @classmethod
    def from_hf_files(cls, vocab_file: str, merges_file: str) -> "ClipBpeTokenizer":
        """Load HF-format ``vocab.json`` + ``merges.txt`` (same algorithm,
        ids carried by the json)."""
        with open(vocab_file, encoding="utf-8") as f:
            encoder = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")
        merges = [tuple(m.split()) for m in lines[_MERGE_SLICE] if len(m.split()) == 2]
        ranks = {m: i for i, m in enumerate(merges)}
        return cls(encoder, ranks)

    @classmethod
    def from_dir(cls, path: str) -> "ClipBpeTokenizer":
        """Auto-detect: a dir with vocab.json/merges.txt, or a bpe .txt(.gz)."""
        if os.path.isdir(path):
            return cls.from_hf_files(
                os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt")
            )
        return cls.from_openai_vocab(path)

    def __len__(self) -> int:
        return len(self.encoder)

    # -- BPE core (word-level, </w> marker) -----------------------------------
    def _bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            self._cache[token] = word[0]
            return word[0]
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
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
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
        self._cache[token] = out
        return out

    def _encode_text(self, text: str) -> list[int]:
        text = whitespace_clean(basic_clean(text)).lower()
        ids: list[int] = []
        for token in _CLIP_SPLIT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder.get(t, self.eot_token_id) for t in self._bpe(token).split(" "))
        return ids

    # -- public API ------------------------------------------------------------
    def encode(self, text: str, max_length: int | None = None,
               add_special_tokens: bool = True) -> list[int]:
        """SOT + bpe ids + EOT; `truncate=True` semantics of clip.tokenize —
        cut to max_length keeping EOT as the final id."""
        ids = self._encode_text(text)
        if add_special_tokens:
            ids = [self.sot_token_id] + ids + [self.eot_token_id]
        if max_length is not None and len(ids) > max_length:
            ids = ids[:max_length]
            if add_special_tokens:
                ids[-1] = self.eot_token_id
        return ids

    def tokenize(self, texts, context_length: int = 77, truncate: bool = False) -> np.ndarray:
        """Bit-exact `clip.tokenize`: [N, context_length] int32, zero-padded;
        raises on overflow unless truncate (goodnews...py:628 passes True)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot_token_id] + self._encode_text(text) + [self.eot_token_id]
            if len(ids) > context_length:
                if not truncate:
                    raise RuntimeError(
                        f"Input {text!r} is too long for context length {context_length}")
                ids = ids[:context_length]
                ids[-1] = self.eot_token_id
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        """OpenAI decode: join token strings, byte-decode, '</w>' → space.
        ('<','/','w','>' are ASCII, so they survive the byte table intact.)"""
        ids = [int(i) for i in ids]
        if skip_special_tokens:
            # tokenize() zero-pads after EOT, but raw id 0 is also the
            # legitimate '!' byte symbol — only ids past the first EOT are
            # padding; inside the text, 0 must decode.
            if self.eot_token_id in ids:
                ids = ids[: ids.index(self.eot_token_id)]
            ids = [i for i in ids if i not in (self.sot_token_id, self.eot_token_id)]
        text = "".join(self.decoder.get(i, "") for i in ids)
        raw = bytearray(self.byte_decoder.get(c, 32) for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()
