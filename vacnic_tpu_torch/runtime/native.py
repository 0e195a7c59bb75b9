"""Native runtime bindings (port of vacnic_tpu/runtime/native.py): the C BPE
merge loop (fastbpe.c, the port's own copy) built with the system compiler
at first use and bound through ctypes. No pip, no pybind11, no PyTorch
headers; every entry point has a pure-Python fallback in data/tokenize.py.

Differences from JAX, by design:
- the cache directory is the port's own (`VACNIC_TORCH_NATIVE_CACHE`, else
  `vacnic_torch_native_{uid}` under the temporary directory);
- the library is compiled to a name of its own process and thread and moved
  into place with `os.replace`, so a second process never loads a file
  that is still being written (JAX compiles straight to the final path).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "fastbpe.c")
_LIB = None
_TRIED = False
_LOCK = threading.Lock()
COMPILERS = ("cc", "gcc", "clang")


def _build_dir() -> str:
    d = os.environ.get("VACNIC_TORCH_NATIVE_CACHE") or os.path.join(
        tempfile.gettempdir(), f"vacnic_torch_native_{os.getuid()}")
    os.makedirs(d, exist_ok=True)
    return d


def library_path() -> str:
    """Where the shared object for this fastbpe.c lives (named by its hash)."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_build_dir(), f"libfastbpe_{tag}.so")


def build(so_path: str) -> bool:
    """Compile fastbpe.c to `so_path` atomically: to a temporary name first,
    then `os.replace`. False when no compiler builds it."""
    tmp = f"{so_path}.tmp{os.getpid()}_{threading.get_ident()}"
    try:
        for cc in COMPILERS:
            try:
                subprocess.run([cc, "-O2", "-shared", "-fPIC", _SRC, "-o", tmp],
                               check=True, capture_output=True, timeout=60)
            except (FileNotFoundError, subprocess.CalledProcessError,
                    subprocess.TimeoutExpired):
                continue
            os.replace(tmp, so_path)
            return True
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_fastbpe():
    """Return the ctypes lib or None (no compiler / build failure)."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            so_path = library_path()
            if not os.path.exists(so_path) and not build(so_path):
                return None
            lib = ctypes.CDLL(so_path)
            lib.bpe_encode_batch.restype = ctypes.c_int
            lib.bpe_encode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_int32),  # syms
                ctypes.POINTER(ctypes.c_int64),  # offsets
                ctypes.POINTER(ctypes.c_int32),  # out_lens
                ctypes.c_int64,  # n_words
                ctypes.POINTER(ctypes.c_uint64),  # keys
                ctypes.POINTER(ctypes.c_int32),  # ranks
                ctypes.POINTER(ctypes.c_int32),  # merged
                ctypes.c_int64,  # n_table
            ]
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


class FastBpe:
    """Native BPE merge engine over a (keys, ranks, merged) table."""

    def __init__(self, pair_keys: np.ndarray, ranks: np.ndarray, merged: np.ndarray):
        order = np.argsort(pair_keys)
        self.keys = np.ascontiguousarray(pair_keys[order], np.uint64)
        self.ranks = np.ascontiguousarray(ranks[order], np.int32)
        self.merged = np.ascontiguousarray(merged[order], np.int32)
        self.lib = load_fastbpe()

    @property
    def available(self) -> bool:
        return self.lib is not None

    def encode_words(self, words: list[list[int]]) -> list[list[int]]:
        """Apply the merge loop to each word's initial symbol ids."""
        if not words:
            return []
        offsets = np.zeros(len(words) + 1, np.int64)
        np.cumsum([len(w) for w in words], out=offsets[1:])
        syms = np.fromiter((s for w in words for s in w), np.int32, int(offsets[-1]))
        out_lens = np.zeros(len(words), np.int32)
        self.lib.bpe_encode_batch(
            syms.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(words),
            self.keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            self.ranks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.merged.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(self.keys),
        )
        return [syms[offsets[i]: offsets[i] + int(out_lens[i])].tolist()
                for i in range(len(words))]
