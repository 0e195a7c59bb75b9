"""Build and load the port's CUDA kernels (kernels/csrc/*.cu, headers *.cuh).

Each source is compiled by its own `nvcc` process, all started together,
for sm_90a (`-gencode arch=compute_90a,code=sm_90a -O3`, position
independent), and the objects are linked into one shared library with a
plain C interface that ctypes loads. Pointers and the stream travel as
ctypes.c_void_p; every entry point returns cudaGetLastError(), which the
wrappers raise on. The library lands in kernels/build/ (listed in
.gitignore), named by a hash of the sources, headers and flags, so an edited
source or header is rebuilt. A failed build raises; nothing falls back.

Run `python -m vacnic_tpu_torch.kernels._build` to build ahead of use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point -> argument types (all return int: a cudaError_t)
SIGNATURES = {
    "vt_gemm_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "vt_gemm_smem_bytes": [_I, _I],  # returns bytes, not an error code
    "vt_layernorm": [_P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
    "vt_enc_self_attention": [_P, _P, _P, _I, _I, _I, _F, _P],
    "vt_enc_cross_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "vt_dec_self_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "vt_dec_cross_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "vt_lm_stats": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "vt_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "vt_attn_tile_check": [_P, _P, _P, _P, _P, _P],
}

NVCC_FALLBACKS = ("/usr/local/cuda/bin/nvcc",)  # the toolkit's usual home
_LIB = None
BUILD_LOG: list[str] = []  # nvcc's output of the last build (-Xptxas -v lines)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), *NVCC_FALLBACKS):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA "
                       "toolkit is installed")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Named by a hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvacnic_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every source in parallel and link the library; returns its
    path. Raises RuntimeError with nvcc's output on any failure."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = out.stem.rsplit("_", 1)[-1]
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    failed = []
    objs = []
    for src, obj, p in procs:
        log, _ = p.communicate()
        BUILD_LOG.append(f"== {src.name}\n{log}")
        if p.returncode != 0:
            failed.append(f"{src.name} (rc {p.returncode}):\n{log}")
        objs.append(str(obj))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", *objs, "-ldl", "-o", str(tmp)],  # dlsym in gemm_bf16
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"CUDA kernel link failed:\n{link.stdout}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


if __name__ == "__main__":
    print(build())
    print("\n".join(BUILD_LOG))
