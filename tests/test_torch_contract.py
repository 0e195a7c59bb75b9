"""Contract of the port: it imports neither jax nor vacnic_tpu, its entry
point refuses to run silently on the CPU, and chip_smoke.py fails where
there is no GPU or no package beside it."""

import os
import shutil
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

IMPORT_ALL = r"""
import importlib, pkgutil, runpy, sys
import vacnic_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vacnic_tpu_torch.__path__, "vacnic_tpu_torch.")]
for n in names:
    importlib.import_module(n)
runpy.run_path("chip_smoke.py", run_name="chip_smoke_imported")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "vacnic_tpu"
             or m.startswith("vacnic_tpu."))
print("MODULES", len(names))
print("NAMES", " ".join(names))
print("BAD", bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n = int(out.stdout.split("MODULES")[1].split()[0])
    assert n >= 20  # every subpackage's modules were walked
    walked = set(out.stdout.split("NAMES")[1].split())
    assert {"vacnic_tpu_torch.cli", "vacnic_tpu_torch.convert_checkpoint",
            "vacnic_tpu_torch.core.profiling", "vacnic_tpu_torch.lmm.prompting",
            "vacnic_tpu_torch.data.preprocess.clip_retrieval"} <= walked


def test_generate_mm_needs_explicit_cpu():
    """Every entry point: generate_mm, generate_text_bart, greedy_search,
    get_prob and mm_forward."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from vacnic_tpu_torch.core.config import VacnicConfig
    from vacnic_tpu_torch.infer.generate import (generate_mm, generate_text_bart, get_prob,
                                                 greedy_search, resolve_device)
    from vacnic_tpu_torch.models.fusion import mm_forward

    cfg = VacnicConfig.tiny()
    ids = torch.ones(1, 4, dtype=torch.int64)
    img = torch.zeros(1, 32)
    for call in (lambda: generate_mm({}, ids, ids, img, cfg.bart, cfg.fusion, cfg.decode),
                 lambda: generate_text_bart({}, ids, ids, cfg.bart, cfg.decode),
                 lambda: greedy_search({}, ids, ids, cfg.bart, cfg.decode),
                 lambda: get_prob({}, ids, ids, ids, ids, cfg.bart),
                 lambda: mm_forward({}, ids, ids, ids, img, cfg.bart, cfg.fusion)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_kernel_build_refuses_without_nvcc(monkeypatch, tmp_path):
    """Without a CUDA toolkit the build raises instead of falling back."""
    from vacnic_tpu_torch.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACKS", ())
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "missing.so")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    names = {p.name for p in _build._sources()}
    assert names == {"gemm_bf16.cu", "layernorm.cu", "enc_attention.cu", "dec_attention.cu",
                     "dec_cross_attention.cu", "flash_attn.cu", "lm_head.cu"}


def test_library_built_once_from_two_threads(monkeypatch, tmp_path):
    """Two threads that reach lib() first (a service's batcher and a
    caller's precompile) get one build and one CDLL: the second waits for
    the first's build under the module's lock."""
    from vacnic_tpu_torch.kernels import _build

    calls = {"build": 0, "cdll": 0}
    gate = threading.Event()

    def slow_build():
        calls["build"] += 1
        gate.wait(5)  # hold the first build while the second thread arrives
        return tmp_path / "libvacnic_kernels_stub.so"

    def fake_cdll(path):
        calls["cdll"] += 1
        return types.SimpleNamespace(**{name: types.SimpleNamespace()
                                        for name in _build.SIGNATURES})

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    got = []
    threads = [threading.Thread(target=lambda: got.append(_build.lib())) for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    gate.set()
    for t in threads:
        t.join(timeout=10)
    assert calls == {"build": 1, "cdll": 1}
    assert len(got) == 2 and got[0] is got[1]
    assert got[0].vt_gemm_bf16.restype is _build.ctypes.c_int


def test_library_path_follows_headers(monkeypatch, tmp_path):
    """The library is named by a hash of the sources and of the headers they
    include: an edited attn_tiles.cuh gives a new path, hence a rebuild."""
    from vacnic_tpu_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert (csrc / "attn_tiles.cuh").exists()
    original = _build.library_path()
    monkeypatch.setattr(_build, "CSRC", csrc)
    same = _build.library_path()
    assert same.name == original.name  # the copy hashes like the original
    with open(csrc / "attn_tiles.cuh", "a") as f:
        f.write("// edited\n")
    after_header = _build.library_path()
    assert after_header.name != same.name
    with open(csrc / "flash_attn.cu", "a") as f:
        f.write("// edited\n")
    assert _build.library_path().name not in (same.name, after_header.name)


def test_flash_wrapper_checks_row_alignment():
    """The kernel copies rows in 16-byte pieces; the wrapper's stride helper
    refuses rows that start elsewhere, and a strided last dimension."""
    from vacnic_tpu_torch.kernels import flash_attn as FA

    assert FA._strides(torch.zeros(2, 1, 64, 64), "bias") == [64 * 64, 0, 64]
    assert FA._strides(torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16), "bias") == [0, 0, 64]
    with pytest.raises(ValueError, match="16-byte"):
        FA._strides(torch.zeros(1, 1, 64, 66)[..., :64], "bias")     # row stride 66 floats
    with pytest.raises(ValueError, match="16-byte"):
        FA._strides(torch.zeros(1, 1, 64, 68)[..., 1:65], "bias")   # base 4 bytes off
    with pytest.raises(ValueError, match="contiguous"):
        FA._strides(torch.zeros(1, 1, 64, 128)[..., ::2], "bias")
