"""Builds the port's CUDA kernels and binds them with ctypes.

Each source under ``csrc/`` compiles with ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
Sources build in parallel, one ``nvcc`` each, at first use. Libraries are
cached by the hash of the sources and flags in the build directory:
``$REPRO_TORCH_BUILD_DIR`` or ``build/kernels`` at the root of the checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("dom_release", "dom_admit", "flash_attention", "ssd_scan",
           "inchash")
TILE = 2048     # elements per tile block, `TILE` in csrc/common.cuh
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(extra_flags: tuple[str, ...] = ()) -> dict[str, float]:
    """Compile every source missing from the cache, all in parallel.

    Returns each compiled source's wall seconds (empty when all were
    cached). ``extra_flags`` (e.g. ``("-Xptxas=-v",)``) only apply to
    sources compiled by this call; their output is printed."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not _library_path(n).exists()]
    if not todo:
        return {}
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        target = _library_path(name)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    seconds: dict[str, float] = {}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        if extra_flags and log:
            print(f"[nvcc {name}]\n{log}", end="")
        tmp.replace(target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def bind(lib: ctypes.CDLL, name: str, argtypes: list):
    """``lib``'s function ``name``, its argtypes and int restype set on
    first use (ctypes keeps the function object on the library)."""
    fn = getattr(lib, name)
    if getattr(fn, "argtypes", None) is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(lib: ctypes.CDLL, kernel: str, code: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({code})")


__all__ = ["CSRC", "SOURCES", "TILE", "bind", "build_all", "build_dir",
           "library", "check"]
