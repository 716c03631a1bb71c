"""Build the port's CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/*.cu`` source has a plain C interface.  It is compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/`` at the
repository root (listed in ``.gitignore``), named by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing is compiled when a module is imported: the CPU tests import every
module on a host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# after the source: flash_attention.cu finds cuTensorMapEncodeTiled with dlsym
LINK_FLAGS = ("-ldl",)

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_INFO: dict = {}     # source name -> {"seconds", "cached", "ptxas"}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a host "
                       "with the CUDA toolkit")


def _ptxas_summary(log: str) -> list:
    """One entry per compiled kernel: registers, shared memory, spills."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
            out.append({"kernel": name, "spill_stores": spills[0],
                        "spill_loads": spills[1]})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and out and out[-1]["kernel"] == name:
            out[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[-1]["smem_static"] = int(sm.group(1)) if sm else 0
    return out


def build(source: str) -> str:
    """Compile ``csrc/<source>`` (if not built yet) and return the library path."""
    src = CSRC / source
    text = src.read_bytes()
    flags = " ".join(NVCC_FLAGS + LINK_FLAGS).encode()
    tag = hashlib.sha256(text + flags).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{src.stem}-{tag}.so"
    if lib.exists():
        BUILD_INFO.setdefault(source, {"seconds": 0.0, "cached": True, "ptxas": []})
        return str(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src), *LINK_FLAGS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr[-8000:]}")
    os.replace(tmp, lib)
    BUILD_INFO[source] = {"seconds": time.perf_counter() - t0, "cached": False,
                          "ptxas": _ptxas_summary(proc.stderr + proc.stdout)}
    return str(lib)


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<source>``, built at first use."""
    with _LOCK:
        if source not in _LIBS:
            _LIBS[source] = ctypes.CDLL(build(source))
        return _LIBS[source]
