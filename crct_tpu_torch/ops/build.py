"""Build and load the port's CUDA kernels.

Each ``crct_tpu_torch/csrc/<name>.cu`` exposes a plain ``extern "C"``
entry. At first use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library under ``build/kernels/`` at the root of the checkout,
keyed by a hash of the source and of every ``csrc/*.cuh`` header it
includes, and loaded with ``ctypes``. Nothing is built when a module is imported: this runs inside the
first launch, or ahead of it through :func:`build`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
# what the last build of each kernel reported: (seconds, compiler output)
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME`` or from PyTorch's idea of the CUDA home."""
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME
    if not home:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME to the "
                           "directory that holds bin/nvcc")
    nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_digest(src: Path) -> str:
    """Hash of ``src`` and of the local headers it includes, transitively,
    so that an edit to a shared header rebuilds every kernel that uses it."""
    h = hashlib.sha256()
    seen, todo = set(), [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text)
        todo.extend(path.parent / inc.decode()
                    for inc in _INCLUDE.findall(text))
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    headers is already built; return the library's path."""
    src = CSRC / f"{name}.cu"
    digest = source_digest(src)
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)     # atomic: a concurrent loader sees all or nothing
    BUILD_LOG[name] = (time.perf_counter() - t0, log)
    return out


def compiler_report(name: str) -> str:
    """What nvcc (with ``-Xptxas -v``: registers, spills, shared memory of
    each kernel) reported when it built the library of ``csrc/<name>.cu``
    that :func:`build` returns, also when that build was an earlier
    process's."""
    return build(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LOADED[name] = lib
        return lib

