"""ctypes bindings for the native (C++) WordPiece tokenizer.

The port's copy of ``crct_tpu/data/native.py``. ``csrc/wordpiece.cpp`` is
compiled by ``g++`` at first use into ``build/native/`` at the root of the
checkout, keyed by a hash of the source as ``ops/build.py`` keys the CUDA
kernels, and loaded with ``ctypes``. Nothing is built when the module is
imported. A build that fails raises: ``load_tokenizer`` falls back to the
pure-Python tokenizer only when the caller asks for it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

from crct_tpu_torch.ops.build import CSRC, source_digest

SRC = CSRC / "wordpiece.cpp"
BUILD_DIR = CSRC.parent.parent / "build" / "native"
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_lib_handle: Optional[ctypes.CDLL] = None


def build_library() -> Path:
    """Compile ``csrc/wordpiece.cpp`` unless a library of the same source is
    already built; return the library's path."""
    out = BUILD_DIR / f"libwordpiece-{source_digest(SRC)}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)     # atomic: a concurrent loader sees all or nothing
    return out


def _load() -> ctypes.CDLL:
    global _lib_handle
    with _LOCK:
        if _lib_handle is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.wp_create.restype = ctypes.c_void_p
            lib.wp_create.argtypes = [ctypes.c_char_p]
            lib.wp_destroy.restype = None
            lib.wp_destroy.argtypes = [ctypes.c_void_p]
            lib.wp_encode.restype = ctypes.c_int
            lib.wp_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.c_int]
            _lib_handle = lib
        return _lib_handle


class NativeWordPieceTokenizer:
    """C++-backed tokenizer with the part of ``WordPieceTokenizer``'s
    interface that the data pipeline uses: ``encode`` and the special
    ids."""

    MAX_IDS = 4096

    def __init__(self, vocab_file: str):
        if not os.path.isfile(vocab_file):
            raise FileNotFoundError(vocab_file)
        self._lib = _load()
        self._handle = self._lib.wp_create(vocab_file.encode())
        if not self._handle:
            raise FileNotFoundError(vocab_file)
        # special ids read from the vocab file directly
        vocab: Dict[str, int] = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                t = line.rstrip("\n").rstrip("\r")   # CRLF vocab parity
                if t:                                # with the C++ reader
                    vocab[t] = i
        self.cls_id = vocab.get("[CLS]", 101)
        self.sep_id = vocab.get("[SEP]", 102)
        self.mask_id = vocab.get("[MASK]", 103)
        self.pad_id = vocab.get("[PAD]", 0)
        self.unk_id = vocab.get("[UNK]", 100)
        self._buf = (ctypes.c_int32 * self.MAX_IDS)()
        self._buf_lock = threading.Lock()    # one shared output buffer

    def close(self) -> None:
        if self._handle:
            self._lib.wp_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()

    def encode(self, text: str) -> List[int]:
        with self._buf_lock:
            n = self._lib.wp_encode(self._handle, str(text).encode("utf-8"),
                                    self._buf, self.MAX_IDS)
            return list(self._buf[:n])


def write_vocab_file(vocab: Dict[str, int], path: str) -> str:
    """Serialize a vocab dict to the vocab.txt line format (id = line no.)."""
    inv = {v: k for k, v in vocab.items()}
    size = max(inv) + 1
    with open(path, "w", encoding="utf-8") as f:
        for i in range(size):
            f.write(inv.get(i, f"[unused_{i}]") + "\n")
    return path
