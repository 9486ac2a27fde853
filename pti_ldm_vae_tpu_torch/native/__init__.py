"""ctypes bindings for the native host data path (``ptidata.cpp``): TIFF
decode, area resize and mask z-score fused in C++ (counterpart of
``pti_ldm_vae_tpu/native/__init__.py``, same API).

``ptidata.cpp`` is the port's byte-for-byte copy of the JAX package's source.
It compiles at first use with the JAX package's exact flags,

    g++ -O3 -shared -fPIC -std=c++17

(no ``-march``, no ``-ffast-math``: the same source and flags give the JAX
native path's bits), into ``build/`` at the repository root (listed in
``.gitignore``) under a name hashed from the source text, so an edited source
never loads a stale library. The port never loads the JAX package's
``libptidata.so``.

A file the library does not parse (compressed, multi-sample, big-endian ...)
makes ``decode_tiff`` / ``preprocess_tiff`` return None, and the caller takes
the numpy path. A library that fails to build prints one warning to stderr and
leaves every file to the numpy path, so a broken build is never silent;
``decoded`` and ``python_path`` count the files each path took
(``count_path``; the data loader counts every file it preprocesses).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "preprocess_tiff", "decode_tiff", "build", "library_path",
           "count_path", "reset_counts"]

SOURCE = Path(__file__).resolve().parent / "ptidata.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

# files preprocessed by the library / by the numpy path since the last reset
decoded = 0
python_path = 0
_count_lock = threading.Lock()


def count_path(native: bool) -> None:
    """Count one file preprocessed by the library (``native``) or the numpy path."""
    global decoded, python_path
    with _count_lock:
        if native:
            decoded += 1
        else:
            python_path += 1


def reset_counts() -> None:
    global decoded, python_path
    with _count_lock:
        decoded = python_path = 0


def library_path() -> Path:
    """Where the library built from ``ptidata.cpp`` lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"ptidata_{digest}.so"


def build(force: bool = False) -> str | None:
    """Compile the shared library unless it exists; returns its path, or None
    when g++ is missing or fails (its message goes to stderr). Writes to a
    temporary name and renames, so a concurrent process never loads a
    half-written library."""
    out = library_path()
    if out.exists() and not force:
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"[WARN] native: cannot run g++ ({exc!r})", file=sys.stderr, flush=True)
        return None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        print(f"[WARN] native: g++ failed for {SOURCE}:\n{proc.stderr[-2000:]}", file=sys.stderr,
              flush=True)
        return None
    os.replace(tmp, out)
    return str(out)


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            print("[WARN] native: the TIFF library did not build; every file takes the numpy "
                  "path (slower, and up to ~5e-7 apart from the native bits)", file=sys.stderr,
                  flush=True)
            return None
        lib = ctypes.CDLL(path)
        lib.pti_tiff_probe.restype = ctypes.c_int
        lib.pti_tiff_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.pti_tiff_decode_f32.restype = ctypes.c_int
        lib.pti_tiff_decode_f32.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t,
        ]
        lib.pti_preprocess.restype = ctypes.c_int
        lib.pti_preprocess.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library built and loaded."""
    return _load() is not None


def decode_tiff(path: str) -> np.ndarray | None:
    """Native TIFF decode -> float32 [H, W]; None when unsupported."""
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as fh:
        buf = fh.read()
    h, w = ctypes.c_uint32(), ctypes.c_uint32()
    if lib.pti_tiff_probe(buf, len(buf), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    out = np.empty((h.value, w.value), dtype=np.float32)
    rc = lib.pti_tiff_decode_f32(buf, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                 out.size)
    return out if rc == 0 else None


def preprocess_tiff(path: str, patch_size: tuple[int, int]) -> np.ndarray | None:
    """Fused native decode + area resize + mask z-score -> [H, W, 1] f32;
    None when the file needs the numpy path."""
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as fh:
        buf = fh.read()
    h_out, w_out = int(patch_size[0]), int(patch_size[1])
    if h_out <= 0 or w_out <= 0:
        raise ValueError(f"patch size must be positive, got {patch_size}")
    out = np.empty((h_out, w_out), dtype=np.float32)
    rc = lib.pti_preprocess(buf, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            h_out, w_out)
    return out[..., None] if rc == 0 else None
