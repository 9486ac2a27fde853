"""Build and load the CUDA C++ kernels of ``csrc/`` (nvcc -> shared library -> ctypes).

Each source compiles on first use into ``build/`` at the repository root
(listed in ``.gitignore``) with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into a library named after the source and a hash of its text and of the text
of every header of ``csrc/`` it includes (``#include "name.cuh"``, followed
through nested includes), so an edited source or header never loads a stale
library. The library exposes plain C functions
(no PyTorch headers: a build takes seconds, not minutes). ``ptxas``'s
register / shared-memory report is kept beside the library in ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "source_files", "library_path", "build", "build_all", "load"]

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def source_files(source: str) -> list[Path]:
    """``csrc/<source>`` and, in the order met, every file of ``csrc/`` it
    includes with quotes, directly or through another such file."""
    found: list[Path] = []
    todo = [CSRC_DIR / source]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            if (CSRC_DIR / name).is_file():
                todo.append(CSRC_DIR / name)
    return found


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    digest = hashlib.sha256()
    for path in source_files(source):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}_{digest.hexdigest()[:12]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library exists; returns the path.

    Writes to a temporary name and renames, so a concurrent process never sees
    a half-written library."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def build_all(sources: tuple[str, ...] | list[str]) -> list[Path]:
    """Compile several sources at once, one nvcc process each; returns their paths."""
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return list(pool.map(build, sources))


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<source>`` once per process."""
    with _lock:
        if source not in _loaded:
            _loaded[source] = ctypes.CDLL(str(build(source)))
        return _loaded[source]
