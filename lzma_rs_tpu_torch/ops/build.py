"""Build and load the CUDA segment-decoder library.

``nvcc`` compiles ``csrc/decode_segments.cu`` (plain C interface, no
PyTorch headers: seconds, not minutes) into
``lzma_rs_tpu_torch/build/liblzl_segdec-<hash>.so``, where the hash covers
the sources and the flags, so an edited source rebuilds and an unchanged one
loads at once. The library is bound with ``ctypes``. Nothing here runs at
import time; every failure raises, except in :func:`unavailable`, which
the ``auto`` router asks before it picks the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("decode_segments.cu", "lzma_lane.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: str
    seconds: float  # 0.0 when the cached library was reused
    log: str        # nvcc/ptxas output (registers, spills) of a fresh build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA segment "
        "decoder builds on a machine with the CUDA toolkit"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build_library() -> BuildResult:
    """Compile the library unless this source hash is already built."""
    path = os.path.join(BUILD_DIR, f"liblzl_segdec-{_source_hash()}.so")
    if os.path.exists(path):
        return BuildResult(path, 0.0, "")
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp,
             os.path.join(CSRC, "decode_segments.cu")],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return BuildResult(path, time.perf_counter() - t0,
                       proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=1)
def unavailable() -> Optional[str]:
    """None once the library is loaded; else the first line of why it
    cannot be built or loaded here. The verdict holds for the process, so
    the ``auto`` router pays for a failed build once."""
    try:
        load()
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        return str(e).splitlines()[0] if str(e) else type(e).__name__
    return None


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build (if needed) and bind the library; one handle per process."""
    lib = ctypes.CDLL(build_library().path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lzl_decode_segments.restype = ci
    lib.lzl_decode_segments.argtypes = [vp] * 11 + [ci] * 7 + [vp]
    lib.lzl_error_string.restype = ctypes.c_char_p
    lib.lzl_error_string.argtypes = [ci]
    return lib
