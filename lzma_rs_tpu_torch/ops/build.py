"""Build and load the port's CUDA libraries.

``nvcc`` compiles each library's main source (plain C interface, no
PyTorch headers: seconds, not minutes) into
``lzma_rs_tpu_torch/build/liblzl_<name>-<hash>.so``, where the hash covers
that library's own sources and the flags, so an edited source rebuilds its
library alone and an unchanged one loads at once. Eight libraries:

- ``segdec``: the segment decoder (``decode_segments.cu`` +
  ``segment_kernel.cuh`` + ``lzma_lane.cuh``), :func:`load`;
- ``segvar``: the decoder's variants (``decode_variants.cu`` over the same
  two headers), :func:`load_variants`;
- ``probes``: the lane2d and state-in-ref probe kernels (``probes.cu`` +
  ``probe_lane.cuh``), :func:`load_probes`;
- ``mosaic``: the mosaic probe kernels (``probes_mosaic.cu`` +
  ``probe_mosaic.cuh``), :func:`load_mosaic`;
- ``mosaic3``: the mosaic3 probe kernels (``probes_mosaic3.cu`` +
  ``probe_mosaic3.cuh``, which includes ``probe_mosaic.cuh``),
  :func:`load_mosaic3`;
- ``mosaic4``: the mosaic4 probe kernel (``probes_mosaic4.cu`` +
  ``probe_mosaic4.cuh`` + ``probe_mosaic.cuh``), :func:`load_mosaic4`;
- ``round4``: the round4 probe kernels (``probes_round4.cu`` +
  ``probe_round4.cuh`` + ``probe_mosaic.cuh``), :func:`load_round4`;
- ``bisect``: the bisect probe kernel (``probes_bisect.cu`` +
  ``probe_bisect.cuh`` + ``probe_lane.cuh``), :func:`load_bisect`.

Each is bound with ``ctypes``. Nothing here runs at import time; every
failure raises, except in :func:`unavailable`, which the ``auto`` router
asks before it picks the card.
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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Library:
    name: str       # the file is liblzl_<name>-<hash>.so
    sources: tuple  # files under csrc/ the hash covers; nvcc compiles the
                    # first, which includes the others


SEGDEC = Library("segdec", ("decode_segments.cu", "segment_kernel.cuh",
                            "lzma_lane.cuh"))
SEGVAR = Library("segvar", ("decode_variants.cu", "segment_kernel.cuh",
                            "lzma_lane.cuh"))
PROBES = Library("probes", ("probes.cu", "probe_lane.cuh"))
MOSAIC = Library("mosaic", ("probes_mosaic.cu", "probe_mosaic.cuh"))
MOSAIC3 = Library("mosaic3", ("probes_mosaic3.cu", "probe_mosaic3.cuh",
                              "probe_mosaic.cuh"))
MOSAIC4 = Library("mosaic4", ("probes_mosaic4.cu", "probe_mosaic4.cuh",
                              "probe_mosaic.cuh"))
ROUND4 = Library("round4", ("probes_round4.cu", "probe_round4.cuh",
                            "probe_mosaic.cuh"))
BISECT = Library("bisect", ("probes_bisect.cu", "probe_bisect.cuh",
                            "probe_lane.cuh"))
LIBRARIES = (SEGDEC, SEGVAR, PROBES, MOSAIC, MOSAIC3, MOSAIC4, ROUND4, BISECT)


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
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "build on a machine with the CUDA toolkit"
    )


def source_hash(lib: Library, csrc: str = CSRC) -> str:
    """The hash of ``lib``'s own sources (read from ``csrc``) and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in lib.sources:
        with open(os.path.join(csrc, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build_library(lib: Library = SEGDEC) -> BuildResult:
    """Compile ``lib`` unless this source hash is already built."""
    path = os.path.join(BUILD_DIR, f"liblzl_{lib.name}-{source_hash(lib)}.so")
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
             os.path.join(CSRC, lib.sources[0])],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {lib.sources[0]} ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return BuildResult(path, time.perf_counter() - t0,
                       proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=1)
def unavailable() -> Optional[str]:
    """None once the decoder library is loaded; else the first line of why
    it cannot be built or loaded here. The verdict holds for the process,
    so the ``auto`` router pays for a failed build once."""
    try:
        load()
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        return str(e).splitlines()[0] if str(e) else type(e).__name__
    return None


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build (if needed) and bind the segment decoder; one handle per
    process."""
    lib = ctypes.CDLL(build_library(SEGDEC).path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lzl_decode_segments.restype = ci
    lib.lzl_decode_segments.argtypes = [vp] * 11 + [ci] * 7 + [vp]
    lib.lzl_decoder_occupancy.restype = ci
    lib.lzl_decoder_occupancy.argtypes = [ci, vp]
    lib.lzl_error_string.restype = ctypes.c_char_p
    lib.lzl_error_string.argtypes = [ci]
    return lib


@functools.lru_cache(maxsize=1)
def load_variants() -> ctypes.CDLL:
    """Build (if needed) and bind the decoder's variants; one handle per
    process."""
    lib = ctypes.CDLL(build_library(SEGVAR).path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lzl_decode_variant.restype = ci
    lib.lzl_decode_variant.argtypes = [ci] + [vp] * 12 + [ci] * 8 + [vp]
    lib.lzl_variant_occupancy.restype = ci
    lib.lzl_variant_occupancy.argtypes = [ci, ci, vp]
    lib.lzl_variant_error_string.restype = ctypes.c_char_p
    lib.lzl_variant_error_string.argtypes = [ci]
    return lib


def bind_probes(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the probe library's C interface on ``lib``: the nvcc build,
    or a g++ build of ``probe_lane.cuh`` with ``-DLZP_HOST_ENTRY``, which
    exports the same functions."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn, args in (
        (lib.lzp_tinyops, [vp, vp, ci, ci, vp]),
        (lib.lzp_bitdecode, [ci, ci, vp, vp, vp, vp, vp, ci, ci, vp]),
        (lib.lzp_realweight, [vp, vp, vp, ci, ci, ci, vp]),
    ):
        fn.restype, fn.argtypes = ci, args
    lib.lzp_error_string.restype = ctypes.c_char_p
    lib.lzp_error_string.argtypes = [ci]
    return lib


@functools.lru_cache(maxsize=1)
def load_probes() -> ctypes.CDLL:
    """Build (if needed) and bind the probe kernels; one handle per
    process."""
    return bind_probes(ctypes.CDLL(build_library(PROBES).path))


def bind_mosaic(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the mosaic library's C interface on ``lib``: the nvcc build,
    or a g++ build of ``probe_mosaic.cuh`` with ``-DLZP_HOST_ENTRY``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn, args in (
        (lib.lzm_gather_sum, [ci, ci, vp, ci, ci, vp, ci, ci, vp, ci, ci, ci,
                              vp]),
        (lib.lzm_rw_chain, [ci, vp, ci, ci, vp, vp, ci, vp]),
        (lib.lzm_row_chain, [ci, vp, ci, ci, vp, ci, vp]),
        (lib.lzm_segment_chain, [ci, vp, ci, ci, vp, ci, vp]),
    ):
        fn.restype, fn.argtypes = ci, args
    lib.lzm_error_string.restype = ctypes.c_char_p
    lib.lzm_error_string.argtypes = [ci]
    return lib


@functools.lru_cache(maxsize=1)
def load_mosaic() -> ctypes.CDLL:
    """Build (if needed) and bind the mosaic probe kernels; one handle per
    process."""
    return bind_mosaic(ctypes.CDLL(build_library(MOSAIC).path))


def bind_mosaic3(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the mosaic3 library's C interface on ``lib``: the nvcc
    build, or a g++ build of ``probe_mosaic3.cuh`` with
    ``-DLZP_HOST_ENTRY``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn, args in (
        (lib.lzm3_vote_chain, [ci, vp, ci, vp, vp, ci, vp]),
        (lib.lzm3_byte_chain, [ci, vp, ci, vp, ci, vp]),
        (lib.lzm3_onehot_chain, [ci, ci, vp, ci, ci, vp, ci, vp]),
        (lib.lzm3_window_chain, [ci, vp, ci, ci, vp, vp, ci, vp]),
    ):
        fn.restype, fn.argtypes = ci, args
    lib.lzm3_error_string.restype = ctypes.c_char_p
    lib.lzm3_error_string.argtypes = [ci]
    return lib


@functools.lru_cache(maxsize=1)
def load_mosaic3() -> ctypes.CDLL:
    """Build (if needed) and bind the mosaic3 probe kernels; one handle per
    process."""
    return bind_mosaic3(ctypes.CDLL(build_library(MOSAIC3).path))


def bind_mosaic4(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the mosaic4 library's C interface on ``lib``: the nvcc
    build, or a g++ build of ``probe_mosaic4.cuh`` with
    ``-DLZP_HOST_ENTRY``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lzm4_table_chain.restype = ci
    lib.lzm4_table_chain.argtypes = [ci, vp, ci] + [vp] * 5 + [ci, vp]
    lib.lzm4_error_string.restype = ctypes.c_char_p
    lib.lzm4_error_string.argtypes = [ci]
    return lib


@functools.lru_cache(maxsize=1)
def load_mosaic4() -> ctypes.CDLL:
    """Build (if needed) and bind the mosaic4 probe kernel; one handle per
    process."""
    return bind_mosaic4(ctypes.CDLL(build_library(MOSAIC4).path))


def bind_round4(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the round4 library's C interface on ``lib``: the nvcc
    build, or a g++ build of ``probe_round4.cuh`` with
    ``-DLZP_HOST_ENTRY``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn, args in (
        (lib.lzr4_select_chain, [ci, ci, ci, vp, ci, ci, ci, vp, vp, ci,
                                 vp]),
        (lib.lzr4_blend_chain, [ci, ci, vp, ci, ci, vp, vp, ci, vp]),
    ):
        fn.restype, fn.argtypes = ci, args
    lib.lzr4_error_string.restype = ctypes.c_char_p
    lib.lzr4_error_string.argtypes = [ci]
    return lib


@functools.lru_cache(maxsize=1)
def load_round4() -> ctypes.CDLL:
    """Build (if needed) and bind the round4 probe kernels; one handle per
    process."""
    return bind_round4(ctypes.CDLL(build_library(ROUND4).path))


def bind_bisect(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the bisect library's C interface on ``lib``: the nvcc
    build, or a g++ build of ``probe_bisect.cuh`` with
    ``-DLZP_HOST_ENTRY``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lzb_bisect.restype = ci
    lib.lzb_bisect.argtypes = [ci] + [vp] * 4 + [ci, ci, vp]
    lib.lzb_error_string.restype = ctypes.c_char_p
    lib.lzb_error_string.argtypes = [ci]
    return lib


@functools.lru_cache(maxsize=1)
def load_bisect() -> ctypes.CDLL:
    """Build (if needed) and bind the bisect probe kernel; one handle per
    process."""
    return bind_bisect(ctypes.CDLL(build_library(BISECT).path))
