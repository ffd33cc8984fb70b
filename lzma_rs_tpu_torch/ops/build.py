"""Build and load the port's CUDA libraries.

``nvcc`` compiles each library's main source (plain C interface, no
PyTorch headers: seconds, not minutes) into
``lzma_rs_tpu_torch/build/liblzl_<name>-<hash>.so``, where the hash covers
that library's own sources and the flags, so an edited source rebuilds its
library alone and an unchanged one loads at once. Eleven libraries:

- ``segdec``: the segment decoder (``decode_segments.cu`` +
  ``segment_kernel.cuh`` + ``lzma_lane.cuh``), :func:`load`;
- ``segvar``: the decoder's variants (``decode_variants.cu`` over the same
  two headers), :func:`load_variants`;
- ``probes``: the lane2d and state-in-ref probe kernels (``probes.cu`` +
  ``probe_lane.cuh`` + ``kernel_attributes.cuh``), :func:`load_probes`;
- ``mosaic``: the mosaic probe kernels (``probes_mosaic.cu`` +
  ``probe_mosaic.cuh``, which includes ``probe_stage.cuh``, +
  ``kernel_attributes.cuh``), :func:`load_mosaic`;
- ``mosaic3``: the mosaic3 probe kernels (``probes_mosaic3.cu`` +
  ``probe_mosaic3.cuh``, which includes ``probe_mosaic.cuh`` and
  ``probe_stage.cuh``, + ``kernel_attributes.cuh``), :func:`load_mosaic3`;
- ``mosaic4``: the mosaic4 probe kernel (``probes_mosaic4.cu`` +
  ``probe_mosaic4.cuh`` + ``probe_mosaic.cuh`` + ``probe_stage.cuh`` +
  ``kernel_attributes.cuh``), :func:`load_mosaic4`;
- ``round4``: the round4 probe kernels (``probes_round4.cu`` +
  ``probe_round4.cuh`` + ``probe_mosaic.cuh`` + ``probe_stage.cuh`` +
  ``kernel_attributes.cuh``), :func:`load_round4`;
- ``bisect``: the bisect probe kernel (``probes_bisect.cu`` +
  ``probe_bisect.cuh`` + ``probe_lane.cuh`` + ``kernel_attributes.cuh``),
  :func:`load_bisect`;
- ``stepcost``: the decoder's step-cost builds (``step_cost.cu`` over
  ``segment_kernel.cuh`` + ``lzma_lane.cuh``), :func:`load_step_cost`;
- ``lanedec``: the lane engine (``decode_lanes.cu`` + ``lane_engine.cuh`` +
  ``lzma_lane.cuh``), :func:`load_lanes`;
- ``crc``: the device CRC (``crc_blocks.cu`` + ``crc_kernel.cuh``),
  :func:`load_crc`.

Each is bound with ``ctypes``. :func:`load_host` builds the per-lane code
of the decoder and of the lane engine (``lane_engine.cuh``, which includes
``lzma_lane.cuh``) for the host with g++ instead, a test aid that runs the
kernels' logic without a card; :func:`load_crc_host` does the same for
``crc_kernel.cuh``. Nothing here runs at import
time; every failure raises, except in :func:`unavailable`, which the
``auto`` router asks before it picks the card.
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
PROBES = Library("probes", ("probes.cu", "probe_lane.cuh",
                            "kernel_attributes.cuh"))
MOSAIC = Library("mosaic", ("probes_mosaic.cu", "probe_mosaic.cuh",
                            "probe_stage.cuh", "kernel_attributes.cuh"))
MOSAIC3 = Library("mosaic3", ("probes_mosaic3.cu", "probe_mosaic3.cuh",
                              "probe_mosaic.cuh", "probe_stage.cuh",
                              "kernel_attributes.cuh"))
MOSAIC4 = Library("mosaic4", ("probes_mosaic4.cu", "probe_mosaic4.cuh",
                              "probe_mosaic.cuh", "probe_stage.cuh",
                              "kernel_attributes.cuh"))
ROUND4 = Library("round4", ("probes_round4.cu", "probe_round4.cuh",
                            "probe_mosaic.cuh", "probe_stage.cuh",
                            "kernel_attributes.cuh"))
BISECT = Library("bisect", ("probes_bisect.cu", "probe_bisect.cuh",
                            "probe_lane.cuh", "kernel_attributes.cuh"))
STEPCOST = Library("stepcost", ("step_cost.cu", "segment_kernel.cuh",
                                "lzma_lane.cuh"))
LANEDEC = Library("lanedec", ("decode_lanes.cu", "lane_engine.cuh",
                              "lzma_lane.cuh"))
CRC = Library("crc", ("crc_blocks.cu", "crc_kernel.cuh"))
LIBRARIES = (SEGDEC, SEGVAR, PROBES, MOSAIC, MOSAIC3, MOSAIC4, ROUND4, BISECT,
             STEPCOST, LANEDEC, CRC)


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
    t0 = time.perf_counter()
    log = _compile([_nvcc(), *NVCC_FLAGS], lib.sources[0], path)
    return BuildResult(path, time.perf_counter() - t0, log)


def _compile(command: list, source: str, path: str) -> str:
    """Compile ``csrc/<source>`` with ``command`` into ``path``, through a
    temporary file in the build directory; returns the compiler's
    output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [*command, "-o", tmp, os.path.join(CSRC, source)],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(command[0])} failed on {source} "
                f"({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stdout + proc.stderr


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
def load_step_cost() -> ctypes.CDLL:
    """Build (if needed) and bind the decoder's step-cost builds; one
    handle per process."""
    lib = ctypes.CDLL(build_library(STEPCOST).path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lzl_decode_ablated.restype = ci
    lib.lzl_decode_ablated.argtypes = [ci] + [vp] * 12 + [ci] * 7 + [vp]
    lib.lzl_ablated_occupancy.restype = ci
    lib.lzl_ablated_occupancy.argtypes = [ci, ci, vp]
    lib.lzl_ablated_error_string.restype = ctypes.c_char_p
    lib.lzl_ablated_error_string.argtypes = [ci]
    return lib


@functools.lru_cache(maxsize=1)
def load_lanes() -> ctypes.CDLL:
    """Build (if needed) and bind the lane engine; one handle per
    process."""
    lib = ctypes.CDLL(build_library(LANEDEC).path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lzl_decode_lanes.restype = ci
    lib.lzl_decode_lanes.argtypes = ([vp] * 17 + [ci] * 4
                                     + [ctypes.c_longlong, ci, vp])
    lib.lzl_lanes_smem_bytes.restype = ci
    lib.lzl_lanes_smem_bytes.argtypes = []
    lib.lzl_lanes_occupancy.restype = ci
    lib.lzl_lanes_occupancy.argtypes = [ci, vp]
    lib.lzl_lanes_error_string.restype = ctypes.c_char_p
    lib.lzl_lanes_error_string.argtypes = [ci]
    return lib


@functools.lru_cache(maxsize=1)
def load_crc() -> ctypes.CDLL:
    """Build (if needed) and bind the device CRC; one handle per
    process."""
    lib = ctypes.CDLL(build_library(CRC).path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lzc_crc_blocks.restype = ci
    lib.lzc_crc_blocks.argtypes = [ci, vp, ci, vp, vp, ci, vp, vp]
    lib.lzc_error_string.restype = ctypes.c_char_p
    lib.lzc_error_string.argtypes = [ci]
    return lib


HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall",
              "-Werror", "-DLZL_HOST_ENTRY")
CRC_HOST_FLAGS = (*HOST_FLAGS[:-1], "-DLZC_HOST_ENTRY")


def _host_library(name: str, headers: tuple, flags: tuple) -> ctypes.CDLL:
    """Build (if needed) with g++ ``headers[0]`` (which includes the rest)
    into ``build/liblzl_<name>-<hash>.so``, the hash over ``flags`` and
    every header, and open it."""
    h = hashlib.sha256(" ".join(flags).encode())
    for header in headers:
        with open(os.path.join(CSRC, header), "rb") as f:
            h.update(header.encode() + b"\0" + f.read())
    path = os.path.join(BUILD_DIR, f"liblzl_{name}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found: the host build of "
                               f"{headers[0]} needs it")
        _compile([gxx, *flags], headers[0], path)
    return ctypes.CDLL(path)


@functools.lru_cache(maxsize=1)
def load_host() -> ctypes.CDLL:
    """Build (if needed) with g++ and bind the host entries of
    ``lzma_lane.cuh`` and ``lane_engine.cuh``: the per-lane code run lane
    by lane on the CPU (a warp played by one thread rank by rank), by build
    code (``lzl_decode_segments_host``: the decoder, the variants that
    change the code, the seven step-cost cases), one match copy
    (``lzl_match_copy_host``), the table's size (``lzl_probs_bytes_host``)
    and the lane engine (``lzl_decode_lanes_host``, its budget
    ``lzl_lane_budget_host`` and its table's bytes
    ``lzl_lanes_smem_bytes_host``). A test aid for
    checking the kernels' logic against the plain versions without a card:
    the main path never loads it. Built into ``build/liblzl_host-<hash>.so``,
    the hash over both headers and the flags; one handle per process."""
    lib = _host_library("host", ("lane_engine.cuh", "lzma_lane.cuh"),
                        HOST_FLAGS)
    ci, vp = ctypes.c_int, ctypes.c_void_p
    lib.lzl_decode_segments_host.restype = ci
    lib.lzl_decode_segments_host.argtypes = [vp] * 12 + [ci] * 8
    lib.lzl_match_copy_host.restype = ci
    lib.lzl_match_copy_host.argtypes = [vp] + [ci] * 7 + [vp]
    lib.lzl_probs_bytes_host.restype = ci
    lib.lzl_probs_bytes_host.argtypes = [ci]
    ll = ctypes.c_longlong
    lib.lzl_decode_lanes_host.restype = ci
    lib.lzl_decode_lanes_host.argtypes = [vp] * 17 + [ci] * 4 + [ll]
    lib.lzl_lane_budget_host.restype = ll
    lib.lzl_lane_budget_host.argtypes = [ll, ci, ll]
    lib.lzl_lanes_smem_bytes_host.restype = ci
    lib.lzl_lanes_smem_bytes_host.argtypes = []
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
        (lib.lzp_bitdecode_max_lanes, []),
    ):
        fn.restype, fn.argtypes = ci, args
    lib.lzp_error_string.restype = ctypes.c_char_p
    lib.lzp_error_string.argtypes = [ci]
    return lib


@functools.lru_cache(maxsize=1)
def load_probes() -> ctypes.CDLL:
    """Build (if needed) and bind the probe kernels (and the card build's
    ``lzp_realweight_attributes`` and ``lzp_bitdecode_attributes``); one
    handle per process."""
    lib = bind_probes(ctypes.CDLL(build_library(PROBES).path))
    lib.lzp_realweight_attributes.restype = ctypes.c_int
    lib.lzp_realweight_attributes.argtypes = [ctypes.c_void_p]
    lib.lzp_bitdecode_attributes.restype = ctypes.c_int
    lib.lzp_bitdecode_attributes.argtypes = [ctypes.c_int, ctypes.c_int,
                                             ctypes.c_void_p]
    return lib


def bind_mosaic(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the mosaic library's C interface on ``lib``: the nvcc build,
    or a g++ build of ``probe_mosaic.cuh`` with ``-DLZP_HOST_ENTRY``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn, args in (
        (lib.lzm_gather_sum, [ci, ci, vp, ci, ci, vp, ci, ci, vp, ci, ci, ci,
                              vp]),
        (lib.lzm_rw_chain, [ci, vp, ci, ci, vp, vp, ci, vp]),
        (lib.lzm_row_chain, [ci, vp, ci, ci, vp, vp, ci, vp]),
        (lib.lzm_segment_chain, [ci, vp, ci, ci, vp, vp, ci, vp]),
        (lib.lzm_segment_max_rows, []),
        (lib.lzm_gather_launch, [ci, ci, vp]),
        (lib.lzm_rw_launch, [ci, ci, vp]),
        (lib.lzm_rw_max_cols, []),
        (lib.lzm_row_launch, [ci, ci, vp]),
        (lib.lzm_row_max_w, []),
        (lib.lzm_row_copy_blocks, [ci, ci, ci]),
    ):
        fn.restype, fn.argtypes = ci, args
    lib.lzm_error_string.restype = ctypes.c_char_p
    lib.lzm_error_string.argtypes = [ci]
    return lib


@functools.lru_cache(maxsize=1)
def load_mosaic() -> ctypes.CDLL:
    """Build (if needed) and bind the mosaic probe kernels (and the card
    build's ``lzm_segment_attributes``, ``lzm_rw_attributes`` and
    ``lzm_row_attributes``); one handle per process."""
    lib = bind_mosaic(ctypes.CDLL(build_library(MOSAIC).path))
    lib.lzm_segment_attributes.restype = ctypes.c_int
    lib.lzm_segment_attributes.argtypes = [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    lib.lzm_rw_attributes.restype = ctypes.c_int
    lib.lzm_rw_attributes.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.lzm_row_attributes.restype = ctypes.c_int
    lib.lzm_row_attributes.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
    return lib


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
        (lib.lzm3_vote_slots, [ci]),
    ):
        fn.restype, fn.argtypes = ci, args
    lib.lzm3_error_string.restype = ctypes.c_char_p
    lib.lzm3_error_string.argtypes = [ci]
    return lib


@functools.lru_cache(maxsize=1)
def load_mosaic3() -> ctypes.CDLL:
    """Build (if needed) and bind the mosaic3 probe kernels (and the card
    build's ``lzm3_onehot_attributes``, ``lzm3_window_attributes``,
    ``lzm3_vote_attributes`` and ``lzm3_byte_attributes``); one handle per
    process."""
    lib = bind_mosaic3(ctypes.CDLL(build_library(MOSAIC3).path))
    ci, vp = ctypes.c_int, ctypes.c_void_p
    lib.lzm3_onehot_attributes.restype = ci
    lib.lzm3_onehot_attributes.argtypes = [ci, ci, ci, vp]
    lib.lzm3_window_attributes.restype = ci
    lib.lzm3_window_attributes.argtypes = [ci, ci, vp]
    lib.lzm3_vote_attributes.restype = ci
    lib.lzm3_vote_attributes.argtypes = [ci, ci, vp]
    lib.lzm3_byte_attributes.restype = ci
    lib.lzm3_byte_attributes.argtypes = [ci, vp]
    return lib


def bind_mosaic4(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the mosaic4 library's C interface on ``lib``: the nvcc
    build, or a g++ build of ``probe_mosaic4.cuh`` with
    ``-DLZP_HOST_ENTRY``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lzm4_table_chain.restype = ci
    lib.lzm4_table_chain.argtypes = [ci, vp, ci] + [vp] * 6 + [ci, vp]
    lib.lzm4_error_string.restype = ctypes.c_char_p
    lib.lzm4_error_string.argtypes = [ci]
    return lib


@functools.lru_cache(maxsize=1)
def load_mosaic4() -> ctypes.CDLL:
    """Build (if needed) and bind the mosaic4 probe kernel (and the card
    build's ``lzm4_kernel_attributes``); one handle per process."""
    lib = bind_mosaic4(ctypes.CDLL(build_library(MOSAIC4).path))
    lib.lzm4_kernel_attributes.restype = ctypes.c_int
    lib.lzm4_kernel_attributes.argtypes = [ctypes.c_int, ctypes.c_void_p]
    return lib


def bind_round4(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the round4 library's C interface on ``lib``: the nvcc
    build, or a g++ build of ``probe_round4.cuh`` with
    ``-DLZP_HOST_ENTRY``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn, args in (
        (lib.lzr4_select_chain, [ci, ci, ci, vp, ci, ci, ci, vp, vp, ci,
                                 vp]),
        (lib.lzr4_blend_chain, [ci, ci, vp, ci, ci, vp, vp, ci, vp]),
        (lib.lzr4_lanes_per_block, [ci, ci]),
        (lib.lzr4_staged_rows, [ci, ci]),
    ):
        fn.restype, fn.argtypes = ci, args
    lib.lzr4_block_bytes.restype = ctypes.c_longlong
    lib.lzr4_block_bytes.argtypes = [ci, ci, ci]
    lib.lzr4_error_string.restype = ctypes.c_char_p
    lib.lzr4_error_string.argtypes = [ci]
    return lib


@functools.lru_cache(maxsize=1)
def load_round4() -> ctypes.CDLL:
    """Build (if needed) and bind the round4 probe kernels (and the card
    build's ``lzr4_kernel_attributes``); one handle per process."""
    lib = bind_round4(ctypes.CDLL(build_library(ROUND4).path))
    ci = ctypes.c_int
    lib.lzr4_kernel_attributes.restype = ci
    lib.lzr4_kernel_attributes.argtypes = [ci] * 4 + [ctypes.c_void_p]
    return lib


def bind_bisect(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the bisect library's C interface on ``lib``: the nvcc
    build, or a g++ build of ``probe_bisect.cuh`` with
    ``-DLZP_HOST_ENTRY``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lzb_bisect.restype = ci
    lib.lzb_bisect.argtypes = [ci] + [vp] * 5 + [ci, ci, vp]
    lib.lzb_error_string.restype = ctypes.c_char_p
    lib.lzb_error_string.argtypes = [ci]
    return lib


@functools.lru_cache(maxsize=1)
def load_bisect() -> ctypes.CDLL:
    """Build (if needed) and bind the bisect probe kernel (and the card
    build's ``lzb_kernel_attributes``); one handle per process."""
    lib = bind_bisect(ctypes.CDLL(build_library(BISECT).path))
    lib.lzb_kernel_attributes.restype = ctypes.c_int
    lib.lzb_kernel_attributes.argtypes = [ctypes.c_int, ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=1)
def load_crc_host() -> ctypes.CDLL:
    """Build (if needed) with g++ and bind ``crc_kernel.cuh``'s host entry
    ``lzc_crc_blocks_host``: the kernel's arithmetic chunk by chunk and
    lane by lane on the CPU, with the kernel's arguments. A test aid: the
    main path never loads it. Built into ``build/liblzl_crchost-<hash>.so``,
    the hash over the header and the flags; one handle per process."""
    lib = _host_library("crchost", ("crc_kernel.cuh",), CRC_HOST_FLAGS)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lzc_crc_blocks_host.restype = ci
    lib.lzc_crc_blocks_host.argtypes = [ci, vp, ci, vp, vp, ci, vp]
    return lib
