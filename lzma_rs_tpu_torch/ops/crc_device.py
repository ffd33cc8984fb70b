"""CRC32 / CRC64-XZ of a block on the card: a Hopper kernel that folds
the block's chunks to one register there.

The counterpart of ``lzma_rs_tpu/ops/crc_device.py``'s device path
(``_device_raw`` over ``_jitted_crc_matmul``, ``:226-339``, under
``crc32_device`` ``:362`` and ``crc64_device`` ``:375``). The JAX code
bit-unpacks the chunks, takes one bf16 matrix product against a GF(2)
weight matrix, copies the ``[L, width]`` parity matrix back and folds the
chunk registers on the host in power-of-two batches.

**On the card**, :func:`crc_raw` launches ``crc_blocks``
(``csrc/crc_blocks.cu`` over ``csrc/crc_kernel.cuh``, library ``crc`` of
``ops/build.py``): a warp a 4 KiB chunk, a lane 128 bytes of it by
slice-by-8, each lane's and then each chunk's register advanced to the
block's end by the zero-advance maps ``Z_{2^j}`` (:func:`power_maps`,
applied through :func:`nibble_table`), XORed into one 8-byte register with
a 64-bit ``atomicXor``. One launch a block; only those 8 bytes come back.
What bounds it is bytes: ``L x 4096`` read once over 3.35 TB/s. The tables
(:func:`slice_table`, the maps) are built here once per width and kept on
each card (:func:`_kernel_tables`).

**The plain version**, :func:`crc_raw_reference`, is the route the port
took before the kernel: :func:`crc_parity` (bit-unpack, one float32
``torch.matmul`` with the weight matrix, ``& 1``) on the tensor's device,
the registers packed and folded on the host (``_pack_parity``,
``_tree_combine_host``, ``combine_raw``). A CPU tensor takes it in
:func:`crc_raw`; the tests hold it, the kernel's host build and the JAX
package against each other.

**Exact in float32.** The product's operands are 0 or 1 and a sum has at
most CHUNK*8 = 32,768 < 2^24 terms, so every partial sum is an integer
that float32 holds exactly. The JAX code gets the same from bf16 operands
with ``preferred_element_type=float32``; ``torch.matmul`` on bf16 operands
returns **bf16**, whose 8-bit mantissa rounds sums above 256 and destroys
the parity, so the product takes float32 operands.

The host numpy machinery (``_zero_byte_matrix`` ... ``combine_raw``,
``_crc_weight_matrix``, ``_mat_compose_np``, ``_pack_parity``,
``_tree_combine_host``, ``_host_raw_crc``) and ``crc32_device`` /
``crc64_device`` (the tail and the init/xorout correction on the host) are
copies of the JAX module's, changed only in the native loader they import,
the ``device`` argument and the one call to :func:`crc_raw`. The JAX
module's scan kernels (``_jitted_crc``, ``_crc32_chunks``,
``_crc64_chunks``, ``_tree_combine``) have no caller there and are left
out. Like the reference, the main path does not call this module: it
checks blocks on the host (``parallel/runtime.py::check_blocks``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

CRC32_POLY = 0xEDB88320
CRC64_POLY = 0xC96C5795D7870F42

CHUNK = 4096  # bytes per lane


# -- copied from lzma_rs_tpu/ops/crc_device.py:35-86

# ---------------------------------------------------------------------------
# GF(2) matrix machinery (host side, numpy): operators as column images.
# ---------------------------------------------------------------------------


def _zero_byte_matrix(poly: int, width: int) -> np.ndarray:
    """Matrix of 'process one zero byte' acting on the raw register."""
    cols = np.zeros(width, dtype=np.uint64)
    for i in range(width):
        reg = 1 << i
        for _ in range(8):
            reg = (reg >> 1) ^ (poly if (reg & 1) else 0)
        cols[i] = reg
    return cols


def _mat_apply(m: np.ndarray, x: int) -> int:
    y = 0
    i = 0
    while x:
        if x & 1:
            y ^= int(m[i])
        x >>= 1
        i += 1
    return y


def _mat_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a ∘ b): column i = a(b[i])."""
    return np.array([_mat_apply(a, int(c)) for c in b], dtype=np.uint64)


@functools.lru_cache(maxsize=None)
def zero_advance_matrix(poly: int, width: int, nbytes: int) -> tuple:
    """Z_n as a tuple of column images (hashable for lru_cache)."""
    base = _zero_byte_matrix(poly, width)
    # identity
    result = np.array([1 << i for i in range(width)], dtype=np.uint64)
    sq = base
    n = nbytes
    while n:
        if n & 1:
            result = _mat_compose(sq, result)
        sq = _mat_compose(sq, sq)
        n >>= 1
    return tuple(int(c) for c in result)


def combine_raw(poly: int, width: int, left: int, right: int, right_len: int) -> int:
    """raw(A||B) = raw(B) ^ Z_{|B|}(raw(A))."""
    m = np.array(zero_advance_matrix(poly, width, right_len), dtype=np.uint64)
    return right ^ _mat_apply(m, left)


# -- copied from lzma_rs_tpu/ops/crc_device.py:184-222

@functools.lru_cache(maxsize=8)
def _crc_weight_matrix(poly: int, width: int, nbytes: int):
    """W [nbytes*8, width] int8: row (j*8+i) = bits of Z_{n-1-j}(T(1<<i)).

    Bit i here is the i-th bit of the byte as XORed into the register low
    bits (reflected convention: byte ^ reg low byte).
    """
    # T(1<<i): register after processing the single byte (1<<i) from 0.
    t = []
    for i in range(8):
        reg = 1 << i
        for _ in range(8):
            reg = (reg >> 1) ^ (poly if (reg & 1) else 0)
        t.append(reg)

    zb = _zero_byte_matrix(poly, width)
    # V = Z_n, built incrementally from n=0 upward; row block for position
    # j = nbytes-1-n uses V.
    V = np.array([1 << i for i in range(width)], dtype=np.uint64)
    W = np.zeros((nbytes * 8, width), dtype=np.int8)
    bit_idx = np.arange(width, dtype=np.uint64)
    for n in range(nbytes):
        j = nbytes - 1 - n
        for i in range(8):
            v = _mat_apply(V, t[i])
            W[j * 8 + i, :] = (np.uint64(v) >> bit_idx) & np.uint64(1)
        if n != nbytes - 1:
            V = _mat_compose_np(zb, V)
    return W


def _mat_compose_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized GF(2) compose: column i of (a ∘ b) = a(b[i])."""
    width = a.shape[0]
    out = np.zeros_like(b)
    for i in range(width):
        mask = ((b >> np.uint64(i)) & np.uint64(1)).astype(bool)
        out[mask] ^= a[i]
    return out


# -- the plain version's product: the port's first route for
# _jitted_crc_matmul (:226-267)

@functools.lru_cache(maxsize=8)
def _weight(width: int, device: torch.device) -> torch.Tensor:
    """The ``[CHUNK*8, width]`` weight matrix on ``device``, float32."""
    poly = CRC32_POLY if width == 32 else CRC64_POLY
    w = _crc_weight_matrix(poly, width, CHUNK)
    return torch.from_numpy(w).to(device=device, dtype=torch.float32)


def unpack_bits(data2d: torch.Tensor) -> torch.Tensor:
    """``[L, CHUNK]`` u8 -> ``[L, CHUNK*8]`` float32 of 0/1, bit 0 (the
    LSB, XORed into the register's low bit first) of each byte first."""
    shifts = torch.arange(8, dtype=torch.uint8, device=data2d.device)
    bits = (data2d[:, :, None] >> shifts) & 1
    return bits.reshape(data2d.shape[0], -1).to(torch.float32)


def crc_parity(data2d: torch.Tensor, width: int) -> torch.Tensor:
    """The raw registers of ``L`` chunks as a ``[L, width]`` u8 parity
    matrix (0/1): bit-unpack, one float32 ``torch.matmul`` (exact: see the
    module's docstring), ``& 1``. The registers are packed on the host."""
    y = torch.matmul(unpack_bits(data2d), _weight(width, data2d.device))
    return (y.to(torch.int32) & 1).to(torch.uint8)


# -- copied from lzma_rs_tpu/ops/crc_device.py:270-291

def _pack_parity(parity: np.ndarray, width: int) -> np.ndarray:
    """[L, width] 0/1 -> [L] uint64 registers (host)."""
    shifts = np.arange(width, dtype=np.uint64)
    return (parity.astype(np.uint64) << shifts[None, :]).sum(
        axis=1, dtype=np.uint64
    )


def _tree_combine_host(regs: np.ndarray, poly: int, width: int, chunk_len: int) -> int:
    """Host log-tree fold of per-chunk raw registers (stream order)."""
    vals = regs.astype(np.uint64)
    level_len = chunk_len
    while vals.size > 1:
        cols = np.array(zero_advance_matrix(poly, width, level_len), dtype=np.uint64)
        left, right = vals[0::2], vals[1::2]
        acc = right.copy()
        for i in range(width):
            mask = ((left >> np.uint64(i)) & np.uint64(1)).astype(bool)
            acc[mask] ^= cols[i]
        vals = acc
        level_len *= 2
    return int(vals[0])


# -- the kernel's tables: built here from the GF(2) machinery above

# Z_{2^j} for j < MAPS (csrc/crc_kernel.cuh kMaps): a chunk advances by
# at most 2^31 - 2 chunks, under 2^43 bytes.
MAPS = 43
MASK64 = (1 << 64) - 1


@functools.lru_cache(maxsize=None)
def slice_table(width: int) -> np.ndarray:
    """``[8, 256]`` uint64: ``t[k][v]``, the raw register of byte ``v``
    followed by ``k`` zero bytes (slice-by-8)."""
    poly = CRC32_POLY if width == 32 else CRC64_POLY
    t = np.zeros((8, 256), dtype=np.uint64)
    for v in range(256):
        reg = v
        for _ in range(8):
            reg = (reg >> 1) ^ (poly if (reg & 1) else 0)
        t[0, v] = reg
    for k in range(1, 8):
        prev = t[k - 1]
        t[k] = (prev >> np.uint64(8)) ^ t[0][(prev & np.uint64(255)).astype(
            np.intp)]
    return t


@functools.lru_cache(maxsize=None)
def power_maps(width: int) -> np.ndarray:
    """``[MAPS, width]`` uint64: row ``j`` holds the column images of
    ``Z_{2^j}`` (as :func:`zero_advance_matrix` gives them), each the
    square of the one before."""
    poly = CRC32_POLY if width == 32 else CRC64_POLY
    maps = np.zeros((MAPS, width), dtype=np.uint64)
    maps[0] = _zero_byte_matrix(poly, width)
    for j in range(1, MAPS):
        maps[j] = _mat_compose_np(maps[j - 1], maps[j - 1])
    return maps


def nibble_table(cols: np.ndarray) -> np.ndarray:
    """A map's nibble table from its column images: ``n[q * 16 + v] =
    Z(v << 4q)``, ``len(cols) / 4 x 16`` uint64, so ``Z(x)`` is the XOR of
    ``n[q * 16 + nibble q of x]``."""
    width = len(cols)
    n = np.zeros((width // 4, 16), dtype=np.uint64)
    for i in range(4):
        has = (np.arange(16) >> i) & 1 == 1
        n[:, has] ^= cols[i::4, None]
    return n.reshape(-1)


def _as_registers(a: np.ndarray, width: int) -> torch.Tensor:
    """uint64 registers as the kernel's: int32 bits for CRC32, int64 for
    CRC64."""
    if width == 32:
        return torch.from_numpy(a.astype(np.uint32).view(np.int32))
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


@functools.lru_cache(maxsize=8)
def _kernel_tables(width: int, device: torch.device) -> tuple:
    """The kernel's slice-by-8 table and its ``MAPS`` nibble tables on
    ``device``, built once per width and card."""
    maps = np.stack([nibble_table(c) for c in power_maps(width)])
    return (_as_registers(slice_table(width), width).to(device),
            _as_registers(maps, width).to(device))


def _check_chunks(data2d: torch.Tensor, width: int) -> None:
    if width not in (32, 64):
        raise ValueError(f"width {width}: 32 or 64")
    if not isinstance(data2d, torch.Tensor) or data2d.dtype != torch.uint8:
        raise TypeError("the chunks are a uint8 tensor, not "
                        f"{getattr(data2d, 'dtype', type(data2d))}")
    if data2d.dim() != 2 or data2d.shape[1] != CHUNK:
        raise ValueError(f"the chunks are [L, {CHUNK}], not "
                         f"{list(data2d.shape)}")
    if not 1 <= data2d.shape[0] < 1 << 31:
        raise ValueError(f"L = {data2d.shape[0]}: 1 <= L < 2^31")
    if not data2d.is_contiguous():
        raise ValueError("the chunks must be contiguous")


def register(t: torch.Tensor) -> int:
    """The register :func:`crc_raw` returns, as an int (one D2H copy)."""
    return int(t.item()) & MASK64


def crc_raw(data2d: torch.Tensor, width: int) -> torch.Tensor:
    """The raw register (init 0, no final XOR) of ``L`` full chunks in
    stream order: a ``[1]`` int64 tensor on ``data2d``'s device holding the
    register's bits (read it with :func:`register`).

    ``data2d`` is ``[L, CHUNK]`` uint8, contiguous, ``L >= 1``; ``width``
    32 or 64. A CUDA tensor launches ``crc_blocks`` on the current stream
    (asynchronously; a chunk row the caller's slicing left off a 16-byte
    boundary is copied first) or raises; a CPU tensor takes
    :func:`crc_raw_reference`."""
    _check_chunks(data2d, width)
    dev = data2d.device
    if dev.type == "cpu":
        return crc_raw_reference(data2d, width)
    if dev.type != "cuda":
        raise ValueError(f"crc_raw runs on cuda or cpu, not {dev}")

    from lzma_rs_tpu_torch.ops import build

    lib = build.load_crc()
    with torch.cuda.device(dev):
        if data2d.data_ptr() % 16:
            data2d = data2d.clone()
        slice_t, maps_t = _kernel_tables(width, dev)
        out = torch.empty(1, dtype=torch.int64, device=dev)  # zeroed there
        rc = lib.lzc_crc_blocks(
            width, data2d.data_ptr(), data2d.shape[0], slice_t.data_ptr(),
            maps_t.data_ptr(), MAPS, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("crc_blocks kernel launch failed: "
                           + lib.lzc_error_string(rc).decode())
    crc_raw.launches += 1
    return out


crc_raw.launches = 0


def crc_raw_reference(data2d: torch.Tensor, width: int) -> torch.Tensor:
    """The plain version of :func:`crc_raw`, on any device: the parity
    matrix of :func:`crc_parity` on ``data2d``'s device, packed and folded
    on the host in power-of-two batches (``_device_raw``'s loop in the JAX
    module, ``:316-339``)."""
    _check_chunks(data2d, width)
    poly = CRC32_POLY if width == 32 else CRC64_POLY
    regs = _pack_parity(crc_parity(data2d, width).cpu().numpy(), width)
    pos = 0
    raw = 0
    remaining = len(regs)
    while remaining:
        L = 1 << (remaining.bit_length() - 1)
        val = _tree_combine_host(regs[pos:pos + L], poly, width, CHUNK)
        raw = val if pos == 0 else combine_raw(poly, width, raw, val,
                                               L * CHUNK)
        pos += L
        remaining -= L
    signed = raw - (1 << 64) if raw >> 63 else raw
    return torch.tensor([signed], dtype=torch.int64, device=data2d.device)


# -- copied from lzma_rs_tpu/ops/crc_device.py:316-385; the device is an
# argument, and one crc_raw call takes every full chunk

def _device_raw(data: bytes, width: int, device: torch.device) -> tuple:
    """Raw register of the full-chunk prefix of ``data``; returns
    (raw_value, covered_len). One :func:`crc_raw` call over every full
    chunk: on the card one launch and 8 bytes back."""
    n = len(data) // CHUNK
    if n == 0:
        return 0, 0
    arr = np.frombuffer(data, dtype=np.uint8, count=n * CHUNK)
    chunks = torch.from_numpy(arr.reshape(n, CHUNK).copy()).to(device)
    return register(crc_raw(chunks, width)), n * CHUNK


def _host_raw_crc(data: bytes, width: int, init: int) -> int:
    """Raw register update (no init/xorout convention) on the host."""
    if width == 32:
        import zlib

        # zlib.crc32(data, v) computes ~raw(data, ~v); so raw(data, x) =
        # ~zlib.crc32(data, ~x & 0xFFFFFFFF)
        return (zlib.crc32(data, (~init) & 0xFFFFFFFF) ^ 0xFFFFFFFF)
    from lzma_rs_tpu_torch.native import loader

    lib = loader.load()
    if lib is not None:
        return lib.crc64_update(data, init)
    # numpy fallback via utils.crc internals
    from lzma_rs_tpu_torch.utils import crc as crc_mod

    arr = np.frombuffer(data, dtype=np.uint8)
    return crc_mod._crc64_numpy(arr, init)


def _device(device) -> torch.device:
    """``device``, or the current CUDA device; raises without one."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("the device CRC needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    return torch.device("cuda", torch.cuda.current_device())


def crc32_device(data: bytes, device=None) -> int:
    """CRC-32/ISO-HDLC with the chunks' register from :func:`crc_raw` on
    ``device`` (by default the current CUDA device; it raises without one),
    the tail and the affine correction on the host."""
    raw, covered = _device_raw(data, 32, _device(device))
    tail = data[covered:]
    if tail:
        raw = _host_raw_crc(bytes(tail), 32, raw)
    # apply init: crc = raw(data, init=0xFFFFFFFF) ^ 0xFFFFFFFF
    #            = raw(data, 0) ^ Z_len(0xFFFFFFFF) ^ 0xFFFFFFFF
    m = np.array(zero_advance_matrix(CRC32_POLY, 32, len(data)), dtype=np.uint64)
    return (raw ^ _mat_apply(m, 0xFFFFFFFF)) ^ 0xFFFFFFFF


def crc64_device(data: bytes, device=None) -> int:
    """CRC-64/XZ with the chunks' register from :func:`crc_raw` on
    ``device`` (by default the current CUDA device; it raises without
    one)."""
    raw, covered = _device_raw(data, 64, _device(device))
    tail = data[covered:]
    if tail:
        raw = _host_raw_crc(bytes(tail), 64, raw)
    m = np.array(
        zero_advance_matrix(CRC64_POLY, 64, len(data)), dtype=np.uint64
    )
    init = 0xFFFFFFFFFFFFFFFF
    return (raw ^ _mat_apply(m, init)) ^ init
