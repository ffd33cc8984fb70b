"""CRC32 / CRC64-XZ of a block on the card, as a GF(2) matrix product.

The port of ``lzma_rs_tpu/ops/crc_device.py``'s product path
(``_device_raw`` over ``_jitted_crc_matmul``, ``:226-267``). CRC is linear
over GF(2), so the raw register of a 4 KiB chunk is a binary product:

    raw_bits = bits(chunk) [CHUNK*8]  x  W [CHUNK*8, width]   (mod 2)

The host numpy machinery below (``_zero_byte_matrix`` ... ``combine_raw``,
``_crc_weight_matrix``, ``_mat_compose_np``, ``_pack_parity``,
``_tree_combine_host``, ``_host_raw_crc``, ``crc32_device``,
``crc64_device``) is a copy of the JAX module's, changed only in the
native loader it imports and the ``device`` argument. The device part,
:func:`crc_parity`, is PyTorch: unpack ``[L, CHUNK]`` bytes to ``[L,
CHUNK*8]`` bits, one ``torch.matmul`` with the weight matrix, ``& 1``.

**Exact in float32.** The operands are 0 or 1 and a sum has at most
CHUNK*8 = 32,768 < 2^24 terms, so every partial sum is an integer that
float32 holds exactly (TF32 or bf16 operand rounding cannot change a 0 or
a 1 either). The JAX code gets the same from bf16 operands with
``preferred_element_type=float32``; ``torch.matmul`` on bf16 operands
returns **bf16**, whose 8-bit mantissa rounds sums above 256 and destroys
the parity, so the product takes float32 operands. (``torch._int_mm``,
int8 -> int32, would also be exact, but only at the shapes its kernels
take.)

The JAX module's scan kernels (``_jitted_crc``, ``_crc32_chunks``,
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


# -- the device part: the port of _jitted_crc_matmul (:226-267)

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


# -- copied from lzma_rs_tpu/ops/crc_device.py:316-385; the device is an
# argument, the product is crc_parity

def _device_raw(data: bytes, width: int, device: torch.device) -> tuple:
    """Raw register of the full-chunk prefix of ``data``; returns
    (raw_value, covered_len). Non-power-of-two chunk counts run as a few
    power-of-two device batches combined on the host (cheap matrix ops)."""
    poly = CRC32_POLY if width == 32 else CRC64_POLY
    pos = 0
    raw = 0
    remaining = len(data) // CHUNK
    first = True
    while remaining:
        L = 1 << (remaining.bit_length() - 1)
        seg = data[pos : pos + L * CHUNK]
        arr = np.frombuffer(seg, dtype=np.uint8).reshape(L, CHUNK)
        parity = crc_parity(torch.from_numpy(arr.copy()).to(device), width)
        regs = _pack_parity(parity.cpu().numpy(), width)
        val = _tree_combine_host(regs, poly, width, CHUNK)
        raw = val if first else combine_raw(poly, width, raw, val, L * CHUNK)
        first = False
        pos += L * CHUNK
        remaining -= L
    return raw, pos


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
    """CRC-32/ISO-HDLC with the chunks' product on ``device`` (by default
    the current CUDA device; it raises without one), the tail and the
    affine correction on the host."""
    raw, covered = _device_raw(data, 32, _device(device))
    tail = data[covered:]
    if tail:
        raw = _host_raw_crc(bytes(tail), 32, raw)
    # apply init: crc = raw(data, init=0xFFFFFFFF) ^ 0xFFFFFFFF
    #            = raw(data, 0) ^ Z_len(0xFFFFFFFF) ^ 0xFFFFFFFF
    m = np.array(zero_advance_matrix(CRC32_POLY, 32, len(data)), dtype=np.uint64)
    return (raw ^ _mat_apply(m, 0xFFFFFFFF)) ^ 0xFFFFFFFF


def crc64_device(data: bytes, device=None) -> int:
    """CRC-64/XZ with the chunks' product on ``device`` (by default the
    current CUDA device; it raises without one)."""
    raw, covered = _device_raw(data, 64, _device(device))
    tail = data[covered:]
    if tail:
        raw = _host_raw_crc(bytes(tail), 64, raw)
    m = np.array(
        zero_advance_matrix(CRC64_POLY, 64, len(data)), dtype=np.uint64
    )
    init = 0xFFFFFFFFFFFFFFFF
    return (raw ^ _mat_apply(m, init)) ^ init
