"""The port's device CRC (``lzma_rs_tpu_torch/ops/crc_device.py``) against
the JAX package's (``lzma_rs_tpu/ops/crc_device.py``, on the CPU),
``zlib`` and the port's ``crc64``.

The port runs here on CPU tensors (``device="cpu"``): ``crc_raw`` takes
its plain version, a float32 ``torch.matmul`` and the host fold. The
kernel's arithmetic (``csrc/crc_kernel.cuh``) runs through its g++ host
build (``ops/build.py::load_crc_host``) with the kernel's own tables;
the kernel itself runs in the tests marked ``cuda``. Data comes from a
seeded numpy generator.
"""

import zlib

import numpy as np
import pytest
import torch

from lzma_rs_tpu.ops import crc_device as jax_crc
from lzma_rs_tpu_torch.ops import crc_device as crc
from lzma_rs_tpu_torch.utils.crc import crc64

CPU = torch.device("cpu")
C = crc.CHUNK
LENGTHS = [0, 1, 100, C - 1, C, C + 1, 3 * C + 17, 8 * C, 13 * C + 1234]


def data(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("n", LENGTHS)
def test_crc32_equals_the_jax_package_and_zlib(n):
    d = data(n, n)
    got = crc.crc32_device(d, device=CPU)
    assert got == zlib.crc32(d) & 0xFFFFFFFF
    assert got == jax_crc.crc32_device(d)


@pytest.mark.parametrize("n", LENGTHS)
def test_crc64_equals_the_jax_package_and_the_host_crc(n):
    d = data(n, n + 1)
    got = crc.crc64_device(d, device=CPU)
    assert got == crc64(d)
    assert got == jax_crc.crc64_device(d)


@pytest.mark.parametrize("width,poly", [(32, crc.CRC32_POLY),
                                        (64, crc.CRC64_POLY)])
def test_combine_raw_equals_the_jax_package(width, poly):
    a, b = data(C, 7), data(C + 99, 8)
    raw = lambda d: zlib.crc32(d, 0xFFFFFFFF) ^ 0xFFFFFFFF  # init 0
    if width == 64:
        raw = lambda d: crc._host_raw_crc(d, 64, 0)
    combined = crc.combine_raw(poly, width, raw(a), raw(b), len(b))
    assert combined == raw(a + b)
    assert combined == jax_crc.combine_raw(poly, width, raw(a), raw(b),
                                           len(b))
    assert crc.zero_advance_matrix(poly, width, 4097) == \
        jax_crc.zero_advance_matrix(poly, width, 4097)


@pytest.mark.parametrize("width", [32, 64])
def test_the_parity_matrix_equals_the_jax_product(width):
    import jax.numpy as jnp

    arr = np.frombuffer(data(4 * C, width), dtype=np.uint8).reshape(4, C)
    want = np.asarray(jax_crc._jitted_crc_matmul(width, 4)(jnp.asarray(arr)))
    got = crc.crc_parity(torch.from_numpy(arr.copy()), width)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (4, width)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the registers it packs to are each chunk's raw CRC
    regs = crc._pack_parity(got.numpy(), width)
    for i in range(4):
        assert int(regs[i]) == crc._host_raw_crc(arr[i].tobytes(), width, 0)


def test_a_bf16_product_gives_a_wrong_crc():
    """``torch.matmul`` on bf16 operands returns bf16, which rounds sums
    above 256: the parity, and the CRC, come out wrong. The module's
    product is float32 and right."""
    arr = np.frombuffer(data(4 * C, 3), dtype=np.uint8).reshape(4, C)
    x = torch.from_numpy(arr.copy())
    bits = crc.unpack_bits(x)
    w = crc._weight(64, CPU)
    assert bits.dtype == w.dtype == torch.float32
    y16 = torch.matmul(bits.bfloat16(), w.bfloat16())
    assert y16.dtype == torch.bfloat16
    y32 = torch.matmul(bits, w)
    assert int(y32.max()) > 256  # sums that bf16 cannot hold
    wrong = (y16.float().to(torch.int32) & 1).to(torch.uint8)
    right = crc.crc_parity(x, 64)
    assert not torch.equal(wrong, right)
    regs = crc._pack_parity(wrong.numpy(), 64)
    assert [int(r) for r in regs] != [
        crc._host_raw_crc(arr[i].tobytes(), 64, 0) for i in range(4)]
    np.testing.assert_array_equal(
        crc._pack_parity(right.numpy(), 64),
        [crc._host_raw_crc(arr[i].tobytes(), 64, 0) for i in range(4)])


def test_the_weight_matrix_equals_the_jax_package():
    np.testing.assert_array_equal(
        crc._crc_weight_matrix(crc.CRC32_POLY, 32, 64),
        jax_crc._crc_weight_matrix(crc.CRC32_POLY, 32, 64))


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (crc.crc32_device, crc.crc64_device):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            fn(data(C, 1))


def host_register(chunks: np.ndarray, width: int) -> int:
    """The raw register of ``chunks`` ([L, C] uint8) from the g++ build of
    the kernel's arithmetic, with the kernel's tables."""
    from lzma_rs_tpu_torch.ops import build

    slice_t, maps_t = crc._kernel_tables(width, CPU)
    arr = np.ascontiguousarray(chunks)
    out = np.zeros(1, dtype=np.uint64)
    assert build.load_crc_host().lzc_crc_blocks_host(
        width, arr.ctypes.data, arr.shape[0], slice_t.data_ptr(),
        maps_t.data_ptr(), crc.MAPS, out.ctypes.data) == 0
    return int(out[0])


def chunks_of(L: int, seed: int) -> np.ndarray:
    return np.frombuffer(data(L * C, seed), dtype=np.uint8).reshape(L, C)


@pytest.mark.parametrize("L", [1, 2, 3, 5, 255, 256, 257])
@pytest.mark.parametrize("width", [32, 64])
def test_the_host_build_equals_the_plain_version_and_the_jax_package(
        width, L):
    arr = chunks_of(L, 1000 * width + L)
    got = host_register(arr, width)
    ref = crc.crc_raw_reference(torch.from_numpy(arr.copy()), width)
    assert ref.dtype == torch.int64 and tuple(ref.shape) == (1,)
    assert got == crc.register(ref)
    assert got == crc.register(crc.crc_raw(torch.from_numpy(arr.copy()),
                                           width))
    assert (got, L * C) == jax_crc._device_raw(arr.tobytes(), width)
    assert got == crc._host_raw_crc(arr.tobytes(), width, 0)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("width", [32, 64])
def test_the_checks_through_the_host_build(width, n, monkeypatch):
    """``crc32_device`` / ``crc64_device`` with the kernel's arithmetic in
    ``crc_raw``'s place: one call over every full chunk."""
    calls = []

    def kernel(chunks, w):
        calls.append(tuple(chunks.shape))
        v = host_register(chunks.numpy(), w)
        return torch.tensor([v - (1 << 64) if v >> 63 else v])

    monkeypatch.setattr(crc, "crc_raw", kernel)
    d = data(n, n + 3)
    if width == 32:
        got, want = crc.crc32_device(d, device=CPU), zlib.crc32(d)
    else:
        got, want = crc.crc64_device(d, device=CPU), crc64(d)
    assert got == want
    assert calls == ([(n // C, C)] if n >= C else [])


@pytest.mark.parametrize("width,poly", [(32, crc.CRC32_POLY),
                                        (64, crc.CRC64_POLY)])
def test_the_kernel_maps_equal_the_jax_zero_advance_matrix(width, poly):
    maps = crc.power_maps(width)
    assert maps.shape == (crc.MAPS, width)
    for j in (0, 1, 2, 7, 8, 9, 10, 11, 12, 13, 20, 31, crc.MAPS - 1):
        assert tuple(int(c) for c in maps[j]) == \
            jax_crc.zero_advance_matrix(poly, width, 1 << j)
    # a nibble table applies its map: Z(x) == the columns' select-XOR
    rng = np.random.default_rng(width)
    slice_t, maps_t = crc._kernel_tables(width, CPU)
    kernel_maps = maps_t.numpy().view(
        np.uint32 if width == 32 else np.uint64).astype(np.uint64)
    assert kernel_maps.shape == (crc.MAPS, width // 4 * 16)
    for j in (7, 12, 30):
        n = crc.nibble_table(maps[j])
        np.testing.assert_array_equal(kernel_maps[j], n)
        for x in rng.integers(0, 1 << 62, 20, dtype=np.int64):
            x = int(x) & ((1 << width) - 1)
            y = 0
            for q in range(width // 4):
                y ^= int(n[q * 16 + ((x >> (4 * q)) & 15)])
            assert y == crc._mat_apply(maps[j], x)


@pytest.mark.parametrize("width", [32, 64])
def test_the_slice_table_is_a_byte_then_zeros(width):
    t = crc.slice_table(width)
    slice_t, _ = crc._kernel_tables(width, CPU)
    np.testing.assert_array_equal(slice_t.numpy().view(
        np.uint32 if width == 32 else np.uint64).astype(np.uint64), t)
    for k in range(8):
        for v in (0, 1, 0x80, 0xA5, 0xFF):
            assert int(t[k, v]) == crc._host_raw_crc(
                bytes([v]) + bytes(k), width, 0)


@pytest.mark.parametrize("case", ["dtype", "non-contiguous", "L = 0",
                                  "row length", "one dimension", "width"])
def test_bad_chunks_raise(case):
    arr = torch.from_numpy(chunks_of(4, 5).copy())
    x, width, err = arr, 64, ValueError
    if case == "dtype":
        x, err = arr.to(torch.int16), TypeError
    elif case == "non-contiguous":
        x = torch.from_numpy(chunks_of(4, 5).copy().reshape(2, 2 * C))[
            :, :C]
        assert not x.is_contiguous()
    elif case == "L = 0":
        x = arr[:0]
    elif case == "row length":
        x = arr.reshape(8, C // 2)
    elif case == "one dimension":
        x = arr.reshape(-1)
    else:
        width = 16
    for fn in (crc.crc_raw, crc.crc_raw_reference):
        with pytest.raises(err):
            fn(x, width)


def test_crc_raw_on_the_cpu_launches_nothing(monkeypatch):
    from lzma_rs_tpu_torch.ops import build

    monkeypatch.setattr(crc.crc_raw, "launches", 0)
    monkeypatch.setattr(build, "load_crc",
                        lambda: pytest.fail("the kernel was loaded"))
    arr = chunks_of(3, 6)
    got = crc.crc_raw(torch.from_numpy(arr.copy()), 32)
    assert crc.register(got) == crc._host_raw_crc(arr.tobytes(), 32, 0)
    assert crc.crc_raw.launches == 0


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("n", LENGTHS)
def test_crc_on_the_card(n):
    dev = card()
    d = data(n, n + 2)
    before = crc.crc_raw.launches
    assert crc.crc32_device(d) == zlib.crc32(d) & 0xFFFFFFFF
    assert crc.crc64_device(d) == crc64(d)
    assert crc.crc_raw.launches - before == (2 if n >= C else 0)
    if n >= C:  # the kernel against its plain version on the same chunks
        x = torch.from_numpy(np.frombuffer(d, dtype=np.uint8)[
            :n // C * C].reshape(-1, C).copy()).to(dev)
        for width in (32, 64):
            got = crc.crc_raw(x, width)
            assert got.device == dev
            assert crc.register(got) == crc.register(
                crc.crc_raw_reference(x, width))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [32, 64])
def test_the_kernel_equals_its_plain_version_at_a_1_mib_block(width):
    """(c)'s block size (256 chunks), and the same chunks from a row the
    caller's slicing left off a 16-byte boundary (the wrapper copies it)."""
    dev = card()
    arr = chunks_of(256, 17 + width)
    x = torch.from_numpy(arr.copy()).to(dev)
    want = crc.register(crc.crc_raw_reference(x, width))
    assert want == crc._host_raw_crc(arr.tobytes(), width, 0)
    assert crc.register(crc.crc_raw(x, width)) == want
    flat = torch.zeros(256 * C + 1, dtype=torch.uint8, device=dev)
    flat[1:] = x.reshape(-1)
    off = flat[1:].view(256, C)
    assert off.data_ptr() % 16 and off.is_contiguous()
    assert crc.register(crc.crc_raw(off, width)) == want
