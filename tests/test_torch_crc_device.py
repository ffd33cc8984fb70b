"""The port's device CRC (``lzma_rs_tpu_torch/ops/crc_device.py``) against
the JAX package's (``lzma_rs_tpu/ops/crc_device.py``, on the CPU),
``zlib`` and the port's ``crc64``.

The port runs here on CPU tensors (``device="cpu"``): its product is a
float32 ``torch.matmul``, the same call on either device. Data comes from
a seeded numpy generator.
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


@pytest.mark.cuda
@pytest.mark.parametrize("n", LENGTHS)
def test_crc_on_the_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = data(n, n + 2)
    assert crc.crc32_device(d) == zlib.crc32(d) & 0xFFFFFFFF
    assert crc.crc64_device(d) == crc64(d)
