"""Fuzz-style properties of the port (deterministic seeds): the
properties ``tests/test_fuzz.py`` holds over the JAX package, over
``lzma_rs_tpu_torch``, after the reference's fuzz targets:

- ``decompress_{lzma,lzma2,xz}``: arbitrary bytes give a typed
  ``LzmaRsError`` or success, never anything else (the ``.xz`` share also
  through the ``cuda`` engine on CPU slabs: its plain version);
- ``roundtrip_{lzma,lzma2,xz}``: the port's encoders and decoders agree
  on arbitrary payloads;
- ``decompress_lzma_stream``: the port's chunked stream output equals the
  one-shot output;
- ``compare_xz`` / ``interop_xz``: against liblzma.
"""

import lzma as liblzma
import random

import pytest
import torch

import lzma_rs_tpu_torch
from lzma_rs_tpu_torch.parallel import runtime
from lzma_rs_tpu_torch.stream import Stream
from lzma_rs_tpu_torch.utils.errors import LzmaRsError

N_CASES = 60


def _rand_bytes(rng, max_len=512):
    n = rng.randrange(max_len)
    return bytes(rng.randrange(256) for _ in range(n))


@pytest.mark.parametrize("seed", range(5))
class TestNoCrash:
    """Typed errors (or success) on arbitrary input, never a crash."""

    def _cases(self, seed):
        rng = random.Random(seed)
        return [_rand_bytes(rng) for _ in range(N_CASES)]

    def test_decompress_lzma(self, seed):
        for data in self._cases(seed):
            try:
                lzma_rs_tpu_torch.lzma_decompress(data)
            except LzmaRsError:
                pass

    def test_decompress_lzma2(self, seed):
        for data in self._cases(seed):
            try:
                lzma_rs_tpu_torch.lzma2_decompress(data)
            except LzmaRsError:
                pass

    def test_decompress_xz(self, seed):
        for data in self._cases(seed):
            try:
                lzma_rs_tpu_torch.xz_decompress(data)
            except LzmaRsError:
                pass

    def test_decompress_xz_cuda_on_cpu_slabs(self, seed):
        """Arbitrary bytes behind a valid stream header reach the planner
        of the ``cuda`` engine (CPU slabs: the plain version)."""
        head = lzma_rs_tpu_torch.xz_compress(b"")[:12]
        for data in self._cases(seed)[:20]:
            try:
                runtime.xz_decode(head + data, engine="cuda",
                                  device=torch.device("cpu"))
            except LzmaRsError:
                pass

    def test_stream_write(self, seed):
        for data in self._cases(seed):
            s = Stream()
            try:
                s.write(data)
                s.finish()
            except LzmaRsError:
                pass


@pytest.mark.parametrize("seed", range(3))
class TestRoundTrip:
    def _payloads(self, seed):
        rng = random.Random(1000 + seed)
        out = [_rand_bytes(rng, 2048) for _ in range(20)]
        # compressible payloads too
        out += [bytes([rng.randrange(4)]) * rng.randrange(1, 4096)
                for _ in range(10)]
        return out

    def test_roundtrip_lzma(self, seed):
        t = lzma_rs_tpu_torch
        for p in self._payloads(seed):
            assert t.lzma_decompress(t.lzma_compress(p)) == p

    def test_roundtrip_lzma2(self, seed):
        t = lzma_rs_tpu_torch
        for p in self._payloads(seed):
            assert t.lzma2_decompress(t.lzma2_compress(p)) == p

    def test_roundtrip_xz(self, seed):
        t = lzma_rs_tpu_torch
        for p in self._payloads(seed):
            assert t.xz_decompress(t.xz_compress(p)) == p


class TestDifferential:
    """compare_xz / interop_xz: agree with liblzma."""

    def test_interop_xz_decode(self):
        rng = random.Random(42)
        for _ in range(15):
            p = _rand_bytes(rng, 4096) + bytes(rng.randrange(2048))
            c = liblzma.compress(p, format=liblzma.FORMAT_XZ)
            assert lzma_rs_tpu_torch.xz_decompress(c) == p

    def test_interop_xz_encode(self):
        rng = random.Random(43)
        for _ in range(15):
            p = _rand_bytes(rng, 4096)
            c = lzma_rs_tpu_torch.xz_compress(p)
            assert liblzma.decompress(c) == p

    def test_compare_xz_on_corrupted(self):
        """Both fail, or both succeed with equal bytes, on flipped bits
        (either failing alone is allowed: implementations detect errors at
        different points, as for the reference)."""
        rng = random.Random(44)
        p = bytes(range(256)) * 16
        c = bytearray(liblzma.compress(p, format=liblzma.FORMAT_XZ))
        for _ in range(25):
            i = rng.randrange(len(c))
            old = c[i]
            c[i] ^= 1 << rng.randrange(8)
            ours = theirs = None
            try:
                ours = lzma_rs_tpu_torch.xz_decompress(bytes(c))
            except LzmaRsError:
                pass
            try:
                theirs = liblzma.decompress(bytes(c))
            except liblzma.LZMAError:
                pass
            if ours is not None and theirs is not None:
                assert ours == theirs
            c[i] = old

    def test_stream_chunked_equals_oneshot(self):
        rng = random.Random(45)
        for _ in range(8):
            p = _rand_bytes(rng, 2048)
            c = lzma_rs_tpu_torch.lzma_compress(p)
            chunk = rng.randrange(1, 64)
            s = Stream()
            for i in range(0, len(c), chunk):
                s.write(c[i:i + chunk])
            assert s.finish() == p
            assert lzma_rs_tpu_torch.lzma_decompress(c) == p
