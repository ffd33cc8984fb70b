"""The port's public surface against the JAX package's: the streaming classes
(``stream.Stream``, ``streams2.Lzma2Stream`` / ``XzStream``), ``raw``'s
decoders and the package namespaces.

Every input is fed to the port's class and to the original in pieces of 1,
7 and 4,096 bytes and whole, under the ``native`` engine and the ``spec``
one (each package's ``native.loader.load`` made to return ``None``). What
is compared: each ``write``'s return value (the ``unpacked size``
handling: a stream whose size is reached consumes no more), the output of
``finish``, and on a truncated or corrupted input the exception's class
name and message, then ``finish``'s after the failed write (a poisoned
stream). Each package is given its own ``Options``.

Inputs come from a seeded numpy generator (text and random bytes), stdlib
``lzma`` and the port's encoder.
"""

import functools
import io
import lzma as liblzma

import numpy as np
import pytest

import lzma_rs_tpu
import lzma_rs_tpu_torch
from lzma_rs_tpu import raw as jax_raw
from lzma_rs_tpu import stream as jax_stream
from lzma_rs_tpu import streams2 as jax_streams2
from lzma_rs_tpu.formats import lzma_header as jax_header
from lzma_rs_tpu.native import loader as jax_loader
from lzma_rs_tpu.utils import options as jax_options
from lzma_rs_tpu.utils.cursor import ByteCursor as JaxCursor
from lzma_rs_tpu_torch import raw as port_raw
from lzma_rs_tpu_torch import stream as port_stream
from lzma_rs_tpu_torch import streams2 as port_streams2
from lzma_rs_tpu_torch.formats import lzma_header as port_header
from lzma_rs_tpu_torch.native import loader as port_loader
from lzma_rs_tpu_torch.tools.corpus import raw_lzma2
from lzma_rs_tpu_torch.utils import options as port_options
from lzma_rs_tpu_torch.utils.cursor import ByteCursor

from test_torch_kernel_hostbuild import text

PIECES = {"1": 1, "7": 7, "4096": 4096, "whole": None}
ENGINES = ("native", "spec")
PORT = {"stream": port_stream.Stream, "lzma2": port_streams2.Lzma2Stream,
        "xz": port_streams2.XzStream, "raw": port_raw,
        "options": port_options, "header": port_header, "cursor": ByteCursor}
JAX = {"stream": jax_stream.Stream, "lzma2": jax_streams2.Lzma2Stream,
       "xz": jax_streams2.XzStream, "raw": jax_raw, "options": jax_options,
       "header": jax_header, "cursor": JaxCursor}


def data(n: int, seed: int) -> bytes:
    """Seeded text with a run of random bytes in the middle."""
    rng = np.random.default_rng(seed)
    t = text(n, seed)
    noise = rng.integers(0, 256, size=n // 8, dtype=np.uint8).tobytes()
    return (t[: n // 2] + noise + t[n // 2:])[:n]


def variants(packed: bytes) -> dict:
    """The input whole, cut short (inside its first 10 bytes, a header,
    and later) and with a byte of its payload flipped."""
    bad = bytearray(packed)
    bad[len(bad) // 2] ^= 0x5A
    return {"clean": packed, "cut in the header": packed[:10],
            "truncated": packed[: len(packed) * 3 // 5],
            "corrupt": bytes(bad)}


VARIANTS = ["clean", "cut in the header", "truncated", "corrupt"]


def options(pkg, spec):
    """One package's ``Options`` for a spec: (size mode, its value,
    memlimit, allow_incomplete)."""
    mode, value, memlimit, incomplete = spec
    o = pkg["options"]
    size = getattr(o.UnpackedSize, mode)(
        *(() if mode == "read_from_header" else (value,)))
    return o.Options(unpacked_size=size, memlimit=memlimit,
                     allow_incomplete=incomplete)


HEADER = ("read_from_header", None, None, False)


@functools.lru_cache(maxsize=None)
def lzma_inputs() -> dict:
    """Raw LZMA (``.lzma``) streams and the options to read each with."""
    d = data(6000, 1)
    opts = port_options
    sized = lzma_rs_tpu_torch.lzma_compress_with_options(
        d, opts.CompressOptions(opts.WriteUnpackedSize.write_to_header(
            len(d))))
    skip = lzma_rs_tpu_torch.lzma_compress_with_options(
        d, opts.CompressOptions(
            opts.WriteUnpackedSize.skip_writing_to_header()))
    return {
        "stdlib alone (end marker)": (liblzma.compress(
            d, format=liblzma.FORMAT_ALONE, preset=6), HEADER),
        "port, size in the header": (sized, HEADER),
        "port, end marker": (lzma_rs_tpu_torch.lzma_compress(d), HEADER),
        "port, no size field": (skip, ("use_provided", None, None, False)),
        "size given short of the stream": (sized, (
            "read_header_but_use_provided", len(d) // 3, None, False)),
        "memlimit": (sized, ("read_from_header", None, 1024, False)),
        "allow_incomplete": (sized, ("read_from_header", None, None, True)),
    }


@functools.lru_cache(maxsize=None)
def lzma2_inputs() -> dict:
    d = data(9000, 2)
    segs = [data(3000, 10 + i) for i in range(3)]
    return {
        "stdlib preset 6": raw_lzma2(d, 6),
        "stdlib lc=0 lp=2 pb=1": raw_lzma2(d, 6, lc=0, lp=2, pb=1),
        "port level 6, 1 KiB chunks": lzma_rs_tpu_torch.lzma2_compress(
            d, level=6),
        "port stored chunks": lzma_rs_tpu_torch.lzma2_compress(d, level=0),
        "three dict-reset segments": b"".join(
            raw_lzma2(s)[:-1] for s in segs) + b"\x00",
    }


@functools.lru_cache(maxsize=None)
def xz_inputs() -> dict:
    d = data(8000, 3)
    out = {f"stdlib check {name}": liblzma.compress(
        d, format=liblzma.FORMAT_XZ, check=check) for name, check in (
        ("none", liblzma.CHECK_NONE), ("crc32", liblzma.CHECK_CRC32),
        ("crc64", liblzma.CHECK_CRC64), ("sha256", liblzma.CHECK_SHA256))}
    out["port, 2 KiB blocks, crc64"] = lzma_rs_tpu_torch.xz_compress(
        d, block_size=2048, check_method=4)
    out["port tpu_profile, crc32"] = lzma_rs_tpu_torch.xz_compress(
        d, tpu_profile=True, check_method=1)
    return out


def error_key(e):
    return (type(e).__name__, str(e))


def feed(make, packed: bytes, piece) -> tuple:
    """Feed ``packed`` to a new stream in pieces: (each write's return,
    ``get_output`` before ``finish``, ``finish``'s bytes or error, and
    after a failed write its error and ``finish``'s)."""
    s = make()
    step = piece or max(1, len(packed))
    written = []
    try:
        for off in range(0, len(packed), step):
            written.append(s.write(packed[off:off + step]))
    except Exception as e:  # the parity object under test
        try:
            after = s.finish()
        except Exception as f:
            after = error_key(f)
        return written, error_key(e), after
    seen = s.get_output()
    try:
        return written, seen, s.finish()
    except Exception as e:
        return written, seen, error_key(e)


@pytest.fixture(params=ENGINES)
def engine(request, monkeypatch):
    """``native``, or ``spec``: both packages' native library withheld."""
    if request.param == "spec":
        monkeypatch.setattr(port_loader, "load", lambda: None)
        monkeypatch.setattr(jax_loader, "load", lambda: None)
    return request.param


def both(kind, packed, piece, **kw):
    """The port's and the original's run of one input."""
    return [feed(lambda: pkg[kind](**{k: v(pkg) for k, v in kw.items()}),
                 packed, piece) for pkg in (PORT, JAX)]


@pytest.mark.parametrize("piece", list(PIECES))
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(lzma_inputs()))
def test_stream_equals_the_original(name, variant, piece, engine):
    packed, spec = lzma_inputs()[name]
    got, want = both("stream", variants(packed)[variant], PIECES[piece],
                     options=lambda pkg: options(pkg, spec))
    assert got == want
    if variant == "clean" and spec == HEADER:
        assert got[2] == data(6000, 1)


@pytest.mark.parametrize("piece", list(PIECES))
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(lzma2_inputs()))
def test_lzma2_stream_equals_the_original(name, variant, piece, engine):
    packed = lzma2_inputs()[name]
    got, want = both("lzma2", variants(packed)[variant], PIECES[piece])
    assert got == want
    if variant == "clean":
        assert got[2] == lzma_rs_tpu_torch.lzma2_decompress(packed)
    elif variant in ("cut in the header", "truncated"):
        assert isinstance(got[2], tuple)


@pytest.mark.parametrize("piece", list(PIECES))
@pytest.mark.parametrize("variant", VARIANTS + ["corrupt footer"])
@pytest.mark.parametrize("name", list(xz_inputs()))
def test_xz_stream_equals_the_original(name, variant, piece, engine):
    packed = xz_inputs()[name]
    if variant == "corrupt footer":
        x = bytearray(packed)
        x[-7] ^= 0x01  # the backward size
        x = bytes(x)
    else:
        x = variants(packed)[variant]
    got, want = both("xz", x, PIECES[piece])
    assert got == want
    if variant == "clean":
        assert got[2] == data(8000, 3)
    elif variant in ("cut in the header", "truncated"):
        assert isinstance(got[2], tuple)


def test_a_stream_writes_into_its_sink():
    x = xz_inputs()["stdlib check crc64"]
    sinks = [io.BytesIO(), io.BytesIO()]
    for pkg, sink in zip((PORT, JAX), sinks):
        s = pkg["xz"](output=sink)
        for off in range(0, len(x), 100):
            s.write(x[off:off + 100])
        assert s.get_output() is None and s.finish() == b""
    assert sinks[0].getvalue() == sinks[1].getvalue() == data(8000, 3)


def raw_lzma(pkg, packed, spec):
    """``raw.LzmaDecoder`` over the payload after the header that
    ``spec``'s options read."""
    cursor = pkg["cursor"](packed)
    opts = options(pkg, spec)
    params = pkg["header"].read_header(cursor, opts)
    dec = pkg["raw"].LzmaDecoder(params, opts.memlimit)
    return dec.decompress(packed[cursor.pos:])


def outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # the parity object under test
        return error_key(e)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", ["port, size in the header",
                                  "stdlib alone (end marker)", "memlimit"])
def test_raw_lzma_decoder_equals_the_original(name, variant, engine):
    packed, spec = lzma_inputs()[name]
    x = variants(packed)[variant]
    got, want = (outcome(raw_lzma, pkg, x, spec) for pkg in (PORT, JAX))
    assert got == want
    if variant == "clean" and spec == HEADER:
        assert got == data(6000, 1)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(lzma2_inputs()))
def test_raw_lzma2_decoder_equals_the_original(name, variant, engine):
    x = variants(lzma2_inputs()[name])[variant]
    got, want = (outcome(pkg["raw"].Lzma2Decoder().decompress, x)
                 for pkg in (PORT, JAX))
    assert got == want


def test_the_public_names_equal_the_originals():
    assert set(lzma_rs_tpu_torch.__all__) == set(lzma_rs_tpu.__all__)
    for name in lzma_rs_tpu_torch.__all__:
        assert getattr(lzma_rs_tpu_torch, name) is not None
    d = lzma_rs_tpu_torch.decompress
    for cls, mod in ((d.Stream, port_stream), (d.Lzma2Stream, port_streams2),
                     (d.XzStream, port_streams2),
                     (lzma_rs_tpu_torch.Stream, port_stream)):
        assert cls.__module__ == mod.__name__
    assert d.raw.LzmaDecoder is port_raw.LzmaDecoder
    assert lzma_rs_tpu_torch.raw is port_raw
    assert d.Options is port_options.Options
    assert d.UnpackedSize is port_options.UnpackedSize
    assert lzma_rs_tpu_torch.compress.Options is port_options.CompressOptions
    assert lzma_rs_tpu_torch.compress.UnpackedSize \
        is port_options.WriteUnpackedSize
    assert lzma_rs_tpu_torch.error.LzmaRsError \
        is lzma_rs_tpu_torch.LzmaRsError is not lzma_rs_tpu.LzmaRsError
    with pytest.raises(AttributeError):
        lzma_rs_tpu_torch.no_such_name
