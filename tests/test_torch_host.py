"""The port's copies of the host layers against their originals.

``lzma_rs_tpu_torch`` keeps its own copy of every JAX-free host module it
uses (``utils/``, ``formats/``, ``models/``, ``encode/``, ``native/``, the
stream classes, ``raw.py`` and the host half of ``parallel/runtime.py``).
Each copy's text differs from its original only in import lines and the
few lines listed here (the native library's name and location), and each is held against the original on
the same inputs, with exact equality: the planners' fields, the encoders'
bytes, and the decoders' bytes or their exception (class name and
message: each package raises its own classes) together with the fallback
reasons each package's own stats collector records.

Inputs come from a seeded numpy generator, stdlib ``lzma`` and the JAX
package's encoder.
"""

import dataclasses
import difflib
import lzma as liblzma
import os
import re

import pytest
import torch

import lzma_rs_tpu
import lzma_rs_tpu_torch
from lzma_rs_tpu.encode import lzma2_enc as jax_lzma2_enc
from lzma_rs_tpu.parallel import runtime as jax_runtime
from lzma_rs_tpu.utils import options as jax_options
from lzma_rs_tpu.utils import stats as jax_stats
from lzma_rs_tpu_torch.parallel import runtime
from lzma_rs_tpu_torch.utils import options as port_options
from lzma_rs_tpu_torch.utils import stats as port_stats

from test_torch_kernel_hostbuild import runs, stored_mid_segment, text

DATA = text(24000, 50)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_IMPORT = re.compile(r"^(\s*)(from|import) lzma_rs_tpu_torch(?=[.\s])")
# ... and so does a module the port imports by name
PORT_MODULE = re.compile(r'(import_module\(\s*")lzma_rs_tpu_torch(?=[."])')


def as_original(line: str) -> str:
    """A line of the port with its imports of the port's modules written as
    the original's."""
    return PORT_MODULE.sub(r"\1lzma_rs_tpu",
                           PORT_IMPORT.sub(r"\1\2 lzma_rs_tpu", line))

# Each copied module, with the original's lines that may differ beyond
# import lines: (kind, first line, last line) as difflib reports them.
COPIES = {
    **{os.path.join(pkg, f"{mod}.py"): [] for pkg, mods in (
        ("utils", ("__init__", "errors", "logging", "cursor", "options",
                   "crc")),
        ("formats", ("__init__", "lzma_header", "lzma2", "xz")),
        ("models", ("__init__", "state", "spec", "codecs")),
        ("encode", ("__init__", "rangecoder", "lzma_enc", "lzma2_enc",
                    "xz_enc")),
        ("native", ("__init__",)),
        ("", ("stream", "streams2", "raw")),
    ) for mod in mods},
    "native/lzma_native.cpp": [],
    # the comment naming the reference's fuzz targets
    "native/cov_runtime.cpp": [("replace", 9, 11)],
    # the usage example names the port
    "utils/stats.py": [("replace", 13, 13)],
    # the usage lines and prog= name the port, which is imported under the
    # original's name (line 67)
    "__main__.py": [("replace", 1, 1), ("replace", 7, 7), ("replace", 10, 11),
                    ("replace", 46, 46), ("replace", 67, 67)],
    # the docstring (1-21) and xz_decode_multihost (171-307), written for
    # torch.distributed; the host half between them is the original's
    "parallel/multihost.py": [
        ("replace", 1, 1), ("replace", 3, 7), ("replace", 9, 16),
        ("replace", 18, 21), ("replace", 171, 172), ("replace", 174, 180),
        ("replace", 182, 184), ("insert", 187, 186), ("insert", 188, 187),
        ("replace", 189, 189), ("replace", 194, 197), ("replace", 199, 205),
        ("insert", 207, 206), ("replace", 210, 210), ("replace", 212, 212),
        ("replace", 215, 245), ("insert", 247, 246), ("delete", 248, 254),
        ("replace", 258, 271),
    ],
    # the library's name and build location, the instrumented (fuzzing)
    # build's too (line 425, and its build directory made at 479)
    "native/loader.py": [
        ("replace", 1, 1), ("insert", 11, 10), ("delete", 17, 17),
        ("insert", 19, 18), ("insert", 375, 374), ("insert", 379, 378),
        ("replace", 417, 417), ("replace", 425, 425), ("insert", 479, 478),
    ],
}


def error_key(e):
    return None if e is None else (type(e).__name__, str(e))


def flip(data: bytes, pos: int) -> bytes:
    b = bytearray(data)
    b[pos] ^= 0x5A
    return bytes(b)


# -- the copy rule -------------------------------------------------------


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_a_copy_differs_from_its_original_only_where_allowed(rel):
    with open(os.path.join(REPO, "lzma_rs_tpu", rel)) as f:
        orig = f.read().splitlines()
    with open(os.path.join(REPO, "lzma_rs_tpu_torch", rel)) as f:
        # an import of the port's module stands for the original's
        copy = [as_original(ln) for ln in f.read().splitlines()]
    ops = difflib.SequenceMatcher(a=orig, b=copy, autojunk=False)
    assert [(kind, i1 + 1, i2) for kind, i1, i2, _, _ in ops.get_opcodes()
            if kind != "equal"] == COPIES[rel]


def copied_blocks(rel):
    """(first, last, body) of each block a port module marks as copied
    from ``lzma_rs_tpu/<rel>``, ranges as the marker gives them."""
    with open(os.path.join(REPO, "lzma_rs_tpu_torch", rel)) as f:
        text_ = f.read()
    marker = re.compile(rf"^# -- copied from lzma_rs_tpu/{re.escape(rel)}:"
                        r"([\d, -]+)\n\n", re.M)
    for m in marker.finditer(text_):
        body = text_[m.end():].splitlines()
        for part in m.group(1).split(","):
            a, _, b = part.strip().partition("-")
            a, b = int(a), int(b or a)
            while body and not body[0].strip():
                body = body[1:]
            yield a, b, body[: b - a + 1]
            body = body[b - a + 1:]


@pytest.mark.parametrize("rel,n_blocks", [("parallel/runtime.py", 8),
                                          ("__init__.py", 7)])
def test_copied_blocks_equal_their_originals(rel, n_blocks):
    with open(os.path.join(REPO, "lzma_rs_tpu", rel)) as f:
        orig = f.read().splitlines()
    blocks = list(copied_blocks(rel))
    assert len(blocks) == n_blocks
    for a, b, body in blocks:
        assert [as_original(ln) for ln in body] == orig[a - 1:b], (rel, a, b)


# -- the planners ------------------------------------------------------


def plan_key(plan):
    return ([dataclasses.asdict(lane) for lane in plan.lanes], plan.prefill,
            plan.total_out, error_key(plan.pending_error))


def xz_plan_key(result):
    plans, spans, flags, records, cursor = result[:5]
    return ([plan_key(p) for p in plans], spans, dataclasses.asdict(flags),
            [dataclasses.asdict(r) for r in records], cursor.pos,
            [error_key(d) for d in result[5:]])


def planned(rt, fn, *args, **kw):
    """The planner's result as plain fields, or its exception."""
    try:
        res = getattr(rt, fn)(*args, **kw)
    except Exception as e:  # the parity object under test
        return error_key(e)
    return xz_plan_key(res) if fn == "plan_xz" else (plan_key(res[0]),
                                                     res[1])


def xz_archives():
    stock = liblzma.compress(text(60000, 51), format=liblzma.FORMAT_XZ,
                             check=liblzma.CHECK_CRC64, preset=6)
    tpu = lzma_rs_tpu.xz_compress(DATA, tpu_profile=True, check_method=1)
    multi = lzma_rs_tpu.xz_compress(DATA, block_size=4096, check_method=4)
    stored = lzma_rs_tpu.xz_compress(DATA[:9000], level=0, check_method=10)
    return {
        "tpu_profile": tpu,
        "stock": stock,
        "multi_block": multi,
        "stored": stored,
        "payload_flip": flip(tpu, len(tpu) // 2),
        "header_flip": flip(multi, 14),
        "truncated": multi[:-30],
        "index_flip": flip(multi, len(multi) - 20),
        "garbage": b"\xfd7zXZ\x00" + bytes(40),
    }


def lzma2_streams():
    filt = [{"id": liblzma.FILTER_LZMA2, "preset": 6}]
    raw = [liblzma.compress(p, format=liblzma.FORMAT_RAW, filters=filt)
           for p in (text(1500, 52), runs(1800, 53), text(900, 54))]
    return {
        "multi_chunk": jax_lzma2_enc.lzma2_compress(DATA[:6000], level=6,
                                                    chunk_size=512),
        "multi_segment": raw[0][:-1] + raw[1][:-1] + raw[2],
        "stored_mid_segment": stored_mid_segment(),
        "stored_only": lzma_rs_tpu.lzma2_compress(DATA[:3000], level=0),
        "chunk_header_flip": flip(jax_lzma2_enc.lzma2_compress(
            DATA[:6000], level=6, chunk_size=512), 0),
        "truncated": raw[0][:-20],
    }


@pytest.mark.parametrize("name", list(xz_archives()))
def test_plan_xz_equals_the_original(name):
    xz = xz_archives()[name]
    for stop in (False, True):
        assert planned(runtime, "plan_xz", xz, stop_on_error=stop) == \
            planned(jax_runtime, "plan_xz", xz, stop_on_error=stop)


@pytest.mark.parametrize("name", list(lzma2_streams()))
def test_plan_lzma2_stream_equals_the_original(name):
    stream = lzma2_streams()[name]
    for start, out_base in ((0, 0), (0, 12345)):
        assert planned(runtime, "plan_lzma2_stream", stream, start,
                       out_base) == planned(jax_runtime, "plan_lzma2_stream",
                                            stream, start, out_base)


def test_the_planners_saw_every_shape():
    """The cases above reach the planners' branches they are named for."""
    a, s = xz_archives(), lzma2_streams()
    plans = jax_runtime.plan_xz(a["tpu_profile"])[0]
    assert len(plans) == 3 and all(p.lanes[0].lc == [0] for p in plans)
    assert any(p.prefill for p in jax_runtime.plan_xz(a["stored"])[0])
    assert len(jax_runtime.plan_lzma2_stream(
        s["multi_chunk"], 0, 0)[0].lanes[0].in_start) > 4
    assert len(jax_runtime.plan_lzma2_stream(
        s["multi_segment"], 0, 0)[0].lanes) == 3
    for bad in ("payload_flip", "truncated", "garbage"):
        assert isinstance(planned(jax_runtime, "plan_xz", a[bad]), tuple)
    assert planned(jax_runtime, "plan_xz", a["header_flip"])[0] == "XzError"


# -- the encoders --------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"block_size": 4096, "check_method": 1},
    {"tpu_profile": True, "check_method": 1},
    {"check_method": 10, "level": 1}, {"level": 0, "check_method": 4},
], ids=["default", "blocks-crc32", "tpu_profile", "sha256-level1", "stored"])
def test_xz_compress_equals_the_original(kw):
    assert lzma_rs_tpu_torch.xz_compress(DATA, **kw) == \
        lzma_rs_tpu.xz_compress(DATA, **kw)


@pytest.mark.parametrize("kw", [
    {}, {"level": 0}, {"level": 9, "props": 90, "dist_cap": 2048},
], ids=["default", "stored", "lc0-capped"])
def test_lzma2_compress_equals_the_original(kw):
    assert lzma_rs_tpu_torch.lzma2_compress(DATA, **kw) == \
        lzma_rs_tpu.lzma2_compress(DATA, **kw)


@pytest.mark.parametrize("sized", [False, True], ids=["eos", "sized"])
def test_lzma_compress_equals_the_original(sized):
    def opts(mod):
        if not sized:
            return mod.CompressOptions()
        return mod.CompressOptions(
            mod.WriteUnpackedSize.write_to_header(len(DATA)))

    assert lzma_rs_tpu_torch.lzma_compress_with_options(
        DATA, opts(port_options)) == lzma_rs_tpu.lzma_compress_with_options(
        DATA, opts(jax_options))
    if not sized:
        assert lzma_rs_tpu_torch.lzma_compress(DATA) == \
            lzma_rs_tpu.lzma_compress(DATA)


# -- the decoders under the native and spec engines ----------------------


def decode_cases():
    small = DATA[:4000]  # the spec engine decodes ~100 KB/s
    xz = lzma_rs_tpu.xz_compress(small, block_size=1024, check_method=4)
    l2 = lzma_rs_tpu.lzma2_compress(small)
    lz = lzma_rs_tpu.lzma_compress(small)
    return {
        "xz-clean": ("xz_decompress", xz),
        "xz-payload": ("xz_decompress", flip(xz, len(xz) // 3)),
        "xz-check": ("xz_decompress", flip(xz, 130)),
        "xz-truncated": ("xz_decompress", xz[:-9]),
        "xz-garbage": ("xz_decompress", b"not an xz stream"),
        "lzma2-clean": ("lzma2_decompress", l2),
        "lzma2-payload": ("lzma2_decompress", flip(l2, len(l2) // 2)),
        "lzma2-truncated": ("lzma2_decompress", l2[:-25]),
        "lzma-clean": ("lzma_decompress", lz),
        "lzma-payload": ("lzma_decompress", flip(lz, len(lz) // 2)),
        "lzma-short-header": ("lzma_decompress", lz[:7]),
    }


def outcome(pkg, stats, fn, data, *args):
    with stats.collect() as s:
        try:
            out = getattr(pkg, fn)(data, *args)
        except Exception as e:  # the parity object under test
            out = error_key(e)
    return out, s.fallbacks


@pytest.mark.parametrize("backend", ["native", "spec", "auto",
                                     "auto-gate-open"])
@pytest.mark.parametrize("case", list(decode_cases()))
def test_decode_equals_the_original(case, backend, monkeypatch):
    """``auto`` runs on a host without a card, with the small-workload
    gate as it is and opened (every stream then passes it)."""
    fn, data = decode_cases()[case]
    if backend.startswith("auto"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        if backend == "auto-gate-open":
            monkeypatch.setenv("LZMA_RS_TPU_AUTO_MIN_LANES", "1")
            monkeypatch.setenv("LZMA_RS_TPU_AUTO_MIN_OUT", "1")
        backend = "auto"
    monkeypatch.setenv("LZMA_RS_TPU_BACKEND", backend)
    got = outcome(lzma_rs_tpu_torch, port_stats, fn, data)
    want = outcome(lzma_rs_tpu, jax_stats, fn, data)
    assert got == want
    if case.endswith("clean"):
        assert got[0] == DATA[:4000]
    else:
        assert isinstance(got[0], tuple), got[0][:40]


def raw_cases():
    """Raw LZMA streams that the device engines leave to the host: an
    unknown size (end marker), lc+lp = 5 (a known-size stream's header
    rewritten to lc=4, lp=1) and a memlimit."""
    small = DATA[:4000]
    sized = lzma_rs_tpu.lzma_compress_with_options(
        small, jax_options.CompressOptions(
            jax_options.WriteUnpackedSize.write_to_header(len(small))))
    wide = bytearray(sized)
    wide[0] = (2 * 5 + 1) * 9 + 4  # pb=2, lp=1, lc=4
    return {"unknown-size": (lzma_rs_tpu.lzma_compress(small), None),
            "lc+lp=5": (bytes(wide), None),
            "memlimit": (sized, 1 << 20)}


@pytest.mark.parametrize("case", list(raw_cases()))
def test_raw_lzma_off_the_device_equals_the_original(case, monkeypatch):
    """``cuda`` (with a card that ``cuda_device`` pretends is there)
    against the JAX package's ``tpu``: the same bytes or error, and the
    same ``stats.fallbacks`` (none)."""
    data, memlimit = raw_cases()[case]
    monkeypatch.setattr(runtime, "cuda_device",
                        lambda device=None: torch.device("cpu"))

    def run(pkg, stats, options, backend):
        monkeypatch.setenv("LZMA_RS_TPU_BACKEND", backend)
        return outcome(pkg, stats, "lzma_decompress_with_options", data,
                       options.Options(memlimit=memlimit))

    got = run(lzma_rs_tpu_torch, port_stats, port_options, "cuda")
    want = run(lzma_rs_tpu, jax_stats, jax_options, "tpu")
    assert got == want
    assert got[1] == []
    if case != "lc+lp=5":
        assert got[0] == DATA[:4000]
