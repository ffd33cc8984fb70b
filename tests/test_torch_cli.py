"""The port's CLI (``python -m lzma_rs_tpu_torch``) end to end, against
the JAX package's (``python -m lzma_rs_tpu``).

- ``tests/test_cli.py``'s four cases, on seeded data;
- ``compress`` writes the same bytes (and the same summary line) as the
  original for the same arguments, and ``info`` prints the same text;
- ``decompress`` routes through the port's backends
  (``LZMA_RS_TPU_BACKEND``): ``cuda`` raises without a card;
- the CLI's process imports no ``jax`` and nothing of ``lzma_rs_tpu``
  (``python -X importtime`` lists every module a process imports).
"""

import lzma as liblzma
import os
import re
import subprocess
import sys

import pytest

from test_torch_kernel_hostbuild import runs, text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = text(150000, 61)


def run_cli(*args, input=None, pkg="lzma_rs_tpu_torch", env=None,
            check=True, python=()):
    environ = {k: v for k, v in os.environ.items()
               if k != "LZMA_RS_TPU_BACKEND"}
    environ.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", **(env or {}))
    return subprocess.run(
        [sys.executable, *python, "-m", pkg, *args], input=input,
        capture_output=True, cwd=REPO, check=check, env=environ,
        timeout=300)


def test_compress_decompress_xz():
    data = DATA[:60000]
    r = run_cli("compress", "--check", "crc32", input=data)
    out = run_cli("decompress", input=r.stdout)
    assert out.stdout == data


def test_lzma_format():
    data = text(2000, 62)
    r = run_cli("compress", "--format", "lzma", input=data)
    out = run_cli("decompress", "--format", "lzma", input=r.stdout)
    assert out.stdout == data


def test_info(tmp_path):
    p = tmp_path / "a.xz"
    run_cli("compress", "-o", str(p), "--block-size", "65536", input=DATA)
    r = run_cli("info", str(p))
    assert b"blocks: 3" in r.stdout


def test_sniff_auto():
    data = runs(3000, 63)
    r = run_cli("compress", "--format", "lzma", input=data)
    out = run_cli("decompress", input=r.stdout)  # auto-sniffs raw lzma
    assert out.stdout == data


COMPRESS_ARGS = {
    "xz-default": [],
    "xz-sha256-16k": ["--check", "sha256", "--block-size", "16384"],
    "xz-none-level0": ["--check", "none", "--level", "0",
                       "--block-size", "4096"],
    "lzma2-level3": ["--format", "lzma2", "--level", "3"],
    "lzma": ["--format", "lzma"],
}


@pytest.mark.parametrize("case", list(COMPRESS_ARGS))
def test_compress_writes_the_original_bytes(case, tmp_path):
    args = COMPRESS_ARGS[case]
    src = tmp_path / "in.txt"
    src.write_bytes(DATA[:40000])
    got = run_cli("compress", *args, str(src))
    want = run_cli("compress", *args, str(src), pkg="lzma_rs_tpu")
    assert got.stdout == want.stdout and got.stdout
    assert got.stderr == want.stderr  # "N -> M bytes (P%)"
    fmt = args[args.index("--format") + 1] if "--format" in args else "xz"
    back = run_cli("decompress", "--format", fmt, input=got.stdout)
    assert back.stdout == DATA[:40000]


def test_info_prints_the_original_text(tmp_path):
    """A multi-block archive of the port's encoder and a one-block one of
    stdlib ``lzma``."""
    many = tmp_path / "many.xz"
    run_cli("compress", "-o", str(many), "--block-size", "32768",
            "--check", "crc64", input=DATA)
    one = tmp_path / "one.xz"
    one.write_bytes(liblzma.compress(DATA[:9000], format=liblzma.FORMAT_XZ,
                                     check=liblzma.CHECK_SHA256))
    for p, blocks in ((many, 5), (one, 1)):
        got = run_cli("info", str(p))
        want = run_cli("info", str(p), pkg="lzma_rs_tpu")
        assert got.stdout == want.stdout
        assert f"blocks: {blocks} ".encode() in got.stdout


def test_decompress_routes_through_the_backends(tmp_path):
    p = tmp_path / "a.xz"
    run_cli("compress", "-o", str(p), "--block-size", "8192",
            input=DATA[:30000])
    for backend in ("native", "spec"):
        r = run_cli("decompress", str(p),
                    env={"LZMA_RS_TPU_BACKEND": backend})
        assert r.stdout == DATA[:30000]
    r = run_cli("decompress", str(p), env={
        "LZMA_RS_TPU_BACKEND": "cuda", "CUDA_VISIBLE_DEVICES": ""},
        check=False)
    assert r.returncode != 0 and r.stdout == b""
    assert b"needs a CUDA device" in r.stderr


def test_the_cli_imports_no_jax(tmp_path):
    p = tmp_path / "a.xz"
    run_cli("compress", "-o", str(p), "--block-size", "16384",
            input=DATA[:50000])
    r = run_cli("decompress", str(p), python=("-X", "importtime"))
    assert r.stdout == DATA[:50000]
    mods = re.findall(rb"^import time:.*\|\s*(\S+)\s*$", r.stderr, re.M)
    names = {m.decode().strip() for m in mods}
    assert "lzma_rs_tpu_torch.parallel.runtime" in names
    assert {"torch"} <= names
    assert [n for n in names if n == "jax" or n.startswith("jax.")] == []
    assert [n for n in names if n == "lzma_rs_tpu"
            or n.startswith("lzma_rs_tpu.")] == []
