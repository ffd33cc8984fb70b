"""Command-line interface: ``python -m lzma_rs_tpu_torch``.

The reference library ships no CLI (SURVEY.md §1); this thin tool makes
the framework usable standalone and doubles as an end-to-end exerciser.

Usage:
  python -m lzma_rs_tpu_torch compress   [-o OUT] [--format xz|lzma|lzma2]
                                   [--level N] [--block-size N]
                                   [--check none|crc32|crc64|sha256] [FILE]
  python -m lzma_rs_tpu_torch decompress [-o OUT] [--format xz|lzma|lzma2] [FILE]
  python -m lzma_rs_tpu_torch info FILE            # block/chunk table of a .xz
FILE defaults to stdin; output to stdout unless -o.
"""

from __future__ import annotations

import argparse
import sys

CHECKS = {"none": 0, "crc32": 1, "crc64": 4, "sha256": 0x0A}


def _read(path):
    if path in (None, "-"):
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def _write(data, path):
    if path in (None, "-"):
        sys.stdout.buffer.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


def _sniff(data: bytes) -> str:
    if data[:6] == bytes([0xFD, 0x37, 0x7A, 0x58, 0x5A, 0x00]):
        return "xz"
    return "lzma"


def main(argv=None):
    """CLI entry point: compress/decompress lzma/lzma2/xz streams."""
    ap = argparse.ArgumentParser(prog="lzma_rs_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress")
    c.add_argument("file", nargs="?")
    c.add_argument("-o", "--output")
    c.add_argument("--format", choices=["xz", "lzma", "lzma2"], default="xz")
    c.add_argument("--level", type=int, default=6)
    c.add_argument("--block-size", type=int, default=None)
    c.add_argument("--check", choices=list(CHECKS), default="crc64")

    d = sub.add_parser("decompress")
    d.add_argument("file", nargs="?")
    d.add_argument("-o", "--output")
    d.add_argument("--format", choices=["auto", "xz", "lzma", "lzma2"],
                   default="auto")

    i = sub.add_parser("info")
    i.add_argument("file")

    args = ap.parse_args(argv)
    import lzma_rs_tpu_torch as lzma_rs_tpu

    if args.cmd == "compress":
        data = _read(args.file)
        if args.format == "xz":
            out = lzma_rs_tpu.xz_compress(
                data, block_size=args.block_size,
                check_method=CHECKS[args.check], level=args.level,
            )
        elif args.format == "lzma2":
            out = lzma_rs_tpu.lzma2_compress(data, level=args.level)
        else:
            out = lzma_rs_tpu.lzma_compress(data)
        _write(out, args.output)
        n_in, n_out = len(data), len(out)
        print(
            f"{n_in} -> {n_out} bytes"
            f" ({n_out / max(n_in, 1) * 100:.1f}%)",
            file=sys.stderr,
        )
    elif args.cmd == "decompress":
        data = _read(args.file)
        fmt = args.format if args.format != "auto" else _sniff(data)
        fn = {
            "xz": lzma_rs_tpu.xz_decompress,
            "lzma": lzma_rs_tpu.lzma_decompress,
            "lzma2": lzma_rs_tpu.lzma2_decompress,
        }[fmt]
        _write(fn(data), args.output)
    else:  # info
        data = _read(args.file)
        from lzma_rs_tpu_torch.parallel.multihost import scan_blocks

        flags, spans, total_out = scan_blocks(data)
        check = {0: "None", 1: "CRC32", 4: "CRC64", 0x0A: "SHA-256"}[
            flags.check_method
        ]
        print(f"streams: 1   blocks: {len(spans)}   check: {check}")
        print(f"compressed: {len(data)}   uncompressed: {total_out}")
        for idx, s in enumerate(spans):
            print(
                f"  block {idx}: packed {s.payload_len:>10}  "
                f"unpacked {s.out_len:>10}  at {s.out_base}"
            )


if __name__ == "__main__":
    main()
