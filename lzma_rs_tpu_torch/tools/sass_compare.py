"""Compare the SASS of kernel libraries built from two source trees.

    python -m lzma_rs_tpu_torch.tools.sass_compare OTHER_CSRC [LIB ...]
    python -m lzma_rs_tpu_torch.tools.sass_compare --record OUT OTHER_CSRC [LIB ...]

builds each named library of ``ops/build.py``'s ``LIBRARIES`` (default
``segdec``, the decoder) from this checkout's ``csrc/`` and from
``OTHER_CSRC`` (another checkout's ``lzma_rs_tpu_torch/csrc``) with the same
nvcc flags, into a temporary directory, reads both with ``cuobjdump
-sass`` and prints, kernel by kernel, whether the two instruction streams
are identical (addresses and encodings left out) and their lengths. It
exits 1 when a kernel differs or is missing on one side. A change to a
shared header that must not change a kernel's code is checked so: the
lane engine's team in ``lzma_lane.cuh`` against the decoder's build.
``--record`` writes instead the digests of ``OTHER_CSRC``'s kernels
(instructions and a SHA-256 a kernel, with nvcc's version) to ``OUT``,
which :func:`check_recorded` holds later builds to without the other
tree: ``decoder_sass.json`` beside this file holds the decoder's
(``segdec``, ``segvar``, ``stepcost``) and ``chip_smoke.py`` checks it.
Needs the CUDA toolkit (nvcc, cuobjdump); no card.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile

from lzma_rs_tpu_torch.ops import build


def sass_by_kernel(so_path: str) -> dict:
    """kernel name -> its instructions (text, no addresses or encodings)."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", so_path], capture_output=True,
                         text=True, check=True).stdout
    kernels, cur = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            kernels[cur] = []
        elif cur is not None and "/*" in line and ";" in line:
            ins = line.split("*/", 1)[-1].split(";", 1)[0]
            kernels[cur].append(" ".join(ins.split()))
    return kernels


def build_from(csrc: str, lib: build.Library, where: str) -> str:
    """Compile ``lib``'s main source from the tree ``csrc`` into ``where``
    with the port's nvcc flags; returns the library's path."""
    path = os.path.join(where, f"{lib.name}-{abs(hash(csrc))}.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", path,
                    os.path.join(csrc, lib.sources[0])],
                   capture_output=True, text=True, check=True)
    return path


def compare(other_csrc: str, names=("segdec",)) -> list:
    """``(library, kernel, identical, this tree's length, the other's)``
    for every kernel of the named libraries on either side."""
    libs = {lib.name: lib for lib in build.LIBRARIES}
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            lib = libs[name]
            here = sass_by_kernel(build_from(build.CSRC, lib, tmp))
            there = sass_by_kernel(build_from(other_csrc, lib, tmp))
            for k in sorted(set(here) | set(there)):
                a, b = here.get(k), there.get(k)
                rows.append((name, k, a is not None and a == b,
                             len(a or ()), len(b or ())))
    return rows


RECORDED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "decoder_sass.json")


def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (its build)."""
    out = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def digests(so_path: str) -> dict:
    """kernel name -> [instructions, SHA-256 of their text]."""
    return {k: [len(v), hashlib.sha256("\n".join(v).encode()).hexdigest()]
            for k, v in sass_by_kernel(so_path).items()}


def record(out: str, other_csrc: str, names=("segdec",)) -> dict:
    """Write the digests of ``names`` built from ``other_csrc`` to
    ``out``; returns what it wrote."""
    libs = {lib.name: lib for lib in build.LIBRARIES}
    rec = {"nvcc": nvcc_version(), "flags": list(build.NVCC_FLAGS),
           "libraries": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            rec["libraries"][name] = digests(
                build_from(other_csrc, libs[name], tmp))
    with open(out, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    return rec


def check_recorded(paths: dict, recorded: str = RECORDED) -> tuple:
    """Hold built libraries (``{name: .so path}``, built with
    ``build.NVCC_FLAGS``) to the recorded digests. Returns ``(comparable,
    rows)``: comparable is False when this nvcc or the flags are not the
    recording's (the SASS may then differ for that alone); rows are
    ``(library, kernel, identical, instructions here, recorded)``."""
    with open(recorded) as f:
        rec = json.load(f)
    comparable = (rec["nvcc"] == nvcc_version()
                  and rec["flags"] == list(build.NVCC_FLAGS))
    rows = []
    for name, path in paths.items():
        here, there = digests(path), rec["libraries"].get(name, {})
        for k in sorted(set(here) | set(there)):
            a, b = here.get(k), there.get(k)
            rows.append((name, k, a is not None and a == b,
                         (a or [0])[0], (b or [0])[0]))
    return comparable, rows


def main(argv=None) -> int:
    """The command line; 0 when every kernel's SASS is identical (or the
    digests were written)."""
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--record"] and len(argv) >= 3:
        rec = record(argv[1], argv[2], tuple(argv[3:]) or ("segdec",))
        n = sum(len(v) for v in rec["libraries"].values())
        print(f"recorded {n} kernels of {sorted(rec['libraries'])} "
              f"({rec['nvcc']}) in {argv[1]}")
        return 0
    if not argv or argv[0].startswith("--"):
        print(__doc__.strip().splitlines()[2], file=sys.stderr)
        return 2
    rows = compare(argv[0], tuple(argv[1:]) or ("segdec",))
    for name, kernel, same, n_here, n_there in rows:
        print(f"{name} {kernel}: {'identical' if same else 'DIFFERS'} "
              f"({n_here} instructions here, {n_there} there)")
    return 0 if rows and all(r[2] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
