"""Compare the SASS of kernel libraries built from two source trees.

    python -m lzma_rs_tpu_torch.tools.sass_compare OTHER_CSRC [LIB ...]

builds each named library of ``ops/build.py``'s ``LIBRARIES`` (default
``segdec``, the decoder) from this checkout's ``csrc/`` and from
``OTHER_CSRC`` (another checkout's ``lzma_rs_tpu_torch/csrc``) with the same
nvcc flags, into a temporary directory, reads both with ``cuobjdump
-sass`` and prints, kernel by kernel, whether the two instruction streams
are identical (addresses and encodings left out) and their lengths. It
exits 1 when a kernel differs or is missing on one side. A change to a
shared header that must not change a kernel's code is checked so: the
lane engine's option bits in ``lzma_lane.cuh`` against the decoder's
build. Needs the CUDA toolkit (nvcc, cuobjdump); no card.
"""

from __future__ import annotations

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


def main(argv=None) -> int:
    """The command line; 0 when every kernel's SASS is identical."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__.strip().splitlines()[2], file=sys.stderr)
        return 2
    rows = compare(argv[0], tuple(argv[1:]) or ("segdec",))
    for name, kernel, same, n_here, n_there in rows:
        print(f"{name} {kernel}: {'identical' if same else 'DIFFERS'} "
              f"({n_here} instructions here, {n_there} there)")
    return 0 if rows and all(r[2] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
