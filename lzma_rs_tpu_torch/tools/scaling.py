"""Process scaling of the multi-process decode: ``benches/scaling.py`` with
its workers on the card.

    python -m lzma_rs_tpu_torch.tools.scaling [--mb 16]
        [--engine cuda|native|auto] [--device cpu] [--out PATH]

It decodes the tpu_profile archive (``tools/corpus.py``: the interpreter's
stdlib sources, 8 KiB blocks) with ``xz_decode_multihost`` in 1, 2 and 4
processes, a gloo group over loopback, every rank on card ``rank %
cards`` (``--device cpu``: on the CPU, the kernel's plain version, so use
``--engine native`` or a small ``--mb`` there; without a card and without
it the tool raises). Each process count runs twice, the best wall time
kept; it prints the card's name and power limit (``nvidia-smi``) and one
JSON line: wall, decode and gather-wait seconds (the slowest rank's) per
process count, the decode scaling efficiency ``decode_1 / decode_n`` and
MB/s. It writes a file only under ``--out``.

On one host the processes share its cores and its card, so the wall time
measures the protocol's cost, not added compute: the decode share a rank
should fall as 1/n, and the gather wait is the exchange not hidden behind
the decode.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from lzma_rs_tpu_torch.tools import multihost_demo


def worker(rank: int, world: int, port: int, path: str, engine: str,
           device) -> str:
    """One timed decode on one rank, after a warm one: the ``RESULT`` line
    (rank, bytes, wall, decode and gather-wait seconds)."""
    import torch.distributed as dist

    from lzma_rs_tpu_torch.parallel import multihost
    from lzma_rs_tpu_torch.utils import stats as stats_mod

    dev = multihost_demo.rank_device(rank, device)
    if world > 1:
        multihost_demo.init_group(rank, world, port)
    try:
        with open(path, "rb") as f:
            data = f.read()
        out = multihost.xz_decode_multihost(data, engine, dev)  # warm
        with stats_mod.collect() as st:
            t0 = time.perf_counter()
            out = multihost.xz_decode_multihost(data, engine, dev)
            dt = time.perf_counter() - t0
    finally:
        if world > 1:
            dist.destroy_process_group()
    return (f"RESULT {rank} {len(out)} {dt:.6f} "
            f"{st.multihost_decode_seconds:.6f} "
            f"{st.multihost_gather_wait_seconds:.6f}")


def run(n: int, path: str, engine: str, device) -> tuple:
    """(wall, decode, gather wait) seconds of ``n`` ranks, each the
    slowest rank's."""
    port = multihost_demo.free_port()
    extra = ["--engine", engine] + (["--device", device] if device else [])
    res = multihost_demo.launch(
        [[sys.executable, "-m", "lzma_rs_tpu_torch.tools.scaling",
          "--worker", str(r), str(n), str(port), path, *extra]
         for r in range(n)], timeout_s=900)
    rows = []
    for rc, out, err in res:
        if rc != 0:
            raise RuntimeError(f"a rank of {n} exited {rc}: {err[-2000:]}")
        rows += [ln.split() for ln in out.splitlines()
                 if ln.startswith("RESULT")]
    if len(rows) != n:
        raise RuntimeError(f"{len(rows)} results from {n} ranks")
    return tuple(max(float(r[i]) for r in rows) for i in (3, 4, 5))


def card_line(device) -> str:
    """The card's ``nvidia-smi`` name and power limit, or what ran instead."""
    if device == "cpu":
        return "cpu (no card)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"


def measure(mb: float, procs, engine: str, device=None) -> dict:
    """The scaling result of ``procs`` process counts on ``mb`` MB."""
    from lzma_rs_tpu_torch.tools import corpus

    data, _ = corpus.stdlib_corpus(int(mb * 1e6))
    with tempfile.NamedTemporaryFile(suffix=".xz", delete=False) as f:
        f.write(corpus.tpu_archive(data))
        path = f.name
    try:
        wall, dec, wait = {}, {}, {}
        for n in procs:
            best = min((run(n, path, engine, device) for _ in range(2)),
                       key=lambda r: r[0])
            wall[n], dec[n], wait[n] = best
    finally:
        os.unlink(path)
    if 1 in dec and not dec[1]:
        dec[1] = wall[1]  # one process is the single-process decode
    n_mb = len(data) / 1e6
    return {
        "corpus_mb": n_mb,
        "engine": engine,
        "device": card_line(device),
        "wall_s": {str(n): t for n, t in wall.items()},
        "decode_s": {str(n): t for n, t in dec.items()},
        "gather_wait_s": {str(n): t for n, t in wait.items()},
        "decode_scaling_efficiency": {
            str(n): dec[1] / dec[n] if 1 in dec and dec[n] else None
            for n in wall},
        "throughput_mb_s": {str(n): n_mb / t for n, t in wall.items()},
    }


def main(argv=None) -> None:
    """The command line (module docstring); ``--worker`` runs one rank."""
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        ap = argparse.ArgumentParser()
        for a in ("rank", "world", "port"):
            ap.add_argument(a, type=int)
        ap.add_argument("path")
        ap.add_argument("--engine", default="cuda")
        ap.add_argument("--device", default=None)
        a = ap.parse_args(argv[1:])
        print(worker(a.rank, a.world, a.port, a.path, a.engine, a.device),
              flush=True)
        return
    ap = argparse.ArgumentParser(prog="python -m lzma_rs_tpu_torch.tools."
                                 "scaling", description=__doc__.split("\n")[0])
    ap.add_argument("--mb", type=float, default=16.0)
    ap.add_argument("--engine", default="cuda",
                    choices=["cuda", "native", "auto"])
    ap.add_argument("--device", default=None, choices=["cpu"],
                    help="run on the CPU (default: the card)")
    ap.add_argument("--out", help="also write the JSON here")
    a = ap.parse_args(argv)
    if a.device is None:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("scaling: no CUDA device "
                             "(torch.cuda.is_available() is False); "
                             "--device cpu runs on the CPU")
    result = measure(a.mb, (1, 2, 4), a.engine, a.device)
    print(result["device"], flush=True)
    print(json.dumps(result), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
