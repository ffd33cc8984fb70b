"""A multi-process demo of the block-parallel `.xz` decode
(``parallel/multihost.py``) over ``torch.distributed``, and the helpers
that start such processes on one host.

Run one process a rank, each with its rank, the world size and one free
TCP port on 127.0.0.1 (rank 0 serves the group's store there):

    for r in 0 1; do
        python -m lzma_rs_tpu_torch.tools.multihost_demo $r 2 29511 &
    done; wait

Each rank decodes an archive of 1 MiB of the interpreter's stdlib sources
(``tools/corpus.py``) in 16 KiB blocks (CRC64) with ``xz_decode_multihost``,
once at the default wave size and once in 32 KiB waves, so that several
gathers overlap the decode, and checks the bytes. The engine is ``cuda``
unless ``--engine`` says otherwise: each rank on card ``rank % cards``,
and it raises without a card (``--engine native`` runs on the CPU). The
group is gloo, which lets ranks share a card, with a timeout, so that a
rank that fails ends the others' wait.
"""

from __future__ import annotations

import argparse
import datetime
import socket
import subprocess
import sys
import tempfile
import time

#: The demo's second pass: waves of 32 KiB, several a rank.
DEMO_WAVE_BYTES = 32 << 10


def free_port() -> int:
    """A TCP port on 127.0.0.1 that no process holds now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_group(rank: int, world: int, port: int, backend: str = "gloo",
               timeout_s: float = 120.0) -> None:
    """Join the default process group whose store rank 0 serves on
    127.0.0.1:``port``; a collective that waits longer than ``timeout_s``
    raises. Gloo's pairs use the loopback interface unless
    ``GLOO_SOCKET_IFNAME`` names another."""
    import os

    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")

    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def rank_device(rank: int, device=None):
    """The device a rank decodes on: ``device`` when given, else card
    ``rank % cards`` (made the current card), else None (no card: the
    ``cuda`` engine then raises)."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        return None
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def launch(argvs: list, timeout_s: float, env=None) -> list:
    """Run one process for each argument list, all at once; returns
    ``(exit code, stdout, stderr)`` of each. Kills every process and raises
    when they have not all ended within ``timeout_s``."""
    outs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            for _ in argvs]
    procs = [subprocess.Popen(a, stdout=o, stderr=e, text=True, env=env)
             for a, (o, e) in zip(argvs, outs)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise RuntimeError(f"{len(procs)} processes did not end within "
                           f"{timeout_s:.0f} s")
    results = []
    for p, (o, e) in zip(procs, outs):
        o.seek(0)
        e.seek(0)
        results.append((p.returncode, o.read(), e.read()))
        o.close()
        e.close()
    return results


def run_rank(rank: int, world: int, port: int, engine: str = "cuda") -> str:
    """The demo on one rank; returns its report line."""
    import torch.distributed as dist

    from lzma_rs_tpu_torch import xz_compress
    from lzma_rs_tpu_torch.parallel import multihost
    from lzma_rs_tpu_torch.tools import corpus

    dev = rank_device(rank)
    init_group(rank, world, port)
    try:
        data, _ = corpus.stdlib_corpus(1 << 20)
        xz = xz_compress(data, block_size=1 << 14, check_method=4)
        out = multihost.xz_decode_multihost(xz, engine, dev)
        if out != data:
            raise RuntimeError(f"rank {rank}: output differs")
        _, spans, _ = multihost.scan_blocks(xz)
        owner = multihost.assign_blocks(spans, world)
        _, sizes = multihost.plan_waves(spans, owner, world, DEMO_WAVE_BYTES)
        out2 = multihost.xz_decode_multihost(xz, engine, dev,
                                             wave_bytes=DEMO_WAVE_BYTES)
        if out2 != data:
            raise RuntimeError(f"rank {rank}: output differs in waves")
    finally:
        dist.destroy_process_group()
    return (f"rank {rank}/{world}: OK ({len(out)} bytes, bit-exact; "
            f"{len(sizes)} waves pipelined; engine {engine})")


def main(argv=None) -> None:
    """The command line: ``RANK WORLD PORT [--engine E]``."""
    ap = argparse.ArgumentParser(
        prog="python -m lzma_rs_tpu_torch.tools.multihost_demo")
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--engine", default="cuda",
                    choices=["cuda", "native", "auto"])
    args = ap.parse_args(argv)
    print(run_rank(args.rank, args.world, args.port, args.engine),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
