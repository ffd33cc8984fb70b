"""Benchmark: `.xz` decode throughput of the port, on the host and on the card.

The port of the root ``bench.py``. Run on a machine with a CUDA card::

    python -m lzma_rs_tpu_torch.bench

It prints ONE JSON line on stdout (details go to stderr)::

    {"metric": "xz_decode_throughput", "value": <MB/s>, "unit": "MB/s",
     "vs_baseline": <ratio>, "host_mb_s": <MB/s>, "cuda_...": ...,
     "device": {"name": ..., "power_limit": ..., "count": ...}}

The corpus is the interpreter's stdlib ``.py`` sources, cycled
(``tools/corpus.py``); the archives are written with stdlib ``lzma`` and
the port's own encoder and writers, so neither the ``xz`` binary nor a
reference corpus is needed. Every lane is checked bit-exact, and a card
lane also free of fallbacks, before it is timed:

- (c) host: 60 MB in 1 MiB blocks,
  liblzma preset 6 per block with CRC64, as ``xz -6 --block-size=1MiB``
  writes; ``xz_decompress`` under ``auto`` (its route recorded), the
  ``native`` engine, and the baseline, single-threaded stdlib
  ``lzma.decompress``: liblzma, the library ``xz -dc -T1`` runs. ``value``
  and ``vs_baseline`` are ``xz_decompress``'s.
- (a) 16 MB as the tpu_profile
  archive (8 KiB blocks, CRC32) and (b) the same bytes as stock-shaped
  64 KiB blocks: end to end under ``engine="cuda"`` (best of 3 after a
  warm call), device-resident (``parallel/devbench.device_throughput``)
  and the ``native`` engine beside them; on (a) also what the slab path
  adds to one launch with its copies (``devbench.sharding_overhead``,
  over the cards present) and the link rate (an 8 MiB round trip, best
  of 3).

Without a card ``main`` exits nonzero, and a card lane that fails or falls
back fails the run: no host number stands in for it. The lane functions
take ``device`` so that a caller can run them on the CPU (the kernel's
plain version); their keys then read ``cpu_*``. ``run`` takes the two
sizes, so a caller (the tests) can run the lanes smaller.
"""

from __future__ import annotations

import json
import lzma
import subprocess
import sys
import time

import torch

HOST_BLOCK = 1 << 20


def log(*a) -> None:
    """Print a progress line to stderr."""
    print(*a, file=sys.stderr, flush=True)


def time_best(fn, reps: int) -> float:
    """The best wall seconds of ``fn()`` over ``reps`` calls."""
    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t)
    return best


def host_lane(data: bytes, reps: int = 5) -> dict:
    """(c): ``data`` in 1 MiB blocks through ``xz_decompress`` (``auto``),
    the native engine and single-threaded liblzma, best of ``reps`` each,
    in turns."""
    import lzma_rs_tpu_torch
    from lzma_rs_tpu_torch.parallel import runtime
    from lzma_rs_tpu_torch.tools import corpus
    from lzma_rs_tpu_torch.utils import stats

    archive = corpus.stock_archive(data, HOST_BLOCK)
    with stats.collect() as st:
        out = lzma_rs_tpu_torch.xz_decompress(archive)
    for name, got in (("xz_decompress", out),
                      ("native", runtime.xz_decode(archive, engine="native")),
                      ("lzma.decompress", lzma.decompress(archive))):
        if got != data:
            raise RuntimeError(f"(c) {name} is not bit-exact")
    fns = {"ours": lambda: lzma_rs_tpu_torch.xz_decompress(archive),
           "native": lambda: runtime.xz_decode(archive, engine="native"),
           "baseline": lambda: lzma.decompress(archive)}
    best = dict.fromkeys(fns, float("inf"))
    for _ in range(reps):
        for name, fn in fns.items():
            best[name] = min(best[name], time_best(fn, 1))
    mb = len(data) / 1e6
    res = {"host_mb_s": mb / best["ours"], "host_route": st.engine,
           "host_fallbacks": st.fallbacks,
           "host_native_mb_s": mb / best["native"],
           "baseline_mb_s": mb / best["baseline"],
           "host_corpus_mb": mb, "host_blocks": -(-len(data) // HOST_BLOCK)}
    log(f"(c) {mb:.1f} MB in 1 MiB blocks -> {len(archive) / 1e6:.1f} MB: "
        f"xz_decompress ({st.engine}) {res['host_mb_s']:.1f} MB/s, native "
        f"{res['host_native_mb_s']:.1f}, liblzma (lzma.decompress, one "
        f"thread) {res['baseline_mb_s']:.1f}")
    return res


def card_lane(archive: bytes, data: bytes, device, reps: int = 3,
              dev_reps: int = 10) -> dict:
    """(a) or (b): ``archive`` end to end under ``engine="cuda"`` on
    ``device`` (best of ``reps`` after the checked warm call),
    device-resident (``dev_reps`` launches) and under ``native``. Raises
    when the card's decode is not bit-exact or falls back."""
    from lzma_rs_tpu_torch.parallel import devbench, runtime
    from lzma_rs_tpu_torch.utils import stats

    device = devbench.timing_device(device)
    with stats.collect() as st:
        out = runtime.xz_decode(archive, engine="cuda", device=device)
    if out != data:
        raise RuntimeError("the card's decode is not bit-exact")
    if st.engine != device.type or st.fallbacks:
        raise RuntimeError(f"the card's decode left the card: engine "
                           f"{st.engine!r}, fallbacks {st.fallbacks}")
    e2e = time_best(lambda: runtime.xz_decode(archive, engine="cuda",
                                              device=device), reps)
    dev = devbench.device_throughput(archive, device, reps=dev_reps,
                                     verify=data)
    if runtime.xz_decode(archive, engine="native") != data:
        raise RuntimeError("the native decode is not bit-exact")
    native = time_best(lambda: runtime.xz_decode(archive, engine="native"),
                       reps)
    mb = len(data) / 1e6
    return {"e2e_mb_s": mb / e2e, "e2e_ms": e2e * 1e3,
            "device_mb_s": dev["mb_s"], "device_ms": dev["ms"],
            "us_per_step": dev["us_per_step"],
            "cycles_per_step": dev["cycles_per_step"], "lanes": dev["lanes"],
            "native_mb_s": mb / native, "corpus_mb": mb}


def link_rate(device, nbytes: int = 8 << 20, reps: int = 3) -> float:
    """MB/s of an ``nbytes`` round trip, host to ``device`` and back, best
    of ``reps``."""
    buf = torch.zeros(nbytes, dtype=torch.uint8)
    best = time_best(lambda: buf.to(device).cpu(), reps)
    return 2 * nbytes / 1e6 / best


def device_object(device: torch.device) -> dict:
    """``devbench.device_info`` (name, count) and the card's power limit
    (``nvidia-smi``; None on the CPU)."""
    from lzma_rs_tpu_torch.parallel import devbench

    limit = None
    if device.type == "cuda":
        limit = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
            check=True).stdout.strip()
    return {**devbench.device_info(device), "power_limit": limit}


def run(device, host_mb: float = 60, card_mb: float = 16) -> dict:
    """Every lane on ``device``, (c) on ``host_mb`` MB and (a) and (b) on
    ``card_mb`` MB of the corpus; returns the benchmark's JSON object."""
    from lzma_rs_tpu_torch.parallel import devbench
    from lzma_rs_tpu_torch.tools import corpus

    device = devbench.timing_device(device)
    host_bytes, card_bytes = int(host_mb * 1e6), int(card_mb * 1e6)
    data, distinct = corpus.stdlib_corpus(max(host_bytes, card_bytes))
    log(f"corpus: {len(data)} B of stdlib sources ({distinct} B distinct)")
    host = host_lane(data[:host_bytes])

    card_data = data[:card_bytes]
    p = device.type  # the keys name what the numbers ran on
    res = {}
    for key, archive in (("", corpus.tpu_archive(card_data)),
                         ("stock64k_", corpus.stock_archive(card_data))):
        r = card_lane(archive, card_data, device)
        log(f"({'b' if key else 'a'}) {r['corpus_mb']:.1f} MB -> "
            f"{len(archive) / 1e6:.1f} MB on {p}: end to end "
            f"{r['e2e_mb_s']:.1f} MB/s, device-resident "
            f"{r['device_mb_s']:.1f} MB/s ({r['device_ms']:.3f} ms, "
            f"{r['lanes']} lanes), native {r['native_mb_s']:.1f} MB/s")
        res.update({f"{p}_{key}{k}": v for k, v in r.items()})
        if not key:
            oh = devbench.sharding_overhead(archive, device)
            log(f"(a) slab path over {oh['n']} device(s): "
                f"{oh['slabs_ms']:.2f} ms against one launch's with its "
                f"copies {oh['plain_ms']:.2f} ms "
                f"({oh['overhead_pct']:+.1f}%)")
            res.update({f"{p}_shard_overhead_pct": oh["overhead_pct"],
                        f"{p}_shard_n": oh["n"],
                        f"{p}_shard_plain_ms": oh["plain_ms"],
                        f"{p}_shard_slabs_ms": oh["slabs_ms"]})
    res[f"{p}_link_mb_s"] = link_rate(device)
    log(f"link (8 MiB round trip): {res[f'{p}_link_mb_s']:.1f} MB/s")
    return {
        "metric": "xz_decode_throughput",
        "value": host["host_mb_s"],
        "unit": "MB/s",
        "vs_baseline": host["host_mb_s"] / host["baseline_mb_s"],
        **host,
        **res,
        "device": device_object(device),
    }


def main() -> None:
    """Run every lane on the current card and print the JSON line."""
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (torch.cuda.is_available() "
                         "is False); the card lanes need one")
    result = run(torch.device("cuda", torch.cuda.current_device()))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
