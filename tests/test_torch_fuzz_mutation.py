"""Differential mutation fuzzing of the port.

Valid archives and streams are mutated (bit and byte flips, truncations,
insertions, deletions, stacked 1-4 deep, and cross-seed splices; the
machinery is a copy of ``tests/test_fuzz_mutation.py:39-110``) and every
mutant is held to four contracts:

- (i) ``.xz`` against liblzma: the port's ``xz_decompress`` under
  ``native``, and the ``cuda`` engine on CPU slabs (its plain version;
  these cases stay at a few KiB), must both fail, or both succeed with
  equal bytes (the reference's ``compare_xz``). Where liblzma alone
  accepts, or alone rejects, the port's spec decoder must side with the
  port (the reference's known strictness and its unchecked tail bytes).
- (ii) the port against the JAX package: ``xz_decompress``,
  ``lzma2_decompress`` and ``lzma_decompress`` under ``native`` in both
  packages give the same bytes, or the same error class and message, and
  the same ``stats.fallbacks`` (ROADMAP's parity).
- (iii) LZMA2: the port's native engine against its spec decoder, as the
  JAX file holds them (``_native_vs_spec_lzma2``), and the ``cuda``
  engine on CPU slabs beside them.
- (iv) the lane tier, the kernel's own logic on corrupt input: the lanes
  of valid archives are staged (``runtime.stage_plans``), their staged
  input bytes and sometimes their chunk ends are mutated in place, and the
  g++ host build of the decoder (``ops/build.py::load_host``, code 1) must
  equal ``decode_segments_reference`` in win, err, outp and steps on a few
  short lanes a batch, and the native engine's ``lzma2_decode_segment``
  on every lane in its error/no-error verdict and a clean lane's bytes
  (lane error codes are not public).

Seeds never read a corpus from disk: seeded numpy text, the port's
encoder (one block, 4-64 KiB blocks, ``tpu_profile``, check methods 0, 1,
4 and 10) and stdlib ``lzma`` (``.xz`` with CRC32, CRC64 and SHA-256 at
presets 0 and 6; raw LZMA2; raw LZMA1 behind a ``.lzma`` header). The
smoke tiers and the corpus replay run in tier-1; ``TestMutationDeep``,
``TestMutationNightly`` (``LZMA_RS_TPU_FUZZ_MINUTES``,
``LZMA_RS_TPU_FUZZ_SEED``) and the two coverage-guided tiers (the spec
decoder under ``sys.monitoring`` arcs, the native engine under its
instrumented build) are ``slow``. Cases that ever diverged are kept under
``.bench/fuzz_torch/`` and replayed on every run.
"""

import functools
import hashlib
import json
import lzma as liblzma
import os
import random
import struct
import sys
import time

import numpy as np
import pytest
import torch

import lzma_rs_tpu
import lzma_rs_tpu_torch
from lzma_rs_tpu.utils import stats as jax_stats
from lzma_rs_tpu_torch.encode import lzma2_enc
from lzma_rs_tpu_torch.models.codecs import Lzma2Decoder, xz_decode_stream
from lzma_rs_tpu_torch.native import loader
from lzma_rs_tpu_torch.ops import segment_decoder as sd
from lzma_rs_tpu_torch.parallel import runtime
from lzma_rs_tpu_torch.tools import mutate
from lzma_rs_tpu_torch.utils import stats as port_stats
from lzma_rs_tpu_torch.utils.cursor import ByteCursor
from lzma_rs_tpu_torch.utils.errors import LzmaRsError as Error

from test_torch_kernel_hostbuild import runs, stored_mid_segment, text

CPU = torch.device("cpu")

# Divergences from liblzma that are understood and accepted: none.
ALLOWED_XZ_DIVERGENCES = ()


# The mutation machinery (tests/test_fuzz_mutation.py:39-72) is the
# port's copy in lzma_rs_tpu_torch/tools/mutate.py, which chip_smoke.py
# phase 20 runs on the card; the regression corpus (:75-103) follows.
_mutations, _splices = mutate.mutations, mutate.splices


# Accumulated regression corpus: every case that ever produced a
# divergence (before triage) is saved here and replayed as extra seeds on
# later runs, libFuzzer-corpus style.
FUZZ_CORPUS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".bench", "fuzz_torch",
)


def _corpus_cases():
    try:
        names = sorted(os.listdir(FUZZ_CORPUS_DIR))
    except OSError:
        return []
    out = []
    for nm in names:
        if nm.endswith(".bin"):
            with open(os.path.join(FUZZ_CORPUS_DIR, nm), "rb") as f:
                out.append(f.read())
    return out


def _save_to_corpus(case: bytes, tag: str) -> str:
    os.makedirs(FUZZ_CORPUS_DIR, exist_ok=True)
    h = hashlib.sha256(case).hexdigest()[:16]
    path = os.path.join(FUZZ_CORPUS_DIR, f"{tag}-{h}.bin")
    with open(path, "wb") as f:
        f.write(case)
    return path


# -- seeds ---------------------------------------------------------------


def _lzma1_raw(data: bytes) -> bytes:
    """stdlib ``lzma``'s raw LZMA1 stream (end marker, size unknown) behind
    a ``.lzma`` header written here, so ``lzma_decompress`` reads it."""
    filt = {"id": liblzma.FILTER_LZMA1, "preset": 6}
    body = liblzma.compress(data, format=liblzma.FORMAT_RAW, filters=[filt])
    props = (2 * 5 + 0) * 9 + 3  # preset 6: lc=3, lp=0, pb=2
    return struct.pack("<BIQ", props, 1 << 23, 2**64 - 1) + body


@functools.lru_cache(maxsize=None)
def xz_seeds():
    """``.xz`` seeds: the port's encoder and stdlib ``lzma``."""
    body = text(12000, 70)
    enc = lzma_rs_tpu_torch.xz_compress
    return (
        enc(body, check_method=4),                         # one block
        enc(body, block_size=4096, check_method=1),        # multi-block
        enc(body + runs(4000, 71), block_size=65536, check_method=0),
        enc(body, tpu_profile=True, check_method=1),       # 8 KiB, lc=0
        enc(body[:6000], block_size=16384, check_method=10),
        liblzma.compress(body, format=liblzma.FORMAT_XZ,
                         check=liblzma.CHECK_CRC32, preset=0),
        liblzma.compress(body, format=liblzma.FORMAT_XZ,
                         check=liblzma.CHECK_CRC64, preset=6),
        liblzma.compress(body[:5000], format=liblzma.FORMAT_XZ,
                         check=liblzma.CHECK_SHA256, preset=6),
    )


@functools.lru_cache(maxsize=None)
def small_xz_seeds():
    """``.xz`` seeds for the ``cuda`` engine on CPU slabs, whose plain
    version runs every lane in lockstep: a few hundred bytes a block."""
    enc = lzma_rs_tpu_torch.xz_compress
    return (enc(text(700, 72), block_size=256, check_method=1),
            enc(text(500, 73), tpu_profile=True, check_method=4))


@functools.lru_cache(maxsize=None)
def lzma2_seeds():
    body = text(6000, 74)
    return (
        lzma2_enc.lzma2_compress(body, level=6),
        lzma2_enc.lzma2_compress(body, level=0),
        lzma2_enc.lzma2_compress(body, level=6, dist_cap=512, props=90),
        liblzma.compress(body, format=liblzma.FORMAT_RAW,
                         filters=[{"id": liblzma.FILTER_LZMA2,
                                   "preset": 6}]),
    )


@functools.lru_cache(maxsize=None)
def lzma1_seeds():
    body = text(5000, 75)
    return (lzma_rs_tpu_torch.lzma_compress(body),
            liblzma.compress(body, format=liblzma.FORMAT_ALONE),
            _lzma1_raw(body))


# -- contract (i): .xz against liblzma -----------------------------------


def _port_xz(data: bytes, engine: str):
    try:
        if engine == "cuda":
            return True, runtime.xz_decode(data, engine="cuda", device=CPU)
        return True, runtime.xz_decode(data, engine=engine)
    except Error as e:
        return False, type(e).__name__
    except OverflowError:
        # 64-bit varint fields can exceed host sizes; classified failure
        return False, "OverflowError"


def _liblzma_xz(data: bytes):
    try:
        return True, liblzma.decompress(data, format=liblzma.FORMAT_XZ)
    except Exception as e:  # any liblzma failure is its verdict
        return False, type(e).__name__


def _xz_agree(case: bytes, engine: str = "native") -> str:
    """'' when the port's ``engine`` and liblzma agree, else why."""
    ok_a, a = _port_xz(case, engine)
    ok_b, b = _liblzma_xz(case)
    if ok_a and ok_b:
        return "" if a == b else (f"output mismatch: ours {len(a)}B vs "
                                  f"liblzma {len(b)}B")
    if ok_a == ok_b:
        return ""
    # One side alone accepts: the reference's known differences (it never
    # checks a known-size chunk's trailing compressed bytes; it rejects
    # what liblzma streams past, e.g. concatenations). The port must side
    # with its reference-parity spec decoder, with the same bytes.
    try:
        spec = (True, xz_decode_stream(ByteCursor(case)))
    except (Error, OverflowError):
        spec = (False, None)
    if ok_a and not spec[0]:
        return f"{engine} accepted ({len(a)}B), liblzma and spec rejected"
    if ok_a and spec[1] != a:
        return f"{engine}/spec output mismatch on a liblzma-rejected case"
    if ok_b and spec[0]:
        return f"spec accepted but {engine} rejected ({a})"
    return ""


def _run_xz_mutations(seeds, n, rng, engine="native", stacked=False,
                      save=False):
    failures, cases = [], 0
    for si, seed in enumerate(seeds):
        for case in _mutations(rng, seed, n, stacked=stacked):
            cases += 1
            why = _xz_agree(case, engine)
            if why and why not in ALLOWED_XZ_DIVERGENCES:
                loc = _save_to_corpus(case, "xz") if save else f"seed {si}"
                failures.append(f"{loc}: {why}")
                if len(failures) > 5:
                    return failures, cases
    return failures, cases


# -- contract (ii): the port against the JAX package ----------------------


def _outcome(pkg, stats, fn, data):
    with stats.collect() as s:
        try:
            out = getattr(pkg, fn)(data)
        except (Exception,) as e:  # the error is the parity object
            out = (type(e).__name__, str(e))
    return out, s.fallbacks


def _parity(fn: str, case: bytes) -> str:
    """'' when the port and the JAX package give the same bytes or error
    (class and message) and the same fallbacks, under ``native``."""
    got = _outcome(lzma_rs_tpu_torch, port_stats, fn, case)
    want = _outcome(lzma_rs_tpu, jax_stats, fn, case)
    if got == want:
        return ""
    return f"{fn}: port {str(got)[:120]} vs JAX {str(want)[:120]}"


def _run_parity(fn, seeds, n, rng, stacked=False):
    failures, cases = [], 0
    for si, seed in enumerate(seeds):
        for case in _mutations(rng, seed, n, stacked=stacked):
            cases += 1
            why = _parity(fn, case)
            if why:
                failures.append(f"seed {si}: {why}")
                if len(failures) > 5:
                    return failures, cases
    return failures, cases


# -- contract (iii): LZMA2, native against spec, and cuda beside them -----


def _lzma2_outcome(fn):
    try:
        return True, fn()
    except (Error, OverflowError) as e:
        return False, f"{type(e).__name__}: {e}"


def _native_vs_spec_lzma2(case: bytes, cuda: bool = False) -> str:
    lib = loader.load()
    if lib is None:
        pytest.skip("native library unavailable")
    try:
        a = (True, lib.lzma2_decode(case))
    except Exception as e:  # native raises the port's typed errors
        a = (False, str(e))
    try:
        b = (True, Lzma2Decoder().decompress(ByteCursor(case)))
    except Error as e:
        b = (False, str(e))
    if a[0] != b[0]:
        return f"native ok={a[0]} spec ok={b[0]} ({a[1]!r:.60} vs {b[1]!r:.60})"
    if a[0] and a[1] != b[1]:
        return "native/spec output mismatch"
    if not a[0] and a[1] != b[1]:
        return f"error-string mismatch: {a[1]!r} vs {b[1]!r}"
    if cuda:
        native = _lzma2_outcome(
            lambda: runtime.lzma2_decode(case, engine="native"))
        dev = _lzma2_outcome(
            lambda: runtime.lzma2_decode(case, engine="cuda", device=CPU))
        if dev != native:
            return f"cuda {str(dev)[:80]} vs native {str(native)[:80]}"
    return ""


def _run_lzma2_mutations(n, rng, seeds=None, cuda=False, stacked=False):
    failures, cases = [], 0
    for si, seed in enumerate(seeds or lzma2_seeds()):
        for case in _mutations(rng, seed, n, stacked=stacked):
            cases += 1
            why = _native_vs_spec_lzma2(case, cuda)
            if why:
                failures.append(f"seed {si}: {why}")
                if len(failures) > 5:
                    return failures, cases
    return failures, cases


# -- contract (iv): the lane tier -----------------------------------------


@functools.lru_cache(maxsize=None)
def lane_pool():
    """Staged lanes of valid streams, one bucket (W 8 KiB, NLIT 8): 8 KiB
    tpu_profile blocks, stdlib raw LZMA2 at several props, multi-chunk
    segments, a stored chunk inside a segment."""
    streams = [lzma2_enc.lzma2_compress(text(2500, 80 + i), level=6,
                                        chunk_size=1024) for i in range(3)]
    streams += [liblzma.compress(text(3000, 90 + i), format=liblzma.FORMAT_RAW,
                                 filters=[{"id": liblzma.FILTER_LZMA2,
                                           "preset": p, "lc": lc, "lp": lp,
                                           "pb": pb}])
                for i, (p, lc, lp, pb) in enumerate(
                    ((6, 3, 0, 2), (1, 0, 0, 0), (9, 1, 2, 1), (6, 2, 1, 3)))]
    streams += [lzma2_enc.lzma2_compress(text(6000, 95), level=6, props=90,
                                         dist_cap=2048),
                stored_mid_segment(), lzma2_enc.lzma2_compress(
                    runs(4000, 96), level=6)]
    blob, plans, off = bytearray(), [], 0
    for s in streams:
        plan, _ = runtime.plan_lzma2_stream(bytes(blob) + s, len(blob), off)
        blob += s
        off += plan.total_out
        plans.append(plan)
    return runtime.stage_plans(bytes(blob), plans)


def _lane_batch(rng, staged, n, stacked, plain_lanes=2):
    """One batch of n mutated lanes: the host build against native on
    every lane, and against the plain version on the ``plain_lanes``
    that stop soonest. Returns (failures, lanes by error code)."""
    cfg, arrays, seg_lens = mutate.mutate_lanes(rng, staged, n, stacked)
    got = mutate.host_decode(cfg, arrays)
    failures = mutate.lane_verdicts(loader.load(), got, arrays, seg_lens)
    short = np.argsort(got[3].numpy(), kind="stable")[:plain_lanes]
    want = sd.decode_segments_reference(
        *(torch.from_numpy(np.ascontiguousarray(a[short])) for a in arrays),
        config=staged.slab_config(0, plain_lanes))
    for what, g, w in zip(("win", "err", "outp", "steps"), got, want):
        if not torch.equal(g[torch.from_numpy(short)], w):
            failures.append(f"lanes {short.tolist()}: host build and plain "
                            f"version differ in {what}")
    err = got[1].numpy()
    codes = {int(c): int((err == c).sum()) for c in np.unique(err)}
    return failures, codes


def _run_lane_mutations(batches, n, rng, stacked=False):
    staged = lane_pool()
    failures, codes = [], {}
    for _ in range(batches):
        f, c = _lane_batch(rng, staged, n, stacked)
        failures += f
        for k, v in c.items():
            codes[k] = codes.get(k, 0) + v
        if len(failures) > 5:
            break
    return failures, codes


# -- the tiers -------------------------------------------------------------


@pytest.fixture
def native_backend(monkeypatch):
    """Both packages under their native engine (contract (ii))."""
    monkeypatch.setenv("LZMA_RS_TPU_BACKEND", "native")
    if loader.load() is None:
        pytest.skip("native library unavailable")


class TestMutationSmoke:
    def test_xz_differential(self):
        failures, cases = _run_xz_mutations(xz_seeds(), 40,
                                            random.Random(0xF00D))
        assert cases >= 300 and not failures, failures

    def test_xz_differential_cuda_on_cpu_slabs(self):
        failures, cases = _run_xz_mutations(small_xz_seeds(), 12,
                                            random.Random(0xC0DA),
                                            engine="cuda")
        assert not failures, failures

    def test_xz_splices(self):
        rng = random.Random(0x5EED)
        failures = [why for case in _splices(rng, list(xz_seeds()), 40)
                    if (why := _xz_agree(case))]
        assert not failures, failures

    @pytest.mark.parametrize("fn", ("xz_decompress", "lzma2_decompress",
                                    "lzma_decompress"))
    def test_port_equals_the_jax_package(self, fn, native_backend):
        seeds = {"xz_decompress": xz_seeds(),
                 "lzma2_decompress": lzma2_seeds(),
                 "lzma_decompress": lzma1_seeds()}[fn]
        failures, _ = _run_parity(fn, seeds, 12, random.Random(0xAB1E),
                                  stacked=True)
        assert not failures, failures

    def test_lzma2_native_vs_spec(self):
        failures, cases = _run_lzma2_mutations(25, random.Random(0xBEEF))
        assert cases >= 100 and not failures, failures

    def test_lzma2_cuda_on_cpu_slabs(self):
        seeds = (lzma2_enc.lzma2_compress(text(600, 76), level=6,
                                          chunk_size=256),)
        failures, _ = _run_lzma2_mutations(10, random.Random(0xD1CE),
                                           seeds=seeds, cuda=True)
        assert not failures, failures

    @pytest.mark.parametrize("stacked", (False, True))
    def test_lane_tier(self, stacked):
        failures, codes = _run_lane_mutations(
            4, 64, random.Random(0x1A4E + stacked), stacked=stacked)
        assert not failures, failures
        # the tier reaches clean lanes and the kernel's error paths
        assert sum(codes.values()) >= 256 and codes.get(0, 0) and any(
            c for c in codes if c), codes


def test_a_chunk_past_the_streams_end_goes_to_the_host():
    """A packed size that runs past the stream (a mutant of the tier found
    it): the planner's lane is not staged (staged, it would decode the
    zeros after the end); the ``cuda`` engine records the lane as
    ineligible and gives the native engine's result."""
    s = bytearray(lzma2_enc.lzma2_compress(text(600, 76), level=6,
                                           chunk_size=256))
    assert s[0] >= 0xE0  # an LZMA chunk with props: a 6-byte header
    second = 6 + (s[3] << 8 | s[4]) + 1
    assert s[second] >= 0x80  # the next LZMA chunk
    s[second + 3:second + 5] = b"\x1f\xff"  # packed size 8,192
    case = bytes(s)
    plan, _ = runtime.plan_lzma2_stream(case, 0, 0)
    assert max(e for lane in plan.lanes for e in lane.in_end) > len(case)
    with port_stats.collect() as st:
        dev = _lzma2_outcome(
            lambda: runtime.lzma2_decode(case, engine="cuda", device=CPU))
    assert dev == _lzma2_outcome(
        lambda: runtime.lzma2_decode(case, engine="native"))
    assert [f.split(":")[0] for f in st.fallbacks] == ["vmem-ineligible"]
    assert "past the stream" in st.fallbacks[0]


class TestCorpusReplay:
    def test_accumulated_corpus_still_agrees(self, native_backend):
        """Replay every saved divergence case through contracts (i) and
        (ii): the nightly tier's findings must stay triaged."""
        failures = []
        for case in _corpus_cases():
            why = _xz_agree(case) or _parity("xz_decompress", case)
            if why and why not in ALLOWED_XZ_DIVERGENCES:
                failures.append(why)
        assert not failures, failures


@pytest.mark.slow
class TestMutationDeep:
    def test_xz_differential_deep(self):
        failures, _ = _run_xz_mutations(xz_seeds(), 400,
                                        random.Random(0xF00D), stacked=True)
        assert not failures, failures

    def test_port_equals_the_jax_package_deep(self, native_backend):
        rng = random.Random(0xDEE9)
        failures = []
        for fn, seeds in (("xz_decompress", xz_seeds()),
                          ("lzma2_decompress", lzma2_seeds()),
                          ("lzma_decompress", lzma1_seeds())):
            failures += _run_parity(fn, seeds, 150, rng, stacked=True)[0]
        assert not failures, failures

    def test_lzma2_native_vs_spec_deep(self):
        failures, _ = _run_lzma2_mutations(150, random.Random(0xBEEF),
                                           stacked=True)
        assert not failures, failures

    def test_lane_tier_deep(self):
        failures, _ = _run_lane_mutations(40, 128, random.Random(0x1A4E),
                                          stacked=True)
        assert not failures, failures


def _budget():
    minutes = float(os.environ.get("LZMA_RS_TPU_FUZZ_MINUTES", "3"))
    seed = int(os.environ.get(
        "LZMA_RS_TPU_FUZZ_SEED",
        str(random.SystemRandom().randrange(1 << 48))))
    return minutes, seed


@pytest.mark.slow
class TestMutationNightly:
    """Time-budgeted randomized tier (``LZMA_RS_TPU_FUZZ_MINUTES``, default
    3; the seed drawn fresh per run and printed, or
    ``LZMA_RS_TPU_FUZZ_SEED``): stacked mutations and splices through
    contracts (i) and (ii), then lane batches (iv). Divergent cases are
    written to ``.bench/fuzz_torch/`` and replay in every later run."""

    def test_xz_differential_nightly(self, native_backend):
        minutes, seed = _budget()
        print(f"nightly fuzz seed: {seed} (LZMA_RS_TPU_FUZZ_SEED to repro)")
        rng = random.Random(seed)
        deadline = time.monotonic() + minutes * 60 * 2 / 3
        seeds = list(xz_seeds()) + _corpus_cases()
        failures, cases = [], 0
        while time.monotonic() < deadline and len(failures) <= 5:
            batch = [c for s in seeds for c in _mutations(rng, s, 20, True)]
            batch += list(_splices(rng, seeds, 40))
            for case in batch:
                cases += 1
                why = _xz_agree(case) or _parity("xz_decompress", case)
                if why and why not in ALLOWED_XZ_DIVERGENCES:
                    failures.append(f"{_save_to_corpus(case, 'xz')}: {why}")
        print(f"nightly fuzz: {cases} cases")
        assert not failures, f"seed {seed}: {failures}"

    def test_lane_tier_nightly(self):
        minutes, seed = _budget()
        rng = random.Random(seed)
        deadline = time.monotonic() + minutes * 60 / 3
        failures = []
        while time.monotonic() < deadline and not failures:
            failures = _run_lane_mutations(4, 128, rng, stacked=True)[0]
        assert not failures, f"seed {seed}: {failures}"


# -- coverage-guided nightly tiers ------------------------------------------
#
# Mutants run the port's pure-Python spec decoder under sys.monitoring
# (line and branch arcs of its decode modules), or its native engine under
# the edge-instrumented build (native/cov_runtime.cpp,
# loader.load_instrumented); a mutant that reaches a new arc is kept as a
# corpus seed and must still satisfy its differential contract. The arc
# sets persist under .bench/fuzz_torch/ so exploration compounds across
# runs (native arcs keyed by the instrumented build's hash).

_COV_MODULES = (
    "models/spec.py", "models/codecs.py", "formats/xz.py",
    "formats/lzma2.py", "formats/lzma_header.py", "utils/cursor.py",
)
_PORT_DIR = os.sep + "lzma_rs_tpu_torch" + os.sep
_ARCS_PATH = os.path.join(FUZZ_CORPUS_DIR, "coverage_arcs.json")
_NARCS_PATH = os.path.join(FUZZ_CORPUS_DIR, "native_arcs.json")


class _ArcTracker:
    """Edge-granularity coverage over the port's spec decode modules via
    sys.monitoring (PEP 669): LINE events plus BRANCH source->dest arcs."""

    def __init__(self):
        self.current = set()
        mon = sys.monitoring
        # COVERAGE_ID may already be claimed (tools/coverage_report.py):
        # fall back to any free tool id
        self.TOOL = None
        for tid in (mon.COVERAGE_ID, 3, 4, 5):
            try:
                mon.use_tool_id(tid, "lzma_rs_tpu_torch-fuzz-cov")
                self.TOOL = tid
                break
            except ValueError:
                continue
        if self.TOOL is None:
            raise RuntimeError("no free sys.monitoring tool id")
        mon.register_callback(self.TOOL, mon.events.LINE, self._on_line)
        mon.register_callback(self.TOOL, mon.events.BRANCH, self._on_branch)
        self._events = mon.events.LINE | mon.events.BRANCH

    def _module(self, fn):
        if _PORT_DIR in fn:
            for suffix in _COV_MODULES:
                if fn.endswith(suffix):
                    return suffix
        return None

    def _on_line(self, code, line):
        suffix = self._module(code.co_filename)
        if suffix is None:
            return sys.monitoring.DISABLE
        self.current.add(f"{suffix}:{line}")

    def _on_branch(self, code, src, dst):
        suffix = self._module(code.co_filename)
        if suffix is None:
            return sys.monitoring.DISABLE
        self.current.add(f"{suffix}:b{src}>{dst}")

    def run(self, fn):
        """Run fn() with tracing; returns the arc set it touched."""
        self.current = set()
        mon = sys.monitoring
        mon.set_events(self.TOOL, self._events)
        mon.restart_events()  # a per-code-object DISABLE sticks until then
        try:
            fn()
        except Exception:
            pass  # error paths are exactly the arcs worth finding
        finally:
            mon.set_events(self.TOOL, 0)
        return self.current

    def close(self):
        sys.monitoring.free_tool_id(self.TOOL)


def _load_json(path):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def _dump_json(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.mark.slow
class TestCoverageGuidedNightly:
    def test_xz_spec_coverage_guided(self):
        minutes, seed = _budget()
        print(f"coverage fuzz seed: {seed}")
        rng = random.Random(seed)
        known = set(_load_json(_ARCS_PATH) or [])
        start_arcs = len(known)
        tracker = _ArcTracker()
        seeds = list(xz_seeds()) + _corpus_cases()
        kept = cases = 0
        failures = []
        try:
            for s in seeds:  # warm: only genuinely new arcs count
                known |= tracker.run(lambda: xz_decode_stream(ByteCursor(s)))
            deadline = time.monotonic() + minutes * 60 / 3
            while time.monotonic() < deadline and len(failures) <= 5:
                for s in seeds:
                    for case in _mutations(rng, s, 20, stacked=True):
                        cases += 1
                        new = tracker.run(lambda: xz_decode_stream(
                            ByteCursor(case))) - known
                        if new:
                            known |= new
                            kept += 1
                            path = _save_to_corpus(case, "cov")
                            why = _xz_agree(case)
                            if why and why not in ALLOWED_XZ_DIVERGENCES:
                                failures.append(f"{path}: {why}")
                    if time.monotonic() >= deadline:
                        break
        finally:
            tracker.close()
        _dump_json(_ARCS_PATH, sorted(known))
        print(f"coverage fuzz: {cases} cases, arcs {start_arcs} -> "
              f"{len(known)} (+{kept} corpus seeds)")
        assert not failures, f"seed {seed}: {failures}"


@pytest.mark.slow
class TestNativeCoverageGuidedNightly:
    def test_native_edge_coverage_guided(self):
        cov = loader.load_instrumented()
        if cov is None:
            pytest.skip("instrumented native build unavailable")
        import ctypes

        lib = cov._lib

        def decode(case: bytes):
            out = ctypes.c_void_p()
            n = ctypes.c_size_t()
            consumed = ctypes.c_size_t()
            err = ctypes.create_string_buffer(256)
            lib.lrt_lzma2_decode(bytes(case), len(case), 0, ctypes.byref(out),
                                 ctypes.byref(n), ctypes.byref(consumed), err)
            if out.value:
                lib.lrt_free(out)

        minutes, seed = _budget()
        print(f"native coverage fuzz seed: {seed}")
        rng = random.Random(seed)
        build_id = cov.build_id()
        saved = _load_json(_NARCS_PATH)
        known = (set(saved["arcs"]) if saved and saved.get("build") == build_id
                 else set())
        start_arcs = len(known)
        seeds = list(lzma2_seeds())
        for s in seeds:
            known |= cov.cov_run(lambda: decode(s))
        deadline = time.monotonic() + minutes * 60 / 3
        kept = cases = 0
        failures = []
        while time.monotonic() < deadline and len(failures) <= 5:
            for s in seeds:
                for case in _mutations(rng, s, 20, stacked=True):
                    cases += 1
                    new = cov.cov_run(lambda: decode(case)) - known
                    if new:
                        known |= new
                        kept += 1
                        path = _save_to_corpus(case, "ncov")
                        why = _native_vs_spec_lzma2(case)
                        if why:
                            failures.append(f"{path}: {why}")
                if time.monotonic() >= deadline:
                    break
        _dump_json(_NARCS_PATH, {"build": build_id, "arcs": sorted(known)})
        print(f"native coverage fuzz: {cases} cases, arcs {start_arcs} -> "
              f"{len(known)} (+{kept} corpus seeds)")
        assert not failures, f"seed {seed}: {failures}"
