"""The port's multi-process `.xz` decode (``parallel/multihost.py``)
against the JAX package's (``lzma_rs_tpu/parallel/multihost.py``).

- The host half (``scan_blocks``, ``assign_blocks``, ``plan_waves``,
  ``stitch_waves``) is a copy: field for field the same results on the
  same archives (the port's encoder with 4-64 KiB blocks and all four
  check methods, stdlib ``lzma`` for one block and for none, hand-built
  empty and stored blocks).
- One process: ``xz_decode_multihost`` under ``native`` and under ``cuda``
  on the CPU device (the kernel's plain version) gives the JAX function's
  bytes or error (type and message) and ``stats.fallbacks`` (the JAX
  package under ``native`` and ``tpu-vmem``, in interpret mode).
- Two and three processes: gloo groups on the CPU (a ``FileStore`` in
  ``tmp_path``, a timeout on the group and on the join), in which this
  file runs as each rank's script. Every rank returns the JAX package's
  bytes or raises its error; the waves each rank gathered equal those of
  the JAX protocol simulated (each rank's dense buffer of its wave's
  blocks, zero-padded to the wave's size, as ``tests/test_multihost.py``
  builds them); the device arm calls ``decode_segments`` once a wave that
  holds lanes, on the rank's own device only; and it catches only
  ``VmemIneligible`` and ``_KernelError``.

A case marked ``cuda`` runs two ranks on the card.
"""

import dataclasses
import hashlib
import json
import lzma as liblzma
import os
import sys

import numpy as np
import pytest
import torch

from lzma_rs_tpu.parallel import multihost as jax_multihost
from lzma_rs_tpu.parallel import runtime as jax_runtime
from lzma_rs_tpu.utils import stats as jax_stats
from lzma_rs_tpu_torch import xz_compress
from lzma_rs_tpu_torch.formats import xz as fmt
from lzma_rs_tpu_torch.parallel import multihost, runtime
from lzma_rs_tpu_torch.utils import stats
from lzma_rs_tpu_torch.utils.cursor import ByteWriter

from test_torch_kernel_hostbuild import text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
GROUP_TIMEOUT_S = 60  # a collective that waits longer raises
JOIN_TIMEOUT_S = 300  # the ranks of one group together


def flip(data: bytes, pos: int) -> bytes:
    b = bytearray(data)
    b[pos] ^= 0x5A
    return bytes(b)


def error_key(e):
    return [type(e).__name__, str(e)]


def digest(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def blocks_archive(parts, check_method=fmt.CHECK_CRC32) -> bytes:
    """An archive of one block per part (stdlib ``lzma`` raw LZMA2), parts
    of zero bytes included."""
    filt = [{"id": liblzma.FILTER_LZMA2, "preset": 6}]
    flags = fmt.StreamFlags(check_method=check_method)
    w = ByteWriter()
    fmt.write_stream_header(w, flags)
    records = [fmt.write_block(
        w, liblzma.compress(p, format=liblzma.FORMAT_RAW, filters=filt), p,
        check_method=check_method) for p in parts]
    fmt.write_footer(w, flags, fmt.write_index(w, records))
    return w.getvalue()


def archives() -> dict:
    """name -> (archive, decoded bytes)."""
    d = {n: text(n, n % 97) for n in (3072, 40000, 96000, 200000)}
    stdlib = text(50000, 25)
    empty = [text(700, 31), b"", text(900, 32), b"", b"", text(300, 33)]
    cases = {
        "crc32-4k": (xz_compress(d[40000], block_size=4096,
                                 check_method=1), d[40000]),
        "crc64-16k": (xz_compress(d[96000], block_size=16384,
                                  check_method=4), d[96000]),
        "sha256-64k": (xz_compress(d[200000], block_size=65536,
                                   check_method=10), d[200000]),
        "none-8k": (xz_compress(d[40000], block_size=8192,
                                check_method=0), d[40000]),
        "tpu-profile": (xz_compress(d[40000], tpu_profile=True,
                                    check_method=1), d[40000]),
        # small lanes for the plain version (~1.5 s a 512 B lane)
        "small-512": (xz_compress(d[3072], block_size=512, check_method=1),
                      d[3072]),
        "stored": (xz_compress(d[3072], block_size=1024, level=0,
                               check_method=4), d[3072]),
        "empty-blocks": (blocks_archive(empty), b"".join(empty)),
        "stdlib-one-block": (liblzma.compress(
            stdlib, format=liblzma.FORMAT_XZ, check=liblzma.CHECK_CRC64),
            stdlib),
        "no-blocks": (liblzma.compress(b"", format=liblzma.FORMAT_XZ), b""),
    }
    return cases


ARCHIVES = archives()


def check_flip(x: bytes, block: int = 1) -> bytes:
    _, spans, _ = jax_multihost.scan_blocks(x)
    return flip(x, spans[min(block, len(spans) - 1)].check_off)


def index_flip(x: bytes) -> bytes:
    """A byte of the index's first record flipped."""
    flags, spans, _ = jax_multihost.scan_blocks(x)
    return flip(x, spans[-1].check_off + fmt.check_size(flags.check_method)
                + 2)


def footer_flip(x: bytes) -> bytes:
    """The footer's backward size flipped."""
    return flip(x, len(x) - 7)


def span_lanes(x: bytes, span) -> int:
    return len(jax_runtime.plan_lzma2_stream(x, span.payload_start,
                                             0)[0].lanes)


# -- the host half: a copy --------------------------------------------


@pytest.mark.parametrize("name", sorted(ARCHIVES))
def test_scan_blocks_equals_the_original(name):
    x, data = ARCHIVES[name]
    got, want = multihost.scan_blocks(x), jax_multihost.scan_blocks(x)
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
    assert [dataclasses.asdict(s) for s in got[1]] == \
        [dataclasses.asdict(s) for s in want[1]]
    assert got[2] == want[2] == len(data)


@pytest.mark.parametrize("name", sorted(ARCHIVES))
def test_assign_blocks_equals_the_original(name):
    x, _ = ARCHIVES[name]
    spans = multihost.scan_blocks(x)[1]
    jspans = jax_multihost.scan_blocks(x)[1]
    for n in (1, 2, 3, 4):
        assert multihost.assign_blocks(spans, n) == \
            jax_multihost.assign_blocks(jspans, n)


def waves_key(host_waves, sizes):
    return ([[[dataclasses.asdict(s) for s in w] for w in h]
             for h in host_waves], sizes)


@pytest.mark.parametrize("name", sorted(ARCHIVES))
def test_plan_waves_equals_the_original(name):
    x, _ = ARCHIVES[name]
    spans = multihost.scan_blocks(x)[1]
    jspans = jax_multihost.scan_blocks(x)[1]
    assert multihost.WAVE_BYTES == jax_multihost.WAVE_BYTES
    for n in (1, 2, 3, 4):
        owner = multihost.assign_blocks(spans, n)
        for wave in (512, 4096, 16384, 1 << 20, multihost.WAVE_BYTES):
            got = multihost.plan_waves(spans, owner, n, wave)
            assert waves_key(*got) == waves_key(*jax_multihost.plan_waves(
                jspans, owner, n, wave)), (n, wave)


def simulated_waves(x: bytes, n: int, wave_bytes: int):
    """The JAX protocol's gathered waves, simulated: wave w is ``[n,
    wave_sizes[w]]``, row h host h's blocks of that wave decoded in stream
    order (the JAX package's native engine) and zero-padded."""
    _, spans, _ = jax_multihost.scan_blocks(x)
    owner = jax_multihost.assign_blocks(spans, n)
    host_waves, sizes = jax_multihost.plan_waves(spans, owner, n, wave_bytes)
    gathered = []
    for w, size in enumerate(sizes):
        g = np.zeros((n, size), np.uint8)
        for h in range(n):
            off = 0
            for s in host_waves[h][w]:
                plan, _ = jax_runtime.plan_lzma2_stream(x, s.payload_start, 0)
                out = jax_runtime.execute_plan_native(x, [plan])
                g[h, off:off + s.out_len] = np.frombuffer(out, np.uint8)
                off += s.out_len
        gathered.append(g)
    return host_waves, gathered


@pytest.mark.parametrize("name", sorted(ARCHIVES))
def test_stitch_waves_equals_the_original(name):
    x, data = ARCHIVES[name]
    for n, wave in ((2, 4096), (3, 1 << 20)):
        jhw, gathered = simulated_waves(x, n, wave)
        spans = multihost.scan_blocks(x)[1]
        hw, _ = multihost.plan_waves(
            spans, multihost.assign_blocks(spans, n), n, wave)
        got = multihost.stitch_waves(hw, gathered, n, len(data))
        want = jax_multihost.stitch_waves(jhw, gathered, n, len(data))
        assert bytes(got) == bytes(want) == data


# -- one process ------------------------------------------------------


def single_cases():
    x, _ = ARCHIVES["small-512"]
    _, spans, _ = jax_multihost.scan_blocks(x)
    mid = spans[1]
    return {
        "clean": x,
        "check-flipped": check_flip(x),
        "payload-flipped": flip(x, mid.payload_start + mid.payload_len // 2),
        "truncated": x[:-9],
    }


def outcome(fn, st_mod, *args, **kw):
    with st_mod.collect() as s:
        try:
            out = digest(fn(*args, **kw))
        except Exception as e:  # the parity object under test
            out = error_key(e)
    return out, s.fallbacks


@pytest.mark.parametrize("engine", ["native", "cuda-on-cpu"])
@pytest.mark.parametrize("case", list(single_cases()))
def test_one_process_equals_the_original(case, engine):
    """Without a group the call is the runtime's single-process decode;
    ``cuda`` on the CPU device runs the plain version, held against the
    JAX package's ``tpu-vmem`` (interpret mode)."""
    x = single_cases()[case]
    if engine == "native":
        got = outcome(multihost.xz_decode_multihost, stats, x, "native")
        want = outcome(jax_multihost.xz_decode_multihost, jax_stats, x,
                       "native")
    else:
        got = outcome(multihost.xz_decode_multihost, stats, x, "cuda", CPU)
        want = outcome(jax_multihost.xz_decode_multihost, jax_stats, x,
                       "tpu-vmem")
    assert got == want
    if case == "clean":
        assert got[0] == digest(ARCHIVES["small-512"][1])
    else:
        assert isinstance(got[0], list)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, _ = ARCHIVES["crc32-4k"]
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        multihost.xz_decode_multihost(x)  # cuda is the default
    with pytest.raises(ValueError, match="engine 'tpu-vmem'"):
        multihost.xz_decode_multihost(x, "tpu-vmem", CPU)
    assert multihost.xz_decode_multihost(x, "native") == \
        ARCHIVES["crc32-4k"][1]


# -- several processes: this file is each rank's script ---------------


def job(name, archive, engine="native", wave_bytes=None, x=None, env=None,
        patch=None, device="cpu"):
    return {"name": name, "archive": archive, "engine": engine,
            "wave_bytes": wave_bytes, "x": x, "env": env or {},
            "patch": patch, "device": device}


def group_jobs(world: int) -> list:
    crc64 = ARCHIVES["crc64-16k"][0]
    cpu_slabs = {"LZMA_RS_TPU_DEVICES": "3"}  # one process: 3 CPU slabs
    jobs = [
        job("native-waves", "crc64-16k" if world == 2 else "crc32-4k",
            wave_bytes=16384),
        job("cuda-waves", "small-512", "cuda", wave_bytes=1024,
            env=cpu_slabs),
        job("check-flipped", "crc64-16k", x=check_flip(crc64)),
        job("empty-blocks-native", "empty-blocks", wave_bytes=512),
    ]
    if world == 2:
        small = ARCHIVES["small-512"][0]
        jobs += [
            job("native-one-wave", "sha256-64k"),
            job("index-flipped", "crc64-16k", x=index_flip(crc64)),
            job("footer-flipped", "crc64-16k", x=footer_flip(crc64)),
            job("no-blocks-native", "no-blocks"),
            job("no-blocks-cuda", "no-blocks", "cuda"),
            job("empty-blocks-cuda", "empty-blocks", "cuda", wave_bytes=512),
            job("stored-cuda", "stored", "cuda", wave_bytes=1024),
            job("stdlib-one-block", "stdlib-one-block"),
            job("auto", "small-512", "auto", wave_bytes=1024,
                env={"LZMA_RS_TPU_AUTO_MIN_LANES": "1",
                     "LZMA_RS_TPU_AUTO_MIN_OUT": "1"}),
            job("ineligible->native", "small-512", "cuda",
                patch="VmemIneligible"),
            job("kernel-error->native", "small-512", "cuda",
                patch="_KernelError"),
            job("launch-failure-raises", "small-512", "cuda",
                patch="RuntimeError"),
            job("check-flipped-cuda", "small-512", "cuda",
                x=check_flip(small, 0)),
        ]
    return jobs


def run_job(j: dict, path: str) -> dict:
    """One job on this rank: its outcome and what the device arm did."""
    from lzma_rs_tpu_torch.ops import segment_decoder as sd
    from lzma_rs_tpu_torch.tools import multihost_demo

    with open(path, "rb") as f:
        x = f.read()
    rec = {"gathered": None, "call_devices": []}
    orig_stitch = multihost.stitch_waves
    orig_decode = sd.decode_segments
    orig_device = runtime.execute_plan_device

    def spy_stitch(host_waves, gathered, n, total):
        rec["gathered"] = [[list(g.shape), digest(g.tobytes())]
                           for g in gathered]
        return orig_stitch(host_waves, gathered, n, total)

    def spy_decode(inbuf, *a, **kw):
        rec["call_devices"].append(str(inbuf.device))
        return orig_decode(inbuf, *a, **kw)

    # the wrapper counts its launches on the name it is called by
    spy_decode.launches = launches = orig_decode.launches

    def failing(*a, **kw):
        raise {"VmemIneligible": runtime.VmemIneligible("a test's refusal"),
               "_KernelError": runtime._KernelError(0, 2),
               "RuntimeError": RuntimeError("the kernel did not build"),
               }[j["patch"]]

    saved_env = {k: os.environ.get(k) for k in j["env"]}
    os.environ.update(j["env"])
    multihost.stitch_waves = spy_stitch
    sd.decode_segments = spy_decode
    if j["patch"]:
        runtime.execute_plan_device = failing
    device = multihost_demo.rank_device(0, None if j["device"] == "card"
                                        else j["device"])
    try:
        with stats.collect() as st:
            try:
                rec["out"] = digest(multihost.xz_decode_multihost(
                    x, j["engine"], device, wave_bytes=j["wave_bytes"]))
            except Exception as e:  # the outcome under test
                rec["out"] = error_key(e)
    finally:
        multihost.stitch_waves = orig_stitch
        sd.decode_segments = orig_decode
        orig_decode.launches = spy_decode.launches
        runtime.execute_plan_device = orig_device
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    rec.update(engine=st.engine, fallbacks=st.fallbacks,
               waves=st.multihost_waves, devices=st.devices,
               launches=orig_decode.launches - launches)
    return rec


def rank_main(rank: int, world: int, store: str, jobs_path: str) -> None:
    """A rank's script: join the group, run every job, write the results
    to ``<jobs_path>.rank<rank>``."""
    import datetime

    import torch.distributed as dist

    with open(jobs_path) as f:
        jobs = json.load(f)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        results = {j["name"]: run_job(j, j["path"]) for j in jobs}
    finally:
        dist.destroy_process_group()
    results["jax loaded"] = sorted(m for m in sys.modules
                                   if m == "jax" or m.startswith("jax."))
    with open(f"{jobs_path}.rank{rank}", "w") as f:
        json.dump(results, f)


def run_group(tmp, world: int, jobs: list) -> list:
    """Run ``jobs`` in a gloo group of ``world`` ranks; each rank's
    results."""
    from lzma_rs_tpu_torch.tools import multihost_demo

    for j in jobs:
        j["path"] = str(tmp / f"{j['name']}.xz")
        with open(j["path"], "wb") as f:
            f.write(ARCHIVES[j["archive"]][0] if j["x"] is None
                    else bytes(j["x"]))
        j["x"] = None
    jobs_path = str(tmp / "jobs.json")
    with open(jobs_path, "w") as f:
        json.dump(jobs, f)
    env = {**os.environ, "PYTHONPATH": REPO}
    res = multihost_demo.launch(
        [[sys.executable, os.path.abspath(__file__), str(r), str(world),
          str(tmp / "store"), jobs_path] for r in range(world)],
        JOIN_TIMEOUT_S, env=env)
    for r, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {r} exited {rc}: {err[-3000:]}"
    out = []
    for r in range(world):
        with open(f"{jobs_path}.rank{r}") as f:
            out.append(json.load(f))
    return out


def expected(j: dict, world: int, want=None) -> dict:
    """What every rank must report for ``j``, from the JAX package: its
    ``xz_decode_multihost``'s outcome (imports ``jax``) unless ``want`` is
    given, and its host half's waves."""
    x = ARCHIVES[j["archive"]][0] if j["x"] is None else j["x"]
    if want is None:
        with jax_stats.collect():
            try:
                want = digest(jax_multihost.xz_decode_multihost(x, "native"))
            except Exception as e:  # the outcome under test
                want = error_key(e)
    wave = j["wave_bytes"] or jax_multihost.WAVE_BYTES
    try:
        host_waves, gathered = simulated_waves(x, world, wave)
    except Exception:  # the container itself is broken: no waves
        host_waves, gathered = None, None
    calls = None
    if host_waves is not None:
        calls = [sum(1 for w in hw if any(span_lanes(x, s) for s in w))
                 for hw in host_waves]
    return {"out": want, "gathered": None if gathered is None else
            [[list(g.shape), digest(g.tobytes())] for g in gathered],
            "calls": calls}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Each group's jobs and every rank's results, run once."""
    out = {}
    for world in (2, 3):
        jobs = group_jobs(world)
        ranks = run_group(tmp_path_factory.mktemp(f"world{world}"), world,
                          [dict(j) for j in jobs])
        out[world] = ({j["name"]: j for j in jobs}, ranks)
    return out


# every job but the failed launch, which the JAX function would hide
GROUP_CASES = [(w, j["name"]) for w in (2, 3) for j in group_jobs(w)
               if j["patch"] != "RuntimeError"]


@pytest.mark.parametrize("world,name", GROUP_CASES)
def test_every_rank_returns_the_original_outcome(groups, world, name):
    jobs, ranks = groups[world]
    j = jobs[name]
    want = expected(j, world)
    for rank, res in enumerate(ranks):
        got = res[name]
        assert got["out"] == want["out"], (rank, got["out"])
        if j["engine"] == "auto":  # the router's record, once a wave
            assert all(f.startswith("auto->native: ")
                       for f in got["fallbacks"])
        else:  # the JAX function records none on this path
            assert got["fallbacks"] == []
        assert res["jax loaded"] == []
        if isinstance(want["out"], list):
            continue  # an error: every rank raised the JAX package's
        assert got["waves"] == len(want["gathered"])
        # the gathered waves equal the JAX protocol's, simulated
        assert got["gathered"] == want["gathered"], rank
        if j["engine"] == "cuda" and not j["patch"]:
            # one call a wave that holds lanes, on this rank's device only
            assert len(got["call_devices"]) == want["calls"][rank]
            assert set(got["call_devices"]) <= {"cpu"}
            assert got["engine"] in ("cpu", "") and got["devices"] <= 1


def test_a_group_runs_several_waves_a_rank(groups):
    jobs, ranks = groups[2]
    for name in ("native-waves", "cuda-waves"):
        for res in ranks:
            assert res[name]["waves"] >= 2
            assert len(res[name]["gathered"]) >= 2
    # the cuda arm's waves each ran the kernel's plain version
    assert [len(r["cuda-waves"]["call_devices"]) for r in ranks] == \
        expected(jobs["cuda-waves"], 2)["calls"]
    assert all(c >= 2 for c in expected(jobs["cuda-waves"], 2)["calls"])


def test_the_device_arm_catches_only_what_the_host_can_replay(groups):
    _, ranks = groups[2]
    data = digest(ARCHIVES["small-512"][1])
    for res in ranks:
        assert res["ineligible->native"]["out"] == data
        assert res["ineligible->native"]["engine"] == "native"
        assert res["kernel-error->native"]["out"] == data
        assert res["launch-failure-raises"]["out"] == [
            "RuntimeError", "the kernel did not build"]


def test_a_rank_keeps_its_slabs_on_its_own_device(groups, monkeypatch):
    """``LZMA_RS_TPU_DEVICES=3`` gives one process three CPU slabs; a rank
    of the group takes one, so one call a wave."""
    monkeypatch.setenv("LZMA_RS_TPU_DEVICES", "3")
    x, _ = ARCHIVES["small-512"]
    n_lanes = sum(len(p.lanes) for p in runtime.plan_xz(x)[0])
    assert len(runtime.slab_devices(n_lanes, CPU)[1]) == 3
    assert len(runtime.slab_devices(n_lanes, CPU, max_devices=1)[1]) == 1
    for w in (2, 3):
        _, ranks = groups[w]
        for res in ranks:
            assert res["cuda-waves"]["devices"] == 1
            assert res["cuda-waves"]["engine"] == "cpu"


def test_empty_archives_and_empty_blocks(groups):
    """No blocks at all (``wave_sizes == [0]``, no collective), and blocks
    of zero bytes among others."""
    for w in (2, 3):
        _, ranks = groups[w]
        for res in ranks:
            assert res["empty-blocks-native"]["out"] == digest(
                ARCHIVES["empty-blocks"][1])
    for res in groups[2][1]:
        assert res["no-blocks-native"]["out"] == digest(b"")
        assert res["no-blocks-cuda"]["out"] == digest(b"")
        assert res["no-blocks-native"]["waves"] == 1
        assert res["no-blocks-native"]["gathered"] == [[[2, 0],
                                                        digest(b"")]]
        assert res["empty-blocks-cuda"]["out"] == digest(
            ARCHIVES["empty-blocks"][1])
        assert res["stored-cuda"]["call_devices"] == []  # no lanes


def test_the_demo_runs_two_ranks_on_the_cpu():
    from lzma_rs_tpu_torch.tools import multihost_demo

    port = multihost_demo.free_port()
    res = multihost_demo.launch(
        [[sys.executable, "-m", "lzma_rs_tpu_torch.tools.multihost_demo",
          str(r), "2", str(port), "--engine", "native"] for r in range(2)],
        JOIN_TIMEOUT_S, env={**os.environ, "PYTHONPATH": REPO})
    for r, (rc, out, err) in enumerate(res):
        assert rc == 0, err[-3000:]
        assert out.startswith(f"rank {r}/2: OK (1048576 bytes, bit-exact; ")
        assert int(out.split("; ")[1].split()[0]) >= 2  # waves pipelined


def test_the_scaling_tool_on_the_cpu(monkeypatch):
    """One and two ranks under ``native``; without a card and without
    ``--device cpu`` it exits nonzero before starting a rank."""
    from lzma_rs_tpu_torch.tools import scaling

    monkeypatch.setenv("PYTHONPATH", REPO)
    r = scaling.measure(0.25, [1, 2], "native", "cpu")
    assert r["corpus_mb"] == 0.25 and r["device"] == "cpu (no card)"
    assert set(r["wall_s"]) == {"1", "2"}
    assert r["decode_s"]["1"] == r["wall_s"]["1"]  # one process
    assert 0 < r["decode_s"]["2"] <= r["wall_s"]["2"]
    assert r["decode_scaling_efficiency"]["1"] == 1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        scaling.main(["--mb", "0.25"])


@pytest.mark.cuda
def test_two_ranks_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jobs = [job("card-waves", "tpu-profile", "cuda", wave_bytes=8192,
                device="card"),
            job("card-one-wave", "crc32-4k", "cuda", device="card")]
    ranks = run_group(tmp_path, 2, [dict(j) for j in jobs])
    for j in jobs:  # the card's machine has no jax: the corpus's digest
        want = expected(j, 2, digest(ARCHIVES[j["archive"]][1]))
        for rank, res in enumerate(ranks):
            got = res[j["name"]]
            assert got["out"] == want["out"]
            assert got["engine"] == "cuda" and got["fallbacks"] == []
            assert got["launches"] == want["calls"][rank]
            assert set(got["call_devices"]) == {"cuda:0"}


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
