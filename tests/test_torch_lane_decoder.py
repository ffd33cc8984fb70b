"""The lane engine's plain version against the JAX lane kernel, and the
kernel's own source (built for the host) against the plain version.

``lzma_rs_tpu_torch/ops/lane_decoder.py::decode_lanes_reference`` must equal
``lzma_rs_tpu/ops/lane_decoder.py::decode_lanes`` (jit on the CPU, as the
JAX package's tests run it) exactly: ``out``, ``err``, ``outp`` and the
loop's iterations (the port's longest lane's steps), through
``from_jax_args`` and ``to_jax_outputs``, on the numpy inputs the JAX
runtime's ``execute_plan`` builds (captured from it). One batch holds every
case as lanes of their own: several lanes of stdlib ``lzma`` streams at
several props, a stored chunk at a segment's start and at its end, lc=4
with lp=0 and lc=0 with lp=4, pb=4, a segment of 12 chunks, raw LZMA
lanes with a dictionary smaller than a match distance (``ERR_DIST_DICT``)
and of unknown size up to the end marker, and corrupted streams of
``tests/test_engine_equivalence.py``'s generator. A stored chunk between
two LZMA chunks of a segment is the one case where the two differ: the
JAX kernel does not move ``outp`` to the chunk's ``out_start`` and fails
the lane, the port decodes it (asserted as such).

The g++ build of ``csrc/lane_engine.cuh`` (``ops/build.py::load_host``)
must equal the plain version bit for bit on the same batch, with step
budgets that stop lanes, and on one lane of ~110 KiB with match distances
above 65,536 (its bytes equal the payload; with ``dict_size`` 65,536 the
lane stops with ``ERR_DIST_DICT``, which shows the distances). The JAX
package is imported only inside the fixtures that need it; the tests
marked ``cuda`` hold the kernel against the plain version on a card.
"""

import dataclasses
import json
import lzma as liblzma
import random

import numpy as np
import pytest
import torch

from lzma_rs_tpu_torch.ops import build
from lzma_rs_tpu_torch.ops import lane_decoder as ld
from lzma_rs_tpu_torch.parallel import runtime
from lzma_rs_tpu_torch.tools import corpus as corpus_mod

from test_torch_kernel_hostbuild import text


def raw2(data: bytes, preset: int = 6, **props) -> bytes:
    return corpus_mod.raw_lzma2(data, preset, **props)


def raw1(data: bytes, dict_size: int = 1 << 16) -> bytes:
    """stdlib ``lzma``'s raw LZMA stream (lc=3, lp=0, pb=2), which ends in
    an end marker."""
    filt = {"id": liblzma.FILTER_LZMA1, "dict_size": dict_size, "lc": 3,
            "lp": 0, "pb": 2}
    return liblzma.compress(data, format=liblzma.FORMAT_RAW, filters=[filt])


def chunked(pieces) -> bytes:
    """One LZMA2 segment of ``pieces`` (``("lzma" | "stored", bytes)``):
    each LZMA piece compressed alone at lc=lp=pb=0 (its literals read no
    earlier byte, its matches stay inside it), then chained with state
    resets and no dictionary reset, so the chunks decode in one window."""
    out, first, props = bytearray(), True, False
    for kind, piece in pieces:
        if kind == "stored":
            out += bytes([0x01 if first else 0x02])
            out += (len(piece) - 1).to_bytes(2, "big") + piece
        else:
            c = raw2(piece, 6, lc=0, lp=0, pb=0)
            packed = int.from_bytes(c[3:5], "big") + 1
            assert c[0] == 0xE0 and len(c) == 6 + packed + 1, "one chunk"
            if first:
                out += c[:-1]
            elif not props:
                out += bytes([0xC0]) + c[1:6] + c[6:-1]
            else:
                out += bytes([0xA0]) + c[1:5] + c[6:-1]
            props = True
        first = False
    return bytes(out) + b"\x00"


@dataclasses.dataclass
class Batch:
    """Lanes of several streams laid out one after another in one archive
    and one output, with each lane's case name and its stream's payload."""

    blob: bytearray = dataclasses.field(default_factory=bytearray)
    plans: list = dataclasses.field(default_factory=list)
    names: list = dataclasses.field(default_factory=list)  # per lane
    payloads: list = dataclasses.field(default_factory=list)  # (out0, data)
    total: int = 0

    def lzma2(self, name: str, stream: bytes, payload=None) -> None:
        off = len(self.blob)
        self.blob += stream
        plan, _ = runtime.plan_lzma2_stream(bytes(self.blob), off, self.total)
        assert plan.pending_error is None
        self._add(name, plan, payload)

    def raw(self, name: str, stream: bytes, payload: bytes, dict_size: int,
            size_known: int = 1, props=(3, 0, 2)) -> None:
        off = len(self.blob)
        self.blob += stream
        n = len(payload)
        lc, lp, pb = props
        lane = runtime.LanePlan(
            in_start=[off], in_end=[off + len(stream)],
            out_start=[self.total], out_end=[self.total + n], reset_state=[1],
            lc=[lc], lp=[lp], pb=[pb], seg_base=self.total,
            size_known=size_known, dict_size=dict_size)
        self._add(name, runtime.DecodePlan(lanes=[lane], prefill=[],
                                           total_out=n), payload)

    def _add(self, name, plan, payload):
        self.plans.append(plan)
        self.names += [name] * len(plan.lanes)
        self.payloads.append((self.total, payload))
        self.total += plan.total_out

    def lanes(self):
        return [lane for p in self.plans for lane in p.lanes]

    def tensors(self, device="cpu"):
        """``decode_lanes``' inputs for the batch, as the runtime's
        ``execute_plan`` builds them."""
        return runtime.lane_tables(bytes(self.blob), self.plans).tensors(
            device)


def corrupt_lanes(batch: Batch, n_streams: int = 3, flips: int = 3) -> None:
    """Small payloads of ``test_engine_equivalence``'s generator (the first
    seeds from 20,000 whose payload is 1-3 KB), compressed at preset 6,
    each with ``flips`` variants of one flipped bit in its chunk's data
    (a flip that changes the chunk table is skipped)."""
    from test_engine_equivalence import _gen_payload

    seed, added = 20_000, 0
    while added < n_streams:
        rng = random.Random(seed)
        seed += 1
        payload = _gen_payload(rng)
        if not 1000 <= len(payload) <= 3000:
            continue
        c = raw2(payload)
        if len(runtime.plan_lzma2_stream(c, 0, 0)[0].lanes) != 1:
            continue  # stored chunks only: nothing for a lane to decode
        done = 0
        while done < flips:
            i = rng.randrange(6, len(c) - 1)
            bad = bytearray(c)
            bad[i] ^= 1 << rng.randrange(8)
            try:
                plan, _ = runtime.plan_lzma2_stream(bytes(bad), 0, 0)
            except Exception:  # a flip in a chunk header
                continue
            if plan.pending_error is not None or len(plan.lanes) != 1:
                continue
            batch.lzma2("corrupt", bytes(bad))
            done += 1
        added += 1


def main_batch() -> Batch:
    b = Batch()
    t = text(12_000, 3)
    for i, (preset, props) in enumerate((
            (0, {}), (6, {}), (9, dict(lc=1, lp=2, pb=1)),
            (6, dict(lc=2, lp=1, pb=0)))):
        piece = t[i * 2000:(i + 1) * 2000]
        b.lzma2("several", raw2(piece, preset, **props), piece)
    piece = t[8000:10000]
    b.lzma2("lc4", raw2(piece, 6, lc=4, lp=0), piece)
    b.lzma2("lp4", raw2(piece, 6, lc=0, lp=4), piece)
    b.lzma2("pb4", raw2(piece, 6, pb=4), piece)
    pieces = [("lzma", t[i * 250:(i + 1) * 250] * 2) for i in range(12)]
    b.lzma2("k12", chunked(pieces), b"".join(p for _, p in pieces))
    stored = [("stored", t[10000:10300]), ("lzma", t[:1500])]
    b.lzma2("stored_first", chunked(stored), b"".join(p for _, p in stored))
    stored = [("lzma", t[:1500]), ("stored", t[10000:10300])]
    b.lzma2("stored_last", chunked(stored), b"".join(p for _, p in stored))
    far = t[:700] + t[5000:8000] + t[:700]  # a match 3,700 back
    b.raw("dict_small", raw1(far), far, dict_size=2048)
    b.raw("dict_fits", raw1(far), far, dict_size=4096)
    b.raw("size_unknown", raw1(t[2000:3500]), t[2000:3500], 1 << 16,
          size_known=0)
    corrupt_lanes(b)
    return b


def stored_mid_batch() -> Batch:
    b = Batch()
    t = text(4000, 4)
    pieces = [("lzma", t[:1200]), ("stored", t[3000:3400]),
              ("lzma", t[1200:2400])]
    b.lzma2("stored_mid", chunked(pieces), b"".join(p for _, p in pieces))
    b.lzma2("plain", raw2(t[:1500]), t[:1500])
    return b


def jax_capture(batch: Batch):
    """The numpy inputs the JAX runtime's ``execute_plan`` hands its
    jitted ``decode_lanes`` for the batch's plans, and that function's
    outputs."""
    from lzma_rs_tpu.parallel import runtime as jrt

    real = jrt._jitted_decoder()
    rec = {}

    def recorder(*args, **kw):
        rec["args"] = [np.asarray(a) for a in args]
        res = real(*args, **kw)
        rec["res"] = [np.asarray(r) for r in res]
        return res

    jplans = [jrt.DecodePlan(
        lanes=[jrt.LanePlan(**dataclasses.asdict(lane)) for lane in p.lanes],
        prefill=list(p.prefill), total_out=p.total_out) for p in batch.plans]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrt, "_jitted_decoder", lambda: recorder)
        try:
            jrt.execute_plan(bytes(batch.blob), jplans)
        except jrt._KernelError:
            pass
    return rec["args"], rec["res"]


def port_on_jax_args(args):
    got = ld.decode_lanes(*ld.from_jax_args(*args))
    return ld.to_jax_outputs(*got, args[1])


@pytest.fixture(scope="module")
def main():
    b = main_batch()
    args, want = jax_capture(b)
    return b, args, want, port_on_jax_args(args)


def lane_rows(batch: Batch, name: str):
    return [i for i, n in enumerate(batch.names) if n == name]


CASES = ("several", "lc4", "lp4", "pb4", "k12", "stored_first",
         "stored_last", "dict_small", "dict_fits", "size_unknown", "corrupt")


@pytest.mark.parametrize("case", CASES)
def test_plain_version_equals_jax(main, case):
    batch, _, want, got = main
    lanes = batch.lanes()
    rows = lane_rows(batch, case)
    assert rows
    for i in rows:
        lane = lanes[i]
        a, z = lane.seg_base, lane.out_end[-1]
        assert got[1][i] == want[1][i], (case, i)
        assert got[2][i] == want[2][i], (case, i)
        assert np.array_equal(got[0][a:z], want[0][a:z]), (case, i)


def test_plain_version_equals_jax_whole(main):
    batch, args, want, got = main
    L = len(batch.lanes())
    assert len(want[1]) >= L and len(want[0]) == len(args[1])
    assert np.array_equal(got[0], want[0])  # padding and dump slot too
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
    assert got[3] == int(want[3])  # the loop's iterations: longest lane


def test_codes_are_the_jax_codes(main):
    batch, _, want, got = main
    codes = dict(zip(batch.names, got[1]))
    assert codes["dict_small"] == ld.ERR_DIST_DICT == 3
    assert codes["dict_fits"] == codes["size_unknown"] == 0
    bad = [int(got[1][i]) for i in lane_rows(batch, "corrupt")]
    assert any(bad) and set(bad) <= set(range(8))


def test_clean_lanes_decode_their_payload(main):
    batch, _, _, got = main
    for (out0, payload), name in zip(batch.payloads, _plan_names(batch)):
        if payload is None or name in ("dict_small", "corrupt"):
            continue
        assert got[0][out0:out0 + len(payload)].tobytes() == payload, name


def _plan_names(batch):
    names, i = [], 0
    for p in batch.plans:
        names.append(batch.names[i])
        i += len(p.lanes)
    return names


def test_stored_chunk_mid_segment():
    """The JAX kernel leaves ``outp`` where the previous LZMA chunk ended,
    so the chunk after a stored chunk decodes over the stored bytes and
    the lane fails; the port starts each chunk at its ``out_start`` and
    decodes the lane, as the native engine does. The other lane agrees."""
    batch = stored_mid_batch()
    args, want = jax_capture(batch)
    got = port_on_jax_args(args)
    mid, other = lane_rows(batch, "stored_mid")[0], lane_rows(batch, "plain")
    assert want[1][mid] != 0 and got[1][mid] == 0
    out0, payload = batch.payloads[0]
    assert got[0][out0:out0 + len(payload)].tobytes() == payload
    for i in other:
        lane = batch.lanes()[i]
        a, z = lane.seg_base, lane.out_end[-1]
        assert got[1][i] == want[1][i] == 0 and got[2][i] == want[2][i]
        assert np.array_equal(got[0][a:z], want[0][a:z])


# -- the kernel's source built for the host --------------------------------

@pytest.fixture(scope="module")
def host_lib():
    return build.load_host()


def host_decode(lib, *tensors, max_steps=None):
    t = [x.clone() for x in tensors]
    L, K = t[2].shape
    err, outp = (torch.zeros(L, dtype=torch.int32) for _ in range(2))
    steps = torch.zeros(L, dtype=torch.int64)
    rc = lib.lzl_decode_lanes_host(
        t[0].data_ptr(), t[1].data_ptr(),
        *(x.data_ptr() for x in t[2:]), err.data_ptr(), outp.data_ptr(),
        steps.data_ptr(), L, K, t[0].numel(), t[1].numel(),
        0 if max_steps is None else max_steps)
    assert rc == 0
    return t[1], err, outp, steps


def plain(*tensors, max_steps=None):
    return ld.decode_lanes_reference(*(x.clone() for x in tensors),
                                     max_steps=max_steps)


@pytest.fixture(scope="module")
def main_tensors():
    return main_batch().tensors()


@pytest.fixture(scope="module")
def main_plain(main_tensors):
    return plain(*main_tensors)


def test_host_build_equals_plain_version(host_lib, main_tensors, main_plain):
    got = host_decode(host_lib, *main_tensors)
    for what, g, w in zip(("out", "err", "outp", "steps"), got, main_plain):
        assert torch.equal(g, w), what


@pytest.mark.parametrize("budget", [40, 900, 2500])
def test_host_build_step_cap(host_lib, main_tensors, budget):
    got = host_decode(host_lib, *main_tensors, max_steps=budget)
    want = plain(*main_tensors, max_steps=budget)
    for what, g, w in zip(("out", "err", "outp", "steps"), got, want):
        assert torch.equal(g, w), what
    assert int(want[3].max()) == budget
    capped = want[3] == budget
    assert (want[1][capped] != 0).all()


def far_batch(dict_size: int = 0xFFFFFFFF) -> Batch:
    """One lane of ~110 KiB: text, 66 KiB of a repeated pattern (long
    matches), the text again (matches ~69 KiB back), another pattern and
    the text changed in places."""
    t = text(3000, 7)
    pat1 = (b"0123456789abcdefghijklmnopqrstuvwxyz:" * 1800)[:66_000]
    pat2 = (b"-=+*/ THE QUICK BROWN FOX " * 1400)[:36_000]
    tail = bytearray(t)
    for k in range(0, len(tail), 97):
        tail[k] = 33 + k % 90
    payload = t + pat1 + t + pat2 + bytes(tail)
    b = Batch()
    b.lzma2("far", raw2(payload, 6), payload)
    lanes = b.lanes()
    assert len(lanes) == 1
    lanes[0].dict_size = dict_size
    return b


@pytest.fixture(scope="module")
def far_tensors():
    return far_batch().tensors()


def test_far_lane_host_build_plain_version_and_stdlib(host_lib, far_tensors):
    payload = far_batch().payloads[0][1]
    got = host_decode(host_lib, *far_tensors)
    want = plain(*far_tensors)
    for what, g, w in zip(("out", "err", "outp", "steps"), got, want):
        assert torch.equal(g, w), what
    assert want[1].tolist() == [0] and want[2].tolist() == [len(payload)]
    assert len(payload) > 100 * 1024
    assert want[0].numpy().tobytes() == payload


def test_far_lane_reaches_past_65536(host_lib):
    """With a 64 KiB dictionary the lane stops at its first match from
    farther back: ERR_DIST_DICT, in the host build and the plain
    version alike."""
    tensors = far_batch(dict_size=65536).tensors()
    got = host_decode(host_lib, *tensors)
    want = plain(*tensors)
    for what, g, w in zip(("out", "err", "outp", "steps"), got, want):
        assert torch.equal(g, w), what
    assert want[1].tolist() == [ld.ERR_DIST_DICT]
    assert int(want[2][0]) > 65536


def test_budgets():
    w = torch.tensor([0, 1000, 10**8], dtype=torch.int64)
    n = torch.tensor([0, 3, 40], dtype=torch.int64)
    assert ld.lane_budgets(w, n).tolist() == [64, 24_070, 2_400_000_144]
    assert ld.lane_budgets(w, n, 500).tolist() == [64, 500, 500]
    assert ld.smem_bytes() == build.load_host().lzl_lanes_smem_bytes_host()


# Windows up to the largest the runtime takes (outputs < 2^31 bytes), with
# the most chunks a lane of that window can hold (a chunk emits a byte).
WINDOWS = [0, 1, 65_536, 89_478_485, 97_612_893, 2**30, 2**31 - 1]


@pytest.mark.parametrize("w", WINDOWS)
def test_budget_covers_every_valid_lane(w):
    """No valid lane takes more than ``22 w + K + 1`` steps, so the budget
    stays above that for every window the runtime takes: past 89 MB too,
    where the int32 count stopped valid lanes with ``ERR_STEP_CAP``."""
    for k in (0, 1, min(w, 2**20)):
        got = ld.lane_budgets(torch.tensor([w]), torch.tensor([k]))
        assert got.dtype == torch.int64
        assert int(got[0]) >= 22 * w + k + 1


@pytest.mark.parametrize("w", WINDOWS)
def test_host_lane_budget_covers_every_valid_lane(host_lib, w):
    """``csrc/lane_engine.cuh::lane_budget`` (the g++ build) equals
    ``lane_budgets`` and covers ``22 w + K + 1``; a ``max_steps`` above
    2^32 caps it uncut."""
    for k in (0, 1, min(w, 2**20)):
        want = int(ld.lane_budgets(torch.tensor([w]), torch.tensor([k]))[0])
        assert host_lib.lzl_lane_budget_host(w, k, 0) == want
        assert want >= 22 * w + k + 1
        cap = 2**32 + 40
        assert host_lib.lzl_lane_budget_host(w, k, cap) == min(want, cap)


def test_max_steps_past_int32(host_lib, main_tensors, main_plain):
    """``max_steps`` = 2^32 + 40 caps no lane of the batch: the wrapper
    (the plain version on CPU tensors) and the host build give the uncapped
    outputs, so it is not cut to int32 (it would be 40)."""
    big = 2**32 + 40
    for got in (ld.decode_lanes(*(x.clone() for x in main_tensors),
                                max_steps=big),
                host_decode(host_lib, *main_tensors, max_steps=big)):
        for what, g, w in zip(("out", "err", "outp", "steps"), got,
                              main_plain):
            assert torch.equal(g, w), what
    assert got[3].dtype == torch.int64
    assert int(main_plain[3].max()) > 40


def test_wrapper_checks(main_tensors):
    t = list(main_tensors)
    bad = list(t)
    bad[13] = t[13].to(torch.int32)
    with pytest.raises(ValueError, match="dict_size"):
        ld.decode_lanes(*bad)
    bad = list(t)
    bad[2] = t[2][:, :1].contiguous()
    with pytest.raises(ValueError, match="in_end|in_start"):
        ld.decode_lanes(*bad)
    with pytest.raises(ValueError, match="max_steps"):
        ld.decode_lanes(*t, max_steps=0)
    meta = [x.to("meta") for x in t]
    meta[1] = torch.empty(2**31, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        ld.decode_lanes(*meta)
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ld.decode_lanes(*meta)


def test_from_jax_args_drops_the_dump_slot(main):
    _, args, _, _ = main
    port = ld.from_jax_args(*args)
    assert port[1].numel() == len(args[1]) - 1
    assert port[13].dtype == torch.int64 and int(port[13].max()) == 2**32 - 1
    assert all(x.dtype == torch.int32 for x in port[2:13])


def top_values_batch(size_known: int = 0) -> Batch:
    """One raw LZMA lane (stdlib ``lzma``'s ``.lzma`` body) at lc=3, lp=1,
    pb=2 (lc + lp = 4): 600 B of text, 40 KB of a repeated line, the text
    again with every 37th byte changed (matches 40 KB back, each followed
    by a matched literal), 3,000 B of one byte (matches of 273 bytes, the
    length tree's top) and the end marker (position slot 63)."""
    t = text(600, 11)
    fill = (b"0123456789 the lazy dog jumps over\n" * 1200)[:40_000]
    again = bytearray(t)
    for k in range(20, len(again), 37):
        again[k] = 33 + k % 90
    payload = t + fill + bytes(again) + b"x" * 3000
    filt = {"id": liblzma.FILTER_LZMA1, "dict_size": 1 << 20, "lc": 3,
            "lp": 1, "pb": 2}
    alone = liblzma.compress(payload, format=liblzma.FORMAT_ALONE,
                             filters=[filt])
    b = Batch()
    b.raw("top", alone[13:], payload, 1 << 20, size_known=size_known,
          props=(3, 1, 2))
    b.alone = alone
    return b


def test_top_values_lane_is_what_it_says(monkeypatch):
    """The spec decoder, recording each symbol, finds in the lane a match
    of 273 bytes, the end marker's distance (position slot 63) and matched
    literals right after matches more than 32 KiB back."""
    import lzma_rs_tpu_torch as port
    from lzma_rs_tpu_torch.models import spec

    seen = {"len": [], "dist": [], "matched": []}
    real_len, real_dist, real_lit = (spec.DecoderState._decode_len,
                                     spec.DecoderState._decode_distance,
                                     spec.DecoderState._decode_literal)

    def rec_len(self, *a, **k):
        v = real_len(self, *a, **k)
        seen["len"].append(v)
        return v

    def rec_dist(self, *a, **k):
        v = real_dist(self, *a, **k)
        seen["dist"].append(v)
        return v

    def rec_lit(self, *a, **k):
        if self.state >= 7:
            seen["matched"].append(self.rep[0])
        return real_lit(self, *a, **k)

    monkeypatch.setenv("LZMA_RS_TPU_BACKEND", "spec")
    monkeypatch.setattr(spec.DecoderState, "_decode_len", rec_len)
    monkeypatch.setattr(spec.DecoderState, "_decode_distance", rec_dist)
    monkeypatch.setattr(spec.DecoderState, "_decode_literal", rec_lit)
    batch = top_values_batch()
    assert port.lzma_decompress(batch.alone) == batch.payloads[0][1]
    assert max(seen["len"]) == 273 - 2
    assert 0xFFFFFFFF in seen["dist"]
    assert sum(d > 32768 for d in seen["matched"]) >= 8


@pytest.mark.parametrize("budget", [None, 700, 9000])
def test_host_build_top_values(host_lib, budget):
    """The lane of :func:`top_values_batch`: the host build equals the plain
    version bit for bit, whole (its payload, up to the end marker) and cut
    by budgets inside it."""
    batch = top_values_batch()
    tensors = batch.tensors()
    got = host_decode(host_lib, *tensors, max_steps=budget)
    want = plain(*tensors, max_steps=budget)
    for what, g, w in zip(("out", "err", "outp", "steps"), got, want):
        assert torch.equal(g, w), what
    payload = batch.payloads[0][1]
    if budget is None:
        assert want[1].tolist() == [0]
        assert want[0][:len(payload)].numpy().tobytes() == payload
    else:
        assert want[1].tolist() == [ld.ERR_STEP_CAP]
        assert want[3].tolist() == [budget]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["main", "far"])
def test_kernel_matches_plain_version_on_card(which, cuda_device):
    batch = main_batch() if which == "main" else far_batch()
    tensors = batch.tensors(cuda_device)
    before = ld.decode_lanes.launches
    got = ld.decode_lanes(*(x.clone() for x in tensors))
    torch.cuda.synchronize()
    assert ld.decode_lanes.launches == before + 1
    want = plain(*(x.cpu() for x in tensors))
    for what, g, w in zip(("out", "err", "outp", "steps"), got, want):
        assert torch.equal(g.cpu(), w), what


@pytest.mark.cuda
def test_kernel_step_cap_on_card(cuda_device):
    tensors = main_batch().tensors(cuda_device)
    got = ld.decode_lanes(*(x.clone() for x in tensors), max_steps=900)
    torch.cuda.synchronize()
    want = plain(*(x.cpu() for x in tensors), max_steps=900)
    for what, g, w in zip(("out", "err", "outp", "steps"), got, want):
        assert torch.equal(g.cpu(), w), what


def test_recorded_sass_check(monkeypatch, tmp_path):
    """``sass_compare.check_recorded`` (phase 2's check of the decoder's
    SASS): identical digests pass, a changed or missing kernel is named,
    and another nvcc makes the comparison not comparable. The recorded
    file holds the decoder's 15 kernels."""
    from lzma_rs_tpu_torch.tools import sass_compare as sc

    with open(sc.RECORDED) as f:
        rec = json.load(f)
    assert sorted(rec["libraries"]) == ["segdec", "segvar", "stepcost"]
    assert sum(len(v) for v in rec["libraries"].values()) == 15
    assert rec["flags"] == list(build.NVCC_FLAGS)
    lib = rec["libraries"]["segdec"]
    monkeypatch.setattr(sc, "nvcc_version", lambda: rec["nvcc"])
    monkeypatch.setattr(sc, "digests", lambda path: dict(lib))
    ok, rows = sc.check_recorded({"segdec": "x.so"})
    assert ok and rows and all(r[2] for r in rows)
    changed = {k: [n + 1, "0" * 64] for k, (n, _) in lib.items()}
    monkeypatch.setattr(sc, "digests", lambda path: changed)
    ok, rows = sc.check_recorded({"segdec": "x.so"})
    assert ok and not any(r[2] for r in rows)
    monkeypatch.setattr(sc, "digests", lambda path: {})
    _, rows = sc.check_recorded({"segdec": "x.so"})
    assert [r[3] for r in rows] == [0] * len(lib)
    monkeypatch.setattr(sc, "nvcc_version", lambda: "another nvcc")
    assert sc.check_recorded({"segdec": "x.so"})[0] is False
