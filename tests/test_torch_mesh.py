"""The port's lane batching over slabs and devices against the reference.

``LZMA_RS_TPU_VMEM_L`` cuts the sorted lanes into slabs and each launch
takes one slab a device over ``n_dev`` devices, as the JAX package's
``execute_plan_vmem`` does (``lzma_rs_tpu/parallel/runtime.py:881-1030``);
on the CPU, ``LZMA_RS_TPU_DEVICES`` sets the number of CPU slabs a launch.
Each case decodes a 1 KiB-block archive through the device path on CPU
tensors (the kernel's plain version) and must give the JAX package's bytes
under ``LZMA_RS_TPU_BACKEND=native``, the expected slabs (each a
``decode_segments`` call, counted through a wrapper) and
``stats.devices``. A corrupt lane on the third slab gives the reference's
exception and ``stats.fallbacks`` (the JAX package's own slab path, its
Pallas kernel in interpret mode under ``shard_map`` over three of the
tests' XLA host devices). Without ``LZMA_RS_TPU_VMEM_L`` each device
takes one slab: one launch of every lane where there is one device.
"""

import numpy as np
import pytest
import torch

import lzma_rs_tpu
import lzma_rs_tpu_torch
from lzma_rs_tpu.parallel import runtime as jax_runtime
from lzma_rs_tpu.utils import stats as jax_stats
from lzma_rs_tpu_torch.encode.lzma2_enc import lzma2_compress
from lzma_rs_tpu_torch.ops import segment_decoder as sd
from lzma_rs_tpu_torch.parallel import mesh, runtime
from lzma_rs_tpu_torch.utils import stats

from test_torch_kernel_hostbuild import text
from test_torch_runtime import native

CPU = torch.device("cpu")
DATA = text(7 * 1024, 3)  # 7 lanes of 1 KiB


@pytest.fixture
def slabs(monkeypatch):
    """Every ``decode_segments`` call's lane count, in call order."""
    calls = []
    real = sd.decode_segments

    def counted(*args, config, **kw):
        calls.append(config.L)
        return real(*args, config=config, **kw)

    monkeypatch.setattr(sd, "decode_segments", counted)
    return calls


def set_slabs(monkeypatch, lanes, devices):
    if lanes is None:
        monkeypatch.delenv("LZMA_RS_TPU_VMEM_L", raising=False)
    else:
        monkeypatch.setenv("LZMA_RS_TPU_VMEM_L", str(lanes))
    monkeypatch.setenv("LZMA_RS_TPU_DEVICES", str(devices))


# (lanes a slab, devices) -> (slab sizes in call order, stats.devices)
MATRIX = {
    (1, 1): ([1] * 7, 1),
    (1, 3): ([1] * 7, 3),
    (3, 1): ([3, 3, 1], 1),
    (3, 3): ([3, 3, 1], 3),
    (None, 1): ([7], 1),
    (None, 3): ([3, 3, 1], 3),  # one slab a device
}


@pytest.mark.parametrize("lanes,devices", MATRIX,
                         ids=[f"L{a or 'all'}-dev{b}" for a, b in MATRIX])
def test_slabs_match_the_reference_bytes(lanes, devices, slabs,
                                         monkeypatch):
    xz = lzma_rs_tpu.xz_compress(DATA, block_size=1024, check_method=1)
    want, _ = native("xz_decompress", xz, monkeypatch)
    set_slabs(monkeypatch, lanes, devices)
    with stats.collect() as s:
        out = runtime.xz_decode(xz, engine="cuda", device=CPU)
    assert out == want == DATA
    sizes, n_dev = MATRIX[lanes, devices]
    assert slabs == sizes
    assert s.devices == n_dev and s.engine == "cpu" and s.fallbacks == []
    assert s.lanes == 7


def test_slabs_with_and_without_stored_chunks(slabs, monkeypatch):
    """An LZMA2 stream of five segments, the second holding a stored chunk
    between two LZMA chunks: in slabs of one lane over three CPU devices
    the stored bytes reach that lane's slab alone, and the stream decodes
    as the reference's native engine decodes it."""
    segs = [text(1024, 10 + i) for i in range(5)]
    noise = np.random.default_rng(9).integers(0, 256, 1024,
                                              dtype=np.uint8).tobytes()
    segs[1] = segs[1] + noise + text(1024, 20)  # chunk 1 is stored
    streams = [lzma2_compress(d, level=6, chunk_size=1024) for d in segs]
    stream = b"".join(s[:-1] for s in streams[:-1]) + streams[-1]
    want, _ = native("lzma2_decompress", stream, monkeypatch)
    assert want == b"".join(segs)
    plan, _ = runtime.plan_lzma2_stream(stream, 0, 0)
    staged = runtime.stage_plans(stream, [plan])
    assert plan.prefill and staged.prefilled.sum() == 1
    set_slabs(monkeypatch, 1, 3)
    with stats.collect() as s:
        assert runtime.lzma2_decode(stream, engine="cuda", device=CPU) == want
    assert slabs == [1] * 5 and s.devices == 3 and s.fallbacks == []
    # each slab's window: the stored bytes in the prefilled lane's only
    i = int(np.argmax(staged.prefilled))
    for a in range(5):
        win = staged.tensors(CPU, a, a + 1)[1]
        assert win.any().item() == (a == i)
        if a == i:
            assert torch.equal(win[0], torch.from_numpy(staged.win_init[i]))


def corrupt_third_slab():
    """A 7-lane archive with one byte flipped in the lane that sorts third
    (slab 2 in slabs of one lane): ``(archive, that lane's index)``."""
    xz = bytearray(lzma_rs_tpu.xz_compress(DATA, block_size=1024,
                                           check_method=1))
    lanes = runtime.stage_plans(bytes(xz), runtime.plan_xz(bytes(xz))[0]
                                ).lanes
    lane = lanes[2]
    xz[(lane.in_start[0] + lane.in_end[0]) // 2] ^= 0x5A
    return bytes(xz), 2


def test_a_corrupt_lane_on_the_third_slab_gives_the_reference_error(
        monkeypatch):
    xz, lane = corrupt_third_slab()
    set_slabs(monkeypatch, 1, 3)
    with jax_stats.collect() as j:
        with pytest.raises(Exception) as want:
            jax_runtime.xz_decode(xz, engine="tpu-vmem")
    assert j.engine == "tpu-vmem" and j.devices == 3
    with stats.collect() as s:
        with pytest.raises(Exception) as got:
            runtime.xz_decode(xz, engine="cuda", device=CPU)
    assert (type(got.value).__name__, str(got.value)) == (
        type(want.value).__name__, str(want.value))
    assert s.fallbacks == j.fallbacks
    assert s.fallbacks[0].startswith("host replay: lane error code")
    assert s.devices == 3
    # the kernel error names the lane by its place in the whole sorted list
    with pytest.raises(runtime._KernelError) as err:
        runtime.execute_plan_device(xz, runtime.plan_xz(xz)[0], CPU)
    assert err.value.lane == lane
    assert s.fallbacks[0] == f"host replay: lane error code {err.value.code}"


def cards(monkeypatch, n, current=0):
    """Make torch report ``n`` cards, ``current`` the current one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)


def test_without_the_lane_variable_each_device_takes_one_slab(
        slabs, monkeypatch):
    """The default: one slab a device, so one launch of every lane on one
    device, and ``ceil(lanes / n)`` lanes a slab over ``n``."""
    xz = lzma_rs_tpu_torch.xz_compress(DATA, block_size=1024, check_method=1)
    monkeypatch.delenv("LZMA_RS_TPU_VMEM_L", raising=False)
    for cap, sizes in ((None, [7]), ("4", [2, 2, 2, 1]), ("9", [1] * 7)):
        if cap is None:
            monkeypatch.delenv("LZMA_RS_TPU_DEVICES", raising=False)
        else:
            monkeypatch.setenv("LZMA_RS_TPU_DEVICES", cap)
        slabs.clear()
        with stats.collect() as s:
            assert runtime.xz_decode(xz, engine="cuda", device=CPU) == DATA
        assert slabs == sizes and s.devices == len(sizes)
    monkeypatch.delenv("LZMA_RS_TPU_DEVICES", raising=False)
    for have, per_slab in ((1, 7), (2, 4), (4, 2), (8, 1)):
        cards(monkeypatch, have)
        n = runtime._n_local_devices("cuda")
        assert n == have and runtime.slab_lanes(7, n) == per_slab


def test_the_device_count(monkeypatch):
    """Cards from the caller's on, capped by ``LZMA_RS_TPU_DEVICES``; under
    a CPU device the variable alone (default 1)."""
    monkeypatch.delenv("LZMA_RS_TPU_DEVICES", raising=False)
    assert runtime._n_local_devices(CPU) == 1
    cards(monkeypatch, 4)
    assert runtime._n_local_devices() == 4
    assert runtime._n_local_devices("cuda:0") == 4
    assert runtime._n_local_devices("cuda:1") == 3
    assert runtime._n_local_devices("cuda:3") == 1
    cards(monkeypatch, 4, current=2)
    assert runtime._n_local_devices("cuda") == 2
    cards(monkeypatch, 4)
    monkeypatch.setenv("LZMA_RS_TPU_DEVICES", "2")
    assert runtime._n_local_devices() == 2
    assert runtime._n_local_devices(CPU) == 2
    monkeypatch.setenv("LZMA_RS_TPU_DEVICES", "9")
    assert runtime._n_local_devices() == 4
    assert runtime._n_local_devices(CPU) == 9
    monkeypatch.setenv("LZMA_RS_TPU_DEVICES", "0")
    assert runtime._n_local_devices() == runtime._n_local_devices(CPU) == 1


def test_slab_launches_follow_the_reference_loop():
    """Launches of ``L * n_dev`` lanes, slab ``j`` to device ``j``
    (``lzma_rs_tpu/parallel/runtime.py:926-931``)."""
    assert runtime.slab_launches(7, 1, 3) == [
        [(0, 1), (1, 2), (2, 3)], [(3, 4), (4, 5), (5, 6)], [(6, 7)]]
    assert runtime.slab_launches(7, 3, 3) == [[(0, 3), (3, 6), (6, 7)]]
    assert runtime.slab_launches(37, 2, 8)[-1] == [
        (32, 34), (34, 36), (36, 37)]
    assert len(runtime.slab_launches(37, 2, 8)) == 3  # the dry run's count
    assert runtime.slab_launches(21, 1, 8)[-1] == [
        (16, 17), (17, 18), (18, 19), (19, 20), (20, 21)]
    assert runtime.slab_launches(5, 5, 1) == [[(0, 5)]]


def test_mesh_devices():
    assert mesh.devices(3, "cpu") == [CPU] * 3
    assert mesh.devices(1, CPU) == [CPU]
    with pytest.raises(ValueError):
        mesh.devices(0, "cpu")
    with pytest.raises(ValueError):
        mesh.devices(1, "meta")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA devices"):
        mesh.devices(have + 1, "cuda")


def test_mesh_devices_start_at_the_callers_card(monkeypatch):
    cards(monkeypatch, 4)
    assert mesh.devices(2, "cuda") == [torch.device("cuda", 0),
                                       torch.device("cuda", 1)]
    assert mesh.devices(2, "cuda:2") == [torch.device("cuda", 2),
                                         torch.device("cuda", 3)]
    with pytest.raises(RuntimeError, match="from cuda:3"):
        mesh.devices(2, "cuda:3")
    cards(monkeypatch, 4, current=1)
    assert mesh.devices(3, "cuda") == [torch.device("cuda", i)
                                       for i in (1, 2, 3)]


def test_slabs_go_to_the_callers_card_and_on(monkeypatch):
    """``device="cuda:1"`` on a host of three cards: two slabs, on cuda:1
    and cuda:2 (their tensors are made on the CPU: no card here)."""
    cards(monkeypatch, 3)
    monkeypatch.delenv("LZMA_RS_TPU_VMEM_L", raising=False)
    monkeypatch.delenv("LZMA_RS_TPU_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: None)
    xz = lzma_rs_tpu_torch.xz_compress(DATA, block_size=1024, check_method=1)
    plans = runtime.plan_xz(xz)[0]
    staged = runtime.stage_plans(xz, plans)
    on = []

    def tensors(self, device, a=0, b=None):
        on.append((torch.device(device), a, b))
        return real_tensors(self, CPU, a, b)

    real_tensors = runtime.StagedLanes.tensors
    monkeypatch.setattr(runtime.StagedLanes, "tensors", tensors)
    with stats.collect() as s:
        runtime.execute_plan_device(xz, plans, torch.device("cuda", 1))
    assert on == [(torch.device("cuda", 1), 0, 4),
                  (torch.device("cuda", 2), 4, 7)]
    assert s.devices == 2 and len(staged.lanes) == 7


@pytest.mark.cuda
def test_slabs_on_the_card(monkeypatch):
    """Three slabs on one card (every launch dispatched
    before a result is read): the same bytes, one kernel launch a slab."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xz = lzma_rs_tpu_torch.xz_compress(DATA, block_size=1024, check_method=1)
    set_slabs(monkeypatch, 3, 1)
    before = sd.decode_segments.launches
    with stats.collect() as s:
        assert runtime.xz_decode(xz, engine="cuda") == DATA
    assert s.devices == 1 and s.engine == "cuda"
    assert sd.decode_segments.launches == before + 3  # 3, 3 and 1 lanes
