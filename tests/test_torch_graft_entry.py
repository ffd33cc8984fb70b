"""The port's entry points: ``entry()`` and the dry run over devices.

- ``_example_lane_args`` stages real LZMA chunks (the port's native
  library's, or the range encoder's literal-only one without it) that
  decode to the payload in every lane; ``entry()`` runs on the card unless
  asked for the CPU.
- ``dryrun_multichip``'s three shape classes (flagship-shaped,
  stock-shaped, corrupt) through the production runtime over three CPU
  slabs a launch, at reduced sizes (8 KiB in 1 KiB blocks: the plain
  version advances every lane one micro-op per step, and the reference's
  74 and 42 KiB would take minutes here; the card runs those): the bytes,
  engine, no fallbacks and ``stats.devices``, and for the corrupt class the
  native engine's exception from a lane on a slab other than the first.
"""

import os

import pytest
import torch

from lzma_rs_tpu_torch import graft_entry as g
from lzma_rs_tpu_torch.native import loader as native_loader
from lzma_rs_tpu_torch.ops import segment_decoder as sd

CPU = torch.device("cpu")
# the three classes at reduced sizes
SMALL = tuple(g.ShapeClass(c.label, 8, 1, c.lanes_per_device,
                           c.tpu_profile, c.corrupt)
              for c in g.SHAPE_CLASSES)


def lanes_decode_to(args, cfg, payload):
    win, err, outp, _ = sd.decode_segments(*args, config=cfg)
    assert err.eq(0).all() and outp.eq(len(payload)).all()
    return all(bytes(w[:len(payload)].tolist()) == payload for w in win)


@pytest.mark.parametrize("K", (1, 3))
def test_the_example_arguments_decode_to_the_payload(K):
    args, cfg, payload = g._example_lane_args(5, K=K)
    assert cfg.L == 5 and cfg.K == K and args[2].shape == (5, K)
    assert payload and g.PAYLOAD.startswith(payload)
    assert lanes_decode_to(args, cfg, payload)


def test_without_the_native_library_a_literal_only_chunk(monkeypatch):
    monkeypatch.setattr(native_loader, "load", lambda: None)
    chunk, lc, lp, pb, payload = g._lane_chunk()
    assert (lc, lp, pb) == (0, 0, 0) and payload == g.PAYLOAD
    args, cfg, payload = g._example_lane_args(2)
    assert lanes_decode_to(args, cfg, payload)


def test_entry_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        g.entry()
    fn, args = g.entry(CPU)
    win = fn(*args)
    assert win.shape == (8, fn.config.W) and win.dtype == torch.uint8
    assert torch.equal(win, fn.reference(*args))
    n = len(g.PAYLOAD) if native_loader.load() is None else int(args[5][0, 0])
    assert all(bytes(w[:n].tolist()) == g.PAYLOAD[:n] for w in win)


def test_the_corpus_is_the_ports_own_sources():
    data = g._dryrun_corpus(4096)
    first = os.path.join(os.path.dirname(g.__file__), "__init__.py")
    with open(first, "rb") as f:
        assert data == f.read()[:4096]
    assert len(g._dryrun_corpus(10**6)) == 10**6


@pytest.mark.parametrize("cls", SMALL, ids=[c.label for c in SMALL])
def test_dryrun_class_on_cpu_slabs(cls, monkeypatch):
    monkeypatch.setenv("LZMA_RS_TPU_DEVICES", "7")  # put back afterwards
    monkeypatch.delenv("LZMA_RS_TPU_VMEM_L", raising=False)
    line = g._dryrun_one(3, cls, CPU)
    assert os.environ["LZMA_RS_TPU_DEVICES"] == "7"
    assert "LZMA_RS_TPU_VMEM_L" not in os.environ
    slabs = 8 // cls.lanes_per_device
    assert line.startswith(
        f"{cls.label}: 8 blocks, 8 segments, {-(-slabs // 3)} launches x "
        f"{cls.lanes_per_device} lanes/device ({slabs} slabs)")
    if cls.corrupt:  # the last lane, on the last slab
        assert f"lane 7 (slab {slabs - 1}) broken: LzmaError" in line
        assert "host replay: lane error code" in line
    else:
        assert "8192 bytes bit-exact" in line


def test_dryrun_multichip_prints_one_line(capsys, monkeypatch):
    monkeypatch.setattr(g, "SHAPE_CLASSES", SMALL[:1])
    lines = g.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert out == [f"dryrun_multichip OK: 2 cpu device(s); {lines[0]}; "
                   "engine cpu on all, CRC32 checks verified"]


def test_dryrun_on_the_card_needs_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError,
                       match="need 2 CUDA devices from cuda:0, have 0"):
        g.dryrun_multichip(2)


def test_the_classes_are_the_references():
    """74 KiB of 2 KiB tpu_profile blocks at 2 lanes a device, 42 KiB of
    2 KiB stock blocks at 1 (``__graft_entry__.py:173-192``), and the
    flagship shape again, corrupt."""
    flag, stock, bad = g.SHAPE_CLASSES
    assert (flag.kib, flag.block_kib, flag.lanes_per_device,
            flag.tpu_profile) == (74, 2, 2, True)
    assert (stock.kib, stock.block_kib, stock.lanes_per_device,
            stock.tpu_profile) == (42, 2, 1, False)
    assert bad == g.ShapeClass(bad.label, 74, 2, 2, True, corrupt=True)


@pytest.mark.cuda
def test_entry_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fn, args = g.entry()
    before = sd.decode_segments.launches
    win = fn(*args)
    torch.cuda.synchronize()
    assert sd.decode_segments.launches == before + 1
    assert torch.equal(win.cpu(), fn.reference(*args).cpu())
