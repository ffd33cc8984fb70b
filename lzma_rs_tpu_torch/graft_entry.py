"""Entry points of the port: one decode step, and the dry run over devices.

The port's counterpart of the repository's root ``__graft_entry__.py``:

- :func:`entry` returns ``(fn, args)``: ``fn`` is ``decode_segments`` on
  the card (the port's main kernel) and returns the decoded window,
  ``args`` its inputs for 8 lanes of a real LZMA2 chunk
  (:func:`_example_lane_args`). The reference's ``entry`` returns the XLA
  lane kernel, which the port leaves out.
- :func:`dryrun_multichip` decodes real multi-block `.xz` archives
  through the production runtime (``runtime.xz_decode(engine="cuda")``)
  with its lanes cut into slabs, one slab a device, over ``n`` devices:
  the first ``n`` cards, or ``n`` CPU slabs through the kernel's plain
  version under ``device="cpu"``. Three shape classes: flagship-shaped
  (tpu_profile), stock-shaped (lc=3) and a corrupt flagship-shaped archive
  whose broken block lands on a slab other than the first.

Run the dry run on the card, or on the CPU::

    python -m lzma_rs_tpu_torch.graft_entry [n] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

import lzma_rs_tpu_torch
from lzma_rs_tpu_torch.formats import lzma2 as lzma2_fmt
from lzma_rs_tpu_torch.native import loader as native_loader
from lzma_rs_tpu_torch.ops import segment_decoder as sd
from lzma_rs_tpu_torch.ops.lzma_consts import SegmentConfig, pack_chunk_meta
from lzma_rs_tpu_torch.parallel import mesh, runtime
from lzma_rs_tpu_torch.utils import stats as stats_mod
from lzma_rs_tpu_torch.utils.cursor import ByteCursor
from lzma_rs_tpu_torch.utils.errors import LzmaError, XzError

PAYLOAD = b"tpu-native lzma: shard me! " * 4  # matches and literals
_HERE = os.path.dirname(os.path.abspath(__file__))


def _lane_chunk() -> tuple:
    """``(chunk, lc, lp, pb, payload)``: the first LZMA chunk of
    :data:`PAYLOAD` compressed by the port's native library, with its props
    and the bytes it decodes to; without the library, a literal-only chunk
    from the port's range encoder (lc = lp = pb = 0), as the reference
    does."""
    lib = native_loader.load()
    if lib is not None:
        stream = lib.lzma2_compress(PAYLOAD, 6)
        c = lzma2_fmt.scan(ByteCursor(stream)).chunks[0]
        if c.kind == lzma2_fmt.KIND_LZMA:
            return (stream[c.data_off:c.data_off + c.packed_size],
                    c.props.lc, c.props.lp, c.props.pb,
                    PAYLOAD[:c.unpacked_size])
    from lzma_rs_tpu_torch.encode.rangecoder import RangeEncoder, fresh_probs

    enc = RangeEncoder()
    lit, is_match = fresh_probs(0x300), fresh_probs(16)
    for byte in PAYLOAD:
        enc.encode_bit(is_match, 0, False)
        res = 1
        for k in range(8):
            bit = (byte >> (7 - k)) & 1
            enc.encode_bit(lit, res, bool(bit))
            res = (res << 1) ^ bit
    return enc.finish(), 0, 0, 0, PAYLOAD


def _example_lane_args(L: int, K: int = 1, device="cpu") -> tuple:
    """``(args, config, payload)``: the seven ``decode_segments`` inputs on
    ``device`` for ``L`` lanes, each decoding the same real LZMA chunk
    (:func:`_lane_chunk`) in chunk slot 0 of ``K``, the window bucket's
    smallest sizes, and the bytes every lane decodes to."""
    chunk, lc, lp, pb, payload = _lane_chunk()
    w_in = 2048
    while w_in < len(chunk):
        w_in *= 2
    cfg = SegmentConfig(L=L, W=2048, W_IN=w_in, NLIT=1 << min(lc + lp, 3),
                        K=K, NPS=4 if pb <= 2 else 16)
    inbuf = np.zeros((L, w_in), dtype=np.uint8)
    inbuf[:, :len(chunk)] = np.frombuffer(chunk, dtype=np.uint8)
    in_start, in_end, out_start, out_end, meta = np.zeros((5, L, K),
                                                          dtype=np.int32)
    in_end[:, 0] = len(chunk)
    out_end[:, 0] = len(payload)
    meta[:, 0] = pack_chunk_meta(1, lc, lp, pb, 1)
    arrays = (inbuf, np.zeros((L, cfg.W), dtype=np.uint8), in_start, in_end,
              out_start, out_end, meta)
    return (tuple(torch.from_numpy(a).to(device) for a in arrays), cfg,
            payload)


def entry(device=None) -> tuple:
    """``(fn, args)``: ``fn(*args)`` runs ``decode_segments`` on the card
    (``device``; by default the current CUDA device, and it raises without
    one) over 8 lanes and returns the window ``[8, W]`` u8, each lane's
    first ``len(payload)`` bytes the payload. ``fn.reference`` is the plain
    version on the same arguments, ``fn.config`` the bucket."""
    args, cfg, _ = _example_lane_args(8, device=runtime.cuda_device(device))

    def fn(*a):
        return sd.decode_segments(*a, config=cfg)[0]

    fn.reference = lambda *a: sd.decode_segments_reference(*a, config=cfg)[0]
    fn.config = cfg
    return fn, args


# -- the dry run -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeClass:
    """One archive of the dry run: ``kib`` KiB of corpus in ``block_kib``
    KiB `.xz` blocks (one segment each), ``lanes_per_device`` lanes a
    slab; tpu_profile (lc=0, distances capped) or stock (lc=3); corrupt:
    one byte flipped in the block that sorts last, which is on the last
    slab."""

    label: str
    kib: int
    block_kib: int
    lanes_per_device: int
    tpu_profile: bool
    corrupt: bool = False


# the reference's sizes (__graft_entry__.py:173-192): 37 and 21 segments
SHAPE_CLASSES = (
    ShapeClass("flagship-shaped", 74, 2, 2, True),
    ShapeClass("stock-shaped", 42, 2, 1, False),
    ShapeClass("corrupt flagship-shaped", 74, 2, 2, True, corrupt=True),
)


def _dryrun_corpus(n_bytes: int) -> bytes:
    """Deterministic text-like corpus: the port's own sources, in sorted
    path order, repeated to ``n_bytes``."""
    parts = []
    for root, dirs, files in sorted(os.walk(_HERE)):
        dirs[:] = sorted(d for d in dirs if d not in ("build", "__pycache__"))
        for f in sorted(files):
            if f.endswith(".py"):
                with open(os.path.join(root, f), "rb") as fh:
                    parts.append(fh.read())
    seed = b"\n".join(parts)
    return (seed * (n_bytes // len(seed) + 1))[:n_bytes]


def _corrupt(archive: bytes) -> tuple:
    """``(archive, lane)``: one byte flipped in the compressed data of the
    lane that sorts last (``stage_plans``' order, biggest first), at the
    first position from its middle where the native engine's error is the
    LZMA decoder's (so the lane itself reports it, rather than the block's
    check)."""
    lanes = runtime.stage_plans(archive, runtime.plan_xz(archive)[0]).lanes
    lane = lanes[-1]
    for pos in range((lane.in_start[0] + lane.in_end[0]) // 2,
                     lane.in_end[-1]):
        bad = bytearray(archive)
        bad[pos] ^= 0x5A
        try:
            runtime.xz_decode(bytes(bad), engine="native")
        except LzmaError:  # the lane breaks: this is the archive
            return bytes(bad), len(lanes) - 1
        except XzError:  # the block's check: try the next byte
            continue
    raise RuntimeError("no single-byte flip breaks the last lane")


def _dryrun_one(n_devices: int, cls: ShapeClass, device) -> str:
    """One decode of ``cls`` through the production runtime over
    ``n_devices`` devices; checks the bytes (the corrupt class: the native
    engine's exception class and message), engine, fallbacks and
    ``stats.devices``, and returns the summary line."""
    data = _dryrun_corpus(cls.kib * 1024)
    archive = lzma_rs_tpu_torch.xz_compress(
        data, tpu_profile=cls.tpu_profile, block_size=cls.block_kib * 1024,
        check_method=1, level=6)
    plans = runtime.plan_xz(archive)[0]
    n_segments = sum(len(p.lanes) for p in plans)
    per_slab = cls.lanes_per_device
    n_slabs = -(-n_segments // per_slab)
    n_launches = -(-n_segments // (per_slab * n_devices))
    broken = None
    if cls.corrupt:
        archive, broken = _corrupt(archive)

    saved = {k: os.environ.get(k)
             for k in ("LZMA_RS_TPU_VMEM_L", "LZMA_RS_TPU_DEVICES")}
    os.environ["LZMA_RS_TPU_VMEM_L"] = str(per_slab)
    os.environ["LZMA_RS_TPU_DEVICES"] = str(n_devices)
    before = sd.decode_segments.launches
    err = None
    try:
        with stats_mod.collect() as st:
            try:
                out = runtime.xz_decode(archive, engine="cuda", device=device)
            except Exception as e:  # the corrupt class: compared below
                if not cls.corrupt:
                    raise
                err = e
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launched = sd.decode_segments.launches - before

    where = f"{cls.label} over {n_devices} {device.type} device(s)"
    if st.engine != device.type:
        raise AssertionError(f"{where}: engine {st.engine!r}, fallbacks "
                             f"{st.fallbacks}")
    if st.devices != n_devices:
        raise AssertionError(f"{where}: used {st.devices} devices")
    if device.type == "cuda" and launched != n_slabs:
        raise AssertionError(f"{where}: {launched} kernel launches, want "
                             f"{n_slabs}")
    head = (f"{cls.label}: {len(plans)} blocks, {n_segments} segments, "
            f"{n_launches} launches x {per_slab} lanes/device "
            f"({n_slabs} slabs)")
    if not cls.corrupt:
        if out != data:
            raise AssertionError(f"{where}: decode is not bit-exact")
        if st.fallbacks:
            raise AssertionError(f"{where}: fallbacks {st.fallbacks}")
        return (f"{head}, {len(data)} bytes bit-exact (archive "
                f"{len(archive)} B)")
    try:
        runtime.xz_decode(archive, engine="native")
        want = None
    except Exception as e:  # the reference's error, compared below
        want = e
    if err is None or want is None or (type(err), str(err)) != (
            type(want), str(want)):
        raise AssertionError(f"{where}: raised {err!r}, the native engine "
                             f"{want!r}")
    if not any(f.startswith("host replay: lane error code")
               for f in st.fallbacks):
        raise AssertionError(f"{where}: no lane error replayed "
                             f"({st.fallbacks})")
    return (f"{head}, lane {broken} (slab {broken // per_slab}) broken: "
            f"{type(err).__name__} {str(err)!r} as the native engine; "
            f"fallbacks {st.fallbacks}")


def dryrun_multichip(n_devices: int, device=None) -> list:
    """Decode each of :data:`SHAPE_CLASSES` through the production
    runtime with its lanes in slabs over ``n_devices`` devices:
    ``n_devices`` cards from ``device``'s on (``device`` None or cuda;
    raises when fewer are present), or ``n_devices`` CPU slabs
    (``device="cpu"``, the kernel's plain version). Prints one line and
    returns the classes' summary lines."""
    device = torch.device("cuda" if device is None else device)
    mesh.devices(n_devices, device)  # raises when too few cards
    lines = [_dryrun_one(n_devices, c, device) for c in SHAPE_CLASSES]
    print(f"dryrun_multichip OK: {n_devices} {device.type} device(s); "
          + "; ".join(lines) + f"; engine {device.type} on all, CRC32 "
          "checks verified", flush=True)
    return lines


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(prog="lzma_rs_tpu_torch.graft_entry")
    ap.add_argument("n", nargs="?", type=int, default=1,
                    help="devices (cards, or CPU slabs)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args()
    dryrun_multichip(a.n, device=a.device)
