"""Probe kernels: three per-lane integer chains, asked on the card.

The port of the Pallas probes in ``tools/probe_lane2d.py`` and
``tools/probe_state_in_ref.py`` (seven functions, three per-lane
functions on a thread-per-lane card):

- :func:`tinyops_chain` (``tinyops_only_1d``, ``tinyops_only_2d``): a
  dependent chain of 150 integer ops per iteration, no memory;
- :func:`bitdecode_chain` (``bitdecode_1d``, ``bitdecode_2d``, ``y1``,
  ``y2``): a range-coder-shaped bit decode per iteration, reading and
  adapting one row of a per-lane probability table;
- :func:`realweight_step` (``y4``): tiny ops, the bit decode and reads and a
  masked write of a per-lane ring window: the decoder's step in miniature.

Each wrapper launches its hand-written kernel (``csrc/probes.cu``) on a
CUDA tensor, or raises; on a CPU tensor it runs its plain PyTorch version
(``*_reference``: every lane in lockstep). ``<wrapper>.launches`` counts
kernel launches. ``<wrapper>.reference`` is the plain version.

Layouts are the JAX probes': a table is ``[ROWS, *lanes]`` (``[ROWS, L]``
or ``[ROWS, S, 128]``), a ring ``[RING, *lanes]``, and the output has the
lanes' shape. ``full=True`` also returns the final table, ring and state,
and the bit decode's ``init`` and realweight's ``init`` / ``ring`` can be
per-lane tensors (test instrumentation: from the y-series' zero state
every bit is 1 and the output is the same in every lane, so only a
seeded start and the final state tell a wrong port from a right one).

Integer semantics are wrapping int32 and uint32. The plain versions keep
``rng`` and ``cod`` as uint32 values in int64 (the product and compare of
the bit decode) and the rest in int32, whose add, subtract and shift wrap
in PyTorch.
"""

from __future__ import annotations

import ctypes
import math

import torch

__all__ = [
    "ITERS", "ROWS", "RING", "NST", "BITDECODE_INIT", "Y_INIT",
    "PLACEMENTS", "STATES", "WRAPPERS", "BITDECODE_MAX_LANES",
    "tinyops_chain", "tinyops_reference",
    "bitdecode_chain", "bitdecode_reference",
    "realweight_step", "realweight_reference",
    "TINYOPS_OPS", "BITDECODE_OPS", "realweight_ops",
    "realweight_attributes", "bitdecode_attributes",
]

ITERS = 256       # the probes' ITERS
ROWS = 648        # table rows (PROB_WORDS at NLIT=1)
RING = 512        # y4's ring window rows
NST = 8           # y1's state slots
# bitdecode_chain's kernel addresses its table in 32-bit offsets: fewer
# than 2^31 words, the same bound as every wrapper's _check on a tensor
BITDECODE_MAX_LANES = (2**31 - 1) // ROWS  # 3,314,017
TINY_ROUNDS = 50  # tiny-op rounds per tinyops iteration (3 ops each)
BITDECODE_INIT = (0, 1, -1, 12345)  # idx, acc, rng, cod of bitdecode_*
Y_INIT = (0, 0, 0, 0)               # the y-series' (state refs zeroed)
PLACEMENTS = ("minor", "major", "shared")  # csrc/probes.cu's table places
STATES = ("registers", "slots", "arrays")  # registers; y1's; y2's
BLOCK = 64        # threads (lanes) a block of the kernels (csrc/probes.cu)

# Integer operations per lane and iteration, counted from the code (for
# the bound): the probes' own count for tinyops (3 per round); for the bit
# decode, 10 x (compare, add) for idx, 2 for the clip, then p & 0x7FF,
# rng >> 11, the product, the compare, p >> 5, the subtract, the add, the
# select, rng - bound, rng | 1, the select, cod ^ bit, acc << 1, | bit, the
# compare, the select, and the address of the row: 39.
TINYOPS_OPS = 3 * TINY_ROUNDS
BITDECODE_OPS = 39
_U32 = 0xFFFFFFFF


def realweight_ops(rounds: int) -> int:
    """y4's count: 3 per tiny-op round; idx's and, add and clip (3); the
    bit decode without idx's climb (39 - 22 = 17); the ring's four row
    addresses, three masks, the merge's and, two ors (10)."""
    return 3 * rounds + 3 + (BITDECODE_OPS - 22) + 10


# -- plain versions ------------------------------------------------------


def _to_i32(u):
    """uint32 values held in int64 -> int32 (two's complement)."""
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


def _tiny_rounds(a, b, d, rounds: int):
    for k in range(rounds):
        a = torch.where(b > (k & 7), a + 1, a - d)
        b = (b ^ a) & 0xFFFF
        d = torch.where(a > b, d | 1, d << 1)
    return a, b, d


def _decode_bit(tab, idx, rng, cod, write: bool = True):
    """The bit decode at row ``idx`` of every lane's column of ``tab``
    (updated in place, unless ``write`` is false). Returns (bit, rng,
    cod)."""
    rows = idx.long()[None]
    p = tab.gather(0, rows)[0]
    bound = (rng >> 11) * (p & 0x7FF).long()
    bit = cod >= bound
    if write:
        tab.scatter_(0, rows, torch.where(bit, p - (p >> 5), p + 3)[None])
    rng = torch.where(bit, (rng - bound) & _U32, rng | 1)
    return bit, rng, cod ^ bit.long()


def _shift_in(acc, bit):
    acc = (acc << 1) | bit.int()
    return torch.where(acc > 0x100, 1, acc)


def _lanes(t, lead: int):
    """``t`` ([lead rows, *lanes]) as a contiguous int32 [rows, L] copy."""
    return t.reshape(lead, -1).to(torch.int32).clone(
        memory_format=torch.contiguous_format)


def _start(v, lanes, device):
    """A state word's start, an int or an int32 tensor of the lanes'
    shape, as a fresh int32 [L] tensor on ``device``. An int is filled on
    the device: a copy from the host would wait for the stream and put
    host time into a timed call."""
    if torch.is_tensor(v):
        return _lanes(v.to(device)[None], 1)[0]
    return torch.full((math.prod(lanes),), v, dtype=torch.int32,
                      device=device)


def _real_start(init, ring, lanes, device):
    """realweight's [7, L] state and [RING, L] ring: zeros (y4's), or
    copies of ``init`` ([7, *lanes]) and ``ring`` ([RING, *lanes])."""
    L = math.prod(lanes)
    zeros = (lambda n: torch.zeros((n, L), dtype=torch.int32,
                                   device=device))
    return (zeros(7) if init is None else _lanes(init, 7).to(device),
            zeros(RING) if ring is None else _lanes(ring, RING).to(device))


def tinyops_reference(x, *, iters: int = ITERS, full: bool = False):
    """Plain version of :func:`tinyops_chain`."""
    a = x.reshape(-1).to(torch.int32)
    a, b, d = a, a + 1, a + 2
    for _ in range(iters):
        a, b, d = _tiny_rounds(a, b, d, TINY_ROUNDS)
    out = a.reshape(x.shape)
    if not full:
        return out
    return out, {"state": torch.stack([a, b, d]).reshape(3, *x.shape)}


def bitdecode_reference(table, *, init=BITDECODE_INIT, iters: int = ITERS,
                        full: bool = False):
    """Plain version of :func:`bitdecode_chain` (every placement)."""
    lanes = table.shape[1:]
    tab = _lanes(table, ROWS)
    idx, acc, rng, cod = (_start(v, lanes, tab.device) for v in init)
    rng, cod = rng.long() & _U32, cod.long() & _U32
    for _ in range(iters):
        # idx += #{k < 10 : acc > k}, then the clip
        idx = (idx + acc.clamp(0, 10)).clamp(0, ROWS - 1)
        bit, rng, cod = _decode_bit(tab, idx, rng, cod)
        acc = _shift_in(acc, bit)
    out = acc.reshape(lanes)
    if not full:
        return out
    state = torch.stack([idx, acc, _to_i32(rng), _to_i32(cod)])
    return out, {"table": tab.reshape(table.shape),
                 "state": state.reshape(4, *lanes)}


def realweight_reference(table, *, rounds: int, iters: int = ITERS,
                         init=None, ring=None, full: bool = False):
    """Plain version of :func:`realweight_step`."""
    lanes = table.shape[1:]
    tab = _lanes(table, ROWS)
    state, ring = _real_start(init, ring, lanes, tab.device)
    idx, acc, rng, cod, a, b, d = state
    rng, cod = rng.long() & _U32, cod.long() & _U32
    for _ in range(iters):
        a, b, d = _tiny_rounds(a, b, d, rounds)
        idx = (idx + (a & 1)).clamp(0, ROWS - 1)
        bit, rng, cod = _decode_bit(tab, idx, rng, cod)
        pw = (a & (RING - 1)).long()[None]
        q = (b & (RING - 1)).long()[None]
        # w1 = ring[(pw + 1) & 511] enters the merge masked to 0: left out
        w0, old = ring.gather(0, pw)[0], ring.gather(0, q)[0]
        new = (old & ~0xFF) | (w0 & 0xFF)
        ring.scatter_(0, q, torch.where(bit, new, old)[None])
        acc = _shift_in(acc, bit)
    out = acc.reshape(lanes)
    if not full:
        return out
    state = torch.stack([idx, acc, _to_i32(rng), _to_i32(cod), a, b, d])
    return out, {"table": tab.reshape(table.shape),
                 "ring": ring.reshape(RING, *lanes),
                 "state": state.reshape(7, *lanes)}


# -- kernel launches -----------------------------------------------------


def _check(name, t, rows=None):
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: want int32, got {t.dtype}")
    if rows is not None and (t.dim() < 2 or t.shape[0] != rows):
        raise ValueError(f"{name}: want [{rows}, *lanes], got "
                         f"{tuple(t.shape)}")
    if t.numel() >= 2**31:
        raise ValueError(f"{name}: {t.numel()} elements is too many")


def _check_start(name, t, rows, lanes):
    """A per-lane start ([rows, *lanes] int32), or None."""
    if t is not None:
        _check(name, t, rows)
        if tuple(t.shape[1:]) != tuple(lanes):
            raise ValueError(f"{name}: want [{rows}, *{tuple(lanes)}], got "
                             f"{tuple(t.shape)}")


def _check_iters(iters: int, *more):
    if not all(0 <= v < 2**31 for v in (iters, *more)):
        raise ValueError(f"counts {(iters, *more)} outside [0, 2^31)")


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.lzp_error_string(rc).decode())


def _stream(t):
    if t.device.type != "cuda":
        return None
    return torch.cuda.current_stream(t.device).cuda_stream


def _cuda_lib(t, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    from lzma_rs_tpu_torch.ops import build

    return build.load_probes()


def launch_tinyops(lib, x, *, iters: int = ITERS, full: bool = False):
    """Run ``lib``'s ``lzp_tinyops`` on ``x``'s device: the nvcc build on a
    CUDA tensor, the host build of ``probe_lane.cuh`` on a CPU one."""
    xs = x.reshape(-1).contiguous()
    L = xs.numel()
    state = torch.empty((3, L), dtype=torch.int32, device=x.device)
    _raise_on(lib, lib.lzp_tinyops(xs.data_ptr(), state.data_ptr(), L, iters,
                                   _stream(x)), "tinyops_chain")
    out = state[0].reshape(x.shape)
    return (out, {"state": state.reshape(3, *x.shape)}) if full else out


def launch_bitdecode(lib, table, *, init=BITDECODE_INIT, iters: int = ITERS,
                     placement: str = "minor", state: str = "registers",
                     full: bool = False):
    """Run ``lib``'s ``lzp_bitdecode`` (see :func:`launch_tinyops`)."""
    lanes = table.shape[1:]
    L = math.prod(lanes)
    tab = table.reshape(ROWS, L)
    tab = tab.t().contiguous() if placement == "major" else tab.clone()
    dev = table.device
    if state == "arrays":  # y2: four separate [L] arrays
        words = [_start(v, lanes, dev) for v in init]
    else:  # registers: [4, L] read and written once; slots: y1's [NST, L]
        st = torch.zeros((4 if state == "registers" else NST, L),
                         dtype=torch.int32, device=dev)
        words = [w.copy_(v.reshape(-1)) if torch.is_tensor(v) else w.fill_(v)
                 for w, v in zip(st, init)]
    rc = lib.lzp_bitdecode(PLACEMENTS.index(placement),
                           int(state != "registers"), tab.data_ptr(),
                           *(w.data_ptr() for w in words), L, iters,
                           _stream(table))
    _raise_on(lib, rc, "bitdecode_chain")
    out = words[1].reshape(lanes)
    if not full:
        return out
    if placement == "major":
        tab = tab.t()
    return out, {"table": tab.reshape(table.shape),
                 "state": torch.stack(words).reshape(4, *lanes)}


def launch_realweight(lib, table, *, rounds: int, iters: int = ITERS,
                      init=None, ring=None, full: bool = False):
    """Run ``lib``'s ``lzp_realweight`` (see :func:`launch_tinyops`)."""
    lanes = table.shape[1:]
    L = math.prod(lanes)
    tab = _lanes(table, ROWS)
    state, ring = _real_start(init, ring, lanes, table.device)
    rc = lib.lzp_realweight(tab.data_ptr(), ring.data_ptr(),
                            state.data_ptr(), L, iters, rounds,
                            _stream(table))
    _raise_on(lib, rc, "realweight_step")
    out = state[1].reshape(lanes)
    if not full:
        return out
    return out, {"table": tab.reshape(table.shape),
                 "ring": ring.reshape(RING, *lanes),
                 "state": state.reshape(7, *lanes)}


def realweight_attributes() -> dict:
    """The card build's attributes of :func:`realweight_step`'s kernel:
    ``registers`` and ``local_bytes`` a thread (spills), ``static_shared``
    and ``max_dynamic_shared`` bytes (``cudaFuncGetAttributes``). Needs the
    card."""
    return _attributes(lambda lib, out: lib.lzp_realweight_attributes(out),
                       "realweight_attributes")


def bitdecode_attributes(placement: str, state: str) -> dict:
    """The card build's attributes of :func:`bitdecode_chain`'s kernel for
    ``placement`` and ``state``, as :func:`realweight_attributes` gives
    y4's. Needs the card."""
    if placement not in PLACEMENTS or state not in STATES:
        raise ValueError(f"placement {placement!r} or state {state!r}")
    return _attributes(
        lambda lib, out: lib.lzp_bitdecode_attributes(
            PLACEMENTS.index(placement), int(state != "registers"), out),
        "bitdecode_attributes")


def _attributes(query, what: str) -> dict:
    from lzma_rs_tpu_torch.ops import build

    lib = build.load_probes()
    out = (ctypes.c_int * 4)()
    _raise_on(lib, query(lib, out), what)
    return dict(zip(("registers", "local_bytes", "static_shared",
                     "max_dynamic_shared"), out))


# -- wrappers ------------------------------------------------------------


def tinyops_chain(x, *, iters: int = ITERS, full: bool = False):
    """``a`` after ``iters`` iterations of 50 tiny-op rounds from
    ``a, b, d = x, x + 1, x + 2``, one lane per element of ``x`` (int32,
    any shape); the output has ``x``'s shape. With ``full``, also
    ``{"state": [3, *shape]}`` (a, b, d)."""
    _check("x", x)
    _check_iters(iters)
    if x.device.type == "cpu":
        return tinyops_reference(x, iters=iters, full=full)
    res = launch_tinyops(_cuda_lib(x, "tinyops_chain"), x, iters=iters,
                         full=full)
    tinyops_chain.launches += 1
    return res


def bitdecode_chain(table, *, init=BITDECODE_INIT, iters: int = ITERS,
                    placement: str = "minor", state: str = "registers",
                    full: bool = False):
    """The final ``acc`` of ``iters`` bit-decode iterations from the state
    ``init`` (idx, acc, rng, cod: ints, or int32 tensors of the lanes'
    shape) over ``table`` ([ROWS, *lanes] int32, not changed; at most
    :data:`BITDECODE_MAX_LANES` lanes, on the CPU as on the card); the
    output has the lanes' shape. ``placement`` puts the kernel's table in
    device memory lane-minor (the TPU layout), lane-major (the decoder's)
    or in shared memory; ``state`` keeps the kernel's state in registers, in
    memory slots of one [NST, L] array (y1) or in four [L] arrays (y2).
    The function is the same for all of them. With ``full``, also
    ``{"table": final, "state": [4, *lanes]}``."""
    _check("table", table, ROWS)
    _check_iters(iters)
    if len(init) != 4 or any(
            torch.is_tensor(v) and (v.dtype != torch.int32 or
                                    v.shape != table.shape[1:])
            for v in init):
        raise ValueError("init: want four ints or int32 tensors of shape "
                         f"{tuple(table.shape[1:])}")
    if placement not in PLACEMENTS or state not in STATES:
        raise ValueError(f"placement {placement!r} not in {PLACEMENTS} or "
                         f"state {state!r} not in {STATES}")
    if table.device.type == "cpu":
        return bitdecode_reference(table, init=init, iters=iters, full=full)
    res = launch_bitdecode(_cuda_lib(table, "bitdecode_chain"), table,
                           init=init, iters=iters, placement=placement,
                           state=state, full=full)
    bitdecode_chain.launches += 1
    return res


def realweight_step(table, *, rounds: int, iters: int = ITERS,
                    init=None, ring=None, full: bool = False):
    """y4's ``acc`` after ``iters`` iterations of ``rounds`` tiny-op rounds
    (y4's ``nops // 3``), the bit decode over ``table`` ([ROWS, *lanes]
    int32, not changed) and the ring window, from y4's zero state and ring,
    or from ``init`` ([7, *lanes]: idx, acc, rng, cod, a, b, d) and
    ``ring`` ([RING, *lanes]), neither changed. With ``full``, also
    ``{"table", "ring", "state": [7, *lanes]}``."""
    _check("table", table, ROWS)
    _check_start("init", init, 7, table.shape[1:])
    _check_start("ring", ring, RING, table.shape[1:])
    _check_iters(iters, rounds)
    if table.device.type == "cpu":
        return realweight_reference(table, rounds=rounds, iters=iters,
                                    init=init, ring=ring, full=full)
    res = launch_realweight(_cuda_lib(table, "realweight_step"), table,
                            rounds=rounds, iters=iters, init=init,
                            ring=ring, full=full)
    realweight_step.launches += 1
    return res


for _w, _ref in ((tinyops_chain, tinyops_reference),
                 (bitdecode_chain, bitdecode_reference),
                 (realweight_step, realweight_reference)):
    _w.launches = 0
    _w.reference = _ref
WRAPPERS = (tinyops_chain, bitdecode_chain, realweight_step)
