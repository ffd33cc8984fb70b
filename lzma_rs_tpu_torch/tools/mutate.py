"""Mutants for the differential tier: byte-level mutations of whole
streams, and mutated lanes for the decoder.

- :func:`mutate_once`, :func:`mutations`, :func:`splices`: bit and byte
  flips, truncations, insertions and deletions, stacked 1-4 deep, and
  cross-seed splices; a copy of the JAX package's
  ``tests/test_fuzz_mutation.py:39-72``.
- :func:`mutate_lanes`: copies of staged lanes (``runtime.stage_plans``)
  with their compressed input bytes, and sometimes a chunk's input end,
  mutated in place; :func:`host_decode` runs them through the g++ host
  build of the decoder (``ops/build.py::load_host``) and
  :func:`native_lane` one of them through the native engine's segment
  decoder, whose error/no-error verdict and clean bytes the kernel must
  match (lane error codes are not public).

``tests/test_torch_fuzz_mutation.py`` runs them on the CPU and
``chip_smoke.py`` phase 20 on the card. Nothing of the decode path uses
this module.
"""

from __future__ import annotations

import ctypes
import random

import numpy as np
import torch


def mutate_once(rng: random.Random, b: bytearray) -> None:
    """One mutation of ``b`` in place: a bit flip, a byte set, a
    truncation, an insertion or a deletion at a random position."""
    if not b:
        return
    kind = rng.randrange(5)
    pos = rng.randrange(len(b))
    if kind == 0:  # bit flip
        b[pos] ^= 1 << rng.randrange(8)
    elif kind == 1:  # byte set
        b[pos] = rng.randrange(256)
    elif kind == 2:  # truncate
        del b[pos:]
    elif kind == 3:  # insert
        b[pos:pos] = bytes([rng.randrange(256)])
    else:  # delete
        del b[pos]


def mutations(rng: random.Random, data: bytes, n: int, stacked: bool = False):
    """Yield n mutated variants of data (deterministic given rng).

    ``stacked`` applies 1-4 mutations per case (deeper tier): single
    mutations mostly probe header/CRC validation, stacks reach decode
    states that one flip cannot."""
    for _ in range(n):
        b = bytearray(data)
        for _ in range(rng.randrange(1, 5) if stacked else 1):
            mutate_once(rng, b)
        yield bytes(b)


def splices(rng: random.Random, seeds, n: int):
    """Cross-seed splices: prefix of one archive + suffix of another — the
    classic libFuzzer crossover, good at confusing framing/index logic."""
    for _ in range(n):
        a, b = rng.choice(seeds), rng.choice(seeds)
        if not a or not b:
            continue
        cut_a = rng.randrange(len(a))
        cut_b = rng.randrange(len(b))
        yield a[:cut_a] + b[cut_b:]


def mutate_lanes(rng: random.Random, staged, n: int, stacked: bool):
    """n mutated copies of lanes of ``staged`` (a ``StagedLanes``), drawn
    with replacement: 1-4 (``stacked``) or one byte of a lane's
    compressed input flipped or set, and in one lane of five a chunk's
    input end moved anywhere from its start to the input bucket's end.
    Returns ``(config, the seven decode_segments inputs as numpy arrays,
    each lane's segment length)``."""
    cfg = staged.slab_config(0, n)
    picks = [rng.randrange(len(staged.lanes)) for _ in range(n)]
    inbuf = staged.inbuf[picks].copy()
    win = (np.zeros((n, cfg.W), np.uint8) if staged.win_init is None
           else staged.win_init[picks].copy())
    tables = [t[picks].copy() for t in staged.tables]
    in_start, in_end = tables[0], tables[1]
    valid = (tables[4] >> 12) & 1
    for r in range(n):
        k = int(valid[r].sum())
        end = int(in_end[r, k - 1])
        for _ in range(rng.randrange(1, 5) if stacked else 1):
            pos = rng.randrange(end)
            if rng.randrange(2):
                inbuf[r, pos] ^= 1 << rng.randrange(8)
            else:
                inbuf[r, pos] = rng.randrange(256)
        if rng.randrange(5) == 0:
            j = rng.randrange(k)
            in_end[r, j] = rng.randrange(int(in_start[r, j]), cfg.W_IN + 1)
    return cfg, (inbuf, win, *tables), staged.seg_lens[picks]


def host_decode(cfg, arrays, max_steps: int | None = None):
    """The decoder's build (code 1) of the g++ host build on numpy inputs:
    ``(win, err, outp, steps)`` CPU tensors."""
    from lzma_rs_tpu_torch.ops import build
    from lzma_rs_tpu_torch.ops import segment_decoder as sd
    from lzma_rs_tpu_torch.ops.lzma_consts import prob_layout

    lib = build.load_host()
    inbuf, win_init, *tables = (torch.from_numpy(np.ascontiguousarray(a))
                                for a in arrays)
    nprobs = prob_layout(cfg.NLIT).total
    win = win_init.clone()
    probs = torch.empty((cfg.L, nprobs), dtype=torch.uint16)
    err, outp, steps = (torch.empty(cfg.L, dtype=torch.int32)
                        for _ in range(3))
    rc = lib.lzl_decode_segments_host(
        inbuf.data_ptr(), win.data_ptr(), probs.data_ptr(),
        *(t.data_ptr() for t in tables), err.data_ptr(), outp.data_ptr(),
        steps.data_ptr(), None, cfg.L, cfg.W_IN, cfg.W, nprobs, cfg.NLIT,
        cfg.K, max_steps or sd.default_max_steps(cfg), 1)
    if rc != 0:
        raise RuntimeError(f"the host build refused the batch ({rc})")
    return win, err, outp, steps


def native_lane(lib, arrays, r: int, seg_len: int):
    """Lane ``r`` of ``arrays`` through the native engine's segment
    decoder (``lib``: ``native.loader.load()``), its window prefilled as
    the kernel's: the decoded bytes, or None where the engine raises."""
    from lzma_rs_tpu_torch.utils.errors import LzmaRsError

    inbuf, win, in_start, in_end, out_start, out_end, meta = arrays
    chunks = []
    for j in range(in_start.shape[1]):
        m = int(meta[r, j])
        if not (m >> 12) & 1:
            break
        chunks.append((int(in_start[r, j]), int(in_end[r, j]),
                       int(out_start[r, j]), int(out_end[r, j]), m & 3,
                       min((m >> 2) & 15, 8), (m >> 6) & 7, (m >> 9) & 7))
    out = bytearray(win[r, :seg_len].tobytes())
    view = ctypes.addressof(ctypes.c_char.from_buffer(out))
    try:
        lib.lzma2_decode_segment(inbuf[r].tobytes(), chunks, view, seg_len)
    except LzmaRsError:
        return None
    return bytes(out)


def lane_verdicts(lib, got, arrays, seg_lens) -> list:
    """Where the decoder's outputs ``got`` (``(win, err, outp, steps)``)
    differ from the native engine lane by lane: a lane fails on one side
    only, or a clean lane's bytes or length differ. Returns the
    differences as text (empty when none)."""
    err, outp = got[1].cpu().numpy(), got[2].cpu().numpy()
    win = got[0].cpu().numpy()
    out = []
    for r, n in enumerate(int(x) for x in seg_lens):
        want = native_lane(lib, arrays, r, n)
        if (err[r] != 0) != (want is None):
            out.append(f"lane {r}: err {err[r]}, native "
                       f"{'fails' if want is None else 'decodes'}")
        elif want is not None and (outp[r] != n
                                   or win[r, :n].tobytes() != want):
            out.append(f"lane {r}: clean bytes differ from native")
    return out
