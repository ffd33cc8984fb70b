"""The port's segment decoder against the JAX package's gen-1 and gen-2
kernels.

The same lanes, staged in the JAX kernel's layout, go through
``decode_segments_vmem2(..., interpret=True)`` (gen-2) or
``decode_segments_vmem(..., interpret=True)`` (gen-1: one bucket for window
and staged input, full-window mode) and, via
``from_jax_layout``/``to_jax_layout``, through the port's plain PyTorch
version on the CPU. Bytes and verdicts are integers, so the tolerance is
exact: on every lane the error code agrees, and where both are clean the
windows and output positions are equal.

Inputs are made from a seeded numpy generator and stdlib ``lzma``
(tests/test_torch_kernel_hostbuild.py holds the cases and the staging).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lzma_rs_tpu.ops.vmem2_decoder import KernelConfig2, decode_segments_vmem2
from lzma_rs_tpu.ops.vmem_decoder import KernelConfig, decode_segments_vmem
from lzma_rs_tpu_torch.ops import segment_decoder as sd
from lzma_rs_tpu_torch.ops.lzma_consts import SegmentConfig

from test_torch_kernel_hostbuild import BATCH_NAMES, batch, raw, stage, text

CFG2 = KernelConfig2(L=8, W=4096, W_IN=4096, K=4)
# gen-1 in full-window mode (RING=0), as tests/test_vmem_kernel.py runs it
CFG1 = KernelConfig(L=8, W=4096, W_IN=4096, NLIT=8, K=4)
CFGS = {1: CFG1, 2: CFG2}
# one interpret-mode compile per generation for all batches, as the JAX
# runtime jits it
_JITTED = {
    gen: jax.jit(fn, static_argnames=("config", "max_iters", "interpret"))
    for gen, fn in ((1, decode_segments_vmem), (2, decode_segments_vmem2))
}


def max_iters(cfg):
    """The JAX runtime's iteration cap (parallel/runtime.py:876)."""
    return 8 * cfg.W_IN + 2 * cfg.W + cfg.MAINT * (3 * cfg.K + 4) + 1024


@functools.lru_cache(maxsize=None)
def jax_run(name, gen=2):
    cfg = CFGS[gen]
    args, seg_lens = stage(batch(name), cfg)
    win, err, outp, _ = _JITTED[gen](
        *(jnp.asarray(a) for a in args), config=cfg,
        max_iters=max_iters(cfg), interpret=True,
    )
    return args, seg_lens, (np.asarray(win), np.asarray(err),
                            np.asarray(outp))


@functools.lru_cache(maxsize=None)
def port_run(name, gen=2):
    args, _, _ = jax_run(name, gen)
    cfg, *tensors = sd.from_jax_layout(CFGS[gen], *args)
    win, err, outp, steps = sd.decode_segments_reference(*tensors, config=cfg)
    return sd.to_jax_layout(win, err, outp), steps


@pytest.mark.parametrize("gen,name", [
    pytest.param(gen, name, id=name if gen == 2 else f"gen1-{name}")
    for gen in (1, 2) for name in BATCH_NAMES
])
def test_reference_matches_jax_kernel(gen, name):
    _, seg_lens, (jwin, jerr, joutp) = jax_run(name, gen)
    (pwin, perr, poutp), _ = port_run(name, gen)
    # the err != 0 verdict, on every lane (padding lanes included), and the
    # error codes themselves
    np.testing.assert_array_equal(perr != 0, jerr != 0)
    np.testing.assert_array_equal(perr, jerr)
    clean = (jerr[0] == 0) & (perr[0] == 0)
    np.testing.assert_array_equal(poutp[0][clean], joutp[0][clean])
    np.testing.assert_array_equal(pwin[:, clean], jwin[:, clean])


def test_clean_batches_decode_their_data():
    for name in ("props", "structure"):
        _, seg_lens, (_, jerr, joutp) = jax_run(name)
        (_, perr, poutp), _ = port_run(name)
        n = len(seg_lens)
        assert not perr[0, :n].any() and not jerr[0, :n].any(), name
        np.testing.assert_array_equal(poutp[0, :n], seg_lens)


def test_corrupt_batch_has_errors():
    _, seg_lens, (_, jerr, joutp) = jax_run("corrupt")
    (_, perr, _), _ = port_run("corrupt")
    n = len(seg_lens)
    # every truncated lane fails; the verdicts themselves are compared above
    assert (perr[0, 4:n] != 0).all()
    assert (perr[0, :n] != 0).sum() >= 5


def test_layout_round_trip():
    args, _, _ = jax_run("structure")
    cfg, inbuf, win_init, *tables = sd.from_jax_layout(CFG2, *args)
    assert cfg == SegmentConfig(L=8, W=4096, W_IN=4096, NLIT=8, K=4, NPS=16)
    # a gen-1 KernelConfig carries the same budget fields
    assert sd.from_jax_layout(CFG1, *args)[0] == cfg
    assert inbuf.shape == (8, 4096) and inbuf.dtype == torch.uint8
    assert all(t.shape == (8, 4) and t.dtype == torch.int32 for t in tables)
    jw, je, jo = sd.to_jax_layout(
        win_init, torch.arange(8, dtype=torch.int32),
        torch.full((8,), 7, dtype=torch.int32),
    )
    np.testing.assert_array_equal(jw, args[1])
    assert je.shape == (1, 8) and jo.tolist() == [[7] * 8]


def _small_lanes(device):
    cfg2 = KernelConfig2(L=2, W=2048, W_IN=2048, K=2)
    args, _ = stage([raw(text(600, 40)), raw(text(500, 41), lc=0)], cfg2)
    return sd.from_jax_layout(cfg2, *args, device=device)


def test_wrapper_runs_plain_version_on_cpu_tensors():
    cfg, *tensors = _small_lanes(torch.device("cpu"))
    before = sd.decode_segments.launches
    got = sd.decode_segments(*tensors, config=cfg)
    want = sd.decode_segments_reference(*tensors, config=cfg)
    assert sd.decode_segments.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2].tolist() == [600, 500] and got[1].tolist() == [0, 0]


def test_wrapper_rejects_bad_inputs():
    cfg, inbuf, win, *tables = _small_lanes(torch.device("cpu"))
    with pytest.raises(ValueError, match="inbuf"):
        sd.decode_segments(inbuf.to(torch.int32), win, *tables, config=cfg)
    with pytest.raises(ValueError, match="in_start"):
        sd.decode_segments(inbuf, win, tables[0][:, :1].contiguous(),
                           *tables[1:], config=cfg)
    with pytest.raises(ValueError, match="contiguous"):
        sd.decode_segments(inbuf, win, tables[0].t().contiguous().t(),
                           *tables[1:], config=cfg)


def test_step_cap_marks_lane_corrupt():
    cfg, *tensors = _small_lanes(torch.device("cpu"))
    win, err, outp, steps = sd.decode_segments_reference(
        *tensors, config=cfg, max_steps=500
    )
    assert err.tolist() == [1, 1] and steps.tolist() == [500, 500]
    assert (outp < 500).all()
