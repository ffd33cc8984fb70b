"""The port's decoder constants equal the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lzma_rs_tpu.models import state as model_state
from lzma_rs_tpu.ops import vmem_decoder as vd
from lzma_rs_tpu.ops.vmem2_decoder import KernelConfig2
from lzma_rs_tpu_torch.ops import lzma_consts as C

NAMES = [n for n in dir(C) if n.startswith(("N_", "ERR_"))
         and n != "ERR_STEP_CAP"]


@pytest.mark.parametrize("name", NAMES)
def test_codes_equal(name):
    assert getattr(C, name) == getattr(vd, name)


def test_port_covers_every_jax_node_and_used_code():
    jax_nodes = {n for n in dir(vd) if n.startswith("N_")}
    assert jax_nodes == {n for n in NAMES if n.startswith("N_")}
    # ERR_DIST_DICT (raw-LZMA dictionary cap, XLA lane kernel) and ERR_RING
    # (ring mode) belong to paths the segment kernel does not have
    jax_codes = {n for n in dir(vd) if n.startswith("ERR_")}
    assert jax_codes - set(NAMES) == {"ERR_DIST_DICT", "ERR_RING"}
    assert C.ERR_STEP_CAP == 1  # the code the JAX runtime gives a stalled lane


def test_literal_row_and_prob_init():
    assert C.LIT_ROW == vd.LIT_ROW == model_state.LIT_TREE_SIZE
    assert C.PROB_INIT == model_state.PROB_INIT


def test_pack_chunk_meta_equal():
    rng = np.random.default_rng(0)
    fields = [rng.integers(0, hi, size=(8, 4)).astype(np.int32)
              for hi in (4, 9, 5, 5, 2)]
    np.testing.assert_array_equal(
        C.pack_chunk_meta(*fields), vd.pack_chunk_meta(*fields)
    )
    tf = [torch.from_numpy(f) for f in fields]
    np.testing.assert_array_equal(
        C.pack_chunk_meta(*tf).numpy(), vd.pack_chunk_meta(*fields)
    )


@pytest.mark.parametrize(
    "port,jax_fn",
    [(C.after_lit, vd._after_lit), (C.after_match, vd._after_match),
     (C.after_rep, vd._after_rep), (C.after_shortrep, vd._after_shortrep)],
    ids=["lit", "match", "rep", "shortrep"],
)
def test_state_transitions_equal(port, jax_fn):
    states = np.arange(12, dtype=np.int32)
    got = port(torch.from_numpy(states).long()).numpy()
    want = np.asarray(jax_fn(jnp.asarray(states)))
    np.testing.assert_array_equal(got, want)


def test_state_transitions_match_the_model_tables():
    s = torch.arange(12)
    assert C.after_lit(s).tolist() == list(model_state.STATE_AFTER_LIT)
    assert C.after_match(s).tolist() == list(model_state.STATE_AFTER_MATCH)
    assert C.after_rep(s).tolist() == list(model_state.STATE_AFTER_REP)
    assert C.after_shortrep(s).tolist() == list(
        model_state.STATE_AFTER_SHORTREP)


def test_segment_config_keeps_the_budget_fields():
    k = KernelConfig2(L=8, W=4096, W_IN=2048, NLIT=2, K=4, NPS=4)
    cfg = C.SegmentConfig(L=k.L, W=k.W, W_IN=k.W_IN, NLIT=k.NLIT, K=k.K,
                          NPS=k.NPS)
    assert cfg.RING == 0
    assert {f for f in C.SegmentConfig.__dataclass_fields__} == {
        "L", "W", "W_IN", "NLIT", "K", "NPS"}
    with pytest.raises(ValueError):
        C.SegmentConfig(L=8, W=4096, W_IN=4096, NLIT=3)
    with pytest.raises(ValueError):
        C.SegmentConfig(L=8, W=4096, W_IN=4096, NPS=8)


@pytest.mark.parametrize("nlit", [1, 2, 4, 8])
def test_prob_layout_is_the_model_layout(nlit):
    lay = C.prob_layout(nlit)
    # the port's ProbLayout is its own copy's class: compare the fields
    ref = model_state.make_layout(nlit.bit_length() - 1)
    assert type(lay).__name__ == type(ref).__name__
    assert dataclasses.asdict(lay) == dataclasses.asdict(ref)
    assert lay.total == nlit * C.LIT_ROW + 1847
