"""The devices of the decode runtime's slabs.

The port of ``lzma_rs_tpu/parallel/mesh.py``. The codec's only parallel
axis is independent work units (LZMA2 dict-reset segments, `.xz`
blocks), so the devices form one data-parallel line: each takes its own
slab of lanes, and no lane's output crosses devices (reassembly offsets
are known before decode from the container index). Where the reference
builds a JAX ``Mesh`` (``make_mesh``) for ``shard_map``, the port makes
one launch per device, so :func:`devices` lists the torch devices the
slabs go to. The reference's ``MeshConfig`` also holds
``lanes_per_device`` and ``max_chunk_bytes``; nothing in the port reads
them (a slab's lanes are ``parallel/runtime.py``'s ``slab_lanes``), so
the port keeps only the device count, as an argument.
"""

from __future__ import annotations

from typing import List

import torch


def first_card(device) -> int:
    """The index of the card ``device`` names: its own, else the current
    card."""
    device = torch.device(device)
    if device.index is not None:
        return device.index
    return torch.cuda.current_device() if torch.cuda.is_available() else 0


def devices(n: int, device="cuda") -> List[torch.device]:
    """The devices of ``n`` slabs. A CUDA ``device``: ``n`` cards from the
    one ``device`` names on (the current card where it names none); raises
    when fewer are present. A CPU ``device``: ``n`` handles of the CPU, the
    counterpart of the reference tests' XLA host devices, so the slab path
    runs without a card."""
    kind = torch.device(device).type
    if n < 1:
        raise ValueError(f"n={n}: want >= 1")
    if kind == "cpu":
        return [torch.device("cpu")] * n
    if kind != "cuda":
        raise ValueError(f"devices of kind {kind!r}: want cuda or cpu")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    first = first_card(device)
    if first + n > have:
        raise RuntimeError(f"need {n} CUDA devices from cuda:{first}, have "
                           f"{have}")
    return [torch.device("cuda", first + i) for i in range(n)]
