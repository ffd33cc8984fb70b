"""The port's benchmark (``python -m lzma_rs_tpu_torch.bench``) on the CPU.

Without a card ``main`` exits nonzero and prints no result line. The lane
functions are driven here with ``device="cpu"`` (the kernel's plain
version) on small inputs: each lane is checked bit-exact before it is
timed, a card lane that falls back or decodes wrong bytes fails, and the
result's keys name the device the numbers ran on.
"""

import functools
import json
import os
import subprocess
import sys

import pytest
import torch

from lzma_rs_tpu_torch import bench
from lzma_rs_tpu_torch.parallel import devbench
from lzma_rs_tpu_torch.tools import corpus

from test_torch_kernel_hostbuild import text

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_exits_nonzero_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert "no CUDA device" in str(e.value.code)


def test_the_module_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "lzma_rs_tpu_torch.bench"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_the_host_lane():
    data = text(2_500_000, 3)
    r = bench.host_lane(data, reps=1)
    assert r["host_blocks"] == 3 and r["host_corpus_mb"] == 2.5
    # three 1 MiB blocks are below auto's small-workload gate
    assert r["host_route"] == "native"
    assert r["host_fallbacks"] == ["auto->native: small workload (3 lanes, "
                                   "2500000 B out)"]
    assert min(r["host_mb_s"], r["host_native_mb_s"],
               r["baseline_mb_s"]) > 0


def test_a_card_lane_on_the_cpu():
    data = text(4096, 4)
    r = bench.card_lane(corpus.tpu_archive(data, 1024), data, CPU, reps=1,
                        dev_reps=1)
    assert r["lanes"] == 4 and r["cycles_per_step"] is None
    assert min(r["e2e_mb_s"], r["device_mb_s"], r["native_mb_s"]) > 0


def test_a_card_lane_that_falls_back_fails():
    data = text(140_000, 5)  # one block: a segment beyond the 64 KiB window
    arch = corpus.stock_archive(data, 1 << 20)
    with pytest.raises(RuntimeError, match="left the card"):
        bench.card_lane(arch, data, CPU, reps=1, dev_reps=1)


def test_a_card_lane_with_wrong_bytes_fails():
    data = text(2048, 6)
    with pytest.raises(RuntimeError, match="not bit-exact"):
        bench.card_lane(corpus.tpu_archive(data, 1024), data[::-1], CPU,
                        reps=1, dev_reps=1)


def test_run_on_the_cpu_names_the_cpu(monkeypatch):
    tpu_archive = corpus.tpu_archive
    monkeypatch.setattr(corpus, "tpu_archive",
                        lambda d: tpu_archive(d, 1024))
    monkeypatch.setattr(bench, "card_lane", functools.partial(
        bench.card_lane, reps=1, dev_reps=1))
    monkeypatch.setattr(devbench, "sharding_overhead", functools.partial(
        devbench.sharding_overhead, reps=1))
    r = bench.run(CPU, host_mb=0.002, card_mb=0.001)
    json.dumps(r)
    assert (r["metric"], r["unit"]) == ("xz_decode_throughput", "MB/s")
    assert r["value"] == r["host_mb_s"]
    assert r["vs_baseline"] == pytest.approx(r["host_mb_s"]
                                             / r["baseline_mb_s"])
    assert r["device"] == {"name": "cpu", "power_limit": None, "count": 1}
    assert not [k for k in r if k.startswith("cuda")]
    for k in ("cpu_e2e_mb_s", "cpu_device_mb_s", "cpu_native_mb_s",
              "cpu_stock64k_e2e_mb_s", "cpu_stock64k_device_mb_s",
              "cpu_stock64k_native_mb_s", "cpu_shard_overhead_pct",
              "cpu_link_mb_s"):
        assert isinstance(r[k], float), k
    assert r["cpu_shard_n"] == 1 and r["cpu_corpus_mb"] == 0.001


@pytest.mark.cuda
def test_the_bench_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = bench.run(torch.device("cuda", torch.cuda.current_device()),
                  host_mb=3, card_mb=1)
    json.dumps(r)
    assert r["device"]["name"] == torch.cuda.get_device_name(0)
    assert r["cuda_device_mb_s"] > 0 and r["cuda_stock64k_e2e_mb_s"] > 0
    assert r["cuda_shard_n"] == torch.cuda.device_count()
