"""The port's documentation gate: ``lzma_rs_tpu_torch/tools/check_docs.py``
(the JAX package's ``tools/check_docs.py`` pointed at the port) passes on
the port's whole surface, and fails on a public function without a
docstring."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_every_public_symbol_of_the_port_is_documented():
    env = {**os.environ, "PYTHONPATH": REPO}
    r = subprocess.run(
        [sys.executable, "-m", "lzma_rs_tpu_torch.tools.check_docs"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    last = r.stdout.strip().splitlines()[-1]
    assert last.startswith("doc check OK:"), last
    assert int(last.split()[3]) >= 60  # modules checked


def test_the_check_finds_a_missing_docstring(monkeypatch, capsys):
    from lzma_rs_tpu_torch.parallel import multihost
    from lzma_rs_tpu_torch.tools import check_docs

    monkeypatch.setattr(multihost.scan_blocks, "__doc__", None)
    monkeypatch.setattr(multihost, "__doc__", "")
    assert check_docs.main() == 1
    out = capsys.readouterr().out
    assert "lzma_rs_tpu_torch.parallel.multihost.scan_blocks: missing " \
        "docstring" in out
    assert "lzma_rs_tpu_torch.parallel.multihost: module missing " \
        "docstring" in out
