"""The port stands alone: it imports nothing of ``lzma_rs_tpu``.

Three checks:

- statically, no ``.py`` file of ``lzma_rs_tpu_torch/`` and not
  ``chip_smoke.py`` imports ``lzma_rs_tpu`` or a module under it: not at
  the top, not inside a function, and not by name through
  ``importlib.import_module`` or ``__import__``;
- in a fresh interpreter, importing every module of the port and running
  an `.xz` round trip on the CPU leaves no ``lzma_rs_tpu*`` module other
  than the port's, and no ``jax``, in ``sys.modules``;
- the JAX package's native library and the port's (its own file name,
  built into the port's ``build/``) load side by side in one process, each
  package's facade bound to its own library and raising its own package's
  exception classes.
"""

import ast
import ctypes
import os
import subprocess
import sys

import pytest

import lzma_rs_tpu
import lzma_rs_tpu_torch
from lzma_rs_tpu.native import loader as jax_loader
from lzma_rs_tpu.utils import errors as jax_errors
from lzma_rs_tpu_torch.native import loader as port_loader
from lzma_rs_tpu_torch.utils import errors as port_errors

from test_torch_kernel_hostbuild import text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "lzma_rs_tpu_torch")


def jax_package(name) -> bool:
    """Is ``name`` the JAX package or a module under it?"""
    return isinstance(name, str) and (
        name == "lzma_rs_tpu" or name.startswith("lzma_rs_tpu."))


def port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("build", "__pycache__")]
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def imports_of_the_jax_package(path):
    """(line, what) of every import of the JAX package in one file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names
                      if jax_package(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and jax_package(node.module):
                found.append((node.lineno, node.module))
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            arg = node.args[0]
            if (name in ("import_module", "__import__")
                    and isinstance(arg, ast.Constant)
                    and jax_package(arg.value)):
                found.append((node.lineno, arg.value))
    return found


def test_no_source_of_the_port_imports_the_jax_package():
    files = port_sources()
    # the walk sees the copied host layers and the device half
    rel = {os.path.relpath(f, REPO) for f in files}
    assert {"chip_smoke.py", "lzma_rs_tpu_torch/parallel/runtime.py",
            "lzma_rs_tpu_torch/parallel/mesh.py",
            "lzma_rs_tpu_torch/graft_entry.py",
            "lzma_rs_tpu_torch/ops/probes_bisect.py",
            "lzma_rs_tpu_torch/ops/crc_device.py",
            "lzma_rs_tpu_torch/parallel/devbench.py",
            "lzma_rs_tpu_torch/bench.py",
            "lzma_rs_tpu_torch/tools/corpus.py",
            "lzma_rs_tpu_torch/tools/probe_vmem2_time.py",
            "lzma_rs_tpu_torch/tools/time_vmem_step.py",
            "lzma_rs_tpu_torch/tools/profile_decode.py",
            "lzma_rs_tpu_torch/tools/profile_pipeline.py",
            "lzma_rs_tpu_torch/tools/calibrate.py",
            "lzma_rs_tpu_torch/stream.py",
            "lzma_rs_tpu_torch/streams2.py",
            "lzma_rs_tpu_torch/raw.py",
            "lzma_rs_tpu_torch/native/loader.py",
            "lzma_rs_tpu_torch/models/codecs.py",
            "lzma_rs_tpu_torch/encode/lzma2_enc.py",
            "lzma_rs_tpu_torch/__main__.py",
            "lzma_rs_tpu_torch/parallel/multihost.py",
            "lzma_rs_tpu_torch/tools/multihost_demo.py",
            "lzma_rs_tpu_torch/tools/scaling.py",
            "lzma_rs_tpu_torch/tools/check_docs.py",
            "lzma_rs_tpu_torch/ops/step_cost.py",
            "lzma_rs_tpu_torch/tools/probe_step_cost.py",
            "lzma_rs_tpu_torch/tools/probe_step_cost2.py",
            "lzma_rs_tpu_torch/tools/mutate.py",
            "lzma_rs_tpu_torch/tools/coverage_report.py"} <= rel
    bad = {os.path.relpath(f, REPO): hits for f in files
           if (hits := imports_of_the_jax_package(f))}
    assert bad == {}


def test_the_static_check_finds_every_form_of_import():
    code = (
        "import lzma_rs_tpu\n"
        "import lzma_rs_tpu_torch.utils\n"
        "from lzma_rs_tpu.utils import stats\n"
        "from . import sibling\n"
        "def f():\n"
        "    from lzma_rs_tpu.native import loader\n"
        "    importlib.import_module('lzma_rs_tpu.raw')\n"
        "    __import__('lzma_rs_tpu_torch.raw')\n"
    )
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"standalone_probe_{os.getpid()}.py")
    with open(path, "w") as f:
        f.write(code)
    try:
        assert imports_of_the_jax_package(path) == [
            (1, "lzma_rs_tpu"), (3, "lzma_rs_tpu.utils"),
            (6, "lzma_rs_tpu.native"), (7, "lzma_rs_tpu.raw"),
        ]
    finally:
        os.unlink(path)


def test_a_fresh_interpreter_loads_only_the_port():
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "import lzma_rs_tpu_torch as t\n"
        "for m in pkgutil.walk_packages(t.__path__, 'lzma_rs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from lzma_rs_tpu_torch.parallel import runtime\n"
        "data = b'standalone ' * 2000\n"
        "xz = t.xz_compress(data, block_size=4096, check_method=1)\n"
        "assert t.xz_decompress(xz) == data\n"
        "assert runtime.xz_decode(xz, engine='cuda',\n"
        "                         device=torch.device('cpu')) == data\n"
        "assert t.lzma_decompress(t.lzma_compress(data)) == data\n"
        "assert t.lzma2_decompress(t.lzma2_compress(data)) == data\n"
        "s = t.decompress.XzStream()\n"
        "s.write(xz)\n"
        "assert s.finish() == data and t.decompress.raw.Lzma2Decoder\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.startswith(('lzma_rs_tpu', 'jax'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    assert "lzma_rs_tpu_torch.native.loader" in loaded
    assert "lzma_rs_tpu_torch.parallel.runtime" in loaded
    assert {"lzma_rs_tpu_torch.bench", "lzma_rs_tpu_torch.ops.crc_device",
            "lzma_rs_tpu_torch.parallel.devbench",
            "lzma_rs_tpu_torch.tools.probe_vmem2_time",
            "lzma_rs_tpu_torch.tools.profile_pipeline",
            "lzma_rs_tpu_torch.tools.calibrate", "lzma_rs_tpu_torch.stream",
            "lzma_rs_tpu_torch.streams2", "lzma_rs_tpu_torch.raw",
            "lzma_rs_tpu_torch.__main__",
            "lzma_rs_tpu_torch.parallel.multihost",
            "lzma_rs_tpu_torch.tools.multihost_demo",
            "lzma_rs_tpu_torch.tools.scaling",
            "lzma_rs_tpu_torch.tools.check_docs",
            "lzma_rs_tpu_torch.ops.step_cost",
            "lzma_rs_tpu_torch.tools.probe_step_cost",
            "lzma_rs_tpu_torch.tools.probe_step_cost2",
            "lzma_rs_tpu_torch.tools.mutate",
            "lzma_rs_tpu_torch.tools.coverage_report"} <= set(loaded)
    assert [m for m in loaded if m != "lzma_rs_tpu_torch"
            and not m.startswith("lzma_rs_tpu_torch.")] == []


def test_the_two_native_libraries_load_side_by_side():
    jax_lib, port_lib = jax_loader.load(), port_loader.load()
    if jax_lib is None or port_lib is None:
        pytest.skip("needs g++ to build the native libraries")
    # the port's library has its own name, in the port's build directory
    so = port_loader._so_path()
    assert so != jax_loader._SO
    assert os.path.dirname(so) == os.path.join(PORT, "build")
    assert os.path.basename(so).startswith("liblzma_rs_tpu_torch_native-")
    # both loaded RTLD_LOCAL: the same exported name resolves to two
    # functions, one in each library
    addr = [ctypes.cast(lib._lib.lrt_lzma2_decode, ctypes.c_void_p).value
            for lib in (jax_lib, port_lib)]
    assert addr[0] != addr[1]
    data = text(20000, 11)
    packed = jax_lib.lzma2_compress(data, 6)
    assert port_lib.lzma2_compress(data, 6) == packed
    assert jax_lib.lzma2_decode(packed) == port_lib.lzma2_decode(packed) \
        == data
    # each facade raises its own package's exception classes
    bad = packed[:40] + bytes(b ^ 0x5A for b in packed[40:80]) + packed[80:]
    with pytest.raises(Exception) as jax_err:
        jax_lib.lzma2_decode(bad)
    with pytest.raises(Exception) as port_err:
        port_lib.lzma2_decode(bad)
    assert isinstance(jax_err.value, jax_errors.LzmaRsError)
    assert isinstance(port_err.value, port_errors.LzmaRsError)
    assert not isinstance(port_err.value, jax_errors.LzmaRsError)
    assert (type(port_err.value).__name__, str(port_err.value)) == (
        type(jax_err.value).__name__, str(jax_err.value))


def test_the_two_packages_keep_separate_state():
    from lzma_rs_tpu.utils import stats as jax_stats
    from lzma_rs_tpu_torch.utils import stats as port_stats

    assert port_stats is not jax_stats
    assert port_errors.XzError is not jax_errors.XzError
    assert lzma_rs_tpu_torch.Options is not lzma_rs_tpu.Options
    xz = lzma_rs_tpu_torch.xz_compress(text(5000, 12), check_method=4)
    with port_stats.collect() as p, jax_stats.collect() as j:
        lzma_rs_tpu_torch.xz_decompress(xz)
    assert p.engine and p.unpacked_bytes == 5000
    assert j.engine == "" and j.unpacked_bytes == 0
