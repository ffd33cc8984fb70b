"""API documentation check of the port: ``tools/check_docs.py`` (the
reference's rustdoc gate adapted to Python) pointed at ``lzma_rs_tpu_torch``.

Fails if any public symbol reachable from the package surface (the
reference-parity entry points, the option and stream classes, and every
public module under ``lzma_rs_tpu_torch/``) is missing a docstring, and
builds the pydoc HTML pages to catch malformed ones. The native loader is
left out, as in the original. Run:

    python -m lzma_rs_tpu_torch.tools.check_docs
"""

import importlib
import inspect
import os
import pkgutil
import sys
import tempfile

def public_members(mod):
    """(name, object) of each public function and class ``mod`` defines."""
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    for n in names:
        obj = getattr(mod, n, None)
        # only flag symbols DEFINED here (re-exports are checked once, at
        # their defining module)
        if getattr(obj, "__module__", None) == mod.__name__ and (
            inspect.isfunction(obj) or inspect.isclass(obj)
        ):
            yield n, obj


# User-facing classes whose every public method must be documented
# (mirrors the reference's public rustdoc surface: Stream, options, raw).
API_CLASSES = {
    "Stream", "Lzma2Stream", "XzStream", "Options", "CompressOptions",
    "UnpackedSize", "WriteUnpackedSize", "LzmaDecoder", "Lzma2Decoder",
    "LzmaParams", "LzmaProperties", "DecodeStats",
}


def main() -> int:
    """Check every module of the port; 0 when all is documented."""
    import lzma_rs_tpu_torch

    missing = []
    mods = [lzma_rs_tpu_torch]
    pkg_dir = os.path.dirname(lzma_rs_tpu_torch.__file__)
    for info in pkgutil.walk_packages([pkg_dir], prefix="lzma_rs_tpu_torch."):
        if ".native" in info.name:
            continue  # ctypes loader builds C++ lazily; skip import side effects
        try:
            mods.append(importlib.import_module(info.name))
        except Exception as e:  # import failure is itself a doc-build failure
            missing.append(f"{info.name}: import failed: {e}")

    for mod in mods:
        if not (mod.__doc__ or "").strip():
            missing.append(f"{mod.__name__}: module missing docstring")
        for name, obj in public_members(mod):
            if not (inspect.getdoc(obj) or "").strip():
                missing.append(f"{mod.__name__}.{name}: missing docstring")
            # method docstrings are required on the user-facing API
            # surface (the reference-parity entry classes); internal
            # helper classes need only a class docstring
            if inspect.isclass(obj) and name in API_CLASSES:
                for mname, m in vars(obj).items():
                    if mname.startswith("_") or not inspect.isfunction(m):
                        continue
                    if not (inspect.getdoc(m) or "").strip():
                        missing.append(
                            f"{mod.__name__}.{name}.{mname}: missing docstring"
                        )

    # pydoc HTML build (catches symbols whose signatures cannot render)
    import pydoc

    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            for mod in mods:
                pydoc.writedoc(mod)
        finally:
            os.chdir(cwd)

    if missing:
        print(f"DOC CHECK FAILED ({len(missing)}):")
        for m in sorted(set(missing)):
            print(" -", m)
        return 1
    print(f"doc check OK: {len(mods)} modules, all public symbols documented")
    return 0


if __name__ == "__main__":
    sys.exit(main())
