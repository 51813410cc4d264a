"""Build the native BDD extension with g++ at first use (plain CPython C
API; no pybind11).

The library goes into the ignored `spf_tpu_torch/_build/` as
`bdd_native-<digest><EXT_SUFFIX>`, where the digest covers the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded; the source tree is never written.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "bdd_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(BUILD_DIR, f"bdd_native-{h.hexdigest()[:16]}{suffix}")


def build_extension():
    """Build the extension if it is missing and load it."""
    out = library_path()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        include = sysconfig.get_paths()["include"]
        cmd = ["g++", *FLAGS, f"-I{include}", SOURCE, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    spec = importlib.util.spec_from_file_location("spf_tpu_torch.native.bdd_native", out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
