"""The port stands alone: importing every `spf_tpu_torch` module and
`chip_smoke.py` loads neither `jax` nor `spf_tpu`, imports no `triton`,
and builds or loads no kernel library and no native BDD extension."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, os, pkgutil, sys
sys.path.insert(0, os.environ["REPO"])
import spf_tpu_torch
names = ["spf_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(spf_tpu_torch.__path__, "spf_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (its imports only: main() runs under __main__)
from spf_tpu_torch import kernels
from spf_tpu_torch.kernels import build
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "spf_tpu", "triton"))
assert not bad, bad
assert not build._libs, "a kernel library was loaded at import"
assert all(k._fn is None and k.launches == 0 for k in kernels.ALL.values())
from spf_tpu_torch import native
assert not native._tried and native._cached is None, "the BDD extension was built at import"
assert "spf_tpu_torch.native.bdd_native" not in sys.modules
print(len(names))
"""


def _kernel_builds(build_dir):
    """The kernel libraries and logs in `_build/`; the BDD extension there
    is left out: a test of the circuit layer in another worker may build
    it meanwhile, and the probe checks in-process that the import did not."""
    if not os.path.isdir(build_dir):
        return []
    return sorted(f for f in os.listdir(build_dir) if not f.startswith("bdd_native"))


def test_port_imports_neither_jax_nor_reference(tmp_path):
    build_dir = os.path.join(REPO, "spf_tpu_torch", "_build")
    before = _kernel_builds(build_dir)
    env = dict(os.environ, REPO=REPO, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # every module was found: ops.u64 too, and ops.u64.pfks, runtime.recryption, ops.ntt,
    # ops.u64.fft_ds32, utils.{combinatorics,security,serialization,noise}, scripts.op_noise,
    # ops.{fft_ds32_t,bootstrap_tpu}, parallel.{mesh,multihost}
    assert int(out.stdout.strip().splitlines()[-1]) >= 78
    assert _kernel_builds(build_dir) == before, "importing built kernels"
