"""spf_tpu_torch — the PyTorch and CUDA port of spf_tpu, for one NVIDIA H100.

The JAX package `spf_tpu` stays beside it as the reference. This package
imports neither `jax` nor `spf_tpu`. Torus elements are wrapping
`torch.int64` tensors, float work is double-single (ds32) arithmetic in
the reference's order of operations, and every kernel that `spf_tpu`
wrote in Pallas is a CUDA C++ kernel under `csrc/`, built with nvcc at
first use and bound with ctypes (`kernels/build.py`).

Entry points run on the card (`device="cuda"`) unless the caller asks
for the CPU, where each kernel wrapper runs its plain PyTorch version.
The u64 API (`runtime.generate_keys`, `Encryption`, `Evaluation`,
`runtime.executor.CircuitExecutor`, over `ops/u64/`) computes with
`torch.fft` complex128 and elementwise PyTorch, as the JAX package's c128
backend does outside any Pallas kernel.
"""

from . import params  # noqa: F401
from .params import (  # noqa: F401
    DEFAULT_128,
    GLWE_1_1024_128,
    GLWE_1_2048_128,
    GLWE_1_512_128,
    GLWE_5_256_128,
    LWE_512_128,
    LWE_637_128,
    TEST_PARAMS,
    GlweDef,
    LweDef,
    Params,
    RadixDecomposition,
)

__version__ = "0.1.0"
