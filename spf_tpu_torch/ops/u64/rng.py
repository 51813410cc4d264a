"""Randomness for key generation and encryption on an explicit
`torch.Generator` (port of `spf_tpu/ops/rng.py`; the reference's
`sunscreen_tfhe/src/rand.rs`). Tensors are made on the generator's
device. The random streams differ from jax.random's: tests hand both
packages the same keys and ciphertexts instead.
"""

from __future__ import annotations

import torch

from .. import encryption as _enc


def uniform_torus(generator: torch.Generator, shape=()) -> torch.Tensor:
    """Uniform torus elements, all 64 bits (`rand.rs:33-35`)."""
    return _enc.uniform_torus(tuple(shape), generator)


def normal_torus(generator: torch.Generator, std: float, shape=()) -> torch.Tensor:
    """round(N(0, std) * 2**64) as wrapping int64 (`rand.rs:20-30`);
    exactly zero, drawing nothing, when std == 0 (`glwe_encryption.rs:51-53`)."""
    if std == 0.0:
        return torch.zeros(tuple(shape), dtype=torch.int64, device=generator.device)
    return _enc.normal_torus(std, tuple(shape), generator)


def binary(generator: torch.Generator, shape=()) -> torch.Tensor:
    """Uniform bits in {0, 1} (secret key coefficients, `rand.rs:38-40`)."""
    return torch.randint(0, 2, tuple(shape), generator=generator, dtype=torch.int64,
                         device=generator.device)
