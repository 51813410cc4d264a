"""Parameter sets for the TFHE scheme (PyTorch port).

A copy of the parameter dataclasses, sets and depth model of
`spf_tpu.params`, so that the port imports nothing of the JAX package,
with its security estimates over the port's copy of `utils/security.py`.
The torus is Z_q with q = 2**64; the
port carries torus elements as wrapping `torch.int64`.
"""

from __future__ import annotations

import dataclasses
import math

from .utils.security import lwe_std_to_security_level

TORUS_BITS = 64  # q = 2**64


@dataclasses.dataclass(frozen=True)
class LweDef:
    """An LWE instance: dimension and noise stddev (normalized over the
    torus [0, 1))."""

    dim: int
    std: float

    def assert_valid(self) -> None:
        assert self.dim > 0


@dataclasses.dataclass(frozen=True)
class GlweDef:
    """A GLWE instance over Z_q[X]/(X^N + 1): `size` is k (number of
    mask polynomials), `degree` is N (a power of 2)."""

    size: int
    degree: int
    std: float

    def assert_valid(self) -> None:
        assert self.degree > 0 and (self.degree & (self.degree - 1)) == 0
        assert self.size > 0

    def as_lwe_def(self) -> LweDef:
        """Reinterpret as an LWE instance of dimension k*N."""
        return LweDef(dim=self.size * self.degree, std=self.std)

    @property
    def log_degree(self) -> int:
        return self.degree.bit_length() - 1


@dataclasses.dataclass(frozen=True)
class RadixDecomposition:
    """Gadget decomposition: `count` digits of `radix_log` bits each."""

    count: int
    radix_log: int

    def assert_valid(self) -> None:
        assert self.count > 0
        assert self.radix_log > 0
        assert self.count * self.radix_log <= TORUS_BITS


@dataclasses.dataclass(frozen=True)
class Params:
    """Full parameter set for circuit-bootstrapping-based computation
    (L0 LWE -> CBS -> L1 GGSW -> CMux -> L1 GLWE -> sample extract ->
    L1 LWE -> keyswitch -> L0 LWE)."""

    l0_params: LweDef
    l1_params: GlweDef
    cbs_radix: RadixDecomposition
    pbs_radix: RadixDecomposition
    ks_radix: RadixDecomposition
    pfks_radix: RadixDecomposition
    ss_radix: RadixDecomposition
    tr_radix: RadixDecomposition
    # blind-rotation radix inside circuit bootstrapping (None -> pbs_radix);
    # the ds32 FFT-MAD error grows with digit magnitude, so CBS rotates
    # at a narrower-digit radix than the standalone PBS
    cbs_pbs_radix: "RadixDecomposition | None" = None

    @property
    def cbs_pbs_radix_eff(self) -> RadixDecomposition:
        return self.cbs_pbs_radix or self.pbs_radix

    @property
    def l1_poly_degree(self) -> int:
        return self.l1_params.degree


# 128-bit secure instances (reference `sunscreen_tfhe/src/params.rs:218-264`)
LWE_637_128 = LweDef(dim=637, std=7.25e-5)
LWE_512_128 = LweDef(dim=512, std=6.6e-4)
GLWE_1_512_128 = GlweDef(size=1, degree=512, std=6.6e-4)
GLWE_5_256_128 = GlweDef(size=5, degree=256, std=5e-10)
GLWE_1_1024_128 = GlweDef(size=1, degree=1024, std=7.2e-8)
GLWE_1_2048_128 = GlweDef(size=1, degree=2048, std=7e-16)

# the standard 128-bit secure parameter set
DEFAULT_128 = Params(
    l0_params=LWE_637_128,
    l1_params=GLWE_1_2048_128,
    cbs_radix=RadixDecomposition(count=4, radix_log=4),
    pbs_radix=RadixDecomposition(count=2, radix_log=16),
    pfks_radix=RadixDecomposition(count=2, radix_log=17),
    ks_radix=RadixDecomposition(count=6, radix_log=2),
    ss_radix=RadixDecomposition(count=15, radix_log=3),
    tr_radix=RadixDecomposition(count=6, radix_log=7),
    cbs_pbs_radix=RadixDecomposition(count=4, radix_log=8),
)

# reduced-size instances: INSECURE, for fast tests only (the sizes of the
# reference's TEST_* sets, `sunscreen_tfhe/src/high_level.rs:9-57`)
TEST_RADIX = RadixDecomposition(count=3, radix_log=4)
TEST_GLWE_DEF_1 = GlweDef(size=2, degree=128, std=1e-16)
TEST_RLWE_DEF = GlweDef(size=1, degree=256, std=1e-16)
TEST_GLWE_DEF_2 = GlweDef(size=3, degree=256, std=1e-16)
TEST_LWE_DEF_1 = LweDef(dim=128, std=1e-16)
TEST_LWE_DEF_2 = LweDef(dim=256, std=1e-16)
TEST_LWE_DEF_3 = LweDef(dim=128, std=0.0)

TEST_PARAMS = Params(
    l0_params=TEST_LWE_DEF_1,
    l1_params=TEST_GLWE_DEF_1,
    cbs_radix=RadixDecomposition(count=2, radix_log=9),
    pbs_radix=RadixDecomposition(count=2, radix_log=16),
    ks_radix=RadixDecomposition(count=6, radix_log=2),
    pfks_radix=RadixDecomposition(count=2, radix_log=17),
    ss_radix=RadixDecomposition(count=6, radix_log=8),
    tr_radix=RadixDecomposition(count=6, radix_log=7),
)


def noise_exponent_at_depth(depth: float) -> float:
    """CMux-tree error exponent model for DEFAULT_128: the base-2 error
    exponent at a given multiplexer-tree depth (reference
    `parasol_runtime/src/params.rs:103-106`; ~2^-125 at depth 1024)."""
    return -1.0 / (6.162e-6 * (depth + 304.7668)) - 3.3379


def security_level(lwe: LweDef) -> float:
    """Security bits of an LWE instance per the lattice-estimator fit
    (≙ `SecurityLevel for LweDef`, `sunscreen_tfhe/src/params.rs:176-180`).
    Raises `utils.security.OutsideConstraintsError` outside the fit's
    validity region."""
    return lwe_std_to_security_level(lwe.dim, lwe.std)


def assert_security_level(lwe: LweDef, specified: int, tolerance: float = 0.25):
    """Assert the instance achieves `specified` bits within +-0.25
    (≙ `SecurityLevel::assert_security_level`, `params.rs:14-26`)."""
    got = security_level(lwe)
    assert abs(got - specified) <= tolerance, (
        f"security level mismatch: expected {specified}, got {got}"
    )


def security_estimate_ok(lwe: LweDef, level: float = 128.0) -> bool:
    """True iff (dim, std) achieves at least `level` bits per the
    lattice-estimator fit (conjunctive on BOTH dim and std: a large
    dimension with tiny noise does NOT pass). Points outside the fit's
    validity polytope fail closed, except dimensions above the fit range
    with noise at/above the fitted band's minimum, which only get more
    secure with dimension."""
    if lwe.std <= 0:
        return False
    try:
        return security_level(lwe) >= level
    except Exception:
        # Outside the fit region. Security grows with dimension (at fixed
        # noise) and with noise (at fixed dimension), so clamp toward the
        # fitted band from the MORE-secure side only: a conservative
        # lower bound; too-little-noise points stay rejected.
        dim = min(lwe.dim, 2048)
        log_std = math.log10(lwe.std)
        band_top = 0.7390928205510939 - 0.0077927720025765665 * dim
        if log_std < band_top:
            return False  # less noise than the fitted band: fail closed
        try:
            return lwe_std_to_security_level(dim, 10.0 ** (band_top - 1e-9)) >= level
        except Exception:
            return False
