"""LWE security estimation: 2-D polynomial fits of the lattice estimator.

A copy of `spf_tpu/utils/security.py` (pure math), so that the port
imports nothing of the JAX package. Behavioral port of the reference's
estimator layer
(`sunscreen_math/src/security.rs:65-264` and `geometry.rs`): maps
(LWE dimension, noise stddev) <-> security bits via polynomial fits of
lattice-estimator simulation data (commit 25f9e88, Nov 8 2023), with a
convex-polytope validity region. The coefficient tables are the fit
*data* (like test vectors); the polytopes bound where the fits are
valid. Binary secret keys are assumed throughout, q = 2^64.
"""

from __future__ import annotations

import dataclasses
import math


# --------------------------------------------------------------------------
# geometry (≙ sunscreen_math/src/geometry.rs)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HalfSpace2D:
    """The set of points (x, y) with a0*x + a1*y <= b."""

    a: tuple
    b: float

    def inside(self, x: float, y: float) -> bool:
        return self.a[0] * x + self.a[1] * y <= self.b


@dataclasses.dataclass(frozen=True)
class ConvexPolytope2D:
    """Intersection of half-spaces (no vertex representation needed)."""

    half_spaces: tuple

    def inside(self, x: float, y: float) -> bool:
        return all(h.inside(x, y) for h in self.half_spaces)

    def violations(self, x: float, y: float) -> list:
        return [h for h in self.half_spaces if not h.inside(x, y)]


class OutsideConstraintsError(ValueError):
    """A (dimension, value) point fell outside the fit's validity
    polytope (≙ `security.rs` OutsideConstraintsError)."""

    def __init__(self, dimensions, value, polytope):
        self.dimensions = dimensions
        self.value = value
        self.polytope = polytope
        super().__init__(
            f"value {value} for {dimensions} is outside the fit's validity region"
        )


# --------------------------------------------------------------------------
# polynomial evaluation
# --------------------------------------------------------------------------


def evaluate_polynomial(coeffs, x: float) -> float:
    """1-D polynomial, coefficients in increasing degree order."""
    return sum(c * x**i for i, c in enumerate(coeffs))


def evaluate_polynomial_2d(coeffs, x: float, y: float) -> float:
    """2-D polynomial, coefficients[i][j] multiplies x^i * y^j
    (≙ `security.rs:65`)."""
    return sum(
        c * x**i * y**j for i, row in enumerate(coeffs) for j, c in enumerate(row)
    )


# --------------------------------------------------------------------------
# Gaussian tail probability (≙ `security.rs:84-150`)
# --------------------------------------------------------------------------

# Quintic fit used above ratio 7 (validated to ratio 30), increasing
# degree order (`security.rs:104-115` lists them; applied via
# evaluate_polynomial with increasing-order indexing).
_TAIL_COEFFS = (
    -0.31904236601958913,
    -0.13390834324063405,
    -0.20902566462352498,
    -0.0003178660849038345,
    6.75504783552659e-06,
    -5.91907446763691e-08,
)


def probability_away_from_mean_gaussian(x: float, std: float) -> float:
    """log10 of the two-tailed probability of being farther than `x`
    from the mean of a N(0, std) Gaussian."""
    ratio = x / std
    if ratio < 7.0:
        both_tails = math.erfc(ratio / math.sqrt(2.0))
        return math.log10(both_tails)
    return evaluate_polynomial(_TAIL_COEFFS, ratio)


# --------------------------------------------------------------------------
# lattice-estimator fits (≙ `security.rs:152-264`)
# --------------------------------------------------------------------------

_SECURITY_TO_STD_POLYTOPE = ConvexPolytope2D(
    half_spaces=(
        HalfSpace2D((-1.0, 0.0), -368.0),
        HalfSpace2D((1.0, 0.0), 2048.0),
        HalfSpace2D((0.0, -1.0), -78.0),
        HalfSpace2D((0.0, 1.0), 130.0),
        # above 1472 dims the security at the smallest possible noise
        # already exceeds 78 bits
        HalfSpace2D((0.05678074392712544, -1.0), 3.5151045883938177),
    )
)

_SECURITY_TO_STD_COEFFS = (
    (2.89630547e00, -1.26321873e-01, 2.13993467e-03, -1.49515549e-05, 3.84468453e-08),
    (-5.60568533e-02, 1.33311189e-03, -1.56200244e-05, 8.93067686e-08, -2.00996854e-10),
    (7.39088707e-07, -9.61269520e-08, 2.15766569e-09, -1.82462028e-11, 5.45243818e-14),
    (1.49456164e-09, -4.28264022e-11, 4.30538855e-13, -1.50621118e-15, 0.0),
    (9.49334890e-14, -2.17539853e-15, 1.22195316e-17, 0.0, 0.0),
)

_STD_TO_SECURITY_POLYTOPE = ConvexPolytope2D(
    half_spaces=(
        HalfSpace2D((-1.0, 0.0), -386.0),
        HalfSpace2D((1.0, 0.0), 2048.0),
        # general region where the (log10) std is valid
        HalfSpace2D((-0.012501482876757172, -1.0), -0.5040411014606384),
        HalfSpace2D((0.0077927720025765665, 1.0), 0.7390928205510939),
        # minimum bound on the std
        HalfSpace2D((0.0, -1.0), 17.67),
    )
)

_STD_TO_SECURITY_COEFFS = (
    (6.90381015e01, 5.02853460e01, 1.94568148e01, 4.20275108e00, 5.70115313e-01,
     3.84445029e-02, 1.01123781e-03),
    (5.74446364e-01, 2.16090358e-01, 4.33027422e-02, 5.96469779e-03, 3.47705471e-05,
     -3.75600129e-05, -1.73396859e-06),
    (1.38947894e-04, -1.97798175e-06, 6.18022031e-06, -8.44553282e-06, -9.87061302e-07,
     -1.98799589e-08, 7.73239565e-10),
    (-1.76700147e-07, 4.46397961e-08, -8.48859329e-08, -6.50906497e-09, 2.29684491e-10,
     2.23006735e-11, 0.0),
    (2.73798876e-10, -4.27647020e-10, -1.56129840e-12, 5.18444880e-12, 2.50320308e-13,
     0.0, 0.0),
    (-9.58735744e-13, 1.71390444e-13, 3.36603110e-14, 1.30767385e-15, 0.0, 0.0, 0.0),
    (5.98968287e-16, 7.74296283e-17, 2.66615159e-18, 0.0, 0.0, 0.0, 0.0),
)


def lwe_security_level_to_std(dimension: int, security_level: float) -> float:
    """Noise stddev (normalized over the torus) achieving
    `security_level` bits at `dimension` (≙ `security.rs:165`).
    Valid for dims 368..=2048 and 78..=130 bits; raises
    OutsideConstraintsError outside the fit region."""
    if not _SECURITY_TO_STD_POLYTOPE.inside(float(dimension), security_level):
        raise OutsideConstraintsError(
            ("dimension", "security_level"),
            (float(dimension), security_level),
            _SECURITY_TO_STD_POLYTOPE,
        )
    log_std = evaluate_polynomial_2d(
        _SECURITY_TO_STD_COEFFS, float(dimension), security_level
    )
    return 10.0**log_std


def lwe_std_to_security_level(dimension: int, std: float) -> float:
    """Security bits for (dimension, stddev) (≙ `security.rs:244`)."""
    log_std = math.log10(std)
    if not _STD_TO_SECURITY_POLYTOPE.inside(float(dimension), log_std):
        raise OutsideConstraintsError(
            ("dimension", "log_std"),
            (float(dimension), log_std),
            _STD_TO_SECURITY_POLYTOPE,
        )
    return evaluate_polynomial_2d(_STD_TO_SECURITY_COEFFS, float(dimension), log_std)
