"""The port's host utilities against the JAX package's, on the CPU:
`spf_tpu_torch/utils/{combinatorics,security,serialization}.py` and the
security functions of `spf_tpu_torch/params.py`.

- Combinatorics: the cases of `tests/test_aux.py::TestCombinatorics`, and
  every value equal to the JAX package's.
- Security: the same values (floats equal, the same refusals) as
  `spf_tpu.utils.security` and `spf_tpu.params` on a grid of (dim, std)
  inside, outside and on the edge of the fits' polytopes, and on the named
  parameter sets.
- Serialization: each kind saved by one package loads in the other with
  the same bytes, a tensor asked back on the device named, and the three
  refusals of `tests/test_aux.py::TestSerialization`.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from spf_tpu import params as jp
from spf_tpu.utils import combinatorics as j_comb
from spf_tpu.utils import security as j_sec
from spf_tpu.utils import serialization as j_ser
from spf_tpu_torch import convert
from spf_tpu_torch import params as pp
from spf_tpu_torch.ops.torus import to_u64_np
from spf_tpu_torch.utils import combinatorics, security, serialization

torch.set_num_threads(1)


# --- combinatorics -------------------------------------------------------------------


def test_number_combinations():
    assert combinatorics.number_combinations(3, 5) == 0
    assert combinatorics.number_combinations(5, 0) == 1
    assert combinatorics.number_combinations(5, 5) == 1
    for n in range(0, 14):
        for k in range(0, n + 2):
            got = combinatorics.number_combinations(n, k)
            assert got == j_comb.number_combinations(n, k)
            assert got == (math.comb(n, k) if k <= n else 0)


@pytest.mark.parametrize("n, t", [(7, 3), (5, 1), (6, 6), (9, 4)])
def test_combination_index_round_trip(n, t):
    c, jc = combinatorics.Combinations(n, t), j_comb.Combinations(n, t)
    combos = list(itertools.combinations(range(n), t))
    assert c.number_combinations() == jc.number_combinations() == len(combos)
    for i, combo in enumerate(combos):
        assert c.get_index(list(combo)) == jc.get_index(list(combo)) == i
        assert c.at_index(i) == jc.at_index(i) == list(combo)
    assert c.at_index(len(combos)) is None
    assert list(c) == list(jc) == [list(x) for x in combos]


def test_combination_refusals():
    for args in ((0, 0), (3, 4)):
        with pytest.raises(ValueError):
            combinatorics.Combinations(*args)
    c = combinatorics.Combinations(5, 2)
    with pytest.raises(ValueError):
        c.get_index([1, 2, 3])
    with pytest.raises(ValueError):
        c.get_index([1, 5])


# --- security ------------------------------------------------------------------------


def _same(fn, jfn, *args):
    """fn and jfn give the same float, or both raise the same refusal."""
    try:
        want = jfn(*args)
    except j_sec.OutsideConstraintsError:
        with pytest.raises(security.OutsideConstraintsError):
            fn(*args)
        return "outside"
    assert fn(*args) == want
    return "inside"


def test_security_fits_equal_reference():
    """Both fits and the tail probability on a grid that crosses every
    face of both polytopes (dims 300-2200, levels 60-140, log10 std from
    -20 to 0), plus points on the faces."""
    seen = set()
    for dim in (300, 368, 386, 637, 1024, 1472, 2048, 2100):
        for level in (60.0, 78.0, 80.0, 100.0, 128.0, 130.0, 140.0):
            seen.add(_same(security.lwe_security_level_to_std, j_sec.lwe_security_level_to_std,
                           dim, level))
        for log_std in np.linspace(-20.0, 0.0, 21):
            seen.add(_same(security.lwe_std_to_security_level, j_sec.lwe_std_to_security_level,
                           dim, 10.0 ** log_std))
    for dim, std in ((386, 10.0 ** -(0.5040411014606384 + 0.012501482876757172 * 386)),
                     (2048, 10.0 ** (0.7390928205510939 - 0.0077927720025765665 * 2048)),
                     (2048, 10.0 ** -17.67)):
        seen.add(_same(security.lwe_std_to_security_level, j_sec.lwe_std_to_security_level,
                       dim, std))
    assert seen == {"inside", "outside"}
    for x, std in ((1.0, 1.0), (6.99, 1.0), (7.0, 1.0), (10.0, 1.0), (20.0, 1.0), (0.25, 0.01)):
        assert (security.probability_away_from_mean_gaussian(x, std)
                == j_sec.probability_away_from_mean_gaussian(x, std))
    assert round(10.0 ** security.probability_away_from_mean_gaussian(1.0, 1.0), 4) == 0.3173


def test_params_security_functions_equal_reference():
    """`security_level`, `assert_security_level` and `security_estimate_ok`
    as the JAX package's, on the named sets and on points inside, outside
    and on the edge of the fit (the fail-closed clamp included)."""
    band_top = 0.7390928205510939 - 0.0077927720025765665 * 2048
    points = [(pp.LWE_637_128.dim, pp.LWE_637_128.std), (pp.LWE_512_128.dim, pp.LWE_512_128.std),
              (2048, 7e-16), (2048, 1e-30), (637, 2.0**-200), (100, 0.5), (637, 0.0),
              (4096, 1e-3), (3000, 1e-16), (1024, 1e-7), (800, 1e-5),
              (2048, 10.0 ** band_top), (2048, 10.0 ** (band_top - 1e-6))]
    for dim, std in points:
        lwe, jlwe = pp.LweDef(dim, std), jp.LweDef(dim, std)
        for level in (80.0, 128.0):
            assert pp.security_estimate_ok(lwe, level) == jp.security_estimate_ok(jlwe, level)
        if std > 0:
            _same(pp.security_level, lambda _, j=jlwe: jp.security_level(j), lwe)
    std = j_sec.lwe_security_level_to_std(1024, 128.0)  # a point the fit covers
    lwe, jlwe = pp.LweDef(1024, std), jp.LweDef(1024, std)
    assert pp.security_level(lwe) == jp.security_level(jlwe)
    pp.assert_security_level(lwe, 128)
    jp.assert_security_level(jlwe, 128)
    with pytest.raises(AssertionError):
        pp.assert_security_level(lwe, 130)


def test_default_128_security():
    """Both of DEFAULT_128's instances fall outside the fit's polytope
    (l0 below its noise band, l1 at its top edge), and both pass the
    fail-closed estimate, as in the JAX package."""
    for lwe, jlwe in ((pp.DEFAULT_128.l0_params, jp.DEFAULT_128.l0_params),
                      (pp.DEFAULT_128.l1_params.as_lwe_def(),
                       jp.DEFAULT_128.l1_params.as_lwe_def())):
        assert (lwe.dim, lwe.std) == (jlwe.dim, jlwe.std)
        with pytest.raises(j_sec.OutsideConstraintsError):
            jp.security_level(jlwe)
        with pytest.raises(security.OutsideConstraintsError):
            pp.security_level(lwe)
        assert jp.security_estimate_ok(jlwe) and pp.security_estimate_ok(lwe)


# --- serialization -------------------------------------------------------------------

JP = jp.Params(
    l0_params=jp.LweDef(dim=16, std=1e-16), l1_params=jp.GlweDef(size=2, degree=32, std=1e-16),
    cbs_radix=jp.RadixDecomposition(count=2, radix_log=9),
    pbs_radix=jp.RadixDecomposition(count=2, radix_log=16),
    ks_radix=jp.RadixDecomposition(count=3, radix_log=4),
    pfks_radix=jp.RadixDecomposition(count=2, radix_log=11),
    ss_radix=jp.RadixDecomposition(count=6, radix_log=8),
    tr_radix=jp.RadixDecomposition(count=6, radix_log=7))
P = convert.param(JP)


def _arrays():
    rng = np.random.default_rng(5)
    return {kind: rng.integers(0, 2**64, shape, dtype=np.uint64)
            for kind, shape in serialization.expected_shapes(P).items()}


def test_expected_shapes_equal_reference():
    assert serialization.expected_shapes(P) == j_ser.expected_shapes(JP)


@pytest.mark.parametrize("kind", list(serialization.expected_shapes(P)))
def test_round_trip_across_packages(kind):
    """Saved by JAX, loaded by the port (numpy, and an int64 tensor on the
    CPU); saved by the port from numpy and from a tensor, loaded by JAX:
    the same bytes every way."""
    arr = _arrays()[kind]
    blob = j_ser.serialize(kind, arr, JP)
    back = serialization.deserialize(blob, kind, P)
    assert back.dtype == np.uint64 and back.tobytes() == arr.tobytes()
    t = serialization.deserialize(blob, kind, P, device="cpu")
    assert t.dtype == torch.int64 and t.device.type == "cpu"
    assert to_u64_np(t).tobytes() == arr.tobytes()
    tensor = torch.from_numpy(arr.view(np.int64).copy())
    for saved in (serialization.serialize(kind, arr, P), serialization.serialize(kind, tensor, P)):
        assert j_ser.deserialize(saved, kind, JP).tobytes() == arr.tobytes()


def test_refusals():
    """Wrong shape, an oversized payload and a kind mismatch (the JAX
    package's three), plus a tensor that is not int64 and an unknown kind."""
    bad = np.zeros((3, 3), dtype=np.uint64)
    with pytest.raises(serialization.DeserializationError):
        serialization.serialize("glwe1", bad, P)
    blob = serialization.serialize("glwe1", np.zeros((3, 32), dtype=np.uint64), P)
    with pytest.raises(serialization.DeserializationError):
        serialization.deserialize(blob + b"\x00" * (1 << 20), "glwe1", P)
    blob = serialization.serialize("lwe0_sk", np.zeros(16, dtype=np.uint64), P)
    with pytest.raises(serialization.DeserializationError):
        serialization.deserialize(blob, "lwe0", P)
    with pytest.raises(serialization.DeserializationError):
        serialization.serialize("glwe1", torch.zeros((3, 32), dtype=torch.int32), P)
    with pytest.raises(serialization.DeserializationError):
        serialization.deserialize(blob, "bsk", P)
