"""The port's in-loop phase generator (`ops/phase_rot.py`:
`phase_minus_one` and its plain versions) against the JAX package, at
N = 64 (K = 32).

- Bit for bit (subnormals flushed while comparing, ROADMAP Queue 3) with
  `spf_tpu.ops.phase_rot.phase_minus_one` run op by op (it is not jitted):
  natural order, `perm = scrambled_perm(32)` and `bit_images`, at B = 8
  with t at its edges and beyond 2N.
- Within the tolerance of `tests/test_phase_rot.py` (atol 1e-5 per plane,
  1e-11 on the complex value) of `phase_minus_one_pallas(interpret=True)`
  at B = 128: the interpret call is jitted and XLA:CPU contracts.
- The permuted result is the natural one gathered by `perm`, exactly.
- `phase_minus_one_outer`, `seed_factors` and `scrambled_perm` equal the
  JAX functions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spf_tpu.ops import phase_rot as jpr
from spf_tpu_torch.ops import phase_rot

torch.set_num_threads(1)

N = 64
K = N // 2


@pytest.fixture(autouse=True)
def _flush_denormals():
    """XLA:CPU flushes subnormal f32 values to zero; PyTorch keeps them
    (see tests/test_torch_ops.py)."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _ts(b):
    """t values for B columns: the edges {0, 1, N-1, N, 2N-1}, values >= 2N
    (only t mod 2N counts), the rest random below 2N."""
    rng = np.random.default_rng(7)
    t = rng.integers(0, 2 * N, b).astype(np.int64)
    edges = [0, 1, N - 1, N, 2 * N - 1, 2 * N, 5 * N + 3, (1 << 32) - 1][:b]
    t[:len(edges)] = edges
    return t


def _both(fn_j, fn_t, t, *args, **kw):
    want = fn_j(jnp.asarray(t.astype(np.uint32)), N, *args, **kw)
    got = fn_t(torch.from_numpy(t), N, *args, **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_bits(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


def test_scrambled_perm_matches_reference():
    np.testing.assert_array_equal(phase_rot.scrambled_perm(K), jpr.scrambled_perm(K))


def test_seed_factors_match_reference():
    t = _ts(8)
    want_c, want_q = jpr._seed_factors(jnp.asarray(t.astype(np.uint32)), N)
    got_c, got_q = phase_rot.seed_factors(torch.from_numpy(t), N)
    _assert_bits([g.numpy() for g in got_c + got_q],
                 [np.asarray(w) for w in want_c + want_q])


@pytest.mark.parametrize("order", ["natural", "perm", "bit_images"])
def test_phase_minus_one_plain_matches_reference(order):
    kw = {"perm": phase_rot.scrambled_perm(K)} if order == "perm" else (
        {"bit_images": phase_rot.backend_bit_images(N)} if order == "bit_images" else {})
    want, got = _both(jpr.phase_minus_one, phase_rot.phase_minus_one_plain, _ts(8), **kw)
    _assert_bits(got, want)


def test_phase_minus_one_outer_matches_reference():
    want, got = _both(jpr.phase_minus_one_outer, phase_rot.phase_minus_one_outer, _ts(8),
                      bit_images=phase_rot.backend_bit_images(N))
    _assert_bits(got, want)


def _c128(planes):
    return (planes[0].astype(np.float64) + planes[1]) + 1j * (
        planes[2].astype(np.float64) + planes[3])


def test_phase_minus_one_plain_matches_pallas_interpret():
    t = _ts(128)
    want = [np.asarray(w) for w in jpr.phase_minus_one_pallas(
        jnp.asarray(t.astype(np.uint32)), N, interpret=True)]
    got = [g.numpy() for g in phase_rot.phase_minus_one_plain(torch.from_numpy(t), N)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    assert np.abs(_c128(got) - _c128(want)).max() < 1e-11


@pytest.mark.parametrize("b", [8, 128])
def test_permuted_is_natural_gathered(b):
    t = torch.from_numpy(_ts(b))
    perm = phase_rot.scrambled_perm(K)
    nat = phase_rot.phase_minus_one(t, N)  # the wrapper: the plain version on the CPU
    per = phase_rot.phase_minus_one(t, N, perm)
    for p, q in zip(per, nat):
        assert torch.equal(p.view(torch.int32), q[torch.from_numpy(perm.astype(np.int64))]
                           .view(torch.int32))


def test_phase_minus_one_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        phase_rot.phase_minus_one(torch.zeros(8, dtype=torch.int64, device="meta"), N)
