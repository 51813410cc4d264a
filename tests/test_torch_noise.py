"""Empirical noise measurement (`spf_tpu_torch/utils/noise.py`) and its
entry point (`spf_tpu_torch/scripts/op_noise.py`) against the JAX
package's (`spf_tpu/utils/noise.py`), on the CPU at N = 64.

- The statistics functions (host math) on the same inputs as JAX's,
  within REL = 1e-12.
- `measure_noise_ggsw` on one GGSW carried across: the same f64 values.
- `measure_encryption_noise` and `measure_cmux_noise` on the JAX
  package's secret key carried across (`convert.secret_key`): each log2
  std within 1 bit of JAX's, under the bounds of
  `tests/test_aux.py::TestNoise`. The two packages draw their randomness
  from different generators, so their samples differ; their spread must
  not. The JAX side runs its GLWE encryption and CMux jitted (the
  encryption gives the same bits as eagerly; the CMux's FFT moves by
  ulps, far below the noise).
- The keyswitch, CBS-then-CMux, CMux-tree and scheme-switch search in the
  port alone, held to the bounds of `tests/test_aux.py`'s cases (a JAX
  CBS costs far more than this file's time).
- `op_noise.measure` on the CPU gives the example's rows.

DEFAULT_128 noise runs on the card only (`chip_smoke.py` path 10).
"""

import types

import jax
import numpy as np
import pytest
import torch

from spf_tpu.ops import encryption as j_enc_ops
from spf_tpu.ops import fft_ops as j_fft_ops
from spf_tpu.ops.fft import C128 as J_C128
from spf_tpu import params as jparams
from spf_tpu.params import noise_exponent_at_depth
from spf_tpu.runtime.encryption import Encryption as JEncryption
from spf_tpu.runtime.keys import SecretKey as JSecretKey
from spf_tpu.utils import noise as j_noise
from spf_tpu_torch import convert
from spf_tpu_torch.ops.u64 import encryption as enc
from spf_tpu_torch.ops.torus import to_u64_np
from spf_tpu_torch.runtime.evaluation import Evaluation
from spf_tpu_torch.runtime.keys import ComputeKey
from spf_tpu_torch.scripts import op_noise
from spf_tpu_torch.utils import noise

torch.set_num_threads(1)

REL = 1e-12
JP = jparams.Params(
    l0_params=jparams.LweDef(dim=16, std=1e-16),
    l1_params=jparams.GlweDef(size=1, degree=64, std=1e-16),
    cbs_radix=jparams.RadixDecomposition(count=2, radix_log=9),
    pbs_radix=jparams.RadixDecomposition(count=2, radix_log=16),
    ks_radix=jparams.RadixDecomposition(count=9, radix_log=4),
    pfks_radix=jparams.RadixDecomposition(count=4, radix_log=11),
    ss_radix=jparams.RadixDecomposition(count=6, radix_log=8),
    tr_radix=jparams.RadixDecomposition(count=6, radix_log=7),
)  # examples/op_noise.py's PARAMS at N = 64, n0 = 16
P = convert.param(JP)
KEY = jax.random.key(313)


@pytest.fixture(scope="module")
def keys():
    """The JAX package's secret key, carried across, and a port evaluation
    on its compute key made from it on the CPU."""
    jsk = JSecretKey.generate(KEY, JP)
    sk = convert.secret_key(jsk, "cpu")
    gen = torch.Generator().manual_seed(313)
    ev = Evaluation(ComputeKey.generate(gen, sk, P), P, precompute_constants=False,
                    device="cpu")
    return dict(jp=JP, jsk=jsk, sk=sk, ev=ev)


def _close(a, b):
    assert abs(a - b) <= REL * max(abs(a), abs(b)), (a, b)


def test_statistics_equal_reference():
    rng = np.random.default_rng(3)
    xs = rng.normal(5.0, 2.0, 1000)
    rs, jrs = noise.RunningStats(), j_noise.RunningStats()
    for x in xs:
        rs.add_sample(float(x))
        jrs.add_sample(float(x))
    assert rs.count == jrs.count == 1000
    for f in ("mean", "variance", "std"):
        _close(getattr(rs, f)(), getattr(jrs, f)())
    _close(rs.std(), float(xs.std()))
    errs = rng.integers(-(2**40), 2**40, 4096)
    got, want = noise._stats("op", torch.from_numpy(errs)), j_noise._stats("op", errs)
    assert (got.op, got.samples) == (want.op, want.samples)
    _close(got.log2_std, want.log2_std)
    _close(got.log2_max, want.log2_max)
    for std in (1e-3, 0.01, 0.05, 0.1, 0.2):
        _close(noise.log2_failure_probability_binary(std),
               j_noise.log2_failure_probability_binary(std))
    depths = np.array([16, 64, 128, 256, 512, 1024, 2048, 4096])
    vals = np.array([noise_exponent_at_depth(d) for d in depths])
    got, want = noise.fit_noise_vs_depth(depths, vals), j_noise.fit_noise_vs_depth(depths, vals)
    for g, w in zip(got, want):
        _close(g, w)
    a, b, c = got
    pred = -1.0 / (a * (1024 + b)) + c
    assert abs(pred - noise_exponent_at_depth(1024)) < 0.03 * abs(noise_exponent_at_depth(1024))


def test_measure_noise_ggsw_exact(keys):
    """One GGSW of 1 made by the port, read by both packages: the same
    normalized distances, and u64_mul_shift the same bits."""
    gen = torch.Generator().manual_seed(9)
    ggsw = enc.encrypt_ggsw_scalar(gen, 1, keys["sk"].glwe_1, P.l1_params, P.cbs_radix)
    got = noise.measure_noise_ggsw(ggsw, keys["sk"].glwe_1, P.l1_params, P.cbs_radix)
    want = j_noise.measure_noise_ggsw(jax.numpy.asarray(to_u64_np(ggsw)), keys["jsk"].glwe_1,
                                      keys["jp"].l1_params, keys["jp"].cbs_radix)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, np.asarray(want))
    msg = np.random.default_rng(2).integers(0, 2**64, 64, dtype=np.uint64)
    for shift in (0, 1, 46, 63):
        np.testing.assert_array_equal(
            to_u64_np(noise.u64_mul_shift(torch.from_numpy(msg.view(np.int64)), shift)),
            np.asarray(j_noise.u64_mul_shift(jax.numpy.asarray(msg), shift)))


def test_encryption_and_cmux_noise_near_reference(keys, monkeypatch):
    jp, jsk, sk, ev = keys["jp"], keys["jsk"], keys["sk"], keys["ev"]
    monkeypatch.setattr(j_enc_ops, "encrypt_glwe",
                        jax.jit(j_enc_ops.encrypt_glwe, static_argnums=3))
    monkeypatch.setattr(j_fft_ops, "cmux", jax.jit(j_fft_ops.cmux, static_argnums=(3, 4, 5)))
    gen = torch.Generator().manual_seed(7)
    got = noise.measure_encryption_noise(gen, sk, P)
    want = j_noise.measure_encryption_noise(jax.random.fold_in(KEY, 7), jsk, jp)
    assert got.samples == want.samples == 32 * 64
    assert 9.5 < got.log2_std < 12.5 and abs(got.log2_std - want.log2_std) <= 1.0, (got, want)

    got = noise.measure_cmux_noise(gen, sk, ev, P, depth=4, trials=2)
    jev = types.SimpleNamespace(enc=JEncryption(jp), be=J_C128)
    want = j_noise.measure_cmux_noise(jax.random.fold_in(KEY, 8), jsk, jev, jp, depth=4,
                                      trials=2)
    assert [s.op for s in got] == [s.op for s in want] == [f"cmux_depth_{d}" for d in (1, 2, 3, 4)]
    assert all(s.log2_max < 55 for s in got), got
    assert got[-1].log2_std >= got[0].log2_std - 1.0
    for g, w in zip(got, want):
        assert g.samples == w.samples and abs(g.log2_std - w.log2_std) <= 1.0, (g, w)


def test_keyswitch_and_cbs_noise(keys):
    """Noise far below the message bit (2^63), as op_noise reports it."""
    gen = torch.Generator().manual_seed(11)
    ks = noise.measure_keyswitch_noise(gen, keys["sk"], keys["ev"], P)
    cbs = noise.measure_cbs_noise(gen, keys["sk"], keys["ev"], P, trials=2)
    assert (ks.op, ks.samples) == ("keyswitch_l1_l0", 16)
    assert (cbs.op, cbs.samples) == ("cbs_then_cmux", 2 * 64)
    assert ks.log2_max < 55 and cbs.log2_max < 55, (ks, cbs)


def test_cmux_tree_and_scheme_switch_search(keys):
    """The cases of tests/test_aux.py::TestNoiseTooling at N = 64."""
    gen = torch.Generator().manual_seed(21)
    sk, ev = keys["sk"], keys["ev"]
    levels = noise.measure_cmux_tree_noise(gen, sk.glwe_1, P.l1_params, P.cbs_radix, ev.be,
                                           depth=3, trials=1)
    assert [lv.depth for lv in levels] == [1, 2, 3]
    assert all(lv.log2_failure_probability < -100 for lv in levels)
    assert levels[-1].log2_std >= levels[0].log2_std - 1.0
    res = noise.search_scheme_switch(gen, sk.glwe_1, P.l1_params, P.cbs_radix, radix_logs=[4, 8],
                                     counts=[6], trials=1, be=ev.be)
    assert len(res) == 2
    by_log = {r["ss_radix_log"]: r for r in res}
    assert by_log[8]["log2_out_std"] <= by_log[4]["log2_out_std"] + 1.0, res
    assert all(np.isfinite(r["log2_out_std"]) for r in res)


def test_fold_in_is_a_function_of_seed_and_data():
    gen = torch.Generator().manual_seed(5)
    a = torch.randint(0, 2**31, (4,), generator=noise.fold_in(gen, 3))
    torch.rand(8, generator=gen)  # the caller's state does not enter
    assert torch.equal(a, torch.randint(0, 2**31, (4,), generator=noise.fold_in(gen, 3)))
    assert not torch.equal(a, torch.randint(0, 2**31, (4,), generator=noise.fold_in(gen, 4)))
    assert noise.fold_in(noise.fold_in(gen, 1), 2).initial_seed() != noise.fold_in(
        noise.fold_in(gen, 2), 1).initial_seed()
    zero = torch.Generator().manual_seed(0)  # mix64's fixed point: a fold is still fresh
    assert noise.fold_in(zero, 0).initial_seed() != 0
    assert not torch.equal(torch.randint(0, 2**31, (4,), generator=noise.fold_in(zero, 0)),
                           torch.randint(0, 2**31, (4,), generator=zero))


def test_op_noise_rows_on_the_cpu():
    rows = op_noise.measure(P, depth=3, trials=2, device="cpu")
    assert [r["op"] for r in rows] == ["glwe_encryption", "keyswitch_l1_l0", "cmux_depth_1",
                                       "cmux_depth_2", "cmux_depth_3", "cbs_then_cmux"]
    assert all(set(r) == {"op", "samples", "log2_std", "log2_max"} for r in rows)
    assert all(r["log2_max"] < 55 for r in rows), rows
