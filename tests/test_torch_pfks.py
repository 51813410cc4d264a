"""The functional keyswitches and CBS v1 (`spf_tpu_torch/ops/u64/pfks.py`)
against the JAX package's (`spf_tpu/ops/pfks.py`), on the CPU.

The four cases of `tests/test_pfks.py` (identity map, two-slot map,
public identity, the CBS-PFKS selector) on the JAX package's keys, carried
across by `convert.functional_keyswitch_key`, at sizes below that test's
(LWE dim 16, GLWE k = 2, N = 32, noise 1e-16): the JAX key generation
loops in Python over every key row (786 GLWE encryptions for the four
keys), so the keys are made once for the module, each row's encryption
and the CBS-PFKS map's negacyclic product jitted (the JAX package's own
functions, bit for bit with their eager runs: integer arithmetic and the
same jax.random stream; eagerly they took ~20 ms a row here).

- Bit for bit: the integer functions (the scalar digits and MAD, the
  private keyswitch, `extract_and_rotate`) on the same inputs.
- Within TOL = 2^32 as int64: the c128 public keyswitch (XLA's FFT and
  pocketfft agree to a few ulps, as `tests/test_torch_u64.py` holds).
- By decryption in the port: every keyswitch, and the CBS-PFKS selector
  (its GGSW through a CMux picks the right GLWE for both bits).
- The port's own key generation (its random stream differs from
  jax.random's): every row decrypts to the plaintext that the same row of
  the JAX package's key decrypts to, within the noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spf_tpu.ops import encryption as j_enc
from spf_tpu.ops import pfks as j_pfks
from spf_tpu.ops import poly as j_poly
from spf_tpu.params import GlweDef as JGlweDef
from spf_tpu.params import LweDef as JLweDef
from spf_tpu.params import RadixDecomposition as JRadix
from spf_tpu_torch import convert
from spf_tpu_torch.ops import torus as port_torus
from spf_tpu_torch.ops.u64 import encryption as enc
from spf_tpu_torch.ops.u64 import fft_ops, pfks
from spf_tpu_torch.ops.u64 import torus as t64
from spf_tpu_torch.params import GlweDef, LweDef, RadixDecomposition

torch.set_num_threads(1)

KEY = jax.random.key(555)
TOL = 2.0**32
ROW_NOISE = 2.0**20  # two Gaussian draws of std 1e-16 * 2^64 ~ 2^10.85 each
LWE = LweDef(dim=16, std=1e-16)
GLWE = GlweDef(size=2, degree=32, std=1e-16)
RADIX = RadixDecomposition(count=3, radix_log=11)
PBS_RADIX = RadixDecomposition(count=2, radix_log=16)
CBS_RADIX = RadixDecomposition(count=2, radix_log=9)
J_LWE = JLweDef(dim=LWE.dim, std=LWE.std)
J_GLWE = JGlweDef(size=GLWE.size, degree=GLWE.degree, std=GLWE.std)
J_RADIX = JRadix(count=RADIX.count, radix_log=RADIX.radix_log)
N = GLWE.degree


# The JAX package's integer functions that the tests call many times,
# jitted: the same bits as eagerly, one compile a shape instead of an eager
# gather and MAD per key row
J_PRIVATE_KEYSWITCH = jax.jit(j_pfks.private_functional_keyswitch, static_argnums=(2, 3, 4))
J_EXTRACT_AND_ROTATE = jax.jit(j_pfks.extract_and_rotate, static_argnums=(1, 2))
# its c128 public keyswitch too: held within TOL, which a jitted FFT's last
# ulps do not approach
J_PUBLIC_KEYSWITCH = jax.jit(j_pfks.public_functional_keyswitch, static_argnums=(2, 3, 4, 5))


def k(i):
    return jax.random.fold_in(KEY, i)


def tt(a) -> torch.Tensor:
    """A jnp or numpy u64 array -> int64 tensor."""
    return port_torus.from_u64_np(np.asarray(a).astype(np.uint64))


def same(got: torch.Tensor, want) -> bool:
    return got.shape == tuple(np.shape(want)) and np.array_equal(
        port_torus.to_u64_np(got), np.asarray(want).astype(np.uint64))


def j_id_map(slots):
    return jnp.zeros((N,), dtype=jnp.uint64).at[0].set(slots[0])


def j_two_map(slots):
    return jnp.zeros((N,), dtype=jnp.uint64).at[0].set(slots[0]).at[1].set(slots[1])


def id_map(slots):
    """The port's maps take leading batch dims: [..., lwe_count] -> [..., N]."""
    return pfks.constant_map(slots, N)


def two_map(slots):
    out = id_map(slots)
    out[..., 1] = slots[..., 1]
    return out


@pytest.fixture(scope="module")
def keys():
    """The JAX package's secret keys and functional keyswitch keys (the
    reference test's seeds), and each carried across."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_enc, "encrypt_glwe", jax.jit(j_enc.encrypt_glwe, static_argnums=3))
        mp.setattr(j_poly, "negacyclic_mul_exact", jax.jit(j_poly.negacyclic_mul_exact))
        return _jax_keys()


def _jax_keys():
    lwe_sk = j_enc.generate_lwe_sk(k(0), J_LWE)
    glwe_sk = j_enc.generate_glwe_sk(k(1), J_GLWE)
    j = dict(
        private=j_pfks.generate_private_functional_keyswitch_key(
            k(2), lwe_sk, glwe_sk, j_id_map, J_LWE, J_GLWE, J_RADIX, 1),
        two=j_pfks.generate_private_functional_keyswitch_key(
            k(20), lwe_sk, glwe_sk, j_two_map, J_LWE, J_GLWE, J_RADIX, 2),
        public=j_pfks.generate_public_functional_keyswitch_key(
            k(30), lwe_sk, glwe_sk, J_LWE, J_GLWE, J_RADIX),
        cbs_pfks=j_pfks.generate_cbs_pfks_keys(
            k(41), j_enc.glwe_sk_to_lwe_sk(glwe_sk), glwe_sk, J_GLWE.as_lwe_def(), J_GLWE,
            J_RADIX))
    port = {name: convert.functional_keyswitch_key(
        np.asarray(key), "private" if name == "two" else name, "cpu") for name, key in j.items()}
    lwe_sk_t, glwe_sk_t = convert.secret_keys(lwe_sk, glwe_sk, "cpu")
    return dict(j=j, port=port, j_lwe_sk=lwe_sk, j_glwe_sk=glwe_sk, lwe_sk=lwe_sk_t,
                glwe_sk=glwe_sk_t)


def _lwe_inputs(keys, msgs, seed):
    """LWE encryptions of 2-bit messages under the carried LWE key, made in
    the port, int64 [len(msgs), n+1] (handed to JAX as numpy)."""
    gen = torch.Generator().manual_seed(seed)
    return enc.encrypt_lwe(gen, t64.encode(torch.tensor(msgs), 2), keys["lwe_sk"], LWE)


def test_scalar_helpers_bit_for_bit():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**64, (3, 17), dtype=np.uint64)
    assert same(pfks._scalar_digits(tt(x), RADIX), j_pfks._scalar_digits(jnp.asarray(x), J_RADIX))
    acc, glwe = (rng.integers(0, 2**64, (3, N), dtype=np.uint64) for _ in range(2))
    scalar = np.int64(-517)
    want = j_pfks._glwe_scalar_mad(jnp.asarray(acc), jnp.asarray(glwe), jnp.asarray(scalar))
    assert same(pfks._glwe_scalar_mad(tt(acc), tt(glwe), torch.tensor(scalar)), want)


@pytest.mark.parametrize("name, map_fn, msgs", [
    ("private", id_map, [[0], [1], [2], [3]]),
    ("two", two_map, [[2, 3], [1, 0]]),
])
def test_private_keyswitch(keys, name, map_fn, msgs):
    """The reference test's identity and two-slot maps: bit for bit with
    JAX on the same key and inputs, and decrypting to the messages."""
    cts = _lwe_inputs(keys, msgs, seed=len(msgs[0]))  # [cases, lwe_count, n+1]
    key = keys["port"][name]
    out = pfks.private_functional_keyswitch(cts, key, LWE, GLWE, RADIX)
    for c, m in zip(range(len(msgs)), msgs):
        want = J_PRIVATE_KEYSWITCH(
            jnp.asarray(port_torus.to_u64_np(cts[c])), keys["j"][name], J_LWE, J_GLWE, J_RADIX)
        assert same(out[c], want)
        dec = t64.decode(enc.decrypt_glwe(out[c], keys["glwe_sk"], GLWE), 2)
        assert dec[:len(m)].tolist() == m and not dec[len(m):].any()


def test_public_keyswitch_identity(keys):
    """The c128 public keyswitch within TOL of JAX's, decrypting right."""
    for msg in (1, 3):
        ct = _lwe_inputs(keys, [[msg]], seed=30 + msg)[0]
        out = pfks.public_functional_keyswitch(ct, keys["port"]["public"], id_map, LWE, GLWE,
                                               RADIX)
        want = tt(J_PUBLIC_KEYSWITCH(
            jnp.asarray(port_torus.to_u64_np(ct)), keys["j"]["public"], j_id_map, J_LWE, J_GLWE,
            J_RADIX))
        assert float((out - want).abs().max()) <= TOL
        assert int(t64.decode(enc.decrypt_glwe(out, keys["glwe_sk"], GLWE), 2)[0]) == msg


@pytest.mark.parametrize("name", ["private", "two", "public", "cbs_pfks"])
def test_keygen_rows_match_jax_key(keys, name):
    """The port's key: the shape of the JAX package's, and every row
    decrypting to the plaintext of the same row of the JAX key, within
    two draws of the noise."""
    gen = torch.Generator().manual_seed(7)
    lwe_sk, glwe_sk = keys["lwe_sk"], keys["glwe_sk"]
    if name in ("private", "two"):
        got = pfks.generate_private_functional_keyswitch_key(
            gen, lwe_sk, glwe_sk, id_map if name == "private" else two_map, LWE, GLWE, RADIX,
            1 if name == "private" else 2)
    elif name == "public":
        got = pfks.generate_public_functional_keyswitch_key(gen, lwe_sk, glwe_sk, LWE, GLWE,
                                                            RADIX)
    else:
        got = pfks.generate_cbs_pfks_keys(gen, enc.glwe_sk_to_lwe_sk(glwe_sk), glwe_sk,
                                          GLWE.as_lwe_def(), GLWE, RADIX)
    want = keys["port"][name]
    assert got.shape == want.shape
    diff = enc.decrypt_glwe(got, glwe_sk, GLWE) - enc.decrypt_glwe(want, glwe_sk, GLWE)
    assert float(diff.abs().max()) < ROW_NOISE


def test_cbs_pfks_selector(keys):
    """CBS v1 of both bits in one batched call: `extract_and_rotate` and
    each GGSW row's private keyswitch bit for bit with JAX on the same
    intermediate (the port's multi-function PBS output), the whole
    `circuit_bootstrap_via_pfks` equal to those steps, and its GGSW
    through a CMux selecting the right GLWE for each bit."""
    gen = torch.Generator().manual_seed(40)
    lwe_sk, glwe_sk = keys["lwe_sk"], keys["glwe_sk"]
    bsk = pfks.generate_bootstrap_key(gen, lwe_sk, glwe_sk, LWE, GLWE, PBS_RADIX)
    cbsksk = keys["port"]["cbs_pfks"]
    bits = [0, 1]
    ct = enc.encrypt_lwe(gen, t64.encode(torch.tensor(bits), 1), lwe_sk, LWE)
    lo = pfks.hi_noise_lwe_to_lo_noise_glwe(ct, bsk, LWE, GLWE, PBS_RADIX, CBS_RADIX)
    lwes = pfks.extract_and_rotate(lo, GLWE, CBS_RADIX)  # [2, l, k*N+1]
    j_cbs_radix = JRadix(count=CBS_RADIX.count, radix_log=CBS_RADIX.radix_log)
    from_lwe = GLWE.as_lwe_def()
    j_from = J_GLWE.as_lwe_def()
    rows = torch.stack([pfks.private_functional_keyswitch(lwes[..., None, :], cbsksk[j], from_lwe,
                                                          GLWE, RADIX)
                        for j in range(GLWE.size + 1)], dim=-4)
    for b in range(len(bits)):
        j_lwes = J_EXTRACT_AND_ROTATE(jnp.asarray(port_torus.to_u64_np(lo[b])), J_GLWE,
                                      j_cbs_radix)
        assert same(lwes[b], j_lwes)
        for j in range(GLWE.size + 1):
            for i in range(CBS_RADIX.count):
                assert same(rows[b, j, i], J_PRIVATE_KEYSWITCH(
                    j_lwes[i][None, :], keys["j"]["cbs_pfks"][j], j_from, J_GLWE, J_RADIX))
    ggsw = pfks.circuit_bootstrap_via_pfks(ct, bsk, cbsksk, LWE, GLWE, GLWE, PBS_RADIX,
                                           CBS_RADIX, RADIX)
    assert torch.equal(ggsw, rows)
    c0 = enc.encrypt_glwe(gen, t64.encode(torch.zeros(N, dtype=torch.int64), 1), glwe_sk, GLWE)
    c1 = enc.encrypt_glwe(gen, t64.encode(torch.ones(N, dtype=torch.int64), 1), glwe_sk, GLWE)
    out = fft_ops.cmux(c0, c1, fft_ops.ggsw_to_fft(ggsw), GLWE, CBS_RADIX)
    dec = t64.decode(enc.decrypt_glwe(out, glwe_sk, GLWE), 1)
    for b, bit in enumerate(bits):
        assert (dec[b] == bit).all(), f"bit={bit}"


def test_convert_rejects_other_keys():
    with pytest.raises(ValueError):
        convert.functional_keyswitch_key(np.zeros((2, 3, 4, 5), dtype=np.uint64), "private", "cpu")
    with pytest.raises(ValueError):
        convert.functional_keyswitch_key(np.zeros((2, 3, 4, 5), dtype=np.complex128), "public",
                                         "cpu")
    got = convert.functional_keyswitch_key(np.full((1, 2, 3, 4, 5), 2**63 + 5, dtype=np.uint64),
                                           "private", "cpu")
    assert got.dtype == torch.int64 and int(got[0, 0, 0, 0, 0]) == -(2**63) + 5

