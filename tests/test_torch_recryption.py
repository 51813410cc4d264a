"""The one-time pad (`spf_tpu_torch/runtime/recryption.py`) against the
JAX package's (`spf_tpu/runtime/recryption.py`), on the CPU, at the
parameters of `tests/test_aux.py` (k = 1, N = 256, noise 1e-16).

The case of `tests/test_aux.py::TestRecryption`: the pad operations bit
for bit with JAX on the same numpy inputs, and the round trip in the port
(encrypt, generate the pad under the public key, recrypt, decrypt: the
decrypting party sees msg XOR pad, the pad holder recovers msg). The pad
itself comes from the port's generator (its stream differs from
jax.random's): it is binary and its public half decrypts to it.
"""

import jax.numpy as jnp
import numpy as np
import torch

from spf_tpu.runtime import recryption as j_rec
from spf_tpu_torch.ops import torus as port_torus
from spf_tpu_torch.params import GlweDef, LweDef, Params, RadixDecomposition
from spf_tpu_torch.runtime import (Encryption, PublicKey, PublicOneTimePad, SecretKey,
                                   SecretOneTimePad, decrypt_one_time_pad,
                                   generate_one_time_pad, recrypt_one_time_pad)

torch.set_num_threads(1)

P = Params(
    l0_params=LweDef(dim=128, std=1e-16),
    l1_params=GlweDef(size=1, degree=256, std=1e-16),
    cbs_radix=RadixDecomposition(count=2, radix_log=9),
    pbs_radix=RadixDecomposition(count=2, radix_log=16),
    ks_radix=RadixDecomposition(count=9, radix_log=4),
    pfks_radix=RadixDecomposition(count=4, radix_log=11),
    ss_radix=RadixDecomposition(count=6, radix_log=8),
    tr_radix=RadixDecomposition(count=6, radix_log=7),
)
N = P.l1_params.degree


def test_pad_operations_bit_for_bit():
    """recrypt (wrapping addition of the pad's GLWE) and decrypt (the pad's
    bits added mod 2) on the same numpy inputs as JAX."""
    rng = np.random.default_rng(3)
    x, ct = (rng.integers(0, 2**64, (2, N), dtype=np.uint64) for _ in range(2))
    got = recrypt_one_time_pad(port_torus.from_u64_np(x),
                               PublicOneTimePad(ct=port_torus.from_u64_np(ct)))
    want = j_rec.recrypt_one_time_pad(jnp.asarray(x), j_rec.PublicOneTimePad(ct=jnp.asarray(ct)))
    np.testing.assert_array_equal(port_torus.to_u64_np(got), np.asarray(want))
    bits, pad = (rng.integers(0, 2, N, dtype=np.uint64) for _ in range(2))
    got = decrypt_one_time_pad(torch.from_numpy(bits.astype(np.int64)),
                               SecretOneTimePad(key=torch.from_numpy(pad.astype(np.int64))))
    want = j_rec.decrypt_one_time_pad(jnp.asarray(bits), j_rec.SecretOneTimePad(key=jnp.asarray(pad)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), np.asarray(want))


def test_otp_roundtrip():
    gen = torch.Generator().manual_seed(909)
    sk = SecretKey.generate(gen, P)
    pk = PublicKey.generate(gen, sk, P)
    enc = Encryption(P, device="cpu")
    msg = torch.from_numpy(np.random.default_rng(3).integers(0, 2, N).astype(np.int64))
    ct = enc.encrypt_glwe_l1(gen, msg, sk)
    public, secret = generate_one_time_pad(gen, enc, pk)
    assert public.ct.shape == (2, N) and set(secret.key.tolist()) == {0, 1}
    assert torch.equal(enc.decrypt_glwe_l1(public.ct, sk), secret.key)
    padded = enc.decrypt_glwe_l1(recrypt_one_time_pad(ct, public), sk)
    # the decrypting party sees only msg ^ pad...
    assert torch.equal(padded, msg ^ secret.key) and not torch.equal(padded, msg)
    # ...and the pad holder recovers the message
    assert torch.equal(decrypt_one_time_pad(padded, secret), msg)
