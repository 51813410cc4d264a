"""The u64 API's operations on wrapping int64 tensors, batch first.

Ports of the JAX package's u64 family, under the reference's own module
names. The port's `ops/` already holds the limb and ds32 families
(`ops/torus.py` ≙ `limb32`/`torus`, `ops/encryption.py` ≙
`encryption_u32`, `ops/keyswitch.py` ≙ `keyswitch_u32`, ...), so this
family lives here:

- `torus`         ≙ `spf_tpu/ops/torus.py`
- `rng`           ≙ `spf_tpu/ops/rng.py` (an explicit `torch.Generator`)
- `decomp`        ≙ `spf_tpu/ops/decomp.py`
- `poly`          ≙ `spf_tpu/ops/poly.py`
- `ciphertext`    ≙ `spf_tpu/ops/ciphertext.py`
- `encryption`    ≙ `spf_tpu/ops/encryption.py`
- `fft`           ≙ `spf_tpu/ops/fft.py` (the c128 backend, `torch.fft`)
- `fft_ops`       ≙ `spf_tpu/ops/fft_ops.py`
- `keyswitch`     ≙ `spf_tpu/ops/keyswitch.py`
- `scheme_switch` ≙ `spf_tpu/ops/scheme_switch.py`
- `automorphism`  ≙ `spf_tpu/ops/automorphism.py`
- `bootstrap`     ≙ `spf_tpu/ops/bootstrap.py`
- `cbs`           ≙ `spf_tpu/ops/cbs.py`

A torus element is one `torch.int64` whose bits are the u64's. Layouts
are the reference's, with leading batch dims: LWE [..., n+1], GLWE
[..., k+1, N], GLEV [..., l, k+1, N], GGSW [..., k+1, l, k+1, N];
frequency-domain values are complex128 [..., N/2]. Where a function is
one the port already has (the LWE keyswitch, `decompose`, `shr_round`,
the binary-key products and the samplers), these modules call it.

The JAX package computes this family outside any Pallas kernel (the c128
backend is `jnp.fft` plus elementwise products), so it has no kernel of
its own here either: `torch.fft` and elementwise PyTorch on the card.
"""
