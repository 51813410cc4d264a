"""Private and public functional keyswitching, and circuit bootstrapping
v1 (via PFKS).

Port of `spf_tpu/ops/pfks.py` (≙ `sunscreen_tfhe/src/ops/keyswitch/
private_functional_keyswitch.rs`, `public_functional_keyswitch.rs` and
`ops/bootstrapping/circuit_bootstrapping.rs:100-219`, the classic
CGGI-style circuit bootstrap kept beside the default WHS+24 one in
`cbs.py`).

A functional keyswitch maps `lwe_count` LWE ciphertexts to one GLWE
ciphertext while applying an R-Lipschitzian morphism f: T_q^p -> T_q[X];
in the private variant the morphism is baked (secretly) into the key.

`map_fn(slots)` takes torus values int64 [..., lwe_count] and returns
torus polynomials int64 [..., N]: the reference's map with leading batch
dims, so that a key's rows are made in one call.

Where the reference loops in Python over every key row, the port batches:
key generation is one GLWE encryption of all (z, i, j) rows, and the
private keyswitch one product-sum over (z, i, j), exact mod 2^64 (the
LWE keyswitch's 16-bit plane products, `keyswitch.plane_product_sum`),
so its order changes no bit. The public keyswitch's frequency-domain
sum keeps the reference's order over (i, j).
Random numbers come from an explicit `torch.Generator` (the streams
differ from jax.random's: tests carry the JAX package's keys across).
"""

from __future__ import annotations

import torch

from ...params import GlweDef, LweDef, RadixDecomposition
from . import encryption as enc
from .bootstrap import generate_bootstrap_key  # noqa: F401  (re-exported, as the reference)
from .cbs import hi_noise_lwe_to_lo_noise_glwe
from .ciphertext import lwe_rotate, sample_extract
from .decomp import decompose, decomposition_factor
from .fft import C128
from .keyswitch import key_planes, plane_product_sum
from .poly import negacyclic_mul_exact
from .torus import _signed, encode, u64


def _scalar_digits(x, radix: RadixDecomposition) -> torch.Tensor:
    """Row-aligned signed digits of scalar torus values."""
    return decompose(u64(x), radix)


def _glwe_scalar_mad(acc, glwe, scalar) -> torch.Tensor:
    """acc += glwe * scalar (wrapping; `glev_ciphertext_ops.rs:48-59`)."""
    return u64(acc) + u64(glwe) * u64(scalar)


def constant_map(slots: torch.Tensor, degree: int) -> torch.Tensor:
    """The identity map x -> x in the constant coefficient: torus values
    int64 [..., lwe_count] -> polynomials int64 [..., degree] (slot 0)."""
    out = torch.zeros((*slots.shape[:-1], degree), dtype=torch.int64, device=slots.device)
    out[..., 0] = slots[..., 0]
    return out


def _s_ext(from_sk, device) -> torch.Tensor:
    """The from-key with the virtual s_n = -1 that handles b."""
    sk = u64(from_sk, device)
    return torch.cat([sk, torch.full((1,), -1, dtype=torch.int64, device=device)])


def _factors(radix: RadixDecomposition, device) -> torch.Tensor:
    """q / B^(j+1) for each level j, as wrapping int64 [count]."""
    return torch.tensor([_signed(decomposition_factor(j, radix) % (1 << 64))
                         for j in range(radix.count)], dtype=torch.int64, device=device)


# --------------------------------------------------------------------------
# private functional keyswitch
# --------------------------------------------------------------------------


def generate_private_functional_keyswitch_key(generator, from_sk, to_sk, map_fn,
                                              from_lwe: LweDef, to_glwe: GlweDef,
                                              radix: RadixDecomposition,
                                              lwe_count: int) -> torch.Tensor:
    """PFKS key: for slot z and from-key component i (with the virtual
    s_n = -1 handling b), GLEV row j encrypts f(e_z * s_i * q/B^(j+1))
    (`private_functional_keyswitch.rs:44-102`), every row in one batched
    encryption on the generator's device.

    Shape: int64 [lwe_count, n_from+1, count, k+1, N]."""
    dev = generator.device
    n = from_lwe.dim
    vals = _s_ext(from_sk, dev)[:, None] * _factors(radix, dev)  # [n+1, count]
    slots = torch.zeros((lwe_count, n + 1, radix.count, lwe_count), dtype=torch.int64,
                        device=dev)
    z = torch.arange(lwe_count, device=dev)
    slots[z, :, :, z] = vals
    pts = u64(map_fn(slots), dev)  # [lwe_count, n+1, count, N]
    return enc.encrypt_glwe(generator, pts, u64(to_sk, dev), to_glwe)


def private_functional_keyswitch(inputs, pfksk: torch.Tensor, from_lwe: LweDef,
                                 to_glwe: GlweDef, radix: RadixDecomposition) -> torch.Tensor:
    """out = -sum_z sum_i <decomp(ab_i^z), GLEV_{z,i}>
    (`private_functional_keyswitch.rs:107-142`), one wrapping product-sum
    over (z, i, j).

    inputs: int64 [..., lwe_count, n_from+1]; returns [..., k+1, N]."""
    inputs = u64(inputs, pfksk.device)
    lwe_count = pfksk.shape[0]
    if inputs.shape[-2:] != (lwe_count, from_lwe.dim + 1):
        raise ValueError(f"private_functional_keyswitch: inputs {tuple(inputs.shape)}, want "
                         f"[..., {lwe_count}, {from_lwe.dim + 1}]")
    batch = inputs.shape[:-2]
    digits = _scalar_digits(inputs, radix)  # [count, ..., lwe_count, n+1]
    d = digits.movedim(0, -1).reshape(-1, lwe_count * (from_lwe.dim + 1) * radix.count)
    acc = plane_product_sum(d, key_planes(pfksk.reshape(d.shape[1], -1)), radix)
    return -acc.reshape(*batch, to_glwe.size + 1, to_glwe.degree)


# --------------------------------------------------------------------------
# public functional keyswitch
# --------------------------------------------------------------------------


def generate_public_functional_keyswitch_key(generator, from_sk, to_sk, from_lwe: LweDef,
                                             to_glwe: GlweDef,
                                             radix: RadixDecomposition) -> torch.Tensor:
    """GLEV_i row j encrypts s_i * q/B^(j+1) in the constant coefficient
    (`public_functional_keyswitch.rs:29-54`), every row in one batched
    encryption. Shape int64 [n_from, count, k+1, N]."""
    dev = generator.device
    pts = torch.zeros((from_lwe.dim, radix.count, to_glwe.degree), dtype=torch.int64,
                      device=dev)
    pts[..., 0] = u64(from_sk, dev)[:, None] * _factors(radix, dev)
    return enc.encrypt_glwe(generator, pts, u64(to_sk, dev), to_glwe)


def public_functional_keyswitch(inputs, pufksk: torch.Tensor, map_fn, from_lwe: LweDef,
                                to_glwe: GlweDef, radix: RadixDecomposition,
                                be=C128) -> torch.Tensor:
    """out = (0, f(b_0..b_p)) - sum_i <decomp(f(a_i^0..a_i^p)), GLEV_i>
    with the sum accumulated in the frequency domain, in the reference's
    order over (i, j) (`public_functional_keyswitch.rs:75-147`); the
    forward transforms of every i at once.

    inputs: int64 [lwe_count, n_from+1]; returns [k+1, N]."""
    inputs = u64(inputs, pufksk.device)
    n = from_lwe.dim
    polys = u64(map_fn(inputs.t()))  # [n+1, N]: f of each component's slots
    digit_fft = be.fwd_signed(decompose(polys[:n], radix))  # [count, n, N/2]
    glev_fft = be.fwd_torus(pufksk)  # [n, count, k+1, N/2]
    acc = be.zeros((to_glwe.size + 1, to_glwe.degree // 2), device=inputs.device)
    for i in range(n):
        for j in range(radix.count):
            acc = be.cmadd(acc, digit_fft[j, i, None, :], glev_fft[i, j])
    out = -be.inv(acc)
    out[-1, :] += polys[n]
    return out


# --------------------------------------------------------------------------
# circuit bootstrapping v1 (via PFKS)
# --------------------------------------------------------------------------


def generate_cbs_pfks_keys(generator, from_sk, to_sk, from_lwe: LweDef, to_glwe: GlweDef,
                           radix: RadixDecomposition) -> torch.Tensor:
    """k+1 PFKS keys with maps x -> -x*s_j (rows j < k) and x -> x
    (row k), each with lwe_count = 1 (`private_functional_keyswitch.rs:145-207`).

    Shape: int64 [k+1, 1, n_from+1, count, k+1, N]."""
    to_sk = u64(to_sk, generator.device)

    def mono(slots):
        return constant_map(slots, to_glwe.degree)

    keys = []
    for j in range(to_glwe.size):
        keys.append(generate_private_functional_keyswitch_key(
            generator, from_sk, to_sk, lambda s, s_j=to_sk[j]: -negacyclic_mul_exact(mono(s), s_j),
            from_lwe, to_glwe, radix, 1))
    keys.append(generate_private_functional_keyswitch_key(
        generator, from_sk, to_sk, mono, from_lwe, to_glwe, radix, 1))
    return torch.stack(keys, dim=0)


def extract_and_rotate(lo_noise_glwe, glwe: GlweDef, cbs_radix: RadixDecomposition):
    """Sample extract the first l coefficients and undo the functional
    bootstrap's rotation (+1 at each level's precision)
    (`circuit_bootstrapping.rs:224-251`). Returns int64 [..., l, k*N+1]."""
    outs = []
    for i in range(cbs_radix.count):
        pb = cbs_radix.radix_log * (i + 1) + 1
        outs.append(lwe_rotate(sample_extract(lo_noise_glwe, i, glwe), encode(1, pb)))
    return torch.stack(outs, dim=-2)


def circuit_bootstrap_via_pfks(ct, bsk_fft, cbs_pfks_keys: torch.Tensor, lwe_0: LweDef,
                               glwe_1: GlweDef, glwe_2: GlweDef,
                               pbs_radix: RadixDecomposition, cbs_radix: RadixDecomposition,
                               pfks_radix: RadixDecomposition, be=C128) -> torch.Tensor:
    """CBS v1: multi-function PBS -> sample extract per level -> PFKS per
    GGSW row (`circuit_bootstrapping.rs:162-219`). ct int64 [..., n0+1]
    -> a coefficient-domain GGSW int64 [..., k+1, l, k+1, N] (the
    reference's v1 also emits non-FFT GGSWs)."""
    lo_noise_glwe = hi_noise_lwe_to_lo_noise_glwe(ct, bsk_fft, lwe_0, glwe_2, pbs_radix,
                                                  cbs_radix, be)
    lwes = extract_and_rotate(lo_noise_glwe, glwe_2, cbs_radix)[..., None, :]  # [..., l, 1, n+1]
    from_lwe = glwe_2.as_lwe_def()
    rows = [private_functional_keyswitch(lwes, cbs_pfks_keys[j], from_lwe, glwe_1, pfks_radix)
            for j in range(glwe_1.size + 1)]
    return torch.stack(rows, dim=-4)
