"""L1 -> L0 LWE keyswitch as one exact f32 matrix product.

Port of `spf_tpu/ops/keyswitch_u32.py`. The reference computes
out = trivial(b) − Σ_i <decomp(a_i), LEV_i> in exact u64 arithmetic
(`lwe_keyswitch.rs:23-60`). As on the TPU, the product is a float matrix
product that is exact:

- the gadget digits of `ks_radix` (log B = 2) lie in [−2, 2);
- the key is cut into 8 unsigned byte planes per u64 entry (integers
  <= 255);
- Σ_{i,j} digit[j, i] · byte[i, j, m] is one [B, n·l] x [n·l, m·8]
  product with every partial sum an integer below 2^24
  (2 · 255 · 12288 at DEFAULT_128), so f32 holds it exactly in any order
  of summation;
- the byte-plane sums are recombined mod 2^64 through a ds f32 pair and
  `torus.from_ds`, in the reference's order (`keyswitch_u32.py:75-84`).

The product runs in f32 with TF32 off: TF32 keeps 10 mantissa bits and
would round the sums. `keyswitch_lwe` turns it off around its own matrix
product whatever the caller set, and restores the setting. The TPU did
this product with `jnp.dot` outside any Pallas kernel; here it is
`torch.matmul` (cuBLAS on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import LweDef, RadixDecomposition
from . import ds, torus


def ksk_to_byte_planes(ksk) -> torch.Tensor:
    """Keyswitch key int64 tensor or u64 numpy [n_old, l, n_new+1] -> f32
    byte planes [n_old*l, (n_new+1)*8], the 8 bytes of each output column
    contiguous, least significant first (≙ `ksk_to_byte_planes`)."""
    ksk = torus.from_u64_np(ksk) if isinstance(ksk, np.ndarray) else ksk
    n_old, count, m = ksk.shape
    flat = ksk.reshape(n_old * count, m)
    planes = torch.stack([(flat >> (8 * k)) & 0xFF for k in range(8)], dim=-1)
    return planes.reshape(n_old * count, m * 8).to(torch.float32)


def keyswitch_lwe(ct: torch.Tensor, ksk_planes: torch.Tensor, old_lwe: LweDef,
                  new_lwe: LweDef, radix: RadixDecomposition) -> torch.Tensor:
    """LWE int64 [n_old+1, B] -> LWE int64 [n_new+1, B]
    (≙ `keyswitch_u32.keyswitch_lwe_u32`)."""
    n_old, count = old_lwe.dim, radix.count
    m = new_lwe.dim + 1
    if (1 << (radix.radix_log - 1)) * 255 * n_old * count >= 1 << 24:
        raise ValueError("byte-plane accumulation would lose bits in f32")
    a, b = ct[:-1], ct[-1]  # [n_old, B], [B]
    digits = torus.decompose(a, radix)  # int32 [l, n_old, B]
    d2 = digits.permute(2, 1, 0).reshape(-1, n_old * count).to(torch.float32)  # [B, n_old*l]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sums = torch.matmul(d2, ksk_planes)  # [B, m*8], exact
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    s = sums.reshape(-1, m, 8)
    hi = torch.zeros(s.shape[:2], dtype=torch.float32, device=s.device)
    lo = torch.zeros_like(hi)
    for k in range(8):
        hi, e = ds.two_sum(hi, s[:, :, k] * 2.0 ** (8 * k))
        lo = lo + e
    hi, lo = ds.quick_two_sum(hi, lo)
    out = torus.neg(torus.from_ds(hi, lo).t())  # [m, B]
    out[-1] = torus.add(out[-1], b)
    return out
