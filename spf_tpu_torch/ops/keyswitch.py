"""L1 -> L0 LWE keyswitch as one exact matrix product.

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
  A ds pair holds ~48 bits, so the recombined sums are rounded in their
  low bits as `keyswitch_u32` rounds them; the u64 API's keyswitch
  (`ops/u64/keyswitch.py`) is exact mod 2^64 and differs from this one
  there.

The product runs in f64, which no precision setting of PyTorch reaches
(TF32 or bf16 settings apply to f32 products only) and which is exact on
the same integer operands, so it gives the sums an exact f32 product
gives, whatever the caller set, without touching global state. The TPU
did this product with `jnp.dot` outside any Pallas kernel; here it is
`torch.matmul` (cuBLAS on the card), on planes kept in f64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import LweDef, RadixDecomposition
from . import ds, torus


def ksk_to_byte_planes(ksk) -> torch.Tensor:
    """Keyswitch key int64 tensor or u64 numpy [n_old, l, n_new+1] -> f64
    byte planes [n_old*l, (n_new+1)*8], the 8 bytes of each output column
    contiguous, least significant first (≙ `ksk_to_byte_planes`, whose
    planes hold the same integers)."""
    ksk = torus.from_u64_np(ksk) if isinstance(ksk, np.ndarray) else ksk
    n_old, count, m = ksk.shape
    flat = ksk.reshape(n_old * count, m)
    planes = torch.stack([(flat >> (8 * k)) & 0xFF for k in range(8)], dim=-1)
    return planes.reshape(n_old * count, m * 8).to(torch.float64)


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
    d2 = digits.permute(2, 1, 0).reshape(-1, n_old * count)  # [B, n_old*l]
    f64 = torch.float64
    sums = torch.matmul(d2.to(f64), ksk_planes.to(f64)).to(torch.float32)  # [B, m*8], exact
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
