"""Number-theoretic transform over the Goldilocks field
p = 2^64 - 2^32 + 1.

The port's own copy of `spf_tpu/ops/ntt.py` (≙ the reference's
`sunscreen_tfhe/src/math/goldilocks_field.rs` + `math/fft/cyclic/NaiveNtt`,
present and tested there but unused on its main path). It runs on the
host in Python ints, exact, with no device and no kernel: not a hot path.
"""

from __future__ import annotations

GOLDILOCKS_P = (1 << 64) - (1 << 32) + 1
# 7 generates the multiplicative group; the field has 2-adicity 32
_GENERATOR = 7
_TWO_ADICITY = 32


def root_of_unity(order: int) -> int:
    """A primitive `order`-th root of unity (order a power of two <= 2^32)."""
    if order & (order - 1) or not 0 < order <= 1 << _TWO_ADICITY:
        raise ValueError(f"root_of_unity: order {order} is not a power of two <= 2^32")
    return pow(_GENERATOR, (GOLDILOCKS_P - 1) // order, GOLDILOCKS_P)


def ntt(a, inverse: bool = False) -> list:
    """O(n log n) radix-2 cyclic NTT over the Goldilocks field (n a power of two)."""
    a = [int(x) % GOLDILOCKS_P for x in a]
    n = len(a)
    w = root_of_unity(n)
    if inverse:
        w = pow(w, GOLDILOCKS_P - 2, GOLDILOCKS_P)
    j = 0  # bit reversal
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        wl = pow(w, n // length, GOLDILOCKS_P)
        for start in range(0, n, length):
            cur = 1
            for k in range(length // 2):
                u = a[start + k]
                v = a[start + k + length // 2] * cur % GOLDILOCKS_P
                a[start + k] = (u + v) % GOLDILOCKS_P
                a[start + k + length // 2] = (u - v) % GOLDILOCKS_P
                cur = cur * wl % GOLDILOCKS_P
        length <<= 1
    if inverse:
        n_inv = pow(n, GOLDILOCKS_P - 2, GOLDILOCKS_P)
        a = [x * n_inv % GOLDILOCKS_P for x in a]
    return a


def cyclic_mul(a, b) -> list:
    """Exact cyclic convolution via the NTT (a test oracle, as the
    reference's NaiveNtt)."""
    fa = ntt(a)
    fb = ntt(b)
    return ntt([x * y % GOLDILOCKS_P for x, y in zip(fa, fb)], inverse=True)
