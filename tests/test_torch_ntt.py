"""The port's Goldilocks NTT (`spf_tpu_torch/ops/ntt.py`, host Python
ints) against the JAX package's (`spf_tpu/ops/ntt.py`) on the lists of
`tests/test_math.py::TestGoldilocksNtt`: the same transform, inverse and
cyclic product, and the product against the schoolbook convolution."""

import numpy as np
import pytest
import torch

from spf_tpu.ops import ntt as j_ntt
from spf_tpu_torch.ops import ntt

torch.set_num_threads(1)


def _lists():
    rng = np.random.default_rng(3)
    a = [int(x) for x in rng.integers(0, 1 << 62, 16)]
    b = [int(x) for x in rng.integers(0, 1000, 16)]
    sm = [int(x) for x in rng.integers(0, 1000, 16)]
    return a, b, sm


def test_roundtrip_and_convolution():
    a, b, sm = _lists()
    assert ntt.GOLDILOCKS_P == j_ntt.GOLDILOCKS_P
    assert ntt.ntt(a) == j_ntt.ntt(a)
    assert ntt.ntt(a, inverse=True) == j_ntt.ntt(a, inverse=True)
    assert ntt.ntt(ntt.ntt(a), inverse=True) == [x % ntt.GOLDILOCKS_P for x in a]
    got = ntt.cyclic_mul(b, sm)
    assert got == j_ntt.cyclic_mul(b, sm)
    n = 16
    exp = [0] * n
    for i in range(n):
        for j in range(n):
            exp[(i + j) % n] = (exp[(i + j) % n] + b[i] * sm[j]) % ntt.GOLDILOCKS_P
    assert got == exp


@pytest.mark.parametrize("order", [1, 2, 16, 1 << 32])
def test_root_of_unity(order):
    w = ntt.root_of_unity(order)
    assert w == j_ntt.root_of_unity(order)
    assert pow(w, order, ntt.GOLDILOCKS_P) == 1
    assert order == 1 or pow(w, order // 2, ntt.GOLDILOCKS_P) != 1


@pytest.mark.parametrize("order", [3, 12, 1 << 33])
def test_root_of_unity_rejects(order):
    with pytest.raises(ValueError):
        ntt.root_of_unity(order)
