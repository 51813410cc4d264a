"""Combination enumeration utilities (≙ `sunscreen_math/src/combination.rs`).

A copy of `spf_tpu/utils/combinatorics.py` (pure Python), so that the port
imports nothing of the JAX package. Lexicographic enumeration of t-of-n
combinations with index<->combination mappings (combinadics), used by
noise-analysis tooling.
"""

from __future__ import annotations

import itertools


def number_combinations(n: int, k: int) -> int:
    """Binomial coefficient with the reference's conventions
    (`combination.rs:17`): 0 when n < k, 1 when k == 0 or k == n."""
    if n < k:
        return 0
    if k == 0 or k == n:
        return 1
    if k > n // 2:
        k = n - k
    result = 1
    for i in range(1, k + 1):
        result = result * (n - k + i) // i
    return result


class Combinations:
    """Iterator over all t-of-n combinations in lexicographic order,
    with combinadic index mapping (`combination.rs:79-190`)."""

    def __init__(self, n: int, t: int):
        if n == 0:
            raise ValueError("N must be greater than 0")
        if t > n:
            raise ValueError(f"Combinations must have N >= t, but N = {n}, t = {t}")
        self.n = n
        self.t = t

    def number_combinations(self) -> int:
        return number_combinations(self.n, self.t)

    def get_index(self, combination) -> int:
        """Lexicographic index of `combination` (strictly increasing
        element list)."""
        k = len(combination)
        if k != self.t:
            raise ValueError(f"combination must have length {self.t}, got {k}")
        index = 0
        item_in_check = 0
        n = self.n - 1
        for offset, item in enumerate(combination, start=1):
            if item > self.n - 1:
                raise ValueError(f"element {item} too large (max {self.n - 1})")
            while item_in_check < item:
                index += number_combinations(n - item_in_check, k - offset)
                item_in_check += 1
            item_in_check += 1
        return index

    def at_index(self, index: int):
        """Combination at lexicographic `index`, or None if out of
        bounds (combinadic decoding, `combination.rs:166-190`)."""
        total = self.number_combinations()
        if index >= total:
            return None
        result = []
        a, b = self.n, self.t
        x = total - 1 - index
        for _ in range(self.t):
            a -= 1
            while number_combinations(a, b) > x:
                a -= 1
            result.append(self.n - 1 - a)
            x -= number_combinations(a, b)
            b -= 1
        return result

    def __iter__(self):
        return iter(list(c) for c in itertools.combinations(range(self.n), self.t))
