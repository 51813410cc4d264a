"""A small hash-consed ROBDD engine for building mux circuits.

(Plays the role of `biodivine-lib-bdd` in the reference; circuit
*construction* is offline/build-time, so pure Python is fine. The BDD
property that decision variables appear only as selectors is exactly
what the FHE mapping needs: every circuit input arrives as a GGSW and
every mux low/high input is an internal GLWE — see
`parasol_runtime/src/fhe_circuit.rs:351-361`.)

Nodes are integers; 0 and 1 are the terminals. Internal nodes are
(var, lo, hi) triples with hi = the var==1 branch, hash-consed so
equivalent subfunctions are shared (free CSE).
"""

from __future__ import annotations


class PyBddManager:
    FALSE = 0
    TRUE = 1

    def __init__(self, num_vars: int):
        self.num_vars = num_vars
        # nodes[i] = (var, lo, hi); terminals use var = num_vars (sinks sort last)
        self.nodes: list[tuple[int, int, int]] = [
            (num_vars, 0, 0),
            (num_vars, 1, 1),
        ]
        self._unique: dict[tuple[int, int, int], int] = {}
        self._ite_cache: dict[tuple[int, int, int], int] = {}

    def var_of(self, f: int) -> int:
        return self.nodes[f][0]

    def _mk(self, var: int, lo: int, hi: int) -> int:
        if lo == hi:
            return lo
        key = (var, lo, hi)
        n = self._unique.get(key)
        if n is None:
            n = len(self.nodes)
            self.nodes.append(key)
            self._unique[key] = n
        return n

    def var(self, i: int) -> int:
        assert 0 <= i < self.num_vars
        return self._mk(i, self.FALSE, self.TRUE)

    def ite(self, f: int, g: int, h: int) -> int:
        """if f then g else h."""
        if f == self.TRUE:
            return g
        if f == self.FALSE:
            return h
        if g == h:
            return g
        if g == self.TRUE and h == self.FALSE:
            return f
        key = (f, g, h)
        r = self._ite_cache.get(key)
        if r is not None:
            return r
        top = min(self.var_of(f), self.var_of(g), self.var_of(h))

        def cof(x: int, branch: int) -> int:
            v, lo, hi = self.nodes[x]
            if v != top:
                return x
            return hi if branch else lo

        lo = self.ite(cof(f, 0), cof(g, 0), cof(h, 0))
        hi = self.ite(cof(f, 1), cof(g, 1), cof(h, 1))
        r = self._mk(top, lo, hi)
        self._ite_cache[key] = r
        return r

    def not_(self, f: int) -> int:
        return self.ite(f, self.FALSE, self.TRUE)

    def and_(self, f: int, g: int) -> int:
        return self.ite(f, g, self.FALSE)

    def or_(self, f: int, g: int) -> int:
        return self.ite(f, self.TRUE, g)

    def xor(self, f: int, g: int) -> int:
        return self.ite(f, self.not_(g), g)

    def xnor(self, f: int, g: int) -> int:
        return self.ite(f, g, self.not_(g))

    def evaluate(self, f: int, assignment) -> int:
        """Evaluate with a sequence of 0/1 per variable (for tests)."""
        while f > 1:
            v, lo, hi = self.nodes[f]
            f = hi if assignment[v] else lo
        return f


class _NativeNodes:
    """Sequence view over the native manager's (var, lo, hi) triples."""

    def __init__(self, native_mgr):
        self._m = native_mgr

    def __getitem__(self, i: int):
        return self._m.node(i)

    def __len__(self):
        return self._m.num_nodes()


class NativeBddManager:
    """Same interface as PyBddManager, backed by the C++ engine
    (`spf_tpu_torch/native/bdd_native.cpp`) — ~50-100x faster circuit builds."""

    FALSE = 0
    TRUE = 1

    def __init__(self, native_module, num_vars: int):
        self.num_vars = num_vars
        self._m = native_module.Manager(num_vars)
        self.nodes = _NativeNodes(self._m)

    def var_of(self, f: int) -> int:
        return self._m.node(f)[0]

    def var(self, i: int) -> int:
        assert 0 <= i < self.num_vars
        return self._m.var(i)

    def ite(self, f: int, g: int, h: int) -> int:
        return self._m.ite(f, g, h)

    def not_(self, f: int) -> int:
        return self._m.ite(f, self.FALSE, self.TRUE)

    def and_(self, f: int, g: int) -> int:
        return self._m.ite(f, g, self.FALSE)

    def or_(self, f: int, g: int) -> int:
        return self._m.ite(f, self.TRUE, g)

    def xor(self, f: int, g: int) -> int:
        return self._m.ite(f, self.not_(g), g)

    def xnor(self, f: int, g: int) -> int:
        return self._m.ite(f, g, self.not_(g))

    def evaluate(self, f: int, assignment) -> int:
        while f > 1:
            v, lo, hi = self._m.node(f)
            f = hi if assignment[v] else lo
        return f


def BddManager(num_vars: int):
    """Factory: native C++ engine when available, Python fallback
    otherwise. Both produce identical node-id semantics."""
    from ..native import get_native_bdd

    native = get_native_bdd()
    if native is not None:
        return NativeBddManager(native, num_vars)
    return PyBddManager(num_vars)
