"""Native (C++) components of the port.

The one CPU-side hot spot of the circuit layer is circuit construction
(ROBDD builds), implemented in C++ (`bdd_native.cpp`, a copy of the JAX
package's) with a pure-Python fallback (`circuits/bdd.py`).

`get_native_bdd()` returns the compiled extension module, or None where
it cannot be built. Nothing is built or loaded when this package is
imported: the first call builds the extension with g++ into the ignored
`spf_tpu_torch/_build/` (`build.py`).
"""

from __future__ import annotations

_cached = None
_tried = False


def get_native_bdd():
    global _cached, _tried
    if _tried:
        return _cached
    _tried = True
    from .build import build_extension

    try:
        _cached = build_extension()
    except (OSError, ImportError, RuntimeError):
        _cached = None
    return _cached
