"""The import guard: no module of JAX or of the JAX package may be loaded in a
benchmark run. Names are compared by their top-level part whole, because
the port's name (``spmf_tpu_torch``) begins with the JAX package's."""
from __future__ import annotations

import sys

#: top-level module names a run may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "spmf_tpu")


def forbidden_loaded(modules=None):
    """The sorted top-level names of ``FORBIDDEN`` found among ``modules``
    (default: ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops.intersection(FORBIDDEN))


def check_imports(modules=None):
    """Raise ``SystemExit`` (code 3) naming what was found, on standard
    error, when a forbidden module is loaded."""
    found = forbidden_loaded(modules)
    if found:
        print("h100bench: forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        raise SystemExit(3)
