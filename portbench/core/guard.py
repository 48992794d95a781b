"""Which loaded modules the benchmark refuses: JAX and the JAX package.

Names are compared by their top-level part, the text before the first
dot, as a whole: ``lrzip_next_tpu_torch`` (the program) is not
``lrzip_next_tpu`` (the JAX package it was ported from)."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "lrzip_next_tpu"})


def loaded(names=FORBIDDEN, modules=None) -> list:
    """Sorted loaded module names whose top-level part is in ``names``."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split(".")[0] in names)
