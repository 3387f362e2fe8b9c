"""A reader that loads a stand-in module named jax, as a reader that
imported JAX would: run.py must then exit 4 and print no result."""

import sys
import types

LAYER = "parallel/multihost.py"
MOVES = "round_ms"
UNIT = "count"


def read(r):
    sys.modules.setdefault("jax", types.ModuleType("jax"))
    return 1.0
