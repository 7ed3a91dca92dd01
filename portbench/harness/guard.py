"""The benchmark runs the PyTorch port alone: no module of JAX, Flax or the
JAX package may be loaded in its processes.

Names are compared whole at the top level (the part before the first
dot), since the port's own name, ``hpfx_torch``, begins with the JAX
package's, ``hpfx``.
"""
from __future__ import annotations

import sys

BANNED = frozenset({"jax", "jaxlib", "flax", "hpfx"})


def banned_modules(names=None) -> list:
    """The loaded modules (default: ``sys.modules``) whose top-level name
    is banned, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".")[0] in BANNED)


def check(where: str) -> None:
    """Exit with code 3 and name what was found when a banned module is
    loaded."""
    bad = banned_modules()
    if bad:
        print(f"portbench: {where}: JAX or the JAX package is loaded: "
              f"{bad}", file=sys.stderr, flush=True)
        sys.exit(3)
