"""The cards a cell needs.  A run without them fails: it never falls back
to the CPU."""
from __future__ import annotations

import sys


def require(n: int) -> None:
    """Exit with code 2, and no result, unless CUDA shows ``n`` cards."""
    import torch
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is false: no result",
              file=sys.stderr, flush=True)
        sys.exit(2)
    if torch.cuda.device_count() < n:
        print(f"portbench: the cell needs {n} cards, CUDA shows "
              f"{torch.cuda.device_count()}: no result", file=sys.stderr,
              flush=True)
        sys.exit(2)


def device(rank: int):
    """This process's card."""
    import torch
    return torch.device("cuda", rank)
