"""The one generator of every traffic mix: a study's scenario batches,
drawn from the run's seed.

A mix (``portbench/traffic/<name>.json``) gives the harmonic depth
``h_max``, the batch ``batch`` of every call, and for each scenario scale
(``p_scale``, ``q_scale``, ``injection_scale``) the range ``[lo, hi]`` it
is drawn from, uniformly and independently, one value per scenario.
Call k of a run draws its batch from the seed and k alone, on the host,
so every process of a run and every run with that seed gets the same
scenarios; another seed gives other scales at the same sizes.  The same
draw picks the call's correctness sample: ``sample`` distinct lanes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SCALES = ("p_scale", "q_scale", "injection_scale")
#: the streams of a run: the timed calls and the set-up's warm-up call
WINDOW, WARMUP = 0, 1


class Batch(NamedTuple):
    """One call's scenarios: each scale (batch,) float32 on the host, and
    the lanes the check samples."""
    scales: dict
    sample: torch.Tensor


def call_seed(seed: int, stream: int, k: int) -> int:
    """A 63-bit seed for call ``k`` of ``stream`` of run ``seed``."""
    ss = np.random.SeedSequence(entropy=int(seed) % 2 ** 64,
                                spawn_key=(stream, k))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def draw(mix: dict, seed: int, k: int, sample: int = 0,
         stream: int = WINDOW) -> Batch:
    """The scenarios of call ``k`` and its ``sample`` checked lanes."""
    g = torch.Generator().manual_seed(call_seed(seed, stream, k))
    B = int(mix["batch"])
    u = torch.rand((len(SCALES), B), generator=g, dtype=torch.float32)
    scales = {}
    for i, name in enumerate(SCALES):
        lo, hi = (float(v) for v in mix[name])
        scales[name] = lo + (hi - lo) * u[i]
    lanes = torch.randperm(B, generator=g)[:min(sample, B)]
    return Batch(scales, lanes)
