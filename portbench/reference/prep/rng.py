"""RNG protocol utilities.

Mirrors the reference's seed-inference contract (`mmpfn/models/mmpfn/utils.py:620-646`)
so ensemble generation draws the same numpy Generator sequence, while model-side
randomness uses JAX PRNG keys.
"""

from __future__ import annotations

import numpy as np


def infer_random_state(
    random_state: int | np.random.RandomState | np.random.Generator | None,
) -> tuple[int, np.random.Generator]:
    """Return (static integer seed, numpy Generator) for any accepted seed input.

    Behavioral parity with reference `utils.py:620-646`: ints seed a fresh
    default_rng; RandomState/Generator are consumed for one integer draw; None uses
    entropy.
    """
    if isinstance(random_state, (int, np.integer)):
        return int(random_state), np.random.default_rng(int(random_state))
    if isinstance(random_state, np.random.RandomState):
        static_seed = int(random_state.randint(0, 2**31))
        return static_seed, np.random.default_rng(static_seed)
    if isinstance(random_state, np.random.Generator):
        static_seed = int(random_state.integers(0, 2**31))
        return static_seed, random_state
    if random_state is None:
        rng = np.random.default_rng()
        return int(rng.integers(0, 2**31)), rng
    raise ValueError(f"Invalid random_state {random_state}")
