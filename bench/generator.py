"""The one traffic generator: it reads a mix's parameters
(`bench/traffic/<mix>.json`) and the seed, and yields the batches of node
ids that callers send.

``"loop": "closed"``: callers that each wait for their reply; batches of
``batch`` distinct ids drawn uniformly without replacement from the test
split (the nodes unseen in training), one batch sent as the previous one
is taken, so the engine never waits for work.

Every seed gives the same sizes; the seed only chooses the ids.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def rngs(seed: int):
    """Independent streams for warm-up and for the window, both from the
    run's seed."""
    ss = np.random.SeedSequence(int(seed) % (1 << 128))
    warm, window = ss.spawn(2)
    return np.random.default_rng(warm), np.random.default_rng(window)


def closed_batches(rng: np.random.Generator, pool: np.ndarray,
                   batch: int) -> Iterator[np.ndarray]:
    """Batches of `batch` distinct ids from `pool`, without end."""
    while True:
        yield rng.choice(pool, size=batch, replace=False)
