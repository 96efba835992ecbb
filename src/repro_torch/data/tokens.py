"""Deterministic synthetic LM prompts (a copy of `synthetic_lm_batch` from
the numpy-only `repro.data.tokens`, so that the port imports nothing of the
JAX package). The encoder/image frontend stubs and the stream wait for the
encoder and VLM configs (ROADMAP A10).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_lm_batch(rng: np.random.Generator, batch: int, seq: int,
                       vocab: int) -> Dict[str, np.ndarray]:
    """Order-1 Markov chain over a small latent alphabet mapped into vocab —
    learnable by a tiny LM in a few hundred steps."""
    K = min(64, vocab)
    # fixed transition matrix derived from a seeded generator so every call
    # sees the same language
    tg = np.random.default_rng(0)
    T = tg.dirichlet(np.ones(K) * 0.3, size=K)
    states = rng.integers(0, K, size=(batch,))
    out = np.empty((batch, seq), np.int32)
    for t in range(seq):
        u = rng.random((batch, 1))
        cdf = np.cumsum(T[states], axis=1)
        states = (u < cdf).argmax(axis=1)
        out[:, t] = states
    return {"tokens": out}
