"""Deterministic synthetic LM data (a copy of the numpy-only
`repro.data.tokens`, so that the port imports nothing of the JAX
package): Markov-chain token streams with a learnable structure, so that
training loss actually falls, plus the frontend stubs (image patches,
audio frames) of the VLM and encoder-decoder models. The arrays equal
the reference's, seed for seed.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def synthetic_lm_batch(rng: np.random.Generator, batch: int, seq: int,
                       vocab: int, cfg=None) -> Dict[str, np.ndarray]:
    """Order-1 Markov chain over a small latent alphabet mapped into vocab —
    learnable by a tiny LM in a few hundred steps. With `cfg`, a VLM or
    encoder-decoder model's batch also holds its standard-normal
    "frontend" (B, N, d_model) f32, N = `num_image_tokens` or
    `encoder_seq`."""
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
    batch_dict: Dict[str, np.ndarray] = {"tokens": out}
    if cfg is not None:
        d = cfg.d_model
        if cfg.is_encdec:
            batch_dict["frontend"] = rng.standard_normal(
                (batch, cfg.encoder_seq, d)).astype(np.float32)
        elif cfg.num_image_tokens:
            batch_dict["frontend"] = rng.standard_normal(
                (batch, cfg.num_image_tokens, d)).astype(np.float32)
    return batch_dict


def synthetic_stream(seed: int, batch: int, seq: int, vocab: int,
                     cfg=None) -> Iterator[Dict[str, np.ndarray]]:
    """Endless batches of `synthetic_lm_batch` from one generator seeded
    `seed`."""
    rng = np.random.default_rng(seed)
    while True:
        yield synthetic_lm_batch(rng, batch, seq, vocab, cfg)
