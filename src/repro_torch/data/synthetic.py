"""The synthetic LM token stream the trainer fine-tunes on: the port's own
copy of ``make_lm_dataset`` and ``lm_batch_iterator`` from
``repro/data/synthetic.py`` (numpy only, the same tokens from the same
seed).  The image dataset waits for the paper's CNN experiment (ROADMAP
A10).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def make_lm_dataset(vocab_size: int, n_tokens: int = 200_000, order: int = 1, seed: int = 0) -> np.ndarray:
    """Markov token stream with Zipfian marginals; predictable enough that a
    small LM's loss drops well below log(vocab).  (``order`` is the
    reference's signature; its stream is first-order either way.)"""
    rng = np.random.RandomState(seed)
    v_eff = min(vocab_size, 512)
    # Sparse transition table: each token strongly prefers ~8 successors.
    succ = rng.randint(0, v_eff, size=(v_eff, 8))
    toks = np.empty(n_tokens, np.int64)
    toks[0] = rng.randint(v_eff)
    u = rng.rand(n_tokens)
    choice = rng.randint(0, 8, size=n_tokens)
    for i in range(1, n_tokens):
        if u[i] < 0.85:
            toks[i] = succ[toks[i - 1], choice[i]]
        else:
            toks[i] = rng.randint(v_eff)
    return toks.astype(np.int32)


def lm_batch_iterator(tokens: np.ndarray, batch: int, seq_len: int, seed: int = 0) -> Iterator[np.ndarray]:
    """Endless (batch, seq_len) int32 windows at random starts."""
    rng = np.random.RandomState(seed)
    n = tokens.shape[0] - seq_len - 1
    while True:
        starts = rng.randint(0, n, size=batch)
        yield np.stack([tokens[s:s + seq_len] for s in starts]).astype(np.int32)
