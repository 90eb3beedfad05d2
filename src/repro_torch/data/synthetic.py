"""Deterministic synthetic datasets, the port's own copy of
``repro/data/synthetic.py`` (numpy only; the same arrays, bit for bit, and
the same batch sequence from the same seed):

* ``make_image_dataset`` — the CIFAR-like 10-class image task of the
  paper's CNN experiment: smooth class prototypes plus structured noise
  and a random shift, NHWC float32 images, int32 labels;
* ``batch_iterator`` — shuffled (x, y) batches, a fresh permutation an
  epoch;
* ``make_lm_dataset`` / ``lm_batch_iterator`` — the Zipfian Markov token
  stream the LM trainer fine-tunes on.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def make_image_dataset(
    n_train: int = 5000,
    n_test: int = 1000,
    num_classes: int = 10,
    image_size: int = 32,
    noise: float = 0.6,
    seed: int = 0,
    signal_min: float = 1.0,
    sub_prototypes: int = 1,
):
    """((x_train, y_train), (x_test, y_test)): (N, S, S, 3) float32 images
    and int32 labels.  ``signal_min`` < 1 scales each sample's prototype by
    U[signal_min, 1]; ``sub_prototypes`` > 1 makes classes multimodal; both
    keep accuracy off the ceiling so corruption effects are measurable."""
    rng = np.random.RandomState(seed)
    # Smooth class prototypes: low-frequency random fields.
    freq = 4
    base = rng.randn(num_classes * sub_prototypes, freq, freq, 3).astype(np.float32)
    protos = np.stack(
        [_upsample(base[c], image_size) for c in range(num_classes * sub_prototypes)], axis=0,
    ).reshape(num_classes, sub_prototypes, image_size, image_size, 3)
    protos /= protos.std(axis=(2, 3, 4), keepdims=True) + 1e-6

    def sample(n, rs):
        labels = rs.randint(0, num_classes, size=n)
        subs = rs.randint(0, sub_prototypes, size=n)
        imgs = protos[labels, subs].copy()
        if signal_min < 1.0:
            scale = rs.uniform(signal_min, 1.0, size=(n, 1, 1, 1)).astype(np.float32)
            imgs *= scale
        # random small translation
        for i in range(n):
            sx, sy = rs.randint(-3, 4, size=2)
            imgs[i] = np.roll(imgs[i], (sx, sy), axis=(0, 1))
        imgs += noise * rs.randn(*imgs.shape).astype(np.float32)
        return imgs.astype(np.float32), labels.astype(np.int32)

    x_train, y_train = sample(n_train, np.random.RandomState(seed + 1))
    x_test, y_test = sample(n_test, np.random.RandomState(seed + 2))
    return (x_train, y_train), (x_test, y_test)


def _upsample(small: np.ndarray, size: int) -> np.ndarray:
    """Bilinear upsample (freq, freq, C) -> (size, size, C) without scipy."""
    f = small.shape[0]
    xs = np.linspace(0, f - 1, size)
    x0 = np.clip(np.floor(xs).astype(int), 0, f - 2)
    w = (xs - x0)[:, None]
    rows = small[x0] * (1 - w[..., None]) + small[x0 + 1] * w[..., None]
    cols = rows[:, x0, :] * (1 - w[None, :, :]) + rows[:, x0 + 1, :] * w[None, :, :]
    return cols.astype(np.float32)


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


def batch_iterator(x: np.ndarray, y: np.ndarray, batch: int, seed: int = 0,
                   epochs: int = 10**9) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(x, y) batches of ``batch`` rows; each epoch a fresh permutation, its
    ragged tail dropped."""
    rng = np.random.RandomState(seed)
    n = x.shape[0]
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            idx = order[i:i + batch]
            yield x[idx], y[idx]
