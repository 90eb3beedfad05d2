"""The port's threefry key chain (``repro_torch.prng``) is bit-equal to
``jax.random``: keys, splits, fold-ins, uniform bits, Bernoulli masks,
randint and the sort-based permutation, in the installed jax's
``jax_threefry_partitionable`` mode and in the other one."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import prng  # noqa: E402

SEEDS = (0, 1, 42, 2**31 + 5)
SIZES = (1, 25, 1024, 4096)
INSTALLED = bool(jax.config.jax_threefry_partitionable)
MODES = (INSTALLED, not INSTALLED)


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("part", MODES)
def test_key_split_fold_in(part):
    with jax.threefry_partitionable(part):
        for seed in SEEDS:
            jk = jax.random.PRNGKey(seed)
            tk = prng.PRNGKey(seed)
            np.testing.assert_array_equal(_words(jk), tk.numpy())
            for n in (2, 3, 5):
                jk = jax.random.PRNGKey(seed)
                np.testing.assert_array_equal(
                    _words(jax.random.split(jk, n)), prng.split(tk, n, partitionable=part).numpy())
            for data in (0, 7, 2**31 + 3):
                np.testing.assert_array_equal(
                    _words(jax.random.fold_in(jk, data)), prng.fold_in(tk, data).numpy())


@pytest.mark.parametrize("part", MODES)
@pytest.mark.parametrize("size", SIZES)
def test_uniform_bits(part, size):
    with jax.threefry_partitionable(part):
        for seed in SEEDS:
            jk = jax.random.PRNGKey(seed)
            want = np.asarray(jax.random.uniform(jk, (size,)))
            got = prng.uniform(prng.PRNGKey(seed), (size,), partitionable=part).numpy()
            np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("part", MODES)
@pytest.mark.parametrize("shape", [(), (4, 1, 7), (2, 3, 64)])
def test_uniform_shapes(part, shape):
    with jax.threefry_partitionable(part):
        jk = jax.random.PRNGKey(3)
        want = np.asarray(jax.random.uniform(jk, shape))
        got = prng.uniform(prng.PRNGKey(3), shape, partitionable=part).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("part", MODES)
@pytest.mark.parametrize("size", SIZES)
def test_bernoulli(part, size):
    with jax.threefry_partitionable(part):
        for seed in SEEDS:
            for p in (0.7, 0.9, 0.1):
                jk = jax.random.fold_in(jax.random.PRNGKey(seed), int(p * 10))
                want = np.asarray(jax.random.bernoulli(jk, p, (size,)))
                tk = prng.fold_in(prng.PRNGKey(seed), int(p * 10))
                np.testing.assert_array_equal(want, prng.bernoulli(tk, p, (size,), partitionable=part).numpy())


@pytest.mark.parametrize("part", MODES)
@pytest.mark.parametrize("size", SIZES)
def test_permutation(part, size):
    with jax.threefry_partitionable(part):
        for seed in SEEDS:
            jk = jax.random.PRNGKey(seed)
            want = np.asarray(jax.random.permutation(jk, size))
            got = prng.permutation(prng.PRNGKey(seed), size, partitionable=part).numpy()
            np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("part", MODES)
@pytest.mark.parametrize("bounds", [(0, 151936), (-127, 128), (0, 512), (5, 5)])
def test_randint(part, bounds):
    lo, hi = bounds
    with jax.threefry_partitionable(part):
        for seed in SEEDS:
            jk = jax.random.PRNGKey(seed)
            want = np.asarray(jax.random.randint(jk, (4, 32), lo, hi, jnp.int32))
            got = prng.randint(prng.PRNGKey(seed), (4, 32), lo, hi, partitionable=part).numpy()
            assert got.dtype == np.int32
            np.testing.assert_array_equal(want, got)


def test_default_mode():
    """``partitionable=None`` draws in ``prng.DEFAULT_PARTITIONABLE`` mode."""
    with jax.threefry_partitionable(prng.DEFAULT_PARTITIONABLE):
        jk = jax.random.PRNGKey(9)
        want = np.asarray(jax.random.split(jk, 4))
    np.testing.assert_array_equal(_words(want), prng.split(prng.PRNGKey(9), 4).numpy())
