"""utils/prng.py ≡ jax.random (threefry2x32, partitionable): keys, fold_in,
split and uniform draws are bit for bit the same."""

import jax
import numpy as np
import pytest

from learnablepoolingmethods_torch.utils import prng


def _words(jkey):
    return np.asarray(jax.random.key_data(jkey)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -5])
def test_key_fold_in_split_match_jax(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    for data in (0, 3, 12345, 2**32 - 1):
        jf, tf = jax.random.fold_in(jk, data), prng.fold_in(tk, data)
        np.testing.assert_array_equal(tf.numpy(), _words(jf))
        np.testing.assert_array_equal(prng.split(tf, 3).numpy(), _words(jax.random.split(jf, 3)))


@pytest.mark.parametrize("shape", [(7,), (3, 5), (256, 30)])
def test_uniform_matches_jax_bit_for_bit(shape):
    for seed, step in ((0, 0), (7, 2), (123, 99)):
        jk = jax.random.split(jax.random.fold_in(jax.random.key(seed), step))[0]
        tk = prng.split(prng.fold_in(prng.key(seed), step))[0]
        want = np.asarray(jax.random.uniform(jk, shape))
        got = prng.uniform(tk, shape).numpy()
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_seed_out_of_range_raises():
    with pytest.raises(ValueError, match="32 bits"):
        prng.key(2**32)
