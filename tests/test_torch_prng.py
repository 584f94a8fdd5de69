"""The port's threefry PRNG (utils/prng.py) against jax.random, and the
scan step's float64 log(size + 2) table against XLA's log.

Bits are compared as integers (the float32 uniforms through their int32
views).  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cluster_capacity_tpu_torch.engine import fused as tfused
from cluster_capacity_tpu_torch.engine import simulator as tsim
from cluster_capacity_tpu_torch.utils import prng

SEEDS = (0, 1, 42, 2 ** 31 - 1, 2 ** 32 + 5)
SHAPES = (1, 7, 128, 10_000)


def _words(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert tk.dtype == torch.int64
    assert np.array_equal(tk.numpy(), _words(jk))
    for num in (2, 3, 5):
        assert np.array_equal(prng.split(tk, num).numpy(),
                              _words(jax.random.split(jk, num)))


@pytest.mark.parametrize("n", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bits_match_jax(seed, n):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.uniform(key, (n,), dtype=jnp.float32))
    got = prng.uniform(prng.prng_key(seed), n).numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    bits = np.asarray(jax.random.bits(key, (n,), dtype=jnp.uint32))
    assert np.array_equal(prng.random_bits(prng.prng_key(seed), n).numpy(),
                          bits.astype(np.int64))


def test_chain_of_splits_matches_jax():
    """The scan step's draw, 100 times: rng, sub = split(rng); uniform(sub)
    over 33 nodes."""
    jk, tk = jax.random.PRNGKey(42), prng.prng_key(42)
    for _ in range(100):
        jk, jsub = jax.random.split(jk)
        keys = prng.split(tk)
        tk, tsub = keys[0], keys[1]
        assert np.array_equal(tk.numpy(), _words(jk))
        want = np.asarray(jax.random.uniform(jsub, (33,), dtype=jnp.float32))
        assert np.array_equal(prng.uniform(tsub, 33).numpy().view(np.int32),
                              want.view(np.int32))


def test_log_tables_match_xla():
    """float64: math.log(size + 2) equals XLA's float64 log on the CPU (the
    JAX step's) at every size up to 65,538 — no size needs an XLA value in
    the table.  float32: the step reads the kernel's correctly rounded
    table, within one ulp of XLA's float32 log."""
    n = 65_538
    sizes = np.arange(n + 1, dtype=np.float64)
    tab = tsim.log_table64(n)
    assert tab.dtype == np.float64 and tab.shape == (n + 1,)
    xla = np.asarray(jax.jit(lambda v: jnp.log(v + 2.0))(
        jnp.asarray(sizes, dtype=jnp.float64)))
    assert xla.dtype == np.float64 and np.array_equal(tab, xla)
    f32 = tfused.log_table(n)
    assert np.array_equal(f32, tab.astype(np.float32))
