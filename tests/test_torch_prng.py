"""Keys, bits, uniforms and normals of the port (parelagmc_tpu_torch.ops.prng)
held against jax.random on the CPU: bits and uniforms exactly, normals
within the erfinv gap (5e-5 abs in float32, 1e-10 abs in float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU
from parelagmc_tpu_torch import kernels
from parelagmc_tpu_torch.ops import prng

SEEDS = [0, 7, 12345, 2 ** 33 + 5]
SHAPES = [(7,), (3, 5), (2, 3, 17)]


def _key_data(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_match_jax(seed):
    k = jax.random.PRNGKey(seed)
    assert prng.PRNGKey(seed) == _key_data(k)
    for d in (0, 1, 3, 2 ** 31 - 2):
        assert prng.fold_in(prng.PRNGKey(seed), d) == _key_data(jax.random.fold_in(k, d))
    # The managers' nested schedule fold_in(fold_in(key, level), counter).
    nested = jax.random.fold_in(jax.random.fold_in(k, 2), 11)
    assert prng.fold_in(prng.fold_in(prng.PRNGKey(seed), 2), 11) == _key_data(nested)


@pytest.mark.parametrize("bit_width", [32, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_match_jax_exactly(bit_width, shape):
    for seed in SEEDS[:3]:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
        ref = np.asarray(jax.random.bits(key, shape, jnp.uint32 if bit_width == 32 else jnp.uint64))
        ref = ref.astype(np.int64) if bit_width == 32 else ref.view(np.int64)
        got = prng.random_bits(_key_data(key), bit_width, shape, CPU).numpy()
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize(
    "dtype,tdtype,atol",
    [(jnp.float32, torch.float32, 5e-5), (jnp.float64, torch.float64, 1e-10)],
)
@pytest.mark.parametrize("shape", SHAPES + [(4, 512)])
def test_normals_match_jax(dtype, tdtype, atol, shape):
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jax.random.normal(key, shape, dtype))
        got = prng.sample_normals(prng.PRNGKey(seed), shape, tdtype, CPU)
        assert got.dtype == tdtype and tuple(got.shape) == shape
        # The bits are identical; the gap is erfinv's implementation alone.
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype,tdtype", [(jnp.float32, torch.float32),
                                          (jnp.float64, torch.float64)])
@pytest.mark.parametrize("shape", SHAPES + [(4, 512)])
def test_uniforms_match_jax_bit_for_bit(dtype, tdtype, shape):
    """K3's plain version (the mantissa-trick float of the 32-bit bits for
    float32, of the 64-bit bits for float64) is jax.random.uniform."""
    for seed in SEEDS:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 9)
        ref = np.asarray(jax.random.uniform(key, shape, dtype))
        got = prng.sample_uniforms(_key_data(key), shape, tdtype, CPU).numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def test_uniform_moments():
    """The uniform moments test of tests/test_misc.py:22 on the port."""
    u = prng.sample_uniforms(prng.PRNGKey(1), (2000,), torch.float64, CPU).numpy()
    assert 0.0 <= u.min() and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.05 and abs(u.var() - 1.0 / 12.0) < 0.01


def test_normal_moments():
    """The moments test of tests/test_misc.py:17 on the port's stream."""
    x = prng.sample_normals(prng.PRNGKey(0), (1000, 50), torch.float64, CPU).numpy()
    assert abs(x.mean()) < 0.05 and abs(x.std() - 1.0) < 0.05
    # Tails are reached and finite (the uniform is clipped at nextafter(-1, 0)).
    assert np.isfinite(x).all() and np.abs(x).max() > 3.0


def test_cpu_draws_do_not_count_as_kernel_launches():
    before = dict(kernels.launch_counts)
    prng.sample_normals(prng.PRNGKey(1), (4, 9), torch.float32, CPU)
    prng.random_bits(prng.PRNGKey(1), 64, (4, 9), CPU)
    prng.sample_uniforms(prng.PRNGKey(1), (4, 9), torch.float64, CPU)
    assert kernels.launch_counts == before
    with pytest.raises(NotImplementedError):
        prng.sample_uniforms(prng.PRNGKey(1), (4, 9), torch.bfloat16, CPU)
