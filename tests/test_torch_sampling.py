"""The port's counter-based threefry against jax.random: key bits and
uniforms bit for bit, the samplers built on them within float tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import sampling as jsamp
from mobileraytracer_tpu_torch import sampling as tsamp
from mobileraytracer_tpu_torch import threefry

torch.set_num_threads(2)


def _bits(jkeys):
    return np.asarray(jax.random.key_data(jkeys)
                      if jnp.issubdtype(jkeys.dtype, jax.dtypes.prng_key)
                      else jkeys).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_prng_key_and_fold_in_bits(seed):
    jk = jax.random.PRNGKey(seed)
    tk = threefry.prng_key(seed)
    np.testing.assert_array_equal(tk.numpy(), _bits(jk))
    for data in (0, 1, 12345, 2**32 - 1):
        np.testing.assert_array_equal(
            threefry.fold_in(tk, data).numpy(),
            _bits(jax.random.fold_in(jk, data)))


@pytest.mark.parametrize("sample", [0, 3])
def test_ray_and_event_keys_bitwise(sample):
    """Keys over a batch of (pixel, sample, bounce, purpose)."""
    rng = np.random.default_rng(sample)
    pids = rng.integers(0, 2**22, 2000).astype(np.int32)
    bounce = rng.integers(0, 14, 2000).astype(np.int32)
    jk = jsamp.ray_key(jax.random.PRNGKey(11), jnp.asarray(pids), sample)
    tk = tsamp.ray_key(tsamp.prng_key(11), torch.from_numpy(pids), sample)
    np.testing.assert_array_equal(tk.numpy(), _bits(jk))
    for purpose in range(6):
        # Scalar and per-lane bounces, as the walker uses both.
        np.testing.assert_array_equal(
            tsamp.event_key(tk, 2, purpose).numpy(),
            _bits(jsamp.event_key(jk, 2, purpose)))
        np.testing.assert_array_equal(
            tsamp.event_key(tk, torch.from_numpy(bounce), purpose).numpy(),
            _bits(jsamp.event_key(jk, jnp.asarray(bounce), purpose)))


@pytest.mark.parametrize("n", [0, 1, 2, 5])
def test_uniform_bitwise(n):
    keys = tsamp.ray_key(tsamp.prng_key(3), torch.arange(4096), 1)
    jkeys = jsamp.ray_key(jax.random.PRNGKey(3), jnp.arange(4096), 1)
    shape = () if n == 0 else (n,)
    ju = jax.vmap(lambda k: jax.random.uniform(k, shape, jnp.float32))(jkeys)
    tu = tsamp.uniform(keys, n)
    assert tu.dtype == torch.float32
    np.testing.assert_array_equal(tu.numpy().view(np.int32),
                                  np.asarray(ju).view(np.int32))


def test_light_and_surface_samplers():
    rng = np.random.default_rng(0)
    b = 3000
    keys = tsamp.ray_key(tsamp.prng_key(5), torch.arange(b), 0)
    jkeys = jsamp.ray_key(jax.random.PRNGKey(5), jnp.arange(b), 0)
    for num in (1, 2, 3, 7):
        jl = jax.vmap(jsamp.pick_light, (0, None))(jkeys,
                                                   jnp.asarray(num, jnp.int32))
        tl = tsamp.pick_light(keys, torch.tensor(num, dtype=torch.int32))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))

    a, ab, ac = (rng.normal(size=(b, 3)).astype(np.float32) for _ in range(3))
    jp = jax.vmap(jsamp.sample_triangle_point)(jkeys, a, ab, ac)
    tp = tsamp.sample_triangle_point(keys, *map(torch.from_numpy, (a, ab, ac)))
    # Float tolerance: XLA may fuse a + r*ab + s*ac into FMAs.
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-5)

    n = rng.normal(size=(b, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:10] = 0.0                       # dead lanes carry a zero normal
    jh = jsamp.cosine_sample_hemisphere(jkeys, jnp.asarray(n))
    th = tsamp.cosine_sample_hemisphere(keys, torch.from_numpy(n))
    # sin/cos differ by ulps between XLA and torch's CPU kernels.
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
