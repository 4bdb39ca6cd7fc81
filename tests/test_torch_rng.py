"""The port's counter RNG against the JAX package's: bitwise.

Every path test of the port depends on both packages drawing the same
numbers, so PCG4D, the u32 -> f32 conversion, counter_uniforms and
mix_stream are held to equal bits on random words, including words of 2^31
and above (where int32 arithmetic in torch would sign-extend).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_path_tracer_tpu.utils import rng as jrng
from volume_path_tracer_tpu_torch.utils import rng as trng

torch.set_num_threads(2)


def _words(rng, n):
    w = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    w[:6] = [0, 1, 2**31 - 1, 2**31, 2**32 - 128, 2**32 - 1]
    return w


def _bits(x):
    return np.asarray(x).view(np.uint32)


def test_pcg4d_bitwise():
    rng = np.random.default_rng(0)
    a, b, c, d = (_words(rng, 50_000) for _ in range(4))
    jv = jrng.pcg4d(*(jnp.asarray(x) for x in (a, b, c, d)))
    tv = trng.pcg4d(*(torch.from_numpy(x.astype(np.int64)) for x in (a, b, c, d)))
    for j, t in zip(jv, tv):
        assert np.array_equal(np.asarray(j).astype(np.int64), t.numpy())


def test_pcg4d_accepts_int32_bit_patterns():
    # int32 inputs carry the same bits as uint32 ones (pixel ids, counters).
    rng = np.random.default_rng(1)
    a = _words(rng, 1000)
    tv_u = trng.pcg4d(*(torch.from_numpy(a.astype(np.int64)) for _ in range(4)))
    tv_i = trng.pcg4d(*(torch.from_numpy(a.view(np.int32)) for _ in range(4)))
    for x, y in zip(tv_u, tv_i):
        assert torch.equal(x, y)


def test_u32_to_uniform_bitwise():
    rng = np.random.default_rng(2)
    w = _words(rng, 200_000)
    j = jrng._u32_to_uniform(jnp.asarray(w))
    t = trng._u32_to_uniform(torch.from_numpy(w.astype(np.int64)))
    assert np.array_equal(_bits(j), _bits(t.numpy()))
    assert float(t.max()) < 1.0


@pytest.mark.parametrize("iteration", ["scalar", "per_lane", "jitter"])
def test_counter_uniforms_bitwise(iteration):
    rng = np.random.default_rng(3)
    pids = rng.integers(0, 2**31 - 1, 4096).astype(np.int32)
    stream = jrng.mix_stream(10, 3)
    if iteration == "scalar":
        it_j, it_t, n = 17, 17, 4
    elif iteration == "per_lane":
        ctr = rng.integers(0, 10_000, 4096).astype(np.int32)
        it_j, it_t, n = jnp.asarray(ctr), torch.from_numpy(ctr), 4
    else:  # the renderer's jitter counter, cast to uint32
        it_j, it_t, n = jnp.int32(2**31 - 1), 2**31 - 1, 2
    j = jrng.counter_uniforms(jnp.asarray(pids), stream, it_j, n)
    t = trng.counter_uniforms(torch.from_numpy(pids), trng.mix_stream(10, 3), it_t, n)
    assert t.shape == (4096, n) and t.dtype == torch.float32
    assert np.array_equal(_bits(j), _bits(t.numpy()))


def test_counter_uniforms_more_than_four():
    pids = np.arange(257, dtype=np.int32)
    j = jrng.counter_uniforms(jnp.asarray(pids), jrng.mix_stream(1, 1), 5, 7)
    t = trng.counter_uniforms(torch.from_numpy(pids), trng.mix_stream(1, 1), 5, 7)
    assert np.array_equal(_bits(j), _bits(t.numpy()))


@pytest.mark.parametrize("seed,wave", [(0, 0), (3, 1), (10, 128), (2**31, 7), (2**32 - 1, 2**32 - 1)])
def test_mix_stream_bitwise(seed, wave):
    assert trng.mix_stream(seed, wave) == int(jrng.mix_stream(seed, wave))


def test_sample_exponential_and_discrete3():
    rng = np.random.default_rng(4)
    u = rng.uniform(0, 1, 10_000).astype(np.float32)
    a = rng.uniform(0.01, 5, 10_000).astype(np.float32)
    j = np.asarray(jrng.sample_exponential(jnp.asarray(u), jnp.asarray(a)))
    t = trng.sample_exponential(torch.from_numpy(u), torch.from_numpy(a)).numpy()
    # log1p may differ in the last ulp between XLA's and torch's CPU kernels.
    np.testing.assert_allclose(t, j, rtol=1e-6)
    w = rng.uniform(0, 1, (3, 10_000)).astype(np.float32)
    j = np.asarray(jrng.sample_discrete3(*(jnp.asarray(x) for x in w), jnp.asarray(u)))
    t = trng.sample_discrete3(*(torch.from_numpy(x) for x in w), torch.from_numpy(u)).numpy()
    assert np.array_equal(j, t)
