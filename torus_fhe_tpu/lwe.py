"""LWE keys and samples as batched pytrees.

Rework of 3-gen-mk-tfhe/src/lwe.jl. A "sample" here is an array of
ciphertexts: ``a`` has shape (..., n) and ``b`` shape (...,); every operation
is batch-first so thousands of ciphertexts move through one XLA program.
Noise-variance bookkeeping is carried as a scalar python float on the type
(like the reference's ``current_variance``) only where tests need it; the
crypto path itself is pure integer arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .core import rng as trng
from .core.params import LweParams
from .core.torus import double_to_torus


class LweKey(NamedTuple):
    key: jax.Array  # (n,) int32 in {0, 1}

    @property
    def size(self) -> int:
        return self.key.shape[-1]


class LweSample(NamedTuple):
    a: jax.Array  # (..., n) torus
    b: jax.Array  # (...,) torus

    def __add__(self, other):
        return LweSample(self.a + other.a, self.b + other.b)

    def __sub__(self, other):
        return LweSample(self.a - other.a, self.b - other.b)

    def __neg__(self):
        return LweSample(-self.a, -self.b)

    def scale(self, c: int):
        c = jnp.asarray(c, self.a.dtype)
        return LweSample(self.a * c, self.b * c)


def lwe_keygen(key, params: LweParams) -> LweKey:
    """Uniform binary LWE key (lwe.jl:11-13)."""
    return LweKey(trng.uniform_binary(key, (params.size,)))


def lwe_encrypt(key, message, alpha: float, lwe_key: LweKey, shape=()) -> LweSample:
    """b = message + gaussian(alpha) + <a, s>, a uniform (lwe.jl:38-45).

    ``message`` broadcasts against ``shape``; pass shape=() for one sample or
    (B,) for a batch sharing one call.
    """
    ka, kb = jax.random.split(key)
    msg = jnp.broadcast_to(jnp.asarray(message, jnp.int32), shape)
    a = trng.uniform_torus(ka, shape + (lwe_key.size,))
    noise = trng.gaussian_torus(kb, 0, alpha, shape)
    b = msg + noise + jnp.sum(a * lwe_key.key, axis=-1, dtype=jnp.int32)
    return LweSample(a, b)


def lwe_encrypt_with_noise(message, noise, a, lwe_key: LweKey) -> LweSample:
    """Deterministic encrypt given explicit mask and float noise (lwe.jl:48-56),
    used by keyswitch-key generation with re-centred noise."""
    b = jnp.asarray(message, jnp.int32) + double_to_torus(noise, jnp.int32) + jnp.sum(a * lwe_key.key, axis=-1, dtype=jnp.int32)
    return LweSample(a, b)


def lwe_phase(sample: LweSample, lwe_key: LweKey):
    """phi = b - <a, s> (lwe.jl:60)."""
    return sample.b - jnp.sum(sample.a * lwe_key.key, axis=-1, dtype=sample.a.dtype)


def lwe_noiseless_trivial(mu, params: LweParams, shape=()) -> LweSample:
    """(0, mu) (lwe.jl:63-64)."""
    mu = jnp.broadcast_to(jnp.asarray(mu, jnp.int32), shape)
    return LweSample(jnp.zeros(shape + (params.size,), jnp.int32), mu)
