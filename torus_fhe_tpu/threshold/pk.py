"""Public-key encryption from encryptions of zero.

Rework of `ThFHEPubKey` (src/thfhe.hpp:28-42, src/libthfhe.cpp:4-52):
the public key is NSAMPLES=20 LWE encryptions of 0; to encrypt, draw a random
subset, sum it (one masked matmul here, batched over messages), and add the
±1/8 message phase plus fresh gaussian noise to b.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rng as trng
from ..core.torus import encode_message
from ..lwe import LweKey, LweSample, lwe_encrypt

N_SAMPLES = 20  # src/thfhe.hpp:21


class PublicKey(NamedTuple):
    samples: LweSample  # batch of n_samples encryptions of 0
    alpha: float


def public_keygen(key, lwe_key: LweKey, alpha: float,
                  n_samples: int = N_SAMPLES) -> PublicKey:
    """n_samples lweSymEncrypt(0) (src/libthfhe.cpp:13-18)."""
    zeros = jnp.zeros((n_samples,), jnp.int32)
    return PublicKey(lwe_encrypt(key, zeros, alpha, lwe_key, (n_samples,)), alpha)


def public_encrypt(key, pk: PublicKey, messages) -> LweSample:
    """Batched subset-sum encryption (src/libthfhe.cpp:22-52).

    messages: (...,) bools. choice ~ Bernoulli(1/2) per (message, sample);
    (a, b) = choice @ pk + (0, gaussian(±1/8, alpha)).
    """
    messages = jnp.asarray(messages)
    kc, kn = jax.random.split(key)
    n_samples = pk.samples.b.shape[0]
    choice = jax.random.bernoulli(kc, 0.5, messages.shape + (n_samples,)).astype(jnp.int32)
    a = jnp.einsum("...s,sn->...n", choice, pk.samples.a).astype(jnp.int32)
    b_sum = jnp.einsum("...s,s->...", choice, pk.samples.b).astype(jnp.int32)
    mu = jnp.where(messages, encode_message(1, 8), encode_message(-1, 8))
    b = b_sum + trng.gaussian_torus(kn, mu, pk.alpha, messages.shape)
    return LweSample(a, b)
