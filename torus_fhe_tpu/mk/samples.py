"""Multikey LWE samples as batched pytrees.

Rework of `MKLweSample` (3-gen-mk-tfhe/src/mk_internals.jl:23-51):
the mask is a (parties, n) matrix per ciphertext — here batched as
a: (..., parties, n), b: (...,) so thousands of MK ciphertexts ride one XLA
program. Phase = b − Σ_p <a_p, s_p> (mk_lwe_phase, mk_internals.jl:85-91).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from ..core import rng as trng
from ..core.params import LweParams, SchemeParams3Gen
from ..core.torus import encode_message
from ..lwe import LweKey


class MKLweSample(NamedTuple):
    a: jax.Array  # (..., parties, n) Torus32
    b: jax.Array  # (...,) Torus32

    def __add__(self, other):
        return MKLweSample(self.a + other.a, self.b + other.b)

    def __sub__(self, other):
        return MKLweSample(self.a - other.a, self.b - other.b)

    def __neg__(self):
        return MKLweSample(-self.a, -self.b)

    def scale(self, c: int):
        c = jnp.asarray(c, self.a.dtype)
        return MKLweSample(self.a * c, self.b * c)


def mk_lwe_noiseless_trivial(mu, params: LweParams, parties: int, shape=()) -> MKLweSample:
    """(0, mu) with a (parties, n) zero mask (mk_internals.jl:94-96)."""
    mu = jnp.broadcast_to(jnp.asarray(mu, jnp.int32), shape)
    return MKLweSample(jnp.zeros(shape + (parties, params.size), jnp.int32), mu)


def mk_lwe_phase(sample: MKLweSample, lwe_keys: Sequence[LweKey]):
    """b − Σ_p <a_p, s_p> (mk_internals.jl:85-91)."""
    keys = jnp.stack([k.key for k in lwe_keys])  # (parties, n)
    dots = jnp.einsum("...pn,pn->...", sample.a, keys.astype(sample.a.dtype)
                      ).astype(sample.a.dtype)
    return sample.b - dots


def mk_encrypt(key, secret_keys, messages, params: SchemeParams3Gen) -> MKLweSample:
    """Encrypt booleans as ±1/8 under the concatenated party keys
    (mk_encrypt_3gen, mk_api.jl:519-536). ``secret_keys``: list of LweKey."""
    messages = jnp.asarray(messages)
    parties = len(secret_keys)
    ka, kb = jax.random.split(key)
    n = params.lwe_size
    a = trng.uniform_torus(ka, messages.shape + (parties, n))
    keys = jnp.stack([k.key for k in secret_keys])
    mu = jnp.where(messages, encode_message(1, 8), encode_message(-1, 8))
    b = (trng.gaussian_torus(kb, mu, params.lwe_noise_stddev, messages.shape)
         + jnp.einsum("...pn,pn->...", a, keys.astype(jnp.int32)).astype(jnp.int32))
    return MKLweSample(a, b)


def mk_decrypt(secret_keys, sample: MKLweSample):
    """Boolean decryption (mk_decrypt_3gen, mk_api.jl:607-609)."""
    return mk_lwe_phase(sample, secret_keys) > 0


def mk_int_encrypt(key, secret_keys, value, width: int,
                   params: SchemeParams3Gen) -> MKLweSample:
    """Two's-complement integer encryption: width bits, LSB first, batched as
    the leading axis (mk_int_encrypt_3gen, mk_api.jl:576-589).

    ``value`` may be an int or an int array (...); output bit axis is axis 0
    prepended: a (width, ..., parties, n).
    """
    value = jnp.asarray(value)
    bits = jnp.stack([(value >> i) & 1 for i in range(width)]) == 1
    return mk_encrypt(key, secret_keys, bits, params)


def mk_int_decrypt(secret_keys, sample: MKLweSample, width: int):
    """Two's-complement decode (mk_int_decrypt_3gen, mk_api.jl:612-633)."""
    import numpy as np

    bits = np.asarray(jax.device_get(mk_decrypt(secret_keys, sample)))  # (width, ...)
    msb = bits[width - 1]
    result = np.zeros(bits.shape[1:], np.int64)
    for i in range(width - 1):
        result += (np.logical_xor(bits[i], msb).astype(np.int64)) << i
    return np.where(msb, -(result + 1), result)
