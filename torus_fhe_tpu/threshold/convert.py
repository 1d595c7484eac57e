"""LWE <-> ring-LWE conversion.

Rework of `TLweFromLwe` / `TLweKeyFromLweKey`
(src/Convert.cpp:12-27, src/libthfhe.cpp:340-356): an LWE ciphertext under an
n-coefficient key embeds into a degree-N=n ring ciphertext by the anti-cyclic
reversal a'[0] = a[0], a'[i] = -a[N-i], so that the constant coefficient of
s(X) ⊛ a'(X) equals <s, a>. The ring key is the LWE key read as a polynomial.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..lwe import LweKey, LweSample
from ..rlwe import RLweKey, RLweSample


def tlwe_from_lwe(sample: LweSample) -> RLweSample:
    """Embed batched LWE (a: (..., N), b: (...,)) into ring-LWE with k=1
    (src/Convert.cpp:12-19). Only coefficient 0 of the body is meaningful."""
    a = sample.a
    N = a.shape[-1]
    # a'[0] = a[0]; a'[i] = -a[N-i]  (negacyclic reversal)
    a_ring = jnp.concatenate([a[..., :1], -a[..., :0:-1]], axis=-1)
    body = jnp.zeros_like(a_ring).at[..., 0].set(sample.b)
    return RLweSample(jnp.stack([a_ring, body], axis=-2))


def tlwe_key_from_lwe_key(lwe_key: LweKey, bits: int = 32) -> RLweKey:
    """Read the n LWE key bits as one degree-n ring key polynomial
    (src/libthfhe.cpp:350-356)."""
    return RLweKey(lwe_key.key.reshape(1, -1).astype(jnp.int32), bits)
