"""Public sampling: fresh ciphertexts derived without the secret key.

Rework of src/public_sample_LWE.cpp / _LWE_2.cpp /
_RLWE_01.cpp. The trick (public_sample_LWE.cpp:49-60): for any encrypted bit
x, ``bootsXOR(x, x)`` is a *fresh* encryption of 0 whose noise is the
bootstrap output noise, independent of x's value or noise. Adding a trivial
plaintext phase then yields a publicly sampled encryption of any message —
no secret key, only the cloud key and one existing ciphertext.

Batch-first like everything else: one call manufactures a whole batch of
fresh ciphertexts from a batch seed ciphertext via a single bootstrapped
program.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.torus import encode_message
from ..lwe import LweSample, lwe_noiseless_trivial
from ..rlwe import RLweSample
from .api import CloudKey
from .gates import gate_xor


def fresh_zero(ck: CloudKey, x: LweSample) -> LweSample:
    """A fresh encryption of False derived from any ciphertext x
    (public_sample_LWE.cpp:49-53: bootsXOR(temp, x, x))."""
    return gate_xor(ck, x, x)


def public_sample(ck: CloudKey, x: LweSample, messages) -> LweSample:
    """Fresh encryptions of ``messages`` (bools) from seed ciphertext batch x
    (public_sample_LWE_2.cpp:62-73: fresh zero + plaintext phase +-1/8).

    ``messages`` broadcasts against x's batch shape.
    """
    z = fresh_zero(ck, x)  # phase -1/8 (an encryption of False)
    # shift by +1/4 to flip False -> True (the reference's lweAddTo of the
    # plaintext phase, public_sample_LWE_2.cpp:66-71)
    mu = jnp.where(jnp.asarray(messages), encode_message(1, 4),
                   encode_message(0, 4))
    return z + lwe_noiseless_trivial(mu, ck.params.lwe, z.b.shape)


def rlwe_extract_sample_at(sample: RLweSample, position: int) -> LweSample:
    """LWE extraction of coefficient ``position`` of an RLWE ciphertext
    (public_sample_RLWE_01.cpp:41-59: per-position RLWE->LWE conversion).

    Works by multiplying by X^{-position} (exact negacyclic rotation) and
    extracting the constant coefficient; position 0 reduces to the plain
    `rlwe_extract_sample`.
    """
    from ..rlwe import mul_by_monomial, rlwe_extract_sample

    if position:
        sample = mul_by_monomial(sample, -position)
    return rlwe_extract_sample(sample)
